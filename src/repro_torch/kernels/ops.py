"""Public wrappers around the kernels for parameter dicts.

The port of ``repro/kernels/ops.py``'s ``ssca_update``,
``secure_quant_sum`` and ``secure_dequantize``.  A parameter or message
dict is flattened leaf by leaf in sorted key order (``w1``, ``w2`` for
the MLP, the reference's leaf order), row-major, zero-padded to a
multiple of 128 lanes, run through the kernel once, and unflattened.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import Device
from repro_torch.kernels import secure_agg as _sa
from repro_torch.kernels import ssca_update as _su

LANES = _su.LANES
Params = Dict[str, torch.Tensor]


def flatten(tree: Params, lead: int = 0) -> torch.Tensor:
    """Leaves in sorted key order → one f32 (*lead_dims, n) tensor, each
    leaf row-major after its first ``lead`` dims."""
    return torch.cat([tree[k].float().reshape(*tree[k].shape[:lead], -1)
                      for k in sorted(tree)], dim=-1)


def pad_lanes(flat: torch.Tensor) -> torch.Tensor:
    """Zero-pad the last dim to a multiple of 128 and split it into
    (R, 128)."""
    n = flat.shape[-1]
    flat = F.pad(flat, (0, (-n) % LANES))
    return flat.reshape(*flat.shape[:-1], -1, LANES)


def unflatten(flat: torch.Tensor, like: Params, lead: int = 0) -> Params:
    """Inverse of :func:`flatten` onto ``like``'s leaf shapes, keeping the
    first ``lead`` dims of ``flat``; ``flat`` may carry padding at its end
    and keeps its dtype."""
    lead_shape = flat.shape[:lead]
    flat = flat.reshape(*lead_shape, -1)
    out, off = {}, 0
    for k in sorted(like):
        size = like[k].numel()
        out[k] = flat[..., off:off + size].reshape(*lead_shape,
                                                   *like[k].shape)
        off += size
    return out


def ssca_update(params: Params, lin: Params, grads: Params, beta: Params, *,
                rho, gamma, tau: float, lam: float = 0.0,
                device: Device = None):
    """Fused Algorithm-1 server update over a whole parameter dict: one
    kernel launch.  ``rho``/``gamma`` are f32 scalars (0-d tensors or
    floats).  Returns (params', lin', β')."""
    dev = params[sorted(params)[0]].device
    scalars = torch.stack([torch.as_tensor(v, dtype=torch.float32)
                           for v in (rho, gamma, tau, lam)]).to(dev)
    w, l, g, b = (pad_lanes(flatten(t)) for t in (params, lin, grads, beta))
    w2, l2, b2 = _su.ssca_update_2d(w, l, g, b, scalars, device=device)
    return unflatten(w2, params), unflatten(l2, params), \
        unflatten(b2, params)


def secure_quant_sum(wmsgs: Params, key_words, *, scale_bits: int,
                     client_offset: int = 0,
                     num_clients: Optional[int] = None,
                     alive: Optional[torch.Tensor] = None,
                     device: Device = None) -> Params:
    """Streaming masked quantized aggregate over a message dict.

    Every leaf carries a leading client axis (I_loc, ...).  Returns the
    int32 aggregate with the per-leaf shapes, masks never materialized at
    model size.  ``key_words`` are the round key's uint32 words; the
    first and the last are the PRF key, as in the reference.
    """
    first = wmsgs[sorted(wmsgs)[0]]
    i_loc = first.shape[0]
    nc = i_loc if num_clients is None else int(num_clients)
    kd = np.asarray(key_words, np.uint32).reshape(-1)
    msgs = pad_lanes(flatten(wmsgs, lead=1)).contiguous()
    agg = _sa.masked_sum_2d(msgs, int(kd[0]), int(kd[-1]),
                            scale_bits=scale_bits, num_clients=nc,
                            client_offset=client_offset, alive=alive,
                            device=device)
    return unflatten(agg, {k: v[0] for k, v in wmsgs.items()})


def secure_dequantize(agg_q: Params, scale_bits: int) -> Params:
    """int32 fixed-point aggregate dict → f32 (grid 2^-scale_bits)."""
    return {k: _sa.dequantize(q, scale_bits) for k, q in agg_q.items()}
