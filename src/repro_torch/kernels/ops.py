"""Public wrappers around the kernels for parameter trees.

The port of ``repro/kernels/ops.py``'s ``ssca_update``,
``secure_quant_sum``, ``secure_dequantize``, ``flash_attention`` and
``rwkv6_wkv``.  A parameter or message tree (nested dicts,
:mod:`repro_torch.tree`) is flattened leaf by leaf in ``jax.tree`` order
(sorted keys, depth first:
``w1``, ``w2`` for the MLP; ``blocks/attn_norm`` … ``blocks/wv``,
``embed``, ``final_norm`` for the LM), each leaf row-major, into one
buffer zero-padded to a multiple of 128 lanes, run through the kernel
once, and unflattened.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import Device
from repro_torch import tree as _tree
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rwkv6_scan as _rw
from repro_torch.kernels import secure_agg as _sa
from repro_torch.kernels import ssca_update as _su

LANES = _su.LANES
Params = _tree.Tree


def flatten(tree: Params, lead: int = 0) -> torch.Tensor:
    """Leaves in ``jax.tree`` order → one f32 (*lead_dims, n) tensor,
    each leaf row-major after its first ``lead`` dims."""
    return torch.cat([x.float().reshape(*x.shape[:lead], -1)
                      for x in _tree.leaves(tree)], dim=-1)


def flatten_padded(tree: Params, lead: int = 0) -> torch.Tensor:
    """:func:`flatten` followed by :func:`pad_lanes`, written straight into
    one preallocated contiguous f32 (*lead_dims, R, 128) buffer: one copy
    of the tree, where ``cat`` and then ``pad`` would make two."""
    xs = _tree.leaves(tree)
    lead_shape = xs[0].shape[:lead]
    n = sum(x[(0,) * lead].numel() for x in xs)
    buf = torch.empty(*lead_shape, n + (-n) % LANES, dtype=torch.float32,
                      device=xs[0].device)
    buf[..., n:] = 0.0
    off = 0
    for x in xs:
        size = x[(0,) * lead].numel()
        buf[..., off:off + size] = x.reshape(*lead_shape, size)
        off += size
    return buf.reshape(*lead_shape, -1, LANES)


def pad_lanes(flat: torch.Tensor) -> torch.Tensor:
    """Zero-pad the last dim to a multiple of 128 and split it into
    (R, 128)."""
    n = flat.shape[-1]
    flat = F.pad(flat, (0, (-n) % LANES))
    return flat.reshape(*flat.shape[:-1], -1, LANES)


def unflatten(flat: torch.Tensor, like: Params, lead: int = 0) -> Params:
    """Inverse of :func:`flatten` onto ``like``'s structure and leaf
    shapes, keeping the first ``lead`` dims of ``flat``; ``flat`` may
    carry padding at its end and keeps its dtype.  The leaves are views
    of ``flat``."""
    lead_shape = flat.shape[:lead]
    flat = flat.reshape(*lead_shape, -1)
    out, off = [], 0
    for x in _tree.leaves(like):
        out.append(flat[..., off:off + x.numel()].reshape(
            (*lead_shape, *x.shape)))
        off += x.numel()
    return _tree.unflatten(like, out)


def ssca_update(params: Params, lin: Params, grads: Params, beta: Params, *,
                rho, gamma, tau: float, lam: float = 0.0,
                device: Device = None):
    """Fused Algorithm-1 server update over a whole parameter tree: one
    kernel launch.  ``rho``/``gamma`` are f32 scalars (0-d tensors or
    floats).  Returns (params', lin', β')."""
    dev = _tree.leaves(params)[0].device
    scalars = torch.stack([torch.as_tensor(v, dtype=torch.float32)
                           for v in (rho, gamma, tau, lam)]).to(dev)
    w, l, g, b = (flatten_padded(t) for t in (params, lin, grads, beta))
    w2, l2, b2 = _su.ssca_update_2d(w, l, g, b, scalars, device=device)
    return unflatten(w2, params), unflatten(l2, params), \
        unflatten(b2, params)


def secure_quant_sum(wmsgs: Params, key_words, *, scale_bits: int,
                     client_offset: int = 0,
                     num_clients: Optional[int] = None,
                     alive: Optional[torch.Tensor] = None,
                     device: Device = None) -> Params:
    """Streaming masked quantized aggregate over a message tree.

    Every leaf carries a leading client axis (I_loc, ...).  Returns the
    int32 aggregate with the per-leaf shapes, masks never materialized at
    model size.  ``key_words`` are the round key's uint32 words; the
    first and the last are the PRF key, as in the reference.
    """
    first = _tree.leaves(wmsgs)[0]
    i_loc = first.shape[0]
    nc = i_loc if num_clients is None else int(num_clients)
    kd = np.asarray(key_words, np.uint32).reshape(-1)
    msgs = flatten_padded(wmsgs, lead=1)
    agg = _sa.masked_sum_2d(msgs, int(kd[0]), int(kd[-1]),
                            scale_bits=scale_bits, num_clients=nc,
                            client_offset=client_offset, alive=alive,
                            device=device)
    return unflatten(agg, _tree.map(lambda v: v[0], wmsgs))


def secure_dequantize(agg_q: Params, scale_bits: int) -> Params:
    """int32 fixed-point aggregate tree → f32 (grid 2^-scale_bits)."""
    return _tree.map(lambda q: _sa.dequantize(q, scale_bits), agg_q)


def flash_attention(q, k, v):
    """Causal GQA flash attention, differentiable and vmappable.

    q: (B, S, H, Dh); k/v: (B, S, Hkv, Dh) with Hkv dividing H.  Returns
    (B, S, H, Dh) in q's dtype, scaled by the true Dh^-½.  Query head h
    reads kv head h // (H / Hkv): k/v are not repeated, and Dh is not
    padded.  Routes by where q lies: the kernel for a CUDA tensor, the
    plain version for a CPU one (:mod:`repro_torch.kernels.
    flash_attention`).
    """
    return _fa.FlashAttention.apply(q, k, v)


def rwkv6_wkv(r, k, v, w, u):
    """RWKV-6 WKV with data-dependent decay, differentiable and vmappable.

    r/k/v: (B, S, H, Dh) in the activation dtype; w: (B, S, H, Dh) the
    per-token decay in (0, 1]; u: (H, Dh) the bonus.  The log-decay is
    ``clamp(log(max(w, 1e-20)), −5, 0)`` in f32, as the reference's
    wrapper computes it.  Returns (B, S, H, Dh) f32.  Routes by where r
    lies: the kernel for a CUDA tensor, the plain version for a CPU one
    (:mod:`repro_torch.kernels.rwkv6_scan`).
    """
    lw = torch.clamp(torch.log(torch.clamp_min(w.float(), 1e-20)), -5.0, 0.0)
    return _rw.RWKV6WKV.apply(r, k, v, lw, u.float())
