"""Sketched uploads: the sublinear secure wire (FetchSGD-style).

The port of ``repro/fed/sketch.py``.  Under secure aggregation every
upload travels as the dense Z_{2^32} ring element, so qsgd and top-k do
not shrink the secure wire.  The count-sketch does: each client projects
its upload into S_i ∈ Z^{rows×cols} on the secure grid, the masks are
applied to the sketch, and the server's ring sum of masked sketches is
exactly Σ_i S_i.  One round through the engine
(:mod:`repro_torch.fed.engine`) has two phases:

1. *client* — inp_i = m_i + r_i (message plus the client's residual from
   the population arena); its top-``keep`` coordinates are stochastically
   rounded onto the grid and bucket-accumulated (:meth:`encode`, one
   kernel launch for all clients);
2. *phase 1* — the masked sketch sum; the server takes the top-k of the
   median-of-rows estimate → the k support indices (:meth:`support`);
3. *phase 2* — each client rounds its own inp_i at the support onto the
   grid under a re-keyed stream (:meth:`values`) and uploads that (k,)
   vector under a fresh mask stream; the server scatters the masked sum
   into the model-shaped update (:meth:`reassemble`);
4. *client* — r_i' = inp_i minus its own phase-2 upload at the support
   (:meth:`update_residual`).

The reference's methods take one client's pytree; the port's take the
(I, …) dict of a round and the (I,) int64 stream seeds
(:func:`repro_torch.kernels.compress.client_stream_seed`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch import Device, tree
from repro_torch.fed.compression import _F32_BYTES, _zeros_arena
from repro_torch.kernels import ops as _kops
from repro_torch.kernels import sketch as _ksk
from repro_torch.kernels.secure_agg import _mix32

Params = tree.Tree

# Domain-separation tag of the phase-2 rounding stream: phase 1 already
# drew at the same counters on the client's per-round stream.
_PHASE2_TAG = 0x9D2C5680


@dataclasses.dataclass(frozen=True)
class CountSketchCompressor:
    """Count-sketch upload projection with per-client error feedback.

    ``rows × cols`` is the sketch (cols a power of two); ``fraction`` the
    k of the server's top-k unsketch (k = ⌈fraction·n⌉); ``scale_bits``
    the fixed-point grid the bucket values land on (it must match the
    secure aggregation's, which :func:`repro_torch.fed.engine.run`
    checks); ``seed`` keys the hash and sign streams, shared by every
    client and round.  ``keep`` is the client-side top-``keep``
    pre-sparsification into the sketch (``None`` → rows·cols // 32).
    """
    rows: int = 4
    cols: int = 512
    fraction: float = 0.02
    keep: Optional[int] = None
    scale_bits: int = 20
    seed: int = 0x5EEDC0DE

    name = "sketch"
    is_identity = False
    stateful = True
    sketched = True             # wire shape != message shape (engine hook)

    def __post_init__(self):
        r, c = self.rows, self.cols
        if isinstance(r, bool) or not isinstance(r, (int, np.integer)) \
                or not 1 <= int(r) <= 64:
            raise ValueError(f"rows={r!r} outside [1, 64]")
        if isinstance(c, bool) or not isinstance(c, (int, np.integer)) \
                or not 1 <= int(c) <= 2 ** 24 or (int(c) & (int(c) - 1)):
            raise ValueError(f"cols={c!r} must be a power of two in "
                             "[1, 2^24] (the bucket hash is the PRF "
                             "word's low bits)")
        f = float(self.fraction)
        if not 0.0 < f <= 1.0:
            raise ValueError(f"fraction={self.fraction!r} outside (0, 1]")
        k = self.keep
        if k is not None and (isinstance(k, bool)
                              or not isinstance(k, (int, np.integer))
                              or int(k) < 1):
            raise ValueError(f"keep={k!r} must be a positive int (or None"
                             " for rows·cols // 32)")
        b = self.scale_bits
        if isinstance(b, bool) or not isinstance(b, (int, np.integer)) \
                or not 1 <= int(b) <= 30:
            raise ValueError(f"scale_bits={b!r} outside [1, 30]")

    def init_client_state(self, like: Params, num_clients: int) -> Params:
        return _zeros_arena(like, num_clients)

    def _k(self, elements: int) -> int:
        return max(1, math.ceil(float(self.fraction) * elements))

    @property
    def _keep(self) -> int:
        if self.keep is not None:
            return int(self.keep)
        return max(1, int(self.rows) * int(self.cols) // 32)

    @property
    def _seed_u32(self) -> int:
        return int(self.seed) & 0xFFFFFFFF

    @property
    def _grid(self) -> float:
        return float(2.0 ** -int(self.scale_bits))

    # -- the two-phase protocol steps ------------------------------------

    def encode(self, inp: Params, seeds: torch.Tensor, *,
               device: Device = None) -> torch.Tensor:
        """(I, …) inputs (residual already added) → (I, rows, cols) f32
        sketches with values on the grid, one kernel launch.  Only each
        client's top-``keep`` coordinates enter its sketch (every entry at
        least the keep-th magnitude); the rest stays in its residual."""
        flat = _kops.flatten(inp, lead=1)
        m = min(self._keep, flat.shape[1])
        thr = torch.topk(flat.abs(), m, dim=1).values[:, m - 1:m]
        flat = torch.where(flat.abs() >= thr, flat, torch.zeros_like(flat))
        su = torch.stack([seeds, torch.zeros_like(seeds),
                          torch.full_like(seeds, self._seed_u32)], dim=1)
        sk = _ksk.sketch_encode(_kops.pad_lanes(flat).contiguous(), su,
                                rows=int(self.rows), cols=int(self.cols),
                                scale_bits=int(self.scale_bits),
                                device=device)
        return sk.to(torch.float32) * self._grid

    def support(self, agg_sketch: torch.Tensor, like: Params) -> torch.Tensor:
        """Server, phase 1: the (rows, cols) aggregate sketch → the (k,)
        int64 support, the top-k of |median-of-rows estimate| over every
        model coordinate.  Ties go to the lower index, as ``lax.top_k``
        orders them (``torch.topk`` promises no order for ties, and zero
        estimates tie often)."""
        n = tree.numel(like)
        ctrs = torch.arange(n, dtype=torch.int64, device=agg_sketch.device)
        est = _ksk.sketch_estimate_median(agg_sketch, ctrs, self._seed_u32)
        order = torch.sort(est.abs(), descending=True, stable=True).indices
        return order[:self._k(n)]

    def values(self, inp: Params, support: torch.Tensor,
               seeds: torch.Tensor) -> torch.Tensor:
        """Each client, phase 2: its inputs at the support, stochastically
        rounded onto the 2^-scale_bits grid under its stream re-keyed by
        :data:`_PHASE2_TAG`, with the support positions as counters →
        (I, k) f32."""
        flat = _kops.flatten(inp, lead=1)
        seed2 = _mix32(seeds ^ _PHASE2_TAG)[:, None]
        q = _ksk.round_to_grid(flat[:, support], support, seed2,
                               int(self.scale_bits))
        return q.to(torch.float32) * self._grid

    def reassemble(self, agg_values: torch.Tensor, support: torch.Tensor,
                   like: Params) -> Params:
        """Server, phase 2: the aggregated (k,) values at the (k,) support
        → the k-sparse model-shaped update."""
        dense = torch.zeros(tree.numel(like), dtype=torch.float32,
                            device=agg_values.device)
        dense[support] = agg_values.to(torch.float32)
        return _kops.unflatten(dense, like)

    def update_residual(self, inp: Params, support: torch.Tensor,
                        vals: torch.Tensor) -> Params:
        """Each client: r' = inp − its own phase-2 upload at the support,
        exactly what the server applied on its behalf."""
        flat = _kops.flatten(inp, lead=1).index_add(1, support, -vals)
        return _kops.unflatten(flat, tree.map(lambda v: v[0], inp), lead=1)

    # -- communication-ledger hooks --------------------------------------

    def payload_bytes(self, elements: int, leaves: int,
                      elem_bytes: int) -> int:
        del leaves, elem_bytes  # sketch + the phase-2 exact values
        return (int(self.rows) * int(self.cols)
                + self._k(elements)) * _F32_BYTES

    def wire_elements(self, dense_elements: int) -> int:
        """What gets masked: rows·cols sketch buckets plus the k phase-2
        values."""
        return int(self.rows) * int(self.cols) + self._k(dense_elements)

    def extra_downlink_bytes(self, elements: int) -> int:
        """The k support indices broadcast between the phases."""
        return 4 * self._k(elements)


def sketch(rows: int = 4, cols: int = 512, fraction: float = 0.02,
           keep: Optional[int] = None, scale_bits: int = 20,
           seed: int = 0x5EEDC0DE) -> CountSketchCompressor:
    return CountSketchCompressor(rows=rows, cols=cols, fraction=fraction,
                                 keep=keep, scale_bits=scale_bits,
                                 seed=seed)
