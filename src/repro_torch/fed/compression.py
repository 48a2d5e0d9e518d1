"""Upload compression with error feedback, and the per-round ledger.

The port of ``repro/fed/compression.py``.  A compressor sits between the
clients' uploads and the aggregation: each client compresses its own
message, the server aggregates the compressed messages, and the ledger
(:func:`round_bytes`) counts what crossed the wire.

* :func:`identity` — dense float32 uploads; the engine treats it as no
  compressor at all.
* :func:`qsgd` — unbiased stochastic b-bit quantization onto a per-leaf
  power-of-two lattice Δ = 2^e, e = ⌈log₂(max|x| / L)⌉, L = 2^(b−1) − 1.
  Every output q·2^e with e ≥ −scale_bits lies on the secure fixed-point
  grid, so the secure aggregate of quantized uploads equals their plain
  sum bit for bit.
* :func:`topk` — top-k sparsification over the whole flattened message,
  with per-client error feedback (the residual of the population arena),
  optionally quantizing the kept values (``bits``).

The reference's compressors take one client's pytree and the engine
vmaps them; the port's take the whole (I, …) message tree of a round and
the (I,) int64 per-(round, client) stream seeds
(:func:`repro_torch.kernels.compress.client_stream_seed`), and launch one
kernel (:func:`repro_torch.kernels.compress.compress_2d`) for all
clients: one a round per leaf for qsgd (two on the MLP), one for top-k.
Trees are walked in ``jax.tree`` leaf order (:mod:`repro_torch.tree`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import Device, tree
from repro_torch.kernels import compress as _kc
from repro_torch.kernels import ops as _kops

Params = tree.Tree

_F32_BYTES = 4          # wire width of scales / indices / dense floats


def _pow2_step(maxabs: torch.Tensor, lbound: int) -> torch.Tensor:
    """Δ = 2^e, the smallest power of two with Δ·L ≥ max|x|, from the f32
    bits of y = max(max|x|, 1e-38) / L, exactly: e is y's unbiased
    exponent, plus one unless y is a power of two; a subnormal y gives
    e ≤ −126 and an infinite one e = 128, before the clip to
    [−126, 127].  A zero (or NaN) message gets Δ = 1.

    This is the power of two the reference's docstring defines; the
    reference computes it as ``exp2(ceil(log2(y)))``, which XLA's CPU
    backend evaluates inexactly for some exponents.
    """
    y = torch.clamp_min(maxabs.to(torch.float32), 1e-38) / float(lbound)
    bits = y.view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127 + ((bits & 0x7FFFFF) != 0).to(torch.int32)
    e = torch.where(maxabs > 0, e.clamp(-126, 127), torch.zeros_like(e))
    return ((e + 127) << 23).view(torch.float32)


def _zeros_arena(like: Params, num_clients: int) -> Params:
    """The population-resident (I, …) f32 residual arena, zero at birth."""
    return tree.map(lambda v: torch.zeros(
        (num_clients,) + tuple(v.shape), dtype=torch.float32,
        device=v.device), like)


def _scalars(seeds: torch.Tensor, base: int, thr, delta):
    """The kernel's per-client scalar rows: (I, 2) int64 [seed, base] and
    (I, 2) f32 [θ, Δ]."""
    def column(v):
        # a fill, not a host-to-device copy, for a Python float: a copy
        # would wait for the device
        if isinstance(v, torch.Tensor):
            return v.to(torch.float32).expand(seeds.shape[0])
        return torch.full(seeds.shape, float(v), dtype=torch.float32,
                          device=seeds.device)

    su = torch.stack([seeds, torch.full_like(seeds, base)], dim=1)
    return su, torch.stack([column(thr), column(delta)], dim=1)


@dataclasses.dataclass(frozen=True)
class IdentityCompressor:
    """Dense float32 uploads — the default wire; the engine runs it as no
    compressor at all."""

    name = "identity"
    is_identity = True
    stateful = False

    def payload_bytes(self, elements, leaves, elem_bytes):
        del leaves
        return elements * elem_bytes


@dataclasses.dataclass(frozen=True)
class StochasticQuantizer:
    """Unbiased b-bit stochastic quantization, per-leaf power-of-two scale.

    Wire format per client: ⌈n·b/8⌉ bytes of packed levels plus one
    exponent (4 bytes) per leaf.
    """
    bits: int = 8

    name = "qsgd"
    is_identity = False
    stateful = False

    def __post_init__(self):
        b = self.bits
        if isinstance(b, bool) or not isinstance(b, (int, np.integer)) \
                or not 2 <= int(b) <= 16:
            raise ValueError(f"bits={b!r} outside [2, 16]: need a sign and"
                             " at least one magnitude bit, and > 16 bits"
                             " stops being compression")

    @property
    def _lbound(self) -> int:
        return 2 ** (int(self.bits) - 1) - 1

    def compress(self, msgs: Params, resid, seeds: torch.Tensor, *,
                 device: Device = None):
        """(I, …) message tree → the quantized tree, one kernel launch per
        leaf in leaf order; the leaves' counter ranges are disjoint (each
        starts where the previous padded leaf ended)."""
        out, base = [], 0
        for x in tree.leaves(msgs):
            flat = x.float().reshape(x.shape[0], -1)
            buf = _kops.pad_lanes(flat).contiguous()
            delta = _pow2_step(buf.abs().amax(dim=(1, 2)), self._lbound)
            su, sf = _scalars(seeds, base, 0.0, delta)
            q, _ = _kc.compress_2d(buf, su, sf, lbound=self._lbound,
                                   quantize=True, masked=False,
                                   device=device)
            out.append(q.reshape(x.shape[0], -1)[:, :flat.shape[1]]
                       .reshape(x.shape))
            base += buf.shape[1] * buf.shape[2]
        return tree.unflatten(msgs, out), resid

    def payload_bytes(self, elements, leaves, elem_bytes):
        del elem_bytes
        return math.ceil(elements * int(self.bits) / 8) + _F32_BYTES * leaves


@dataclasses.dataclass(frozen=True)
class TopKCompressor:
    """Top-k sparsification with per-client error feedback.

    Keeps the k = ⌈fraction·n⌉ largest-magnitude entries of each client's
    flattened message plus residual (threshold semantics: every entry at
    least the k-th magnitude is kept); the rest goes to the client's
    residual.  ``bits`` also stochastically quantizes the kept values
    (one power-of-two scale per message), the quantization error going
    into the same residual.

    Wire format per client: k values (b-bit levels or dense floats) +
    k int32 indices (+ one exponent when quantizing).
    """
    fraction: float = 0.1
    bits: Optional[int] = None

    name = "topk"
    is_identity = False
    stateful = True

    def __post_init__(self):
        f = float(self.fraction)
        if not 0.0 < f <= 1.0:
            raise ValueError(f"fraction={self.fraction!r} outside (0, 1]")
        if self.bits is not None \
                and not 2 <= int(self.bits) <= 16:
            raise ValueError(f"bits={self.bits!r} outside [2, 16]")

    def init_client_state(self, like: Params, num_clients: int) -> Params:
        return _zeros_arena(like, num_clients)

    def _k(self, elements: int) -> int:
        return max(1, math.ceil(float(self.fraction) * elements))

    def compress(self, msgs: Params, resid: Params, seeds: torch.Tensor, *,
                 device: Device = None):
        """(I, …) messages and residuals → (compressed, new residuals), one
        kernel launch over the flattened messages of all clients."""
        inp = tree.map(lambda m, r: m.float() + r, msgs, resid)
        buf = _kops.flatten_padded(inp, lead=1)              # (I, R, 128)
        n = tree.numel(inp) // buf.shape[0]
        flat = buf.reshape(buf.shape[0], -1)[:, :n]          # (I, n) view
        k = self._k(n)
        thr = torch.topk(flat.abs(), k, dim=1).values[:, k - 1]
        quantize = self.bits is not None
        if quantize:
            lbound = 2 ** (int(self.bits) - 1) - 1
            delta = _pow2_step(flat.abs().amax(dim=1), lbound)
        else:
            lbound, delta = 1, 1.0
        su, sf = _scalars(seeds, 0, thr, delta)
        out, res = _kc.compress_2d(buf, su, sf, lbound=lbound,
                                   quantize=quantize, masked=True,
                                   device=device)
        like = tree.map(lambda v: v[0], inp)
        return (_kops.unflatten(out, like, lead=1),
                _kops.unflatten(res, like, lead=1))

    def payload_bytes(self, elements, leaves, elem_bytes):
        del leaves
        k = self._k(elements)
        if self.bits is None:
            return k * (elem_bytes + _F32_BYTES)          # value + index
        return math.ceil(k * int(self.bits) / 8) \
            + k * _F32_BYTES + _F32_BYTES                 # + indices + scale


def identity() -> IdentityCompressor:
    return IdentityCompressor()


def qsgd(bits: int = 8) -> StochasticQuantizer:
    return StochasticQuantizer(bits=bits)


def topk(fraction: float = 0.1, bits: Optional[int] = None) -> TopKCompressor:
    return TopKCompressor(fraction=fraction, bits=bits)


# ---------------------------------------------------------------------------
# the communication ledger
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RoundBytes:
    """Exact per-round wire traffic of one engine configuration."""
    uplink_per_client: int
    uplink_total: int
    downlink_per_client: int
    downlink_total: int
    participants: int
    breakdown: Dict[str, Any]

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _param_bytes(params) -> int:
    return sum(w.numel() * w.element_size() for w in tree.leaves(params))


def round_bytes(algorithm, aggregation, compressor, params,
                num_clients: int) -> RoundBytes:
    """The ledger: exact uplink/downlink bytes for one round.

    * uplink — per participating client: the compressor's payload under a
      float wire (plain aggregation), or the dense Z_{2^32} ring
      representation plus the per-peer seed overhead under secure
      aggregation (:meth:`SecureAggregation.uplink_wire_bytes`).  A
      compressor that changes the masked dimension itself (the
      count-sketch) declares it with ``wire_elements``: the secure wire
      then charges 4 bytes per sketch bucket and phase-2 value.
    * downlink — the server's model broadcast, one dense copy of
      ``params`` per participating client, plus any compressor-declared
      per-client extra (``extra_downlink_bytes``: the sketch's k support
      indices).

    A hierarchical aggregation adds the second uplink hop, the G edge
    aggregators' group partials to the root (``group_uplink_bytes``), to
    the round total and the breakdown, not to the per-client charge.
    """
    comp = compressor if compressor is not None else identity()
    elements, leaves, elem_bytes = algorithm.upload_spec(params)
    payload = comp.payload_bytes(elements, leaves, elem_bytes)
    wire_el = comp.wire_elements(elements) \
        if hasattr(comp, "wire_elements") else elements
    per_client = aggregation.uplink_wire_bytes(payload, wire_el,
                                               num_clients)
    participants = aggregation.participants(num_clients)
    group_up = aggregation.group_uplink_bytes(payload, wire_el, num_clients) \
        if hasattr(aggregation, "group_uplink_bytes") else 0
    down = _param_bytes(params)
    if hasattr(comp, "extra_downlink_bytes"):
        down += comp.extra_downlink_bytes(elements)
    return RoundBytes(
        uplink_per_client=per_client,
        uplink_total=per_client * participants + group_up,
        downlink_per_client=down,
        downlink_total=down * participants,
        participants=participants,
        breakdown={
            "compressor": comp.name,
            "payload_bytes": payload,
            "upload_elements": elements,
            "wire_elements": wire_el,
            "upload_leaves": leaves,
            "upload_elem_bytes": elem_bytes,
            "wire_overhead_bytes": per_client - payload,
            "group_uplink_bytes": group_up,
        })
