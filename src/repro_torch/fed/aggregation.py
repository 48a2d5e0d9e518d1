"""Cross-client aggregation strategies, full participation.

The port of ``repro/fed/aggregation.py``'s ``PlainAggregation`` and
``SecureAggregation``.  A strategy declares

* ``needs_messages`` — whether the server must see individual uploads.
  A linear strategy does not: the engine evaluates the aggregate on the
  weighted super-batch, one gradient, no per-client messages;
* ``combine_messages(wmsgs, key_words)`` — the reduction over explicit
  pre-weighted messages with a leading client axis: a dict of (I, …)
  leaves, or one bare (I, …) tensor (the sketch's phases);
* the ledger hooks ``participants`` and ``uplink_wire_bytes``.

Secure aggregation is Bonawitz-style pairwise additive masking in
Z_{2^32}: messages are quantized to int32 on the 2^-scale_bits grid, pair
masks are uniform over the ring and cancel exactly under wraparound, so
the unmasked aggregate is Σ_i quant(m_i) bit for bit.  The combine runs
the streaming kernel (:mod:`repro_torch.kernels.secure_agg`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import Device, tree
from repro_torch.kernels import ops as _kops


@dataclasses.dataclass(frozen=True)
class PlainAggregation:
    """Full participation, plain weighted sum — the eq.-(2) server."""

    needs_messages = False

    def participants(self, num_clients: int) -> int:
        return num_clients

    def combine_messages(self, wmsgs, key_words, *, device: Device = None):
        """Σ_i m_i over the leading client axis."""
        del key_words, device
        if isinstance(wmsgs, torch.Tensor):
            return wmsgs.sum(dim=0)
        return tree.map(lambda v: v.sum(dim=0), wmsgs)

    def uplink_wire_bytes(self, payload_bytes: int, dense_elements: int,
                          num_clients: int) -> int:
        del dense_elements, num_clients
        return payload_bytes


@dataclasses.dataclass(frozen=True)
class SecureAggregation:
    """Pairwise-masked aggregation in Z_{2^32} (Bonawitz et al., 2017;
    honest-but-curious server), full participation.

    Client i uploads quant(λ_i m_i) + Σ_{j>i} PRG(s_ij) − Σ_{j<i} PRG(s_ji)
    (mod 2^32); the server adds the I uploads with int32 wraparound and
    every mask cancels.  ``scale_bits`` sets the fixed-point grid
    2^-scale_bits; the true aggregate must satisfy
    |Σ λ m| < 2^(31−scale_bits) per entry.

    ``streaming=False`` (the mask-materializing reference) and
    ``num_sampled`` (partial participation) are not ported yet and raise.
    """
    scale_bits: int = 20

    streaming: bool = True

    num_sampled: Optional[int] = None

    needs_messages = True

    def __post_init__(self):
        b = self.scale_bits
        if isinstance(b, bool) or not isinstance(b, (int, np.integer)) \
                or not 1 <= int(b) <= 30:
            raise ValueError(
                f"scale_bits={b!r} outside [1, 30]: the int32 fixed point"
                " needs one sign bit and at least one integer bit")
        if self.num_sampled is not None:
            raise NotImplementedError(
                "secure(num_sampled=...) — partial participation — is not "
                "ported to repro_torch yet")
        if not self.streaming:
            raise NotImplementedError(
                "secure(streaming=False) — the mask-materializing "
                "reference — is not ported to repro_torch yet")

    def participants(self, num_clients: int) -> int:
        return num_clients

    def uplink_wire_bytes(self, payload_bytes: int, dense_elements: int,
                          num_clients: int) -> int:
        """Masked uploads travel as the dense Z_{2^32} ring element, 4
        bytes per entry, plus one 4-byte pair-seed share per peer."""
        del payload_bytes
        return 4 * dense_elements + 4 * (num_clients - 1)

    def combine_messages(self, wmsgs, key_words, *, device: Device = None):
        if isinstance(wmsgs, torch.Tensor):
            return self.combine_messages({"m": wmsgs}, key_words,
                                         device=device)["m"]
        n = tree.leaves(wmsgs)[0].shape[0]
        agg_q = _kops.secure_quant_sum(
            wmsgs, key_words, scale_bits=self.scale_bits, client_offset=0,
            num_clients=n, device=device)
        return _kops.secure_dequantize(agg_q, self.scale_bits)


def secure(scale_bits: int = 20, streaming: bool = True,
           num_sampled: Optional[int] = None) -> SecureAggregation:
    return SecureAggregation(scale_bits=scale_bits, streaming=streaming,
                             num_sampled=num_sampled)
