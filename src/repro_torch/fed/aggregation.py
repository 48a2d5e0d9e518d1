"""Cross-client aggregation strategies, cohort-native.

The port of ``repro/fed/aggregation.py``'s ``PlainAggregation``,
``SampledClients`` and ``SecureAggregation``.  A strategy declares

* ``cohort_size(num_clients)`` — S, the clients that upload in a round;
  the engine draws S-client cohorts into the schedule
  (:func:`repro_torch.data.partition.sample_cohorts`) and touches only
  their rows;
* ``cohort_weights(weights, combine, num_clients)`` — the round weights
  λ'_i from the cohort's gathered population weights: sum-combine
  cohorts rescaled by I/S (unbiased), mean-combine ones renormalized to
  Σλ' = 1; S = I returns the weights untouched, so full participation is
  bit for bit :class:`PlainAggregation`;
* ``needs_messages`` — whether the server must see individual uploads.
  A linear strategy does not: the engine evaluates the aggregate on the
  weighted super-batch, one gradient, no per-client messages;
* ``combine_messages(wmsgs, key_words, alive=None)`` — the reduction
  over explicit pre-weighted messages with a leading cohort axis: a dict
  of (S, …) leaves, or one bare (S, …) tensor (the sketch's phases);
  ``alive`` (an int32 (S,) 0/1 tensor, async rounds) marks the slots
  whose upload arrived;
* the ledger hooks ``participants``, ``uplink_wire_bytes`` and
  ``recovery_bytes_per_drop``.

Secure aggregation is Bonawitz-style pairwise additive masking in
Z_{2^32}: messages are quantized to int32 on the 2^-scale_bits grid, pair
masks are uniform over the ring and cancel exactly under wraparound, so
the unmasked aggregate is Σ_i quant(m_i) bit for bit.  Mask streams are
keyed on cohort positions 0 … S−1, so only the round's S participants
exchange pair seeds.  A dropped slot uploads nothing and the survivors'
streams against it are cancelled (seed-share recovery).  The combine
runs the streaming kernel (:mod:`repro_torch.kernels.secure_agg`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import Device, tree
from repro_torch.kernels import ops as _kops


def _sum_clients(wmsgs):
    """Σ_i m_i over the leading cohort axis (a tree or one tensor)."""
    if isinstance(wmsgs, torch.Tensor):
        return wmsgs.sum(dim=0)
    return tree.map(lambda v: v.sum(dim=0), wmsgs)


def _validated_cohort(num_sampled: Optional[int], num_clients: int) -> int:
    """S for a strategy with an optional ``num_sampled``, range-checked
    against the population (the engine asks before it draws a
    schedule)."""
    if num_sampled is None:
        return num_clients
    s = int(num_sampled)
    if not 1 <= s <= num_clients:
        raise ValueError(
            f"num_sampled={s} out of range [1, {num_clients}]")
    return s


def _cohort_reweight(weights: torch.Tensor, combine: str, num_clients: int,
                     s: int) -> torch.Tensor:
    """The partial-participation reweighting of the gathered cohort
    weights: sum-combine λ'_i = (I/S)·λ_i (unbiased), mean-combine
    λ'_i = λ_i / Σ_cohort λ_j (Σλ' = 1).  S = I returns the weights
    untouched, so full participation stays bit for bit
    :class:`PlainAggregation`."""
    if s == num_clients:
        return weights
    if combine == "mean":
        return weights / weights.sum()
    return weights * (num_clients / s)


class _LinearCombine:
    """A plain sum over the cohort: a dropped slot carries weight 0 (the
    engine's staleness reweight zeroed it), so ``alive`` needs no
    arithmetic; the compressor's payload goes on the wire as it is."""

    needs_messages = False

    def cohort_size(self, num_clients: int) -> int:
        return num_clients

    def participants(self, num_clients: int) -> int:
        return self.cohort_size(num_clients)

    def combine_messages(self, wmsgs, key_words, *, alive=None,
                         device: Device = None):
        del key_words, alive, device
        return _sum_clients(wmsgs)

    def uplink_wire_bytes(self, payload_bytes: int, dense_elements: int,
                          num_clients: int) -> int:
        del dense_elements, num_clients
        return payload_bytes

    def recovery_bytes_per_drop(self, num_clients: int) -> int:
        del num_clients                     # no masks, nothing to recover
        return 0


@dataclasses.dataclass(frozen=True)
class PlainAggregation(_LinearCombine):
    """Full participation, plain weighted sum — the eq.-(2) server."""

    def cohort_weights(self, weights, combine, num_clients):
        del combine, num_clients
        return weights


@dataclasses.dataclass(frozen=True)
class SampledClients(_LinearCombine):
    """Partial participation: S of I clients a round, uniform without
    replacement, drawn into the schedule; uploads, reweighting and the
    wire are O(S) however large I grows."""
    num_sampled: int

    def cohort_size(self, num_clients: int) -> int:
        return _validated_cohort(self.num_sampled, num_clients)

    def cohort_weights(self, weights, combine, num_clients):
        return _cohort_reweight(weights, combine, num_clients,
                                int(self.num_sampled))


@dataclasses.dataclass(frozen=True)
class SecureAggregation:
    """Pairwise-masked aggregation in Z_{2^32} (Bonawitz et al., 2017;
    honest-but-curious server).

    Cohort member p uploads quant(λ'_p m_p) + Σ_{q>p} PRG(s_pq) −
    Σ_{q<p} PRG(s_qp) (mod 2^32); the server adds the S uploads with int32
    wraparound and every mask cancels.  ``scale_bits`` sets the
    fixed-point grid 2^-scale_bits; the true aggregate must satisfy
    |Σ λ' m| < 2^(31−scale_bits) per entry.

    ``num_sampled`` — optional partial participation: S of I clients a
    round, drawn and reweighted as :class:`SampledClients`, masked over
    the cohort only; ``None`` is full participation.
    ``streaming=False`` (the mask-materializing reference) is not ported
    and raises.
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
        s = self.num_sampled
        if s is not None and (isinstance(s, bool)
                              or not isinstance(s, (int, np.integer))
                              or int(s) < 1):
            raise ValueError(f"num_sampled={s!r} must be a positive int "
                             "(or None for full participation)")
        if not self.streaming:
            raise NotImplementedError(
                "secure(streaming=False) — the mask-materializing "
                "reference — is not ported to repro_torch yet")

    def cohort_size(self, num_clients: int) -> int:
        return _validated_cohort(self.num_sampled, num_clients)

    def cohort_weights(self, weights, combine, num_clients):
        # each client applies its own λ'_i before masking, with the same
        # unbiased I/S rescale as SampledClients
        return _cohort_reweight(weights, combine, num_clients,
                                self.cohort_size(num_clients))

    def participants(self, num_clients: int) -> int:
        return self.cohort_size(num_clients)

    def uplink_wire_bytes(self, payload_bytes: int, dense_elements: int,
                          num_clients: int) -> int:
        """Masked uploads travel as the dense Z_{2^32} ring element, 4
        bytes per entry, plus one 4-byte pair-seed share per cohort peer
        a round."""
        del payload_bytes
        return 4 * dense_elements + 4 * (self.cohort_size(num_clients) - 1)

    def recovery_bytes_per_drop(self, num_clients: int) -> int:
        """Seed-share recovery a dropped slot costs: each of the S − 1
        peers uploads its 4-byte share of the dropped slot's pair secret,
        so the server can cancel the streams the survivors still carry."""
        return 4 * (self.cohort_size(num_clients) - 1)

    def combine_messages(self, wmsgs, key_words, *, alive=None,
                         device: Device = None):
        if isinstance(wmsgs, torch.Tensor):
            return self.combine_messages({"m": wmsgs}, key_words,
                                         alive=alive, device=device)["m"]
        n = tree.leaves(wmsgs)[0].shape[0]
        agg_q = _kops.secure_quant_sum(
            wmsgs, key_words, scale_bits=self.scale_bits, client_offset=0,
            num_clients=n, alive=alive, device=device)
        return _kops.secure_dequantize(agg_q, self.scale_bits)


def plain() -> PlainAggregation:
    return PlainAggregation()


def secure(scale_bits: int = 20, streaming: bool = True,
           num_sampled: Optional[int] = None) -> SecureAggregation:
    return SecureAggregation(scale_bits=scale_bits, streaming=streaming,
                             num_sampled=num_sampled)


def sampled(num_sampled: int) -> SampledClients:
    return SampledClients(num_sampled=num_sampled)
