"""Cross-client aggregation strategies, cohort-native.

The port of ``repro/fed/aggregation.py``'s ``PlainAggregation``,
``SampledClients``, ``SecureAggregation`` and ``HierarchicalAggregation``.
A strategy declares

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
  whose upload arrived.  It is ``finalize_combine(partial_combine(…))``:
  ``partial_combine(wmsgs, key_words, cohort_offset, cohort_size,
  alive)`` reduces cohort positions [cohort_offset, cohort_offset + S_loc)
  of ``cohort_size`` to a partial (the int32 ring sum under secure
  aggregation) and ``finalize_combine`` turns the partial into the
  aggregate;
* the ledger hooks ``participants``, ``uplink_wire_bytes`` and
  ``recovery_bytes_per_drop`` (and, for the tree, ``group_uplink_bytes``,
  ``mask_pair_count`` and ``root_ingest_bytes``).

Secure aggregation is Bonawitz-style pairwise additive masking in
Z_{2^32}: messages are quantized to int32 on the 2^-scale_bits grid, pair
masks are uniform over the ring and cancel exactly under wraparound, so
the unmasked aggregate is Σ_i quant(m_i) bit for bit.  Mask streams are
keyed on cohort positions 0 … S−1, so only the round's S participants
exchange pair seeds.  A dropped slot uploads nothing and the survivors'
streams against it are cancelled (seed-share recovery).  The combine
runs the streaming kernel (:mod:`repro_torch.kernels.secure_agg`).

The hierarchical tree blocks the cohort into G groups: the inner combine
per group (level 1), then the G partials merged at the root (level 2),
re-masked in the ring for a secure inner.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import Device, tree
from repro_torch.fed.keys import fold_in
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

    def partial_combine(self, wmsgs, key_words, cohort_offset, cohort_size,
                        alive=None, *, device: Device = None):
        # a dropped linear client carries weight 0 already
        del key_words, cohort_offset, cohort_size, alive, device
        return _sum_clients(wmsgs)

    def finalize_combine(self, partial):
        return partial

    def combine_messages(self, wmsgs, key_words, *, alive=None,
                         device: Device = None):
        return self.finalize_combine(self.partial_combine(
            wmsgs, key_words, 0, None, alive, device=device))

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
        return self.wire_bytes_for_peers(dense_elements,
                                         self.cohort_size(num_clients) - 1)

    @staticmethod
    def wire_bytes_for_peers(dense_elements: int, peers: int) -> int:
        """The masked-upload wire with an explicit peer count: the tree
        charges its M − 1 group peers instead of the S − 1 cohort
        peers."""
        return 4 * dense_elements + 4 * peers

    def recovery_bytes_per_drop(self, num_clients: int) -> int:
        """Seed-share recovery a dropped slot costs: each of the S − 1
        peers uploads its 4-byte share of the dropped slot's pair secret,
        so the server can cancel the streams the survivors still carry."""
        return 4 * (self.cohort_size(num_clients) - 1)

    def partial_combine(self, wmsgs, key_words, cohort_offset, cohort_size,
                        alive=None, *, device: Device = None):
        """The int32 masked sum of cohort positions [cohort_offset,
        cohort_offset + S_loc) of ``cohort_size``."""
        if isinstance(wmsgs, torch.Tensor):
            return self.partial_combine({"m": wmsgs}, key_words,
                                        cohort_offset, cohort_size, alive,
                                        device=device)["m"]
        return _kops.secure_quant_sum(
            wmsgs, key_words, scale_bits=self.scale_bits,
            client_offset=cohort_offset, num_clients=cohort_size,
            alive=alive, device=device)

    def finalize_combine(self, partial):
        return _kops.secure_dequantize(partial, self.scale_bits)

    def combine_messages(self, wmsgs, key_words, *, alive=None,
                         device: Device = None):
        n = tree.leaves(wmsgs)[0].shape[0]
        return self.finalize_combine(self.partial_combine(
            wmsgs, key_words, 0, n, alive, device=device))


@dataclasses.dataclass(frozen=True)
class HierarchicalAggregation:
    """Two-level tree combine: clients → G edge aggregators → server.

    Wraps any inner aggregation.  The round's S cohort members are blocked
    into G groups of M = ⌈S/G⌉ (a seed-stable per-round permutation drawn
    in the schedule, :func:`repro_torch.data.partition.sample_groups`);
    each group runs the inner combine over its M members (level 1), and
    the G group partials are merged at the root (level 2).  Root ingest
    drops from O(S) uploads to O(G), each client's pair-seed state from
    O(S) peers to O(M).

    Bit identity with the flat combine:

    * secure inner: level 1 is the masked sum over the group, its key
      folded with the *global* group id so no two groups share a stream;
      level 2 re-masks the int32 group partials directly in Z_{2^32}
      (:func:`repro_torch.kernels.ops.secure_ring_partial_sum`, streams
      domain-separated by the group tag), with no dequantize/requantize.
      Ring addition is associative and every mask cancels at its level,
      so the root equals the flat masked sum bit for bit.
    * linear inner (plain / sampled): level 2 is a plain sum of group
      sums, equal to the flat sum wherever the float additions are exact
      (on-grid messages).

    Level 2 dispatches by dtype: int32 partials get the masked ring merge,
    float ones a plain sum.  ``groups=1`` is the inner aggregation (one
    group, level 2 a sum over one row); a tree inside a tree is refused.
    """
    inner: Any
    groups: int

    needs_messages = True

    def __post_init__(self):
        g = self.groups
        if isinstance(g, bool) or not isinstance(g, (int, np.integer)) \
                or int(g) < 1:
            raise ValueError(f"groups={g!r} must be a positive int")
        if isinstance(self.inner, HierarchicalAggregation):
            raise ValueError("Hierarchical(Hierarchical(...)) is not "
                             "supported: the tree has exactly two levels")

    # -- delegation: who participates and with what weights ------------

    def cohort_size(self, num_clients: int) -> int:
        s = self.inner.cohort_size(num_clients)
        if self.groups > s:
            raise ValueError(
                f"groups={self.groups} exceeds the cohort size {s}")
        return s

    def cohort_weights(self, weights, combine, num_clients):
        return self.inner.cohort_weights(weights, combine, num_clients)

    @property
    def scale_bits(self):
        """The inner fixed-point grid (None for linear inners), so the
        engine's compressor / aggregation grid check sees through the
        tree."""
        return getattr(self.inner, "scale_bits", None)

    def members(self, num_clients: int) -> int:
        """M = ⌈S/G⌉, the members of a group (the last group is padded
        with sentinel members when G ∤ S)."""
        return -(-self.cohort_size(num_clients) // self.groups)

    def _ring_inner(self) -> bool:
        return getattr(self.inner, "scale_bits", None) is not None

    # -- the tree ------------------------------------------------------

    def tree_combine(self, grouped, key_words, *, group_offset: int = 0,
                     member_offset: int = 0, members: Optional[int] = None,
                     num_groups: Optional[int] = None, reduce_members=None,
                     reduce_groups=None, alive=None, device: Device = None):
        """The two-level combine over group-blocked messages:
        ``tree_merge(tree_local(…))``.

        ``grouped`` leaves carry leading (G_loc, M_loc) axes, the local
        tile of the (G, M) grid at groups [group_offset, group_offset +
        G_loc) and member positions [member_offset, member_offset +
        M_loc) of ``members``.  ``alive`` (optional (G_loc, members) 0/1
        rows) cancels a dropped member's masks inside its own group's
        level-1 combine; edge aggregators never drop, so level 2 needs
        none.  ``reduce_members`` and ``reduce_groups`` (the mesh's sums
        over its clients and groups axes, ``None`` where every member or
        group is local) complete the group sums and the root
        (:meth:`tree_merge`).  Returns the pre-finalize aggregate: for a
        secure inner the flat (R, 128) int32 root (:func:`repro_torch.
        kernels.ops.secure_group_sums` layout), otherwise the tree of
        sums.

        The levels stay two calls, as in the reference, whose pipelined
        engine runs level 1 in the produce half of a round and the
        reductions in the next round's consume."""
        level1 = self.tree_local(grouped, key_words,
                                 group_offset=group_offset,
                                 member_offset=member_offset,
                                 members=members, alive=alive, device=device)
        return self.tree_merge(level1, key_words, group_offset=group_offset,
                               num_groups=num_groups,
                               reduce_members=reduce_members,
                               reduce_groups=reduce_groups, device=device)

    def tree_local(self, grouped, key_words, *, group_offset: int = 0,
                   member_offset: int = 0, members: Optional[int] = None,
                   alive=None, device: Device = None):
        """Level 1 alone: the inner partial of each local group row, its
        key ``fold_in(round key, global group id)``.  A secure inner's
        partials are written into one flat (G_loc, R, 128) int32 buffer
        (:func:`repro_torch.kernels.ops.secure_group_sums`); a linear
        inner's are the tree of (G_loc, …) group sums."""
        first = tree.leaves(grouped)[0]
        g_loc = first.shape[0]
        m = first.shape[1] if members is None else int(members)
        gkeys = fold_in(np.asarray(key_words, np.uint32).reshape(-1),
                        np.arange(g_loc) + int(group_offset))
        if self._ring_inner():
            return _kops.secure_group_sums(
                grouped, gkeys, scale_bits=int(self.inner.scale_bits),
                members=m, member_offset=member_offset, alive=alive,
                device=device)
        parts = [self.inner.partial_combine(
            tree.map(lambda x: x[g], grouped), gkeys[g], member_offset, m,
            None if alive is None else alive[g], device=device)
            for g in range(g_loc)]
        return tree.map(lambda *xs: torch.stack(xs), *parts)

    def tree_merge(self, level1, key_words, *, group_offset: int = 0,
                   num_groups: Optional[int] = None, reduce_members=None,
                   reduce_groups=None, device: Device = None):
        """Levels 1½ and 2: ``reduce_members`` completes the group sums
        over the members held elsewhere, the local group partials are
        merged, masked in the Z_{2^32} ring for a secure inner's flat
        int32 buffer and a plain sum for a linear inner's float tree, and
        ``reduce_groups`` completes the root over the groups held
        elsewhere; the same pre-finalize contract as
        ``partial_combine``."""
        ng = self.groups if num_groups is None else int(num_groups)
        if reduce_members is not None:
            level1 = reduce_members(level1)
        if isinstance(level1, torch.Tensor) and level1.dtype == torch.int32:
            partial = _kops.secure_ring_partial_sum(
                level1, key_words, group_offset=group_offset,
                num_groups=ng, device=device)
        else:
            partial = _sum_clients(level1)
        if reduce_groups is not None:
            partial = reduce_groups(partial)
        return partial

    def _group(self, wmsgs, cohort: int):
        """(S, …) leaves → (G, M, …): the cohort axis zero-padded to G·M
        (sentinel members: they quantize to 0 and their masks still
        cancel) and blocked contiguously.  The schedule's group
        permutation has already reordered the cohort, so blocking is a
        reshape."""
        g = self.groups
        m = -(-cohort // g)
        pad = g * m - cohort

        def blk(x):
            if pad:
                x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
            return x.reshape(g, m, *x.shape[1:])

        return tree.map(blk, wmsgs)

    def _group_alive(self, alive, cohort: int):
        """(S,) alive bits → (G, M) rows.  Sentinel pads stay alive: their
        uploads are exact zeros either way, and their live mask streams
        keep the padded group's combine that of the unpadded protocol."""
        g = self.groups
        m = -(-cohort // g)
        pad = g * m - cohort
        alive = alive.to(torch.int32)
        if pad:
            alive = torch.cat([alive, alive.new_ones(pad)])
        return alive.reshape(g, m)

    def partial_combine(self, wmsgs, key_words, cohort_offset, cohort_size,
                        alive=None, *, device: Device = None):
        if not (isinstance(cohort_offset, int) and cohort_offset == 0):
            raise ValueError(
                "HierarchicalAggregation decomposes only over (groups, "
                "members) tiles (tree_local / tree_merge); a flat cohort "
                "shard cannot host the tree's two levels")
        del cohort_size
        if isinstance(wmsgs, torch.Tensor):
            return self.partial_combine({"m": wmsgs}, key_words, 0, None,
                                        alive, device=device)["m"]
        s = tree.leaves(wmsgs)[0].shape[0]
        if alive is not None:
            alive = self._group_alive(alive, s)
        out = self.tree_combine(self._group(wmsgs, s), key_words,
                                alive=alive, device=device)
        if isinstance(out, torch.Tensor):     # a secure inner's flat root
            out = _kops.unflatten(out, tree.map(lambda v: v[0], wmsgs))
        return out

    def finalize_combine(self, partial):
        return self.inner.finalize_combine(partial)

    def combine_messages(self, wmsgs, key_words, *, alive=None,
                         device: Device = None):
        return self.finalize_combine(self.partial_combine(
            wmsgs, key_words, 0, None, alive, device=device))

    # -- communication-ledger hooks ------------------------------------

    def participants(self, num_clients: int) -> int:
        return self.inner.participants(num_clients)

    def uplink_wire_bytes(self, payload_bytes: int, dense_elements: int,
                          num_clients: int) -> int:
        """A secure inner's client exchanges pair seeds with its M − 1
        group peers only; the masked payload is unchanged.  Linear inners
        are untouched by grouping."""
        if self._ring_inner():
            return self.inner.wire_bytes_for_peers(
                dense_elements, self.members(num_clients) - 1)
        return self.inner.uplink_wire_bytes(payload_bytes, dense_elements,
                                            num_clients)

    def recovery_bytes_per_drop(self, num_clients: int) -> int:
        """Group-local seed-share recovery: only the dropped slot's M − 1
        group peers hold shares of its pair secret."""
        if not self._ring_inner():
            return self.inner.recovery_bytes_per_drop(num_clients)
        return 4 * (self.members(num_clients) - 1)

    def group_uplink_bytes(self, payload_bytes: int, dense_elements: int,
                           num_clients: int) -> int:
        """The level-2 wire: each of the G edge aggregators uploads its
        group partial, a dense ring element plus G − 1 group-level seed
        shares for a secure inner, the plain payload otherwise.  Also the
        root's ingest."""
        del num_clients
        if self._ring_inner():
            return self.groups * self.inner.wire_bytes_for_peers(
                dense_elements, self.groups - 1)
        return self.groups * payload_bytes

    def mask_pair_count(self, num_clients: int) -> int:
        """Live pair-mask streams a round: G·M(M−1)/2 within groups plus
        G(G−1)/2 across them (0 for a maskless inner); flat secure holds
        S(S−1)/2."""
        if not self._ring_inner():
            return 0
        g, m = self.groups, self.members(num_clients)
        return g * (m * (m - 1) // 2) + g * (g - 1) // 2

    def root_ingest_bytes(self, dense_elements: int,
                          num_clients: int) -> int:
        """Bytes into the root a round: G group partials of 4-byte words
        instead of S client uploads."""
        del num_clients
        return self.groups * 4 * dense_elements


def plain() -> PlainAggregation:
    return PlainAggregation()


def secure(scale_bits: int = 20, streaming: bool = True,
           num_sampled: Optional[int] = None) -> SecureAggregation:
    return SecureAggregation(scale_bits=scale_bits, streaming=streaming,
                             num_sampled=num_sampled)


def sampled(num_sampled: int) -> SampledClients:
    return SampledClients(num_sampled=num_sampled)


def hierarchical(inner: Optional[Any] = None,
                 groups: int = 16) -> HierarchicalAggregation:
    """Two-level tree over ``inner`` (default: streaming secure)."""
    return HierarchicalAggregation(
        inner=secure() if inner is None else inner, groups=groups)
