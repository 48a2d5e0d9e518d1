"""The federated engine, cohort-native, with async rounds, on one device,
client-sharded over a 1-D mesh of ranks or tiled over the hierarchical
tree's 2-D (groups, clients) mesh.

The port of ``repro/fed/engine.py``'s round body, without scan.  Per
run:

1. the per-round cohorts (T, S) and their mini-batch schedule are drawn
   up front on the host (:func:`build_schedule`, the reference's draw:
   (T, S, B) for sum-combine algorithms, (T, S, E, B) for mean-combine
   ones; S = I is the identity cohort; a hierarchical aggregation's
   group permutation reorders each cohort row) and staged on the device
   once, with the training arrays; nothing (T, I, …)-shaped is drawn;
2. each round, a Python loop step, gathers the cohort's population
   weights, applies the strategy's ``cohort_weights`` (λ'), gathers the
   cohort's batches on the device and forms the aggregate:

   * sum-combine (Algorithms 1 and 2, FedSGD), linear aggregation
     (plain or sampled), no compressor: one upload on the λ'-weighted
     cohort super-batch — the upload is additive in the batch, so no
     per-client message is materialized;
   * otherwise per-slot uploads under ``torch.func.vmap`` over the S
     cohort slots: sum-combine ones with λ'_i folded into the per-sample
     weights, mean-combine ones (FedAvg's E local steps) weighted by λ'_i
     after the upload; compressed when a compressor is set (qsgd, top-k,
     or the count-sketch's two phases, :func:`_sketched_round`), the
     stream seeds keyed on the slots' global client ids and the
     error-feedback residuals gathered from and scattered back to the
     cohort's rows of a population-resident (I, …) arena (the rows of
     non-participants never move); a mean-combine message is compressed
     as its delta from the model; then the strategy's combine — for
     secure aggregation quantize, mask over the cohort positions and sum
     in one kernel launch;

   then ``server_step`` (the fused SSCA kernel when ``fused=True``);
3. eval probes and the algorithm's round metrics (Algorithm 2's slack)
   at every ``eval_every``-th round return device scalars that are read
   back once, after the loop, so no round waits on the host.

``staleness=`` (a :class:`repro_torch.fed.staleness.StalenessConfig`)
turns on the async round mode: a ring of the last K + 1 (parameters,
client state) snapshots, newest at slot 0; every cohort slot uploads
against the snapshot of its trace delay τ = min(trace, K), slots past K
are dropped (weight 0, compressed message gated to 0, residual kept,
secure pair masks cancelled through the masked sum's ``alive`` path),
and the weights are discounted by d(τ) and renormalized
(:func:`repro_torch.fed.staleness.discount_reweight`).  Each ring slot
a round reads runs the synchronous program, and each cohort row is
selected at its delay, so an all-zero trace equals the synchronous run
bit for bit.

``pipeline=True`` is, as in the reference, the async mode at the
constant τ ≡ 1 trace (K = 1, no discount), which it runs bit for bit.
The reference overlaps round t + 1's uploads with round t's combine; the
port runs both in order on one CUDA stream: its MLP rounds are host
bound (on an H100 the device is busy 1.4–10.7% of the round loop,
``PERF.md`` §5), so a second stream would have nothing to overlap yet.
``profile_dir`` traces the timed loop with ``torch.profiler``.

``mesh=`` (a :class:`repro_torch.launch.mesh.ClientMesh` over a
``torch.distributed`` group) shards each round's cohort, as the
reference's ``shard_map`` over ``"clients"`` does: the cohort is padded
to a multiple of the D ranks with sentinel slots (id I, weight 0,
compressed upload gated to 0, residual write dropped), every rank
computes the cohort-wide weights and uploads its S_loc slots at cohort
positions [rank·S_loc, (rank + 1)·S_loc), and the aggregate is
``finalize_combine(psum(partial_combine(…, offset, S_pad)))`` (the
linear fast path psums its one upload).  Under secure aggregation the
partials are int32 masked sums, so the aggregate, and each round's
model, are the one-device ones bit for bit.  ``arena="sharded"`` homes
the residual arena's rows and the weight vector on their clients' ranks
(:mod:`repro_torch.fed.arena`), gathered and written back through psums
of int32 bits; ``"replicated"`` keeps every row on every rank.  Async
rounds on the mesh draw the trace at the unpadded S and pad it with
τ = 0 (a sentinel is alive at weight 0); the combine's ``alive`` covers
the padded cohort's positions.  Under ``arena="sharded"`` the snapshot
ring is column-sharded too (:func:`repro_torch.fed.staleness.
ring_meta`): each rank keeps a (K + 1, ⌈n/D⌉) int32 block and rebuilds
the ring with one placed psum a round.  Pipelined rounds on the mesh
reduce the message paths' partials (the sketch's phase 1 among them)
with :meth:`~repro_torch.launch.mesh.ClientMesh.ring_psum_chunked`,
the reference's chunked ring, which equals the psum bit for bit.

``mesh=`` a :class:`repro_torch.launch.mesh.GroupMesh` of (g, c) ranks
runs the hierarchical tree as the reference's 2-D mesh does: the
cohort is blocked into G groups of M (the last group's tail padded when
G ∤ S) and the member axis padded to M_pad = ⌈M/c⌉·c; each rank uploads
its (G/g, M_pad/c) tile of slots, runs level 1 on it (the masked sum of
each local group at the tile's member offset, over the group's full
member row of ``alive``), completes the group sums over the clients
axis, merges its groups (the masked sum's ring mode at the tile's group
offset) and completes the root over the groups axis; pipelined rounds
take both axes through their chunked rings.  The cohort-wide weights
are formed over the S slots in cohort order, as on one device, and
placed at their padded positions.  The arena, the residual rows
(replicated by one placed psum of the tiles) and the snapshot ring shard
over all g·c ranks, groups-major.

The exact wire bytes of every round are recorded in the ledger.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch.func import vmap

from repro_torch import Device, resolve_device, tree
from repro_torch.data.partition import (Partition, sample_cohorts,
                                        sample_groups, sample_schedule,
                                        sample_staleness)
from repro_torch.fed import arena as arena_mod
from repro_torch.fed import compression as compression_mod
from repro_torch.fed import staleness as staleness_mod
from repro_torch.fed.aggregation import PlainAggregation
from repro_torch.fed.keys import phase2_key, round_keys
from repro_torch.kernels.compress import client_stream_seed
from repro_torch.kernels.ops import unflatten
from repro_torch.launch.mesh import ClientMesh, GroupMesh


_MLP_METRICS = ("train_cost", "test_accuracy", "sparsity")


@dataclasses.dataclass
class History:
    """Per-eval-point metrics plus the communication ledger.

    ``metrics`` maps each task-declared metric name to its series, aligned
    with ``rounds``; ``slack`` is the algorithm's slack s^t at each eval
    point (Algorithm 2; 0.0 for algorithms without one).
    ``uplink_bytes_per_round`` / ``downlink_bytes_per_round`` are the
    exact wire bytes of one round (see
    :func:`repro_torch.fed.compression.round_bytes`, breakdown in
    ``comm``); ``cum_uplink_bytes`` is the cumulative uplink at each eval
    point.  ``wall_seconds`` is the host time of the round loop, ending
    after the device has finished.
    """
    rounds: List[int] = dataclasses.field(default_factory=list)
    metrics: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    slack: List[float] = dataclasses.field(default_factory=list)
    cum_uplink_bytes: List[int] = dataclasses.field(default_factory=list)
    uplink_bytes_per_round: int = 0
    downlink_bytes_per_round: int = 0
    comm: Dict[str, Any] = dataclasses.field(default_factory=dict)
    wall_seconds: float = 0.0

    def metric(self, name: str) -> List[float]:
        """The (live, appendable) series for ``name``; inserts the series
        if absent."""
        return self.metrics.setdefault(name, [])

    @property
    def train_cost(self) -> List[float]:
        return self.metrics.get("train_cost", [])

    @property
    def test_accuracy(self) -> List[float]:
        return self.metrics.get("test_accuracy", [])

    @property
    def sparsity(self) -> List[float]:
        return self.metrics.get("sparsity", [])

    def as_dict(self) -> Dict[str, Any]:
        d = {"rounds": list(self.rounds),
             "metrics": {k: list(v) for k, v in self.metrics.items()},
             "slack": list(self.slack),
             "cum_uplink_bytes": list(self.cum_uplink_bytes),
             "uplink_bytes_per_round": self.uplink_bytes_per_round,
             "downlink_bytes_per_round": self.downlink_bytes_per_round,
             "comm": dict(self.comm),
             "wall_seconds": self.wall_seconds}
        # the MLP's metrics also as flat keys, as the reference writes them
        for k in _MLP_METRICS:
            d[k] = list(self.metrics.get(k, []))
        return d


def evaluator(task, data, eval_samples: int, device: torch.device,
              seed: int = 123):
    """The task's metric probe on a fixed eval subset (the reference's
    rng(123) draw of ``eval_samples`` training rows, and the whole test
    set), staged on ``device``.  Returns ``measure(params) -> {name: 0-d
    tensor}``."""
    rng = np.random.default_rng(seed)
    tr = rng.choice(len(data.x_train), size=min(eval_samples,
                                                len(data.x_train)),
                    replace=False)
    arrays = [torch.as_tensor(a, device=device) for a in
              (data.x_train[tr], data.y_train[tr], data.x_test, data.y_test)]

    @torch.no_grad()
    def measure(params):
        return task.measure(params, *arrays)
    return measure


def _round_ids(rounds: int, local_steps: int, e_axis: bool) -> np.ndarray:
    """The per-(round, local-step) sampling ids: t for the one-shot
    (sum-combine) algorithms, t·1000 + e for the local-step (mean-combine)
    ones, E = 1 included, as the reference draws them."""
    ts = np.arange(1, rounds + 1, dtype=np.int64)
    if not e_axis:
        return ts
    return (ts[:, None] * 1000 + np.arange(local_steps)).reshape(-1)


def build_schedule(part: Partition, batch_size: int, rounds: int,
                   local_steps: int, seed: int, e_axis: bool = False,
                   cohort_size=None, groups=None) -> tuple:
    """The per-round cohorts and their batches, drawn exactly as the
    reference's ``build_schedule`` draws them: ``(cohorts, idx)`` with
    ``cohorts`` (T, S) sorted client ids (the identity when S = I, the
    default) and ``idx`` (T, S, B) for sum-combine algorithms, or
    (T, S, E, B) when ``e_axis`` (mean-combine local-step algorithms, the
    E axis kept even at E = 1; each local step drawn under its own id
    t·1000 + e over the round's cohort).  Only the cohort's rows are
    emitted, so index memory is O(T·S·B).

    ``groups`` (hierarchical aggregation) reorders each cohort row by the
    round's group permutation (:func:`repro_torch.data.partition.
    sample_groups`), so group g is the block [g·M, (g + 1)·M).  Batches
    are drawn by client id, so no client's batches move."""
    i = part.num_clients
    s = i if cohort_size is None else int(cohort_size)
    cohorts = sample_cohorts(i, s, np.arange(1, rounds + 1,
                                             dtype=np.int64), seed)
    if groups is not None and int(groups) > 1:
        perm = sample_groups(s, int(groups),
                             np.arange(1, rounds + 1, dtype=np.int64), seed)
        cohorts = np.take_along_axis(cohorts, perm, axis=1)
    ids = _round_ids(rounds, local_steps, e_axis)
    per_id = cohorts if not e_axis \
        else np.repeat(cohorts, local_steps, axis=0)
    idx = sample_schedule(part, batch_size, ids, seed,
                          cohorts=per_id)                   # (T·E, S, B)
    if e_axis:
        idx = idx.reshape(rounds, local_steps, s,
                          batch_size).transpose(0, 2, 1, 3)
    return cohorts, idx


def _staleness_trace(staleness, staleness_trace, cohort: int, rounds: int,
                     seed: int):
    """The (T, S) int64 delay trace of an async run, or ``None`` for a
    synchronous one: drawn from ``staleness.delay_probs`` on its own rng
    stream, or the caller's, validated."""
    if staleness_trace is not None and staleness is None:
        raise ValueError(
            "staleness_trace requires the async round mode: pass a "
            "repro_torch.fed.staleness.StalenessConfig as staleness=")
    if staleness is None:
        return None
    if not isinstance(staleness, staleness_mod.StalenessConfig):
        raise TypeError(f"staleness={staleness!r} is not a "
                        "repro_torch.fed.staleness.StalenessConfig")
    if staleness_trace is None:
        return sample_staleness(cohort, np.arange(1, rounds + 1,
                                                  dtype=np.int64),
                                seed, staleness.delay_probs)
    trace = np.asarray(staleness_trace, np.int64)
    if trace.shape != (rounds, cohort):
        raise ValueError(f"staleness_trace shape {trace.shape} != (rounds, "
                         f"cohort) = {(rounds, cohort)}")
    if (trace < 0).any():
        raise ValueError("staleness_trace delays must be >= 0")
    return trace


def _async_ledger(trace, max_staleness: int, aggregation,
                  num_clients: int) -> Dict[str, Any]:
    """``History.comm["async"]``: the trace's stale share and dropouts,
    and the seed-share recovery bytes the strategy charges a drop."""
    dropped = int(staleness_mod.dropped_per_round(trace,
                                                  max_staleness).sum())
    rec = getattr(aggregation, "recovery_bytes_per_drop", None)
    rec_per = int(rec(num_clients)) if rec else 0
    return {"max_staleness": max_staleness,
            "stale_fraction": float((trace > 0).mean()),
            "dropped_total": dropped,
            "dropout_rate": float(dropped / trace.size),
            "recovery_bytes_per_drop": rec_per,
            "recovery_bytes_total": dropped * rec_per}


def _check_compressor(compressor, aggregation):
    """``None`` for no compressor or the identity (the same trajectory as
    none); refuses what is not a compressor, and a grid-emitting
    compressor whose fixed-point grid differs from the aggregation's (the
    masked sum of its values would no longer be exact)."""
    if compressor is None:
        return None
    if not hasattr(compressor, "is_identity") \
            or not hasattr(compressor, "payload_bytes"):
        raise TypeError(f"compressor={compressor!r} is not a compressor "
                        "(see repro_torch.fed.compression and .sketch)")
    if compressor.is_identity:
        return None
    comp_grid = getattr(compressor, "scale_bits", None)
    agg_grid = getattr(aggregation, "scale_bits", None)
    if comp_grid is not None and agg_grid is not None \
            and int(comp_grid) != int(agg_grid):
        raise ValueError(
            f"compressor scale_bits={int(comp_grid)} != aggregation "
            f"scale_bits={int(agg_grid)}: the compressor emits values on "
            "the 2^-scale_bits fixed-point grid and the secure masked sum "
            "is only exact when the grids match")
    return compressor


def _rows(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (S,) slot mask shaped to broadcast over ``like``'s rows."""
    return mask.reshape((-1,) + (1,) * (like.ndim - 1))


def _sketched_round(compressor, aggregation, msgs, resid, seeds, key_words,
                    dev, alive=None, keep=None, phase2=None):
    """The count-sketch's two phases (the reference's sketched branch):
    sketch every slot's message plus residual, combine the sketches under
    the round key, take the support from the aggregate, combine the
    slots' on-grid values at the support under ``fold_in(round key,
    0x5EED)`` (through ``phase2``, ``aggregation`` by default), and debit
    each slot's residual by its own values.  ``keep`` (the slots' row
    mask) gates a dropped slot's or a sentinel's sketch and values to
    zero; with ``alive`` (async rounds, over the cohort's positions)
    both combines cancel a dropped slot's masks.  Returns (the k-sparse
    update, new residuals)."""
    def gate(c):
        if keep is None:
            return c
        return torch.where(_rows(keep, c), c, torch.zeros_like(c))

    inp = tree.map(lambda m, r: m.float() + r, msgs, resid)
    like = tree.map(lambda v: v[0], inp)
    sk = gate(compressor.encode(inp, seeds, device=dev))
    support = compressor.support(
        aggregation.combine_messages(sk, key_words, alive=alive,
                                     device=dev), like)
    vals = compressor.values(inp, support, seeds)
    agg_v = (phase2 or aggregation).combine_messages(
        gate(vals), phase2_key(key_words), alive=alive, device=dev)
    return compressor.reassemble(agg_v, support, like), \
        compressor.update_residual(inp, support, vals)


@dataclasses.dataclass(frozen=True)
class _MeshCombine:
    """A strategy's combine on a client mesh, the reference's 1-D mesh
    ``_combine``: ``finalize_combine`` of the psum of the ranks'
    ``partial_combine``s, each rank's slots at cohort positions
    [offset, offset + S_loc) of the padded ``cohort_size``; ``alive``
    covers all of its positions.  ``chunked`` (pipelined rounds) reduces
    through the mesh's chunked ring instead of the psum, bit for bit the
    same sum."""
    aggregation: Any
    mesh: ClientMesh
    offset: int
    cohort_size: int
    chunked: bool = False

    def combine_messages(self, wmsgs, key_words, *, alive=None,
                         device: Device = None):
        agg = self.aggregation
        reduce = self.mesh.ring_psum_chunked if self.chunked \
            else self.mesh.psum
        return agg.finalize_combine(reduce(agg.partial_combine(
            wmsgs, key_words, self.offset, self.cohort_size, alive,
            device=device)))


class _Tile(NamedTuple):
    """A rank's tile of the round's (G, M_pad) grid on the group mesh:
    groups [g_off, g_off + g_loc) and member positions [m_off, m_off +
    m_loc)."""
    groups: int
    m_pad: int
    g_loc: int
    m_loc: int
    g_off: int
    m_off: int


@dataclasses.dataclass(frozen=True)
class _GroupMeshCombine:
    """The tree's combine on the (groups, clients) mesh, the reference's
    2-D mesh ``_combine``: ``tree_local`` over the rank's (g_loc, m_loc)
    ``tile`` of slots, the group sums completed over the clients axis,
    the local groups merged (by the masked sum's ring mode for a secure
    inner), the root completed over the groups axis, then
    ``finalize_combine``.  ``alive`` covers the padded cohort's (G·M_pad)
    positions; each local group cancels its dropped members' masks over
    its full member row.  ``chunked`` (pipelined rounds) reduces both
    axes through their chunked rings instead of the psums."""
    aggregation: Any
    mesh: GroupMesh
    tile: _Tile
    chunked: bool = False

    def combine_messages(self, wmsgs, key_words, *, alive=None,
                         device: Device = None):
        if isinstance(wmsgs, torch.Tensor):          # the sketch's phases
            return self.combine_messages({"m": wmsgs}, key_words,
                                         alive=alive, device=device)["m"]
        agg, tl = self.aggregation, self.tile
        rows = None if alive is None else alive.reshape(
            tl.groups, tl.m_pad)[tl.g_off:tl.g_off + tl.g_loc]
        members, groups = (
            axis.ring_psum_chunked if self.chunked else axis.psum
            for axis in (self.mesh.clients, self.mesh.groups))
        partial = agg.tree_combine(
            tree.map(lambda x: x.reshape((tl.g_loc, tl.m_loc) + x.shape[1:]),
                     wmsgs),
            key_words, group_offset=tl.g_off, member_offset=tl.m_off,
            members=tl.m_pad, num_groups=tl.groups, reduce_members=members,
            reduce_groups=groups, alive=rows, device=device)
        if isinstance(partial, torch.Tensor):   # a secure inner's flat root
            partial = unflatten(partial, tree.map(lambda v: v[0], wmsgs))
        return agg.finalize_combine(partial)


class _SnapshotRing:
    """The async mode's last K + 1 (parameters, client state) snapshots,
    newest at slot 0; rounds before the run see the initial point.

    Replicated (``meta`` None): a list of parameter trees.  Column-sharded
    (``meta``, a mesh under ``arena="sharded"``): the rank's (K + 1,
    chunk) int32 block of the packed ring; :meth:`open`, on every rank
    once a round, rebuilds the whole packed ring with one placed psum,
    and :meth:`push` packs the new snapshot, shifts it in and keeps the
    rank's block.  A slot read from the packed ring is copied out of it
    into a fresh tensor, as a server step's output is, so both forms run
    one trajectory bit for bit.  The client states stay a replicated
    list."""

    def __init__(self, params, cstate, depth: int, meta=None, mesh=None):
        self.meta, self.mesh = meta, mesh
        self.cstates = [cstate] * depth
        self.full = None
        if meta is None:
            self.snaps = [params] * depth
        else:
            phist = tree.map(lambda p: p[None].expand((depth,) + p.shape),
                             params)
            self.block = staleness_mod.ring_localize(
                staleness_mod.pack_ring(phist, meta), meta, mesh.rank)

    def open(self) -> None:
        if self.meta is not None:
            self.full = staleness_mod.ring_unshard(
                self.block, self.meta, self.mesh.rank, self.mesh.psum)

    def params(self, k: int):
        if self.meta is None:
            return self.snaps[k]
        return tree.map(torch.clone, staleness_mod.unpack_snapshot(
            self.full, self.meta, k))

    def stacked(self):
        """Every slot's parameters, leaves (K + 1, …)."""
        if self.meta is None:
            return tree.map(lambda *h: torch.stack(h), *self.snaps)
        return staleness_mod.unpack_ring(self.full, self.meta)

    def cstate(self, k: int):
        return self.cstates[k]

    def push(self, params, cstate) -> None:
        self.cstates = [cstate] + self.cstates[:-1]
        if self.meta is None:
            self.snaps = [params] + self.snaps[:-1]
            return
        new = staleness_mod.pack_snapshot(params, self.meta)
        self.block = staleness_mod.ring_localize(
            torch.cat([new[None], self.full[:-1]]), self.meta,
            self.mesh.rank)
        self.full = None


class _Layout(NamedTuple):
    """Where a mesh puts a round's S cohort slots: ``slot_of`` (P,) maps
    each of the P padded positions to its cohort slot, S for a sentinel
    pad (id I, zero round weight, gated upload, write-back dropped);
    ``local`` holds the rank's positions (a slice on the client mesh,
    the tile's positions row-major on the group mesh), ``tile`` the
    group mesh's :class:`_Tile` (``None`` on the client mesh)."""
    slot_of: np.ndarray
    local: Any
    tile: Optional[_Tile] = None

    def pad(self, rows: np.ndarray, fill) -> np.ndarray:
        """(T, S, …) host rows at the P padded positions, ``fill`` at
        the pads."""
        ext = np.full(rows.shape[:1] + (1,) + rows.shape[2:], fill,
                      rows.dtype)
        return np.concatenate([rows, ext], 1)[:, self.slot_of]

    def live_positions(self, cohort: int) -> np.ndarray:
        """(S,): the padded position of each cohort slot."""
        pos = np.empty(cohort, np.int64)
        live = self.slot_of < cohort
        pos[self.slot_of[live]] = np.nonzero(live)[0]
        return pos


def _cohort_layout(mesh, cohort: int, groups) -> _Layout:
    """The padded cohort of a mesh run.  On the client mesh the S slots
    are padded to a multiple of the D ranks at the end, so any (S, D)
    runs (S = 1 on two ranks included), and a rank holds a contiguous
    slice.  On the (g, c) group mesh the reference's ``_block_schedule``:
    the cohort, already group-permuted, is blocked into G groups of M =
    ⌈S/G⌉ (the last group's tail padded when G ∤ S) and the member axis
    padded to M_pad = ⌈M/c⌉·c, so position g·M_pad + j holds slot g·M + j;
    a rank holds the (G/g, M_pad/c) tile at its coordinates."""
    if isinstance(mesh, GroupMesh):
        g_shards, c_shards = mesh.shape
        gi, ci = mesh.coords
        m = -(-cohort // groups)
        m_pad = -(-m // c_shards) * c_shards
        j = np.arange(m_pad)[None, :]
        slot = np.arange(groups)[:, None] * m + j
        slot_of = np.where((j < m) & (slot < cohort), slot, cohort)
        tile = _Tile(groups, m_pad, groups // g_shards, m_pad // c_shards,
                     gi * (groups // g_shards), ci * (m_pad // c_shards))
        local = ((tile.g_off + np.arange(tile.g_loc))[:, None] * m_pad
                 + tile.m_off + np.arange(tile.m_loc)[None, :]).reshape(-1)
        return _Layout(slot_of.reshape(-1), local, tile)
    width = -(-cohort // mesh.size) * mesh.size
    s_loc = width // mesh.size
    return _Layout(np.minimum(np.arange(width), cohort),
                   slice(mesh.rank * s_loc, (mesh.rank + 1) * s_loc))


def _staged_schedule(schedule: np.ndarray, dev: torch.device) -> torch.Tensor:
    """The rank's batch schedule on the device, contiguous: a batch
    gathered through a strided index keeps the index's strides, and the
    card's matrix products can round strided and contiguous operands
    differently, so one device and every mesh layout (whose padding and
    tiling reorder the host array's strides) gather from one layout."""
    return torch.as_tensor(np.ascontiguousarray(schedule), device=dev)


def _check_mesh(mesh, aggregation) -> None:
    """Refuse what the sharded rounds do not run: a mesh that is neither
    the 1-D client mesh nor the (groups, clients) mesh, the tree on the
    client mesh, a flat strategy on the group mesh, and a tree whose G
    the groups axis does not divide."""
    if mesh is None:
        return
    groups = getattr(aggregation, "groups", None)
    if isinstance(mesh, GroupMesh):
        if groups is None:
            raise ValueError(
                "a (groups, clients) mesh needs a HierarchicalAggregation: "
                "flat strategies shard over the 1-D client mesh of "
                "repro_torch.launch.make_client_mesh")
        if int(groups) % mesh.shape[0]:
            raise ValueError(
                f"groups={int(groups)} must be a multiple of the mesh's "
                f"groups axis ({mesh.shape[0]} shards): a group cannot span "
                "the axis its level-2 combine reduces over")
        return
    if not isinstance(mesh, ClientMesh):
        raise NotImplementedError(
            f"mesh={mesh!r}: the port runs the 1-D client mesh "
            "(repro_torch.launch.make_client_mesh) and the 2-D (groups, "
            "clients) mesh (make_group_mesh), no other mesh")
    if groups is not None:
        raise ValueError(
            "HierarchicalAggregation shards over a 2-D (groups, clients) "
            "mesh (repro_torch.launch.make_group_mesh), not the 1-D client "
            "mesh: a flat cohort shard cannot host the tree's two "
            "reductions")


def _run_device(mesh, device: Device) -> torch.device:
    """The run's device: the mesh rank's own when a mesh is set (a
    ``device`` that names another is refused), else ``cuda`` unless the
    caller asks for the CPU."""
    if mesh is None:
        return resolve_device(device)
    if device is not None:
        want = torch.device(device)
        if want.type != mesh.device.type or (
                want.index is not None and want != mesh.device):
            raise ValueError(f"device={device!r} but the mesh's rank "
                             f"{mesh.rank} runs on {mesh.device}")
    return mesh.device


@contextlib.contextmanager
def _traced(profile_dir, dev: torch.device):
    """With a ``profile_dir``, the block runs under ``torch.profiler`` (the
    CPU, and the card when ``dev`` is one) and its Chrome trace is written
    as one new file under that directory; otherwise nothing is traced."""
    if profile_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(
        out / f"repro_torch.{os.getpid()}.{time.time_ns()}.pt.trace.json"))


@contextlib.contextmanager
def _full_f32_matmuls():
    """Matrix products in full f32 inside the block, as the reference's
    are (TF32 would keep about three decimal digits); the caller's
    setting is restored after it, as the reference changes no global
    setting."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@_full_f32_matmuls()
def run(algorithm, data, part: Partition, *, task, batch_size: int,
        rounds: int, params=None, seed: int = 0, eval_every: int = 1,
        eval_samples: int = 10000, aggregation=None, compressor=None,
        mesh=None, arena=None, staleness=None, staleness_trace=None,
        pipeline: bool = False, profile_dir=None,
        device: Device = None) -> tuple:
    """Run ``algorithm`` on ``task`` for ``rounds`` rounds on ``device``
    (``cuda`` unless the caller asks for the CPU).

    ``params=None`` initializes from ``task.init_params`` with a CPU
    generator seeded by ``seed``.  ``seed`` also keys the cohort draw, the
    batch schedule, the staleness trace and the per-round aggregation key
    words.  ``aggregation`` sets the cohort size S (``sampled(S)``,
    ``secure(num_sampled=S)``; full participation by default).
    ``compressor`` (qsgd, top-k or the count-sketch) compresses every
    upload; a stateful one keeps its error-feedback residuals, shaped
    like one client's message, in an (I, …) arena on ``device``.
    ``staleness`` (a :class:`repro_torch.fed.staleness.StalenessConfig`)
    turns on async rounds with a trace drawn from its ``delay_probs``, or
    the (rounds, S) ``staleness_trace`` given; ``History.comm["async"]``
    then holds the trace's dropouts and their recovery bytes.
    ``aggregation`` may be the hierarchical tree
    (:func:`repro_torch.fed.aggregation.hierarchical`), with any of the
    above.  ``pipeline=True`` runs the async mode at the constant τ ≡ 1
    trace (K = 1, no discount) without an ``alive`` mask, as the
    reference's pipelined rounds do, and writes ``comm["pipeline"]``; it
    refuses ``staleness=``.  ``profile_dir`` writes one Chrome trace of
    the timed loop there (``torch.profiler``).

    ``mesh`` (a :class:`repro_torch.launch.mesh.ClientMesh`) shards each
    round's cohort over the mesh's ranks: every rank makes the same call,
    uploads its S_loc = S_pad / D slots at cohort positions [rank·S_loc,
    (rank + 1)·S_loc) and takes the aggregate from one psum of the
    strategy's partials (int32 masked partials under secure aggregation,
    so the aggregate is the one-device aggregate bit for bit; pipelined
    rounds reduce the message paths' partials with the chunked ring
    :meth:`~repro_torch.launch.mesh.ClientMesh.ring_psum_chunked`, the
    same sum); the cohort is padded to a multiple of D with sentinel
    slots of weight 0, and an async trace, drawn at the unpadded S as on
    one device, with τ = 0.  Every rank returns the same parameters and
    :class:`History`.  ``arena`` places the population-resident state on
    the mesh: ``"sharded"`` (the default with a mesh) homes each client's
    residual row and population weight on one rank
    (:mod:`repro_torch.fed.arena`) and shards the async snapshot ring's
    columns over the ranks, ``"replicated"`` keeps all of them on every
    rank; the two are bit for bit one run.  Without a mesh ``arena`` is
    ignored, as in the reference.  The client mesh runs flat strategies
    (with the tree it raises ``ValueError``); the hierarchical tree runs
    on a :class:`repro_torch.launch.mesh.GroupMesh` (``make_group_mesh(g,
    c)``, g dividing G; a flat strategy on it raises ``ValueError``):
    each rank uploads its (G/g, M_pad/c) tile of the blocked cohort and
    the level-1 and level-2 partials are reduced over the clients and
    groups axes (int32 masked partials for a secure inner, so the run is
    the one-device tree's bit for bit).  Returns the final parameters
    (on ``device``) and the :class:`History`.
    """
    if arena not in (None, "replicated", "sharded"):
        raise ValueError(
            f"arena={arena!r} not in (None, 'replicated', 'sharded')")
    aggregation = aggregation if aggregation is not None \
        else PlainAggregation()
    _check_mesh(mesh, aggregation)
    dev = _run_device(mesh, device)
    combine = algorithm.combine
    compressor = _check_compressor(compressor, aggregation)
    num_clients = part.num_clients
    cohort = aggregation.cohort_size(num_clients)        # validates S
    if params is None:
        params = task.init_params(torch.Generator().manual_seed(seed))
    params = tree.map(lambda v: v.detach().to(dev, torch.float32, copy=True),
                      params)
    cohorts, schedule = build_schedule(part, batch_size, rounds,
                                       algorithm.local_steps, seed,
                                       e_axis=combine == "mean",
                                       cohort_size=cohort,
                                       groups=getattr(aggregation, "groups",
                                                      None))
    if pipeline and staleness is not None:
        raise ValueError(
            "pipeline=True IS the constant tau=1 bounded-staleness "
            "schedule, executed overlapped on hardware; composing it "
            "with an async staleness= config is not defined — pick one")
    trace = _staleness_trace(staleness, staleness_trace, cohort, rounds,
                             seed)
    if pipeline:
        # every slot one round stale, undiscounted: the reference's
        # pipelined trajectory; no slot drops, so no alive mask is passed
        staleness = staleness_mod.StalenessConfig(
            max_staleness=1, schedule=staleness_mod.ConstantDiscount())
        trace = np.ones((rounds, cohort), np.int64)
    is_async = trace is not None
    # the rank's cohort positions (``local`` on the host, ``local_t`` on
    # the device): all S without a mesh
    s_pad, plan, me = cohort, None, None
    local = local_t = slice(0, cohort)
    combiner = phase2 = aggregation
    if mesh is not None:
        layout = _cohort_layout(mesh, cohort,
                                getattr(aggregation, "groups", None))
        cohorts = layout.pad(cohorts, num_clients)
        local = layout.local
        schedule = layout.pad(schedule, 0)[:, local]
        s_pad = len(layout.slot_of)
        local_t = local if layout.tile is None \
            else torch.as_tensor(local, device=dev)
        # the cohort slots' positions, for the cohort-wide weights
        pos_of = torch.as_tensor(layout.live_positions(cohort), device=dev)
        if (arena or "sharded") == "sharded":
            plan = arena_mod.make_plan(num_clients, mesh)
            me = arena_mod.shard_index(plan, mesh)
        if layout.tile is None:
            combiner = _MeshCombine(aggregation, mesh, local.start, s_pad,
                                    chunked=pipeline)
        else:
            combiner = _GroupMeshCombine(aggregation, mesh, layout.tile,
                                         chunked=pipeline)
        # the sketch's phase 2 keeps the psum, as the reference's
        # pipelined consume does
        phase2 = dataclasses.replace(combiner, chunked=False)
    cohorts_dev = torch.as_tensor(cohorts, device=dev)
    schedule = _staged_schedule(schedule, dev)
    x_train = torch.as_tensor(data.x_train, device=dev)
    y_train = torch.as_tensor(data.y_train, device=dev)
    weights = torch.as_tensor(algorithm.client_weights(part, batch_size),
                              device=dev)
    if plan is not None:
        # the (I,)-resident weight vector is home-sharded like the arena
        weights = arena_mod.home_rows(plan, weights, me)
    keyw = round_keys(seed, rounds)
    state = algorithm.init_state(params)
    measure = evaluator(task, data, eval_samples, dev)
    ledger = compression_mod.round_bytes(algorithm, aggregation, compressor,
                                         params, num_clients)
    hist = History(uplink_bytes_per_round=ledger.uplink_total,
                   downlink_bytes_per_round=ledger.downlink_total,
                   comm=ledger.as_dict())
    resid_arena = None
    if compressor is not None:
        # the per-(round, slot) stream seeds, from the round key's first
        # and last words and the slot's global client id, so a client's
        # draws do not depend on its cohort position: (T, S), staged once
        kw64 = keyw.astype(np.int64)
        seeds = torch.as_tensor(client_stream_seed(
            kw64[:, :1], kw64[:, -1:], cohorts)[:, local], device=dev)
    if is_async:
        k_max = staleness.max_staleness
        if pipeline:
            hist.comm["pipeline"] = {"enabled": True, "depth": 1,
                                     "extra_snapshot_slots": 1}
        else:
            hist.comm["async"] = _async_ledger(trace, k_max, aggregation,
                                               num_clients)
        # τ = min(trace, K); τ > K drops the slot (discount 0, masks
        # cancelled, residual kept).  The discounts cover the S cohort
        # slots, alive the padded cohort's positions and τ the rank's: a
        # sentinel is τ = 0, alive at weight 0
        tau_live = torch.as_tensor(np.minimum(trace, k_max), device=dev)
        disc_dev = torch.where(torch.as_tensor(trace <= k_max, device=dev),
                               staleness.discount(tau_live), 0.0)
        if mesh is not None:
            trace = layout.pad(trace, 0)
        tau_host = np.minimum(trace, k_max)[:, local]
        tau_dev = torch.as_tensor(tau_host, device=dev)
        alive_dev = torch.as_tensor((trace <= k_max).astype(np.int32),
                                    device=dev)
        # the snapshot ring; a delayed slot in round 1 replays against
        # the initial point
        meta = None if plan is None \
            else staleness_mod.ring_meta(params, mesh.size)
        ring = _SnapshotRing(params, algorithm.client_state(state),
                             k_max + 1, meta, mesh)
        # the sum-combine uploads read no state: they replay at the live one
        has_cs = bool(tree.leaves(ring.cstate(0)))

    def weighted(msgs, rw):
        """λ'_i · m_i for each slot's leaf row."""
        return tree.map(lambda m: m * _rows(rw, m), msgs)

    def vmapped(batch, t):
        """The per-slot uploads.  Async: the synchronous program once per
        ring slot this round reads, each cohort row selected at its
        delay (so slot 0 alone is the synchronous run)."""
        def at(p, s):
            return vmap(lambda b: algorithm.client_upload(p, s, b))(batch)
        if not is_async:
            return at(params, state)
        out = None
        for k in np.unique(tau_host[t]):
            out_k = at(ring.params(k), ring.cstate(k) if has_cs else state)
            sel = tau_dev[t] == int(k)
            out = out_k if out is None else tree.map(
                lambda o, ok: torch.where(_rows(sel, o), ok, o), out, out_k)
        return out

    def aggregate(t):
        """Round t's aggregate.  The (S_loc, …) per-slot uploads are
        locals here, so they are freed before the server step."""
        nonlocal resid_arena
        cohort_t = cohorts_dev[t]                    # (S_pad,), every rank
        idx_t = schedule[t]                  # (S_loc, B) or (S_loc, E, B)
        live_full = live_loc = keep = None
        if mesh is None:
            w_c = weights[cohort_t]
        else:
            # the S slots' weights out of the padded cohort's (the
            # sentinel pads, id I, clamped in the replicated gather, read
            # their dead row in the home-sharded one)
            live_full = cohort_t < num_clients
            if plan is None:
                w_c = weights[cohort_t.clamp(max=num_clients - 1)]
            else:
                w_c = arena_mod.gather_rows(plan, weights, cohort_t, me,
                                            mesh.psum)
            w_c = w_c[pos_of]
            keep = live_loc = live_full[local_t]
        # the cohort-wide weights over the S slots in cohort order, as on
        # one device, on every rank (async: discounted); on a mesh placed
        # at their padded positions, the pads at 0; then the rank's slots
        rw_live = aggregation.cohort_weights(w_c, combine, num_clients)
        if is_async:
            rw_live = staleness_mod.discount_reweight(rw_live, disc_dev[t])
        rw_full = rw_live if mesh is None else \
            rw_live.new_zeros(s_pad).index_copy_(0, pos_of, rw_live)
        alive = alive_loc = None
        if is_async and not pipeline:
            # over the padded cohort's positions for the combine, the
            # rank's slots for its gates
            alive = alive_dev[t]
            alive_loc = alive[local_t] != 0
            keep = alive_loc if keep is None else keep & alive_loc
        rw = rw_full[local_t]

        def gate(c):
            """A slot's compressed upload zeroed where it never arrived
            (an async dropout) or is a mesh's sentinel pad."""
            if keep is None:
                return c
            return torch.where(_rows(keep, c), c, torch.zeros_like(c))

        if combine == "sum" and compressor is None \
                and not aggregation.needs_messages:
            # linear fast path: one upload on the weighted super-batch
            # (on a mesh, the rank's slots', psummed); async, one per
            # ring slot read, its weights masked to the slots at that
            # delay
            flat = idx_t.reshape(-1)
            bx, by = x_train[flat], y_train[flat]
            if not is_async:
                agg = algorithm.client_upload(
                    params, state,
                    (bx, by, rw.repeat_interleave(idx_t.shape[1])))
                return agg if mesh is None else mesh.psum(agg)
            agg = None
            for k in np.unique(tau_host[t]):
                wk = torch.where(tau_dev[t] == int(k), rw, 0.0)
                g = algorithm.client_upload(
                    ring.params(k), state,
                    (bx, by, wk.repeat_interleave(idx_t.shape[1])))
                agg = g if agg is None else tree.map(torch.add, agg, g)
            return agg if mesh is None else mesh.psum(agg)
        # the per-slot bases of mean-combine deltas: each slot's snapshot
        base = params
        if is_async and combine == "mean" and compressor is not None:
            hist_p = ring.stacked()
            base = tree.map(lambda h: h[tau_dev[t]], hist_p)
        if combine == "sum":
            ws = rw[:, None].expand(idx_t.shape)     # λ'_i per sample
            raw = vmapped((x_train[idx_t], y_train[idx_t], ws), t)
        else:                                                # mean: models
            models = vmapped((x_train[idx_t], y_train[idx_t]), t)
            raw = models if compressor is None else \
                tree.map(lambda m, p: m - p, models, base)
        if compressor is None:
            msgs = raw if combine == "sum" else weighted(raw, rw)
            return combiner.combine_messages(msgs, keyw[t], alive=alive,
                                             device=dev)
        if compressor.stateful and resid_arena is None:
            resid_arena = compressor.init_client_state(
                tree.map(lambda v: v[0], raw),
                num_clients if plan is None else plan.rows_per_shard)
        resid = None
        if resid_arena is not None:
            if mesh is None:
                resid = tree.map(lambda a: a[cohort_t], resid_arena)
            elif plan is None:
                # a sentinel reads zeros, as from the sharded dead row
                resid = tree.map(lambda a: torch.where(
                    _rows(live_loc, a[:1]),
                    a[cohort_t[local_t].clamp(max=num_clients - 1)], 0.0),
                    resid_arena)
            else:
                resid = tree.map(lambda a: a[local_t], arena_mod.gather_rows(
                    plan, resid_arena, cohort_t, me, mesh.psum))
        if getattr(compressor, "sketched", False):
            # λ' is applied before the encode (the bucket values must
            # stay on the fixed-point grid); a sum-combine message
            # carries it already
            msgs = raw if combine == "sum" else weighted(raw, rw)
            if mesh is not None:
                # a sentinel pad's message and residual are zero, so its
                # sketch and phase-2 values are exact zeros
                msgs = tree.map(gate, msgs)
            agg, new_resid = _sketched_round(compressor, combiner, msgs,
                                             resid, seeds[t], keyw[t], dev,
                                             alive, alive_loc, phase2)
            if combine == "mean":
                if is_async:
                    # the deltas were taken against the slots' own
                    # snapshots: the update applies to ω^t + Σ λ'_i
                    # (ω^{t−τ_i} − ω^t), summed over the S cohort slots
                    # on every rank; an exact zero shift on an all-zero
                    # trace (the where keeps −0.0 + x exact)
                    shift = tree.map(
                        lambda p, h: (_rows(rw_live, p[None])
                                      * (h[tau_live[t]] - p[None])).sum(0),
                        params, hist_p)
                    agg = tree.map(
                        lambda sh, d: torch.where(sh == 0, d, sh + d),
                        shift, agg)
                agg = tree.map(lambda p, d: p + d, params, agg)
        else:
            comp, new_resid = compressor.compress(raw, resid, seeds[t],
                                                  device=dev)
            # a dropped slot's upload never arrived; a pad's is zero
            comp = tree.map(gate, comp)
            msgs = comp if combine == "sum" else weighted(
                tree.map(lambda d, p: p + d, comp, base), rw)
            agg = combiner.combine_messages(msgs, keyw[t], alive=alive,
                                            device=dev)
        if resid_arena is not None:
            write_back(new_resid, resid, cohort_t, live_full, alive_loc)
        return agg

    def write_back(new_resid, resid, cohort_t, live_full, alive_loc):
        """The cohort's new residual rows into the arena.  A dropped
        async slot keeps its row; on a mesh one psum replicates every
        rank's rows, then the live ones are written: all of them into the
        replicated arena, the rank's own into the home-sharded one."""
        if alive_loc is not None:
            # a dropped slot applied nothing: its residual rides through
            new_resid = tree.map(lambda nr, od: torch.where(
                _rows(alive_loc, nr), nr, od), new_resid, resid)
        if mesh is None:
            for a, r in zip(tree.leaves(resid_arena),
                            tree.leaves(new_resid)):
                a[cohort_t] = r
            return
        tl = layout.tile
        if tl is None:
            rows = arena_mod.replicate_rows(new_resid, s_pad,
                                            layout.local.start, mesh.psum)
        else:
            rows = arena_mod.replicate_rows_2d(
                new_resid, (tl.groups, tl.m_pad), (tl.g_loc, tl.m_loc),
                (tl.g_off, tl.m_off), mesh.psum)
        if plan is not None:
            arena_mod.scatter_rows(plan, resid_arena, rows, cohort_t,
                                   live_full, me)
            return
        for a, r in zip(tree.leaves(resid_arena), tree.leaves(rows)):
            a[cohort_t[pos_of]] = r[pos_of]

    evals = []
    with _traced(profile_dir, dev):
        t0 = time.perf_counter()
        for t in range(rounds):
            if is_async:
                ring.open()
            params, state = algorithm.server_step(params, state,
                                                  aggregate(t), device=dev)
            if is_async:
                ring.push(params, algorithm.client_state(state))
            if (t + 1) % eval_every == 0 or t + 1 == rounds:
                slack = algorithm.round_metrics(state).get("slack")
                if slack is None:   # a fill, not a copy the host waits on
                    slack = torch.zeros((), device=dev)
                evals.append((t + 1, measure(params), slack))
        names = list(evals[0][1]) if evals else []
        values = torch.stack([torch.stack([*(v[k].float() for k in names),
                                           s.float()])
                              for _, v, s in evals]).cpu().tolist() \
            if evals else []
        hist.wall_seconds = time.perf_counter() - t0
    for (t_pt, _, _), row in zip(evals, values):
        hist.rounds.append(t_pt)
        for k, v in zip(names, row):
            hist.metric(k).append(v)
        hist.slack.append(row[-1])
        hist.cum_uplink_bytes.append(t_pt * hist.uplink_bytes_per_round)
    return params, hist
