"""Federated partitioners — split a dataset over I clients by sample (the
paper's horizontal/sample-based setting, Section II).

A copy of ``repro/data/partition.py`` (numpy only), so the port draws the
same partitions, cohorts and batch schedules as the reference.

Partitions are disjoint, cover all of N, and record N_i so that the
aggregation weights N_i/(B·N) of eqs. (2)/(7) are exact.

The partition is stored as a **packed flat arena** — one contiguous
index array plus per-client offsets/sizes — rather than a per-client
``List[np.ndarray]``.  At the population scales the cohort-native engine
targets (I in the tens of thousands, see :mod:`repro.fed.engine`), a
Python list of I arrays costs I object headers and I pointer chases per
pass; the arena is three arrays regardless of I, and every consumer
(padding, batch draws, weight computation) is a vectorized slice of it.

Per-round *cohorts* — the S participating clients of partial-
participation rounds — are drawn host-side by :func:`sample_cohorts` and
folded into the batch schedule by :func:`sample_schedule`'s ``cohorts=``
argument, so the engine's scan only ever sees ``(T, S, B)`` indices: the
full-population ``(T, I, B)`` tensor is never materialized when S < I.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np

# Sub-stream tag separating the per-round cohort draw from the per-round
# batch draw (both are keyed on (seed, t)); any fixed word works, it just
# must differ from the batch stream's bare [seed, t] entropy.
_COHORT_STREAM = 0xC0407

# Sub-stream tag of the per-round group draw (hierarchical aggregation):
# independent of both the cohort draw and the batch draw, so turning the
# two-level tree on or off never perturbs who participates or what they
# sample — only how the cohort slots are blocked into groups.
_GROUP_STREAM = 0x6409

# Sub-stream tag of the per-round staleness draw (async engine): the
# integer delay of every cohort slot is drawn on its own stream, so
# turning async simulation on or off never perturbs participation,
# batches, or grouping — only *which round's params* each slot computed
# against.
_STALE_STREAM = 0x57A1E

# Per-round transient budget of the batch draw, in elements: the
# (block, width) key/pad matrices of sample_schedule hold at most this
# many entries per array, whatever the partition's skew (~4 MB of f32
# keys plus a few int64 temps of the same shape).
_BLOCK_ELEMS = 1 << 20


class Partition(NamedTuple):
    """Packed per-client sample indices: the flat arena layout.

    ``flat`` holds every client's sample indices back to back;
    client i owns ``flat[offsets[i] : offsets[i] + sizes[i]]``.  Client
    runs are disjoint and cover the dataset.  Construct with
    :meth:`from_indices` (or the partitioner functions below) — the
    ``indices`` property recovers the per-client view as zero-copy
    slices for callers that iterate clients.
    """
    flat: np.ndarray      # (N,) packed sample indices, client runs
    offsets: np.ndarray   # (I,) start of client i's run in ``flat``
    sizes: np.ndarray     # (I,) N_i

    @classmethod
    def from_indices(cls, indices: Sequence[np.ndarray]) -> "Partition":
        """Pack a per-client index list into the arena (order preserved
        per client — the batch draw is keyed on within-client position,
        so packing must not reorder)."""
        sizes = np.asarray([len(ix) for ix in indices], np.int64)
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        flat = (np.concatenate([np.asarray(ix, np.int64) for ix in indices])
                if len(indices) else np.empty((0,), np.int64))
        return cls(flat, offsets.astype(np.int64), sizes)

    @property
    def num_clients(self) -> int:
        return len(self.sizes)

    @property
    def total(self) -> int:
        return int(self.sizes.sum())

    @property
    def indices(self) -> List[np.ndarray]:
        """Per-client zero-copy views into the arena (compat accessor —
        O(I) Python objects; population-scale code should slice
        ``flat``/``offsets``/``sizes`` directly)."""
        return [self.flat[o:o + s]
                for o, s in zip(self.offsets, self.sizes)]

    def weights(self, batch_size: int) -> np.ndarray:
        """N_i / (B·N) of eq. (2)."""
        return (self.sizes / (batch_size * self.total)).astype(np.float32)


def iid(n: int, num_clients: int, seed: int = 0) -> Partition:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    # array_split sizing: the first n % I clients get one extra sample
    sizes = np.full(num_clients, n // num_clients, np.int64)
    sizes[:n % num_clients] += 1
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    return Partition(perm.astype(np.int64), offsets, sizes)


def dirichlet(labels: np.ndarray, num_clients: int, alpha: float = 0.5,
              seed: int = 0, min_size: int = 1,
              max_draws: int = 25) -> Partition:
    """Label-skewed non-IID split (standard Dirichlet protocol).

    ``labels``: (N,) integer class labels.  Smaller alpha ⇒ more skew —
    this is the heterogeneity regime where FedAvg with E>1 degrades (the
    paper's §I motivation for one-shot aggregation per round).

    Every client is guaranteed ≥ ``min_size`` samples: an empty client
    would poison the whole downstream pipeline (the batch sampler pads
    each client's key row with its first index and would otherwise draw
    from a zero-length pool).  At small alpha the Dirichlet proportions
    routinely starve clients, so the split re-draws up to ``max_draws``
    times and then falls back to a deterministic **min-quota repair** on
    the best draw: under-quota clients take samples from the largest
    clients one at a time (label skew is preserved up to the few moved
    samples; a pure re-draw loop can spin forever when
    ``num_clients·min_size`` is close to N).
    """
    if min_size < 1:
        raise ValueError(f"min_size={min_size} must be >= 1 (an empty "
                         "client breaks the batch sampler)")
    if max_draws < 1:
        raise ValueError(f"max_draws={max_draws} must be >= 1 (the "
                         "quota repair needs a draw to start from)")
    n = len(labels)
    if num_clients * min_size > n:
        raise ValueError(
            f"cannot give {num_clients} clients >= {min_size} samples "
            f"each from N={n}")
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    best: List[list] = []
    best_min = -1
    for _ in range(max_draws):
        idx_per_client: List[list] = [[] for _ in range(num_clients)]
        for c in range(n_classes):
            idx_c = np.where(labels == c)[0]
            rng.shuffle(idx_c)
            props = rng.dirichlet([alpha] * num_clients)
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for i, part in enumerate(np.split(idx_c, cuts)):
                idx_per_client[i].extend(part.tolist())
        smallest = min(len(ix) for ix in idx_per_client)
        if smallest >= min_size:
            best = idx_per_client
            break
        if smallest > best_min:
            best, best_min = idx_per_client, smallest
    else:
        # min-quota repair: top up each starved client from whichever
        # client is currently largest (never dropping *it* below quota)
        sizes = [len(ix) for ix in best]
        for i in range(num_clients):
            while sizes[i] < min_size:
                donor = int(np.argmax(sizes))
                best[i].append(best[donor].pop())
                sizes[i] += 1
                sizes[donor] -= 1
    return Partition.from_indices(
        [np.asarray(sorted(ix), np.int64) for ix in best])


def sample_cohorts(num_clients: int, cohort_size: int, round_ids,
                   seed: int = 0) -> np.ndarray:
    """Per-round participating cohorts: (T, S) client ids, **sorted
    ascending** within each round.

    The draw is seed-stable per (seed, round id) — its rng stream is
    independent of the batch draw's, so adding partial participation
    never perturbs the mini-batch schedule — and uniform over S-subsets
    without replacement.  Sorted order makes the cohort aggregate sum
    its terms in ascending-client-id order, i.e. exactly the order of a
    masked full-population sum with the non-participants' zero terms
    removed (zero addends are exact no-ops), which is what lets cohort
    runs be compared bit-for-bit against masked reference runs.

    ``cohort_size == num_clients`` short-circuits to the identity cohort
    (no rng consumed): full participation keeps exact full-population
    semantics and bit-identical trajectories.
    """
    s = int(cohort_size)
    if not 1 <= s <= num_clients:
        raise ValueError(
            f"cohort_size={s} out of range [1, {num_clients}]")
    round_ids = np.asarray(round_ids, np.int64)
    if s == num_clients:
        return np.broadcast_to(np.arange(num_clients, dtype=np.int64),
                               (len(round_ids), s)).copy()
    out = np.empty((len(round_ids), s), np.int64)
    for k, t in enumerate(round_ids):
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, int(t), _COHORT_STREAM]))
        out[k] = np.sort(rng.choice(num_clients, size=s, replace=False))
    return out


def sample_groups(cohort_size: int, num_groups: int, round_ids,
                  seed: int = 0) -> np.ndarray:
    """Per-round group assignment for hierarchical aggregation: a (T, S)
    permutation of the cohort slots, drawn seed-stable per (seed, round
    id) on its own rng stream (:data:`_GROUP_STREAM` — independent of the
    cohort and batch draws, so grouping never perturbs participation or
    sampling).

    The convention is **contiguous blocking of the permuted cohort**:
    after reordering a round's cohort row by this permutation, group g of
    the two-level tree owns slots [g·M, (g+1)·M) with M = ⌈S/G⌉ (the last
    group is sentinel-padded when G ∤ S).  A uniformly random permutation
    of a uniformly drawn cohort makes every group an exchangeable random
    sub-cohort, while keeping the group structure a *reshape* — which is
    what lets the engine lay the (group, member) grid directly onto a
    2-D device mesh (:func:`repro.launch.mesh.make_group_mesh`) with no
    scatter.

    ``num_groups == 1`` (a degenerate tree) short-circuits to the
    identity permutation, no rng consumed.
    """
    s, g = int(cohort_size), int(num_groups)
    if not 1 <= g <= s:
        raise ValueError(f"num_groups={g} out of range [1, {s}]")
    round_ids = np.asarray(round_ids, np.int64)
    if g == 1:
        return np.broadcast_to(np.arange(s, dtype=np.int64),
                               (len(round_ids), s)).copy()
    out = np.empty((len(round_ids), s), np.int64)
    for k, t in enumerate(round_ids):
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, int(t), _GROUP_STREAM]))
        out[k] = rng.permutation(s)
    return out


def sample_staleness(cohort_size: int, round_ids, seed: int = 0,
                     delay_probs=None) -> np.ndarray:
    """Per-round staleness trace for the async engine: (T, S) integer
    delays, slot i of round t computed its upload against the params of
    round t − τ.  Drawn seed-stable per (seed, round id) on its own rng
    stream (:data:`_STALE_STREAM` — independent of the cohort, batch and
    group draws, so async simulation never perturbs who participates or
    what they sample).

    ``delay_probs`` — the delay distribution.  ``None`` is the all-zero
    trace (every slot fresh: async degenerates to the synchronous
    engine, no rng consumed).  A 1-D array p of length D draws
    τ ∈ {0, …, D−1} with P(τ=d) = p[d] iid per slot; a 2-D (T, D) array
    gives each round its own distribution (diurnal straggler cycles —
    row k applies to ``round_ids[k]``).  Probabilities are normalized
    row-wise.  Delays at or past the engine's staleness bound K+1 become
    *dropouts* — the trace itself is unbounded so the dropout rate is a
    property of (trace, K), not of the draw.

    Early rounds clip naturally in the engine: round t has only t
    predecessors, so an effective delay of min(τ, t) applies (the ring
    buffer is seeded with the initial params).
    """
    s = int(cohort_size)
    if s < 1:
        raise ValueError(f"cohort_size={s} must be >= 1")
    round_ids = np.asarray(round_ids, np.int64)
    if delay_probs is None:
        return np.zeros((len(round_ids), s), np.int64)
    p = np.asarray(delay_probs, np.float64)
    if p.ndim == 1:
        p = np.broadcast_to(p, (len(round_ids), p.shape[0]))
    if p.ndim != 2 or p.shape[0] != len(round_ids):
        raise ValueError(
            f"delay_probs shape {np.shape(delay_probs)} is neither (D,) "
            f"nor (T={len(round_ids)}, D)")
    if (p < 0).any() or (p.sum(axis=1) <= 0).any():
        raise ValueError("delay_probs rows must be nonnegative with a "
                         "positive sum")
    p = p / p.sum(axis=1, keepdims=True)
    out = np.empty((len(round_ids), s), np.int64)
    for k, t in enumerate(round_ids):
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, int(t), _STALE_STREAM]))
        # inverse-CDF draw, vectorized over the S slots
        u = rng.random(s)
        out[k] = np.searchsorted(np.cumsum(p[k]), u, side="right")
    # float round-off in the cumsum can push searchsorted one past the
    # last bucket; clip back into the support
    return np.minimum(out, p.shape[1] - 1)


def home_addressing(cohorts, rows_per_shard: int):
    """(home_device, local_row) of every cohort slot under the engine's
    home-sharded arena layout — the host-side counterpart of
    :func:`repro.fed.arena.address` (clients blocked contiguously,
    L = ``rows_per_shard`` rows per device; the sentinel id I lands on a
    real dead row because L·D ≥ I+1).

    The engine does not ship these as scan inputs — inside the round
    body the same addressing is two int32 ops on the replicated cohort
    row against a static L, cheaper than sharding another (T, S) array —
    but the bench and the routing property tests use this to reason
    about row placement (per-device cohort fan-in, dead-row hits) and to
    cross-check the traced arithmetic.
    """
    cohorts = np.asarray(cohorts, np.int64)
    rows = int(rows_per_shard)
    if rows < 1:
        raise ValueError(f"rows_per_shard={rows} must be >= 1")
    return cohorts // rows, cohorts % rows


def sample_schedule(partition: Partition, batch_size: int,
                    round_ids, seed: int = 0,
                    cohorts=None) -> np.ndarray:
    """Mini-batch index schedule: (T, I, B), or (T, S, B) with a cohort.

    Draws are **seed-stable**: the batch of round t depends only on
    (seed, t) and the partition — so algorithms sharing a seed and round
    ids see identical batches (paired convergence comparisons), and the
    whole schedule can be staged on device once instead of per round.
    Each round uses one Generator vectorized across all clients
    (random-key argpartition for the without-replacement draw).

    ``cohorts`` — optional (T, S) per-round client ids aligned with
    ``round_ids`` (:func:`sample_cohorts`).  Only the cohort's rows are
    emitted, so schedule memory is O(T·S·B) — the old O(T·I·B) tensor is
    never allocated.  The per-round draw itself still consumes the
    full-population rng stream before row selection, which keeps every
    client's batch independent of who else participates: the cohort
    schedule is a row-selection of the full-participation schedule, row
    for row, bit for bit.  (The O(I·width) cost is a *transient* per
    round on the host, not T·I resident indices on the device.)

    Clients with N_i ≥ B sample without replacement, smaller clients with
    replacement, matching :func:`sample_minibatches`'s contract.
    """
    round_ids = np.asarray(round_ids, np.int64)
    sizes = partition.sizes
    i_cl = partition.num_clients
    width = max(int(sizes.max()), batch_size)
    no_repl = sizes >= batch_size                            # per-client mode

    if cohorts is not None:
        cohorts = np.asarray(cohorts, np.int64)
        if cohorts.shape[0] != len(round_ids):
            raise ValueError(
                f"cohorts has {cohorts.shape[0]} rounds, round_ids "
                f"{len(round_ids)}")
        rows = cohorts.shape[1]
    else:
        rows = i_cl
    out = np.empty((len(round_ids), rows, batch_size), np.int64)
    any_repl = bool((~no_repl).any())
    # Clients are processed in blocks so the (block, width) key/pad
    # transients stay bounded even for skewed partitions whose largest
    # client makes width huge (one hot client at I=10k would otherwise
    # cost O(I·width) per round).  Generator.random fills row-major from
    # a sequential bitstream, so any block split consumes the *same*
    # stream as one (I, width) draw — draws are bit-identical for every
    # block size.
    block = max(1, _BLOCK_ELEMS // width)
    col = np.arange(width)[None, :]
    for k, t in enumerate(round_ids):
        rng = np.random.default_rng(np.random.SeedSequence([seed, int(t)]))
        full = np.empty((i_cl, batch_size), np.int64)
        for lo in range(0, i_cl, block):
            hi = min(lo + block, i_cl)
            sz = sizes[lo:hi, None]
            keys = rng.random((hi - lo, width), dtype=np.float32)
            keys[col >= sz] = np.inf
            # uniform B-subset per row: the B smallest of N_i iid keys
            sel = np.argpartition(keys, batch_size - 1,
                                  axis=1)[:, :batch_size]
            padded = partition.flat[partition.offsets[lo:hi, None]
                                    + np.where(col < sz, col, 0)]
            full[lo:hi] = np.take_along_axis(padded, sel, axis=1)
        if any_repl:
            # with-replacement fallback for clients smaller than the
            # batch; drawn after the key stream, exactly as before —
            # indexed straight off the arena (flat[offset + ⌊u·N_i⌋])
            u = rng.random((i_cl, batch_size))
            wr = partition.flat[partition.offsets[:, None]
                                + (u * sizes[:, None]).astype(np.int64)]
            full = np.where(no_repl[:, None], full, wr)
        out[k] = full if cohorts is None else full[cohorts[k]]
    return out


def sample_minibatches(partition: Partition, batch_size: int, round_idx: int,
                       seed: int = 0) -> np.ndarray:
    """Each client's uniformly random mini-batch N_i^(t); (I, B) indices.

    Single-round view of :func:`sample_schedule` — same (seed, round)
    always yields the same draw, shared across algorithms.
    """
    return sample_schedule(partition, batch_size, [round_idx], seed)[0]
