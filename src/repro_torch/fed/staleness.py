"""Bounded-staleness rounds: discount schedules, the mass-preserving
reweight, and the host-side accounting of delay traces.

The port of ``repro/fed/staleness.py``.  Every cohort slot of a round
carries an integer delay τ
from a seed-stable staleness trace
(:func:`repro_torch.data.partition.sample_staleness`): slot i of round t
uploads against the parameters of round t − τ_i, kept in a ring of the
last K + 1 snapshots (:mod:`repro_torch.fed.engine`).  Delays past the
bound K are dropouts: the slot's weight is 0 and, under secure
aggregation, its pair masks are cancelled through the masked sum's
``alive`` path, with the seed-share recovery bytes charged to the
ledger.

The wall-clock model (:func:`round_times`) counts in no-straggler round
units: a synchronous round waits for its slowest member, an async round
takes unit time, and drop-stragglers takes unit time but discards every
delayed upload.

On a client mesh under ``arena="sharded"`` the ring of parameter
snapshots is itself sharded over the ranks, so its resident bytes a rank
are O((K + 1)/D · model): the snapshots are packed as int32 bits into
(K + 1, n_pad) rows and each rank carries one (K + 1, chunk) column
block (:class:`RingMeta`, :func:`pack_snapshot`, :func:`pack_ring`,
:func:`unpack_ring`, :func:`unpack_snapshot`, :func:`ring_unshard`,
:func:`ring_localize`).  Rebuilding the ring is a placed psum in which
every column has one contributor, so it moves bits exactly and the
sharded ring runs the replicated one bit for bit.  The client-state half
of the ring stays replicated: it is empty for the sum-combine algorithms
and a scalar counter for FedAvg.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import tree
from repro_torch.fed import arena as arena_mod


@dataclasses.dataclass(frozen=True)
class PolynomialDiscount:
    """d(τ) = (1 + τ)^(−a), the polynomial staleness discount (a = 0.5 is
    the classic async-SGD choice).  d(0) = 1 exactly, so fresh uploads are
    never perturbed."""
    a: float = 0.5

    def __post_init__(self):
        if not (isinstance(self.a, (int, float))
                and not isinstance(self.a, bool)) or self.a < 0:
            raise ValueError(f"a={self.a!r} must be a nonnegative number")

    def discount(self, tau) -> torch.Tensor:
        """f32 d(τ) of an integer tensor (or array) of delays."""
        tau = torch.as_tensor(tau)
        if self.a == 0:
            return torch.ones(tau.shape, dtype=torch.float32,
                              device=tau.device)
        return (1.0 + tau.to(torch.float32)) ** float(-self.a)


@dataclasses.dataclass(frozen=True)
class ConstantDiscount:
    """d(τ) ≡ 1: bounded staleness with no down-weighting (dropouts still
    apply past the bound)."""

    def discount(self, tau) -> torch.Tensor:
        tau = torch.as_tensor(tau)
        return torch.ones(tau.shape, dtype=torch.float32, device=tau.device)


Schedule = Union[PolynomialDiscount, ConstantDiscount]


def _freeze_probs(p) -> Optional[Tuple]:
    if p is None:
        return None
    arr = np.asarray(p, np.float64)
    if arr.ndim == 1:
        return tuple(float(x) for x in arr)
    if arr.ndim == 2:
        return tuple(tuple(float(x) for x in row) for row in arr)
    raise ValueError(f"delay_probs must be 1-D or 2-D, got {arr.ndim}-D")


@dataclasses.dataclass(frozen=True)
class StalenessConfig:
    """The async round mode's settings, frozen and hashable.

    ``max_staleness`` — K: the engine keeps the last K + 1 parameter
    snapshots and a slot may be up to K rounds stale; delays τ > K are
    dropouts (K = 0 drops every delayed slot).

    ``schedule`` — the discount d(τ) of stale uploads (default polynomial,
    a = 0.5).

    ``delay_probs`` — the delay distribution handed to
    :func:`repro_torch.data.partition.sample_staleness` when no explicit
    trace is passed; ``None`` draws the all-zero (synchronous) trace.
    Frozen to nested tuples.
    """
    max_staleness: int = 2
    schedule: Schedule = PolynomialDiscount(0.5)
    delay_probs: Optional[Tuple] = None

    def __post_init__(self):
        k = self.max_staleness
        if isinstance(k, bool) or not isinstance(k, (int, np.integer)) \
                or int(k) < 0:
            raise ValueError(f"max_staleness={k!r} must be an int >= 0")
        object.__setattr__(self, "max_staleness", int(k))
        object.__setattr__(self, "delay_probs",
                           _freeze_probs(self.delay_probs))

    def discount(self, tau) -> torch.Tensor:
        return self.schedule.discount(tau)


def discount_reweight(weights: torch.Tensor,
                      disc: torch.Tensor) -> torch.Tensor:
    """Apply a per-slot discount to the cohort weights, keeping their mass.

    λ'_i = λ_i · d_i · (Σλ / Σ(λ·d)), so Σλ' = Σλ and the aggregate keeps
    the scale the server step expects.  Exact properties:

    * d ≡ 1 → the scale is Σλ/Σλ = 1.0 exactly (the same sum twice), and
      λ·1.0·1.0 == λ bit for bit: an all-fresh round is untouched;
    * d_i = 0 (a dropout) → slot i contributes nothing and the rescale
      renormalizes over the survivors;
    * every slot dropped (Σ(λ·d) = 0) → zero weights.
    """
    disc = torch.as_tensor(disc, dtype=weights.dtype, device=weights.device)
    num = weights.sum()
    den = (weights * disc).sum()
    nonzero = den != 0
    scale = torch.where(nonzero, num / torch.where(nonzero, den, 1.0), 0.0)
    return weights * disc * scale


def round_times(trace, mode: str, max_staleness: int) -> np.ndarray:
    """Simulated wall-clock cost of every round, in no-straggler round
    units: (T,) f64 from a (T, S) trace.

    * ``"sync"`` — the barrier waits for the slowest member: 1 + max_i
      min(τ_i, K + 1) (the sync server gives up at the window the async
      mode drops at);
    * ``"async"`` — unit cost: late uploads arrive in later rounds;
    * ``"drop"`` — drop-stragglers: unit cost, every τ > 0 upload is
      discarded.
    """
    trace = np.asarray(trace)
    if mode == "sync":
        return 1.0 + np.minimum(trace, max_staleness + 1).max(axis=1) \
            .astype(np.float64)
    if mode in ("async", "drop"):
        return np.ones(trace.shape[0], np.float64)
    raise ValueError(f"mode={mode!r} not in ('sync', 'async', 'drop')")


def dropped_per_round(trace, max_staleness: int) -> np.ndarray:
    """(T,) count of dropped slots (τ > K) a round: the ledger's recovery
    charge."""
    return (np.asarray(trace) > int(max_staleness)).sum(axis=1) \
        .astype(np.int64)


class RingMeta(NamedTuple):
    """The static layout of the packed, column-sharded snapshot ring.

    A parameter tree (the structure of ``like``) flattens, in leaf
    order, into ``n`` 4-byte elements, as int32 bits, zero-padded to
    ``chunk · shards``; rank r carries the (K + 1, chunk) column block
    at r · chunk."""
    like: Any                        # the tree's structure, leaves None
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    n: int                           # flat element count (before padding)
    chunk: int                       # elements a rank
    shards: int

    @property
    def padded(self) -> int:
        return self.chunk * self.shards


def ring_meta(params, num_shards: int) -> Optional[RingMeta]:
    """The packed ring's layout for ``params`` over ``num_shards`` ranks,
    or ``None`` when a leaf does not route as int32 bits (not a 4-byte
    f32 or int32 leaf): the engine then keeps the replicated ring."""
    leaves = tree.leaves(params)
    if not leaves or any(x.dtype not in arena_mod.ROUTABLE for x in leaves):
        return None
    n = sum(x.numel() for x in leaves)
    return RingMeta(tree.map(lambda x: None, params),
                    tuple(tuple(x.shape) for x in leaves),
                    tuple(x.dtype for x in leaves), n,
                    -(-n // int(num_shards)), int(num_shards))


def pack_snapshot(params, meta: RingMeta) -> torch.Tensor:
    """One snapshot as its packed (n_pad,) int32 row (a bitcast, exact)."""
    flat = torch.cat([arena_mod.as_bits(x).reshape(-1)
                      for x in tree.leaves(params)])
    return torch.nn.functional.pad(flat, (0, meta.padded - meta.n))


def pack_ring(phist, meta: RingMeta) -> torch.Tensor:
    """A replicated ring (leaves (K + 1, …)) as packed (K + 1, n_pad)
    int32 rows."""
    flat = torch.cat([arena_mod.as_bits(h).reshape(h.shape[0], -1)
                      for h in tree.leaves(phist)], dim=1)
    return torch.nn.functional.pad(flat, (0, meta.padded - meta.n))


def _split_row(flat: torch.Tensor, meta: RingMeta, lead: Tuple[int, ...]):
    out, off = [], 0
    for shape, dtype in zip(meta.shapes, meta.dtypes):
        size = int(np.prod(shape)) if shape else 1
        part = flat[..., off:off + size].reshape(lead + shape)
        out.append(arena_mod.from_bits(part, dtype))
        off += size
    return tree.unflatten(meta.like, out)


def unpack_ring(packed: torch.Tensor, meta: RingMeta):
    """Packed (K + 1, n_pad) rows as the ring's tree (leaves (K + 1, …)),
    views of ``packed``."""
    return _split_row(packed, meta, (packed.shape[0],))


def unpack_snapshot(packed: torch.Tensor, meta: RingMeta, slot: int = 0):
    """Ring slot ``slot`` of packed (K + 1, n_pad) rows as a parameter
    tree, views of ``packed``."""
    return _split_row(packed[slot], meta, ())


def ring_unshard(local: torch.Tensor, meta: RingMeta, my_id: int,
                 psum_fn: Callable) -> torch.Tensor:
    """The whole packed ring from every rank's (K + 1, chunk) block: the
    block placed at its column offset in a zero (K + 1, n_pad) buffer and
    one psum, in which every column has one contributor (exact bit
    movement)."""
    buf = local.new_zeros((local.shape[0], meta.padded))
    buf[:, my_id * meta.chunk:(my_id + 1) * meta.chunk] = local
    return psum_fn(buf)


def ring_localize(packed: torch.Tensor, meta: RingMeta,
                  my_id: int) -> torch.Tensor:
    """Rank ``my_id``'s (rows, chunk) column block of packed rows, a copy
    that does not keep ``packed`` alive."""
    lo = my_id * meta.chunk
    return packed[:, lo:lo + meta.chunk].clone()


def diurnal_delay_probs(rounds: int, max_delay: int = 4,
                        straggler_frac: float = 0.4,
                        period: int = 20) -> np.ndarray:
    """A (T, D) diurnal straggler distribution: the straggler fraction
    swings sinusoidally over ``period`` rounds (up to ``straggler_frac``
    of the cohort delayed, spread geometrically over 1 … ``max_delay``).
    Row t is round t's delay distribution for
    :func:`repro_torch.data.partition.sample_staleness`.
    """
    if max_delay < 1:
        raise ValueError(f"max_delay={max_delay} must be >= 1")
    t = np.arange(rounds, dtype=np.float64)
    frac = straggler_frac * 0.5 * (1.0 - np.cos(2 * np.pi * t / period))
    tail = 0.5 ** np.arange(max_delay, dtype=np.float64)     # geometric
    tail = tail / tail.sum()
    probs = np.empty((rounds, max_delay + 1), np.float64)
    probs[:, 0] = 1.0 - frac
    probs[:, 1:] = frac[:, None] * tail[None, :]
    return probs
