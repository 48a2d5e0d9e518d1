"""Home-rank sharding of the population-resident (I, …) state.

The port of ``repro/fed/arena.py`` for the 1-D client mesh and the 2-D
(groups, clients) mesh (:mod:`repro_torch.launch.mesh`; on the latter D
is g·c and a rank's index its flattened, groups-major rank).  Under ``arena="sharded"`` (the
default whenever a mesh is set) each client's row of the error-feedback
residual arena and of the population weight vector lives on one rank,
so resident bytes per rank scale as O(I/D · model):

* **Addressing.**  Clients are blocked contiguously: with L = ⌈(I+1)/D⌉
  rows a rank, client i lives at local row i mod L of rank i div L.  The
  +1 gives the sentinel id I (the cohort's padding to a multiple of D) a
  real, dead row on the last rank: its reads return the row's zeros and
  its writes are dropped.
* **Gather = masked slice + one psum.**  Each rank takes the cohort's
  rows out of its (L, …) block, zeroed where it is not their home, and
  one :meth:`~repro_torch.launch.mesh.ClientMesh.psum` merges the ranks'
  contributions: each row has exactly one nonzero contributor.
* **Scatter = replicate the cohort rows, write back owner-locally.**
  Each rank computes its own cohort slots' rows; one psum of a
  position-placed buffer replicates all S of them, then every rank
  writes only the rows it homes.
* **Exact by construction.**  Rows are routed as int32 bitcasts and
  never reduced in float: float addition of a row and zeros is exact in
  value, but (−0.0) + 0.0 = +0.0 would flip a sign bit, and a NaN's
  payload need not survive.  Only 4-byte dtypes route.

The helpers take the rank and the reduction as arguments (``my_id``,
``psum_fn``), so the tests can emulate D ranks in one process, summing
the ranks' contributions with plain addition.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from repro_torch import tree

Params = tree.Tree

ROUTABLE = (torch.float32, torch.int32)


class ArenaPlan(NamedTuple):
    """The static home-rank layout of a population-resident array over a
    1-D mesh of ``num_shards`` ranks."""
    num_clients: int                 # I: live rows; ids ≥ I are dead
    rows_per_shard: int              # L = ⌈(I+1)/D⌉
    num_shards: int                  # D

    @property
    def total_rows(self) -> int:     # I_pad = L·D ≥ I + 1
        return self.rows_per_shard * self.num_shards


def make_plan(num_clients: int, mesh) -> ArenaPlan:
    """The plan of an I-client population over ``mesh``'s ranks (all g·c
    of a group mesh)."""
    d = int(mesh.size)
    return ArenaPlan(int(num_clients), -(-(int(num_clients) + 1) // d), d)


def address(plan: ArenaPlan, cids: torch.Tensor) -> Tuple[torch.Tensor,
                                                           torch.Tensor]:
    """(home rank, local row) of each client id; valid for any id below
    ``total_rows``, the sentinel I included."""
    return cids // plan.rows_per_shard, cids % plan.rows_per_shard


def shard_index(plan: ArenaPlan, mesh) -> int:
    """This rank's index along the arena's sharded dim: its rank in the
    mesh the plan was made for (groups-major on the group mesh)."""
    if int(mesh.size) != plan.num_shards:
        raise ValueError(f"a plan over {plan.num_shards} ranks on a mesh of "
                         f"{mesh.size}")
    return int(mesh.rank)


def as_bits(x: torch.Tensor) -> torch.Tensor:
    """A 4-byte-dtype tensor reinterpreted as int32 (shape kept)."""
    if x.dtype not in ROUTABLE:
        raise TypeError(f"only {ROUTABLE} rows route losslessly, not "
                        f"{x.dtype}")
    return x if x.dtype == torch.int32 else x.view(torch.int32)


def from_bits(b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int32 bits back to ``dtype`` (the inverse of :func:`as_bits`)."""
    return b if dtype == torch.int32 else b.view(dtype)


def home_rows(plan: ArenaPlan, full: torch.Tensor, my_id: int) -> torch.Tensor:
    """Rank ``my_id``'s (L, …) block of a population array ``full`` (I, …):
    its home rows, the dead tail past I as zeros."""
    lo = my_id * plan.rows_per_shard
    hi = min(lo + plan.rows_per_shard, plan.num_clients)
    out = full.new_zeros((plan.rows_per_shard,) + tuple(full.shape[1:]))
    if hi > lo:
        out[:hi - lo] = full[lo:hi]
    return out


def take_rows(plan: ArenaPlan, local: Params, cids: torch.Tensor,
              my_id: int) -> Params:
    """One rank's contribution to a cohort gather: the rows of its (L, …)
    block at the cohort's addresses, as int32 bits, zero where it is not
    their home.  The D contributions summed give every row's exact bits:
    each position has one nonzero contributor."""
    home, row = address(plan, cids)
    mine = home == my_id
    safe = torch.where(mine, row, torch.zeros_like(row))

    def leaf(a):
        bits = as_bits(a[safe])
        m = mine.reshape((-1,) + (1,) * (bits.ndim - 1))
        return torch.where(m, bits, torch.zeros_like(bits))

    return tree.map(leaf, local)


def gather_rows(plan: ArenaPlan, local: Params, cids: torch.Tensor,
                my_id: int, psum_fn: Callable) -> Params:
    """The cohort's rows out of the home-sharded arena, on every rank:
    :func:`take_rows` and one psum, bitcast back.  The sentinel I reads
    its dead row's zeros."""
    summed = psum_fn(take_rows(plan, local, cids, my_id))
    return tree.map(lambda b, a: from_bits(b, a.dtype), summed, local)


def replicate_rows(rows: Params, length: int, offset: int,
                   psum_fn: Callable) -> Params:
    """The whole (length, …) cohort-row block on every rank, from each
    rank's contiguous (S_loc, …) slice at ``offset``: the bits placed in
    a zero buffer and psum-merged, one contributor per row."""
    def place(u):
        bits = as_bits(u)
        buf = bits.new_zeros((length,) + tuple(bits.shape[1:]))
        buf[offset:offset + bits.shape[0]] = bits
        return buf

    summed = psum_fn(tree.map(place, rows))
    return tree.map(lambda b, u: from_bits(b, u.dtype), summed, rows)


def replicate_rows_2d(rows: Params, grid: Tuple[int, int],
                      tile: Tuple[int, int], tile_offset: Tuple[int, int],
                      psum_fn: Callable) -> Params:
    """The whole flattened (G·M_pad, …) cohort-row block on every rank of
    the (groups, clients) mesh, from each rank's (G_loc·M_loc, …) tile of
    the (G, M_pad) ``grid`` at ``tile_offset``: the bits placed in a zero
    grid and merged by one psum over the whole mesh, one contributor per
    row."""
    g_tot, m_pad = grid
    g_loc, m_loc = tile
    g_off, m_off = tile_offset

    def place(u):
        bits = as_bits(u).reshape((g_loc, m_loc) + tuple(u.shape[1:]))
        buf = bits.new_zeros((g_tot, m_pad) + tuple(bits.shape[2:]))
        buf[g_off:g_off + g_loc, m_off:m_off + m_loc] = bits
        return buf

    summed = psum_fn(tree.map(place, rows))
    return tree.map(lambda b, u: from_bits(
        b.reshape((g_tot * m_pad,) + tuple(b.shape[2:])), u.dtype),
        summed, rows)


def scatter_rows(plan: ArenaPlan, local: Params, rows: Params,
                 cids: torch.Tensor, live: torch.Tensor,
                 my_id: int) -> Params:
    """Owner-local write-back of the replicated cohort rows into the
    (L, …) blocks, in place and without a collective: every rank writes
    only the live rows it homes; foreign and sentinel rows are dropped.
    A cohort holds each live id once (drawn without replacement)."""
    home, row = address(plan, cids)
    mine = torch.logical_and(live, home == my_id)
    at = row[mine]
    for a, u in zip(tree.leaves(local), tree.leaves(rows)):
        a[at] = u[mine]
    return local
