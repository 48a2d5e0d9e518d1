"""The client mesh and the (groups, clients) mesh on ``torch.distributed``
process groups.

The port of ``repro/launch/mesh.py``'s ``make_client_mesh``: a 1-D group
of ranks over the federated-client axis.  The engine
(:func:`repro_torch.fed.engine.run` with ``mesh=``) shards each round's
cohort over the ranks, every rank running the same call (SPMD, as under
``torchrun``), :meth:`ClientMesh.psum` stands for the reference's
``jax.lax.psum`` over ``"clients"`` and :meth:`ClientMesh.ring_psum_chunked`
for its pipelined rounds' chunked ring (``repro/kernels/ops.py::
ring_psum_chunked``).

:func:`make_group_mesh` is the port of the reference's 2-D ``("groups",
"clients")`` mesh of the hierarchical tree: a :class:`GroupMesh` of g·c
ranks, groups-major, whose ``clients`` and ``groups`` axes are client
meshes on ``torch.distributed`` subgroups (a group row, a client column)
and whose whole-mesh :meth:`GroupMesh.psum` serves the population arena
and the snapshot ring.

:func:`make_mesh` is the port of the reference's production mesh
(``make_mesh``, ``make_production_mesh``, ``make_host_mesh``,
``data_axes``): a :class:`ProductionMesh`, the (data, model) or (pod,
data, model) grid of ranks with a subgroup for every set of axes, whose
all-gather, reduce-scatter and all-reduce over a set of axes stand for
the collectives XLA inserts for the reference's sharded train step
(:mod:`repro_torch.parallel` gives them their gradients).  The
reference's ``use_mesh`` and ``shard_map_fn`` are JAX version shims with
no counterpart here.

:class:`LocalWorld` runs one function on D local processes, one
rank each, in a process group of its own (a ``FileStore`` in a temporary
directory): the tests run the sharded engine on the CPU with gloo this
way, and ``chip_smoke.py`` runs two and four gloo ranks on one card.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import multiprocessing
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import Device, resolve_device, tree
from repro_torch.parallel import data_axes  # noqa: F401  (the reference's name)

_U32 = 1 << 32
_I32_MIN = -(1 << 31)


def _wrap_i32(v: int) -> int:
    """An integer reduced mod 2^32 into int32's range."""
    return (v - _I32_MIN) % _U32 + _I32_MIN


@dataclasses.dataclass(eq=False)
class ClientMesh:
    """A 1-D client group: the process ``group`` (``None`` is the default
    group), this process's ``rank`` of ``size``, the ``backend`` and the
    ``device`` the rank's tensors live on.

    ``int32_wraps`` says whether the backend's int32 sum wraps mod 2^32
    (probed once by :func:`make_client_mesh` on a group of two or more
    ranks); where it does not, :meth:`psum` sums int32 leaves exactly in
    int64 and wraps the result.  ``psum_calls``, ``all_reduces`` and
    ``psum_bytes`` count what :meth:`psum` did since the mesh was made
    (or since the caller set them to 0); ``ring_calls``, ``ring_bytes``
    (sent by this rank) and ``ring_staged_bytes`` (copied through host
    memory) what :meth:`ring_psum_chunked`'s ring did."""
    group: Any
    rank: int
    size: int
    backend: str
    device: torch.device
    int32_wraps: bool = True
    psum_calls: int = 0
    all_reduces: int = 0
    psum_bytes: int = 0
    ring_calls: int = 0
    ring_bytes: int = 0
    ring_staged_bytes: int = 0

    def reset_counts(self) -> None:
        """Set every counter to 0."""
        self.psum_calls = self.all_reduces = self.psum_bytes = 0
        self.ring_calls = self.ring_bytes = self.ring_staged_bytes = 0

    def psum(self, values):
        """The sum of ``values`` (a tree of tensors on :attr:`device`)
        over the ranks, on every rank: one ``all_reduce(SUM)`` per dtype,
        of one flat buffer that holds every leaf of that dtype.  int32
        leaves sum in the ring Z_2^32, never in float."""
        leaves = tree.leaves(values)
        out: List[Optional[torch.Tensor]] = [None] * len(leaves)
        by_dtype: dict = {}
        for i, x in enumerate(leaves):
            if x.device != self.device:
                raise ValueError(f"psum: a leaf on {x.device}, the mesh's "
                                 f"rank {self.rank} is on {self.device}")
            by_dtype.setdefault(x.dtype, []).append(i)
        for dtype, idx in by_dtype.items():
            flat = torch.cat([leaves[i].reshape(-1) for i in idx])
            wide = dtype == torch.int32 and not self.int32_wraps
            if wide:
                flat = flat.to(torch.int64)
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
            self.all_reduces += 1
            self.psum_bytes += flat.numel() * flat.element_size()
            if wide:
                flat = (torch.remainder(flat - _I32_MIN, _U32)
                        + _I32_MIN).to(torch.int32)
            off = 0
            for i in idx:
                n = leaves[i].numel()
                out[i] = flat[off:off + n].reshape(leaves[i].shape)
                off += n
        self.psum_calls += 1
        return tree.unflatten(values, out)

    def ring_psum_chunked(self, values, chunks: int = 4):
        """The sum of ``values`` over the ranks as a chunked ring, the
        pipelined rounds' collective: the int32 leaves (masked Z_2^32
        partials) go into one flat buffer, split into ``chunks`` pieces
        at (j·n)//k, and each piece is reduced by D − 1 neighbour
        exchanges (send to rank r + 1, receive from r − 1, ``acc +=
        buf``).  int32 addition wraps mod 2^32, so the result is
        :meth:`psum`'s bit for bit.  Other dtypes go through one
        :meth:`psum` (float addition is not associative), and so does
        everything on one rank.

        gloo exchanges host tensors: on a CUDA device each piece is
        staged through host memory, counted in ``ring_staged_bytes``.
        A backend that cannot exchange raises."""
        leaves = tree.leaves(values)
        if self.size == 1 or not leaves:
            return self.psum(values)
        out: List[Optional[torch.Tensor]] = list(leaves)
        ints = [i for i, x in enumerate(leaves) if x.dtype == torch.int32]
        rest = [i for i, x in enumerate(leaves) if x.dtype != torch.int32]
        if rest:
            for i, x in zip(rest, self.psum(tuple(leaves[i] for i in rest))):
                out[i] = x
        if ints:
            if any(leaves[i].device != self.device for i in ints):
                raise ValueError(f"ring_psum_chunked: a leaf off the mesh's "
                                 f"rank {self.rank} device {self.device}")
            flat = torch.cat([leaves[i].reshape(-1) for i in ints])
            n = flat.numel()
            k = max(1, min(int(chunks), n))
            bounds = [(j * n) // k for j in range(k + 1)]
            agg = torch.cat([self._ring_reduce(flat[lo:hi])
                             for lo, hi in zip(bounds, bounds[1:])])
            off = 0
            for i in ints:
                size = leaves[i].numel()
                out[i] = agg[off:off + size].reshape(leaves[i].shape)
                off += size
            self.ring_calls += 1
        return tree.unflatten(values, out)

    def _ring_reduce(self, piece: torch.Tensor) -> torch.Tensor:
        """One piece summed over the ranks by D − 1 neighbour exchanges."""
        staged = self.backend == "gloo" and self.device.type != "cpu"
        nxt, prv = ((self.rank + d) % self.size for d in (1, -1))
        if self.group is not None:
            nxt, prv = (dist.get_global_rank(self.group, r)
                        for r in (nxt, prv))
        nbytes = piece.numel() * piece.element_size()
        acc = piece.clone()
        buf = piece
        if staged:
            buf = piece.cpu()
            self.ring_staged_bytes += nbytes
        for _ in range(self.size - 1):
            got = torch.empty_like(buf)
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, buf, nxt, self.group),
                    dist.P2POp(dist.irecv, got, prv, self.group)]):
                req.wait()
            self.ring_bytes += nbytes
            if staged:
                acc += got.to(self.device)
                self.ring_staged_bytes += nbytes
            else:
                acc += got
            buf = got
        return acc


def _rank_card(dev: torch.device) -> torch.device:
    """A bare ``cuda`` resolved to this rank's card: ``LOCAL_RANK``, as
    ``torchrun`` sets it, else the global rank, modulo the cards."""
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def _probe_int32_wrap(group, size: int, dev: torch.device) -> bool:
    """Whether the group's int32 sum wraps mod 2^32: every rank adds
    2^31 − 1, which passes 2^31 on two or more ranks."""
    big = (1 << 31) - 1
    x = torch.full((1,), big, dtype=torch.int32, device=dev)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return int(x.item()) == _wrap_i32(size * big)


def make_client_mesh(group=None, device: Device = None) -> ClientMesh:
    """The 1-D client mesh over ``group`` (``None``: the default process
    group, which the caller has initialized, e.g. under ``torchrun``).

    ``device`` is the rank's device: ``cuda`` unless the caller asks for
    the CPU; without a GPU and without ``device="cpu"`` it raises, as the
    port's entry points do.  A bare ``cuda`` is this rank's card
    (``LOCAL_RANK`` modulo the cards), made the current device.  The
    backend is the group's own: nothing here falls back to another."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError(
            "make_client_mesh: no process group; call "
            "torch.distributed.init_process_group first (torchrun sets "
            "its address, rank and world size)")
    dev = _rank_card(dev)
    backend = str(dist.get_backend(group))
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend reduces CUDA tensors; the rank's "
                         f"device is {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    wraps = size == 1 or _probe_int32_wrap(group, size, dev)
    return ClientMesh(group=group, rank=rank, size=size, backend=backend,
                      device=dev, int32_wraps=wraps)


_COUNTERS = ("psum_calls", "all_reduces", "psum_bytes", "ring_calls",
             "ring_bytes", "ring_staged_bytes")


@dataclasses.dataclass(eq=False)
class GroupMesh:
    """The 2-D (groups, clients) mesh of the hierarchical tree: g·c ranks
    of a process group, groups-major (rank = gi·c + ci, the reference's
    flattened ``("groups", "clients")`` order).

    ``clients`` is the client mesh of this rank's group row (the c ranks
    gi·c … gi·c + c − 1: level 1 of the tree completes its group sums
    over it), ``groups`` the one of its client column (the g ranks
    ci, c + ci, …: level 2 completes the root over it), and ``whole``
    the one of the parent group, whose :meth:`psum` routes the
    population arena's rows and the snapshot ring.  ``shape`` is
    (g, c), ``coords`` this rank's (gi, ci).  Each counter of
    :class:`ClientMesh` reads here as its sum over the three."""
    whole: ClientMesh
    groups: ClientMesh
    clients: ClientMesh
    shape: tuple

    @property
    def rank(self) -> int:
        return self.whole.rank

    @property
    def size(self) -> int:
        return self.whole.size

    @property
    def device(self) -> torch.device:
        return self.whole.device

    @property
    def backend(self) -> str:
        return self.whole.backend

    @property
    def coords(self) -> tuple:
        return divmod(self.whole.rank, self.shape[1])

    def axes(self) -> tuple:
        """The client meshes of the whole mesh, the groups axis and the
        clients axis."""
        return self.whole, self.groups, self.clients

    def psum(self, values):
        """The sum of ``values`` over every rank of the mesh."""
        return self.whole.psum(values)

    def reset_counts(self) -> None:
        """Set every counter of every axis to 0."""
        for axis in self.axes():
            axis.reset_counts()


def _summed(name: str) -> property:
    return property(lambda self: sum(getattr(axis, name)
                                     for axis in self.axes()),
                    doc=f"``{name}`` summed over the mesh's three client "
                        "meshes (read only: :meth:`reset_counts` zeroes "
                        "them).")


for _name in _COUNTERS:
    setattr(GroupMesh, _name, _summed(_name))


def make_group_mesh(group_shards: int = 0, client_shards: int = 1,
                    group=None, device: Device = None) -> GroupMesh:
    """The 2-D (groups, clients) mesh over the ranks of ``group`` (``None``:
    the default process group): ``group_shards`` × ``client_shards``
    ranks, ``group_shards=0`` spending the whole group on the groups
    axis.  It creates one subgroup for each group row and one for each
    client column, on the parent's backend, every process all of them
    and in the same order: ``torch.distributed.new_group`` is collective
    over the default group, members or not, so every process of the job
    makes the call (one that skips a subgroup leaves the others
    waiting).  It probes the int32 wrap on each axis of two or more
    ranks.  ``device`` and the backend follow :func:`make_client_mesh`:
    nothing falls back to another backend, mesh or device.  Raises
    without a process group, and where the group's size is not
    ``group_shards · client_shards``."""
    resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError(
            "make_group_mesh: no process group; call "
            "torch.distributed.init_process_group first (torchrun sets "
            "its address, rank and world size)")
    world = dist.get_world_size(group)
    c = int(client_shards)
    if c < 1 or int(group_shards) < 0:
        raise ValueError(f"make_group_mesh({group_shards}, {client_shards}):"
                         " shard counts must be positive (0 groups: all)")
    g = int(group_shards) or max(1, world // c)
    if g * c != world:
        raise ValueError(f"make_group_mesh: a ({g}, {c}) mesh needs {g * c} "
                         f"ranks, the process group has {world}")
    whole = make_client_mesh(group, device)
    gi, ci = divmod(whole.rank, c)
    ranks = list(range(world)) if group is None \
        else dist.get_process_group_ranks(group)
    rows = [dist.new_group([ranks[i * c + j] for j in range(c)],
                           backend=whole.backend) for i in range(g)]
    cols = [dist.new_group([ranks[i * c + j] for i in range(g)],
                           backend=whole.backend) for j in range(c)]
    groups = make_client_mesh(cols[ci], whole.device)
    clients = make_client_mesh(rows[gi], whole.device)
    return GroupMesh(whole=whole, groups=groups, clients=clients,
                     shape=(g, c))


# ---------------------------------------------------------------------------
# the production (data, model) mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class ProductionMesh:
    """The (data, model) or (pod, data, model) grid of ranks of the
    default process group: rank = row-major index of its coordinates
    (``coords``, one a name of ``axis_names``), as ``jax.make_mesh``
    orders devices.  ``shape`` maps each axis to its size, as the
    reference's ``Mesh.shape`` does.

    The collectives run over a set of axes (a name or a tuple of names):
    the ranks whose coordinates differ only there, in row-major order of
    those axes, each set a ``torch.distributed`` subgroup made once by
    :func:`make_mesh`.  ``calls`` counts, keyed ``"{op}:{axes}"`` (axes
    joined by ``+`` in mesh order), each call since the mesh was made or
    :meth:`reset_counts`; a call over axes of one rank moves nothing and
    still counts, so the counts of a step do not depend on the layout."""
    axis_names: tuple
    sizes: tuple
    coords: tuple
    backend: str
    device: torch.device
    groups: dict
    calls: dict = dataclasses.field(default_factory=dict)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def axes(self, axes) -> tuple:
        """``axes`` (a name or names) as a tuple in mesh order."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = set(names) - set(self.axis_names)
        if unknown:
            raise ValueError(f"mesh axes {self.axis_names} have no "
                             f"{sorted(unknown)}")
        return tuple(a for a in self.axis_names if a in names)

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self.axes(axes))

    def axis_index(self, axes) -> int:
        """This rank's position in the group over ``axes`` (row-major)."""
        idx = 0
        for a in self.axes(axes):
            idx = idx * self.shape[a] + self.coords[self.axis_names.index(a)]
        return idx

    def reset_counts(self) -> None:
        """Set every counter to 0."""
        self.calls.clear()

    def _count(self, op: str, axes: tuple) -> None:
        key = f"{op}:{'+'.join(axes)}"
        self.calls[key] = self.calls.get(key, 0) + 1

    def all_gather(self, x: torch.Tensor, axes, dim: int = 0):
        """The group's tensors concatenated along ``dim`` in rank order
        (``x`` itself over axes of one rank)."""
        axes = self.axes(axes)
        self._count("all_gather", axes)
        n = self.axis_size(axes)
        if n == 1:
            return x
        x = x.contiguous()
        if self.backend == "nccl":
            buf = torch.empty((n, *x.shape), dtype=x.dtype, device=x.device)
            dist.all_gather_into_tensor(buf, x, group=self.groups[axes])
            parts = buf.unbind(0)
        else:
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x, group=self.groups[axes])
        return torch.cat(parts, dim=dim)

    def reduce_scatter(self, x: torch.Tensor, axes, dim: int = 0):
        """This rank's block, along ``dim``, of the group's sum (``dim``
        divided evenly).  gloo sums the whole tensor and keeps the block."""
        axes = self.axes(axes)
        self._count("reduce_scatter", axes)
        n = self.axis_size(axes)
        if n == 1:
            return x
        if x.shape[dim] % n:
            raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                             f"does not split over {n} ranks")
        size = x.shape[dim] // n
        if self.backend == "nccl":
            stacked = torch.stack(x.split(size, dim=dim))
            out = torch.empty_like(stacked[0])
            dist.reduce_scatter_tensor(out, stacked, group=self.groups[axes])
            return out
        total = x.contiguous().clone()
        dist.all_reduce(total, group=self.groups[axes])
        return total.narrow(dim, self.axis_index(axes) * size, size)

    def all_reduce(self, x: torch.Tensor, axes, op: str = "sum"):
        """The group's elementwise ``op`` (``"sum"`` or ``"max"``) on every
        rank (``x`` itself over axes of one rank)."""
        axes = self.axes(axes)
        self._count(f"all_reduce_{op}" if op != "sum" else "all_reduce",
                    axes)
        if self.axis_size(axes) == 1:
            return x
        out = x.contiguous().clone()
        dist.all_reduce(out, op={"sum": dist.ReduceOp.SUM,
                                 "max": dist.ReduceOp.MAX}[op],
                        group=self.groups[axes])
        return out


def make_mesh(shape, axes, device: Device = None) -> ProductionMesh:
    """A :class:`ProductionMesh` of ``shape`` over ``axes`` on the default
    process group, which must hold exactly prod(shape) ranks (no
    shrinking).  For every set of two or more ranks' axes it makes one
    ``dist.new_group`` a group of ranks, every process all of them in
    one order (``new_group`` is collective over the default group), on
    the default group's backend.  ``device`` follows
    :func:`make_client_mesh`: ``cuda`` (this rank's card) unless the
    caller asks for the CPU; nccl on a CPU device raises."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: no process group; call "
            "torch.distributed.init_process_group first (torchrun sets "
            "its address, rank and world size)")
    sizes, names = tuple(int(n) for n in shape), tuple(axes)
    if len(sizes) != len(names) or len(set(names)) != len(names) \
            or min(sizes, default=0) < 1:
        raise ValueError(f"make_mesh: shape {shape} and axes {axes}")
    world = dist.get_world_size()
    if math.prod(sizes) != world:
        raise ValueError(f"make_mesh: a {sizes} mesh needs "
                         f"{math.prod(sizes)} ranks, the process group has "
                         f"{world}")
    dev = _rank_card(dev)
    backend = str(dist.get_backend())
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend reduces CUDA tensors; the rank's "
                         f"device is {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    rank = dist.get_rank()
    coords = tuple(int(c) for c in np.unravel_index(rank, sizes))
    groups = {}
    for k in range(1, len(names) + 1):
        for subset in itertools.combinations(range(len(names)), k):
            axes_k = tuple(names[i] for i in subset)
            if math.prod(sizes[i] for i in subset) == 1:
                groups[axes_k] = None
                continue
            if k == len(names):
                groups[axes_k] = dist.group.WORLD
                continue
            others = [i for i in range(len(names)) if i not in subset]
            for fixed in itertools.product(*(range(sizes[i])
                                             for i in others)):
                members = []
                for var in itertools.product(*(range(sizes[i])
                                               for i in subset)):
                    c = [0] * len(names)
                    for i, v in zip(others, fixed):
                        c[i] = v
                    for i, v in zip(subset, var):
                        c[i] = v
                    members.append(int(np.ravel_multi_index(c, sizes)))
                g = dist.new_group(members, backend=backend)
                if rank in members:
                    groups[axes_k] = g
    return ProductionMesh(axis_names=names, sizes=sizes, coords=coords,
                          backend=backend, device=dev, groups=groups)


def make_production_mesh(*, multi_pod: bool = False,
                         device: Device = None) -> ProductionMesh:
    """The reference's production mesh: (data 16, model 16), or (pod 2,
    data 16, model 16) with ``multi_pod``: 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(device: Device = None) -> ProductionMesh:
    """The (1, 1) (data, model) mesh of one rank: the production code path
    on one device."""
    return make_mesh((1, 1), ("data", "model"), device)


def arena_axes(mesh) -> tuple:
    """The axes a population-resident (I, …) array's leading client dim
    homes over: every axis of the mesh, in mesh order (``("clients",)``
    on a client mesh, ``("groups", "clients")`` on a group mesh, whose
    arena is homed over the flattened groups-major ranks)."""
    if isinstance(mesh, ClientMesh):
        return ("clients",)
    if isinstance(mesh, GroupMesh):
        return ("groups", "clients")
    return tuple(mesh.axis_names)


def arena_spec(mesh) -> tuple:
    """The placement of an array whose leading client dim homes over the
    whole mesh: that dim over :func:`arena_axes`, the rest whole (the
    entries of :mod:`repro_torch.launch.sharding`'s tables)."""
    return (arena_axes(mesh),)


# ---------------------------------------------------------------------------
# a local world of D processes
# ---------------------------------------------------------------------------

def _rank_main(rank: int, size: int, backend: str, store: str, fn, args,
               results, timeout_s: float) -> None:
    """One spawned rank, on one intra-op thread: join the world's
    FileStore group, run ``fn(*args)``, put (rank, ok, result or
    traceback) on ``results``."""
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            backend, store=dist.FileStore(store, size), rank=rank,
            world_size=size, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:                        # reported to the parent
        results.put((rank, False, traceback.format_exc()))


class LocalWorld:
    """D spawned processes, one rank each, of one ``torch.distributed``
    group on a ``FileStore`` in a temporary directory (no TCP port), each
    on one intra-op thread; daemons, so none outlives this process.  ``fn`` must be importable by its
    module path, as ``multiprocessing``'s spawn method requires, and
    return a picklable value (tensors on the CPU).  The collectives
    time out after ``timeout_s``; :meth:`join` waits at most as long
    for every rank, then stops every process and raises if a rank
    failed or did not answer."""

    def __init__(self, fn: Callable, size: int, *, backend: str,
                 args: tuple = (), timeout_s: float = 300.0):
        ctx = multiprocessing.get_context("spawn")
        self.size, self.timeout_s = int(size), float(timeout_s)
        self._tmp = tempfile.mkdtemp(prefix="repro_torch_world_")
        self._results = ctx.Queue()
        self._procs = [ctx.Process(
            target=_rank_main,
            args=(r, self.size, backend, os.path.join(self._tmp, "store"),
                  fn, args, self._results, self.timeout_s),
            name=f"repro_torch-rank{r}", daemon=True)
            for r in range(self.size)]
        for p in self._procs:
            p.start()

    def join(self) -> list:
        """Every rank's result, in rank order."""
        got: dict = {}
        deadline = time.monotonic() + self.timeout_s
        done = False
        try:
            while len(got) < self.size:
                left = deadline - time.monotonic()
                if left <= 0:
                    late = sorted(set(range(self.size)) - set(got))
                    raise TimeoutError(
                        f"local world: ranks {late} did not answer within "
                        f"{self.timeout_s:.0f} s")
                try:
                    rank, ok, out = self._results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(self._procs)
                            if r not in got and not p.is_alive()
                            and p.exitcode not in (0, None)]
                    if dead:
                        raise RuntimeError(
                            f"local world: rank {dead[0]} exited with code "
                            f"{self._procs[dead[0]].exitcode}")
                    continue
                if not ok:
                    raise RuntimeError(f"local world: rank {rank} failed:\n"
                                       f"{out}")
                got[rank] = out
            done = True
        finally:
            self.close(grace_s=10.0 if done else 0.0)
        return [got[r] for r in range(self.size)]

    def close(self, grace_s: float = 0.0) -> None:
        """Stop every process: each gets ``grace_s`` to exit, then is
        terminated and, if need be, killed; remove the store's
        directory."""
        for p in self._procs:
            p.join(timeout=grace_s)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        shutil.rmtree(self._tmp, ignore_errors=True)
