"""The hierarchical tree's cases on the 2-D (groups, clients) mesh, run by
every rank of a local gloo world (``tests/test_torch_group_mesh.py``)
and, without a mesh, by the test process as their reference.

The ranks are spawned processes that must load nothing of JAX or of the
reference package, so this module imports numpy, torch and
``repro_torch`` only.  The configuration is the reference's
``tests/sharded_engine_check.py`` (2000 samples over 10 iid clients, B =
10, 6 rounds, eval every 3 on 300 samples, seed 3) under
``hierarchical(secure(), groups=4)``: M = ⌈10/4⌉ = 3, so the last group
is padded (G ∤ S), and on the (1, 2) layout the member axis too (M_pad =
4).  The async and pipelined rounds run ``tests/async_engine_check.py``'s
trace (eval every 2) under ``hierarchical(groups=2)``, as
``tests/test_async.py`` and ``tests/pipeline_engine_check.py`` do.

A run is keyed (case, layout, arena, mode): ``layout`` the mesh's (g, c),
``arena`` ``None`` (the default, sharded) or ``"replicated"``, ``mode``
one of :data:`MODES`.
"""
from __future__ import annotations

import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.data import partition, synthetic
from repro_torch.fed import aggregation, compression, runtime, staleness
from repro_torch.fed import sketch as fsk
from repro_torch.kernels import secure_agg
from repro_torch.launch import make_group_mesh
from repro_torch.mlpapp import model as tm

KW = dict(batch_size=10, rounds=6, eval_every=3, eval_samples=300, seed=3)
KW_ASYNC = dict(KW, eval_every=2)
FEDAVG = dict(local_steps=2, lr_a=2.0)
# the reference's nonzero trace (delays 3 and 4 drop at K = 2)
DELAYS = (0.5, 0.2, 0.15, 0.1, 0.05)


def hier(groups=4, inner=None):
    return aggregation.hierarchical(
        aggregation.secure() if inner is None else inner, groups=groups)


# name -> (entry point, keyword arguments); the async and pipelined
# checks' case runs every mode at KW_ASYNC, the others KW
CASES = {
    "flat/secure": ("run_alg1", lambda: dict(KW, secure=True)),
    "hier4/secure": ("run_alg1", lambda: dict(KW, aggregation=hier())),
    "hier4/topk8": ("run_alg1", lambda: dict(
        KW, aggregation=hier(), compressor=compression.topk(0.2, bits=8))),
    "hier4/sketch": ("run_alg1", lambda: dict(
        KW, aggregation=hier(),
        compressor=fsk.sketch(rows=4, cols=512, fraction=0.02, keep=64))),
    "hier4/plain": ("run_alg1", lambda: dict(
        KW, aggregation=hier(inner=aggregation.plain()))),
    "alg2/hier4": ("run_alg2", lambda: dict(KW, limit_u=0.4,
                                            aggregation=hier())),
    "fedsgd/hier4": ("run_fedsgd", lambda: dict(KW, lr_a=2.0,
                                                aggregation=hier())),
    "fedavg/hier4": ("run_fedavg", lambda: dict(KW, **FEDAVG,
                                                aggregation=hier())),
    "hier2/secure": ("run_alg1", lambda: dict(KW_ASYNC,
                                              aggregation=hier(2))),
}


def _tau1(rounds, cohort):
    """The constant τ ≡ 1 trace pipelined rounds run, as an async run."""
    return {"staleness": staleness.StalenessConfig(
        max_staleness=1, schedule=staleness.ConstantDiscount()),
        "staleness_trace": np.ones((rounds, cohort), np.int64)}


# mode -> the round's arguments, from (rounds, cohort size)
MODES = {
    "sync": lambda r, s: {},
    "zero": lambda r, s: {
        "staleness": staleness.StalenessConfig(max_staleness=2)},
    "delay": lambda r, s: {"staleness": staleness.StalenessConfig(
        max_staleness=2, delay_probs=DELAYS)},
    "pipeline": lambda r, s: {"pipeline": True},
    "tau1": _tau1,
}

# the other algorithms' round modes under the tree, at (2, 1)
OTHER_MODES = [("alg2/hier4", (2, 1), None, "delay"),
               ("fedsgd/hier4", (2, 1), None, "pipeline"),
               ("fedavg/hier4", (2, 1), None, "delay")]
# the two-rank world: both layouts of two ranks
TWO_LAYOUTS = [(2, 1), (1, 2)]
# (case, layout, arena, mode) of each world
TWO = ([(n, lay, a, "sync") for lay in TWO_LAYOUTS
        for n in ("hier4/secure", "hier4/topk8")
        for a in (None, "replicated")]
       + [(n, (2, 1), None, "sync") for n in
          ("hier4/sketch", "hier4/plain", "alg2/hier4", "fedsgd/hier4",
           "fedavg/hier4")]
       + [("hier2/secure", lay, None, m) for lay in TWO_LAYOUTS
          for m in ("sync", "zero", "delay", "pipeline", "tau1")]
       + [("hier2/secure", lay, "replicated", m) for lay in TWO_LAYOUTS
          for m in ("delay", "pipeline")]
       + OTHER_MODES)
FOUR = [(n, (2, 2), a, "sync") for n in ("hier4/secure", "hier4/topk8")
        for a in (None, "replicated")]
# the port's mesh=None runs the mesh runs are held against
REFERENCE = ([(n, "sync") for n in CASES]
             + [("hier2/secure", m) for m in ("delay", "tau1")]
             + [(n, m) for n, _, _, m in OTHER_MODES])
# the chunked ring's piece counts on each axis
RING_CHUNKS = (3, 4)


def setting():
    """(data, partition) of the ten clients."""
    data = synthetic.classification_dataset(n_train=2000, n_test=500,
                                            seed=0)
    return data, partition.iid(2000, 10, seed=0)


def run_case(name, p0, mode="sync", *, mesh=None, arena=None) -> dict:
    """One case on the CPU: the final weights (numpy, leaf order), the
    history without its wall time, and on a mesh each axis's counts."""
    entry, extra = CASES[name]
    data, part = setting()
    kw = extra()
    kw.update(MODES[mode](kw["rounds"], part.num_clients))
    kw["params"] = tm.params_from_numpy(p0, "cpu")
    if mesh is None:
        kw["device"] = "cpu"
    else:
        mesh.reset_counts()
        kw.update(mesh=mesh, arena=arena)
    params, hist = getattr(runtime, entry)(data, part, **kw)
    h = hist.as_dict()
    del h["wall_seconds"]
    out = {"params": [x.detach().cpu().numpy() for x in tree.leaves(params)],
           "hist": h}
    if mesh is not None:
        out["counts"] = axis_counts(mesh)
    return out


def axis_counts(mesh) -> dict:
    """Each axis's (psum calls, psum bytes, ring calls, ring bytes)."""
    return {name: (axis.psum_calls, axis.psum_bytes, axis.ring_calls,
                   axis.ring_bytes)
            for name, axis in zip(("whole", "groups", "clients"),
                                  mesh.axes())}


def foreign_modules():
    """Modules of JAX or of the reference package loaded in this
    process."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "repro"))


def rank_main(runs, p0) -> dict:
    """A rank's entry: a group mesh of each layout ``runs`` names, on the
    CPU (each made by every rank, in the same order), its geometry and
    the chunked ring's checks on each axis, the refusals that need a
    process group, then every run of ``runs`` with the masked sum's and
    the ring mode's calls (local rows, offset, rows in all, dropped
    slots) recorded."""
    layouts = sorted({r[1] for r in runs})
    meshes = {lay: make_group_mesh(*lay, device="cpu") for lay in layouts}
    out = {"foreign": [], "meshes": {}, "runs": {}}
    for lay, mesh in meshes.items():
        out["meshes"][lay] = {
            "rank": mesh.rank, "size": mesh.size, "coords": mesh.coords,
            "backend": mesh.backend,
            "axes": [(a.rank, a.size, a.backend, a.int32_wraps,
                      dist.get_process_group_ranks(
                          a.group or dist.group.WORLD))
                     for a in mesh.axes()],
            "ring": ring_checks(mesh)}
    out["refusals"] = refusals(meshes[max(layouts)], p0)
    seen = []
    masked, ring = secure_agg.masked_sum_2d, secure_agg.masked_ring_sum_2d

    def recorder(fn, kind):
        def call(rows, key0, key1, *, num_clients, client_offset=0,
                 alive=None, **kw):
            seen.append((kind, rows.shape[0], client_offset, num_clients,
                         None if alive is None
                         else int((alive == 0).sum())))
            return fn(rows, key0, key1, num_clients=num_clients,
                      client_offset=client_offset, alive=alive, **kw)
        return call

    secure_agg.masked_sum_2d = recorder(masked, "masked")
    secure_agg.masked_ring_sum_2d = recorder(ring, "ring")
    try:
        for key in runs:
            name, lay, arena, mode = key
            seen.clear()
            run = run_case(name, p0, mode, mesh=meshes[lay], arena=arena)
            run["calls"] = list(seen)
            out["runs"][key] = run
    finally:
        secure_agg.masked_sum_2d, secure_agg.masked_ring_sum_2d = masked, \
            ring
    out["foreign"] = foreign_modules()
    return out


def refusals(mesh, p0) -> dict:
    """The refusals that need a process group: a mesh whose shape is not
    the world's, and (on ``mesh``, whose groups axis has two ranks) a G
    that axis does not divide and a flat strategy; each error's type and
    message."""
    data, part = setting()
    kw = dict(batch_size=10, rounds=1, params=tm.params_from_numpy(p0, "cpu"),
              mesh=mesh)
    tries = {
        "world": lambda: make_group_mesh(mesh.size + 1, 1, device="cpu"),
        "groups": lambda: runtime.run_alg1(
            data, part, aggregation=hier(2 * mesh.shape[0] + 1), **kw),
        "flat": lambda: runtime.run_alg1(data, part, secure=True, **kw),
    }
    out = {}
    for name, fn in tries.items():
        try:
            fn()
            out[name] = None
        except Exception as e:               # reported to the test
            out[name] = (type(e).__name__, str(e))
    return out


def ring_inputs(rank: int) -> dict:
    """A rank's share of the reference's mixed tree
    (``tests/pipeline_engine_check.py::check_ring_psum``): int32 of
    length 37·13 + 3 over the full range, f32, and a small int32 leaf."""
    rng = np.random.default_rng(200 + rank)
    return {"a": rng.integers(-2 ** 31, 2 ** 31, (37, 13)).astype(np.int32),
            "b": rng.standard_normal(5).astype(np.float32),
            "d": rng.integers(-100, 100, 3).astype(np.int32)}


def ring_checks(mesh) -> dict:
    """On each axis of the mesh, ``ring_psum_chunked`` at
    :data:`RING_CHUNKS` pieces beside the axis's psum of the mixed tree,
    with the axis's counts after each."""
    x = {k: torch.as_tensor(v) for k, v in ring_inputs(mesh.rank).items()}
    out = {}
    for name, axis in (("groups", mesh.groups), ("clients", mesh.clients)):
        axis.reset_counts()
        got = {"psum": {k: v.numpy() for k, v in axis.psum(x).items()}}
        for chunks in RING_CHUNKS:
            axis.reset_counts()
            s = axis.ring_psum_chunked(x, chunks=chunks)
            got[chunks] = ({k: v.numpy() for k, v in s.items()},
                           (axis.ring_calls, axis.psum_calls,
                            axis.ring_bytes))
        out[name] = got
    mesh.reset_counts()
    return out
