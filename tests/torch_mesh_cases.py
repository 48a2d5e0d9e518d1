"""The client-sharded engine's cases, run by every rank of a local gloo
world (``tests/test_torch_mesh.py``, ``tests/test_torch_arena.py``) and,
without a mesh, by the test process as their reference.

The ranks are spawned processes that must load nothing of JAX or of the
reference package, so this module imports numpy, torch and
``repro_torch`` only.  The configurations are the reference's
``tests/sharded_engine_check.py`` (2000 samples over 10 iid clients, B =
10, 6 rounds, eval every 3 on 300 samples, seed 3; I = 7 with B = 5, 4
rounds), ``tests/sharded_arena_check.py`` and ``tests/task_mesh_check.py``
(the reduced dense LM and RWKV-6, secure with ``qsgd(8)``), and for the
async and pipelined rounds ``tests/async_engine_check.py`` and
``tests/pipeline_engine_check.py`` (eval every 2).  Every MLP case on the
10 clients starts from the weights the caller passes (the reference's
initial weights, carried as numpy arrays).

A run is keyed (case, arena) for a synchronous round at ``KW`` and
(case, arena, mode) for a round mode of :data:`MODES` at ``KW_ASYNC``.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch import tree
from repro_torch.data import partition, synthetic
from repro_torch.fed import aggregation, compression, runtime
from repro_torch.fed import arena as arena_mod
from repro_torch.fed import sketch as fsk
from repro_torch.fed import staleness
from repro_torch.fed.tasks import rwkv6_task, transformer_task
from repro_torch.kernels import ops, secure_agg
from repro_torch.launch import make_client_mesh
from repro_torch.mlpapp import model as tm

KW = dict(batch_size=10, rounds=6, eval_every=3, eval_samples=300, seed=3)
KW7 = dict(batch_size=5, rounds=4, eval_every=2, eval_samples=200, seed=3)
KW_LM = dict(batch_size=4, rounds=4, eval_every=2, eval_samples=64, seed=3,
             tau=2.0, secure=True)
FEDAVG = dict(local_steps=2, lr_a=2.0)
# the async and pipelined rounds' checks, and the small population the
# mesh refused these modes on before they ran there
KW_ASYNC = dict(KW, eval_every=2)
KW_SMALL = dict(batch_size=5, rounds=3, eval_every=1, eval_samples=40,
                seed=0, hidden=4)
# the reference's nonzero trace (delays 3 and 4 drop at K = 2)
DELAYS = (0.5, 0.2, 0.15, 0.1, 0.05)


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
    # the small population's three modes: a drawn trace, a given one
    "staleness": lambda r, s: {"staleness": staleness.StalenessConfig(
        max_staleness=1, delay_probs=(0.4, 0.3, 0.2, 0.1))},
    "staleness_trace": lambda r, s: {
        "staleness": staleness.StalenessConfig(max_staleness=1),
        "staleness_trace": np.arange(r * s).reshape(r, s) % 3},
}


def sketch():
    return fsk.sketch(rows=4, cols=512, fraction=0.02, keep=64)


# name -> (entry point, population, keyword arguments); the first twelve
# are sharded_engine_check.py's cases
CASES = {
    "alg1/plain": ("run_alg1", "i10", lambda: {}),
    "alg1/secure": ("run_alg1", "i10", lambda: {"secure": True}),
    "alg1/sampled": ("run_alg1", "i10",
                     lambda: {"aggregation": aggregation.sampled(4)}),
    "alg1/sampled1": ("run_alg1", "i10",
                      lambda: {"aggregation": aggregation.sampled(1)}),
    "fedavg": ("run_fedavg", "i10", lambda: dict(FEDAVG)),
    "alg1/qsgd8": ("run_alg1", "i10",
                   lambda: {"compressor": compression.qsgd(8)}),
    "alg1/topk8+secure": ("run_alg1", "i10", lambda: {
        "compressor": compression.topk(0.2, bits=8), "secure": True}),
    "fedavg/topk": ("run_fedavg", "i10", lambda: dict(
        FEDAVG, compressor=compression.topk(0.3))),
    "alg1/sampled4+topk": ("run_alg1", "i10", lambda: {
        "aggregation": aggregation.sampled(4),
        "compressor": compression.topk(0.2)}),
    "alg1/secure_sampled3": ("run_alg1", "i10", lambda: {
        "aggregation": aggregation.secure(num_sampled=3)}),
    "fedavg/sampled3+qsgd": ("run_fedavg", "i10", lambda: dict(
        FEDAVG, aggregation=aggregation.sampled(3),
        compressor=compression.qsgd(8))),
    "alg1/sketch+secure3": ("run_alg1", "i10", lambda: {
        "aggregation": aggregation.secure(num_sampled=3),
        "compressor": sketch()}),
    # the sketched secure wire at full participation, held bit for bit
    "alg1/sketch+secure": ("run_alg1", "i10", lambda: {
        "compressor": sketch(), "secure": True}),
    "alg1/identity": ("run_alg1", "i10",
                      lambda: {"compressor": compression.identity()}),
    "I=7": ("run_alg1", "i7", lambda: {}),
    "I=7/topk": ("run_alg1", "i7",
                 lambda: {"compressor": compression.topk(0.3)}),
    # the paper's other algorithms: Algorithm 2's (value, gradient)
    # upload on the linear fast path and masked, FedSGD masked
    "alg2": ("run_alg2", "i10", lambda: {"limit_u": 0.4}),
    "alg2/secure": ("run_alg2", "i10",
                    lambda: {"limit_u": 0.4, "secure": True}),
    "fedsgd/secure": ("run_fedsgd", "i10", lambda: {
        "lr_a": 2.0, "aggregation": aggregation.secure()}),
    # the async and pipelined checks' other cases: top-k alone, the
    # sketch's defaults, a secure cohort of 5 (padded to 6 on two ranks),
    # and the small population
    "alg1/topk": ("run_alg1", "i10",
                  lambda: {"compressor": compression.topk(0.3)}),
    "alg1/sketch0+secure": ("run_alg1", "i10", lambda: {
        "compressor": fsk.sketch(), "secure": True}),
    "alg1/secure_sampled5": ("run_alg1", "i10", lambda: {
        "aggregation": aggregation.secure(num_sampled=5)}),
    "small/alg1": ("run_alg1", "small", lambda: {}),
    "small/fedavg": ("run_fedavg", "small", lambda: dict(FEDAVG)),
    "lm/transformer": ("run_alg1", "transformer",
                       lambda: {"compressor": compression.qsgd(8)}),
    "lm/rwkv6": ("run_alg1", "rwkv6",
                 lambda: {"compressor": compression.qsgd(8)}),
}
ENGINE = list(CASES)[:12]
LM = ["lm/transformer", "lm/rwkv6"]
PAPER = ["alg2", "alg2/secure", "fedsgd/secure"]
# sharded_arena_check.py's synchronous cases and its I = 7 top-k case
ARENA = ["alg1/plain", "alg1/topk8+secure", "alg1/sketch+secure3",
         "fedavg/topk", "I=7/topk"]
# async_engine_check.py's seven cases; sharded_arena_check.py's async
# ones; pipeline_engine_check.py's flat cases, a replicated arena among
# them, and its padded cohort
ASYNC = ["alg1/plain", "alg1/secure", "alg1/sampled", "alg1/qsgd8",
         "alg1/topk8+secure", "fedavg", "fedavg/topk"]
ASYNC_ARENA = ["alg1/plain", "alg1/topk"]
PIPELINE = [("alg1/plain", None), ("alg1/secure", None),
            ("alg1/topk8+secure", None), ("alg1/sketch0+secure", None),
            ("fedavg", None), ("alg1/topk8+secure", "replicated"),
            ("alg1/secure_sampled5", None)]
# Algorithm 2 and FedSGD in the round modes (the two others run above)
PAPER_MODES = [("alg2", "delay"), ("alg2/secure", "delay"),
               ("fedsgd/secure", "pipeline")]
SMALL = ["small/alg1", "small/fedavg"]
SMALL_MODES = ["staleness", "staleness_trace", "pipeline"]


def psums_per_round(name: str, arena: str = "sharded") -> int:
    """``PERF.md`` §4's psum calls a round: the home-sharded weight gather
    (none when replicated), the combine (two on the sketch's two phases;
    the linear fast path psums its one upload instead), and for a
    stateful compressor the residual rows' gather (sharded only) and
    their replication."""
    extra = CASES[name][2]()
    comp = extra.get("compressor")
    stateful = comp is not None and getattr(comp, "stateful", False)
    n = 2 if "sketch" in name else 1
    if arena == "sharded":
        n += 1 + stateful
    return n + stateful


def collectives_per_round(name: str, arena: str = "sharded",
                          mode: str = "sync", ranks: int = 2) -> tuple:
    """``PERF.md`` §4's (psum calls, chunked-ring calls) a round of a
    round mode: the synchronous round's psums, the packed snapshot ring's
    rebuild under the sharded arena, and in pipelined rounds on two or
    more ranks the int32 partial of a secure message path (the sketch's
    phase 1) through the ring instead of a psum."""
    psums, rings = psums_per_round(name, arena), 0
    if mode == "sync":
        return psums, rings
    psums += arena == "sharded"
    if mode == "pipeline" and ranks > 1 and "secure" in name:
        psums, rings = psums - 1, 1
    return psums, rings


def lm_task(name):
    make = transformer_task if name == "transformer" else rwkv6_task
    return make(seq_len=16, d_model=32, vocab=64)


def setting(population):
    """(data, partition, keyword arguments, task) of a population."""
    if population in ("transformer", "rwkv6"):
        task = lm_task(population)
        return (task.default_data(n_train=128, n_test=32, seed=0),
                partition.iid(128, 4, seed=0), KW_LM, task)
    if population == "small":
        return (synthetic.classification_dataset(n_train=40, n_test=10,
                                                 k=16, l=3, seed=0),
                partition.iid(40, 4, seed=0), KW_SMALL, None)
    data = synthetic.classification_dataset(n_train=2000, n_test=500,
                                            seed=0)
    if population == "i7":
        return data, partition.iid(700, 7, seed=0), KW7, None
    return data, partition.iid(2000, 10, seed=0), KW, None


def cohort_of(name) -> int:
    """The case's cohort size S."""
    agg = CASES[name][2]().get("aggregation")
    clients = setting(CASES[name][1])[1].num_clients
    return clients if agg is None else agg.cohort_size(clients)


def run_case(name, p0, *, mesh=None, arena=None, mode=None,
             **over) -> dict:
    """One case on the CPU, synchronous or in a round mode of
    :data:`MODES`: the final weights (numpy, leaf order), the history
    without its wall time, and the mesh's psum and ring counts."""
    entry, population, extra = CASES[name]
    data, part, kw, task = setting(population)
    if mode is not None and population == "i10":
        kw = KW_ASYNC
    kw = dict(kw, **extra(), **over)
    if mode is not None:
        kw.update(MODES[mode](kw["rounds"], cohort_of(name)))
    if population == "small":
        pass                                 # the port's own initial weights
    elif task is None:
        kw["params"] = tm.params_from_numpy(p0, "cpu")
    else:
        kw["task"] = task
    if mesh is not None:
        mesh.psum_calls = mesh.all_reduces = mesh.psum_bytes = 0
        mesh.ring_calls = mesh.ring_bytes = mesh.ring_staged_bytes = 0
        kw.update(mesh=mesh, arena=arena)
    else:
        kw["device"] = "cpu"
    params, hist = getattr(runtime, entry)(data, part, **kw)
    h = hist.as_dict()
    del h["wall_seconds"]
    out = {"params": [x.detach().cpu().numpy() for x in tree.leaves(params)],
           "hist": h}
    if mesh is not None:
        out.update(psum_calls=mesh.psum_calls, all_reduces=mesh.all_reduces,
                   psum_bytes=mesh.psum_bytes, ring_calls=mesh.ring_calls,
                   ring_bytes=mesh.ring_bytes,
                   ring_staged_bytes=mesh.ring_staged_bytes)
    return out


def foreign_modules():
    """Modules of JAX or of the reference package loaded in this
    process."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "repro"))


def rank_main(runs, p0, checks: bool = False, ring: bool = False) -> dict:
    """A rank's entry: on the default group's client mesh, on the CPU,
    the collective's checks (``checks``) and the chunked ring's
    (``ring``), then every (case, arena) and
    (case, arena, mode) of ``runs``, with the masked sum's launches
    (local clients, offset, cohort, dropped slots) and the int32 ring
    blocks the snapshot ring keeps (shape) recorded per run."""
    mesh = make_client_mesh(device="cpu")
    out = {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
           "wraps": mesh.int32_wraps}
    if checks:
        out["checks"] = collective_checks(mesh)
    if ring:
        out["ring"] = ring_checks(mesh)
    seen = {"masked": [], "blocks": []}
    plain, localize = secure_agg.masked_sum_plain, staleness.ring_localize

    def masked(msgs, key0, key1, *, client_offset=0, alive=None, **kw):
        seen["masked"].append((msgs.shape[0], client_offset,
                               kw["num_clients"], None if alive is None
                               else int((alive == 0).sum())))
        return plain(msgs, key0, key1, client_offset=client_offset,
                     alive=alive, **kw)

    def block(packed, meta, my_id):
        got = localize(packed, meta, my_id)
        seen["blocks"].append((tuple(got.shape), str(got.dtype)))
        return got

    secure_agg.masked_sum_plain, staleness.ring_localize = masked, block
    out["runs"] = {}
    try:
        for key in runs:
            name, arena, *mode = key
            seen["masked"].clear()
            seen["blocks"].clear()
            run = run_case(name, p0, mesh=mesh, arena=arena,
                           mode=mode[0] if mode else None)
            if mode:
                run.update(masked=list(seen["masked"]),
                           blocks=sorted(set(seen["blocks"])))
            out["runs"][key] = run
    finally:
        secure_agg.masked_sum_plain, staleness.ring_localize = plain, \
            localize
    out["foreign"] = foreign_modules()
    return out


# ---------------------------------------------------------------------------
# the collective's unit checks, in the same world
# ---------------------------------------------------------------------------

def wrap_inputs(rank: int) -> dict:
    """A rank's psum inputs: int32 values whose sum over two ranks passes
    2^31 (and −2^31), beside f32 values in the same tree."""
    rng = np.random.default_rng(100 + rank)
    big = np.array([2 ** 31 - 1, -2 ** 31, 2 ** 30 + 7, -(2 ** 30) - 9],
                   np.int64)
    ints = np.concatenate([big, rng.integers(-2 ** 31, 2 ** 31, 60)])
    return {"i": ints.astype(np.int32),
            "f": rng.standard_normal(5).astype(np.float32)}


def masked_inputs(clients: int, seed: int = 7) -> dict:
    """Fixed uploads of ``clients`` cohort slots, a two-leaf tree."""
    rng = np.random.default_rng(seed)
    return {"a": (rng.standard_normal((clients, 3, 50)) * 0.3)
            .astype(np.float32),
            "b": (rng.standard_normal((clients, 77)) * 2.0).astype(np.float32)}


KEY = np.array([0x1234ABCD, 0x0BADF00D], np.uint32)
# cohort sizes of the masked-partial check: 10, and 5 (padded on 2 ranks)
MASKED = (10, 5)


def rows_population(num_clients: int = 7) -> np.ndarray:
    """A population of (I, 2, 3) rows holding NaN payloads, −0.0, ±inf
    and subnormals."""
    rng = np.random.default_rng(11)
    pop = rng.standard_normal((num_clients, 2, 3)).astype(np.float32)
    bits = pop.view(np.uint32)
    bits[0, 0, 0] = 0x7FC01234        # NaN with a payload
    bits[1, 0, 1] = 0x80000000        # −0.0
    bits[2, 1, 2] = 0xFFA00001        # a signalling-pattern NaN, sign set
    bits[3, 0, 0] = 0x00000001        # the smallest subnormal
    bits[4, 1, 1] = 0xFF800000        # −inf
    bits[6, 1, 0] = 0x80000000
    return pop


COHORT = [6, 1, 3, 7]                 # 7 is the sentinel of I = 7


def collective_checks(mesh) -> dict:
    """The psum, the masked partials and the arena's routing on ``mesh``;
    returns what each computed, for the test process to check."""
    out = {}
    x = {k: torch.as_tensor(v) for k, v in wrap_inputs(mesh.rank).items()}
    mesh.psum_calls = mesh.all_reduces = 0
    s = mesh.psum(x)
    out["psum"] = {k: v.numpy() for k, v in s.items()}
    out["psum_counts"] = (mesh.psum_calls, mesh.all_reduces)
    # the int64 sum masked to 32 bits, as for a backend that does not wrap
    wraps, mesh.int32_wraps = mesh.int32_wraps, False
    out["psum_wide"] = mesh.psum(x)["i"].numpy()
    mesh.int32_wraps = wraps

    out["masked"] = {}
    for clients in MASKED:
        msgs = {k: torch.as_tensor(v)
                for k, v in masked_inputs(clients).items()}
        s_loc = -(-clients // mesh.size)
        pad = s_loc * mesh.size - clients
        if pad:
            msgs = tree.map(lambda v: torch.cat(
                [v, v.new_zeros((pad,) + v.shape[1:])]), msgs)
        lo = mesh.rank * s_loc
        part = ops.secure_quant_sum(
            tree.map(lambda v: v[lo:lo + s_loc], msgs), KEY, scale_bits=20,
            client_offset=lo, num_clients=clients + pad, device="cpu")
        out["masked"][clients] = {k: v.numpy()
                                  for k, v in mesh.psum(part).items()}

    pop = torch.as_tensor(rows_population())
    plan = arena_mod.make_plan(pop.shape[0], mesh)
    local = {"r": arena_mod.home_rows(plan, pop, mesh.rank)}
    cids = torch.as_tensor(COHORT)
    out["gather"] = arena_mod.gather_rows(plan, local, cids, mesh.rank,
                                          mesh.psum)["r"].numpy()
    # each rank's cohort slots [rank·S_loc, (rank + 1)·S_loc) of new rows
    new = -pop.flip(0)[:len(COHORT)]
    s_loc = len(COHORT) // mesh.size
    lo = mesh.rank * s_loc
    rows = arena_mod.replicate_rows({"r": new[lo:lo + s_loc]}, len(COHORT),
                                    lo, mesh.psum)
    out["replicate"] = rows["r"].numpy()
    arena_mod.scatter_rows(plan, local, rows, cids, cids < pop.shape[0],
                           mesh.rank)
    every = torch.arange(pop.shape[0])
    out["after_scatter"] = arena_mod.gather_rows(
        plan, local, every, mesh.rank, mesh.psum)["r"].numpy()
    return out


def ring_inputs(rank: int) -> dict:
    """A rank's share of the reference's mixed tree
    (``tests/pipeline_engine_check.py::check_ring_psum``): int32 of
    length 37·13 + 3 over the full range, f32, and a small int32 leaf."""
    rng = np.random.default_rng(200 + rank)
    return {"a": rng.integers(-2 ** 31, 2 ** 31, (37, 13)).astype(np.int32),
            "b": rng.standard_normal(5).astype(np.float32),
            "d": rng.integers(-100, 100, 3).astype(np.int32)}


# 484 int32 elements: even over 4 pieces, uneven over 3 and 7
RING_CHUNKS = (4, 3, 7)


def ring_checks(mesh) -> dict:
    """``ring_psum_chunked`` beside ``psum`` on the mixed tree, at each
    chunk count, with the counts each made."""
    x = {k: torch.as_tensor(v) for k, v in ring_inputs(mesh.rank).items()}
    mesh.psum_calls = mesh.ring_calls = mesh.ring_bytes = 0
    out = {"psum": {k: v.numpy() for k, v in mesh.psum(x).items()},
           "ring": {}}
    for chunks in RING_CHUNKS:
        mesh.psum_calls = mesh.ring_calls = mesh.ring_bytes = 0
        got = mesh.ring_psum_chunked(x, chunks=chunks)
        out["ring"][chunks] = {
            "sum": {k: v.numpy() for k, v in got.items()},
            "counts": (mesh.ring_calls, mesh.psum_calls, mesh.ring_bytes,
                       mesh.ring_staged_bytes)}
    return out
