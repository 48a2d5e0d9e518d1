"""The client-sharded engine's cases, run by every rank of a local gloo
world (``tests/test_torch_mesh.py``, ``tests/test_torch_arena.py``) and,
without a mesh, by the test process as their reference.

The ranks are spawned processes that must load nothing of JAX or of the
reference package, so this module imports numpy, torch and
``repro_torch`` only.  The configurations are the reference's
``tests/sharded_engine_check.py`` (2000 samples over 10 iid clients, B =
10, 6 rounds, eval every 3 on 300 samples, seed 3; I = 7 with B = 5, 4
rounds), ``tests/sharded_arena_check.py`` and ``tests/task_mesh_check.py``
(the reduced dense LM and RWKV-6, secure with ``qsgd(8)``).  Every MLP
case starts from the weights the caller passes (the reference's initial
weights, carried as numpy arrays).
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
from repro_torch.fed.tasks import rwkv6_task, transformer_task
from repro_torch.kernels import ops
from repro_torch.launch import make_client_mesh
from repro_torch.mlpapp import model as tm

KW = dict(batch_size=10, rounds=6, eval_every=3, eval_samples=300, seed=3)
KW7 = dict(batch_size=5, rounds=4, eval_every=2, eval_samples=200, seed=3)
KW_LM = dict(batch_size=4, rounds=4, eval_every=2, eval_samples=64, seed=3,
             tau=2.0, secure=True)
FEDAVG = dict(local_steps=2, lr_a=2.0)


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


def lm_task(name):
    make = transformer_task if name == "transformer" else rwkv6_task
    return make(seq_len=16, d_model=32, vocab=64)


def setting(population):
    """(data, partition, keyword arguments, task) of a population."""
    if population in ("transformer", "rwkv6"):
        task = lm_task(population)
        return (task.default_data(n_train=128, n_test=32, seed=0),
                partition.iid(128, 4, seed=0), KW_LM, task)
    data = synthetic.classification_dataset(n_train=2000, n_test=500,
                                            seed=0)
    if population == "i7":
        return data, partition.iid(700, 7, seed=0), KW7, None
    return data, partition.iid(2000, 10, seed=0), KW, None


def run_case(name, p0, *, mesh=None, arena=None, **over) -> dict:
    """One case on the CPU: the final weights (numpy, leaf order), the
    history without its wall time, and the mesh's psum counts."""
    entry, population, extra = CASES[name]
    data, part, kw, task = setting(population)
    kw = dict(kw, **extra(), **over)
    if task is None:
        kw["params"] = tm.params_from_numpy(p0, "cpu")
    else:
        kw["task"] = task
    if mesh is not None:
        mesh.psum_calls = mesh.all_reduces = mesh.psum_bytes = 0
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
                   psum_bytes=mesh.psum_bytes)
    return out


def foreign_modules():
    """Modules of JAX or of the reference package loaded in this
    process."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "repro"))


def rank_main(runs, p0, checks: bool = False) -> dict:
    """A rank's entry: on the default group's client mesh, on the CPU,
    the collective's checks (``checks``), then every (case, arena) of
    ``runs``."""
    mesh = make_client_mesh(device="cpu")
    out = {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
           "wraps": mesh.int32_wraps}
    if checks:
        out["checks"] = collective_checks(mesh)
    out["runs"] = {(name, arena): run_case(name, p0, mesh=mesh, arena=arena)
                   for name, arena in runs}
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
