"""The client-sharded rounds of the port on a ``torch.distributed``
group, synchronous, async and pipelined: two gloo ranks on the CPU (and
two cases on three), against the port's own ``mesh=None`` run and, for
five cases, a live JAX run of the reference.

One two-rank world runs every mesh case (``torch_mesh_cases.py``, a
module that imports nothing of JAX or of the reference package; the
ranks report the modules they loaded), a three-rank world the secure
cohort of 10 padded to 12, sync and async, and both worlds the chunked
ring's checks; the test process computes the ``mesh=None`` references
and the JAX runs meanwhile.  Configurations: the reference's
``tests/sharded_engine_check.py``, ``tests/task_mesh_check.py``,
``tests/async_engine_check.py`` (its trace: ``StalenessConfig(2,
delay_probs=(0.5, 0.2, 0.15, 0.1, 0.05))``), ``tests/pipeline_engine_
check.py`` and ``tests/sharded_arena_check.py``'s async cases.

Held, with the reference's bounds where it states them:

* the twelve cases of ``sharded_engine_check.py``, and Algorithm 2
  (plain: the (value, gradient) upload on the linear fast path; secure)
  and FedSGD secure: trajectory gap < 5e-5, accuracy gap < 2e-3 (and
  Algorithm 2's slack within 5e-5), the eval rounds, ``comm`` and the
  ledger equal; every case under secure aggregation (alone, with top-k,
  over a padded cohort, sketched, Algorithm 2's masked (value,
  gradient), FedSGD) equal in its final weights bit for bit;
* the sketched secure wire at full participation bit for bit; identity
  on the mesh bit for bit no compressor; I = 7 on two ranks;
* the reduced dense LM and RWKV-6, secure with ``qsgd(8)``: every metric
  bit for bit, the ledger equal;
* ``arena="sharded"`` (the default) equal to ``arena="replicated"`` bit
  for bit in the weights and the whole history, on the synchronous cases
  of the reference's ``tests/sharded_arena_check.py`` (plain, top-k +
  secure, the sketch over a padded cohort of 3, FedAvg with top-k) and
  its I = 7 top-k case;
* every rank's weights and history bit for bit every other's; the psum
  calls a round as ``PERF.md`` §4 predicts them;
* alg1/secure, fedavg/topk and alg1/sketch+secure3 on the mesh against
  the reference's ``mesh=None`` at ``test_torch_runtime.py``'s and
  ``test_torch_cohorts.py``'s tolerances: weights rtol 1e-4 / atol 2e-5
  (secure), atol 1e-3 (top-k: where the sides' deltas differ in their
  last bits the threshold can keep another entry), atol 2e-5 (sketch);
  cost rtol 1e-5, accuracy atol 1e-6;
* async and pipelined rounds, bit for bit: the zero trace on the mesh
  is the synchronous mesh run (the seven cases of
  ``async_engine_check.py``); under the nonzero trace every secure case
  whose ranks hold two or more slots is the one-device run, with the
  masked sum's ``alive`` path at both ranks' offsets, and the secure
  cohort of 10 on three ranks (padded by two); the sharded ring (a
  (K + 1, ⌈n/D⌉) int32 block a rank) is the replicated one; pipelined
  rounds are the async run at τ ≡ 1 (``pipeline_engine_check.py``'s
  flat cases, a replicated arena and a cohort of 5 padded to 6);
  ``ClientMesh.ring_psum_chunked`` is the psum on the reference's mixed
  tree at 4, 3 and 7 pieces, on two and three ranks;
* async and pipelined rounds within the bounds above elsewhere, with
  ``comm["async"]`` / ``comm["pipeline"]`` equal to one device's, the
  psums and ring calls a round as ``PERF.md`` §4 predicts; Algorithm 2
  and FedSGD in the round modes; alg1/secure and fedavg/topk async
  against the reference's async ``mesh=None`` at
  ``test_torch_async_runtime.py``'s tolerances; the small population's
  three modes (the mesh once refused them) against ``mesh=None``.

The test process computes its references on one intra-op thread, as
the ranks run: another thread count can change a CPU product's last
bits.  Measured on the CPU (largest gap between the mesh and
``mesh=None``):
float-summed paths 0 to 4.8e-7 in cost, the secure ones 0 (bit for
bit); fedavg/topk's weights 2.8e-4 (a top-k threshold moved by the
psum's reassociation), within the 1e-3 above against JAX.  Async and
pipelined: cost 0 to 2.4e-7, weights 0 to 7.5e-8.
"""
import jax
import numpy as np
import pytest
import torch

from repro.data import partition as jpart
from repro.data import synthetic
from repro.fed import aggregation as jagg
from repro.fed import compression as jcomp
from repro.fed import runtime as jrt
from repro.fed import sketch as jsketch
from repro.fed.staleness import StalenessConfig as JConfig
from repro.mlpapp import model as jm
import torch_mesh_cases as cases
from repro_torch.fed import aggregation as tagg
from repro_torch.fed import runtime as trt
from repro_torch.launch import ClientMesh, LocalWorld, make_group_mesh

TWO = ([(n, None) for n in cases.ENGINE]
       + [(n, None) for n in ("alg1/sketch+secure", "alg1/identity", "I=7",
                              "I=7/topk")]
       + [(n, None) for n in cases.LM + cases.PAPER]
       + [(n, "replicated") for n in cases.ARENA]
       # the async and pipelined rounds (keyed with their mode)
       + [(n, None, m) for n in cases.ASYNC for m in ("sync", "zero",
                                                      "delay")]
       + [("alg1/topk", None, "delay")]
       + [(n, "replicated", "delay") for n in cases.ASYNC_ARENA]
       + [(n, a, m) for n, a in cases.PIPELINE for m in ("pipeline", "tau1")]
       + [(n, None, m) for n, m in cases.PAPER_MODES]
       + [(n, None, m) for n in cases.SMALL for m in cases.SMALL_MODES])
THREE = [("alg1/secure", None), ("alg1/secure", None, "delay")]
REFERENCE = (cases.ENGINE + ["alg1/sketch+secure", "I=7"] + cases.LM
             + cases.PAPER)
# the port's mesh=None runs of the round modes
REFERENCE_MODES = ([(n, "delay") for n in cases.ASYNC] + cases.PAPER_MODES
                   + [(n, m) for n in cases.SMALL for m in cases.SMALL_MODES])
SECURE = ["alg1/secure", "alg1/topk8+secure", "alg1/secure_sampled3",
          "alg1/sketch+secure3", "alg1/sketch+secure", "alg2/secure",
          "fedsgd/secure"]
# the reference's runs, from the same weights: (entry, keyword arguments,
# weights rtol, weights atol)
JAX = {
    "alg1/secure": ("run_alg1", lambda: {"secure": True}, 1e-4, 2e-5),
    "fedavg/topk": ("run_fedavg", lambda: dict(
        cases.FEDAVG, compressor=jcomp.topk(0.3)), 0.0, 1e-3),
    "alg1/sketch+secure3": ("run_alg1", lambda: {
        "aggregation": jagg.secure(num_sampled=3),
        "compressor": jsketch.sketch(rows=4, cols=512, fraction=0.02,
                                     keep=64)}, 0.0, 2e-5),
}
# the reference's async runs (the nonzero trace), from the same weights,
# at test_torch_async_runtime.py's tolerances
JAX_ASYNC = {
    "alg1/secure": ("run_alg1", lambda: {"secure": True}, 2e-5),
    "fedavg/topk": ("run_fedavg", lambda: dict(
        cases.FEDAVG, compressor=jcomp.topk(0.3)), 1e-3),
}


@pytest.fixture(scope="module")
def p0():
    w = jm.init_params(jax.random.key(3), 784, 128, 10)
    return tuple(np.asarray(x) for x in w)


@pytest.fixture(scope="module")
def world(p0):
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    worlds = [LocalWorld(cases.rank_main, 2, backend="gloo",
                         args=(TWO, p0, False, True), timeout_s=300),
              LocalWorld(cases.rank_main, 3, backend="gloo",
                         args=(THREE, p0, False, True), timeout_s=300)]
    try:
        ref = {n: cases.run_case(n, p0) for n in REFERENCE}
        ref.update({(n, m): cases.run_case(n, p0, mode=m)
                    for n, m in REFERENCE_MODES})
        data = synthetic.classification_dataset(n_train=2000, n_test=500,
                                                seed=0)
        part = jpart.iid(2000, 10, seed=0)
        params = jm.MLPParams(*p0)
        ref_jax = {n: getattr(jrt, entry)(data, part, params=params,
                                          **cases.KW, **make())
                   for n, (entry, make, _, _) in JAX.items()}
        delays = JConfig(max_staleness=2, delay_probs=cases.DELAYS)
        ref_jax.update({
            (n, "delay"): getattr(jrt, entry)(data, part, params=params,
                                              **cases.KW_ASYNC, **make(),
                                              staleness=delays)
            for n, (entry, make, _) in JAX_ASYNC.items()})
        two, three = (w.join() for w in worlds)
    except BaseException:
        for w in worlds:
            w.close()
        raise
    finally:
        torch.set_num_threads(saved)
    return {"two": two, "three": three, "ref": ref, "jax": ref_jax}


def bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def same_params(a, b):
    return len(a) == len(b) and all(np.array_equal(bits(x), bits(y))
                                    for x, y in zip(a, b))


def gaps(got, want):
    cost = np.max(np.abs(np.asarray(got["train_cost"])
                         - np.asarray(want["train_cost"])))
    acc = np.max(np.abs(np.asarray(got["test_accuracy"])
                        - np.asarray(want["test_accuracy"])))
    return float(cost), float(acc)


def test_ranks_load_no_jax_and_agree_bit_for_bit(world):
    for ranks, size in ((world["two"], 2), (world["three"], 3)):
        assert [r["rank"] for r in ranks] == list(range(size))
        for r in ranks:
            assert r["size"] == size and r["backend"] == "gloo"
            assert r["wraps"]                      # gloo's int32 sum wraps
            assert r["foreign"] == [], r["foreign"]
        first = ranks[0]["runs"]
        for r in ranks[1:]:
            assert r["runs"].keys() == first.keys()
            for key, run in r["runs"].items():
                assert same_params(run["params"], first[key]["params"]), key
                assert run["hist"] == first[key]["hist"], key
                assert run["psum_calls"] == first[key]["psum_calls"], key


@pytest.mark.parametrize("name", cases.ENGINE + cases.PAPER)
def test_sharded_engine_tracks_single_device(world, name):
    got = world["two"][0]["runs"][(name, None)]
    want = world["ref"][name]
    assert got["hist"]["rounds"] == want["hist"]["rounds"] == [3, 6]
    assert got["hist"]["comm"] == want["hist"]["comm"]
    for k in ("uplink_bytes_per_round", "downlink_bytes_per_round",
              "cum_uplink_bytes"):
        assert got["hist"][k] == want["hist"][k], k
    cost, acc = gaps(got["hist"], want["hist"])
    assert cost < 5e-5, cost
    assert acc < 2e-3, acc
    slack = np.abs(np.subtract(got["hist"]["slack"], want["hist"]["slack"]))
    assert slack.max() < 5e-5, slack                # Algorithm 2's s^t
    if name in SECURE:
        # every reduction is an int32 ring psum: the aggregate is the
        # one-device aggregate, and so is each round's model
        assert same_params(got["params"], want["params"]), name
    assert got["psum_calls"] \
        == cases.psums_per_round(name) * cases.KW["rounds"]


@pytest.mark.parametrize("name", cases.ARENA)
def test_sharded_arena_equals_replicated(world, name):
    runs = world["two"][0]["runs"]
    sh, rep = runs[(name, None)], runs[(name, "replicated")]
    assert same_params(sh["params"], rep["params"]), name
    assert sh["hist"] == rep["hist"], name
    rounds = sh["hist"]["rounds"][-1]
    assert sh["psum_calls"] == cases.psums_per_round(name) * rounds
    assert rep["psum_calls"] \
        == cases.psums_per_round(name, "replicated") * rounds


def test_sketched_secure_params_bit_for_bit(world):
    got = world["two"][0]["runs"][("alg1/sketch+secure", None)]
    want = world["ref"]["alg1/sketch+secure"]
    assert same_params(got["params"], want["params"])
    assert got["hist"]["metrics"] == want["hist"]["metrics"]
    assert got["psum_calls"] == 5 * cases.KW["rounds"]


def test_identity_on_the_mesh_is_no_compressor(world):
    runs = world["two"][0]["runs"]
    ident, plain = runs[("alg1/identity", None)], runs[("alg1/plain", None)]
    assert same_params(ident["params"], plain["params"])
    assert ident["hist"] == plain["hist"]


def test_odd_population_on_two_ranks(world):
    # I = 7 pads each cohort to 8 with a sentinel slot of weight 0
    got = world["two"][0]["runs"][("I=7", None)]
    want = world["ref"]["I=7"]
    assert got["hist"]["rounds"] == want["hist"]["rounds"] == [2, 4]
    cost, _ = gaps(got["hist"], want["hist"])
    assert cost < 5e-5, cost
    assert got["hist"]["comm"] == want["hist"]["comm"]


@pytest.mark.parametrize("name", cases.LM)
def test_lm_tasks_on_the_mesh(world, name):
    got = world["two"][0]["runs"][(name, None)]
    want = world["ref"][name]
    task = cases.lm_task(name.split("/")[1])
    assert set(want["hist"]["metrics"]) == set(task.metric_names)
    # qsgd's streams are keyed on global client ids and the secure sum
    # is exact in Z_2^32: the mesh's trajectory is the one-device one
    assert got["hist"]["metrics"] == want["hist"]["metrics"]
    assert same_params(got["params"], want["params"])
    assert got["hist"]["uplink_bytes_per_round"] \
        == want["hist"]["uplink_bytes_per_round"] > 0
    assert np.isfinite(want["hist"]["metrics"]["train_cost"]).all()


def test_three_ranks_pad_the_cohort_by_two(world):
    # S = 10 on 3 ranks: 12 positions, two sentinel slots on rank 2
    got = world["three"][0]["runs"][("alg1/secure", None)]
    want = world["ref"]["alg1/secure"]
    assert same_params(got["params"], want["params"])
    assert got["hist"] == want["hist"]
    assert got["psum_calls"] == 2 * cases.KW["rounds"]


@pytest.mark.parametrize("name", list(JAX))
def test_mesh_tracks_the_reference(world, name):
    _, _, rtol, atol = JAX[name]
    got = world["two"][0]["runs"][(name, None)]
    pj, hj = world["jax"][name]
    assert got["hist"]["rounds"] == hj.rounds
    assert got["hist"]["comm"] == hj.comm
    for g, w in zip(got["params"], pj):
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol)
    np.testing.assert_allclose(got["hist"]["train_cost"], hj.train_cost,
                               rtol=1e-5)
    np.testing.assert_allclose(got["hist"]["test_accuracy"],
                               hj.test_accuracy, atol=1e-6)


# ---------------------------------------------------------------------------
# async and pipelined rounds on the mesh
# ---------------------------------------------------------------------------

ROUNDS = cases.KW_ASYNC["rounds"]
# secure cases whose ranks hold two or more slots: bit for bit mesh=None
ASYNC_BITWISE = ["alg1/secure", "alg1/topk8+secure"]
# the masked sum's launches on rank r of D: (S_loc, offset, S_pad)
SHARD = {(name, d): [(-(-s // d), r * -(-s // d), -(-s // d) * d)
                     for r in range(d)]
         for name, s in (("alg1/secure", 10), ("alg1/topk8+secure", 10),
                         ("alg1/sketch0+secure", 10),
                         ("alg1/secure_sampled5", 5)) for d in (2, 3)}


def collectives(run, name, arena, mode, ranks=2):
    psums, rings = cases.collectives_per_round(
        name, arena or "sharded", mode, ranks)
    assert run["psum_calls"] == psums * ROUNDS, (name, arena, mode)
    assert run["ring_calls"] == rings * ROUNDS, (name, arena, mode)
    assert run["ring_staged_bytes"] == 0


@pytest.mark.parametrize("name", cases.ASYNC)
def test_zero_trace_on_the_mesh_is_sync(world, name):
    runs = world["two"][0]["runs"]
    zero, sync = runs[(name, None, "zero")], runs[(name, None, "sync")]
    assert same_params(zero["params"], sync["params"]), name
    comm = dict(zero["hist"]["comm"])
    assert comm.pop("async")["dropped_total"] == 0
    assert dict(zero["hist"], comm=comm) == sync["hist"]
    assert zero["hist"]["rounds"] == [2, 4, 6]
    collectives(zero, name, None, "zero")
    collectives(sync, name, None, "sync")


@pytest.mark.parametrize("name", cases.ASYNC)
def test_async_mesh_tracks_single_device(world, name):
    got = [r["runs"][(name, None, "delay")] for r in world["two"]]
    want = world["ref"][(name, "delay")]
    assert got[0]["hist"]["comm"] == want["hist"]["comm"]
    dropped = want["hist"]["comm"]["async"]["dropped_total"]
    assert dropped > 0
    cost, acc = gaps(got[0]["hist"], want["hist"])
    assert cost < 5e-5, cost
    assert acc < 2e-3, acc
    if name in ASYNC_BITWISE:
        assert same_params(got[0]["params"], want["params"]), name
        assert got[0]["hist"] == want["hist"], name
        # the masked sum's alive path at each rank's offset: every launch
        # at its shard, the dropped slots over the cohort counted once a
        # round on every rank
        for r, run in enumerate(got):
            shard = SHARD[(name, 2)][r]
            assert [m[:3] for m in run["masked"]] == [shard] * ROUNDS
            assert sum(m[3] for m in run["masked"]) == dropped
    else:
        assert all(r["masked"] == [] for r in got)
    collectives(got[0], name, None, "delay")


@pytest.mark.parametrize("name,mode", cases.PAPER_MODES,
                         ids=[f"{n}-{m}" for n, m in cases.PAPER_MODES])
def test_paper_algorithms_in_the_round_modes_on_the_mesh(world, name, mode):
    # Algorithm 2's (value, gradient) upload async, plain (the bucketed
    # super-batch) and masked; FedSGD pipelined through the chunked ring
    got = world["two"][0]["runs"][(name, None, mode)]
    want = world["ref"][(name, mode)]
    assert got["hist"]["comm"] == want["hist"]["comm"]
    cost, acc = gaps(got["hist"], want["hist"])
    assert cost < 5e-5, cost
    assert acc < 2e-3, acc
    slack = np.abs(np.subtract(got["hist"]["slack"], want["hist"]["slack"]))
    assert slack.max() < 5e-5, slack
    if "secure" in name:
        assert same_params(got["params"], want["params"]), name
        assert got["hist"] == want["hist"], name
    collectives(got, name, None, mode)


@pytest.mark.parametrize("name", cases.ASYNC_ARENA)
def test_sharded_ring_equals_replicated(world, name):
    runs = world["two"][0]["runs"]
    sh, rep = runs[(name, None, "delay")], runs[(name, "replicated",
                                                  "delay")]
    assert same_params(sh["params"], rep["params"]), name
    assert sh["hist"] == rep["hist"], name
    # each rank carries its (K + 1, ⌈n/D⌉) int32 column block of the ring
    n = sum(x.size for x in sh["params"])
    for r in world["two"]:
        assert r["runs"][(name, None, "delay")]["blocks"] \
            == [((3, -(-n // 2)), "torch.int32")]
        assert r["runs"][(name, "replicated", "delay")]["blocks"] == []
    collectives(sh, name, None, "delay")
    collectives(rep, name, "replicated", "delay")
    # the trace bit: async is not the synchronous run
    if name == "alg1/plain":
        sync = runs[(name, None, "sync")]
        assert sh["hist"]["metrics"] != sync["hist"]["metrics"]


@pytest.mark.parametrize("name,arena", cases.PIPELINE,
                         ids=[f"{n}-{a or 'sharded'}"
                              for n, a in cases.PIPELINE])
def test_pipeline_is_async_tau1_on_the_mesh(world, name, arena):
    for r in world["two"]:
        pipe = r["runs"][(name, arena, "pipeline")]
        tau1 = r["runs"][(name, arena, "tau1")]
        assert same_params(pipe["params"], tau1["params"]), name
        assert pipe["hist"]["metrics"] == tau1["hist"]["metrics"], name
        comm = dict(pipe["hist"]["comm"])
        assert comm.pop("pipeline") == {"enabled": True, "depth": 1,
                                        "extra_snapshot_slots": 1}
        assert comm == {k: v for k, v in tau1["hist"]["comm"].items()
                        if k != "async"}
        collectives(pipe, name, arena, "pipeline")
        collectives(tau1, name, arena, "tau1")
        if (name, 2) in SHARD:
            shard = SHARD[(name, 2)][r["rank"]]
            per = 2 if "sketch" in name else 1
            # no alive on the pipelined launches; the τ ≡ 1 run's alive
            # drops nothing
            assert pipe["masked"] == [shard + (None,)] * (per * ROUNDS)
            assert tau1["masked"] == [shard + (0,)] * (per * ROUNDS)
            # the ring carries the int32 partial: the model's elements,
            # the sketch's 4 x 512 buckets in its phase 1
            elems = 4 * 512 if "sketch" in name \
                else sum(x.size for x in pipe["params"])
            assert pipe["ring_bytes"] == 4 * elems * ROUNDS


@pytest.mark.parametrize("ranks", ["two", "three"])
def test_ring_psum_chunked_is_psum(world, ranks):
    size = len(world[ranks])
    ins = [cases.ring_inputs(r) for r in range(size)]
    ints = {k: sum(i[k].astype(np.int64) for i in ins) for k in ("a", "d")}
    ints = {k: ((v + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)
            for k, v in ints.items()}
    n = ins[0]["a"].size + ins[0]["d"].size
    for r in world[ranks]:
        chk = r["ring"]
        for k, want in ints.items():
            np.testing.assert_array_equal(chk["psum"][k], want)
        for chunks, got in chk["ring"].items():
            for k in ("a", "b", "d"):
                assert np.array_equal(bits(got["sum"][k]),
                                      bits(chk["psum"][k])), (chunks, k)
            # one ring call; the f32 leaf through one psum; each rank
            # sends every int32 element D − 1 times, nothing staged
            assert got["counts"] == (1, 1, 4 * n * (size - 1), 0), chunks


def test_three_ranks_pad_the_async_cohort_by_two(world):
    want = world["ref"][("alg1/secure", "delay")]
    for r in world["three"]:
        got = r["runs"][("alg1/secure", None, "delay")]
        assert same_params(got["params"], want["params"])
        assert got["hist"] == want["hist"]
        shard = SHARD[("alg1/secure", 3)][r["rank"]]
        assert [m[:3] for m in got["masked"]] == [shard] * ROUNDS
        collectives(got, "alg1/secure", None, "delay", ranks=3)


@pytest.mark.parametrize("name", list(JAX_ASYNC))
def test_async_mesh_tracks_the_reference(world, name):
    _, _, atol = JAX_ASYNC[name]
    got = world["two"][0]["runs"][(name, None, "delay")]
    pj, hj = world["jax"][(name, "delay")]
    assert got["hist"]["rounds"] == hj.rounds
    assert got["hist"]["comm"] == hj.comm
    for g, w in zip(got["params"], pj):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=atol)
    np.testing.assert_allclose(got["hist"]["train_cost"], hj.train_cost,
                               rtol=1e-5)
    np.testing.assert_allclose(got["hist"]["test_accuracy"],
                               hj.test_accuracy, atol=1e-6)


# ---------------------------------------------------------------------------
# what the mesh refuses, checked before any collective
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_mesh():
    """A client mesh of two ranks with no process group behind it: every
    refusal below raises before the first collective."""
    return ClientMesh(group=None, rank=0, size=2, backend="gloo",
                      device=torch.device("cpu"))


@pytest.fixture(scope="module")
def small():
    data = synthetic.classification_dataset(n_train=40, n_test=10, k=16,
                                            l=3, seed=0)
    return data, jpart.iid(40, 4, seed=0)


@pytest.mark.parametrize("mode", cases.SMALL_MODES)
@pytest.mark.parametrize("entry", ["run_alg1", "run_fedavg"])
def test_mesh_refuses_the_async_modes(world, mode, entry):
    """Named for the refusal it held while the mesh ran synchronous
    rounds only: each mode (a drawn trace, a given one, pipelined rounds)
    of each entry now runs on two ranks (the small population, S_loc =
    2) and tracks its mesh=None run."""
    name = {"run_alg1": "small/alg1", "run_fedavg": "small/fedavg"}[entry]
    got = world["two"][0]["runs"][(name, None, mode)]
    want = world["ref"][(name, mode)]
    assert got["hist"]["rounds"] == want["hist"]["rounds"] == [1, 2, 3]
    assert got["hist"]["comm"] == want["hist"]["comm"]
    assert ("pipeline" if mode == "pipeline" else "async") \
        in got["hist"]["comm"]
    cost, acc = gaps(got["hist"], want["hist"])
    assert cost < 5e-5, cost
    assert acc < 2e-3, acc


def test_mesh_refuses_the_tree(small, fake_mesh):
    data, part = small
    with pytest.raises(ValueError, match="groups, clients"):
        trt.run_alg1(data, part, batch_size=5, rounds=1, hidden=4,
                     mesh=fake_mesh,
                     aggregation=tagg.hierarchical(tagg.secure(), 2))


def test_mesh_refuses_other_meshes_and_devices(small, fake_mesh):
    data, part = small
    with pytest.raises(NotImplementedError, match="mesh"):
        trt.run_alg1(data, part, batch_size=5, rounds=1, hidden=4,
                     mesh=object(), device="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        make_group_mesh(2, 1, device="cpu")
    with pytest.raises(ValueError, match="runs on cpu"):
        trt.run_alg1(data, part, batch_size=5, rounds=1, hidden=4,
                     mesh=fake_mesh, device="cuda")
    with pytest.raises(ValueError, match="arena"):
        trt.run_alg1(data, part, batch_size=5, rounds=1, hidden=4,
                     mesh=fake_mesh, arena="home")


def test_upload_bits_do_not_depend_on_the_slot_batch():
    # a rank uploads its S_loc slots under one vmap where mesh=None
    # batches all S: the slots' bits agree for batches of two or more;
    # one slot alone differs in last bits (ROADMAP queue 3), so the bit
    # for bit cases above keep S_loc >= 2 or S = 1 on both sides
    from torch.func import vmap
    from repro_torch.core import protocol, ssca
    from repro_torch.core.schedules import paper_schedules
    from repro_torch.fed.tasks.base import SumLoss
    from repro_torch.fed.tasks.mlp import MLPTask
    from repro_torch.mlpapp import model as tmodel
    task = MLPTask(k=784, hidden=128, l=10)
    rho, gamma = paper_schedules(10)
    alg = protocol.SSCAUnconstrained(
        loss_fn=SumLoss(task),
        hp=ssca.SSCAHyperParams(tau=0.1, lam=1e-5, rho=rho, gamma=gamma))
    w = jm.init_params(jax.random.key(3), 784, 128, 10)
    params = tmodel.params_from_numpy(w, "cpu")
    state = alg.init_state(params)
    data = synthetic.classification_dataset(n_train=2000, n_test=10, seed=0)
    rng = np.random.default_rng(0)
    idx = torch.as_tensor(rng.integers(0, 2000, (10, 10)))
    batch = (torch.as_tensor(data.x_train)[idx],
             torch.as_tensor(data.y_train)[idx],
             torch.as_tensor(rng.random((10, 1)), dtype=torch.float32)
             .expand(10, 10))

    def upload(lo, hi):
        return vmap(lambda b: alg.client_upload(params, state, b))(
            tuple(x[lo:hi] for x in batch))

    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        whole = upload(0, 10)
        for lo, hi in ((0, 5), (5, 10), (0, 2), (2, 4), (6, 9)):
            part = upload(lo, hi)
            for k in whole:
                assert torch.equal(part[k], whole[k][lo:hi]), (lo, hi, k)
        for lo in (0, 3):
            one = upload(lo, lo + 1)
            for k in whole:
                gap = float((one[k] - whole[k][lo:lo + 1]).abs().max())
                assert gap <= 1e-6, (lo, k, gap)
    finally:
        torch.set_num_threads(saved)
