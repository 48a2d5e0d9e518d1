"""The client-sharded synchronous round of the port on a
``torch.distributed`` group: two gloo ranks on the CPU (and one case on
three), against the port's own ``mesh=None`` run and, for three cases,
a live JAX run of the reference.

One two-rank world runs every mesh case (``torch_mesh_cases.py``, a
module that imports nothing of JAX or of the reference package; the
ranks report the modules they loaded), a three-rank world the secure
cohort of 10 padded to 12, and the test process computes the ``mesh=None``
references and the JAX runs meanwhile.  Configurations: the reference's
``tests/sharded_engine_check.py`` and ``tests/task_mesh_check.py``.

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
  cost rtol 1e-5, accuracy atol 1e-6.

The test process computes its references on one intra-op thread, as
the ranks run: another thread count can change a CPU product's last
bits.  Measured on the CPU (largest gap between the mesh and
``mesh=None``):
float-summed paths 0 to 4.8e-7 in cost, the secure ones 0 (bit for
bit); fedavg/topk's weights 2.8e-4 (a top-k threshold moved by the
psum's reassociation), within the 1e-3 above against JAX.
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
from repro.mlpapp import model as jm
import torch_mesh_cases as cases
from repro_torch.fed import aggregation as tagg
from repro_torch.fed import runtime as trt
from repro_torch.fed.staleness import StalenessConfig
from repro_torch.launch import ClientMesh, LocalWorld, make_group_mesh

TWO = ([(n, None) for n in cases.ENGINE]
       + [(n, None) for n in ("alg1/sketch+secure", "alg1/identity", "I=7",
                              "I=7/topk")]
       + [(n, None) for n in cases.LM + cases.PAPER]
       + [(n, "replicated") for n in cases.ARENA])
THREE = [("alg1/secure", None)]
REFERENCE = (cases.ENGINE + ["alg1/sketch+secure", "I=7"] + cases.LM
             + cases.PAPER)
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


@pytest.fixture(scope="module")
def p0():
    w = jm.init_params(jax.random.key(3), 784, 128, 10)
    return tuple(np.asarray(x) for x in w)


@pytest.fixture(scope="module")
def world(p0):
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    worlds = [LocalWorld(cases.rank_main, 2, backend="gloo",
                         args=(TWO, p0), timeout_s=300),
              LocalWorld(cases.rank_main, 3, backend="gloo",
                         args=(THREE, p0), timeout_s=300)]
    try:
        ref = {n: cases.run_case(n, p0) for n in REFERENCE}
        data = synthetic.classification_dataset(n_train=2000, n_test=500,
                                                seed=0)
        part = jpart.iid(2000, 10, seed=0)
        params = jm.MLPParams(*p0)
        ref_jax = {n: getattr(jrt, entry)(data, part, params=params,
                                          **cases.KW, **make())
                   for n, (entry, make, _, _) in JAX.items()}
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


@pytest.mark.parametrize("kw", [
    {"staleness": StalenessConfig(max_staleness=1)},
    {"staleness_trace": np.zeros((1, 4), np.int64)},
    {"pipeline": True}], ids=["staleness", "staleness_trace", "pipeline"])
@pytest.mark.parametrize("entry", ["run_alg1", "run_fedavg"])
def test_mesh_refuses_the_async_modes(small, fake_mesh, kw, entry):
    data, part = small
    with pytest.raises(NotImplementedError, match="item 4c"):
        getattr(trt, entry)(data, part, batch_size=5, rounds=1, hidden=4,
                            mesh=fake_mesh, **kw)


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
    with pytest.raises(NotImplementedError, match="item 4c"):
        make_group_mesh(2, 1)
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
