"""The port's pipelined rounds, ``profile_dir`` and ``arena`` against the
reference.

Configuration: ``tests/test_pipeline.py``'s (400 samples over I = 8
clients, B = 5, T = 4, hidden 16, eval every 2 rounds on 100 samples,
seed 2), from the reference's initial weights.

``pipeline=True`` is the async mode at the constant τ ≡ 1 trace
(``StalenessConfig(max_staleness=1, schedule=ConstantDiscount())`` and an
all-ones trace), run without an ``alive`` mask.  Inside the port it equals
that async run bit for bit, weights and metric series, on the cases of
``tests/pipeline_engine_check.py``: plain, secure, top-k + secure, the
sketch + secure, FedAvg (E = 2) and the hierarchical tree at G = 2.
``History.comm`` equals the reference's exactly: no ``"async"`` entry,
``"pipeline": {"enabled": True, "depth": 1, "extra_snapshot_slots": 1}``,
the same uplink and downlink.

Against live JAX ``pipeline=True`` runs, final weights within (largest
difference measured on the CPU, tolerance): plain 4.5e-8 (atol 5e-7);
secure and the tree 2.7e-6 (atol 2e-5: a gradient entry on the other side
of a 2^-20 grid rounding); top-k + secure 3.3e-5 (atol 1e-3,
``test_torch_runtime.py``'s reason: a level can round the other way);
FedAvg 3.0e-8 (atol 5e-7).  Train cost 2.1e-7 relative (rtol 1e-5), test
accuracy 1.5e-8 (atol 1e-6).

Also: ``pipeline=True`` with ``staleness=`` raises the reference's
``ValueError``; ``profile_dir`` writes one trace file a run; ``arena`` in
(None, "replicated", "sharded") runs, bit for bit the run without it,
and anything else raises ``ValueError``; ``mesh`` still raises
``NotImplementedError``.
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
from repro_torch.fed import aggregation as tagg
from repro_torch.fed import compression as tcomp
from repro_torch.fed import runtime as trt
from repro_torch.fed import sketch as tsketch
from repro_torch.fed.staleness import ConstantDiscount, StalenessConfig
from repro_torch.kernels import secure_agg
from repro_torch.mlpapp import model as tm

KW = dict(batch_size=5, rounds=4, eval_every=2, eval_samples=100, seed=2,
          hidden=16)
PIPE = {"enabled": True, "depth": 1, "extra_snapshot_slots": 1}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def setup():
    data = synthetic.classification_dataset(n_train=400, n_test=100, seed=0)
    part = jpart.iid(400, 8, seed=0)
    return data, part, jm.init_params(jax.random.key(2), 784, 16, 10)


CASES = [
    ("alg1_plain", "run_alg1", lambda a, c, s: {}),
    ("alg1_secure", "run_alg1",
     lambda a, c, s: dict(aggregation=a.secure())),
    ("alg1_topk2_8b_secure", "run_alg1",
     lambda a, c, s: dict(aggregation=a.secure(),
                          compressor=c.topk(0.2, bits=8))),
    ("alg1_sketch_secure", "run_alg1",
     lambda a, c, s: dict(aggregation=a.secure(), compressor=s.sketch())),
    ("fedavg2_plain", "run_fedavg",
     lambda a, c, s: dict(local_steps=2, lr_a=2.0)),
    ("alg1_hier2", "run_alg1",
     lambda a, c, s: dict(aggregation=a.hierarchical(groups=2))),
]


@pytest.mark.parametrize("name,fn,make", CASES, ids=[c[0] for c in CASES])
def test_pipeline_equals_async_tau1_in_the_port(setup, name, fn, make):
    data, part, _ = setup
    run = getattr(trt, fn)
    alive = secure_agg.masked_sum_2d.launches_by_variant["alive"]
    p_p, h_p = run(data, part, device="cpu", pipeline=True, **KW,
                   **make(tagg, tcomp, tsketch))
    tau1 = StalenessConfig(max_staleness=1, schedule=ConstantDiscount())
    p_a, h_a = run(data, part, device="cpu", **KW,
                   **make(tagg, tcomp, tsketch), staleness=tau1,
                   staleness_trace=np.ones((KW["rounds"], 8), np.int64))
    for a, b in zip(tm.params_to_numpy(p_p), tm.params_to_numpy(p_a)):
        np.testing.assert_array_equal(a, b)
    assert h_p.metrics == h_a.metrics and h_p.rounds == h_a.rounds
    assert h_p.comm["pipeline"] == PIPE and "async" not in h_p.comm
    assert {k: v for k, v in h_p.comm.items() if k != "pipeline"} \
        == {k: v for k, v in h_a.comm.items() if k != "async"}
    # the wrappers count launches only on the card; on the CPU no alive
    # reaches them either way
    assert secure_agg.masked_sum_2d.launches_by_variant["alive"] == alive


JAX_CASES = [
    ("alg1_plain", "run_alg1", lambda a, c, s: {}, 5e-7),
    ("alg1_secure", "run_alg1",
     lambda a, c, s: dict(aggregation=a.secure()), 2e-5),
    ("alg1_topk2_8b_secure", "run_alg1",
     lambda a, c, s: dict(aggregation=a.secure(),
                          compressor=c.topk(0.2, bits=8)), 1e-3),
    ("fedavg2_plain", "run_fedavg",
     lambda a, c, s: dict(local_steps=2, lr_a=2.0), 5e-7),
    ("alg1_hier2", "run_alg1",
     lambda a, c, s: dict(aggregation=a.hierarchical(groups=2)), 2e-5),
]


@pytest.mark.parametrize("name,fn,make,atol", JAX_CASES,
                         ids=[c[0] for c in JAX_CASES])
def test_pipeline_tracks_jax(setup, name, fn, make, atol):
    data, part, p0 = setup
    kw = dict(KW, pipeline=True)
    pj, hj = getattr(jrt, fn)(data, part, params=p0, **kw,
                              **make(jagg, jcomp, jsketch))
    pt, ht = getattr(trt, fn)(data, part,
                              params=tm.params_from_numpy(p0, "cpu"),
                              device="cpu", **kw,
                              **make(tagg, tcomp, tsketch))
    assert ht.rounds == hj.rounds and ht.comm == hj.comm
    assert ht.comm["pipeline"] == PIPE and "async" not in ht.comm
    for a, b in zip(tm.params_to_numpy(pt), jax.tree.leaves(pj)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=atol)
    np.testing.assert_allclose(ht.train_cost, hj.train_cost, rtol=1e-5)
    np.testing.assert_allclose(ht.test_accuracy, hj.test_accuracy,
                               atol=1e-6)


def test_pipeline_refuses_staleness(setup):
    data, part, _ = setup
    cfg = StalenessConfig(max_staleness=1, schedule=ConstantDiscount())
    with pytest.raises(ValueError, match="pipeline=True IS the constant"):
        trt.run_alg1(data, part, device="cpu", pipeline=True, staleness=cfg,
                     **KW)


def test_profile_dir_writes_one_trace_a_run(setup, tmp_path):
    data, part, _ = setup
    prof = tmp_path / "trace"
    for k in (1, 2):
        _, h = trt.run_alg1(data, part, device="cpu", pipeline=True,
                            profile_dir=str(prof), **KW)
        assert np.isfinite(h.train_cost).all()
        assert len([p for p in prof.rglob("*") if p.is_file()]) == k


@pytest.mark.parametrize("arena", ["replicated", "sharded"])
def test_arena_is_validated_and_ignored(setup, arena):
    data, part, _ = setup
    p_a, h_a = trt.run_alg1(data, part, device="cpu", secure=True,
                            arena=arena, **KW)
    p_n, h_n = trt.run_alg1(data, part, device="cpu", secure=True, **KW)
    for a, b in zip(tm.params_to_numpy(p_a), tm.params_to_numpy(p_n)):
        np.testing.assert_array_equal(a, b)
    assert h_a.metrics == h_n.metrics and h_a.comm == h_n.comm


@pytest.mark.parametrize("kw,exc", [({"arena": True}, ValueError),
                                    ({"arena": "home"}, ValueError),
                                    ({"mesh": object()}, NotImplementedError)])
def test_arena_and_mesh_refused(setup, kw, exc):
    data, part, _ = setup
    with pytest.raises(exc, match=next(iter(kw))):
        trt.run_fedavg(data, part, device="cpu", **KW, **kw)
