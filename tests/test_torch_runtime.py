"""The port's ``run_alg1`` tracks a live JAX run from the same weights.

Configuration: ``tests/task_bitexact_check.py``'s — 2000 samples over 10
iid clients, B=10, T=6, eval every 2 rounds on 300 samples, seed 3 — in
plain and secure aggregation, fused and unfused server update.  Both
sides start from the reference's initial weights (carried with
``params_from_numpy``).

Exact: the eval rounds and every byte field of the ledger (secure at
I = 10: 4,065,640 uplink bytes per round).  Within tolerance, measured
on the CPU (largest difference seen, tolerance):

* final weights, plain: 5.2e-8 absolute (rtol 1e-5, atol 5e-7);
* final weights, secure: 3.9e-6 absolute, where a gradient entry lands
  on the other side of a 2^-20 grid rounding (rtol 1e-4, atol 2e-5);
* train cost: 2.1e-7 relative (rtol 1e-5); test accuracy: equal up to
  f32 representation (atol 1e-6);
* sparsity ‖ω‖²: 3.4e-5 relative — the reference sums its 101,632
  squares in f32 in another order (rtol 1e-4).

With a compressor (``test_compressed_run_alg1_tracks_jax``) the ledger,
the comm breakdown and the eval rounds are exact, cost, accuracy and
sparsity are held as above, and the final weights within (largest
absolute difference measured, atol):

* ``topk(0.1)`` plain: 3.7e-8 (5e-7); secure: 2.7e-6 (2e-5);
* ``sketch(4, 512, 0.015, keep=64)`` secure: 1.4e-6 (2e-5);
* ``qsgd(8)`` plain: 2.2e-5 (1e-4); ``topk(0.1, bits=8)`` secure:
  2.3e-4 (1e-3).  Stochastic rounding is a step function of its input:
  where the two sides' gradients differ in the last bit, a level can
  round the other way, a difference of one step Δ (about 2^-18 here),
  which the SSCA update then scales and carries.  The reference's step
  adds to it: XLA's CPU ``exp2`` is inexact for these exponents, so its
  Δ is off by up to 2.03e-6 relative (``ROADMAP.md``, queue 3).  With
  the reference's step made exact the two differences are 1.6e-5 and
  5.2e-5.
"""
import jax
import numpy as np
import pytest

from repro.data import partition as jpart
from repro.data import synthetic
from repro.fed import compression as jcomp
from repro.fed import runtime as jrt
from repro.fed import sketch as jsketch
from repro.mlpapp import model as jm
from repro_torch.fed import aggregation
from repro_torch.fed import compression as tcomp
from repro_torch.fed import runtime as trt
from repro_torch.fed import sketch as tsketch
from repro_torch.mlpapp import model as tm

KW = dict(batch_size=10, rounds=6, eval_every=2, eval_samples=300, seed=3)


@pytest.fixture(scope="module")
def setup():
    data = synthetic.classification_dataset(n_train=2000, n_test=500, seed=0)
    part = jpart.iid(2000, 10, seed=0)
    p0 = jm.init_params(jax.random.key(3), 784, 128, 10)
    return data, part, p0


@pytest.mark.parametrize("secure", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_run_alg1_tracks_jax(setup, secure, fused):
    data, part, p0 = setup
    pj, hj = jrt.run_alg1(data, part, params=p0, secure=secure, fused=fused,
                          **KW)
    pt, ht = trt.run_alg1(data, part, params=tm.params_from_numpy(p0, "cpu"),
                          secure=secure, fused=fused, device="cpu", **KW)
    assert ht.rounds == hj.rounds == [2, 4, 6]
    assert ht.uplink_bytes_per_round == hj.uplink_bytes_per_round
    assert ht.downlink_bytes_per_round == hj.downlink_bytes_per_round
    assert ht.cum_uplink_bytes == hj.cum_uplink_bytes
    assert ht.comm == hj.comm
    if secure:
        assert ht.uplink_bytes_per_round == 4_065_640
    rtol, atol = (1e-4, 2e-5) if secure else (1e-5, 5e-7)
    for got, want in zip(tm.params_to_numpy(pt), pj):
        np.testing.assert_allclose(got, np.asarray(want), rtol=rtol,
                                   atol=atol)
    np.testing.assert_allclose(ht.train_cost, hj.train_cost, rtol=1e-5)
    np.testing.assert_allclose(ht.test_accuracy, hj.test_accuracy, atol=1e-6)
    np.testing.assert_allclose(ht.sparsity, hj.sparsity, rtol=1e-4)
    assert ht.train_cost[-1] < ht.train_cost[0]


def test_params_none_initializes_from_seed(setup):
    data, part, _ = setup
    kw = dict(KW, rounds=2)
    p_a, h_a = trt.run_alg1(data, part, device="cpu", **kw)
    p_b, h_b = trt.run_alg1(data, part, device="cpu", **kw)
    for a, b in zip(tm.params_to_numpy(p_a), tm.params_to_numpy(p_b)):
        np.testing.assert_array_equal(a, b)
    assert h_a.train_cost == h_b.train_cost


COMPRESSED = [
    ("qsgd8_plain", lambda m: m.qsgd(8), False, 1e-4),
    ("topk_plain", lambda m: m.topk(0.1), False, 5e-7),
    ("topk_secure", lambda m: m.topk(0.1), True, 2e-5),
    ("topk8_secure", lambda m: m.topk(0.1, bits=8), True, 1e-3),
    ("sketch_secure",
     lambda m: m.sketch(rows=4, cols=512, fraction=0.015, keep=64), True,
     2e-5),
]


@pytest.mark.parametrize("name,make,secure,atol", COMPRESSED,
                         ids=[c[0] for c in COMPRESSED])
def test_compressed_run_alg1_tracks_jax(setup, name, make, secure, atol):
    data, part, p0 = setup
    jmod, tmod = (jsketch, tsketch) if name.startswith("sketch") \
        else (jcomp, tcomp)
    pj, hj = jrt.run_alg1(data, part, params=p0, secure=secure,
                          compressor=make(jmod), **KW)
    pt, ht = trt.run_alg1(data, part, params=tm.params_from_numpy(p0, "cpu"),
                          secure=secure, compressor=make(tmod), device="cpu",
                          **KW)
    assert ht.rounds == hj.rounds == [2, 4, 6]
    assert ht.comm == hj.comm
    assert (ht.uplink_bytes_per_round, ht.downlink_bytes_per_round,
            ht.cum_uplink_bytes) == (hj.uplink_bytes_per_round,
                                     hj.downlink_bytes_per_round,
                                     hj.cum_uplink_bytes)
    for got, want in zip(tm.params_to_numpy(pt), pj):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)
    np.testing.assert_allclose(ht.train_cost, hj.train_cost, rtol=1e-5)
    np.testing.assert_allclose(ht.test_accuracy, hj.test_accuracy, atol=1e-6)
    np.testing.assert_allclose(ht.sparsity, hj.sparsity, rtol=1e-4)
    assert ht.train_cost[-1] < ht.train_cost[0]


def test_secure_qsgd_run_equals_plain_bitwise(setup):
    # qsgd's outputs lie on the secure grid here (per-leaf steps 2^-15 to
    # 2^-18), so the masked sum is the plain sum, exactly
    data, part, _ = setup
    runs = [trt.run_alg1(data, part, compressor=tcomp.qsgd(8), secure=sec,
                         device="cpu", **KW) for sec in (False, True)]
    for a, b in zip(*(tm.params_to_numpy(p) for p, _ in runs)):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    assert runs[0][1].train_cost == runs[1][1].train_cost


def test_identity_compressor_is_no_compressor(setup):
    data, part, _ = setup
    kw = dict(KW, rounds=2)
    p_a, h_a = trt.run_alg1(data, part, device="cpu", **kw)
    p_b, h_b = trt.run_alg1(data, part, compressor=tcomp.identity(),
                            device="cpu", **kw)
    for a, b in zip(tm.params_to_numpy(p_a), tm.params_to_numpy(p_b)):
        np.testing.assert_array_equal(a, b)
    assert h_a.comm == h_b.comm


def test_sketch_scale_bits_mismatch_raises(setup):
    data, part, _ = setup
    with pytest.raises(ValueError, match="scale_bits"):
        trt.run_alg1(data, part, compressor=tsketch.sketch(scale_bits=16),
                     secure=True, device="cpu", **KW)


def check_ported_mode(run, data, part, kwarg, tmp_path, **kw):
    """``pipeline=True`` runs the async mode at the constant τ ≡ 1 trace
    bit for bit, with ``comm["pipeline"]`` and no ``comm["async"]``;
    ``profile_dir`` writes one trace file of the run."""
    from repro_torch.fed.staleness import ConstantDiscount, StalenessConfig
    if kwarg == "pipeline":
        p_p, h_p = run(data, part, device="cpu", pipeline=True, **kw)
        p_a, h_a = run(data, part, device="cpu", staleness=StalenessConfig(
            max_staleness=1, schedule=ConstantDiscount()),
            staleness_trace=np.ones((kw["rounds"], 10), np.int64), **kw)
        for a, b in zip(tm.params_to_numpy(p_p), tm.params_to_numpy(p_a)):
            np.testing.assert_array_equal(a, b)
        assert h_p.metrics == h_a.metrics and h_p.slack == h_a.slack
        assert h_p.comm["pipeline"] == {"enabled": True, "depth": 1,
                                        "extra_snapshot_slots": 1}
        assert "async" not in h_p.comm
        return
    prof = tmp_path / "trace"
    _, h = run(data, part, device="cpu", profile_dir=str(prof), **kw)
    assert np.isfinite(h.train_cost).all()
    assert len([p for p in prof.rglob("*") if p.is_file()]) == 1


@pytest.mark.parametrize("kwarg", ["compressor", "mesh", "staleness",
                                   "staleness_trace", "arena", "pipeline",
                                   "profile_dir"])
def test_unported_options_raise(setup, kwarg, tmp_path):
    # only mesh is still unported.  True is neither a compressor nor a
    # StalenessConfig, a trace needs staleness=, and arena=True names no
    # placement (ValueError, as in the reference); pipeline=True and a
    # profile_dir run, and are held instead
    data, part, _ = setup
    if kwarg in ("pipeline", "profile_dir"):
        check_ported_mode(trt.run_alg1, data, part, kwarg, tmp_path, **KW)
        return
    exc = {"compressor": TypeError, "staleness": TypeError,
           "staleness_trace": ValueError,
           "arena": ValueError}.get(kwarg, NotImplementedError)
    with pytest.raises(exc, match=kwarg):
        trt.run_alg1(data, part, device="cpu", **KW, **{kwarg: True})


# a sampled secure aggregation still refuses the mask-materializing path
@pytest.mark.parametrize("kw,exc", [({"num_sampled": 4, "streaming": False},
                                     NotImplementedError),
                                    ({"streaming": False}, NotImplementedError),
                                    ({"scale_bits": 31}, ValueError),
                                    ({"scale_bits": True}, ValueError)])
def test_secure_aggregation_options(kw, exc):
    with pytest.raises(exc):
        aggregation.secure(**kw)
