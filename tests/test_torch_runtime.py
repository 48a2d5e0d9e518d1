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
"""
import jax
import numpy as np
import pytest

from repro.data import partition as jpart
from repro.data import synthetic
from repro.fed import runtime as jrt
from repro.mlpapp import model as jm
from repro_torch.fed import aggregation
from repro_torch.fed import runtime as trt
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


@pytest.mark.parametrize("kwarg", ["compressor", "mesh", "staleness",
                                   "staleness_trace", "arena", "pipeline",
                                   "profile_dir"])
def test_unported_options_raise(setup, kwarg):
    data, part, _ = setup
    with pytest.raises(NotImplementedError, match=kwarg):
        trt.run_alg1(data, part, device="cpu", **KW, **{kwarg: True})


@pytest.mark.parametrize("kw,exc", [({"num_sampled": 4}, NotImplementedError),
                                    ({"streaming": False}, NotImplementedError),
                                    ({"scale_bits": 31}, ValueError),
                                    ({"scale_bits": True}, ValueError)])
def test_secure_aggregation_options(kw, exc):
    with pytest.raises(exc):
        aggregation.secure(**kw)
