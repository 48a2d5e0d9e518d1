"""The port's ``run_alg2``, ``run_fedsgd`` and ``run_fedavg`` track live
JAX runs of the reference from the same weights.

Configuration: ``test_torch_runtime.py``'s ``KW`` — 2000 samples over 10
iid clients, B = 10, T = 6, eval every 2 rounds on 300 samples, seed 3 —
with ``run_alg2(limit_u=0.4)``, ``run_fedsgd(lr_a=2.0)`` and
``run_fedavg(local_steps=2, lr_a=2.0)``, plain and secure, both sides
from the reference's initial weights.

Exact: the eval rounds, every byte field of the ledger and the comm
breakdown (at I = 10: Algorithm 2 plain 4,065,320 uplink bytes a round,
10 × 4 × 101,633; secure 4,065,680; FedSGD / FedAvg plain 4,065,280,
secure 4,065,640; downlink 4,065,280 on every path), and
``History.as_dict()``'s keys.  Within tolerance, measured on the CPU
(largest difference seen, tolerance):

* final weights, plain: Algorithm 2 4.5e-8, FedSGD 1.5e-8, FedAvg 8.9e-8
  absolute (rtol 1e-5, atol 5e-7); secure: 2.7e-6, 3.2e-6 and 9.5e-6,
  where an entry lands on the other side of a 2^-20 grid rounding
  (rtol 1e-4, atol 2e-5);
* train cost 4.6e-7 relative (rtol 1e-5); test accuracy equal up to f32
  representation (atol 1e-6); sparsity 3.4e-5 relative (rtol 1e-4: the
  reference sums its squares in f32 in another order, ``ROADMAP.md``
  queue 3);
* Algorithm 2's slack (about 4.5 at round 2): 2.9e-6 absolute plain,
  3.8e-6 secure, 9.5e-6 secure with ``topk(0.1, bits=8)`` (rtol 1e-5,
  atol 2e-5).

With a compressor (``test_compressed_runs_track_jax``), final weights
(largest absolute difference measured, atol): Algorithm 2 secure +
``topk(0.1, bits=8)`` 3.7e-8; FedAvg ``topk(0.1)`` 1.2e-4 and secure +
``topk(0.1, bits=8)`` 5.9e-4 (1e-3 for all three: where the two sides'
deltas differ in their last bits, the top-k threshold can keep another
entry, and stochastic rounding can round a level the other way,
``test_torch_runtime.py``); FedAvg secure + ``sketch(4, 512, 0.015,
keep=64)`` 9.5e-7 (2e-5).

The port runs on one intra-op thread here (``one_torch_thread``): the
tests share the host with other test processes, where torch's spinning
worker threads slowed this module twentyfold, and one thread fixes the
port's reduction order whatever the host.  The numbers above are
measured so.
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
from repro_torch.mlpapp import model as tm
from test_torch_runtime import check_ported_mode

KW = dict(batch_size=10, rounds=6, eval_every=2, eval_samples=300, seed=3)

# name -> (runtime function, its arguments, uplink bytes a round plain,
# secure)
ALGS = {
    "alg2": ("run_alg2", dict(limit_u=0.4), 4_065_320, 4_065_680),
    "fedsgd": ("run_fedsgd", dict(lr_a=2.0), 4_065_280, 4_065_640),
    "fedavg": ("run_fedavg", dict(local_steps=2, lr_a=2.0), 4_065_280,
               4_065_640),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def setup():
    data = synthetic.classification_dataset(n_train=2000, n_test=500, seed=0)
    part = jpart.iid(2000, 10, seed=0)
    p0 = jm.init_params(jax.random.key(3), 784, 128, 10)
    return data, part, p0


def _runs(setup, name, secure, make=None):
    """(reference params, history), (port params, history)."""
    data, part, p0 = setup
    fn, kw, _, _ = ALGS[name]
    jkw, tkw = dict(kw), dict(kw)
    if secure:
        jkw["aggregation"], tkw["aggregation"] = jagg.secure(), tagg.secure()
    if make is not None:
        jmod, tmod = (jsketch, tsketch) if make is _sketch \
            else (jcomp, tcomp)
        jkw["compressor"], tkw["compressor"] = make(jmod), make(tmod)
    ref = getattr(jrt, fn)(data, part, params=p0, **KW, **jkw)
    port = getattr(trt, fn)(data, part, params=tm.params_from_numpy(p0, "cpu"),
                            device="cpu", **KW, **tkw)
    return ref, port


def _check_history(hj, ht):
    assert ht.rounds == hj.rounds == [2, 4, 6]
    assert ht.comm == hj.comm
    assert (ht.uplink_bytes_per_round, ht.downlink_bytes_per_round,
            ht.cum_uplink_bytes) == (hj.uplink_bytes_per_round,
                                     hj.downlink_bytes_per_round,
                                     hj.cum_uplink_bytes)
    assert sorted(ht.as_dict()) == sorted(hj.as_dict())
    assert sorted(ht.metrics) == sorted(hj.metrics)
    np.testing.assert_allclose(ht.train_cost, hj.train_cost, rtol=1e-5)
    np.testing.assert_allclose(ht.test_accuracy, hj.test_accuracy, atol=1e-6)
    np.testing.assert_allclose(ht.sparsity, hj.sparsity, rtol=1e-4)
    np.testing.assert_allclose(ht.slack, hj.slack, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("secure", [False, True], ids=["plain", "secure"])
@pytest.mark.parametrize("name", list(ALGS))
def test_runs_track_jax(setup, name, secure):
    (pj, hj), (pt, ht) = _runs(setup, name, secure)
    _check_history(hj, ht)
    assert ht.uplink_bytes_per_round == ALGS[name][3 if secure else 2]
    assert ht.downlink_bytes_per_round == 4_065_280
    rtol, atol = (1e-4, 2e-5) if secure else (1e-5, 5e-7)
    for got, want in zip(tm.params_to_numpy(pt), pj):
        np.testing.assert_allclose(got, np.asarray(want), rtol=rtol,
                                   atol=atol)
    if name == "alg2":
        assert all(np.isfinite(ht.slack)) and min(ht.slack) >= 0.0
        assert ht.slack[-1] < ht.slack[0]
    else:
        assert ht.slack == [0.0, 0.0, 0.0]
        assert ht.train_cost[-1] < ht.train_cost[0]


def _sketch(m):
    return m.sketch(rows=4, cols=512, fraction=0.015, keep=64)


COMPRESSED = [
    ("alg2_topk8_secure", "alg2", lambda m: m.topk(0.1, bits=8), True, 1e-3),
    ("fedavg_topk", "fedavg", lambda m: m.topk(0.1), False, 1e-3),
    ("fedavg_topk8_secure", "fedavg", lambda m: m.topk(0.1, bits=8), True,
     1e-3),
    ("fedavg_sketch_secure", "fedavg", _sketch, True, 2e-5),
]


@pytest.mark.parametrize("case,name,make,secure,atol", COMPRESSED,
                         ids=[c[0] for c in COMPRESSED])
def test_compressed_runs_track_jax(setup, case, name, make, secure, atol):
    (pj, hj), (pt, ht) = _runs(setup, name, secure, make)
    _check_history(hj, ht)
    for got, want in zip(tm.params_to_numpy(pt), pj):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("name", list(ALGS))
def test_identity_compressor_is_no_compressor(setup, name):
    data, part, _ = setup
    fn, kw, _, _ = ALGS[name]
    kw = dict(KW, **kw, rounds=2, device="cpu")
    p_a, h_a = getattr(trt, fn)(data, part, **kw)
    p_b, h_b = getattr(trt, fn)(data, part, compressor=tcomp.identity(),
                                **kw)
    for a, b in zip(tm.params_to_numpy(p_a), tm.params_to_numpy(p_b)):
        np.testing.assert_array_equal(a, b)
    assert h_a.comm == h_b.comm and h_a.slack == h_b.slack


def test_secure_alg2_matches_plain_trajectory(setup):
    # the port's secure Algorithm 2 stays on its plain trajectory up to
    # the fixed-point quantization, as the reference's does
    data, part, _ = setup
    kw = dict(KW, **ALGS["alg2"][1], device="cpu")
    _, h_p = trt.run_alg2(data, part, **kw)
    _, h_s = trt.run_alg2(data, part, secure=True, **kw)
    np.testing.assert_allclose(h_s.train_cost, h_p.train_cost, atol=1e-4)
    np.testing.assert_allclose(h_s.slack, h_p.slack, atol=1e-4)
    assert h_s.slack != h_p.slack      # the value was quantized and masked


@pytest.mark.parametrize("fn", ["run_alg2", "run_fedsgd", "run_fedavg"])
@pytest.mark.parametrize("kwarg", ["mesh", "staleness", "staleness_trace",
                                   "arena", "pipeline", "profile_dir"])
def test_unported_options_raise(setup, fn, kwarg, tmp_path):
    # only mesh is still unported.  True is not a StalenessConfig, a trace
    # needs staleness=, and arena=True names no placement (ValueError, as
    # in the reference); pipeline=True and a profile_dir run, and are held
    # as in test_torch_runtime.py
    data, part, _ = setup
    if kwarg in ("pipeline", "profile_dir"):
        check_ported_mode(getattr(trt, fn), data, part, kwarg, tmp_path,
                          **KW)
        return
    exc = {"staleness": TypeError, "staleness_trace": ValueError,
           "arena": ValueError}.get(kwarg, NotImplementedError)
    with pytest.raises(exc, match=kwarg):
        getattr(trt, fn)(data, part, device="cpu", **KW, **{kwarg: True})
