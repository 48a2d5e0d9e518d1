"""Async (bounded-staleness, dropout-tolerant) rounds on the port track
live JAX runs of the reference's ``repro.fed.runtime``.

Configuration (``tests/test_async.py``'s ``small_setup``): 400 synthetic
MNIST-shaped samples over I = 8 iid clients, B = 5, T = 4, hidden 16,
seed 2, eval every 2 rounds on 100 samples, both sides from the
reference's initial weights, with ``StalenessConfig(max_staleness=1,
delay_probs=[0.4, 0.3, 0.2, 0.1])``: delays 2 and 3 are dropouts (11 of
the 32 slots), 19 slots stale.  Cases: Algorithm 1 plain (the bucketed
super-batch), secure, secure + ``topk(0.2, bits=8)``, FedAvg (E = 2) +
``topk(0.3)`` (the per-slot delta bases), FedAvg secure + the
count-sketch (the base shift) and Algorithm 1 secure + the sketch.

Exact: the trace, ``History.comm`` with its ``"async"`` entry field for
field, and the eval rounds.  Within tolerance, measured on the CPU
(largest difference seen, tolerance):

* final weights: Algorithm 1 plain 3.7e-8 (atol 5e-7); secure 2.7e-6,
  FedAvg secure with the sketch 9.5e-7, Algorithm 1 secure with the
  sketch 1.9e-6, where a gradient entry lands on the other side of a
  2^-20 grid rounding (atol 2e-5); with top-k 3.0e-8 (atol 1e-3,
  ``test_torch_runtime.py``'s reason: a level can round the other way);
* train cost 2.1e-7 relative (rtol 1e-5); test accuracy 3.0e-8 (atol
  1e-6).

Inside the port, bit for bit: the all-zero trace equals the synchronous
run for the seven configurations of ``tests/async_engine_check.py``
(2000 samples over 10 clients, B = 10, T = 6, seed 3); the explicit
trace's validation errors are the reference's; and in an async secure
round with dropouts the masked sum through ``alive`` equals the plain
sum of the survivors' quantized messages.

The port runs on one intra-op thread (``one_torch_thread``, as in
``test_torch_algorithms_runtime.py``).
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
from repro_torch import tree
from repro_torch.data import partition as tpart
from repro_torch.fed import aggregation as tagg
from repro_torch.fed import compression as tcomp
from repro_torch.fed import runtime as trt
from repro_torch.fed import sketch as tsketch
from repro_torch.fed.staleness import StalenessConfig
from repro_torch.kernels import secure_agg
from repro_torch.mlpapp import model as tm

KW = dict(batch_size=5, rounds=4, eval_every=2, eval_samples=100, seed=2,
          hidden=16)
PROBS = [0.4, 0.3, 0.2, 0.1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def small_setup():
    data = synthetic.classification_dataset(n_train=400, n_test=100, seed=0)
    part = jpart.iid(400, 8, seed=0)
    p0 = jm.init_params(jax.random.key(2), 784, 16, 10)
    return data, part, p0


def _sketch(m):
    return m.sketch(rows=4, cols=512, fraction=0.015, keep=64)


CASES = [
    ("alg1_plain", "run_alg1", lambda a, c: {}, 5e-7),
    ("alg1_secure", "run_alg1", lambda a, c: dict(aggregation=a.secure()),
     2e-5),
    ("alg1_topk8_secure", "run_alg1",
     lambda a, c: dict(aggregation=a.secure(),
                       compressor=c.topk(0.2, bits=8)), 1e-3),
    ("fedavg2_topk", "run_fedavg",
     lambda a, c: dict(local_steps=2, lr_a=2.0, compressor=c.topk(0.3)),
     1e-3),
    ("fedavg2_sketch_secure", "run_fedavg",
     lambda a, c: dict(local_steps=2, lr_a=2.0, aggregation=a.secure(),
                       compressor=_sketch(c)), 2e-5),
    ("alg1_sketch_secure", "run_alg1",
     lambda a, c: dict(aggregation=a.secure(), compressor=_sketch(c)),
     2e-5),
]


@pytest.mark.parametrize("name,fn,make,atol", CASES,
                         ids=[c[0] for c in CASES])
def test_async_runs_track_jax(small_setup, name, fn, make, atol):
    data, part, p0 = small_setup
    jsk = jsketch if "sketch" in name else jcomp
    tsk = tsketch if "sketch" in name else tcomp
    pj, hj = getattr(jrt, fn)(
        data, part, params=p0, **KW, **make(jagg, jsk),
        staleness=JConfig(max_staleness=1, delay_probs=PROBS))
    pt, ht = getattr(trt, fn)(
        data, part, params=tm.params_from_numpy(p0, "cpu"), device="cpu",
        **KW, **make(tagg, tsk),
        staleness=StalenessConfig(max_staleness=1, delay_probs=PROBS))
    assert ht.rounds == hj.rounds == [2, 4]
    assert ht.comm == hj.comm
    a = ht.comm["async"]
    assert a["dropped_total"] == 11 and a["max_staleness"] == 1
    assert a["recovery_bytes_per_drop"] == (4 * 7 if "secure" in name
                                            else 0)
    np.testing.assert_allclose(ht.train_cost, hj.train_cost, rtol=1e-5)
    np.testing.assert_allclose(ht.test_accuracy, hj.test_accuracy,
                               atol=1e-6)
    for got, want in zip(tm.params_to_numpy(pt), pj):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


SYNC_KW = dict(batch_size=10, rounds=6, eval_every=2, eval_samples=300,
               seed=3)

# the seven configurations of tests/async_engine_check.py
ZERO_TRACE = [
    ("alg1/plain", "run_alg1", lambda: {}),
    ("alg1/secure", "run_alg1", lambda: {"secure": True}),
    ("alg1/sampled4", "run_alg1",
     lambda: {"aggregation": tagg.sampled(4)}),
    ("alg1/qsgd8", "run_alg1", lambda: {"compressor": tcomp.qsgd(8)}),
    ("alg1/topk2_8b_secure", "run_alg1",
     lambda: {"compressor": tcomp.topk(0.2, bits=8), "secure": True}),
    ("fedavg2/plain", "run_fedavg", lambda: {"local_steps": 2, "lr_a": 2.0}),
    ("fedavg2/topk3", "run_fedavg",
     lambda: {"local_steps": 2, "lr_a": 2.0,
              "compressor": tcomp.topk(0.3)}),
]


@pytest.fixture(scope="module")
def sync_setup():
    data = synthetic.classification_dataset(n_train=2000, n_test=500, seed=0)
    return data, tpart.iid(2000, 10, seed=0)


@pytest.mark.parametrize("name,fn,extra", ZERO_TRACE,
                         ids=[c[0] for c in ZERO_TRACE])
def test_zero_trace_is_sync_bitwise(sync_setup, name, fn, extra):
    data, part = sync_setup
    run = getattr(trt, fn)
    ps, hs = run(data, part, device="cpu", **SYNC_KW, **extra())
    pa, ha = run(data, part, device="cpu", **SYNC_KW, **extra(),
                 staleness=StalenessConfig(max_staleness=2))
    for a, b in zip(tree.leaves(ps), tree.leaves(pa)):
        assert torch.equal(a, b)
    assert ha.train_cost == hs.train_cost
    assert ha.test_accuracy == hs.test_accuracy
    assert ha.comm["async"]["dropped_total"] == 0
    assert {k: v for k, v in ha.comm.items() if k != "async"} == hs.comm


def test_explicit_trace_and_validation(small_setup):
    data, part, _ = small_setup
    kw = dict(KW, device="cpu")
    tr = np.zeros((4, 8), np.int64)
    tr[1, 3] = 1
    cfg = StalenessConfig(max_staleness=1)
    _, h = trt.run_alg1(data, part, **kw, staleness=cfg, staleness_trace=tr)
    assert all(np.isfinite(h.train_cost))
    assert h.comm["async"]["stale_fraction"] == 1 / 32
    _, hs = trt.run_alg1(data, part, **kw)
    assert h.train_cost != hs.train_cost         # the stale slot moved it
    with pytest.raises(ValueError, match="staleness_trace requires"):
        trt.run_alg1(data, part, **kw, staleness_trace=tr)
    with pytest.raises(ValueError, match="shape"):
        trt.run_alg1(data, part, **kw, staleness=cfg,
                     staleness_trace=np.zeros((2, 8), np.int64))
    with pytest.raises(ValueError, match=">= 0"):
        trt.run_alg1(data, part, **kw, staleness=cfg,
                     staleness_trace=np.full((4, 8), -1))
    with pytest.raises(TypeError, match="StalenessConfig"):
        trt.run_alg1(data, part, **kw, staleness=JConfig(max_staleness=1))


class _Recording(tagg.SecureAggregation):
    """Secure aggregation that keeps each combine's messages, key, alive
    mask and aggregate for the test to read."""
    calls = []

    def combine_messages(self, wmsgs, key_words, *, alive=None,
                         device=None):
        out = super().combine_messages(wmsgs, key_words, alive=alive,
                                       device=device)
        self.calls.append((wmsgs, key_words, alive, out))
        return out


def test_alive_combine_is_the_survivor_sum(small_setup):
    data, part, _ = small_setup
    _Recording.calls.clear()
    trt.run_alg1(data, part, device="cpu", aggregation=_Recording(), **KW,
                 staleness=StalenessConfig(max_staleness=1,
                                           delay_probs=PROBS))
    calls, _Recording.calls[:] = list(_Recording.calls), []
    assert len(calls) == KW["rounds"]
    assert all(alive is not None and alive.dtype == torch.int32
               for _, _, alive, _ in calls)
    dropped = 0
    for wmsgs, kw, alive, out in calls:
        dropped += int((alive == 0).sum())
        flat = torch.cat([v.reshape(v.shape[0], -1)
                          for v in tree.leaves(wmsgs)], dim=1)
        kd = np.asarray(kw, np.uint32)
        agg = secure_agg.masked_sum_plain(
            flat, int(kd[0]), int(kd[-1]), scale_bits=20,
            num_clients=flat.shape[0], alive=alive)
        survivors = secure_agg.quantize(flat, 20)[alive != 0]
        assert torch.equal(agg, survivors.sum(0, dtype=torch.int32))
        got = torch.cat([v.reshape(-1) for v in tree.leaves(out)])
        assert torch.equal(got, secure_agg.dequantize(agg, 20))
    assert dropped == 11
