"""Partial participation on the port: cohorts, their weights, ledgers and
runs, against the reference's on the same inputs.

Configuration of the runs (``tests/test_population.py``'s): 320
synthetic samples of 36 features and 4 classes over I = 16 iid clients,
a cohort of S = 4 a round, B = 5, T = 4, hidden 16, seed 5, eval every
2 rounds on 64 samples; both sides from the reference's initial weights.

Exact: ``build_schedule``'s cohorts and batch indices (sum and mean, E =
1 and 2), the sum-combine cohort weights (an exact ·I/S), the ledgers
(``sampled(4)``: 4 participants; ``secure(num_sampled=4)``: 4 × (4n +
4 × 3) uplink bytes), the eval rounds and the comm breakdown of every
run.  Within tolerance, measured on the CPU (largest difference seen,
tolerance):

* mean-combine cohort weights λ_i / Σ_cohort λ: the sum's order may
  differ from XLA's (tolerance 2 ulp; measured: equal);
* final weights: ``sampled(4)`` 3.0e-8, FedAvg ``sampled(4)`` 2.2e-8
  (rtol 1e-5, atol 5e-7); ``secure(num_sampled=4)`` 1.5e-8 (atol 2e-5:
  a gradient entry can land on the other side of a 2^-20 grid
  rounding); with ``qsgd(8)`` 2.2e-8 and ``topk(0.25, bits=8)`` 1.5e-8
  (atol 1e-3: stochastic rounding can round a level the other way,
  ``test_torch_runtime.py``);
* train cost 8.6e-8 relative (rtol 1e-5); test accuracy equal (atol
  1e-6);
* the reduced RWKV-6 with FedSGD and ``sampled(2)``: cost 1.1e-7
  relative (rtol 1e-4), weights 3.7e-8 (atol 5e-5, as
  ``test_torch_rwkv6_runtime.py``).

Inside the port, bit for bit: S = I is full participation (plain,
sampled, secure; sum and mean); the secure cohort run with ``qsgd(8)``
or ``topk(0.25, bits=8)`` equals a masked full-population run, in which
all I clients compute, compress and upload, the I − S outside the cohort
masked to zero and their residuals frozen; and after a sampled top-k
run, the residual arena's rows of clients never drawn are still zero.

The port runs on one intra-op thread (``one_torch_thread``, as in
``test_torch_algorithms_runtime.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import partition as jpart
from repro.data import synthetic
from repro.fed import aggregation as jagg
from repro.fed import compression as jcomp
from repro.fed import engine as jengine
from repro.fed import runtime as jrt
from repro.fed.tasks.rwkv6 import rwkv6_task as jrwkv6_task
from repro.mlpapp import model as jm
from repro_torch import tree
from repro_torch.core import protocol as tprotocol
from repro_torch.core import ssca as tssca
from repro_torch.core.schedules import paper_schedules
from repro_torch.data import partition as tpart
from repro_torch.fed import aggregation as tagg
from repro_torch.fed import compression as tcomp
from repro_torch.fed import engine as tengine
from repro_torch.fed import runtime as trt
from repro_torch.fed.keys import round_keys
from repro_torch.fed.tasks import rwkv6_task
from repro_torch.fed.tasks.base import SumLoss
from repro_torch.fed.tasks.mlp import MLPTask
from repro_torch.kernels.compress import client_stream_seed
from repro_torch.mlpapp import model as tm
from repro_torch.models import transformer as tt

I, S, B, T, HIDDEN, SEED = 16, 4, 5, 4, 16, 5
KW = dict(batch_size=B, rounds=T, eval_every=2, eval_samples=64,
          hidden=HIDDEN, seed=SEED)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def setup():
    data = synthetic.classification_dataset(n_train=320, n_test=64, k=36,
                                            l=4, seed=0)
    part = jpart.iid(320, I, seed=0)
    p0 = jm.init_params(jax.random.key(SEED), 36, HIDDEN, 4)
    return data, part, p0


def _tpart(p):
    return tpart.Partition(p.flat, p.offsets, p.sizes)


@pytest.mark.parametrize("cohort", [None, 1, 4, 6])
@pytest.mark.parametrize("local_steps,e_axis", [(1, False), (1, True),
                                                (2, True)])
def test_build_schedule_matches_reference(cohort, local_steps, e_axis):
    # uneven clients (two below B, so drawn with replacement)
    jp = jpart.dirichlet(np.random.default_rng(4).integers(0, 5, 300), 6,
                         alpha=0.5, seed=4)
    want_c, want_i = jengine.build_schedule(jp, 8, 5, local_steps, seed=7,
                                            e_axis=e_axis, cohort_size=cohort)
    got_c, got_i = tengine.build_schedule(_tpart(jp), 8, 5, local_steps,
                                          seed=7, e_axis=e_axis,
                                          cohort_size=cohort)
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(got_i, np.asarray(want_i))
    s = 6 if cohort is None else cohort
    assert got_c.shape == (5, s)
    assert got_i.shape == ((5, s, local_steps, 8) if e_axis else (5, s, 8))
    if cohort is None:
        np.testing.assert_array_equal(got_c, np.tile(np.arange(6), (5, 1)))


STRATEGIES = [("plain", lambda m: m.plain()),
              ("sampled4", lambda m: m.sampled(4)),
              ("sampled16", lambda m: m.sampled(16)),
              ("secure", lambda m: m.secure()),
              ("secure_sampled4", lambda m: m.secure(num_sampled=4))]


@pytest.mark.parametrize("combine", ["sum", "mean"])
@pytest.mark.parametrize("name,make", STRATEGIES,
                         ids=[s[0] for s in STRATEGIES])
def test_cohort_weights_match_reference(name, make, combine):
    w = np.random.default_rng(1).dirichlet(np.ones(I)).astype(np.float32)
    cohort = jpart.sample_cohorts(I, 4, [3], seed=2)[0]
    wc = w[cohort] if "4" in name else w
    want = np.asarray(make(jagg).cohort_weights(jnp.asarray(wc), combine, I))
    got = make(tagg).cohort_weights(torch.as_tensor(wc), combine, I).numpy()
    if combine == "sum" or "4" not in name:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_max_ulp(got, want, maxulp=2)
        np.testing.assert_allclose(got.sum(), 1.0, rtol=1e-6)
    if "4" not in name:                  # S = I: the weights untouched
        assert np.array_equal(got, wc)
    assert make(tagg).cohort_size(I) == make(jagg).cohort_size(I)


def _algorithms():
    """Algorithm 1 on the MLP task, the reference's and the port's."""
    from repro.core import protocol as jprotocol
    from repro.core import ssca as jssca
    from repro.core.schedules import paper_schedules as jschedules
    from repro.fed.tasks.base import SumLoss as JSumLoss
    from repro.fed.tasks.mlp import MLPTask as JMLPTask
    rho, gamma = jschedules(B)
    ja = jprotocol.SSCAUnconstrained(
        loss_fn=JSumLoss(JMLPTask(k=36, hidden=HIDDEN, l=4)),
        hp=jssca.SSCAHyperParams(tau=0.1, lam=1e-5, rho=rho, gamma=gamma))
    rho, gamma = paper_schedules(B)
    ta = tprotocol.SSCAUnconstrained(
        loss_fn=SumLoss(MLPTask(k=36, hidden=HIDDEN, l=4)),
        hp=tssca.SSCAHyperParams(tau=0.1, lam=1e-5, rho=rho, gamma=gamma))
    return ja, ta


@pytest.mark.parametrize("name,make", STRATEGIES,
                         ids=[s[0] for s in STRATEGIES])
def test_ledgers_match_reference(setup, name, make):
    _, _, p0 = setup
    pt = tm.params_from_numpy(p0, "cpu")
    j_alg, t_alg = _algorithms()
    ja, ta = make(jagg), make(tagg)
    for comp in (None, "topk"):
        got = tcomp.round_bytes(t_alg, ta, comp and tcomp.topk(0.25, bits=8),
                                pt, I)
        want = jcomp.round_bytes(j_alg, ja,
                                 comp and jcomp.topk(0.25, bits=8), p0, I)
        assert got.as_dict() == want.as_dict()
    n = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(p0))
    if name == "secure_sampled4":
        assert got.participants == 4
        assert got.uplink_total == 4 * (4 * n + 4 * 3)
    assert ta.participants(I) == ja.participants(I)
    assert ta.recovery_bytes_per_drop(I) == ja.recovery_bytes_per_drop(I)


RUNS = [
    ("sampled4", "run_alg1", lambda m: dict(aggregation=m.sampled(S)),
     None, 1e-5, 5e-7),
    ("fedavg_sampled4", "run_fedavg",
     lambda m: dict(aggregation=m.sampled(S), local_steps=2, lr_a=2.0),
     None, 1e-5, 5e-7),
    ("secure_sampled4", "run_alg1",
     lambda m: dict(aggregation=m.secure(num_sampled=S)), None, 1e-4, 2e-5),
    ("secure_sampled4_qsgd8", "run_alg1",
     lambda m: dict(aggregation=m.secure(num_sampled=S)),
     lambda c: c.qsgd(8), 0.0, 1e-3),
    ("secure_sampled4_topk25_8b", "run_alg1",
     lambda m: dict(aggregation=m.secure(num_sampled=S)),
     lambda c: c.topk(0.25, bits=8), 0.0, 1e-3),
]


@pytest.mark.parametrize("name,fn,make,comp,rtol,atol", RUNS,
                         ids=[r[0] for r in RUNS])
def test_cohort_runs_track_jax(setup, name, fn, make, comp, rtol, atol):
    data, part, p0 = setup
    jkw, tkw = make(jagg), make(tagg)
    if comp is not None:
        jkw["compressor"], tkw["compressor"] = comp(jcomp), comp(tcomp)
    pj, hj = getattr(jrt, fn)(data, part, params=p0, **KW, **jkw)
    pt, ht = getattr(trt, fn)(data, part, params=tm.params_from_numpy(p0,
                                                                      "cpu"),
                              device="cpu", **KW, **tkw)
    assert ht.rounds == hj.rounds == [2, 4]
    assert ht.comm == hj.comm and ht.comm["participants"] == S
    assert ht.cum_uplink_bytes == hj.cum_uplink_bytes
    np.testing.assert_allclose(ht.train_cost, hj.train_cost, rtol=1e-5)
    np.testing.assert_allclose(ht.test_accuracy, hj.test_accuracy,
                               atol=1e-6)
    for got, want in zip(tm.params_to_numpy(pt), pj):
        np.testing.assert_allclose(got, np.asarray(want), rtol=rtol,
                                   atol=atol)


def _port_run(data, part, fn, **kw):
    p, h = getattr(trt, fn)(data, part, device="cpu", **dict(KW, **kw))
    return tm.params_to_numpy(p), h


@pytest.mark.parametrize("fn,full,sampled", [
    ("run_alg1", tagg.plain(), tagg.sampled(I)),
    ("run_alg1", tagg.secure(), tagg.secure(num_sampled=I)),
    ("run_fedavg", tagg.plain(), tagg.sampled(I)),
    ("run_fedavg", tagg.secure(), tagg.secure(num_sampled=I)),
], ids=["alg1_plain", "alg1_secure", "fedavg_plain", "fedavg_secure"])
def test_full_cohort_is_full_participation_bitwise(setup, fn, full,
                                                   sampled):
    data, part, _ = setup
    extra = dict(local_steps=2, lr_a=2.0) if fn == "run_fedavg" else {}
    pa, ha = _port_run(data, part, fn, aggregation=full, **extra)
    pb, hb = _port_run(data, part, fn, aggregation=sampled, **extra)
    for a, b in zip(pa, pb):
        np.testing.assert_array_equal(a, b)
    assert ha.train_cost == hb.train_cost and ha.comm == hb.comm


def _masked_full_population_run(data, part, comp, *, secure):
    """The pre-cohort formulation in the port: every one of the I clients
    computes, compresses (stream seeds of its global id) and uploads,
    the I − S outside the round's cohort masked to zero and their
    residuals frozen; the secure combine masks over all I positions.
    Returns the final weights and the residual arena."""
    task = MLPTask(k=36, hidden=HIDDEN, l=4)
    rho, gamma = paper_schedules(B)
    alg = tprotocol.SSCAUnconstrained(
        loss_fn=SumLoss(task),
        hp=tssca.SSCAHyperParams(tau=0.1, lam=1e-5, rho=rho, gamma=gamma))
    params = task.init_params(torch.Generator().manual_seed(SEED))
    state = alg.init_state(params)
    x, y = torch.as_tensor(data.x_train), torch.as_tensor(data.y_train)
    weights = torch.as_tensor(alg.client_weights(part, B))
    cohorts = tpart.sample_cohorts(I, S, np.arange(1, T + 1), SEED)
    arena = None
    for t, kw in enumerate(round_keys(SEED, T)):
        idx = torch.as_tensor(tpart.sample_minibatches(part, B, t + 1, SEED))
        mask = torch.zeros(I)
        mask[cohorts[t]] = 1.0
        rw = mask * weights * (I / S)
        raw = torch.func.vmap(lambda b: alg.client_upload(params, state, b))(
            (x[idx], y[idx], rw[:, None].expand(idx.shape)))
        if arena is None and comp.stateful:
            arena = comp.init_client_state(tree.map(lambda v: v[0], raw), I)
        seeds = torch.as_tensor([client_stream_seed(int(kw[0]), int(kw[-1]),
                                                    c) for c in range(I)])
        out, new_res = comp.compress(raw, arena, seeds, device="cpu")
        live = mask != 0
        out = tree.map(lambda c: torch.where(
            live.reshape((-1,) + (1,) * (c.ndim - 1)), c,
            torch.zeros_like(c)), out)
        if arena is not None:
            arena = tree.map(lambda n, o: torch.where(
                live.reshape((-1,) + (1,) * (n.ndim - 1)), n, o),
                new_res, arena)
        agg = (tagg.secure() if secure else tagg.plain()).combine_messages(
            out, kw, device="cpu")
        params, state = alg.server_step(params, state, agg, device="cpu")
    return tm.params_to_numpy(params), arena


@pytest.mark.parametrize("comp", [tcomp.qsgd(8), tcomp.topk(0.25, bits=8)],
                         ids=["qsgd8", "topk25_8b_ef"])
def test_cohort_run_matches_masked_full_population_bitwise(setup, comp):
    data, part, _ = setup
    p_eng, _ = _port_run(data, part, "run_alg1", compressor=comp,
                         aggregation=tagg.secure(num_sampled=S))
    p_ref, _ = _masked_full_population_run(data, part, comp, secure=True)
    for a, b in zip(p_eng, p_ref):
        np.testing.assert_array_equal(a, b)


class _KeptArena(tcomp.TopKCompressor):
    """Top-k whose residual arena is kept for the test to read."""
    arenas = []

    def init_client_state(self, like, num_clients):
        arena = super().init_client_state(like, num_clients)
        self.arenas.append(arena)
        return arena


def test_residuals_of_nonparticipants_never_move(setup):
    data, part, _ = setup
    s, t = 3, 6
    comp = _KeptArena(fraction=0.25)
    trt.run_alg1(data, part, device="cpu", compressor=comp,
                 aggregation=tagg.sampled(s), **dict(KW, rounds=t))
    arena = _KeptArena.arenas.pop()
    drawn = np.unique(tpart.sample_cohorts(I, s, np.arange(1, t + 1), SEED))
    never = np.setdiff1d(np.arange(I), drawn)
    assert len(never) > 0                                # I > S·T coverage
    for leaf in tree.leaves(arena):
        for c in never:
            assert torch.count_nonzero(leaf[c]) == 0, c
        for c in drawn:
            assert torch.count_nonzero(leaf[c]) > 0, c


@pytest.mark.parametrize("make,match", [
    (lambda m: m.secure(num_sampled=0), "positive int"),
    (lambda m: m.secure(num_sampled=True), "positive int"),
    (lambda m: m.secure(num_sampled=2.5), "positive int"),
])
def test_bad_num_sampled_raises_as_the_reference(make, match):
    with pytest.raises(ValueError, match=match):
        make(jagg)
    with pytest.raises(ValueError, match=match):
        make(tagg)


@pytest.mark.parametrize("aggregation", [tagg.sampled(17), tagg.sampled(0),
                                         tagg.secure(num_sampled=17)],
                         ids=["sampled17", "sampled0", "secure17"])
def test_cohort_out_of_range_raises(setup, aggregation):
    data, part, _ = setup
    with pytest.raises(ValueError, match="out of range"):
        trt.run_alg1(data, part, device="cpu", aggregation=aggregation, **KW)


def test_rwkv6_fedsgd_sampled_tracks_reference():
    """The port's counterpart of ``tests/test_tasks.py::
    test_lm_task_sampled_participation``: rwkv6-7b reduced (seq 16,
    width 32, vocab 64), 64 documents over 4 clients, FedSGD at
    lr_a = 0.5, ``sampled(2)``, B = 4, 3 rounds."""
    task = dict(seq_len=16, d_model=32, vocab=64)
    jt = jrwkv6_task(**task)
    data = jt.default_data(n_train=64, n_test=16, seed=0)
    part = jpart.iid(64, 4, seed=0)
    p0 = jt.init_params(jax.random.key(0))
    rng = np.random.default_rng(11)
    blocks = dict(p0["blocks"])
    for name in ("ln_w", "bonus"):       # zero at init: no WKV gradient
        blocks[name] = jnp.asarray(rng.normal(0.0, 0.5, blocks[name].shape)
                                   .astype(np.float32))
    p0 = {**p0, "blocks": blocks}
    kw = dict(batch_size=4, rounds=3, lr_a=0.5, eval_every=3,
              eval_samples=32)
    pj, hj = jrt.run_fedsgd(data, part, task=jt, params=p0,
                            aggregation=jagg.sampled(2), **kw)
    pt, ht = trt.run_fedsgd(
        data, part, task=rwkv6_task(**task), device="cpu",
        params=tt.params_from_numpy(jax.tree.map(np.asarray, p0), "cpu"),
        aggregation=tagg.sampled(2), **kw)
    assert np.isfinite(ht.metrics["train_cost"]).all()
    assert ht.comm == hj.comm and ht.comm["participants"] == 2
    np.testing.assert_allclose(ht.metrics["train_cost"],
                               hj.metrics["train_cost"], rtol=1e-4)
    for got, want in zip(tree.leaves(pt), jax.tree.leaves(pj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=5e-5)
