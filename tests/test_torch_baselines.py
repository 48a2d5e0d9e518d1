"""The port's SGD baselines, optimizers, schedules, SSCA helpers and the
E-axis schedule against the reference, on the same inputs.

Exact: the schedules' validation, every power law's f32 value, and
``build_schedule`` (full participation, the reference's draw) index for
index at E = 1 and 2, with and without the E axis.  Float paths,
measured on the CPU on the paper's MLP at K = 16, J = 8, L = 4 (largest
difference seen, tolerance):

* ``sgd`` and ``momentum`` (plain and Nesterov) steps: equal here;
  ``fedsgd_round``: 6.0e-8 absolute (atol 1e-6, rtol 1e-6);
* ``local_sgd`` over E = 3 steps, with and without momentum, and
  ``fedavg_round`` / ``prsgd_round`` over 4 clients of E = 2: 1.2e-7
  absolute (atol 1e-6, rtol 1e-6);
* ``surrogate_grad`` equal here (atol 1e-6, rtol 1e-6); ``kkt_residual``
  7.2e-8 relative (rtol 1e-6); ``surrogate_value`` 4.8e-7 absolute,
  where terms of size ≈ 10 cancel to ≈ 0.15 (atol 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.core import fedavg as jfa
from repro.core import schedules as jsched
from repro.core import ssca as jssca
from repro.data import partition as jpart
from repro.fed import engine as jengine
from repro.fed.tasks.base import LocalObjective as JLocal
from repro.fed.tasks.mlp import MLPTask as JMLPTask
from repro.mlpapp import model as jm
from repro_torch import optim as toptim
from repro_torch import tree
from repro_torch.core import fedavg as tfa
from repro_torch.core import schedules as tsched
from repro_torch.core import ssca as tssca
from repro_torch.data import partition as tpart
from repro_torch.fed import engine as tengine
from repro_torch.fed.tasks.base import LocalObjective as TLocal
from repro_torch.fed.tasks.mlp import MLPTask as TMLPTask

K, J, L = 16, 8, 4
TOL = dict(rtol=1e-6, atol=1e-6)


def _params(seed=0, scale=0.3):
    rng = np.random.default_rng(seed)
    return {"w1": (scale * rng.standard_normal((J, K))).astype(np.float32),
            "w2": (scale * rng.standard_normal((L, J))).astype(np.float32)}


def _jp(p):
    return jm.MLPParams(jnp.asarray(p["w1"]), jnp.asarray(p["w2"]))


def _tp(p):
    return {k: torch.tensor(v) for k, v in p.items()}


def _batch(lead=(), n=12, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(lead + (n, K)).astype(np.float32)
    y = np.eye(L, dtype=np.float32)[rng.integers(0, L, lead + (n,))]
    return x, y


def _close(got, want, **tol):
    tol = tol or TOL
    for a, b in zip(tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **tol)


def test_power_laws_and_schedules():
    for law in (tsched.sgd_learning_rate(), tsched.sgd_learning_rate(2.0, 0.3)):
        ref = jsched.sgd_learning_rate(law.a, law.alpha)
        for t in (1, 2, 7, 100):
            assert np.float32(law(t)) == np.float32(ref(t))
    s, r = tsched.strict_schedules(), jsched.strict_schedules()
    assert (s.rho.a, s.rho.alpha, s.gamma.a, s.gamma.alpha) == \
        (r.rho.a, r.rho.alpha, r.gamma.a, r.gamma.alpha)
    for t in (1, 5, 50):
        assert np.float32(s.gamma(t)) == np.float32(r.gamma(t))
    for bad in (dict(a1=0.0), dict(alpha_rho=0.0), dict(alpha_gamma=0.5),
                dict(alpha_gamma=1.2), dict(alpha_rho=0.6, alpha_gamma=0.55)):
        with pytest.raises(ValueError):
            tsched.strict_schedules(**bad)
        with pytest.raises(ValueError):
            jsched.strict_schedules(**bad)


@pytest.mark.parametrize("kind", ["sgd", "momentum", "nesterov"])
def test_optimizer_steps_match_reference(kind):
    p, g = _params(0), _params(1, scale=1.0)
    lr = jsched.sgd_learning_rate(0.5, 0.3)
    tlr = tsched.sgd_learning_rate(0.5, 0.3)
    if kind == "sgd":
        (ji, ju), (ti, tu) = joptim.sgd(lr), toptim.sgd(tlr)
    else:
        nest = kind == "nesterov"
        ji, ju = joptim.momentum(lr, 0.9, nesterov=nest)
        ti, tu = toptim.momentum(tlr, 0.9, nesterov=nest)
    jw, js = _jp(p), ji(_jp(p))
    tw, ts = _tp(p), ti(_tp(p))
    for _ in range(3):
        jw, js = ju(_jp(g), js, jw)
        tw, ts = tu(_tp(g), ts, tw)
        _close(tw, jw)
    assert ts.step == int(js.step) == 4


def test_fedsgd_round_matches_reference():
    p, (x, y) = _params(), _batch()
    w = np.full(x.shape[0], 0.05, np.float32)
    hp_j = jfa.SGDHyperParams(lr=jsched.sgd_learning_rate(2.0, 0.3))
    hp_t = tfa.SGDHyperParams(lr=tsched.sgd_learning_rate(2.0, 0.3))
    jr = jfa.fedsgd_round(JMLPTask(K, J, L).loss_sum, hp_j)
    tr = tfa.fedsgd_round(TMLPTask(K, J, L).loss_sum, hp_t)
    jw, tw = _jp(p), _tp(p)
    for t in (1, 2, 3):
        jw = jr(jw, tuple(map(jnp.asarray, (x, y, w))), t, weight=2.0,
                aggregate=lambda g: jax.tree.map(lambda v: 0.5 * v, g))
        tw = tr(tw, tuple(map(torch.tensor, (x, y, w))), t, weight=2.0,
                aggregate=lambda g: tree.map(lambda v: 0.5 * v, g))
        _close(tw, jw)


@pytest.mark.parametrize("mom", [0.0, 0.9])
def test_local_sgd_matches_reference(mom):
    p, (x, y) = _params(), _batch((3,))                  # E = 3 steps
    hp_j = jfa.SGDHyperParams(local_steps=3, momentum=mom)
    hp_t = tfa.SGDHyperParams(local_steps=3, momentum=mom)
    jloss = JLocal(JMLPTask(K, J, L), 1e-3)
    tloss = TLocal(TMLPTask(K, J, L), 1e-3)
    want = jfa.local_sgd(jloss, hp_j)(_jp(p), (jnp.asarray(x),
                                               jnp.asarray(y)),
                                      jnp.float32(0.7))
    got = tfa.local_sgd(tloss, hp_t)(_tp(p), (torch.tensor(x),
                                              torch.tensor(y)),
                                     torch.tensor(0.7))
    _close(got, want)
    # and it moved: three steps of 0.7 on a mean loss
    assert float((got["w1"] - torch.tensor(p["w1"])).abs().max()) > 1e-3


@pytest.mark.parametrize("fn", ["fedavg_round", "prsgd_round"])
def test_fedavg_round_matches_reference(fn):
    # vmap over 4 clients of E = 2 local steps, then the weighted average
    p, (x, y) = _params(), _batch((4, 2))
    cw = np.asarray([0.1, 0.2, 0.3, 0.4], np.float32)
    hp_j = jfa.SGDHyperParams(lr=jsched.sgd_learning_rate(2.0, 0.3),
                              local_steps=2)
    hp_t = tfa.SGDHyperParams(lr=tsched.sgd_learning_rate(2.0, 0.3),
                              local_steps=2)
    jr = getattr(jfa, fn)(JLocal(JMLPTask(K, J, L), 1e-5), hp_j)
    tr = getattr(tfa, fn)(TLocal(TMLPTask(K, J, L), 1e-5), hp_t)
    jw, tw = _jp(p), _tp(p)
    for t in (1, 2):
        jw = jr(jw, (jnp.asarray(x), jnp.asarray(y)), jnp.asarray(cw), t)
        tw = tr(tw, (torch.tensor(x), torch.tensor(y)), torch.tensor(cw), t)
        _close(tw, jw)


def test_ssca_helpers_match_reference():
    p, lin, beta = _params(0), _params(1, 1.0), _params(2, 1.0)
    g = _params(3, 1.0)
    for lam in (0.0, 1e-3):
        hp_j = jssca.default_hparams(10, tau=0.2, lam=lam)
        hp_t = tssca.default_hparams(10, tau=0.2, lam=lam)
        assert (hp_t.tau, hp_t.lam, hp_t.rho, hp_t.gamma) == \
            (hp_j.tau, hp_j.lam, tsched.PowerLaw(hp_j.rho.a, hp_j.rho.alpha),
             tsched.PowerLaw(hp_j.gamma.a, hp_j.gamma.alpha))
        js = jssca.SSCAState(step=jnp.asarray(1), lin=_jp(lin),
                             beta=_jp(beta))
        ts = tssca.SSCAState(step=1, lin=_tp(lin), beta=_tp(beta))
        # the value cancels terms of size ≈ 10 down to ≈ 0.15: held to
        # their scale
        np.testing.assert_allclose(
            float(tssca.surrogate_value(ts, hp_t, _tp(p))),
            float(jssca.surrogate_value(js, hp_j, _jp(p))), rtol=1e-6,
            atol=1e-5)
        _close(tssca.surrogate_grad(ts, hp_t, _tp(p)),
               jssca.surrogate_grad(js, hp_j, _jp(p)))
    np.testing.assert_allclose(float(tssca.kkt_residual(_tp(g))),
                               float(jssca.kkt_residual(_jp(g))), rtol=1e-6)


@pytest.mark.parametrize("e_axis", [False, True])
@pytest.mark.parametrize("local_steps", [1, 2])
def test_build_schedule_matches_reference(local_steps, e_axis):
    # uneven clients (two below B, so drawn with replacement)
    jp = jpart.dirichlet(np.random.default_rng(4).integers(0, 5, 300), 6,
                         alpha=0.5, seed=4)
    tp = tpart.Partition(jp.flat, jp.offsets, jp.sizes)
    want = jengine.build_schedule(jp, 8, 5, local_steps, seed=7,
                                  e_axis=e_axis)[1]
    _, idx = tengine.build_schedule(tp, 8, 5, local_steps, seed=7,
                                    e_axis=e_axis)
    np.testing.assert_array_equal(idx, np.asarray(want))
    assert idx.shape == ((5, 6, local_steps, 8) if e_axis else (5, 6, 8))
    if e_axis and local_steps == 2:
        # each local step draws under its own id t·1000 + e
        assert not np.array_equal(idx[:, :, 0], idx[:, :, 1])
