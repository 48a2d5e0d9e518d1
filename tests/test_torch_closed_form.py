"""The paper's explicit Section-V recursions in the port
(``repro_torch.mlpapp.closed_form``): against the port's own autodiff and
generic core, as ``tests/test_mlpapp.py`` holds the reference's, and
against the reference's ``closed_form`` on the same inputs.

Inputs: the reference's ``init_params(key(1), 784, 16, 10)`` and the
first 64 synthetic MNIST samples at weights 1/64.  Against autodiff the
tolerances are the reference test's own (rtol 2e-4, atol 1e-6; Ā rel
1e-4; the Algorithm-1 round rtol 1e-4, atol 1e-6).  Against the
reference, measured on the CPU (largest difference seen, tolerance):
B̄ 1.2e-7 and C̄ 2.9e-7 of their largest entry (1e-6); Ā 8.7e-7
relative, its log-probabilities summed in another order (5e-6); the
weights after the Algorithm-1 round 1.5e-8 and after three Algorithm-2
rounds 3.0e-8 absolute (rtol 1e-6, atol 1e-6), Algorithm 2's A 8.7e-7
relative (1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro.data import synthetic
from repro.mlpapp import closed_form as jcf
from repro.mlpapp import model as jm
from repro_torch.core import autodiff, constrained, ssca
from repro_torch.core.schedules import paper_schedules
from repro_torch.fed.tasks.mlp import MLPTask
from repro_torch.mlpapp import closed_form as cf
from repro_torch.mlpapp import model as mlp

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def setup():
    data = synthetic.classification_dataset(n_train=64, n_test=8, seed=0)
    p0 = jm.init_params(jax.random.key(1), 784, 16, 10)
    x, y = data.x_train[:64], data.y_train[:64]
    wn = np.full((64,), 1.0 / 64.0, np.float32)
    jargs = (p0, jnp.asarray(x), jnp.asarray(y), jnp.asarray(wn))
    targs = (mlp.params_from_numpy(p0, "cpu"), torch.tensor(x),
             torch.tensor(y), torch.tensor(wn))
    return jargs, targs


def _loss_sum(params, batch):
    return MLPTask(784, 16, 10).loss_sum(params, batch)


def _scaled_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * float(np.abs(want).max()))


def test_bbar_cbar_equal_gradients_and_reference(setup):
    jargs, (p, x, y, wn) = setup
    bbar, cbar = cf.bbar_cbar(p, x, y, wn)
    g = autodiff.grad(_loss_sum, p, (x, y, wn))
    np.testing.assert_allclose(bbar.numpy(), g["w1"].numpy(), rtol=2e-4,
                               atol=1e-6)
    np.testing.assert_allclose(cbar.numpy(), g["w2"].numpy(), rtol=2e-4,
                               atol=1e-6)
    want = jcf.bbar_cbar(*jargs)
    _scaled_close(bbar, want[0])
    _scaled_close(cbar, want[1])


def test_abar_equals_cost_plus_reg(setup):
    jargs, (p, x, y, wn) = setup
    a = float(cf.abar(p, x, y, wn, tau=0.1))
    ce = float(mlp.cross_entropy(p, (x, y)))       # mean == sum·(1/64)
    assert a == pytest.approx(ce + 0.1 * float(mlp.sparsity(p)), rel=1e-4)
    assert a == pytest.approx(float(jcf.abar(*jargs, tau=0.1)), rel=5e-6)


def test_alg1_explicit_equals_generic_and_reference(setup):
    jargs, (p, x, y, wn) = setup
    tau, lam = 0.1, 1e-3
    rho_s, gamma_s = paper_schedules(100)
    rho, gamma = float(rho_s(1)), float(gamma_s(1))
    p_explicit, st = cf.alg1_update(cf.init_alg1_state(p), p, x, y, wn,
                                    rho=rho, gamma=gamma, tau=tau, lam=lam)
    hp = ssca.SSCAHyperParams(tau=tau, lam=lam, rho=rho_s, gamma=gamma_s)
    g = autodiff.grad(_loss_sum, p, (x, y, wn))
    p_generic, _ = ssca.server_update(ssca.init(p), p, g, hp)
    for k in ("w1", "w2"):
        np.testing.assert_allclose(p_explicit[k].numpy(),
                                   p_generic[k].numpy(), rtol=1e-4,
                                   atol=1e-6)
    want, _ = jcf.alg1_update(jcf.init_alg1_state(jargs[0]), *jargs,
                              rho=rho, gamma=gamma, tau=tau, lam=lam)
    np.testing.assert_allclose(p_explicit["w1"].numpy(), np.asarray(want.w1),
                               **TOL)
    np.testing.assert_allclose(p_explicit["w2"].numpy(), np.asarray(want.w2),
                               **TOL)
    assert set(st) == {"B", "C", "beta"}


def test_alg2_explicit_equals_generic_and_reference(setup):
    # three rounds of eqs. (13)–(15), (20)–(23) against the generic
    # Algorithm-2 round (autodiff + Lemma 1) and the reference's recursions
    jargs, (p, x, y, wn) = setup
    tau, c, u = 0.1, 1e5, 0.13
    rho_s, gamma_s = paper_schedules(100)
    hp = constrained.ConstrainedHyperParams(tau=tau, c=c, rho=rho_s,
                                            gamma=gamma_s)
    generic = constrained.round_fn(_loss_sum, u, hp)
    pe, se = p, cf.init_alg2_state(p)
    pg, sg = p, constrained.init(p)
    pj, sj = jargs[0], jcf.init_alg2_state(jargs[0])
    for t in range(1, 4):
        rho, gamma = float(rho_s(t)), float(gamma_s(t))
        pe, se = cf.alg2_update(se, pe, x, y, wn, rho=rho, gamma=gamma,
                                tau=tau, c=c, limit_u=u)
        pg, sg = generic(pg, sg, (x, y, wn))
        pj, sj = jcf.alg2_update(sj, pj, *jargs[1:], rho=rho, gamma=gamma,
                                 tau=tau, c=c, limit_u=u)
        for k, jw in (("w1", pj.w1), ("w2", pj.w2)):
            assert torch.isfinite(pe[k]).all()
            np.testing.assert_allclose(pe[k].numpy(), pg[k].numpy(),
                                       rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(pe[k].numpy(), np.asarray(jw), **TOL)
        np.testing.assert_allclose(float(se["A"]), float(sj["A"]), rtol=1e-5)
        np.testing.assert_allclose(float(se["A"]), float(sg.a_c[0]),
                                   rtol=1e-4)


def test_swish_prime_matches_autodiff():
    z = torch.linspace(-4, 4, 101)
    d_auto = vmap(grad(mlp.swish))(z)
    np.testing.assert_allclose(mlp.swish_prime(z).numpy(), d_auto.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mlp.swish_prime(z).numpy(),
                               np.asarray(jm.swish_prime(jnp.asarray(z))),
                               rtol=1e-6, atol=1e-7)


def test_model_helpers_match_reference(setup):
    jargs, (p, x, y, wn) = setup
    jp, jx, jy = jargs[:3]
    for got, want in ((mlp.hidden(p, x), jm.hidden(jp, jx)),
                      (mlp.predict(p, x), jm.predict(jp, jx))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(mlp.cross_entropy_sum(p, (x, y))),
                               float(jm.cross_entropy_sum(jp, (jx, jy))),
                               rtol=1e-6)
    np.testing.assert_allclose(float(mlp.l2_objective(1e-3)(p, (x, y))),
                               float(jm.l2_objective(1e-3)(jp, (jx, jy))),
                               rtol=1e-6)
