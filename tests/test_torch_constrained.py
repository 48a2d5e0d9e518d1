"""The port's Algorithm 2 (``repro_torch.core.constrained``) against the
reference's ``repro.core.constrained`` on the same inputs.

Inputs are seeded numpy draws on ``{"w1", "w2"}`` trees (the reference
takes the same dicts).  Float paths hold to f32 tolerances, measured on
the CPU (largest difference seen, tolerance):

* ``update_constraint_surrogate`` at M = 2: lin_c equal bit for bit
  (elementwise), A_m 2.9e-6 absolute on |A| ≈ 14, 2e-7 relative (rtol
  1e-6: the sum order of the dot products);
* ``solve_lemma1`` in its three regimes: ω̄, ν and s equal here
  (tolerance: ω̄ 1e-6 of its largest entry, ν and s rtol 1e-5);
* ``solve_dual``: 50 projected steps, each clipped to [0, c]; the clip
  makes the iterate sensitive to the order of f32 sums.  At c = 1e5 and
  at c = 10 (where the box binds one multiplier at 0): ω within 4.1e-7
  of its largest entry, ν within 5e-7 relative, s 4.5e-7 (tolerance
  1e-5 relative for each);
* ``round_fn`` on the paper's MLP (K = 16, J = 8, L = 4, B = 24), three
  rounds: weights 8.9e-8 absolute (atol 1e-6), slack 1.8e-6 relative,
  A equal (rtol 1e-5, slack atol 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import constrained as jcon
from repro.fed.tasks.mlp import MLPTask as JMLPTask
from repro.mlpapp import model as jm
from repro_torch import tree
from repro_torch.core import constrained as tcon
from repro_torch.fed.tasks.mlp import MLPTask as TMLPTask

SHAPES = {"w1": (8, 16), "w2": (4, 8)}


def _tree(rng, lead=(), scale=1.0):
    return {k: (scale * rng.standard_normal(lead + s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _t(t):
    return {k: torch.tensor(v) for k, v in t.items()}


def _j(t):
    return {k: jnp.asarray(v) for k, v in t.items()}


def _close_tree(got, want, rtol):
    for k in SHAPES:
        w = np.asarray(want[k])
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=rtol * scale)


def test_update_constraint_surrogate_matches_reference():
    rng = np.random.default_rng(0)
    m, tau = 2, 0.1
    params, lin, grads = _tree(rng), _tree(rng, (m,)), _tree(rng, (m,))
    a_c = rng.standard_normal(m).astype(np.float32)
    vals = (3.0 + rng.standard_normal(m)).astype(np.float32)
    rho = np.float32(0.9 / 3 ** 0.3)
    jst = jcon.init(_j(params), m)._replace(lin_c=_j(lin),
                                            a_c=jnp.asarray(a_c))
    tst = tcon.init(_t(params), m)._replace(lin_c=_t(lin),
                                            a_c=torch.tensor(a_c))
    want = jcon.update_constraint_surrogate(jst, _j(params), jnp.asarray(vals),
                                            _j(grads), tau, jnp.asarray(rho))
    got = tcon.update_constraint_surrogate(tst, _t(params), torch.tensor(vals),
                                           _t(grads), tau, torch.tensor(rho))
    for k in SHAPES:
        np.testing.assert_array_equal(got.lin_c[k].numpy(),
                                      np.asarray(want.lin_c[k]))
    np.testing.assert_allclose(got.a_c.numpy(), np.asarray(want.a_c),
                               rtol=1e-6)
    assert got.step == 1 and got.a_c.dtype == torch.float32


# (U − A) as a multiple of b / τ: interior 0 < ν < c at disc = b/2
# (s = 0), disc ≤ 0 at disc = −b (ν = c, s > 0), an inactive constraint
# at disc > b (ν = 0, ω̄ = 0, s = 0)
REGIMES = {"interior": -1.0 / 8.0, "disc_nonpositive": -1.0 / 2.0,
           "inactive": 1.0}


@pytest.mark.parametrize("regime", list(REGIMES))
def test_solve_lemma1_regimes(regime):
    rng = np.random.default_rng(1)
    tau, c, limit_u = 0.1, 1e5, 0.13
    lin = _tree(rng, scale=0.1)
    b = sum(float(np.sum(v.astype(np.float64) ** 2)) for v in lin.values())
    a_t = np.float32(limit_u - REGIMES[regime] * b / tau)
    want = jcon.solve_lemma1(_j(lin), jnp.asarray(a_t), limit_u, tau, c)
    got = tcon.solve_lemma1(_t(lin), torch.tensor(a_t), limit_u, tau, c)
    _close_tree(got[0], want[0], 1e-6)
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-5)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-5)
    nu = float(got[2])
    if regime == "interior":
        # complementarity: an active constraint, no slack (up to f32
        # rounding of a violation near A − U ≈ 2)
        assert 0.0 < nu < c and float(got[1]) < 1e-5
    elif regime == "disc_nonpositive":
        # infeasible for any ν: the penalty's cap, positive slack
        assert nu == c and float(got[1]) > 0.0
    else:
        assert nu == 0.0 and float(got[1]) == 0.0
        assert all(float(v.abs().max()) == 0.0 for v in got[0].values())


@pytest.mark.parametrize("c", [1e5, 10.0])
@pytest.mark.parametrize("m", [1, 2])
def test_solve_dual_matches_reference(m, c):
    rng = np.random.default_rng(10 * m + int(c > 100))
    tau, lam = 0.1, 1e-3
    lin0, beta = _tree(rng), _tree(rng)
    lin_c = _tree(rng, (m,))
    a_c = (rng.standard_normal(m) - 2.0).astype(np.float32)
    args = dict(lam_obj=lam, obj_quad=1.0, tau=tau, c=c, iters=50, lr=0.5)
    want = jcon.solve_dual(_j(lin0), _j(beta), lin_c=_j(lin_c),
                           a_c=jnp.asarray(a_c), **args)
    got = tcon.solve_dual(_t(lin0), _t(beta), lin_c=_t(lin_c),
                          a_c=torch.tensor(a_c), **args)
    _close_tree(got[0], want[0], 1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-5)
    assert got[2].shape == (m,)
    assert float(got[2].min()) >= 0.0 and float(got[2].max()) <= c


def test_round_fn_matches_reference():
    rng = np.random.default_rng(2)
    k, j, l, n = 16, 8, 4, 24
    x = rng.standard_normal((n, k)).astype(np.float32)
    y = np.eye(l, dtype=np.float32)[rng.integers(0, l, n)]
    w = np.full(n, 1.0 / n, np.float32)
    p = {"w1": (0.3 * rng.standard_normal((j, k))).astype(np.float32),
         "w2": (0.3 * rng.standard_normal((l, j))).astype(np.float32)}
    hp_j = jcon.ConstrainedHyperParams()
    hp_t = tcon.ConstrainedHyperParams()
    jround = jcon.round_fn(JMLPTask(k, j, l).loss_sum, 0.8, hp_j)
    tround = tcon.round_fn(TMLPTask(k, j, l).loss_sum, 0.8, hp_t)
    pj = jm.MLPParams(jnp.asarray(p["w1"]), jnp.asarray(p["w2"]))
    pt = _t(p)
    sj, st = jcon.init(pj), tcon.init(pt)
    batch = (x, y, w)
    for _ in range(3):
        pj, sj = jround(pj, sj, tuple(map(jnp.asarray, batch)))
        pt, st = tround(pt, st, tuple(map(torch.tensor, batch)))
        for a, b in zip(tree.leaves(pt), jax.tree.leaves(pj)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6)
        np.testing.assert_allclose(st.slack.numpy(), np.asarray(sj.slack),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(st.a_c.numpy(), np.asarray(sj.a_c),
                                   rtol=1e-5)
    assert st.step == int(sj.step) == 4


def test_penalty_continuation():
    assert tcon.penalty_continuation([1.0, 10.0, 1e5]) == \
        jcon.penalty_continuation([1.0, 10.0, 1e5])
    for bad in ([1.0, 1.0], [10.0, 1.0]):
        with pytest.raises(ValueError, match="Theorem 2"):
            tcon.penalty_continuation(bad)
        with pytest.raises(ValueError):
            jcon.penalty_continuation(bad)
