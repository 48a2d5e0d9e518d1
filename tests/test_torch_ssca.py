"""The port's SSCA server update against the reference.

Float paths match to a stated f32 tolerance: XLA and PyTorch may order
or contract the elementwise operations differently (XLA on the CPU fuses
multiply-adds).  Measured on the CPU at the shapes below: the plain update
against the reference kernel (interpret mode) differs by at most one ulp
of its outputs (4.3e-7 at |x| ≈ 4, N(0, 1) inputs).  Tolerance: rtol 1e-6,
atol 1e-6 (two ulp below |x| = 8).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import schedules as jsched
from repro.core import ssca as jssca
from repro.kernels import ssca_update as jsu
from repro_torch.core import schedules as tsched
from repro_torch.core import ssca as tssca
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssca_update as tsu

RTOL, ATOL = 1e-6, 1e-6


@pytest.mark.parametrize("rows", [3, 794])
def test_plain_update_matches_reference_kernel(rows):
    rng = np.random.default_rng(rows)
    w, lin, g, beta = (rng.standard_normal((rows, 128)).astype(np.float32)
                       for _ in range(4))
    sc = np.asarray([0.9 / 3 ** 0.3, 0.9 / 3 ** 0.35, 0.1, 1e-5], np.float32)
    want = jsu.ssca_update_2d(*map(jnp.asarray, (w, lin, g, beta, sc)),
                              interpret=True)
    got = tsu.ssca_update_2d(*map(torch.tensor, (w, lin, g, beta, sc)),
                             device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=RTOL, atol=ATOL)


def _tree(rng, shapes):
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


def test_flatten_pad_round_trip():
    rng = np.random.default_rng(1)
    tree = {k: torch.tensor(v) for k, v in
            _tree(rng, {"w1": (7, 13), "w2": (257,), "b": (3, 1)}).items()}
    flat = tops.pad_lanes(tops.flatten(tree))
    assert flat.shape == (3, 128)                 # 91 + 257 + 3 = 351 → 384
    assert torch.equal(flat.reshape(-1)[351:], torch.zeros(33))
    # leaves laid out in sorted key order, row-major
    assert torch.equal(flat.reshape(-1)[:3], tree["b"].reshape(-1))
    back = tops.unflatten(flat, tree)
    assert list(back) == sorted(tree)
    for k in tree:
        assert torch.equal(back[k], tree[k])


@pytest.mark.parametrize("lam", [0.0, 1e-3])
def test_server_update_fused_matches_unfused_and_reference(lam):
    rng = np.random.default_rng(2)
    shapes = {"w1": (16, 20), "w2": (5, 16)}
    p, g1, g2 = (_tree(rng, shapes) for _ in range(3))
    hp_j = jssca.SSCAHyperParams(tau=0.1, lam=lam,
                                 rho=jsched.PowerLaw(0.9, 0.3),
                                 gamma=jsched.PowerLaw(0.9, 0.35))
    hp_t = tssca.SSCAHyperParams(tau=0.1, lam=lam,
                                 rho=tsched.PowerLaw(0.9, 0.3),
                                 gamma=tsched.PowerLaw(0.9, 0.35))
    tp = {k: torch.tensor(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    outs = {}
    for fused in (False, True):
        params, state = dict(tp), tssca.init(tp)
        for g in (g1, g2):               # two rounds: lin and β carry
            params, state = tssca.server_update(
                state, params, {k: torch.tensor(v) for k, v in g.items()},
                hp_t, fused=fused, device="cpu")
        outs[fused] = (params, state)
        assert state.step == 3
        assert (state.beta["w1"].abs().sum() > 0) == bool(lam)
    jparams, jstate = jp, jssca.init(jp)
    for g in (g1, g2):
        jparams, jstate = jssca.server_update(
            jstate, jparams, {k: jnp.asarray(v) for k, v in g.items()},
            hp_j)
    for k in shapes:
        np.testing.assert_allclose(outs[True][0][k].numpy(),
                                   outs[False][0][k].numpy(),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(outs[True][1].lin[k].numpy(),
                                   outs[False][1].lin[k].numpy(),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(outs[False][0][k].numpy(),
                                   np.asarray(jparams[k]),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(outs[False][1].beta[k].numpy(),
                                   np.asarray(jstate.beta[k]),
                                   rtol=RTOL, atol=ATOL)


def test_paper_schedules_equal_reference():
    for b in (1, 10, 100):
        for ref, got in zip(jsched.paper_schedules(b),
                            tsched.paper_schedules(b)):
            for t in range(1, 200):
                assert np.float32(ref(t)) == np.float32(got(t).item())
