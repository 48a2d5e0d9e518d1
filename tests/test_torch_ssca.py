"""The port's SSCA server update against the reference.

Float paths match to a stated f32 tolerance: XLA and PyTorch may order
or contract the elementwise operations differently (XLA on the CPU fuses
multiply-adds).  Measured on the CPU at the shapes below: the plain update
against the reference kernel (interpret mode) differs by at most one ulp
of its outputs (4.3e-7 at |x| ≈ 4, N(0, 1) inputs), with β and without
(the ``lambda0`` variant at λ = 0).  Tolerance: rtol 1e-6, atol 1e-6 (two
ulp below |x| = 8).

Without β (``init(params, with_beta=False)``) the port follows the
reference: λ = 0 never reads β, the fused update at λ > 0 runs on a zero
β and discards β', and the unfused one at λ > 0 fails on both sides.
Inside the port, bit for bit: the ``lambda0`` plain version and the
unfused update at λ = 0; an MLP run at λ = 0 with β kept and without.
The ``lambda0`` variant differs from the ``beta`` variant at λ = 0 only
in the sign of a zero of w' (lin' + 0·β' turns a −0 into +0).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import schedules as jsched
from repro.core import ssca as jssca
from repro.data import partition as jpart
from repro.data import synthetic
from repro.kernels import ssca_update as jsu
from repro.mlpapp import model as jm
from repro_torch import tree as ttree
from repro_torch.core import protocol as tprotocol
from repro_torch.core import schedules as tsched
from repro_torch.core import ssca as tssca
from repro_torch.fed import aggregation as tagg
from repro_torch.fed import runtime as trt
from repro_torch.fed.tasks import MLPTask, SumLoss
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssca_update as tsu
from repro_torch.mlpapp import model as tm

RTOL, ATOL = 1e-6, 1e-6


@pytest.mark.parametrize("rows,variant", [
    pytest.param(3, "beta", id="3"), pytest.param(794, "beta", id="794"),
    pytest.param(3, "lambda0", id="3-lambda0"),
    pytest.param(794, "lambda0", id="794-lambda0")])
def test_plain_update_matches_reference_kernel(rows, variant):
    """``lambda0``: the plain version without β against the reference
    kernel at λ = 0 (its β' unread), for w' and lin'."""
    rng = np.random.default_rng(rows)
    w, lin, g, beta = (rng.standard_normal((rows, 128)).astype(np.float32)
                       for _ in range(4))
    lam = 1e-5 if variant == "beta" else 0.0
    sc = np.asarray([0.9 / 3 ** 0.3, 0.9 / 3 ** 0.35, 0.1, lam], np.float32)
    want = jsu.ssca_update_2d(*map(jnp.asarray, (w, lin, g, beta, sc)),
                              interpret=True)
    t_beta = torch.tensor(beta) if variant == "beta" else None
    got = tsu.ssca_update_2d(torch.tensor(w), torch.tensor(lin),
                             torch.tensor(g), t_beta, torch.tensor(sc),
                             device="cpu")
    if variant == "lambda0":
        assert got[2] is None
        got, want = got[:2], want[:2]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=RTOL, atol=ATOL)


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_lambda0_differs_from_beta_variant_only_in_the_sign_of_zero():
    """At λ = 0 lin' is one expression in both variants, bit for bit; w'
    differs at most in the sign of a zero.  Lane 0 shows one: w = −0,
    lin = −0, g = −1e-45 (ρ·g underflows to −0) give lin' = −0, so the
    ``beta`` variant's −(lin' + 0·β')/(2τ) is −0 and w' = −0 + γ·(−0) =
    −0, where ``lambda0``'s −lin'/(2τ) is +0 and w' = +0."""
    rng = np.random.default_rng(5)
    w, lin, g, beta = (torch.tensor(rng.standard_normal((4, 128)),
                                    dtype=torch.float32) for _ in range(4))
    w[0, 0], lin[0, 0], g[0, 0], beta[0, 0] = -0.0, -0.0, -1e-45, 0.0
    sc = torch.tensor([0.3, 0.4, 0.1, 0.0])
    w_b, lin_b, _ = tsu.ssca_update_plain(w, lin, g, beta, sc)
    w_0, lin_0, beta_0 = tsu.ssca_update_plain(w, lin, g, None, sc)
    assert beta_0 is None
    assert torch.equal(_bits(lin_b), _bits(lin_0))
    assert torch.equal(w_b, w_0)                  # −0 == +0
    differ = _bits(w_b) != _bits(w_0)
    assert differ[0, 0] and bool((w_0[differ] == 0).all())
    assert torch.signbit(w_b[0, 0]) and not torch.signbit(w_0[0, 0])


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


def _hparams(lam):
    return (jssca.SSCAHyperParams(tau=0.1, lam=lam,
                                  rho=jsched.PowerLaw(0.9, 0.3),
                                  gamma=jsched.PowerLaw(0.9, 0.35)),
            tssca.SSCAHyperParams(tau=0.1, lam=lam,
                                  rho=tsched.PowerLaw(0.9, 0.3),
                                  gamma=tsched.PowerLaw(0.9, 0.35)))


def _port_rounds(p, grads, hp, fused, with_beta):
    params = {k: torch.tensor(v) for k, v in p.items()}
    state = tssca.init(params, with_beta=with_beta)
    for g in grads:
        params, state = tssca.server_update(
            state, params, {k: torch.tensor(v) for k, v in g.items()}, hp,
            fused=fused, device="cpu")
    return params, state


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("lam", [0.0, 1e-3])
def test_server_update_without_beta_matches_reference(lam, fused):
    """Two rounds from ``init(with_beta=False)`` against the reference's
    own; at λ = 0 the fused (``lambda0``) and unfused updates agree bit
    for bit, and equal the run with β kept."""
    rng = np.random.default_rng(7)
    shapes = {"w1": (16, 20), "w2": (5, 16)}
    p, g1, g2 = (_tree(rng, shapes) for _ in range(3))
    hp_j, hp_t = _hparams(lam)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jstate = jssca.init(jp, with_beta=False)
    assert jstate.beta is None
    if lam and not fused:
        with pytest.raises(ValueError):
            jssca.server_update(jstate, jp, jp, hp_j)
        with pytest.raises(ValueError, match="beta"):
            _port_rounds(p, (g1,), hp_t, False, False)
        return
    for g in (g1, g2):
        jp, jstate = jssca.server_update(
            jstate, jp, {k: jnp.asarray(v) for k, v in g.items()}, hp_j,
            fused=fused)
    params, state = _port_rounds(p, (g1, g2), hp_t, fused, False)
    assert state.step == 3 and state.beta is None and jstate.beta is None
    for k in shapes:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jp[k]),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(state.lin[k].numpy(),
                                   np.asarray(jstate.lin[k]),
                                   rtol=RTOL, atol=ATOL)
    if not lam:
        for other in ((p, (g1, g2), hp_t, not fused, False),
                      (p, (g1, g2), hp_t, fused, True)):
            o_params, o_state = _port_rounds(*other)
            for k in shapes:
                assert torch.equal(_bits(o_params[k]), _bits(params[k]))
                assert torch.equal(_bits(o_state.lin[k]),
                                   _bits(state.lin[k]))


@pytest.mark.parametrize("lam", [0.0, 1e-3])
def test_fused_update_reads_flat_state_in_place(lam, monkeypatch):
    """From the second call on, params, lin (and β at λ > 0) tile the
    previous outputs' buffers and reach the kernel wrapper as those
    buffers, with no copy; every output lies in a fresh buffer; and the
    result equals the copying path's bit for bit."""
    seen = []
    real = tsu.ssca_update_2d

    def spy(w, lin, g, beta, scalars, *, device=None):
        seen.append((w, lin, g, beta))
        return real(w, lin, g, beta, scalars, device=device)

    monkeypatch.setattr(tops._su, "ssca_update_2d", spy)
    rng = np.random.default_rng(3)
    shapes = {"b": (3, 1), "w1": (7, 13), "w2": (257,)}   # n = 351
    p, l0, b0, g1, g2 = ({k: torch.tensor(v) for k, v in
                          _tree(rng, shapes).items()} for _ in range(5))
    kw = dict(rho=0.3, gamma=0.4, tau=0.1, lam=lam, device="cpu")
    out1 = tops.ssca_update(p, l0, g1, b0, **kw)
    assert (out1[2] is None) == (not lam)
    assert seen[0][3] is None if not lam else seen[0][3] is not None
    out2 = tops.ssca_update(*out1[:2], g2, out1[2], **kw)
    w_in, l_in, g_in, b_in = seen[1]
    flat_ins = [w_in, l_in] + ([b_in] if lam else [])
    for buf, prev in zip(flat_ins, out1):
        leaf = ttree.leaves(prev)[0]
        assert buf.shape == (3, 128)
        assert buf.data_ptr() == leaf.data_ptr()
        assert buf.untyped_storage().data_ptr() \
            == leaf.untyped_storage().data_ptr()
    assert tops.flat_buffer(g2) is None               # leaves apart: copied
    for ins, outs in (((p, l0, g1, b0), out1), ((*out1, g2), out2)):
        in_ptrs = {x.untyped_storage().data_ptr() for t in ins
                   if t is not None for x in ttree.leaves(t)}
        assert all(x.untyped_storage().data_ptr() not in in_ptrs
                   for t in outs if t is not None
                   for x in ttree.leaves(t))
    copied = tops.ssca_update(
        *(ttree.map(torch.clone, t) for t in out1[:2]), g2,
        None if not lam else ttree.map(torch.clone, out1[2]), **kw)
    for a, b in zip(out2, copied):
        if a is not None:
            for x, y in zip(ttree.leaves(a), ttree.leaves(b)):
                assert torch.equal(_bits(x), _bits(y))


@pytest.mark.parametrize("case", ["out_of_order", "bf16", "gap", "short"])
def test_flat_buffer_refuses_what_does_not_tile(case):
    buf = torch.arange(3 * 128, dtype=torch.float32).reshape(3, 128)
    tree = tops.unflatten(buf, {"a": torch.empty(100),
                                "b": torch.empty(4, 50)})
    assert tops.flat_buffer(tree).data_ptr() == buf.data_ptr()
    if case == "out_of_order":
        tree = {"a": tree["b"].reshape(-1)[:100], "b": tree["a"][:50]
                .reshape(1, 50).expand(4, 50).contiguous()}
    elif case == "bf16":
        tree = {"a": tree["a"], "b": tree["b"].bfloat16()}
    elif case == "gap":
        flat = buf.reshape(-1)
        tree = {"a": flat[:100], "b": flat[101:301].reshape(4, 50)}
    else:                         # the storage ends before the last row
        tree = {"a": torch.zeros(130)}
    assert tops.flat_buffer(tree) is None


@dataclasses.dataclass(frozen=True)
class _KeepBeta(tprotocol.SSCAUnconstrained):
    def init_state(self, params):
        return tssca.init(params, with_beta=True)


def test_mlp_run_at_lambda0_same_bits_with_or_without_beta():
    """Algorithm 1 fused, secure, λ = 0, 3 rounds: the protocol keeps no
    β at λ = 0, and a run that keeps it ends with the same bits in every
    weight, metric and ledger entry."""
    data = synthetic.classification_dataset(n_train=400, n_test=100, seed=0)
    part = jpart.iid(400, 8, seed=0)
    p0 = tm.params_from_numpy(jm.init_params(jax.random.key(2), 784, 16, 10),
                              "cpu")
    task = MLPTask(k=784, hidden=16, l=10)
    rho, gamma = tsched.paper_schedules(5)
    hp = tssca.SSCAHyperParams(tau=0.1, lam=0.0, rho=rho, gamma=gamma)
    kw = dict(batch_size=5, rounds=3, eval_every=1, eval_samples=100,
              seed=2, params=p0, aggregation=tagg.secure(), device="cpu")
    alg = tprotocol.SSCAUnconstrained(loss_fn=SumLoss(task), hp=hp,
                                      fused=True)
    assert alg.init_state(p0).beta is None
    runs = [trt.run(task, a, data, part, **kw)
            for a in (alg, _KeepBeta(loss_fn=SumLoss(task), hp=hp,
                                     fused=True))]
    (pa, ha), (pb, hb) = runs
    for k in pa:
        assert torch.equal(_bits(pa[k]), _bits(pb[k]))
    for k in ("rounds", "metrics", "cum_uplink_bytes",
              "uplink_bytes_per_round", "downlink_bytes_per_round", "comm"):
        assert getattr(ha, k) == getattr(hb, k)
    assert ha.train_cost[-1] < ha.train_cost[0]


def test_paper_schedules_equal_reference():
    for b in (1, 10, 100):
        for ref, got in zip(jsched.paper_schedules(b),
                            tsched.paper_schedules(b)):
            for t in range(1, 200):
                assert np.float32(ref(t)) == np.float32(got(t).item())
