"""The hybrid family (recurrentgemma-9b) of the port against the
reference's: the RG-LRU (``models/rglru.py``), banded attention
(``attention.attend(window=)`` and the flash op's plain version), the
model's loss and token-by-token decode past ``local_window``,
``serve_batch``, ``make_train_step``, checkpoints of a tree with
``tail``, and ``run_alg1`` on ``transformer_task("recurrentgemma-9b")``.

Configurations: ``reduced(get_config("recurrentgemma-9b"), layers=L,
d_model=64, d_ff=128, vocab=128)`` at L = 3 (one unit: two recurrent
blocks and one local-attention block) and L = 5 (a unit and a recurrent
tail of 2): 4 query heads of 16 on 1 kv head, ``local_window`` 16,
conv width 4; f32 activations and bf16, the full-width dtype.  Both
sides start from one set of weights: the port's seeded init carried to
the reference as numpy.  Inputs are drawn with numpy from a seed.

Tolerances, with the largest difference measured on the CPU (the two
frameworks sum f32 products in other orders; the reference's
``associative_scan`` and the port's doubling scan group the RG-LRU's
products differently; bf16 rounds at other places):

* ``rg_lru``, ``rg_lru_step`` and ``temporal_conv``: 1e-6 of the largest
  |entry| (measured 1.0e-7 for the scan, 3.4e-7 for its gradients, 8.0e-8
  for the step, 0 for the conv); bf16 y 2^-7 (measured 0);
* ``attend(window=)`` against the reference's ``attend``: f32 1e-5 of
  the largest |entry|, forward and each gradient (measured 2.0e-7 and
  3.4e-7); bf16 2^-6 of it, forward and each gradient (measured 5.7e-3
  and 5.5e-3: the reference rounds P to bf16 before P·V and runs its
  backward in bf16, the port's plain version keeps P and the backward in
  f32 and rounds the results);
* the model's loss: f32 rtol 1e-6 (measured 1.7e-7), bf16 rtol 1e-4
  (measured 1.1e-5);
* decode logits, every step, a share of the largest |logit|: f32 1e-5
  (measured 4.1e-7), bf16 2e-2 (measured 3.9e-3); decode states, a share
  of each field's largest entry: f32 1e-5 (measured 1.8e-7), bf16 caches
  and conv contexts 2^-6, the f32 RG-LRU state of a bf16 model 2e-2
  (measured 3.9e-3 at most); decode against the port's own
  teacher-forced forward 2e-2 of the largest |logit| (the reference's
  own bound, ``tests/test_models_smoke.py``; measured 2.5e-7 f32, 1.9e-3
  bf16);
* ``make_train_step``: loss and ``kkt_residual`` rtol 1e-5 (measured
  7.9e-8), parameters and SSCA ``lin`` 5e-5 of each leaf's largest
  |entry| (measured 6.6e-7);
* ``run_alg1``: ``comm`` and the ledger exact, the train cost rtol 1e-4
  (measured 9.3e-8), the weights 5e-5 absolute (measured 1.4e-7), the
  test accuracy within one token flip of the 744 predicted test tokens
  (measured equal);
* checkpoints and the numpy carriers: bit for bit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import io as jckpt
from repro.configs import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core import ssca as jssca
from repro.core.schedules import PowerLaw as JPowerLaw
from repro.data import partition as jpartition
from repro.fed import runtime as jruntime
from repro.fed.tasks import transformer_task as jtransformer_task
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import attention as jattention
from repro.models import rglru as jrglru
from repro.models.transformer import build_model as jbuild_model
from repro_torch import tree
from repro_torch.ckpt import io as ckpt
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.core import ssca
from repro_torch.core.schedules import PowerLaw
from repro_torch.fed import runtime
from repro_torch.fed.tasks import transformer_task
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve, steps, train
from repro_torch.models import attention, rglru
from repro_torch.models import transformer as tt

ARCH = "recurrentgemma-9b"
SMALL = dict(d_model=64, d_ff=128, vocab=128)
F32_LOGITS = 1e-5
BF16_LOGITS = 2e-2
FORWARD = 2e-2
STEP_LEAVES = 5e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _f32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, share):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=share * np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _setup(layers, activ="float32"):
    """(reference model, port model, reference params, port params, the
    reference's jitted decode step) at the reduced hybrid."""
    ct = dataclasses.replace(reduced(get_config(ARCH), layers=layers,
                                     **SMALL), activ_dtype=activ)
    cj = dataclasses.replace(jreduced(jget_config(ARCH), layers=layers,
                                      **SMALL), activ_dtype=activ)
    tm, jm = tt.build_model(ct), jbuild_model(cj)
    pt = tm.init(torch.Generator().manual_seed(0), device="cpu")
    pj = jax.tree.map(jnp.asarray, tt.params_to_numpy(pt))
    return jm, tm, pj, pt, jax.jit(jm.decode_step)


def _tokens(b, s, seed=1):
    return np.random.default_rng(seed).integers(0, SMALL["vocab"], (b, s)) \
        .astype(np.int32)


# --- the RG-LRU --------------------------------------------------------------

def _lru_inputs(b=2, s=37, d=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    r, i = (rng.uniform(0.05, 0.95, (b, s, d)).astype(np.float32)
            for _ in range(2))
    lam = rng.normal(0.0, 0.5, d).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32)
    return x, r, i, lam, h0


@pytest.mark.parametrize("with_h0", [False, True])
def test_rg_lru_and_its_gradient_match_reference(with_h0):
    """y and the last h, then the gradients of Σ c·y + Σ c'·h_last with
    respect to x, r, i, Λ (and h0) against ``jax.vjp``."""
    x, r, i, lam, h0 = _lru_inputs()
    rng = np.random.default_rng(9)
    cy = rng.standard_normal(x.shape).astype(np.float32)
    ch = rng.standard_normal(h0.shape).astype(np.float32)
    args = (x, r, i, lam) + ((h0,) if with_h0 else ())

    @jax.jit
    def ref(args, cot):
        out, vjp = jax.vjp(jrglru.rg_lru, *args)
        return out, vjp(cot)

    want, gwant = ref(tuple(map(jnp.asarray, args)),
                      (jnp.asarray(cy), jnp.asarray(ch)))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    got = rglru.rg_lru(*targs)
    assert got[0].dtype == torch.float32 and got[1].shape == (2, 8)
    for a, w in zip(got, want):
        _close(a, w, 1e-6)
    (torch.sum(got[0] * torch.as_tensor(cy))
     + torch.sum(got[1] * torch.as_tensor(ch))).backward()
    for a, w in zip(targs, gwant):
        _close(a.grad, w, 1e-6)


def test_rg_lru_under_vmap_and_in_bf16():
    """``torch.func.vmap`` over a leading dim equals the loop; bf16 inputs
    give bf16 y and an f32 state, as the reference's."""
    x, r, i, lam, h0 = (torch.as_tensor(a) for a in _lru_inputs(s=16))
    xs = torch.stack([x, 2 * x, -x])
    got_y, got_h = torch.func.vmap(
        lambda xx: rglru.rg_lru(xx, r, i, lam, h0))(xs)
    for n in range(3):
        y, h = rglru.rg_lru(xs[n], r, i, lam, h0)
        np.testing.assert_allclose(got_y[n].numpy(), y.numpy(), rtol=0,
                                   atol=1e-7)
        np.testing.assert_allclose(got_h[n].numpy(), h.numpy(), rtol=0,
                                   atol=1e-7)
    yb, hb = rglru.rg_lru(x.bfloat16(), r.bfloat16(), i.bfloat16(), lam, h0)
    assert yb.dtype == torch.bfloat16 and hb.dtype == torch.float32
    jy, jh = jax.jit(jrglru.rg_lru)(
        *(jnp.asarray(a.numpy(), jnp.bfloat16) for a in (x, r, i)),
        jnp.asarray(lam.numpy()), jnp.asarray(h0.numpy()))
    assert jy.dtype == jnp.bfloat16 and jh.dtype == jnp.float32
    _close(yb, jy, 2.0 ** -7)
    _close(hb, jh, 1e-6)


@pytest.mark.parametrize("with_state", [False, True])
def test_rg_lru_step_and_temporal_conv_match_reference(with_state):
    x, r, i, lam, h0 = _lru_inputs(s=6)
    want = jrglru.rg_lru_step(*map(jnp.asarray, (x[:, 0], r[:, 0], i[:, 0],
                                                 lam, h0)))
    got = rglru.rg_lru_step(*map(torch.as_tensor, (x[:, 0], r[:, 0],
                                                   i[:, 0], lam, h0)))
    for a, w in zip(got, want):
        _close(a, w, 1e-6)
    rng = np.random.default_rng(4)
    w = rng.standard_normal((4, 8)).astype(np.float32)
    state = rng.standard_normal((2, 3, 8)).astype(np.float32) \
        if with_state else None
    jy, js = jrglru.temporal_conv(jnp.asarray(x), jnp.asarray(w),
                                  None if state is None
                                  else jnp.asarray(state))
    ty, ts = rglru.temporal_conv(torch.as_tensor(x), torch.as_tensor(w),
                                 None if state is None
                                 else torch.as_tensor(state))
    assert ts.shape == (2, 3, 8)
    _close(ty, jy, 1e-6)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# --- banded attention ----------------------------------------------------------

ATTEND = [(dh, dt, w) for dh in (64, 256) for dt in ("float32", "bfloat16")
          for w in (5, 40)]


@pytest.mark.parametrize("dh,dtype,window", ATTEND,
                         ids=[f"dh{d}-{t}-w{w}" for d, t, w in ATTEND])
def test_attend_window_matches_reference(dh, dtype, window):
    """(B, S, H, Hkv) = (2, 24, 4, 2): the forward and the gradients
    of Σ c·o with respect to q, k and v against the reference's ``attend``
    and ``jax.vjp``, at a window inside S and one past it; the flash op's
    plain version forward and backward directly too."""
    rng = np.random.default_rng(dh + window)
    b, s, h, hkv = 2, 24, 4, 2
    q = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
            for _ in range(2))
    c = rng.standard_normal(q.shape).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    @jax.jit
    def ref(args, cot):
        out, vjp = jax.vjp(lambda *a: jattention.attend(
            *a, causal=True, window=window), *args)
        return out, vjp(cot)

    want, gwant = ref(tuple(jnp.asarray(a, jdt) for a in (q, k, v)),
                      jnp.asarray(c, jdt))
    tq, tk, tv = (torch.tensor(a).to(tdt).requires_grad_()
                  for a in (q, k, v))
    got = attention.attend(tq, tk, tv, window=window)
    assert got.dtype == tdt
    share = 1e-5 if dtype == "float32" else 2.0 ** -6
    _close(got, want, share)
    (got.float() * torch.as_tensor(c)).sum().backward()
    for a, w in zip((tq, tk, tv), gwant):
        assert a.grad.dtype == tdt
        _close(a.grad, w, share)
    plain_w = window if window < s else 0
    plain = fa.flash_attention_plain(tq.detach(), tk.detach(), tv.detach(),
                                     plain_w)
    assert torch.equal(plain, got.detach())
    grads = fa.flash_attention_backward_plain(
        tq.detach(), tk.detach(), tv.detach(),
        torch.as_tensor(c).to(tdt), plain_w)
    for a, w in zip(grads, (tq.grad, tk.grad, tv.grad)):
        assert torch.equal(a, w)


def test_flash_window_arguments():
    """A window of S or more is the causal case; a negative one raises;
    head dim 256 has a wgmma (bf16) and a tf32x3 (f32) instance; a window
    without causality raises (non-causal attention is ported:
    tests/test_torch_vlm_audio.py, tests/test_torch_flash_attention.py)."""
    rng = np.random.default_rng(0)
    q = torch.as_tensor(rng.standard_normal((1, 9, 2, 16)), dtype=torch.float32)
    k = torch.as_tensor(rng.standard_normal((1, 9, 1, 16)), dtype=torch.float32)
    causal = fa.flash_attention_bhsd(q, k, k, device="cpu")
    for w in (9, 100):
        assert torch.equal(fa.flash_attention_bhsd(q, k, k, window=w,
                                                   device="cpu"), causal)
    assert not torch.equal(fa.flash_attention_bhsd(q, k, k, window=3,
                                                   device="cpu"), causal)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention_bhsd(q, k, k, window=-1, device="cpu")
    assert 256 in fa.HEAD_DIMS["wgmma"] and 256 in fa.HEAD_DIMS["tf32x3"]
    assert fa.band_mask(4, 2).int().tolist() == [
        [1, 0, 0, 0], [1, 1, 0, 0], [0, 1, 1, 0], [0, 0, 1, 1]]
    with pytest.raises(ValueError, match="without causality"):
        attention.attend(q, k, k, causal=False, window=3)


# --- the model -------------------------------------------------------------------

def test_hybrid_parameter_tree_is_the_reference_one():
    """The port's tree has the reference's structure and shapes (the
    reference's init traced), and the numpy carriers move it and a
    decode state both ways bit for bit."""
    for layers in (3, 5):
        jm, tm, pj, pt, _ = _setup(layers)
        ref = jax.eval_shape(jm.init, jax.random.key(0))
        assert jax.tree.structure(ref) == jax.tree.structure(pj)
        for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(pj)):
            assert a.shape == b.shape and a.dtype == b.dtype
        assert ("tail" in pt) == (layers == 5)
        back = tt.params_from_numpy(tt.params_to_numpy(pt), "cpu")
        for a, b in zip(tree.leaves(back), tree.leaves(pt)):
            assert torch.equal(a, b)
    jm, tm, _, _, _ = _setup(5, "bfloat16")
    sj = jm.init_decode(2, 40)
    st = tm.init_decode(2, 40, device="cpu")
    assert st.kv_k.shape == sj.kv_k.shape == (1, 2, 16, 1, 16)
    assert st.rec_h.shape == sj.rec_h.shape == (4, 2, 64)
    assert st.rec_conv.shape == sj.rec_conv.shape == (4, 2, 3, 64)
    assert st.rec_conv.dtype == torch.bfloat16
    rng = np.random.default_rng(3)
    sj = sj._replace(**{f: jnp.asarray(rng.standard_normal(
        getattr(sj, f).shape), getattr(sj, f).dtype)
        for f in ("kv_k", "rec_h", "rec_conv")})
    carried = tt.decode_state_from_numpy(jax.tree.map(np.asarray, sj), "cpu")
    for got, want in zip(tt.decode_state_to_numpy(carried), sj):
        np.testing.assert_array_equal(got, _f32(want)
                                      if want.dtype == jnp.bfloat16
                                      else np.asarray(want))


LOSS = [(3, "float32"), (5, "float32"), (3, "bfloat16"), (5, "bfloat16")]


@pytest.mark.parametrize("layers,activ", LOSS,
                         ids=[f"L{n}-{a}" for n, a in LOSS])
def test_hybrid_loss_matches_reference(layers, activ):
    """S = 40 tokens, past the window of 16: the loss of both models."""
    jm, tm, pj, pt, _ = _setup(layers, activ)
    tok = _tokens(2, 40)
    want = float(jax.jit(jm.loss)(pj, {"tokens": jnp.asarray(tok)}))
    got = float(tm.loss(pt, {"tokens": torch.as_tensor(tok)}))
    np.testing.assert_allclose(got, want,
                               rtol=1e-6 if activ == "float32" else 1e-4)


def _state_close(got, want, activ):
    got = tt.decode_state_to_numpy(got)
    for f in tt.DecodeState._fields:
        a, b = getattr(got, f), _f32(getattr(want, f))
        assert a.shape == b.shape, f
        if f == "length":
            assert int(a) == int(b)
            continue
        if not b.size:
            continue
        tol = 1e-5 if activ == "float32" else \
            2.0 ** -6 if f in ("kv_k", "kv_v", "rec_conv") else 2e-2
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max(),
                                   err_msg=f)


DECODE = [(3, "float32"), (5, "float32"), (5, "bfloat16")]


@pytest.mark.parametrize("layers,activ", DECODE,
                         ids=[f"L{n}-{a}" for n, a in DECODE])
def test_hybrid_decode_past_the_window_matches_reference(layers, activ):
    """24 tokens through both decode steps at ``local_window`` 16 (the
    ring wraps): the logits every step and the final state; at step 18
    the reference's state carried across gives its next logits and
    state; and the port's decode against its own teacher-forced
    forward."""
    jm, tm, pj, pt, jstep = _setup(layers, activ)
    tok = _tokens(2, 24, seed=5)
    sj = jm.init_decode(2, 24)
    st = tm.init_decode(2, 24, device="cpu")
    share = F32_LOGITS if activ == "float32" else BF16_LOGITS
    got = []
    for t in range(24):
        x = tok[:, t:t + 1]
        if t == 18:
            carried = tt.decode_state_from_numpy(
                jax.tree.map(np.asarray, sj), "cpu")
            lc, sc = tm.decode_step(pt, carried, torch.as_tensor(x))
        lj, sj = jstep(pj, sj, jnp.asarray(x))
        lt, st = tm.decode_step(pt, st, torch.as_tensor(x))
        _close(lt, lj, share)
        if t == 18:
            _close(lc, lj, share)
            _state_close(sc, sj, activ)
        got.append(lt)
    _state_close(st, sj, activ)
    full = tm.forward(pt, {"tokens": torch.as_tensor(tok)})
    _close(torch.cat(got, dim=1), full, FORWARD)


def test_hybrid_serve_batch_tokens_match_reference():
    jm, tm, pj, pt, jstep = _setup(5)
    reqs = serve.synth_requests(3, tm.cfg, 12, 8, seed=2)
    jreqs = jserve.synth_requests(3, jm.cfg, 12, 8, seed=2)
    gen_j, _, _ = jserve.serve_batch(jm, pj, jreqs)
    gen_t, _, _ = serve.serve_batch(tm, pt, reqs)
    assert gen_t.shape == (3, 8) and gen_t.dtype == np.int32
    np.testing.assert_array_equal(gen_t, np.asarray(gen_j))


def test_hybrid_train_step_matches_reference():
    """Two Algorithm-1 steps of each side's ``make_train_step`` at 3
    layers from one point and one batch stream."""
    jm, tm, pj, pt, _ = _setup(3)
    hp = dict(tau=2.0, lam=0.0)
    fj = jax.jit(jsteps.make_train_step(jm, jssca.SSCAHyperParams(
        rho=JPowerLaw(0.9, 0.3), gamma=JPowerLaw(0.9, 0.35), **hp)))
    ft = steps.make_train_step(tm, ssca.SSCAHyperParams(
        rho=PowerLaw(0.9, 0.3), gamma=PowerLaw(0.9, 0.35), **hp))
    sj, st = jssca.init(pj, with_beta=False), ssca.init(pt, with_beta=False)
    stream_j = jtrain.batch_stream(jm.cfg, 4, 24)
    stream_t = train.batch_stream(tm.cfg, 4, 24, device="cpu")
    for _ in range(2):
        bj, bt = next(stream_j), next(stream_t)
        pj, sj, mj = fj(pj, sj, bj)
        pt, st, mt = ft(pt, st, bt)
        for k in ("loss", "kkt_residual"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-5)
        for a, b in zip(tree.leaves((pt, st.lin)),
                        jax.tree.leaves((pj, sj.lin))):
            _close(a, b, STEP_LEAVES)


def test_hybrid_checkpoint_with_tail_round_trips(tmp_path):
    """The 5-layer tree (blocks and tail) saved by the port reads back in
    the reference, and the reference's in the port, bit for bit."""
    _, _, pj, pt, _ = _setup(5)
    ckpt.save(tmp_path / "port", {"params": pt}, step=1)
    restored, meta = jckpt.restore(tmp_path / "port")
    assert any(k.startswith("params/tail/") for k in meta["keys"])
    for a, b in zip(tree.leaves(pt), jax.tree.leaves(restored["params"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jckpt.save(tmp_path / "ref", {"params": pj}, step=2)
    back, _ = ckpt.restore(tmp_path / "ref", device="cpu")
    for a, b in zip(tree.leaves(back["params"]), tree.leaves(pt)):
        assert torch.equal(a, b)


def test_hybrid_launchers_run(tmp_path, capsys):
    """``--arch recurrentgemma-9b`` through ``serve.main`` and
    ``train.main`` (reduced: 3 layers of width 256) on the CPU."""
    out = serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "2",
                      "--batch", "2", "--prompt-len", "4", "--max-new", "3"])
    assert out[0][0].shape == (2, 3)
    _, losses = train.main(["--arch", ARCH, "--device", "cpu", "--batch",
                            "2", "--seq", "16", "--steps", "2",
                            "--ckpt-dir", str(tmp_path), "--ckpt-every",
                            "2"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert (tmp_path / "step_2").is_dir()
    assert "served 2 requests" in capsys.readouterr().out


# --- the federated round ---------------------------------------------------------

def test_hybrid_run_alg1_secure_tracks_jax():
    """``transformer_task("recurrentgemma-9b")`` (3 layers, width 64, 4
    heads of 16 on 1 kv head, window 16, 32 tokens), 96 training and 24
    test documents over 4 iid clients, B = 4, 2 rounds, secure, fused,
    λ = 0, τ = 2, both sides from the reference's initial weights."""
    kw = dict(batch_size=4, rounds=2, eval_every=1, eval_samples=48, seed=1,
              tau=2.0, lam=0.0, fused=True, secure=True)
    jt = jtransformer_task(ARCH)
    data = jt.default_data(n_train=96, n_test=24, seed=0)
    part = jpartition.iid(96, 4, seed=0)
    p0 = jt.init_params(jax.random.key(3))
    pj, hj = jruntime.run_alg1(data, part, task=jt, params=p0, **kw)
    task = transformer_task(ARCH)
    assert task.cfg.family == "hybrid" and task.cfg.num_layers == 3
    assert (task.cfg.head_dim, task.cfg.local_window) == (16, 16)
    pt, ht = runtime.run_alg1(
        data, part, task=task, device="cpu",
        params=tt.params_from_numpy(jax.tree.map(np.asarray, p0), "cpu"),
        **kw)
    assert ht.comm == hj.comm and ht.rounds == hj.rounds == [1, 2]
    assert (ht.uplink_bytes_per_round, ht.downlink_bytes_per_round,
            ht.cum_uplink_bytes) == (hj.uplink_bytes_per_round,
                                     hj.downlink_bytes_per_round,
                                     hj.cum_uplink_bytes)
    np.testing.assert_allclose(ht.train_cost, hj.train_cost, rtol=1e-4)
    np.testing.assert_allclose(ht.test_accuracy, hj.test_accuracy, rtol=0,
                               atol=1 / 744 + 1e-6)
    for a, b in zip(tree.leaves(pt), jax.tree.leaves(pj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=5e-5)
