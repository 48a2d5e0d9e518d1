"""The vlm (phi-3-vision-4.2b) and audio (whisper-large-v3) families of
the port against the reference's: the parameter trees, the forward's
logits and loss, their gradients, whisper's ``precompute_cross``,
token-by-token decode, ``serve_batch``, ``make_train_step``, checkpoints
both ways, and the launchers.

Configurations: ``reduced(get_config(arch))``, the reference's smoke
variant: 2 layers of width 256, 4 heads of 64 (on 4 kv heads for the
vlm, whose published config has as many kv heads as heads; whisper's
too), vocabulary 512, f32; the vlm prepends 8 image tokens, whisper's
encoder has 2 layers over 16 frames.  Both sides start from one set of
weights, the port's seeded init carried to the reference as numpy, and
read the same numpy-seeded tokens, ``img_embeds`` and ``frame_embeds``.

Tolerances, with the largest difference measured on the CPU (the two
frameworks sum f32 products in other orders; in bf16 the port's plain
attention keeps P in f32 where the reference rounds it to bf16 before
P·V, and the two round at other places):

* logits: f32 1e-5 of the largest |logit| (measured 5.8e-7 vlm, 6.9e-7
  audio); the loss f32 rtol 1e-6 (measured 7.6e-8), bf16 rtol 1e-4
  (measured 1.3e-5);
* gradients of the loss, every leaf: 1e-5 of the leaf's largest |entry|
  (measured 1.2e-6);
* ``precompute_cross``'s K and V: 1e-5 of the largest |entry| (measured
  5.6e-7);
* 8 decode steps, every step's logits: 1e-5 of the largest |logit|
  (measured 7.2e-7); the final state 1e-5 of each field's largest entry
  (measured 7.6e-7); decode against the port's own teacher-forced
  forward 2e-2 of the largest |logit| (the reference's own bound,
  ``tests/test_models_smoke.py``; measured 6.5e-7);
* ``serve_batch`` tokens: equal;
* ``make_train_step``: loss and ``kkt_residual`` rtol 1e-5 (measured
  1.5e-7), parameters and SSCA ``lin`` 5e-5 of each leaf's largest
  |entry| (measured 1.4e-6);
* checkpoints and the numpy carriers: bit for bit.

Its time alone: 25–37 s by pytest's own clock over three runs, the
slowest call 6.0 s by ``--durations``.
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
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models.transformer import build_model as jbuild_model
from repro_torch import tree
from repro_torch.ckpt import io as ckpt
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.core import ssca
from repro_torch.core.schedules import PowerLaw
from repro_torch.fed.tasks import transformer_task
from repro_torch.launch import serve, steps, train
from repro_torch.models import transformer as tt

VLM, AUDIO = "phi-3-vision-4.2b", "whisper-large-v3"
ARCHS = (VLM, AUDIO)
LOGITS = 1e-5
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
def _setup(arch, activ="float32"):
    """(reference model, port model, reference params, port params) at
    the reduced config, from the port's seeded init."""
    ct = dataclasses.replace(reduced(get_config(arch)), activ_dtype=activ)
    cj = dataclasses.replace(jreduced(jget_config(arch)), activ_dtype=activ)
    tm, jm = tt.build_model(ct), jbuild_model(cj)
    pt = tm.init(torch.Generator().manual_seed(0), device="cpu")
    pj = jax.tree.map(jnp.asarray, tt.params_to_numpy(pt))
    return jm, tm, pj, pt


def _batch(cfg, b, s, seed=1):
    """numpy tokens (B, S) and the family's stub embeddings."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))
           .astype(np.int32)}
    if cfg.family == "vlm":
        out["img_embeds"] = rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["frame_embeds"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.as_tensor(v) for k, v in batch.items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_tree_and_decode_state_are_the_reference_ones(arch):
    """The port's tree has the reference's structure, shapes and dtypes
    (the reference's init traced), the numpy carriers move it both ways
    bit for bit, and ``init_decode`` gives the reference's fields."""
    jm, tm, pj, pt = _setup(arch)
    ref = jax.eval_shape(jm.init, jax.random.key(0))
    assert jax.tree.structure(ref) == jax.tree.structure(pj)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(pj)):
        assert a.shape == b.shape and a.dtype == b.dtype
    back = tt.params_from_numpy(tt.params_to_numpy(pt), "cpu")
    for a, b in zip(tree.leaves(back), tree.leaves(pt)):
        assert torch.equal(a, b)
    # zero norms and biases, drawn matrices, as the reference's init
    enc = pt.get("encoder", {})
    assert not any(float(w.abs().max()) for k, w in
                   [*pt["blocks"].items(), *enc.items()]
                   if k.endswith("_norm") or k.startswith("b_"))
    sj = jm.init_decode(2, 20)
    st = tm.init_decode(2, 20, device="cpu")
    for f in tt.DecodeState._fields:
        assert tuple(getattr(st, f).shape) == tuple(getattr(sj, f).shape), f
    assert (st.cross_k.numel() > 0) == (arch == AUDIO)


@pytest.mark.parametrize("arch,activ", [(a, t) for a in ARCHS
                                        for t in ("float32", "bfloat16")])
def test_logits_and_loss_match_reference(arch, activ):
    jm, tm, pj, pt = _setup(arch, activ)
    bj, bt = _both(_batch(tm.cfg, 2, 12))
    lj = jax.jit(jm.loss)(pj, bj)
    lt = tm.loss(pt, bt)
    np.testing.assert_allclose(float(lt), float(lj),
                               rtol=1e-6 if activ == "float32" else 1e-4)
    if activ == "float32":
        got = tm.forward(pt, bt)
        assert got.shape == (2, 12, tm.cfg.padded_vocab)
        _close(got, jax.jit(jm.forward)(pj, bj), LOGITS)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_match_reference(arch):
    """The gradient of the loss with respect to every leaf (the image
    projector and the encoder too) against ``jax.grad``."""
    jm, tm, pj, pt = _setup(arch)
    bj, bt = _both(_batch(tm.cfg, 2, 12, seed=2))
    gj = jax.jit(jax.grad(jm.loss))(pj, bj)
    params = tree.map(lambda w: w.detach().requires_grad_(), pt)
    tm.loss(params, bt).backward()
    for a, b in zip(tree.leaves(params), jax.tree.leaves(gj)):
        _close(a.grad, b, 1e-5)


def test_precompute_cross_matches_reference():
    jm, tm, pj, pt = _setup(AUDIO)
    bj, bt = _both(_batch(tm.cfg, 2, 4, seed=3))
    sj = jm.precompute_cross(pj, bj, jm.init_decode(2, 8))
    st = tm.precompute_cross(pt, bt, tm.init_decode(2, 8, device="cpu"))
    for f in ("cross_k", "cross_v"):
        assert getattr(st, f).shape == (2, 2, 16, 4, 64)
        _close(getattr(st, f), getattr(sj, f), 1e-5)
    with pytest.raises(ValueError, match="cross-attention"):
        _setup(VLM)[1].precompute_cross(pt, bt, st)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference_and_the_forward(arch):
    """8 tokens through both decode steps (whisper after
    ``precompute_cross`` of the same frames): the logits every step and
    the final state; then the port's decode against its own
    teacher-forced forward (the vlm's over the text alone: the dense
    model on the same blocks, as the reference serves no image)."""
    jm, tm, pj, pt = _setup(arch)
    batch = _batch(tm.cfg, 2, 8, seed=4)
    bj, bt = _both(batch)
    sj, st = jm.init_decode(2, 8), tm.init_decode(2, 8, device="cpu")
    if arch == AUDIO:
        sj = jm.precompute_cross(pj, bj, sj)
        st = tm.precompute_cross(pt, bt, st)
    jstep = jax.jit(jm.decode_step)
    got = []
    for t in range(8):
        lj, sj = jstep(pj, sj, bj["tokens"][:, t:t + 1])
        lt, st = tm.decode_step(pt, st, bt["tokens"][:, t:t + 1])
        _close(lt, lj, LOGITS)
        got.append(lt)
    for f in tt.DecodeState._fields:
        a, b = tt.decode_state_to_numpy(st), jax.tree.map(np.asarray, sj)
        if getattr(b, f).size:
            _close(getattr(a, f), getattr(b, f), 1e-5)
    forward = tm if arch == AUDIO else tt.build_model(
        dataclasses.replace(tm.cfg, family="dense"))
    full = forward.forward(pt, {k: v for k, v in bt.items()
                                if k != "img_embeds"})
    _close(torch.cat(got, dim=1), full, FORWARD)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_batch_tokens_match_reference(arch):
    jm, tm, pj, pt = _setup(arch)
    reqs = serve.synth_requests(3, tm.cfg, 6, 5, seed=2)
    jreqs = jserve.synth_requests(3, jm.cfg, 6, 5, seed=2)
    frames = _batch(tm.cfg, 3, 1, seed=5).get("frame_embeds")
    gen_j, _, _ = jserve.serve_batch(
        jm, pj, jreqs, frame_embeds=None if frames is None
        else jnp.asarray(frames))
    gen_t, _, _ = serve.serve_batch(
        tm, pt, reqs, frame_embeds=None if frames is None
        else torch.as_tensor(frames))
    assert gen_t.shape == (3, 5) and gen_t.dtype == np.int32
    np.testing.assert_array_equal(gen_t, np.asarray(gen_j))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One Algorithm-1 step of each side's ``make_train_step`` from one
    point on one batch (B = 4, S = 12 text tokens; the vlm's 8 image
    tokens before them)."""
    jm, tm, pj, pt = _setup(arch)
    hp = dict(tau=2.0, lam=0.0)
    fj = jax.jit(jsteps.make_train_step(jm, jssca.SSCAHyperParams(
        rho=JPowerLaw(0.9, 0.3), gamma=JPowerLaw(0.9, 0.35), **hp)))
    ft = steps.make_train_step(tm, ssca.SSCAHyperParams(
        rho=PowerLaw(0.9, 0.3), gamma=PowerLaw(0.9, 0.35), **hp))
    bj, bt = _both(_batch(tm.cfg, 4, 12, seed=6))
    qj, sj, mj = fj(pj, jssca.init(pj, with_beta=False), bj)
    qt, st, mt = ft(pt, ssca.init(pt, with_beta=False), bt)
    for k in ("loss", "kkt_residual"):
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-5)
    for a, b in zip(tree.leaves((qt, st.lin)), jax.tree.leaves((qj, sj.lin))):
        _close(a, b, STEP_LEAVES)


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_round_trips_both_ways(arch, tmp_path):
    """The port's tree (the nested encoder, the image projector) saved by
    the port reads back in the reference, and the reference's in the
    port, bit for bit."""
    _, _, pj, pt = _setup(arch)
    ckpt.save(tmp_path / "port", {"params": pt}, step=1)
    restored, meta = jckpt.restore(tmp_path / "port")
    extra = "params/encoder/" if arch == AUDIO else "params/img_proj"
    assert any(k.startswith(extra) for k in meta["keys"])
    for a, b in zip(tree.leaves(pt), jax.tree.leaves(restored["params"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jckpt.save(tmp_path / "ref", {"params": pj}, step=2)
    back, _ = ckpt.restore(tmp_path / "ref", device="cpu")
    for a, b in zip(tree.leaves(back["params"]), tree.leaves(pt)):
        assert torch.equal(a, b)


def test_batch_stream_stub_embeddings_and_short_seq():
    """The vlm's rows are cut to the text beside (B, 8, 256) image
    embeddings, the tokens the reference's numpy stream; whisper's come
    with (B, 16, 256) frames; a vlm seq below num_image_tokens + 2 raises
    before any step (the reference's NaN loss), and so does LMTask on
    both families."""
    from repro.launch import train as jtrain
    for arch in ARCHS:
        cfg = reduced(get_config(arch))
        got = next(train.batch_stream(cfg, 3, 12, seed=4, device="cpu"))
        want = next(jtrain.batch_stream(jreduced(jget_config(arch)), 3, 12,
                                        seed=4))
        assert set(got) == set(want)
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      np.asarray(want["tokens"]))
        for k in set(got) - {"tokens"}:
            assert got[k].shape == want[k].shape and got[k].dtype == \
                torch.float32
        with pytest.raises(NotImplementedError, match="stub"):
            transformer_task(arch)
    vlm = reduced(get_config(VLM))
    assert train.min_seq(vlm) == 10 and train.min_seq(get_config(VLM)) == 578
    with pytest.raises(ValueError, match="at least 578"):
        train.batch_stream(get_config(VLM), 8, 128, device="cpu")
    assert next(train.batch_stream(vlm, 2, 10, device="cpu"))[
        "tokens"].shape == (2, 2)


def test_launchers_run(tmp_path, capsys):
    """``serve.main`` and ``train.main`` (2 steps and a checkpoint) at
    both reduced configs on the CPU."""
    for arch in ARCHS:
        out = serve.main(["--arch", arch, "--device", "cpu", "--requests",
                          "2", "--batch", "2", "--prompt-len", "4",
                          "--max-new", "3"])
        assert out[0][0].shape == (2, 3)
        _, losses = train.main(["--arch", arch, "--device", "cpu", "--batch",
                                "2", "--seq", "12", "--steps", "2",
                                "--ckpt-dir", str(tmp_path / arch),
                                "--ckpt-every", "2"])
        assert len(losses) == 2 and all(np.isfinite(losses))
        assert (tmp_path / arch / "step_2").is_dir()
    assert capsys.readouterr().out.count("served 2 requests") == 2
