"""The port's RWKV-6 model (the ``ssm`` family) against the reference's.

Both sides take the same weights (the reference's init, carried across
with ``params_from_numpy``) and the same tokens and activations, made
from a seed with numpy.  Configurations: rwkv6-7b reduced to 2 layers of
width 32 (4 heads of 8), d_ff 128, vocab 64, and ``rwkv6_task(seq_len=16,
d_model=32, vocab=64)``.  The reference initialises the group norm's
scale ``ln_w`` and the bonus ``bonus`` to zero, so at its init no
gradient reaches the WKV scan; the tests draw both from a seeded normal
before carrying the weights across, so that the WKV forward and backward
are exercised.

Tolerances, with the largest difference measured on the CPU:

* f32 activations: ``time_mix`` and ``channel_mix`` 1e-5 of the largest
  output (measured 9.8e-7); logits 1e-5 absolute (measured 1.8e-7);
  ``loss_sum`` rtol 1e-6, its gradient 1e-6 absolute in every leaf
  (measured 3.0e-8, the WKV leaves 7.3e-10).  The reference's ``time_mix``
  runs ``wkv_chunked`` at a chunk of min(64, S), the port chunks of 16:
  the same function, other summation orders.
* bf16 activations: logits 2e-2 absolute on logits below 1.1 in size
  (measured 1.2e-3).  The two frameworks round to bf16 at other places.
* The reference's chunk of 64 overflows at a log-decay of −1.5 (ROADMAP
  queue 3): its ``time_mix`` gives NaN there, the port stays finite and
  within 1e-5 of the largest |o| of the token-by-token recurrence
  ``repro.kernels.ref.rwkv6_wkv_bh`` (measured 1.2e-7).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.fed.tasks.rwkv6 import rwkv6_task as jrwkv6_task
from repro.kernels import ref as jref
from repro.models import build_model as jbuild_model
from repro.models import rwkv6 as jrwkv6
from repro.models import transformer as jtransformer
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.fed.tasks import rwkv6_task
from repro_torch.models import build_model, rwkv6
from repro_torch.models import transformer as tt

KW = dict(layers=2, d_model=32, d_ff=128, vocab=64)


def _perturbed(params, seed=5):
    """The reference's tree with ``ln_w`` and ``bonus`` drawn from
    N(0, 0.5²) instead of zero."""
    rng = np.random.default_rng(seed)
    blocks = dict(params["blocks"])
    for name in ("ln_w", "bonus"):
        blocks[name] = jnp.asarray(rng.normal(0.0, 0.5, blocks[name].shape)
                                   .astype(np.float32))
    return {**params, "blocks": blocks}


def _pair(activ="float32"):
    cj = dataclasses.replace(jreduced(jget_config("rwkv6-7b"), **KW),
                             activ_dtype=activ)
    ct = dataclasses.replace(reduced(get_config("rwkv6-7b"), **KW),
                             activ_dtype=activ)
    pj = _perturbed(jbuild_model(cj).init(jax.random.key(0)))
    pt = tt.params_from_numpy(jax.tree.map(np.asarray, pj), "cpu")
    return jbuild_model(cj), build_model(ct), pj, pt


def _tokens(b, s, vocab=64, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)) \
        .astype(np.int32)


def _layer(pt, pj, i=0):
    """Layer i of both trees: the port's f32 tensors, the reference's."""
    return ({k: v[i] for k, v in pt["blocks"].items()},
            {k: v[i] for k, v in pj["blocks"].items()})


def test_leaf_order_is_the_reference_one():
    _, model, pj, pt = _pair()
    names = [str(p[-1].key) for p, _ in
             jax.tree_util.tree_flatten_with_path(pj)[0]]
    assert names == [
        "bonus", "ck", "cm_norm", "cmix_k", "cmix_r", "cr", "cv",
        "decay_base", "decay_w1", "decay_w2", "ln_b", "ln_w", "mix_g",
        "mix_k", "mix_r", "mix_v", "mix_w", "tm_norm", "wg", "wk", "wo",
        "wr", "wv", "embed", "final_norm"]
    assert [tuple(x.shape) for x in tree.leaves(pt)] == \
        [tuple(x.shape) for x in jax.tree.leaves(pj)]
    for a, b in zip(jax.tree.leaves(tt.params_to_numpy(pt)),
                    jax.tree.leaves(pj)):
        np.testing.assert_array_equal(a, np.asarray(b))
    # a fresh init: the reference's shapes, dtypes and constant leaves
    fresh = model.init(torch.Generator().manual_seed(0), device="cpu")
    ref = jbuild_model(jreduced(jget_config("rwkv6-7b"), **KW)).init(
        jax.random.key(0))
    assert [(tuple(x.shape), x.dtype) for x in tree.leaves(fresh)] == \
        [(tuple(x.shape), x.dtype) for x in tree.leaves(pt)]
    for name in ("mix_r", "cmix_k", "decay_base", "bonus", "ln_w", "ln_b",
                 "tm_norm", "cm_norm"):
        np.testing.assert_array_equal(fresh["blocks"][name].numpy(),
                                      np.asarray(ref["blocks"][name]))
    assert fresh["blocks"]["wr"].std() > 0.01


def test_full_width_parameter_count():
    full = dataclasses.replace(get_config("rwkv6-7b"), num_layers=2)
    blocks = sum(int(np.prod(s)) for s in tt._rwkv_shapes(full).values())
    n = 2 * blocks + (full.padded_vocab + 1) * full.d_model
    # the parameter tree holds final_norm, which param_count() leaves out
    assert n == 705_802_240 == full.param_count() + full.d_model
    assert tt._rwkv_shapes(full) == jtransformer._rwkv_shapes(full)


def test_group_norm_takes_the_population_variance():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 4, 8)).astype(np.float32) * 3 + 1
    w, b = (rng.standard_normal((4, 8)).astype(np.float32) for _ in range(2))
    got = rwkv6._group_norm(*map(torch.as_tensor, (x, w, b))).numpy()
    want = np.asarray(jrwkv6._group_norm(*map(jnp.asarray, (x, w, b))))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    mu = x.mean(-1, keepdims=True)
    pop = (x - mu) / np.sqrt(x.var(-1, keepdims=True) + 64e-5) * w + b
    np.testing.assert_allclose(got, pop, rtol=0, atol=1e-5)
    sample = (x - mu) / np.sqrt(x.var(-1, ddof=1, keepdims=True) + 64e-5)
    assert np.abs(got - (sample * w + b)).max() > 1e-2


@pytest.mark.parametrize("s", [16, 40, 64])
def test_time_mix_and_channel_mix_match_reference(s):
    _, _, pj, pt = _pair()
    lt, lj = _layer(pt, pj, 1)
    x = np.random.default_rng(3).standard_normal((2, s, 32)) \
        .astype(np.float32)
    state = jrwkv6.RWKVState(wkv=jnp.zeros((2, 4, 8, 8)),
                             shift=jnp.zeros((2, 32)))
    want, _ = jrwkv6.time_mix(lj, jnp.asarray(x), state, 4)
    got, new_state = rwkv6.time_mix(lt, torch.as_tensor(x), None, 4)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # the sequence path returns no WKV state, and the shift it carries on
    assert new_state.wkv is None
    assert torch.equal(new_state.shift, torch.as_tensor(x[:, -1]))
    want, _ = jrwkv6.channel_mix(lj, jnp.asarray(x), jnp.zeros((2, 32)))
    got, shift = rwkv6.channel_mix(lt, torch.as_tensor(x))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert torch.equal(shift, torch.as_tensor(x[:, -1]))


def test_chunk64_overflow_of_the_reference():
    """At a constant log-decay of −1.5 over S = 64 the reference's
    ``time_mix`` (``wkv_chunked`` at chunk 64: exp(−cumsum) reaches e^96)
    returns NaN; the port's stays finite, and its WKV agrees with the
    token-by-token recurrence."""
    b, s, h, dh = 1, 64, 2, 16
    rng = np.random.default_rng(4)
    r, k, v = (rng.standard_normal((b, s, h, dh)).astype(np.float32)
               for _ in range(3))
    u = rng.standard_normal((h, dh)).astype(np.float32)
    lw = np.full((b, s, h, dh), -1.5, np.float32)
    ref_o, _ = jrwkv6.wkv_chunked(
        *map(jnp.asarray, (r, k, v, np.exp(lw), u)),
        jnp.zeros((b, h, dh, dh)), chunk=64)
    assert np.isnan(np.asarray(ref_o)).any()
    from repro_torch.kernels import ops
    got = ops.rwkv6_wkv(*map(torch.as_tensor, (r, k, v, np.exp(lw), u)))
    got = got.numpy()
    want = np.asarray(jref.rwkv6_wkv_bh(
        *(jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, s, dh)
          for x in (r, k, v, lw)),
        jnp.broadcast_to(jnp.asarray(u)[None], (b, h, dh))
        .reshape(b * h, 1, dh))).reshape(b, h, s, dh).transpose(0, 2, 1, 3)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # through the whole time mix: decay_base large enough that every
    # log-decay sits at −exp(0.405) ≈ −1.5, with the LoRA silenced
    _, _, pj, pt = _pair()
    lt, lj = _layer(pt, pj)
    lj = {**lj, "decay_base": jnp.full((32,), np.log(1.5), jnp.float32),
          "decay_w2": jnp.zeros_like(lj["decay_w2"])}
    lt = {**lt, "decay_base": torch.full((32,), float(np.log(1.5))),
          "decay_w2": torch.zeros_like(lt["decay_w2"])}
    x = rng.standard_normal((1, 64, 32)).astype(np.float32)
    state = jrwkv6.RWKVState(wkv=jnp.zeros((1, 4, 8, 8)),
                             shift=jnp.zeros((1, 32)))
    ref_y, _ = jrwkv6.time_mix(lj, jnp.asarray(x), state, 4)
    assert np.isnan(np.asarray(ref_y)).any()
    assert torch.isfinite(
        rwkv6.time_mix(lt, torch.as_tensor(x), None, 4)[0]).all()


def test_forward_matches_reference_f32():
    jm, tm, pj, pt = _pair()
    tok = _tokens(2, 16)
    want = np.asarray(jm.forward(pj, {"tokens": jnp.asarray(tok)}))
    got, aux = tm.forward_with_aux(pt, {"tokens": torch.as_tensor(tok)})
    assert aux == [] and got.dtype == torch.float32
    assert got.shape == (2, 16, 256)              # the padded vocabulary
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_forward_matches_reference_bf16_activations():
    jm, tm, pj, pt = _pair(activ="bfloat16")
    tok = _tokens(2, 16)
    want = np.asarray(jm.forward(pj, {"tokens": jnp.asarray(tok)}))
    got = tm.forward(pt, {"tokens": torch.as_tensor(tok)}).numpy()
    assert np.abs(want).max() < 1.1
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)


def test_loss_sum_and_gradient_match_jax():
    jt = jrwkv6_task(seq_len=16, d_model=32, vocab=64)
    t = rwkv6_task(seq_len=16, d_model=32, vocab=64)
    pj = _perturbed(jt.init_params(jax.random.key(3)), seed=7)
    pt = tt.params_from_numpy(jax.tree.map(np.asarray, pj), "cpu")
    tok = _tokens(3, 16, seed=4)
    w = np.asarray([0.1, 0.25, 0.5], np.float32)
    jb = (jnp.asarray(tok), jnp.asarray(tok), jnp.asarray(w))
    tb = (torch.as_tensor(tok), torch.as_tensor(tok), torch.as_tensor(w))
    lj, gj = jax.value_and_grad(jt.loss_sum)(pj, jb)
    lt = t.loss_sum(pt, tb)
    gt = torch.func.grad(t.loss_sum)(pt, tb)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
    for a, b in zip(tree.leaves(gt), jax.tree.leaves(gj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    # the perturbation makes the WKV scan's inputs receive gradient
    for name in ("wr", "wk", "wv", "decay_w1", "bonus", "mix_w"):
        assert float(gt["blocks"][name].abs().max()) > 1e-7, name
    mj = jt.measure(pj, jb[0], jb[1], jb[0][:2], jb[1][:2])
    mt = t.measure(pt, tb[0], tb[1], tb[0][:2], tb[1][:2])
    np.testing.assert_allclose(float(mt["train_cost"]),
                               float(mj["train_cost"]), rtol=1e-6)
    assert float(mt["test_accuracy"]) == float(mj["test_accuracy"])


def test_at_the_reference_init_the_wkv_gets_no_gradient():
    """Why the tests perturb ``ln_w``: at the reference's init it is zero,
    the group norm scales the WKV readout by it, and r, k, v and the
    decay's weights get exactly zero gradient in the port as in JAX."""
    t = rwkv6_task(seq_len=16, d_model=32, vocab=64)
    pt = tt.params_from_numpy(jax.tree.map(
        np.asarray, jrwkv6_task(seq_len=16, d_model=32, vocab=64)
        .init_params(jax.random.key(3))), "cpu")
    tok = torch.as_tensor(_tokens(2, 16))
    g = torch.func.grad(t.loss_sum)(pt, (tok, tok, torch.ones(2)))
    for name in ("wr", "wk", "wv", "decay_w1", "decay_w2", "bonus"):
        assert not g["blocks"][name].any(), name
    assert g["blocks"]["ln_b"].any() and g["blocks"]["ck"].any()


def test_decode_and_carried_state_raise():
    # decode is ported (tests/test_torch_launch.py); what still raises: a
    # nonzero carried WKV state over S > 1 tokens (the WKV kernel starts
    # from zero, as the reference's Pallas kernel does) and decode of
    # more than one token
    _, _, _, pt = _pair()
    lt = {k: v[0] for k, v in pt["blocks"].items()}
    x = torch.zeros(1, 4, 32)
    shift = torch.zeros(1, 32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rwkv6.time_mix(lt, x, rwkv6.RWKVState(torch.ones(1, 4, 8, 8),
                                              shift), 4)
    with pytest.raises(ValueError, match="one token"):
        rwkv6.time_mix(lt, x, None, 4, decode=True)
    # a zero carried state runs the sequence path, as None does
    y0, _ = rwkv6.time_mix(lt, x + 1, rwkv6.RWKVState(
        torch.zeros(1, 4, 8, 8), shift), 4)
    assert torch.equal(y0, rwkv6.time_mix(lt, x + 1, None, 4)[0])
    y, sh = rwkv6.channel_mix(lt, x + 1, shift + 2)
    assert torch.equal(sh, x[:, -1] + 1) and y.shape == x.shape
