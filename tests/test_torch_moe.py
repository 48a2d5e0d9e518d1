"""The moe family (qwen3-moe-235b-a22b, llama4-maverick-400b-a17b) of the
port against the reference's: the MoE layer (``models/moe.py``: routing,
capacity, dispatch, combine, the load-balance loss, its vjp and its
vmap), the parameter tree of both layouts, the loss, token-by-token
decode, decode against the forward at ``capacity_factor=8.0``,
``make_train_step`` on bf16 parameters, ``serve_batch``, checkpoints of
bf16 trees, ``params_from_numpy``, and ``run_alg1`` on both
``transformer_task``s.  About 35 s on one CPU worker (``--durations``).

Configurations: ``reduced(get_config(arch), d_model=64, d_ff=128,
vocab=128)``: 2 layers, 4 query heads of 16 (on 4 kv heads), 4 experts,
top-2 for qwen3-moe (every layer MoE) and top-1 with the shared expert
for llama4-maverick (one super-block: a dense block, then a MoE block);
f32, and bf16 parameters and activations, the published configs'
dtypes.  Both sides start from one set of weights: the port's seeded
init carried to the reference as numpy.  Inputs are drawn with numpy
from a seed.

Tolerances, with the largest difference measured on the CPU (the two
frameworks sum f32 products in other orders; bf16 rounds at other
places: the reference scatter-adds a token's k weighted rows in bf16,
the port sums them in one product's f32 accumulator):

* ``moe_ffn``: the chosen experts, their positions within the expert and
  ``keep`` equal; gates and probs 1e-6 absolute (measured 1.8e-7); y
  and every vjp 1e-5 of the largest |entry| (measured 4.0e-7), the aux
  loss rtol 1e-5 (measured 1.2e-7); the dropped share rtol 1e-6;
* the loss: f32 rtol 1e-6 (measured 8.6e-8), bf16 rtol 1e-4 (measured
  1.2e-5), the hybrid's bounds;
* decode logits against the reference's, every step, a share of the
  largest |logit|: f32 1e-5 (measured 4.1e-7), bf16 2e-2 (measured
  4.9e-3); caches f32 1e-5 (measured 3.2e-7), bf16 2^-6 (measured
  5.3e-3);
* decode against the port's own forward at ``capacity_factor=8.0`` (no
  drops: decode is one token an example, which never overflows C):
  2e-2 of the largest |logit|, the reference's own bound
  (``tests/test_models_smoke.py``);
* ``make_train_step``, f32: loss and ``kkt_residual`` rtol 1e-5
  (measured 2.6e-7), the parameters and ``lin`` 5e-5 of each leaf's
  largest |entry| (measured 5.8e-7), two steps; bf16 parameters: one
  step, f32 outputs as the reference's, the loss rtol 1e-4 (the bf16
  loss bound; measured 1.7e-5), ``kkt_residual`` rtol 1e-3 (measured
  9.0e-5; the dense llama3-8b's bf16 gradient norm differs from the
  reference's by 2.6e-4: each side rounds the bf16 backward at other
  places, about 1e-2 of a leaf's norm), the parameters and ``lin`` 2^-6
  of each leaf's largest |entry| (measured 1.1e-2); the unfused update
  on unit gradients 1e-6 of it (measured 0);
* ``run_alg1``: ``comm`` and the ledger exact, the train cost rtol 1e-4
  (measured 9.5e-8), the weights 5e-5 absolute (measured 1.6e-7), the
  test accuracy within one token flip of the 744 predicted (measured
  equal);
* ``serve_batch`` tokens equal; checkpoints and the numpy carriers bit
  for bit.
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
from repro.models import moe as jmoe
from repro.models.transformer import build_model as jbuild_model
from repro_torch import tree
from repro_torch.ckpt import io as ckpt
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.core import ssca
from repro_torch.core.schedules import PowerLaw
from repro_torch.fed import runtime
from repro_torch.fed.tasks import transformer_task
from repro_torch.launch import serve, steps, train
from repro_torch.models import moe
from repro_torch.models import transformer as tt

QWEN = "qwen3-moe-235b-a22b"
LLAMA4 = "llama4-maverick-400b-a17b"
ARCHS = (QWEN, LLAMA4)
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


def _cfgs(arch, dtype="float32", **over):
    """The reduced config on both sides, parameters and activations in
    ``dtype``."""
    kw = dict(param_dtype=dtype, activ_dtype=dtype, **over)
    return (dataclasses.replace(reduced(get_config(arch), **SMALL), **kw),
            dataclasses.replace(jreduced(jget_config(arch), **SMALL), **kw))


@functools.lru_cache(maxsize=None)
def _setup(arch, dtype="float32"):
    """(reference model, port model, reference params, port params, the
    reference's jitted decode step)."""
    ct, cj = _cfgs(arch, dtype)
    tm, jm = tt.build_model(ct), jbuild_model(cj)
    pt = tm.init(torch.Generator().manual_seed(0), device="cpu")
    pj = jax.tree.map(lambda a: jnp.asarray(a, cj.pdtype),
                      tt.params_to_numpy(pt))
    return jm, tm, pj, pt, jax.jit(jm.decode_step)


def _tokens(b, s, seed=1):
    return np.random.default_rng(seed).integers(0, SMALL["vocab"], (b, s)) \
        .astype(np.int32)


# --- the MoE layer ---------------------------------------------------------

B, S, D, E, FF, K, CF = 2, 24, 16, 4, 8, 2, 0.5


@functools.lru_cache(maxsize=None)
def _layer_inputs(shared, seed=0):
    """x (B, S, D) and the layer's parameters as numpy, at a capacity
    factor that drops assignments (C = 7 of 12 on average)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    p = {"router": rng.standard_normal((D, E)),
         "wg": 0.3 * rng.standard_normal((E, D, FF)),
         "wu": 0.3 * rng.standard_normal((E, D, FF)),
         "wd": 0.3 * rng.standard_normal((E, FF, D))}
    if shared:
        p.update({"shared_wg": 0.3 * rng.standard_normal((D, FF)),
                  "shared_wu": 0.3 * rng.standard_normal((D, FF)),
                  "shared_wd": 0.3 * rng.standard_normal((FF, D))})
    return x, {k: v.astype(np.float32) for k, v in p.items()}


def _reference_positions(idx, cap):
    """The reference's dispatch (``repro.models.moe.moe_ffn``'s
    ``dispatch_one``: stable argsort by expert, searchsorted) mapped back
    to the flat (token, slot) order: (expert, position, keep)."""
    def one(idx_e):
        flat_e = idx_e.reshape(-1)
        order = jnp.argsort(flat_e)
        e_sorted = flat_e[order]
        pos = jnp.arange(flat_e.size) - jnp.searchsorted(
            e_sorted, e_sorted, side="left")
        return flat_e, jnp.zeros_like(pos).at[order].set(pos)
    flat_e, pos = jax.vmap(one)(idx)
    return np.asarray(flat_e), np.asarray(pos), np.asarray(pos < cap)


@pytest.mark.parametrize("shared", [False, True], ids=["routed", "shared"])
def test_moe_ffn_matches_reference_where_it_drops(shared):
    """Routing, the kept set, y, the aux loss, the dropped share and the
    vjp of Σ c·y + c'·aux against ``jax.vjp`` at a shape that drops."""
    x, p = _layer_inputs(shared)
    kw = dict(num_experts=E, k=K, capacity_factor=CF)
    cap = moe.capacity_for(S, K, E, CF)
    assert cap == jmoe.capacity_for(S, K, E, CF) == 7
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    gj, ij, pj = jmoe.route(jnp.asarray(x), jp["router"], K)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    gt, it, pt = moe.route(tx, tp["router"], K)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    _close(gt, gj, 1e-6)
    _close(pt, pj, 1e-6)
    got = [a.numpy() for a in moe.positions(it, E, cap)]
    for a, b in zip(got, _reference_positions(ij, cap)):
        np.testing.assert_array_equal(a, b)
    assert not got[2].all()

    rng = np.random.default_rng(7)
    cy = rng.standard_normal(x.shape).astype(np.float32)

    @jax.jit
    def ref(x, p):
        def f(x, p):
            out = jmoe.moe_ffn(x, p, **kw)
            return out.y, out.aux_loss
        (y, aux), vjp = jax.vjp(f, x, p)
        dropped = jmoe.moe_ffn(x, p, **kw).dropped_frac
        return y, aux, dropped, vjp((jnp.asarray(cy), jnp.float32(0.7)))

    yj, auxj, dj, (gxj, gpj) = ref(jnp.asarray(x), jp)
    out = moe.moe_ffn(tx, tp, **kw)
    assert isinstance(out, moe.MoEOutput) and out.y.dtype == torch.float32
    assert float(out.dropped_frac) > 0
    np.testing.assert_allclose(float(out.dropped_frac), float(dj), rtol=1e-6)
    _close(out.y, yj, 1e-5)
    np.testing.assert_allclose(float(out.aux_loss.detach()), float(auxj),
                               rtol=1e-5)
    (torch.sum(out.y * torch.as_tensor(cy)) + 0.7 * out.aux_loss).backward()
    _close(tx.grad, gxj, 1e-5)
    for k in p:
        _close(tp[k].grad, gpj[k], 1e-5)


def test_moe_ffn_under_vmap_of_vjp_equals_the_loop():
    """``torch.func.vmap`` over a client axis of the gradient of Σ y +
    aux (the engine's client upload) equals one call a client."""
    x, p = _layer_inputs(True)
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    xs = torch.as_tensor(np.stack([x, -x, 2 * x]))

    def loss(xx, pp):
        out = moe.moe_ffn(xx, pp, num_experts=E, k=K, capacity_factor=CF)
        return out.y.sum() + out.aux_loss

    batched = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)),
                              in_dims=(0, None))(xs, tp)
    for n in range(3):
        one = torch.func.grad(loss, argnums=(0, 1))(xs[n], tp)
        for a, b in zip(tree.leaves(batched), tree.leaves(one)):
            np.testing.assert_allclose(a[n].numpy(), b.numpy(), rtol=0,
                                       atol=1e-6)


# --- the model ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_moe_parameter_tree_is_the_reference_one(arch):
    """Both dtypes: the reference's init traced gives the port's tree
    (names, shapes, dtypes); the super-block's ``d_`` and ``m_`` leaves
    stack one unit; the decode state has a cache a layer."""
    for dtype in ("float32", "bfloat16"):
        jm, tm, pj, pt, _ = _setup(arch, dtype)
        ref = jax.eval_shape(jm.init, jax.random.key(0))
        assert jax.tree.structure(ref) == jax.tree.structure(pj)
        for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(pj)):
            assert a.shape == b.shape and a.dtype == b.dtype
        assert all(w.dtype == tm.cfg.pdtype for w in tree.leaves(pt))
    blocks = pt["blocks"]
    if arch == LLAMA4:
        assert blocks["m_swg"].shape == (1, 64, 128)
        assert blocks["d_wg"].shape == blocks["m_swg"].shape
        assert blocks["m_ewg"].shape == (1, 4, 64, 128)
    else:
        assert blocks["ewd"].shape == (2, 4, 128, 64)
        assert "swg" not in blocks and "wg" not in blocks
    st, sj = tm.init_decode(2, 24, device="cpu"), jm.init_decode(2, 24)
    assert st.kv_k.shape == sj.kv_k.shape == (2, 2, 24, 4, 16)
    assert st.kv_k.dtype == torch.bfloat16


LOSS = [(a, d) for a in ARCHS for d in ("float32", "bfloat16")]


@pytest.mark.parametrize("arch,dtype", LOSS,
                         ids=[f"{a[:6]}-{d}" for a, d in LOSS])
def test_moe_loss_matches_reference(arch, dtype):
    """S = 40: the loss (cross-entropy and the weighted aux) and the
    summed aux of both models; the port's dropped shares in [0, 1)."""
    jm, tm, pj, pt, _ = _setup(arch, dtype)
    tok = _tokens(2, 40)
    want = float(jax.jit(jm.loss)(pj, {"tokens": jnp.asarray(tok)}))
    got = float(tm.loss(pt, {"tokens": torch.as_tensor(tok)}))
    rtol = 1e-6 if dtype == "float32" else 1e-4
    np.testing.assert_allclose(got, want, rtol=rtol)
    _, aux_j = jax.jit(jm.forward_with_aux)(pj, {"tokens": jnp.asarray(tok)})
    dropped = []
    logits, aux_t = tm.forward_with_aux(pt, {"tokens": torch.as_tensor(tok)},
                                        dropped=dropped)
    assert logits.dtype == torch.float32 and aux_t[0].dtype == torch.float32
    np.testing.assert_allclose(float(aux_t[0]), float(aux_j[0]), rtol=rtol)
    assert len(dropped) == (2 if arch == QWEN else 1)
    assert all(0 <= float(d) < 1 for d in dropped)


DECODE = [(QWEN, "float32"), (LLAMA4, "float32"), (LLAMA4, "bfloat16")]


@pytest.mark.parametrize("arch,dtype", DECODE,
                         ids=[f"{a[:6]}-{d}" for a, d in DECODE])
def test_moe_decode_matches_reference(arch, dtype):
    """20 tokens through both decode steps: the logits every step and
    the final caches."""
    jm, tm, pj, pt, jstep = _setup(arch, dtype)
    tok = _tokens(2, 20, seed=5)
    sj = jm.init_decode(2, 20)
    st = tm.init_decode(2, 20, device="cpu")
    share = F32_LOGITS if dtype == "float32" else BF16_LOGITS
    for t in range(20):
        x = tok[:, t:t + 1]
        lj, sj = jstep(pj, sj, jnp.asarray(x))
        lt, st = tm.decode_step(pt, st, torch.as_tensor(x))
        _close(lt, lj, share)
    assert int(st.length) == int(sj.length) == 20
    for f in ("kv_k", "kv_v"):
        assert getattr(st, f).dtype == tm.cfg.adtype
        _close(getattr(st, f), getattr(sj, f),
               1e-5 if dtype == "float32" else 2.0 ** -6)


DROPLESS = [(a, d) for a in ARCHS for d in ("float32", "bfloat16")]


def _routes(monkeypatch, forced=None):
    """Wrap ``moe.route`` to record each call's own expert ids and
    top-(k + 1) probabilities; with ``forced`` (one id tensor a call, in
    order) each call routes to those experts instead, its gates
    renormalised from its own probabilities there.  Returns the list of
    records."""
    calls, route, ids = [], moe.route, iter(forced or ())

    def wrapped(x, w_router, k):
        gates, idx, probs = route(x, w_router, k)
        calls.append((idx, torch.topk(probs, k + 1, dim=-1).values))
        if forced is not None:
            idx = next(ids)
            gates = torch.gather(probs, -1, idx)
            gates = gates / torch.clamp(gates.sum(-1, keepdim=True),
                                        min=1e-9)
        return gates, idx, probs
    monkeypatch.setattr(moe, "route", wrapped)
    return calls


@pytest.mark.parametrize("arch,dtype", DROPLESS,
                         ids=[f"{a[:6]}-{d}" for a, d in DROPLESS])
def test_moe_decode_equals_the_dropless_forward(arch, dtype, monkeypatch):
    """The reference's own check (``tests/test_models_smoke.py``, f32):
    decode against the teacher-forced forward of the same weights at
    ``capacity_factor=8.0``, where the forward drops nothing (at the
    config's 1.25 the forward drops and decode never does).  In bf16 the
    two paths round the router's input at other places, and where a
    token's k-th and (k + 1)-th expert probabilities lie within that
    rounding each may pick another expert (measured: one token of
    llama4's 32, at a relative margin of 1.8e-3; at full width on the
    card tens of tokens, and each perturbs the later layers through
    attention).  So the forward routes to the experts decode chose, and
    its own choice may differ only within 2^-4 of a tie (``chip_smoke.
    py``'s ROUTE_TIE); in f32 it never differs."""
    _, tm, _, pt, _ = _setup(arch, dtype)
    tok = torch.as_tensor(_tokens(2, 16, seed=6))
    calls = _routes(monkeypatch)
    st = tm.init_decode(2, 16, device="cpu")
    got = []
    for t in range(16):
        lt, st = tm.decode_step(pt, st, tok[:, t:t + 1])
        got.append(lt)
    n = len(calls) // 16
    forced = [torch.cat([c[0] for c in calls[layer::n]], dim=1)
              for layer in range(n)]
    wide = tt.build_model(dataclasses.replace(tm.cfg, capacity_factor=8.0))
    own = _routes(monkeypatch, forced)
    dropped = []
    full = wide.forward_with_aux(pt, {"tokens": tok}, dropped=dropped)[0]
    assert all(float(d) == 0.0 for d in dropped)
    k = tm.cfg.experts_per_token
    apart = 0
    for (idx, top), want in zip(own, forced):
        flip = (idx.sort(-1).values != want.sort(-1).values).any(-1)
        margin = (top[..., k - 1] - top[..., k]) / top[..., k - 1]
        assert bool((margin[flip] <= 2.0 ** -4).all())
        apart += int(flip.sum())
    assert apart <= (0 if dtype == "float32" else 2)
    _close(torch.cat(got, dim=1), full, FORWARD)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_train_step_matches_reference(arch):
    """Two Algorithm-1 steps of each side's ``make_train_step`` from one
    point and one batch stream, f32."""
    jm, tm, pj, pt, _ = _setup(arch)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_bf16_train_step_returns_f32_as_the_reference(arch):
    """bf16 parameters and a bf16 SSCA state into one ``make_train_step``:
    f32 parameters and ``lin`` come out on both sides (the fused
    update's flat f32 buffer here, the reference's f32 ρ and γ there),
    and the unfused update and FedSGD's step promote the same way."""
    jm, tm, pj, pt, _ = _setup(arch, "bfloat16")
    hp = dict(tau=2.0, lam=0.0)
    fj = jax.jit(jsteps.make_train_step(jm, jssca.SSCAHyperParams(
        rho=JPowerLaw(0.9, 0.3), gamma=JPowerLaw(0.9, 0.35), **hp)))
    ft = steps.make_train_step(tm, ssca.SSCAHyperParams(
        rho=PowerLaw(0.9, 0.3), gamma=PowerLaw(0.9, 0.35), **hp))
    bj = next(jtrain.batch_stream(jm.cfg, 4, 24))
    bt = next(train.batch_stream(tm.cfg, 4, 24, device="cpu"))
    pj2, sj2, mj = fj(pj, jssca.init(pj, with_beta=False), bj)
    pt2, st2, mt = ft(pt, ssca.init(pt, with_beta=False), bt)
    assert {str(a.dtype) for a in jax.tree.leaves((pj2, sj2.lin))} \
        == {"float32"}
    assert {a.dtype for a in tree.leaves((pt2, st2.lin))} == {torch.float32}
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(mt["kkt_residual"]),
                               float(mj["kkt_residual"]), rtol=1e-3)
    for a, b in zip(tree.leaves((pt2, st2.lin)),
                    jax.tree.leaves((pj2, sj2.lin))):
        _close(a, b, 2.0 ** -6)
    grads = tree.map(torch.ones_like, pt)
    new, state = ssca.server_update(ssca.init(pt, with_beta=False), pt,
                                    grads, ssca.SSCAHyperParams(tau=2.0))
    jnew, jstate = jssca.server_update(
        jssca.init(pj, with_beta=False), pj,
        jax.tree.map(jnp.ones_like, pj), jssca.SSCAHyperParams(tau=2.0))
    for a, b in zip(tree.leaves((new, state.lin)),
                    jax.tree.leaves((jnew, jstate.lin))):
        assert a.dtype == torch.float32 and b.dtype == jnp.float32
        _close(a, b, 1e-6)
    sgd, step, _ = steps.make_sgd_train_step(tm)(
        pt, torch.tensor(1, dtype=torch.int32), bt)
    assert int(step) == 2
    assert {a.dtype for a in tree.leaves(sgd)} == {torch.float32}


def test_bf16_parameters_stay_bf16():
    """``Model.init`` draws bf16 leaves; ``_cast`` passes a leaf already
    in the activation dtype through without a copy; the forward's logits
    are f32 and the KV cache bf16; ``params_from_numpy`` carries an f32
    tree unchanged and a bf16 one (the reference's) as bf16, bit for
    bit."""
    jm, tm, pj, pt, _ = _setup(QWEN, "bfloat16")
    assert {w.dtype for w in tree.leaves(pt)} == {torch.bfloat16}
    cast = tm._cast(pt["blocks"])
    assert all(cast[k] is pt["blocks"][k] for k in cast)
    carried = tt.params_from_numpy(jax.tree.map(np.asarray, pj), "cpu")
    for a, b in zip(tree.leaves(carried), tree.leaves(pt)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    _, _, pj32, pt32, _ = _setup(QWEN)
    carried = tt.params_from_numpy(jax.tree.map(np.asarray, pj32), "cpu")
    for a, b in zip(tree.leaves(carried), tree.leaves(pt32)):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    tok = torch.as_tensor(_tokens(2, 8))
    assert tm.forward(pt, {"tokens": tok}).dtype == torch.float32
    st = tm.init_decode(2, 8, device="cpu")
    logits, st = tm.decode_step(pt, st, tok[:, :1])
    assert logits.dtype == torch.float32 and st.kv_k.dtype == torch.bfloat16


def test_bf16_checkpoint_round_trips(tmp_path):
    """The bf16 interleaved tree saved by the port reads back in the
    reference as bf16, and the reference's in the port, bit for bit."""
    _, _, pj, pt, _ = _setup(LLAMA4, "bfloat16")
    ckpt.save(tmp_path / "port", {"params": pt}, step=1)
    restored, meta = jckpt.restore(tmp_path / "port")
    assert set(meta["dtypes"].values()) == {"bfloat16"}
    for a, b in zip(tree.leaves(pt), jax.tree.leaves(restored["params"])):
        assert b.dtype == jnp.bfloat16
        np.testing.assert_array_equal(_f32(a), _f32(b))
    jckpt.save(tmp_path / "ref", {"params": pj}, step=2)
    back, _ = ckpt.restore(tmp_path / "ref", device="cpu")
    for a, b in zip(tree.leaves(back["params"]), tree.leaves(pt)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_serve_batch_tokens_match_reference(arch):
    jm, tm, pj, pt, _ = _setup(arch)
    reqs = serve.synth_requests(3, tm.cfg, 12, 8, seed=2)
    jreqs = jserve.synth_requests(3, jm.cfg, 12, 8, seed=2)
    gen_j, _, _ = jserve.serve_batch(jm, pj, jreqs)
    gen_t, _, _ = serve.serve_batch(tm, pt, reqs)
    assert gen_t.shape == (3, 8) and gen_t.dtype == np.int32
    np.testing.assert_array_equal(gen_t, np.asarray(gen_j))


def test_moe_launchers_run(tmp_path, capsys):
    """``--arch`` of both moe configs through ``serve.main`` and
    ``train.main`` (reduced: 2 layers of width 256, 4 experts) on the
    CPU."""
    for arch in ARCHS:
        out = serve.main(["--arch", arch, "--device", "cpu", "--requests",
                          "2", "--batch", "2", "--prompt-len", "4",
                          "--max-new", "3"])
        assert out[0][0].shape == (2, 3)
    _, losses = train.main(["--arch", LLAMA4, "--device", "cpu", "--batch",
                            "2", "--seq", "16", "--steps", "2",
                            "--ckpt-dir", str(tmp_path), "--ckpt-every",
                            "2"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert (tmp_path / "step_2").is_dir()
    assert "served 2 requests" in capsys.readouterr().out


# --- the federated round ---------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_moe_run_alg1_secure_tracks_jax(arch):
    """``transformer_task(arch)`` (2 layers, width 64, 4 experts), 96
    training and 24 test documents over 4 iid clients, B = 4, 2 rounds,
    secure, fused, λ = 0, τ = 2, both sides from the reference's initial
    weights; the objective drops the aux loss on both sides."""
    kw = dict(batch_size=4, rounds=2, eval_every=1, eval_samples=48, seed=1,
              tau=2.0, lam=0.0, fused=True, secure=True)
    jt = jtransformer_task(arch)
    data = jt.default_data(n_train=96, n_test=24, seed=0)
    part = jpartition.iid(96, 4, seed=0)
    p0 = jt.init_params(jax.random.key(3))
    pj, hj = jruntime.run_alg1(data, part, task=jt, params=p0, **kw)
    task = transformer_task(arch)
    assert task.cfg.family == "moe" and task.cfg.num_experts == 4
    assert task.cfg.experts_per_token == (2 if arch == QWEN else 1)
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
