"""The launch entry points of the port against the reference's: KV-cache
and WKV-state decode, ``launch/serve.py``, ``launch/steps.py``,
``launch/train.py`` and ``ckpt/io.py``.

Configurations: ``reduced(get_config("llama3-8b"))`` (2 layers, width
256, 4 query and 4 kv heads of 64, vocab 512)
and ``reduced(get_config("rwkv6-7b"))`` (2 layers, width 256, 4 heads
of 64), with f32 activations and with bf16, the full-width dtype.  Both
sides start from one set of weights: the port's seeded init carried to
the reference as numpy (the reference's own init compiles for seconds),
RWKV-6's ``ln_w`` and ``bonus`` drawn from N(0, 0.5²) instead of zero so
that the WKV path counts.  Tokens are drawn with numpy from a seed;
decode states are carried across with ``decode_state_from_numpy``.

Tolerances, with the largest difference measured on the CPU (the two
frameworks sum f32 products in other orders, and round to bf16 at
other places):

* decode logits against the reference's, every step, a share of the
  largest |logit|: f32 1e-5 (measured 1.0e-6 dense, 6.9e-7 ssm); bf16
  2e-2, the bound of ``tests/test_torch_lm.py`` on logits near 1
  (measured 7.3e-3 dense, 7.1e-3 ssm, logits up to 2.1 and 4.1);
* decode states, a share of each field's largest entry: f32 1e-5
  (measured 1.1e-6); bf16 caches and shifts 2^-6, two bf16 ulps
  (measured 9.3e-3), the f32 WKV state of a bf16 model 2e-2 (measured
  7.4e-3);
* decode against the port's own teacher-forced ``forward``: 2e-2 of the
  largest |logit|, the reference's own bound
  (``tests/test_models_smoke.py``) (measured 4.1e-7 f32, 3.8e-3 bf16);
* ``decode_window=8`` at S = 24 against the reference's ring buffer: as
  the f32 decode (measured 8.7e-7);
* ``serve_batch``: the tokens equal the reference's; where a near-tie
  (the reference's top-2 margin below the f32 logits bound) comes
  first, the tokens may part there;
* the step factories: loss and ``kkt_residual`` rtol 1e-5 (measured
  7.3e-7); the new parameters and SSCA ``lin`` within 5e-5 of each
  leaf's largest |entry| (measured 1.2e-6 dense, 7.0e-6 ssm: the RWKV
  gradients pass the WKV chunk's exponentials); FedSGD's parameters
  likewise (measured 3.2e-6); the
  prefill step 1e-5 of the largest |logit| (measured 6.5e-7);
* checkpoints: bit for bit, both ways, f32, bf16 and int32 leaves;
* ``train.main`` resumed from a checkpoint: bit for bit the
  uninterrupted run.
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
from repro.launch import train as jtrain
from repro.models import attention as jattention
from repro.models import layers as jlayers
from repro.models import rwkv6 as jrwkv6
from repro.models.transformer import build_model as jbuild_model
from repro_torch import tree
from repro_torch.ckpt import io as ckpt
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.core import ssca
from repro_torch.core.schedules import PowerLaw
from repro_torch.launch import serve, steps, train
from repro_torch.models import attention, layers, rwkv6
from repro_torch.models import transformer as tt

ARCHS = ("llama3-8b", "rwkv6-7b")
# logits bounds, each a share of the largest |logit|
F32_LOGITS = 1e-5
BF16_LOGITS = 2e-2
FORWARD = 2e-2
# the step factories' parameters and SSCA lin, a share of each leaf's
# largest |entry|
STEP_LEAVES = 5e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _tokens(b, s, vocab=512, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)) \
        .astype(np.int32)


@functools.lru_cache(maxsize=None)
def _setup(arch, activ="float32", window=0):
    """(reference model, port model, reference params, port params, the
    reference's jitted decode step) at the reduced ``arch``."""
    ct = dataclasses.replace(reduced(get_config(arch)), activ_dtype=activ)
    cj = dataclasses.replace(jreduced(jget_config(arch)), activ_dtype=activ)
    tm = tt.build_model(ct, decode_window=window)
    jm = jbuild_model(cj, decode_window=window)
    pt = tm.init(torch.Generator().manual_seed(0), device="cpu")
    if ct.family == "ssm":
        rng = np.random.default_rng(5)
        for name in ("ln_w", "bonus"):
            pt["blocks"][name] = torch.as_tensor(rng.normal(
                0.0, 0.5, pt["blocks"][name].shape).astype(np.float32))
    pj = jax.tree.map(jnp.asarray, tt.params_to_numpy(pt))
    return jm, tm, pj, pt, jax.jit(jm.decode_step)


def _f32(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _state_close(got, want, activ):
    """The port's decode state against the reference's, field by field:
    f32 fields to 1e-5 of their largest entry, bf16 ones to 2^-6 of it
    (2 ulps) and, in a bf16 model, the f32 WKV state to 2e-2 of it."""
    got = tt.decode_state_to_numpy(got)
    for f in tt.DecodeState._fields:
        a, b = getattr(got, f), _f32(getattr(want, f))
        assert a.shape == b.shape, f
        if f == "length":
            assert a.dtype == np.int32 and int(a) == int(b)
            continue
        if not b.size:
            continue
        scale = np.abs(b).max()
        tol = 1e-5 if activ == "float32" else \
            2.0 ** -6 if f in ("kv_k", "kv_v", "rec_conv") else 2e-2
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale,
                                   err_msg=f)


def _logits_close(got, want, activ):
    got, want = _f32(got), _f32(want)
    share = F32_LOGITS if activ == "float32" else BF16_LOGITS
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=share * np.abs(want).max())


def test_softmax_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 5, 40)).astype(np.float32) * 3
    labels = rng.integers(0, 40, (3, 5)).astype(np.int32)
    for z in (0.0, 1e-4):
        want = float(jlayers.softmax_cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels), z_loss=z))
        got = float(layers.softmax_cross_entropy(
            torch.as_tensor(logits), torch.as_tensor(labels), z_loss=z))
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attend_and_cache_update_match_reference(dtype):
    """A cache of 8 slots written 11 times (the ring has wrapped) and
    one written 5 times, with and without a window of 4; 4 query heads
    on 2 kv heads."""
    rng = np.random.default_rng(2)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    b, cap, hkv, dh = 2, 8, 2, 16
    k0, v0 = (rng.standard_normal((b, cap, hkv, dh)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.standard_normal((b, 1, hkv, dh)).astype(np.float32)
              for _ in range(2))
    q = rng.standard_normal((b, 1, 2 * hkv, dh)).astype(np.float32)
    for cache in (attention.init_cache(b, cap, hkv, dh, device="cpu"),
                  jattention.init_cache(b, cap, hkv, dh)):
        assert cache.k.shape == cache.v.shape == (b, cap, hkv, dh)
        assert cache.capacity == cap and int(cache.length) == 0
        assert str(cache.k.dtype).endswith("bfloat16") and not cache.k.any()
    for length in (11, 5):
        jc = jattention.cache_update(jattention.KVCache(
            jnp.asarray(k0, jdt), jnp.asarray(v0, jdt),
            jnp.asarray(length, jnp.int32)), jnp.asarray(kn), jnp.asarray(vn))
        tc = attention.cache_update(attention.KVCache(
            torch.as_tensor(k0).to(tdt), torch.as_tensor(v0).to(tdt),
            torch.tensor(length, dtype=torch.int32)),
            torch.as_tensor(kn), torch.as_tensor(vn))
        assert int(tc.length) == int(jc.length) == length + 1
        for a, w in ((tc.k, jc.k), (tc.v, jc.v)):
            np.testing.assert_array_equal(_f32(a), _f32(w))
        for window in (0, 4):
            want = jattention.decode_attend(jnp.asarray(q, jdt), jc,
                                            window=window)
            got = attention.decode_attend(torch.as_tensor(q).to(tdt), tc,
                                          window=window)
            assert got.dtype == tdt and got.shape == (b, 1, 2 * hkv, dh)
            tol = 1e-6 if dtype == "float32" else 2.0 ** -7
            np.testing.assert_allclose(_f32(got), _f32(want), rtol=0,
                                       atol=tol * np.abs(_f32(want)).max())


def test_wkv_step_matches_reference():
    rng = np.random.default_rng(3)
    b, h, dh = 2, 3, 8
    r, k, v = (rng.standard_normal((b, h, dh)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.01, 1.0, (b, h, dh)).astype(np.float32)
    u = rng.standard_normal((h, dh)).astype(np.float32)
    s = rng.standard_normal((b, h, dh, dh)).astype(np.float32)
    jo, js = jrwkv6.wkv_step(*map(jnp.asarray, (r, k, v, w, u, s)))
    to, ts = rwkv6.wkv_step(*map(torch.as_tensor, (r, k, v, w, u, s)))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(jo)).max())
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(js)).max())


@pytest.mark.parametrize("activ", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_token_by_token_decode_matches_reference(arch, activ):
    """16 tokens through both decode steps: the logits at every step and
    the final state agree; at step 8 the reference's state, carried
    across, gives the reference's next logits and state; and the port's
    decode agrees with its own teacher-forced forward."""
    jm, tm, pj, pt, jstep = _setup(arch, activ)
    tok = _tokens(2, 16)
    sj = jm.init_decode(2, 16)
    st = tm.init_decode(2, 16, device="cpu")
    got = []
    for t in range(16):
        x = tok[:, t:t + 1]
        if t == 8:
            carried = tt.decode_state_from_numpy(
                jax.tree.map(np.asarray, sj), "cpu")
            lc, sc = tm.decode_step(pt, carried, torch.as_tensor(x))
        lj, sj = jstep(pj, sj, jnp.asarray(x))
        lt, st = tm.decode_step(pt, st, torch.as_tensor(x))
        assert lt.shape == (2, 1, 512) and lt.dtype == torch.float32
        _logits_close(lt, lj, activ)
        if t == 8:
            _logits_close(lc, lj, activ)
            _state_close(sc, sj, activ)
        got.append(lt)
    _state_close(st, sj, activ)
    got = torch.cat(got, dim=1)
    full = tm.forward(pt, {"tokens": torch.as_tensor(tok)})
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=0,
                               atol=FORWARD * float(full.abs().max()))


def test_ring_buffer_decode_matches_reference():
    """``decode_window=8`` at S = 24: the ring wraps twice; logits every
    step and the final cache against the reference's ring buffer, and
    one step from the reference's wrapped cache carried across."""
    jm, tm, pj, pt, jstep = _setup("llama3-8b", "float32", window=8)
    tok = _tokens(2, 24, seed=4)
    sj = jm.init_decode(2, 24)
    st = tm.init_decode(2, 24, device="cpu")
    assert st.kv_k.shape == sj.kv_k.shape == (2, 2, 8, 4, 64)
    for t in range(24):
        x = tok[:, t:t + 1]
        if t == 13:
            carried = tt.decode_state_from_numpy(
                jax.tree.map(np.asarray, sj), "cpu")
            lc, sc = tm.decode_step(pt, carried, torch.as_tensor(x))
        lj, sj = jstep(pj, sj, jnp.asarray(x))
        lt, st = tm.decode_step(pt, st, torch.as_tensor(x))
        _logits_close(lt, lj, "float32")
        if t == 13:
            _logits_close(lc, lj, "float32")
            _state_close(sc, sj, "float32")
    _state_close(st, sj, "float32")


def _first_split_is_a_near_tie(jm, pj, jstep, reqs, gen_t, gen_j):
    """Where the tokens part, the reference's top-2 margin at the first
    differing step is below the f32 logits bound."""
    b, step = min(zip(*np.nonzero(gen_t != gen_j)), key=lambda bs: bs[1])
    prompt = np.stack([r.prompt for r in reqs])
    seq = np.concatenate([prompt, gen_j], axis=1)
    state = jm.init_decode(len(reqs), seq.shape[1])
    for t in range(prompt.shape[1] + step):
        logits, state = jstep(pj, state, jnp.asarray(seq[:, t:t + 1]))
    top = np.sort(np.asarray(logits[b, 0, :jm.cfg.vocab_size]))[-2:]
    bound = F32_LOGITS * np.abs(np.asarray(logits)).max()
    assert top[1] - top[0] <= bound, (b, step, top)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_batch_tokens_match_reference(arch):
    jm, tm, pj, pt, jstep = _setup(arch)
    cfg = tm.cfg
    reqs = serve.synth_requests(3, cfg, 8, 8, seed=2)
    jreqs = jserve.synth_requests(3, jm.cfg, 8, 8, seed=2)
    for a, b in zip(reqs, jreqs):
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert a.max_new == b.max_new
    gen_j, _, _ = jserve.serve_batch(jm, pj, jreqs)
    record = []
    gen_t, tp, td = serve.serve_batch(tm, pt, reqs, record=record)
    assert gen_t.shape == gen_j.shape == (3, 8) and gen_t.dtype == np.int32
    assert tp > 0 and td > 0 and len(record) == 16
    assert (gen_t < cfg.vocab_size).all()
    if not np.array_equal(gen_t, gen_j):
        _first_split_is_a_near_tie(jm, pj, jstep, jreqs, gen_t, gen_j)


def test_serve_main_pads_the_tail_batch(capsys):
    out = serve.main(["--arch", "llama3-8b", "--device", "cpu",
                      "--requests", "3", "--batch", "2", "--prompt-len",
                      "4", "--max-new", "3"])
    assert [g.shape for g, _, _ in out] == [(2, 3), (2, 3)]
    # the tail batch holds request 2 twice
    np.testing.assert_array_equal(out[1][0][0], out[1][0][1])
    text = capsys.readouterr().out
    assert text.count("batch done") == 2 and "served 3 requests" in text


HP = dict(tau=2.0, lam=0.0)


@pytest.mark.parametrize("arch,microbatches", [
    ("llama3-8b", 1), ("llama3-8b", 2), ("rwkv6-7b", 1)])
def test_train_step_matches_reference(arch, microbatches):
    """Two Algorithm-1 steps of each side's ``make_train_step`` from one
    point and one batch stream: loss, ``kkt_residual``, the new
    parameters and the SSCA state.  The microbatch loop does not depend
    on the family; it runs on the dense model (each reference case
    compiles for 2–4 s)."""
    jm, tm, pj, pt, _ = _setup(arch)
    hj = jssca.SSCAHyperParams(rho=JPowerLaw(0.9, 0.3),
                               gamma=JPowerLaw(0.9, 0.35), **HP)
    ht = ssca.SSCAHyperParams(rho=PowerLaw(0.9, 0.3),
                              gamma=PowerLaw(0.9, 0.35), **HP)
    fj = jax.jit(jsteps.make_train_step(jm, hj, microbatches=microbatches))
    ft = steps.make_train_step(tm, ht, microbatches=microbatches)
    sj, st = jssca.init(pj, with_beta=False), ssca.init(pt, with_beta=False)
    stream_j = jtrain.batch_stream(jm.cfg, 4, 16)
    stream_t = train.batch_stream(tm.cfg, 4, 16, device="cpu")
    for _ in range(2):
        bj, bt = next(stream_j), next(stream_t)
        np.testing.assert_array_equal(bt["tokens"].numpy(),
                                      np.asarray(bj["tokens"]))
        pj, sj, mj = fj(pj, sj, bj)
        pt, st, mt = ft(pt, st, bt)
        for k in ("loss", "kkt_residual"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-5)
        assert st.step == int(sj.step) and st.beta is None
        for a, b in zip(tree.leaves((pt, st.lin)),
                        jax.tree.leaves((pj, sj.lin))):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=STEP_LEAVES * np.abs(b).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_sgd_prefill_and_decode_steps_match_reference(arch):
    jm, tm, pj, pt, _ = _setup(arch)
    tok = _tokens(4, 16, seed=6)
    bj, bt = {"tokens": jnp.asarray(tok)}, {"tokens": torch.as_tensor(tok)}
    fj = jax.jit(jsteps.make_sgd_train_step(jm))
    ft = steps.make_sgd_train_step(tm)
    qj, cj, mj = fj(pj, jnp.asarray(3, jnp.int32), bj)
    qt, ct, mt = ft(pt, torch.tensor(3, dtype=torch.int32), bt)
    assert ct.dtype == torch.int32 and int(ct) == int(cj) == 4
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-5)
    for a, b in zip(tree.leaves(qt), jax.tree.leaves(qj)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=STEP_LEAVES * np.abs(b).max())
    # the prefill step: the last position of the forward, and the same
    # logits as the decode step's at the last prompt token
    want = np.asarray(jax.jit(jsteps.make_prefill_step(jm))(pj, bj))
    got = steps.make_prefill_step(tm)(pt, bt)
    assert got.shape == (4, 512)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=F32_LOGITS * np.abs(want).max())
    dec = steps.make_decode_step(tm)
    state = tm.init_decode(4, 16, device="cpu")
    for t in range(16):
        logits, state = dec(pt, state, {"tokens": bt["tokens"][:, t:t + 1]})
    np.testing.assert_allclose(logits[:, 0].numpy(), got.numpy(), rtol=0,
                               atol=FORWARD * float(got.abs().max()))


def _ckpt_tree(seed):
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    bf = rng.standard_normal((4,)).astype(np.float32)
    return f32, bf, np.arange(6, dtype=np.int32).reshape(2, 3)


def _bits(x):
    """A leaf's raw bits as a numpy array (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16) \
            if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def test_checkpoint_from_the_port_reads_in_the_reference(tmp_path):
    f32, bf, i32 = _ckpt_tree(7)
    tree_t = {"params": {"blocks": {"w": torch.as_tensor(f32),
                                    "b": torch.as_tensor(bf).bfloat16()},
                         "embed": torch.as_tensor(f32) * 2},
              "count": torch.as_tensor(i32)}
    nbytes = ckpt.save(tmp_path / "step_3", tree_t, step=3,
                       extra={"arch": "x"})
    assert nbytes == (tmp_path / "step_3" / "arrays.npz").stat().st_size
    restored, meta = jckpt.restore(tmp_path / "step_3")
    assert meta["step"] == 3 and meta["extra"] == {"arch": "x"}
    assert meta["keys"] == ["count", "params/blocks/b", "params/blocks/w",
                            "params/embed"]
    assert restored["params"]["blocks"]["b"].dtype == jnp.bfloat16
    for path in meta["keys"]:
        node_t, node_j = tree_t, restored
        for p in path.split("/"):
            node_t, node_j = node_t[p], node_j[p]
        np.testing.assert_array_equal(_bits(node_t), _bits(node_j))
        assert _bits(node_t).dtype == _bits(node_j).dtype


def test_checkpoint_from_the_reference_reads_in_the_port(tmp_path):
    f32, bf, i32 = _ckpt_tree(8)
    tree_j = {"params": {"blocks": {"w": jnp.asarray(f32),
                                    "b": jnp.asarray(bf, jnp.bfloat16)},
                         "embed": jnp.asarray(f32) * 2},
              "count": jnp.asarray(i32)}
    jckpt.save(tmp_path / "step_5", tree_j, step=5)
    restored, meta = ckpt.restore(tmp_path / "step_5", device="cpu")
    assert meta["step"] == 5
    assert restored["params"]["blocks"]["b"].dtype == torch.bfloat16
    assert restored["count"].dtype == torch.int32
    for a, b in zip(jax.tree.leaves(tree_j),
                    [restored["count"], restored["params"]["blocks"]["b"],
                     restored["params"]["blocks"]["w"],
                     restored["params"]["embed"]]):
        np.testing.assert_array_equal(_bits(b), _bits(a))
    # a NamedTuple's fields take the reference's ".field" paths
    ckpt.save(tmp_path / "nt", {"s": ssca.SSCAState(
        step=torch.tensor(2), lin={"w": torch.zeros(2)}, beta=None)})
    assert ckpt.restore(tmp_path / "nt", device="cpu")[1]["keys"] == \
        ["s/.step", "s/.lin/w"]


def test_latest_picks_the_largest_step(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.latest(tmp_path)
    for name in ("step_2", "step_10", "step_9", "other"):
        (tmp_path / name).mkdir()
    (tmp_path / "step_99").write_text("not a directory")
    assert ckpt.latest(tmp_path) == jckpt.latest(tmp_path) \
        == tmp_path / "step_10"


@pytest.mark.parametrize("optimizer", ["ssca", "fedsgd"])
def test_train_main_resumes_bit_for_bit(tmp_path, optimizer):
    """4 steps saving every 2, then 2 more from ``latest``, against 6
    uninterrupted steps: the same parameters and losses, bit for bit."""
    kw = ["--arch", "llama3-8b", "--device", "cpu", "--batch", "4",
          "--seq", "16", "--optimizer", optimizer]
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    _, first = train.main(kw + ck + ["--steps", "4"])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_2", "step_4"]
    resumed, second = train.main(kw + ck + ["--steps", "2"])
    whole, losses = train.main(kw + ["--steps", "6"])
    assert first + second == losses
    for a, b in zip(tree.leaves(resumed), tree.leaves(whole)):
        assert torch.equal(a, b)
    # the checkpoint holds the optimizer state beside the parameters
    meta = ckpt.restore(ckpt.latest(tmp_path), device="cpu")[1]
    assert meta["step"] == 6
    assert any(k.startswith("ssca_lin/") for k in meta["keys"]) \
        == (optimizer == "ssca")


def test_batch_stream_is_the_reference_one():
    cfg, jcfg = reduced(get_config("llama3-8b")), \
        jreduced(jget_config("llama3-8b"))
    a = train.batch_stream(cfg, 3, 12, seed=4, device="cpu")
    b = jtrain.batch_stream(jcfg, 3, 12, seed=4)
    for _ in range(3):
        np.testing.assert_array_equal(next(a)["tokens"].numpy(),
                                      np.asarray(next(b)["tokens"]))
    # the vlm's stream holds its image tokens' place: a seq below them
    # plus two text tokens raises (tests/test_torch_vlm_audio.py streams
    # the vlm and audio)
    with pytest.raises(ValueError, match="at least 10"):
        train.batch_stream(reduced(get_config("phi-3-vision-4.2b")), 2, 8,
                           device="cpu")
