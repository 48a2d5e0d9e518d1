"""The port's GQA attention against the reference's kernel 5 (causal)
and its model's ``attend`` (head dim 96, non-causal over a key length
of its own).

Same inputs, made from a seed with numpy, go through
``repro.kernels.ops.flash_attention`` (the Pallas kernel in interpret
mode), ``repro.kernels.ref.flash_attention_bhsd`` (its plain reference,
on k/v repeated G-fold) and the port's ``ops.flash_attention``, which on
the CPU runs ``flash_attention_plain``.  Shapes: B ∈ {1, 2},
S ∈ {1, 16, 77, 128}, H = 4, Hkv ∈ {1, 2, 4}, Dh ∈ {16, 64, 128}.

Tolerances, with the largest difference measured on the CPU:

* f32: 1e-5 absolute (measured 7.2e-7). Both compute the same f32
  softmax; the kernel's online softmax and the two einsums sum in other
  orders.
* bf16: one bf16 ulp of the output, plus 2e-6 absolute for outputs
  near zero.  Both compute in f32 from the same bf16 inputs and round
  once at the end; where the f32 values straddle a rounding midpoint
  they round to neighbours (measured: one ulp at |o| ≈ 0.19), and where
  the output cancels to near zero, the f32 difference (below 1e-6) is
  many of that output's tiny ulps.

The op's backward (plain PyTorch, P recomputed in f32) equals autograd of
the plain version to 1e-5, and ``vmap(grad)`` through the op — the
engine's per-client uploads — equals a loop of per-client ``grad``s
bit for bit (one call on the folded batch computes the same rows).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

# every (S, Hkv) pair; B and Dh cycle through their values
SHAPES = [(1 + i % 2, s, 4, hkv, (16, 64, 128)[i % 3])
          for i, (s, hkv) in enumerate((s, hkv) for s in (1, 16, 77, 128)
                                       for hkv in (1, 2, 4))]


def _inputs(b, s, h, hkv, dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, dh)).astype(np.float32),
            rng.standard_normal((b, s, hkv, dh)).astype(np.float32),
            rng.standard_normal((b, s, hkv, dh)).astype(np.float32))


def _ref_bhsd(q, k, v):
    """The reference's plain ``flash_attention_bhsd`` on (B·H, S, Dh), k/v
    repeated over each group of query heads."""
    b, s, h, dh = q.shape
    g = h // k.shape[2]

    def bh(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, s, dh)
    o = jref.flash_attention_bhsd(bh(q), bh(np.repeat(k, g, axis=2)),
                                  bh(np.repeat(v, g, axis=2)), dh ** -0.5)
    return np.asarray(o).reshape(b, h, s, dh).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_plain_matches_reference_kernel_f32(shape):
    q, k, v = _inputs(*shape)
    got = ops.flash_attention(*map(torch.as_tensor, (q, k, v)))
    assert got.dtype == torch.float32 and got.shape == q.shape
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), _ref_bhsd(q, k, v), rtol=0,
                               atol=1e-5)


def _bf16_ulp(x):
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_plain_matches_reference_kernel_bf16(shape):
    q, k, v = (jnp.asarray(x).astype(jnp.bfloat16) for x in _inputs(*shape))
    got = ops.flash_attention(*(
        torch.tensor(np.asarray(x.astype(jnp.float32)))
        .to(torch.bfloat16) for x in (q, k, v)))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    want = np.asarray(jops.flash_attention(q, k, v, interpret=True)
                      .astype(jnp.float32))
    lim = _bf16_ulp(np.maximum(np.abs(got), np.abs(want))) + 2e-6
    assert (np.abs(got - want) <= lim).all(), np.abs(got - want).max()


def test_backward_equals_autograd_of_plain():
    rng = np.random.default_rng(1)
    q, k, v = (torch.tensor(x, requires_grad=True)
               for x in _inputs(2, 77, 4, 2, 16, seed=1))
    do = torch.tensor(rng.standard_normal(q.shape).astype(np.float32))
    got = torch.autograd.grad(ops.flash_attention(q, k, v), (q, k, v), do)
    want = torch.autograd.grad(fa.flash_attention_plain(q, k, v), (q, k, v),
                               do)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("hkv", [1, 2])
def test_vmap_grad_folds_clients_into_one_call(hkv, monkeypatch):
    rng = np.random.default_rng(2)
    n, b, s, h, dh = 3, 2, 19, 4, 16
    w = torch.tensor(rng.standard_normal((dh, dh)).astype(np.float32) * 0.3)
    x = torch.tensor(rng.standard_normal((n, b, s, h, dh)).astype(np.float32))
    kv = torch.tensor(rng.standard_normal((n, b, s, hkv, dh))
                      .astype(np.float32))
    calls = []
    plain = fa.flash_attention_plain
    monkeypatch.setattr(fa, "flash_attention_plain",
                        lambda q, k, v, *window: calls.append(q.shape)
                        or plain(q, k, v, *window))

    def loss(w, xi, ki):
        o = ops.flash_attention(xi @ w, ki, 0.5 * ki)
        return (o * o).sum()

    got = vmap(grad(loss), in_dims=(None, 0, 0))(w, x, kv)
    # the forward ran once, on the clients folded into the batch
    assert calls == [(n * b, s, h, dh)]
    want = torch.stack([grad(loss)(w, x[i], kv[i]) for i in range(n)])
    assert torch.equal(got, want)


@pytest.mark.parametrize("bad", ["heads", "dims"])
def test_shape_checks(bad):
    q = torch.zeros(1, 4, 4, 16)
    k = torch.zeros(1, 4, 3, 16) if bad == "heads" else torch.zeros(1, 5, 2,
                                                                      16)
    with pytest.raises(ValueError, match="Hkv"):
        fa.flash_attention_bhsd(q, k, k, device="cpu")


def test_plain_launches_nothing():
    before = fa.flash_attention_bhsd.launches
    by_mask = dict(fa.flash_attention_bhsd.launches_by_mask)
    q = torch.zeros(1, 3, 2, 16)
    fa.flash_attention_bhsd(q, q, q, device="cpu")
    fa.flash_attention_bhsd(q, q[:, :2], q[:, :2], causal=False,
                            device="cpu")
    assert fa.flash_attention_bhsd.launches == before
    assert fa.flash_attention_bhsd.launches_by_mask == by_mask
    assert set(by_mask) == {f"{v}_{m}" for v in fa.HEAD_DIMS
                            for m in fa.COUNT_MASKS}


# The card's bf16 kernel rounds P to bf16 before P·V, so it is held to the
# f64 softmax by ``bf16_error_check`` and not to the plain version.  These
# check the check: it accepts the plain version and an emulation of the
# kernel's rounding, and rejects a masking slip of one key.
CHECK_SHAPES = [(2, 77, 4, 1, 16), (1, 300, 8, 2, 64), (1, 129, 8, 1, 128),
                (1, 200, 6, 3, 32)]


def _bf16_inputs(shape, seed=3):
    return tuple(torch.tensor(x).to(torch.bfloat16)
                 for x in _inputs(*shape, seed=seed))


def _emulate_kernel(q, k, v, tile=128):
    """The wgmma kernel's arithmetic in f32 on the CPU: 128-key tiles,
    online rescaling by exp2, P rounded to bf16 before P·V, l summed over
    the unrounded P, one rounding of O / l at the end."""
    b, s, h, dh = q.shape
    qf, kf, vf, scale, _ = fa._grouped(q, k, v)
    sl2 = scale * 1.4426950408889634
    g = h // k.shape[2]
    m = torch.full((b, k.shape[2], g, s), float("-inf"))
    l = torch.zeros_like(m)
    acc = torch.zeros(*m.shape, dh)
    rows = torch.arange(s)
    for n0 in range(0, s, tile):
        sc = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf[:, n0:n0 + tile])
        keys = torch.arange(n0, min(n0 + tile, s))
        sc = sc.masked_fill(keys[None, :] > rows[:, None], float("-inf"))
        mx = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp2((m - mx) * sl2)
        p = torch.exp2((sc - mx[..., None]) * sl2)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(torch.bfloat16).float(),
            vf[:, n0:n0 + tile])
        m = mx
    o = acc / l[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(q.shape).to(q.dtype)


@pytest.mark.parametrize("shape", CHECK_SHAPES,
                         ids=[str(s) for s in CHECK_SHAPES])
def test_bf16_error_check_accepts_plain(shape):
    q, k, v = _bf16_inputs(shape)
    ok, ratio, rms_got, rms_plain = fa.bf16_error_check(
        q, k, v, fa.flash_attention_plain(q, k, v))
    assert ok and ratio <= 1.0 and rms_got == rms_plain > 0


@pytest.mark.parametrize("shape", CHECK_SHAPES,
                         ids=[str(s) for s in CHECK_SHAPES])
def test_bf16_error_check_accepts_kernel_rounding(shape):
    q, k, v = _bf16_inputs(shape)
    got = _emulate_kernel(q, k, v)
    ok, ratio, rms_got, rms_plain = fa.bf16_error_check(q, k, v, got)
    # the rounding of P costs about 1.2x the plain version's RMS error
    assert ok, (ratio, rms_got, rms_plain)
    assert rms_plain < rms_got <= 1.5 * rms_plain


@pytest.mark.parametrize("shape", CHECK_SHAPES,
                         ids=[str(s) for s in CHECK_SHAPES])
def test_bf16_error_check_rejects_one_extra_key(shape):
    q, k, v = _bf16_inputs(shape)
    qf, kf, vf, scale, _ = fa._grouped(q, k, v)
    s = q.shape[1]
    leak = torch.ones(s, s, dtype=torch.bool).tril(1)   # key i + 1 visible
    got = torch.einsum("bhgqk,bkhd->bqhgd", fa._probs(qf, kf, scale, leak),
                       vf).reshape(q.shape).to(q.dtype)
    ok, ratio, rms_got, rms_plain = fa.bf16_error_check(q, k, v, got)
    assert not ok and ratio > 1.0 and rms_got > 1.5 * rms_plain


# The card's f32 kernel (csrc/flash_attention.cu) runs both products on
# the tensor cores as TF32, each f32 operand split into hi + lo and summed
# in three passes, over 64-key tiles with an online softmax.  Its rounding
# is emulated here; it must hold the card's tolerance, 2e-5 absolute,
# against the plain version and the reference kernel in interpret mode.
TF32X3_SHAPES = [(2, 77, 4, 2, 16), (1, 100, 4, 1, 128), (2, 32, 4, 4, 16),
                 (1, 65, 8, 4, 64)]


def _tf32(x):
    """x with the 13 low mantissa bits masked off: what a TF32 product
    reads of an f32 operand."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def _mm_tf32(a, b, passes):
    """a @ b on TF32 operands: one pass, or each operand carried as hi +
    lo (lo itself read as TF32) and the lo·lo term dropped."""
    if passes == 1:
        return _tf32(a) @ _tf32(b)
    ah, bh = _tf32(a), _tf32(b)
    return _tf32(a - ah) @ bh + ah @ _tf32(b - bh) + ah @ bh


def _emulate_tf32x3(q, k, v, passes=3, tile=64):
    """The f32 kernel's arithmetic on the CPU: 64-key tiles, S = Q·Kᵀ and
    O += P·V on split operands, scale (times log2 e) then mask, the
    online softmax in exp2, O / l at the end (the kernel's mma products
    sum in another order)."""
    b, s, h, dh = q.shape
    g = h // k.shape[2]
    qf = q.permute(0, 2, 1, 3)
    kf, vf = (x.repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
              for x in (k, v))
    rows = torch.arange(s)[:, None]
    scale_log2 = float(np.float32(dh ** -0.5) * np.float32(1.4426950408889634))
    m = torch.full((b, h, s, 1), float("-inf"))
    l = torch.zeros_like(m)
    acc = torch.zeros(b, h, s, dh)
    for n0 in range(0, s, tile):
        kt, vt = kf[:, :, n0:n0 + tile], vf[:, :, n0:n0 + tile]
        sc = _mm_tf32(qf, kt.transpose(-1, -2), passes) * scale_log2
        keys = torch.arange(n0, n0 + kt.shape[2])[None, :]
        sc = sc.masked_fill(keys > rows, float("-inf"))
        mx = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp2(sc - mx)
        alpha = torch.exp2(m - mx)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _mm_tf32(p, vt, passes)
        m = mx
    return (acc / l).permute(0, 2, 1, 3)


@pytest.mark.parametrize("shape", TF32X3_SHAPES,
                         ids=[str(s) for s in TF32X3_SHAPES])
def test_tf32x3_kernel_arithmetic_holds_the_card_tolerance(shape):
    q, k, v = _inputs(*shape, seed=4)
    got = _emulate_tf32x3(*map(torch.as_tensor, (q, k, v)))
    assert got.shape == q.shape and bool(torch.isfinite(got).all())
    plain = fa.flash_attention_plain(*map(torch.as_tensor, (q, k, v)))
    assert float((got - plain).abs().max()) <= 2e-5
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    assert np.abs(got.numpy() - want).max() <= 2e-5


def test_one_tf32_pass_misses_the_card_tolerance():
    """Why the f32 kernel splits its operands: one TF32 pass lands far
    outside 2e-5 of the plain version."""
    q, k, v = map(torch.as_tensor, _inputs(1, 100, 4, 1, 128, seed=4))
    plain = fa.flash_attention_plain(q, k, v)
    one = float((_emulate_tf32x3(q, k, v, passes=1) - plain).abs().max())
    split = float((_emulate_tf32x3(q, k, v) - plain).abs().max())
    assert one > 10 * 2e-5 and split <= 2e-5


# Head dim 96 (phi-3-vision) and non-causal attention over a key length
# of its own (whisper's encoder and cross-attention): the port's op (its
# plain version on the CPU) against the reference model's ``attend``,
# which runs them in XLA (its Pallas kernel is causal only), forward and
# gradients.  Shapes (B, Sq, Sk, H, Hkv, Dh, causal): Dh 96 causal; Sq =
# Sk = 77 (a ragged last 64- and 128-key tile); Sq 16 against Sk 77; Sq >
# Sk (40 against 9); Sk 16 below one tile; Dh 256 against a ragged Sk.
# Tolerances: f32 1e-5 of the largest |entry| (measured 6.1e-7 forward,
# 6.7e-7 gradients); bf16 2^-6 of it, forward and each gradient
# (measured 6.5e-3 and 6.6e-3: the reference rounds P to bf16 before P·V
# and runs its backward in bf16; the port's plain version keeps P and the
# backward in f32).
ATTEND = [(2, 33, 33, 4, 2, 96, True), (2, 77, 77, 4, 4, 64, False),
          (2, 16, 77, 4, 2, 64, False), (1, 40, 9, 4, 1, 96, False),
          (2, 24, 16, 4, 4, 64, False), (1, 5, 70, 2, 1, 256, False)]


def _attend_inputs(b, sq, sk, h, hkv, dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, dh)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, dh)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, dh)).astype(np.float32),
            rng.standard_normal((b, sq, h, dh)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ATTEND, ids=[str(s) for s in ATTEND])
def test_noncausal_and_dh96_match_reference_attend(shape, dtype):
    import jax
    from repro.models import attention as jattention
    *dims, causal = shape
    q, k, v, c = _attend_inputs(*dims, seed=sum(dims))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    @jax.jit
    def ref(args, cot):
        out, vjp = jax.vjp(lambda *a: jattention.attend(*a, causal=causal),
                           *args)
        return out, vjp(cot)

    want, gwant = ref(tuple(jnp.asarray(a, jdt) for a in (q, k, v)),
                      jnp.asarray(c, jdt))
    tq, tk, tv = (torch.tensor(a).to(tdt).requires_grad_()
                  for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tdt and got.shape == q.shape
    share = 1e-5 if dtype == "float32" else 2.0 ** -6

    def close(a, w):
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(a.detach().float().numpy(), w, rtol=0,
                                   atol=share * np.abs(w).max())

    close(got, want)
    (got.float() * torch.as_tensor(c)).sum().backward()
    for a, w in zip((tq, tk, tv), gwant):
        assert a.grad.dtype == tdt
        close(a.grad, w)


def test_noncausal_arguments_and_vmap():
    """Causal attention needs Sq = Sk, a window needs causality and
    non-causal attention a key; the vmap rule folds the clients into one
    call with k/v of their own length, bit for bit a loop."""
    q = torch.zeros(1, 4, 2, 16)
    k = torch.zeros(1, 6, 1, 16)
    with pytest.raises(ValueError, match="Sk = Sq"):
        fa.flash_attention_bhsd(q, k, k, device="cpu")
    with pytest.raises(ValueError, match="without causality"):
        fa.flash_attention_bhsd(q, k, k, causal=False, window=2,
                                device="cpu")
    with pytest.raises(ValueError, match="one key"):
        fa.flash_attention_bhsd(q, k[:, :0], k[:, :0], causal=False,
                                device="cpu")
    assert set(fa.MASKS) == {"causal", "band", "none"}
    assert all(96 in dims and 256 in dims for dims in fa.HEAD_DIMS.values())
    rng = np.random.default_rng(5)
    n, b, sq, sk, h, dh = 3, 2, 7, 19, 4, 16
    w = torch.tensor(rng.standard_normal((dh, dh)).astype(np.float32) * 0.3)
    x = torch.tensor(rng.standard_normal((n, b, sq, h, dh))
                     .astype(np.float32))
    enc = torch.tensor(rng.standard_normal((n, b, sk, 2, dh))
                       .astype(np.float32))

    def loss(w, xi, ei):
        o = ops.flash_attention(xi @ w, ei, 0.5 * ei, causal=False)
        return (o * o).sum()

    got = vmap(grad(loss), in_dims=(None, 0, 0))(w, x, enc)
    want = torch.stack([grad(loss)(w, x[i], enc[i]) for i in range(n)])
    assert torch.equal(got, want)


# The kernels' arithmetic without causality, emulated as above over their
# key tiles: a ragged last tile masked at keys >= Sk (wgmma: 128-key tiles;
# tf32x3: 64, and 32 at Dh 256).  Each holds its card tolerance; and a
# zero-filled key past Sk left unmasked (exp2(0 - max) in the sum) is
# caught by the bf16 check.
NONCAUSAL = [(2, 77, 4, 2, 64, 1500 % 128), (1, 200, 4, 1, 96, 64),
             (2, 160, 4, 4, 64, 300), (1, 40, 2, 1, 256, 70)]


def _emulate_noncausal(q, k, v, tile, kernel):
    """The kernels' non-causal arithmetic on the CPU: key tiles of
    ``tile``, the online softmax in exp2 and, for ``kernel`` "wgmma", P
    rounded to bf16 before P·V (l over the unrounded P); for "tf32x3"
    both products on split TF32 operands in three passes."""
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    g = h // k.shape[2]
    qf = q.float().permute(0, 2, 1, 3)
    kf, vf = (x.float().repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
              for x in (k, v))
    sl2 = float(np.float32(dh ** -0.5) * np.float32(1.4426950408889634))
    m = torch.full((b, h, sq, 1), float("-inf"))
    l = torch.zeros_like(m)
    acc = torch.zeros(b, h, sq, dh)
    for n0 in range(0, sk, tile):
        kt, vt = kf[:, :, n0:n0 + tile], vf[:, :, n0:n0 + tile]
        if kernel == "tf32x3":
            sc = _mm_tf32(qf, kt.transpose(-1, -2), 3) * sl2
        else:
            sc = (qf @ kt.transpose(-1, -2)) * sl2
        mx = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp2(sc - mx)
        alpha = torch.exp2(m - mx)
        l = l * alpha + p.sum(-1, keepdim=True)
        pv = _mm_tf32(p, vt, 3) if kernel == "tf32x3" else \
            p.to(torch.bfloat16).float() @ vt
        acc = acc * alpha + pv
        m = mx
    return (acc / l).permute(0, 2, 1, 3).to(q.dtype)


@pytest.mark.parametrize("shape", NONCAUSAL, ids=[str(s) for s in NONCAUSAL])
def test_noncausal_kernel_arithmetic_holds_the_card_tolerances(shape):
    b, sq, h, hkv, dh, sk = shape
    q, k, v, _ = _attend_inputs(b, sq, sk, h, hkv, dh, seed=sk)
    q, k, v = map(torch.as_tensor, (q, k, v))
    plain = fa.flash_attention_plain(q, k, v, causal=False)
    got = _emulate_noncausal(q, k, v, 32 if dh > 128 else 64, "tf32x3")
    assert float((got - plain).abs().max()) <= 2e-5
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    got = _emulate_noncausal(qb, kb, vb, 128, "wgmma")
    ok, ratio, rms_got, rms_plain = fa.bf16_error_check(qb, kb, vb, got,
                                                        causal=False)
    assert ok, (ratio, rms_got, rms_plain)
    # a zero key past Sk that reaches the softmax: the check rejects it
    pad = torch.zeros_like(kb[:, :1])
    leak = fa.flash_attention_plain(qb, torch.cat([kb, pad], 1),
                                    torch.cat([vb, pad], 1), causal=False)
    assert not fa.bf16_error_check(qb, kb, vb, leak, causal=False)[0]
