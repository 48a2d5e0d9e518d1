"""The port's WKV scan against the reference's kernel 6.

Same inputs, made from a seed with numpy, go through
``repro.kernels.rwkv6_scan.rwkv6_wkv_bh`` (the Pallas kernel in interpret
mode, chunk 16), ``repro.kernels.ref.rwkv6_wkv_bh`` (the token-by-token
recurrence) and the port's ``rwkv6_scan.rwkv6_wkv_bh``, which on the CPU
runs ``wkv_plain`` (the chunked form, chunk 16) on the model's
(N, S, H, D) layout.  Shapes (N, S, H, D) ∈ {(2, 64, 2, 16), (1, 32, 4,
32), (1, 128, 2, 64)}, log-decays drawn as the model's
(−exp(N(−1, 1)) clamped to [−5, 0]) or constant at the −5 floor; and
S = 40 (a short last chunk, which the reference kernel does not take)
against the recurrence.

Tolerances, with the largest difference measured on the CPU:

* forward: 1e-5 of the largest |o| (measured 5.7e-7 against the Pallas
  kernel, 6.6e-7 against the recurrence).  The chunked forms and the
  recurrence sum in other orders, and the chunked forms multiply
  e^{±cumsum} factors that the recurrence never forms.
* backward: the op's gradient (autograd of ``wkv_plain``, recomputed
  from the saved inputs) equals autograd of ``wkv_plain`` called
  directly within 1e-5 of each gradient's largest entry, in each input's
  dtype and shape (measured: equal); and ``jax.vjp`` of the reference's
  recurrence within 1e-4 of each gradient's largest entry (measured
  5.3e-7 at model-like decays; 3.0e-5 in the log-decay's gradient at
  the −5 floor, where the chunked form's e^{±cumsum} factors reach
  e^{80}).
* ``vmap(vjp)`` through the op folds the vmapped dim into N: one forward
  call (and one recompute in the backward, under the vmap),
  and the gradient equals a loop of per-slice gradients within 1e-6 of
  its largest entry (measured: equal; the folded call computes the same
  rows).

The card kernel's arithmetic (``csrc/rwkv6_scan_sm90.cu``) is emulated
here in plain PyTorch (:func:`_emulate_kernel`): chunks of 16, the score
factors taken relative to the chunk's 8th token, every product on TF32
operands (13 low mantissa bits masked off), each f32 operand split into
hi + lo and summed as three passes (two where the other operand is bf16
v, which TF32 holds exactly).  It stays within 1e-5 of the largest |o|
of ``wkv_plain``, the card's tolerance, at the path's decays, the −5
floor, no decay, ragged S and u shared or per sequence (measured at most
1.4e-6); a single TF32 pass does not (4.0e-4 to 1.8e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vjp, vmap

from repro.kernels import ref as jref
from repro.kernels import rwkv6_scan as jrw
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6_scan as rw

SHAPES = [(2, 64, 2, 16), (1, 32, 4, 32), (1, 128, 2, 64)]


def _inputs(n, s, h, d, *, lw=None, per_seq=False, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((n, s, h, d)).astype(np.float32)
               for _ in range(3))
    if lw is None:
        lwa = np.clip(-np.exp(rng.normal(-1.0, 1.0, (n, s, h, d))), -5, 0)
    else:
        lwa = np.full((n, s, h, d), lw)
    u = rng.standard_normal((n, h, d) if per_seq else (h, d))
    return r, k, v, lwa.astype(np.float32), u.astype(np.float32)


def _bh(x):
    """(N, S, H, D) → the reference's (N·H, S, D)."""
    n, s, h, d = x.shape
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(n * h, s, d)


def _reference(fn, r, k, v, lw, u, **kw):
    n, s, h, d = r.shape
    ub = np.broadcast_to(u if u.ndim == 3 else u[None], (n, h, d))
    o = fn(_bh(r), _bh(k), _bh(v), _bh(lw),
           jnp.asarray(ub).reshape(n * h, 1, d), **kw)
    return np.asarray(o).reshape(n, h, s, d).transpose(0, 2, 1, 3)


def _port(r, k, v, lw, u):
    return rw.rwkv6_wkv_bh(*map(torch.as_tensor, (r, k, v, lw, u)),
                           device="cpu")


@pytest.mark.parametrize("lw", [None, -5.0], ids=["model_decay", "floor"])
@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_plain_matches_reference_kernel_and_recurrence(shape, lw):
    x = _inputs(*shape, lw=lw, per_seq=shape[0] > 1)
    got = _port(*x)
    assert got.dtype == torch.float32 and got.shape == shape
    got = got.numpy()
    pallas = _reference(jrw.rwkv6_wkv_bh, *x, interpret=True)
    recurrence = _reference(jref.rwkv6_wkv_bh, *x)
    assert np.isfinite(got).all()
    top = np.abs(recurrence).max()
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5 * top)
    np.testing.assert_allclose(got, recurrence, rtol=0, atol=1e-5 * top)


@pytest.mark.parametrize("lw", [None, -5.0, 0.0],
                         ids=["model_decay", "floor", "no_decay"])
def test_short_last_chunk_matches_recurrence(lw):
    x = _inputs(2, 40, 3, 16, lw=lw, seed=1)
    got = _port(*x).numpy()
    want = _reference(jref.rwkv6_wkv_bh, *x)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # the padded tokens change nothing: the first 32 tokens alone give
    # the same outputs
    head = _port(*(a[:, :32] if a.ndim == 4 else a for a in x)).numpy()
    np.testing.assert_allclose(got[:, :32], head, rtol=0,
                               atol=1e-6 * np.abs(head).max())


def test_bf16_inputs_are_read_as_f32():
    x = _inputs(1, 48, 2, 16, seed=2)
    r, k, v = (torch.as_tensor(a).to(torch.bfloat16) for a in x[:3])
    got = rw.rwkv6_wkv_bh(r, k, v, *map(torch.as_tensor, x[3:]),
                          device="cpu")
    assert got.dtype == torch.float32
    want = rw.wkv_plain(r.float(), k.float(), v.float(),
                        *map(torch.as_tensor, x[3:]))
    assert torch.equal(got, want)


@pytest.mark.parametrize("per_seq", [False, True], ids=["u_shared",
                                                         "u_per_seq"])
@pytest.mark.parametrize("s", [40, 64])
def test_backward_equals_autograd_of_plain(s, per_seq):
    x = [torch.tensor(a, requires_grad=True)
         for a in _inputs(2, s, 2, 16, per_seq=per_seq, seed=3)]
    do = torch.tensor(np.random.default_rng(4).standard_normal(
        x[0].shape).astype(np.float32))
    got = torch.autograd.grad(rw.RWKV6WKV.apply(*x), x, do)
    want = torch.autograd.grad(rw.wkv_plain(*x), x, do)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()))


@pytest.mark.parametrize("lw", [None, -5.0], ids=["model_decay", "floor"])
def test_backward_matches_reference_recurrence_grad(lw):
    x = _inputs(2, 40, 2, 16, lw=lw, per_seq=True, seed=7)
    do = np.random.default_rng(8).standard_normal((2, 40, 2, 16)) \
        .astype(np.float32)
    xt = [torch.tensor(a, requires_grad=True) for a in x]
    got = torch.autograd.grad(rw.RWKV6WKV.apply(*xt), xt, torch.tensor(do))
    n, s, h, d = do.shape

    def ref(r, k, v, lw_, u):
        o = jref.rwkv6_wkv_bh(*(
            a.transpose(0, 2, 1, 3).reshape(n * h, s, d)
            for a in (r, k, v, lw_)), u.reshape(n * h, 1, d))
        return o.reshape(n, h, s, d).transpose(0, 2, 1, 3)

    _, pull = jax.vjp(ref, *map(jnp.asarray, x))
    want = pull(jnp.asarray(do))
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-4 * np.abs(b).max())


def test_op_clamps_the_log_decay_as_the_reference_wrapper():
    """``ops.rwkv6_wkv`` takes the decay w and computes lw =
    clamp(log(max(w, 1e-20)), −5, 0), as ``repro.kernels.ops.rwkv6_wkv``
    does; both give one output for decays below e^-5 and at 0."""
    from repro.kernels import ops as jops
    r, k, v, lw, u = _inputs(1, 32, 2, 16, seed=5)
    w = np.exp(lw)
    w[0, :4] = 0.0          # log → −inf, clamped to the floor
    w[0, 4:8] = 1e-4        # below e^-5
    got = ops.rwkv6_wkv(*map(torch.as_tensor, (r, k, v, w, u))).numpy()
    want = np.asarray(jops.rwkv6_wkv(*map(jnp.asarray, (r, k, v, w, u)),
                                     interpret=True))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("u_batched", [False, True],
                         ids=["u_shared", "u_batched"])
def test_vmap_vjp_folds_clients_into_one_call(u_batched, monkeypatch):
    rng = np.random.default_rng(6)
    m, n, s, h, d = 3, 2, 21, 2, 16
    proj = torch.tensor(rng.standard_normal((d, d)).astype(np.float32) * .3)
    x = torch.tensor(rng.standard_normal((m, n, s, h, d)).astype(np.float32))
    lw = torch.tensor(np.clip(-np.exp(rng.normal(-1, 1, (m, n, s, h, d))),
                              -5, 0).astype(np.float32))
    u = torch.tensor(rng.standard_normal((m, h, d) if u_batched else (h, d))
                     .astype(np.float32))
    calls = []
    plain = rw.wkv_plain
    monkeypatch.setattr(rw, "wkv_plain", lambda *a: calls.append(
        (tuple(a[0].shape), tuple(a[4].shape))) or plain(*a))

    def loss(p, xi, lwi, ui):
        o = rw.RWKV6WKV.apply(xi @ p, xi, 0.5 * xi, lwi, ui)
        return (o * o).sum()

    def grads(p, xi, lwi, ui):
        value, pull = vjp(lambda p_, l_, u_: loss(p_, xi, l_, u_), p, lwi,
                          ui)
        return pull(torch.ones_like(value))

    got = vmap(grads, in_dims=(None, 0, 0, 0 if u_batched else None))(
        proj, x, lw, u)
    # the forward ran once, on the clients folded into N; u stayed one
    # (H, D) when it was shared, one row a folded sequence otherwise.  The
    # backward recomputed the plain version once, under the vmap (the
    # shapes one client's slice shows)
    assert calls == [((m * n, s, h, d),
                      (m * n, h, d) if u_batched else (h, d)),
                     ((n, s, h, d), (h, d))]
    want = [grads(proj, x[i], lw[i], u[i] if u_batched else u)
            for i in range(m)]
    for j, g in enumerate(got):               # d proj, d lw, d u per slice
        ref = torch.stack([w[j] for w in want])
        torch.testing.assert_close(g, ref, rtol=0,
                                   atol=1e-6 * float(ref.abs().max()))


def _tf32(x):
    """x with the 13 low mantissa bits masked off: what a TF32 product
    reads of an f32 operand."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def _mm(a, b, split_a, split_b, passes):
    """a @ b on TF32 operands: one pass, or each split operand carried as
    hi + lo (lo itself read as TF32) and the lo·lo term dropped."""
    if passes == 1:
        return _tf32(a) @ _tf32(b)
    ah, bh = _tf32(a), _tf32(b)
    out = ah @ bh
    if split_b:
        out = out + ah @ _tf32(b - bh)
    if split_a:
        out = out + _tf32(a - ah) @ bh
    return out


def _emulate_kernel(r, k, v, lw, u, passes=3):
    """The card kernel's chunked algebra and rounding on the CPU (the
    kernel's mma products sum in another order)."""
    t_len, ref_t = 16, 7
    n, s, h, d = r.shape
    split_v = r.dtype != torch.bfloat16
    c = -(-s // t_len)
    r, k, v, lw = (rw._chunked(x, c) for x in (r, k, v, lw))
    u = u.float() if u.dim() == 3 else u.float()[None]
    u = u[:, :, None, None, :]
    cum = torch.cumsum(lw, dim=-2)
    ref, total = cum[..., ref_t:ref_t + 1, :], cum[..., -1:, :]
    r_car = r * torch.exp(cum - lw)
    r_sc = r_car * torch.exp(-ref)
    k_sc = k * torch.exp(ref - cum)
    k_dec = k_sc * torch.exp(total - ref)
    att = _mm(r_sc, k_sc.transpose(-1, -2), True, True, passes)
    ti = torch.arange(t_len)
    bonus = torch.diag_embed((r * u * k).sum(-1))
    att = torch.where(ti[None] < ti[:, None], att,
                      torch.where(ti[None] == ti[:, None], bonus, 0.0))
    o = _mm(att, v, True, split_v, passes)
    incr = _mm(k_dec.transpose(-1, -2), v, True, split_v, passes)
    decay = torch.exp(total)[..., 0, :, None]
    state = torch.zeros_like(incr[:, :, 0])
    out = []
    for i in range(c):
        out.append(o[:, :, i] + _mm(r_car[:, :, i], state, True, True,
                                    passes))
        state = state * decay[:, :, i] + incr[:, :, i]
    return rw._unchunked(torch.stack(out, dim=2), s)


# (N, S, H, D), r/k/v dtype, log-decay (None: the card path's statistics,
# −exp(N(−1, 0.5²)) clamped), u per sequence
EMULATED = [((2, 64, 2, 64), torch.bfloat16, None, False),
            ((2, 48, 2, 16), torch.float32, -5.0, True),
            ((2, 48, 2, 64), torch.bfloat16, 0.0, False),
            ((2, 33, 3, 16), torch.float32, None, True),
            ((1, 77, 2, 64), torch.bfloat16, -5.0, True),
            ((2, 1, 2, 16), torch.float32, None, False)]


def _path_inputs(n, s, h, d, dtype, lw, per_seq, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (torch.tensor(rng.standard_normal((n, s, h, d)),
                            dtype=torch.float32).to(dtype)
               for _ in range(3))
    if lw is None:
        lwa = np.clip(-np.exp(rng.normal(-1.0, 0.5, (n, s, h, d))), -5, 0)
    else:
        lwa = np.full((n, s, h, d), lw)
    u = rng.standard_normal((n, h, d) if per_seq else (h, d))
    return (r, k, v, torch.tensor(lwa, dtype=torch.float32),
            torch.tensor(u, dtype=torch.float32))


@pytest.mark.parametrize("case", EMULATED,
                         ids=[f"{c[0]}-{str(c[1])[6:]}-lw{c[2]}-"
                              f"{'u_per_seq' if c[3] else 'u_shared'}"
                              for c in EMULATED])
def test_kernel_arithmetic_holds_the_card_tolerance(case):
    shape, dtype, lw, per_seq = case
    x = _path_inputs(*shape, dtype, lw, per_seq)
    want = rw.wkv_plain(*x)
    got = _emulate_kernel(*x)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    top = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * top


def test_one_tf32_pass_misses_the_card_tolerance():
    """Why the kernel splits its operands: one TF32 pass is a hundred
    times outside the tolerance at the card path's decays."""
    x = _path_inputs(2, 64, 2, 64, torch.bfloat16, None, False)
    want = rw.wkv_plain(*x)
    top = float(want.abs().max())
    one = float((_emulate_kernel(*x, passes=1) - want).abs().max())
    split = float((_emulate_kernel(*x) - want).abs().max())
    assert one > 1e-4 * top and split <= 1e-5 * top


def test_plain_launches_nothing():
    before = rw.rwkv6_wkv_bh.launches
    x = _inputs(1, 5, 2, 8)
    _port(*x)
    ops.rwkv6_wkv(*(torch.as_tensor(a) for a in x))
    assert rw.rwkv6_wkv_bh.launches == before


@pytest.mark.parametrize("bad", ["rank", "mismatch", "u"])
def test_shape_checks(bad):
    x = [torch.zeros(1, 4, 2, 16) for _ in range(4)]
    u = torch.zeros(2, 16)
    if bad == "rank":
        x[0] = torch.zeros(4, 2, 16)
    elif bad == "mismatch":
        x[3] = torch.zeros(1, 4, 2, 8)
    else:
        u = torch.zeros(3, 16)
    with pytest.raises(ValueError, match="rwkv6_wkv takes"):
        rw.rwkv6_wkv_bh(*x, u, device="cpu")
