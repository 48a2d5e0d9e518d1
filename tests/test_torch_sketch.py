"""The port's count-sketch against the reference's, bit for bit.

Everything the sketch computes after the stochastic round is integer
arithmetic or a gather of grid values, so nothing here has a tolerance:

* ``sketch_encode_plain`` equals ``sketch_encode_xla`` and the
  interpret-mode Pallas ``sketch_encode_kernel`` (ragged R, cols = 1, an
  all-zero message, a counter base near 2^32);
* sketches merge linearly in the ring: encode(a) + encode(b) ==
  encode(a + b) for on-grid inputs;
* both estimators, on the same integer sketch, and ``support`` on an
  estimate with many exact ties;
* one whole two-phase round of ``CountSketchCompressor`` — encode,
  the combine of the sketches, support, values, the combine of the
  values, reassemble, update_residual — from the same numpy messages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fed import aggregation as jagg
from repro.fed import sketch as jfsk
from repro.kernels import sketch as jksk
from repro_torch.fed import aggregation as tagg
from repro_torch.fed import engine as tengine
from repro_torch.fed import keys as tkeys
from repro_torch.fed import sketch as tfsk
from repro_torch.kernels import compress as tkc
from repro_torch.kernels import sketch as tksk

K0, K1 = 0xA1B2C3D4, 0x1F2E3D4C
SKSEED = 0x5EEDC0DE
GRID = np.float32(2.0 ** -20)


def _su(clients, base):
    return np.asarray([[tkc.client_stream_seed(K0, K1, c), base, SKSEED]
                       for c in range(clients)], np.uint32)


def _ref_encode(fn, x, su, **kw):
    return np.stack([np.asarray(fn(jnp.asarray(x[i]), jnp.asarray(su[i]),
                                   **kw)) for i in range(x.shape[0])])


@pytest.mark.parametrize("n_rows,rows,cols,base,kind", [
    (3, 4, 128, 0, "dense"), (9, 3, 256, 0, "sparse"),
    (5, 2, 1, 640, "dense"), (2, 4, 64, 2 ** 32 - 100, "dense"),
    (4, 4, 512, 0, "zero")])
def test_sketch_encode_plain_equals_reference(n_rows, rows, cols, base, kind):
    rng = np.random.default_rng(n_rows * 31 + cols)
    x = (rng.standard_normal((2, n_rows, 128)) * 0.1).astype(np.float32)
    if kind == "sparse":                        # pre-sparsified, as encode's
        x[np.abs(x) < 0.2] = 0.0
    if kind == "zero":
        x[:] = 0.0
    su = _su(2, base)
    kw = dict(rows=rows, cols=cols, scale_bits=20)
    got = tksk.sketch_encode(torch.tensor(x), torch.tensor(su.astype(np.int64)),
                             device="cpu", **kw).numpy()
    np.testing.assert_array_equal(got, _ref_encode(jksk.sketch_encode_xla,
                                                   x, su, **kw))
    np.testing.assert_array_equal(got, _ref_encode(
        lambda *a, **k: jksk.sketch_encode_kernel(*a, interpret=True, **k),
        x, su, **kw))
    if kind == "zero":
        assert not got.any()


def test_sketch_encode_saturates_like_xla():
    x = np.zeros((1, 1, 128), np.float32)
    x[0, 0, :4] = [np.inf, -np.inf, 3e9, np.nan]
    su = _su(1, 0)
    kw = dict(rows=2, cols=16, scale_bits=20)
    got = tksk.sketch_encode(torch.tensor(x), torch.tensor(su.astype(np.int64)),
                             device="cpu", **kw).numpy()
    np.testing.assert_array_equal(got, _ref_encode(jksk.sketch_encode_xla,
                                                   x, su, **kw))


def test_sketches_merge_linearly_in_the_ring():
    rng = np.random.default_rng(3)
    a, b = (rng.integers(-2 ** 12, 2 ** 12, size=(1, 6, 128))
            .astype(np.float32) * GRID for _ in range(2))
    su = torch.tensor(_su(1, 0).astype(np.int64))
    enc = lambda v: tksk.sketch_encode(  # noqa: E731
        torch.tensor(v), su, rows=4, cols=64, scale_bits=20, device="cpu")
    assert torch.equal(enc(a) + enc(b), enc(a + b))


def _int_sketch(rng, rows, cols):
    return rng.integers(-2 ** 20, 2 ** 20, size=(rows, cols)) \
        .astype(np.float32) * GRID


@pytest.mark.parametrize("rows", [1, 3, 4, 5])
def test_estimators_equal_reference(rows):
    rng = np.random.default_rng(rows)
    sk = _int_sketch(rng, rows, 256)
    ctrs = np.arange(3000, dtype=np.uint32)
    for tfn, jfn in ((tksk.sketch_estimate, jksk.sketch_estimate),
                     (tksk.sketch_estimate_median,
                      jksk.sketch_estimate_median)):
        got = tfn(torch.tensor(sk), torch.tensor(ctrs.astype(np.int64)),
                  SKSEED).numpy()
        want = np.asarray(jfn(jnp.asarray(sk), jnp.asarray(ctrs),
                              jnp.uint32(SKSEED)))
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def test_support_breaks_ties_like_reference():
    # few sketched coordinates: most estimates are exact zeros (and the
    # nonzero buckets repeat), so the top-k is decided by the tie order
    comp_t = tfsk.sketch(rows=4, cols=64, fraction=0.25, keep=8)
    comp_j = jfsk.sketch(rows=4, cols=64, fraction=0.25, keep=8)
    sk = np.zeros((4, 64), np.float32)
    sk[:, 3] = 5 * GRID
    sk[:, 10] = -5 * GRID
    sk[1, 7] = 2 * GRID
    like_t = {"w": torch.zeros(4, 128)}
    like_j = {"w": jnp.zeros((4, 128))}
    got = comp_t.support(torch.tensor(sk), like_t).numpy()
    want = np.asarray(comp_j.support(jnp.asarray(sk), like_j))
    np.testing.assert_array_equal(got, want)


def _messages(rng, clients):
    return {"w1": (rng.standard_normal((clients, 20, 13)) * 1e-3)
            .astype(np.float32),
            "w2": (rng.standard_normal((clients, 13, 5)) * 1e-3)
            .astype(np.float32)}


@pytest.mark.parametrize("secure", [False, True])
def test_two_phase_round_equals_reference(secure):
    clients = 4
    rng = np.random.default_rng(11)
    msgs = _messages(rng, clients)
    resid = {k: (v * 0.5).astype(np.float32)
             for k, v in _messages(rng, clients).items()}
    kw = dict(rows=4, cols=128, fraction=0.05, keep=24)
    comp_t, comp_j = tfsk.sketch(**kw), jfsk.sketch(**kw)
    words = np.asarray([K0, K1], np.uint32)
    jkey = jax.random.wrap_key_data(jnp.asarray(words))

    # the reference: the engine's sketched branch, client by client
    inp_j = [{k: jnp.asarray(msgs[k][c] + resid[k][c]) for k in msgs}
             for c in range(clients)]
    k0, k1 = jnp.uint32(K0), jnp.uint32(K1)
    cid = [jnp.uint32(c) for c in range(clients)]
    sk_j = jnp.stack([comp_j.encode(m, k0, k1, cid[c])
                      for c, m in enumerate(inp_j)])
    agg_j = jagg.secure() if secure else jagg.PlainAggregation()
    sup_j = comp_j.support(agg_j.combine_messages(sk_j, jkey), inp_j[0])
    vals_j = jnp.stack([comp_j.values(m, sup_j, k0, k1, cid[c])
                        for c, m in enumerate(inp_j)])
    aggv_j = agg_j.combine_messages(vals_j, jax.random.fold_in(jkey, 0x5EED))
    dec_j = comp_j.reassemble(aggv_j, sup_j, inp_j[0])
    res_j = [comp_j.update_residual(m, sup_j, vals_j[c])
             for c, m in enumerate(inp_j)]

    # the port: the same steps, batched over the clients
    seeds = torch.tensor([tkc.client_stream_seed(K0, K1, c)
                          for c in range(clients)], dtype=torch.int64)
    agg_t = tagg.secure() if secure else tagg.PlainAggregation()
    dec_t, res_t = tengine._sketched_round(
        comp_t, agg_t, {k: torch.tensor(v) for k, v in msgs.items()},
        {k: torch.tensor(v) for k, v in resid.items()}, seeds, words, "cpu")

    # and its intermediate steps
    inp_t = {k: torch.tensor(msgs[k] + resid[k]) for k in msgs}
    sk_t = comp_t.encode(inp_t, seeds, device="cpu")
    np.testing.assert_array_equal(sk_t.numpy(), np.asarray(sk_j))
    sup_t = comp_t.support(agg_t.combine_messages(sk_t, words, device="cpu"),
                           {k: v[0] for k, v in inp_t.items()})
    np.testing.assert_array_equal(sup_t.numpy(), np.asarray(sup_j))
    vals_t = comp_t.values(inp_t, sup_t, seeds)
    np.testing.assert_array_equal(vals_t.numpy(), np.asarray(vals_j))
    np.testing.assert_array_equal(tkeys.phase2_key(words), np.asarray(
        jax.random.key_data(jax.random.fold_in(jkey, 0x5EED))))
    for k in msgs:
        np.testing.assert_array_equal(dec_t[k].numpy(), np.asarray(dec_j[k]))
        np.testing.assert_array_equal(
            res_t[k].numpy(), np.stack([np.asarray(r[k]) for r in res_j]))
    assert np.count_nonzero(np.asarray(sk_j)) > 0


@pytest.mark.parametrize("kw", [dict(rows=0), dict(rows=65), dict(cols=96),
                                dict(cols=True), dict(fraction=0.0),
                                dict(keep=0), dict(scale_bits=31)])
def test_config_validation(kw):
    with pytest.raises(ValueError):
        tfsk.sketch(**kw)


@pytest.mark.parametrize("kw,match", [
    (dict(cols=96), "power of two"), (dict(rows=0), "rows"),
    (dict(scale_bits=0), "scale_bits"),
    (dict(x=torch.zeros(1, 1, 128, dtype=torch.float64)), "f32"),
    (dict(su=torch.zeros(1, 2, dtype=torch.int64)), "su must be")])
def test_sketch_wrapper_checks_its_arguments(kw, match):
    args = dict(x=torch.zeros(1, 1, 128), su=torch.zeros(1, 3,
                                                         dtype=torch.int64),
                rows=2, cols=64, scale_bits=20)
    args.update(kw)
    x, su = args.pop("x"), args.pop("su")
    with pytest.raises(ValueError, match=match):
        tksk.sketch_encode(x, su, device="cpu", **args)


# the elements one block of csrc/sketch.cu takes from its client's
# message: kThreads x kLoads 16-byte pieces (128 rows of 128)
BLOCK_ELEMENTS = 4 * 512 * 8


@pytest.mark.parametrize("n_rows,rows,cols,base,kind", [
    (300, 4, 1024, 0, "sparse"), (7, 3, 1, 2 ** 32 - 300, "dense"),
    (5, 2, 64, 640, "special"), (1, 8, 16, 0, "dense"),
    (130, 8, 16384, 0, "sparse")])
def test_block_partition_replay_equals_plain_and_reference(
        n_rows, rows, cols, base, kind):
    """The kernel's arithmetic: each block hashes only the nonzero
    elements of its ``BLOCK_ELEMENTS`` share of a client's message, and
    the blocks' levels are added into one zero-filled sketch mod 2^32, in
    whatever order their atomics land."""
    clients = 3
    rng = np.random.default_rng(n_rows * 7 + cols)
    x = (rng.standard_normal((clients, n_rows, 128)) * 1e-3).astype(
        np.float32)
    if kind == "sparse":                 # pre-sparsified, as on the path
        x[np.abs(x) < 2.5e-3] = 0.0
    if kind == "special":
        x[:, 0, :5] = [np.nan, 0.0, -0.0, np.inf, 3e9]
    su = _su(clients, base)
    xt, sut = torch.tensor(x), torch.tensor(su.astype(np.int64))
    flat = xt.reshape(clients, -1)
    n = flat.shape[1]
    ctrs = tkc.counters(sut, n)
    q = tksk.round_to_grid(flat, ctrs, sut[:, 0:1], 20)
    q = torch.where(flat.abs() > 0, q, 0)     # the kernel's zero test
    total = torch.zeros(clients, rows * cols, dtype=torch.int64)
    # the blocks in reverse, so the order differs from the plain version's
    for e0 in reversed(range(0, n, BLOCK_ELEMENTS)):
        e1 = min(n, e0 + BLOCK_ELEMENTS)
        part = torch.zeros(clients, rows, cols, dtype=torch.int64)
        for r in range(rows):
            h, sgn = tksk.hash_and_sign(tksk.row_seed(sut[:, 2:3], r),
                                        ctrs[:, e0:e1], cols)
            part[:, r].scatter_add_(1, h, sgn * q[:, e0:e1])
        total = (total + (part.reshape(clients, -1) & 0xFFFFFFFF)) \
            & 0xFFFFFFFF
    got = tksk._to_int32(total).reshape(clients, rows, cols).numpy()
    kw = dict(rows=rows, cols=cols, scale_bits=20)
    np.testing.assert_array_equal(
        got, tksk.sketch_encode_plain(xt, sut, **kw).numpy())
    np.testing.assert_array_equal(
        got, _ref_encode(jksk.sketch_encode_xla, x, su, **kw))


def test_zero_and_nan_round_to_zero_for_every_u():
    """Why the kernel draws no u for +0, -0 and NaN: each rounds to level
    0 at every u in [0, 1], including both ends and every uniform a
    client's stream gives; a nonzero element below the grid step may round
    up at a small u, so it must draw."""
    ctrs = torch.arange(4096, dtype=torch.int64)[None]
    seed = torch.tensor([[tkc.client_stream_seed(K0, K1, 0)]])
    u = torch.cat([torch.tensor([0.0, 2.0 ** -32, 1e-7, 0.5, 1 - 2 ** -24,
                                 1.0]),
                   tkc.uniform(tksk.mask_bits(seed, ctrs))[0]])
    for value in (0.0, -0.0, float("nan")):
        x = torch.full_like(u, value)
        assert not tksk.round_level(x, u, 20).any()
    tiny = torch.full_like(u, 2.0 ** -40)
    assert tksk.round_level(tiny, u, 20)[0] == 1
    assert tksk.round_level(tiny, u, 20)[3] == 0

