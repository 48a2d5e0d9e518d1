"""The port's upload compression against the reference's.

* ``compress_2d_plain`` equals ``compress_2d_xla`` and the interpret-mode
  Pallas ``compress_2d_kernel`` bit for bit, given the same scalars, in
  all four (quantize, masked) cases, at a nonzero counter base, on a
  ragged (zero-padded) leaf and on NaN/inf inputs.  Bits are compared
  with every NaN mapped to one pattern (the payload of a NaN is not part
  of the function).  Inputs hold no subnormal numbers: XLA's CPU backend
  flushes them to zero, torch and the card keep them.
* The port's ``_pow2_step`` is the exact power of two of its definition.
  The reference computes it as ``exp2(ceil(log2(y)))``, which XLA's CPU
  backend evaluates inexactly for some integer exponents (relative error
  up to 2.03e-6).  So the compressors agree bit for bit where the
  reference's step is exact (e in [−14, 12] here), and elsewhere in
  their levels q, with the steps within 2.1e-6 relative.
* Inside the port, secure(qsgd) == plain(qsgd) bit for bit, also at the
  exponents −15 to −18 where the reference's CPU step is inexact.
* The ledger equals the reference's byte for byte at the MLP's full
  width for all three compressors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import protocol as jprotocol
from repro.fed import aggregation as jagg
from repro.fed import compression as jcomp
from repro.fed import sketch as jsketch
from repro.kernels import compress as jkc
from repro_torch.core import protocol as tprotocol
from repro_torch.fed import aggregation as tagg
from repro_torch.fed import compression as tcomp
from repro_torch.fed import sketch as tsketch
from repro_torch.kernels import compress as tkc

K0, K1 = 0x8BADF00D, 0x1234567
LB = 127


def _bits(a):
    """float32 bits with every NaN mapped to one pattern."""
    a = np.asarray(a, np.float32)
    return np.where(np.isnan(a), np.float32(np.nan), a).view(np.uint32)


def _assert_bits(got, want):
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _u32(rng, size):
    return rng.integers(0, 2 ** 32, size=size, dtype=np.uint64) \
        .astype(np.uint32)


def test_client_stream_seed_bitwise():
    rng = np.random.default_rng(0)
    k0, k1, cid = (_u32(rng, 2048) for _ in range(3))
    want = np.asarray(jkc.client_stream_seed(jnp.asarray(k0), jnp.asarray(k1),
                                             jnp.asarray(cid)))
    got = tkc.client_stream_seed(*(torch.tensor(v.astype(np.int64))
                                   for v in (k0, k1, cid)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert tkc.client_stream_seed(K0, K1, 7) == int(
        jkc.client_stream_seed(jnp.uint32(K0), jnp.uint32(K1), jnp.uint32(7)))


def _message(rng, clients, rows, *, ragged=0, special=False):
    x = (rng.standard_normal((clients, rows * 128)) * 0.05).astype(np.float32)
    x[:, :3] = np.float32(5 * 2.0 ** -10)          # exactly on lattice points
    if ragged:
        x[:, rows * 128 - ragged:] = 0.0           # a zero-padded leaf tail
    if special:
        # no subnormals: XLA's CPU backend flushes them to zero
        x[:, 3:9] = [np.nan, np.inf, -np.inf, -0.0, 3e38, -3e-38]
    return x.reshape(clients, rows, 128)


def _reference(fn, x, su, sf, **kw):
    outs = [fn(jnp.asarray(x[i]), jnp.asarray(su[i]), jnp.asarray(sf[i]), **kw)
            for i in range(x.shape[0])]
    return [np.stack([np.asarray(o[j]) for o in outs]) for j in range(2)]


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rows,base,ragged,special",
                         [(3, 0, 0, False), (5, 640, 77, False),
                          (2, 2 ** 32 - 200, 0, True)])
def test_compress_plain_equals_reference(quantize, masked, rows, base,
                                         ragged, special):
    rng = np.random.default_rng(rows * 7 + base % 97)
    x = _message(rng, 3, rows, ragged=ragged, special=special)
    seeds = [tkc.client_stream_seed(K0, K1, c) for c in (0, 4, 9)]
    su = np.asarray([[s, base] for s in seeds], np.uint32)
    delta = np.float32(2.0 ** -7) * np.asarray([1, 2, 0.5], np.float32)
    sf = np.stack([np.asarray([0.03, 0.05, 0.0], np.float32), delta], axis=1)
    kw = dict(lbound=LB, quantize=quantize, masked=masked)
    got = tkc.compress_2d(torch.tensor(x), torch.tensor(su.astype(np.int64)),
                          torch.tensor(sf), device="cpu", **kw)
    for fn in (jkc.compress_2d_xla,
               lambda *a, **k: jkc.compress_2d_kernel(*a, interpret=True, **k)):
        want = _reference(fn, x, su, sf, **kw)
        for g, w in zip(got, want):
            _assert_bits(g.numpy(), w)


def test_compress_wrapper_launches_nothing_on_the_cpu():
    x = torch.zeros(2, 1, 128)
    su = torch.zeros(2, 2, dtype=torch.int64)
    sf = torch.ones(2, 2)
    before = tkc.compress_2d.launches
    tkc.compress_2d(x, su, sf, lbound=1, quantize=True, masked=True,
                    device="cpu")
    assert tkc.compress_2d.launches == before


@pytest.mark.parametrize("kw,match", [
    (dict(x=torch.zeros(2, 1, 64)), "takes"),
    (dict(x=torch.zeros(2, 1, 128, dtype=torch.float64)), "f32"),
    (dict(su=torch.zeros(2, 2, dtype=torch.int32)), "su must be"),
    (dict(sf=torch.ones(3, 2)), "sf must be"),
    (dict(lbound=0), "lbound")])
def test_compress_wrapper_checks_its_arguments(kw, match):
    args = dict(x=torch.zeros(2, 1, 128), su=torch.zeros(2, 2,
                                                         dtype=torch.int64),
                sf=torch.ones(2, 2), lbound=1)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        tkc.compress_2d(args["x"], args["su"], args["sf"],
                        lbound=args["lbound"], quantize=True, masked=True,
                        device="cpu")


def _exact_step(maxabs, lbound):
    """The smallest power of two ≥ fl(max(m, 1e-38) / L), in float64."""
    y = np.float64(np.maximum(np.float32(maxabs), np.float32(1e-38))
                   / np.float32(lbound))
    m, p = np.frexp(y)
    e = 127 if np.isinf(y) else np.clip(p - 1 if m == 0.5 else p, -126, 127)
    return np.float32(2.0 ** e) if maxabs > 0 else np.float32(1.0)


@pytest.mark.parametrize("lbound", [1, 127, 32767])
def test_pow2_step_is_exact(lbound):
    rng = np.random.default_rng(lbound)
    pows = np.float32(2.0) ** np.arange(-140, 128, dtype=np.float32)
    pows = pows[pows > 0]
    scaled = pows[pows < np.float32(3e38) / lbound] * np.float32(lbound)
    vals = np.concatenate([
        pows, np.nextafter(pows, np.float32(np.inf)),
        np.nextafter(pows, np.float32(0)),
        scaled, np.nextafter(scaled, np.float32(np.inf)),
        (rng.lognormal(0, 20, 4000)).astype(np.float32),
        np.asarray([0.0, 1e-45, 1e-38, 3.4e38, np.inf], np.float32)])
    got = tcomp._pow2_step(torch.tensor(vals), lbound).numpy()
    want = np.asarray([_exact_step(v, lbound) for v in vals], np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # a NaN message gets Δ = 1, as in the reference
    assert tcomp._pow2_step(torch.tensor([np.nan]), lbound).item() == 1.0


def _tree(rng, clients, scale):
    # a leaf whose size is not a multiple of 128, as the MLP's are
    return {"w1": (rng.standard_normal((clients, 20, 7)) * scale)
            .astype(np.float32),
            "w2": (rng.standard_normal((clients, 7, 3)) * scale)
            .astype(np.float32)}


def _ref_compress(comp, tree, resid, clients):
    outs, res = [], []
    for c in range(clients):
        m = {k: jnp.asarray(v[c]) for k, v in tree.items()}
        r = () if resid is None else {k: jnp.asarray(v[c])
                                      for k, v in resid.items()}
        o, nr = comp.compress(m, r, jnp.uint32(K0), jnp.uint32(K1),
                              jnp.uint32(c))
        outs.append(o)
        res.append(nr)
    stack = lambda ts: {k: np.stack([np.asarray(t[k]) for t in ts])  # noqa
                        for k in tree}
    return stack(outs), (None if resid is None else stack(res))


def _port_compress(comp, tree, resid, clients):
    seeds = torch.tensor([tkc.client_stream_seed(K0, K1, c)
                          for c in range(clients)], dtype=torch.int64)
    t = {k: torch.tensor(v) for k, v in tree.items()}
    r = None if resid is None else {k: torch.tensor(v)
                                    for k, v in resid.items()}
    out, nr = comp.compress(t, r, seeds, device="cpu")
    return ({k: v.numpy() for k, v in out.items()},
            None if nr is None else {k: v.numpy() for k, v in nr.items()})


def _ref_steps(tree, lbound, per_leaf):
    """The reference's Δ per client (and leaf), from its own _pow2_step."""
    if per_leaf:
        return {k: np.asarray([float(jcomp._pow2_step(
            jnp.max(jnp.abs(jnp.asarray(v[c]))), lbound))
            for c in range(v.shape[0])]) for k, v in tree.items()}
    flat = np.concatenate([v.reshape(v.shape[0], -1) for v in tree.values()],
                          axis=1)
    steps = np.asarray([float(jcomp._pow2_step(jnp.max(jnp.abs(
        jnp.asarray(f))), lbound)) for f in flat])
    return {k: steps for k in tree}


CASES = [("qsgd8", lambda: (jcomp.qsgd(8), tcomp.qsgd(8)), 127, True),
         ("qsgd4", lambda: (jcomp.qsgd(4), tcomp.qsgd(4)), 7, True),
         ("topk", lambda: (jcomp.topk(0.2), tcomp.topk(0.2)), None, False),
         ("topk8", lambda: (jcomp.topk(0.2, bits=8),
                            tcomp.topk(0.2, bits=8)), 127, False)]


@pytest.mark.parametrize("name,make,lbound,per_leaf", CASES,
                         ids=[c[0] for c in CASES])
@pytest.mark.parametrize("scale", [0.05, 2e-4, 3e-6])
def test_compressors_match_reference(name, make, lbound, per_leaf, scale):
    rng = np.random.default_rng(int(scale * 1e7) + len(name))
    clients = 3
    tree = _tree(rng, clients, scale)
    jc, tc = make()
    resid = None
    if tc.stateful:
        resid = {k: (v * 0.3).astype(np.float32)
                 for k, v in _tree(rng, clients, scale).items()}
    want, want_r = _ref_compress(jc, tree, resid, clients)
    got, got_r = _port_compress(tc, tree, resid, clients)
    inp = tree if resid is None else {k: tree[k] + resid[k] for k in tree}
    if lbound is None:          # no step: bit for bit
        for k in tree:
            _assert_bits(got[k], want[k])
            _assert_bits(got_r[k], want_r[k])
        return
    ref_steps = _ref_steps(inp, lbound, per_leaf)
    exact = all(np.all(np.exp2(np.round(np.log2(s))) == s)
                for s in ref_steps.values())
    for k in tree:
        step = ref_steps[k].reshape(-1, 1, 1)
        port_step = np.exp2(np.round(np.log2(step)))
        np.testing.assert_allclose(step, port_step, rtol=2.1e-6, atol=0)
        if exact:
            _assert_bits(got[k], want[k])
            if got_r is not None:
                _assert_bits(got_r[k], want_r[k])
        else:
            np.testing.assert_array_equal(got[k] / port_step,
                                          np.round(want[k] / step))
            q = got[k] / port_step
            assert np.all(q == np.round(q)) and np.all(np.abs(q) <= lbound)
    if scale == 0.05:
        assert exact            # e in [−14, 12]: the reference's Δ is exact


@pytest.mark.parametrize("scale,exponents", [
    (0.05, (-10, -9)), (1e-3, (-16, -15)), (4e-4, (-17, -16)),
    (1.5e-4, (-18, -17)), (6e-5, (-20, -19))])
def test_secure_qsgd_equals_plain_bitwise(scale, exponents):
    # per-leaf steps 2^e with e in `exponents` at L = 127: all on the
    # 2^-20 grid of secure(), all but the first where XLA's CPU exp2 is
    # inexact
    rng = np.random.default_rng(17)
    clients = 10
    tree = {k: torch.tensor(v) for k, v in _tree(rng, clients, scale).items()}
    steps = torch.cat([tcomp._pow2_step(v.abs().amax(dim=(1, 2)), 127)
                       for v in tree.values()])
    e = torch.log2(steps)
    assert (e.min().item(), e.max().item()) == exponents
    seeds = torch.tensor([tkc.client_stream_seed(K0, K1, c)
                          for c in range(clients)], dtype=torch.int64)
    comp, _ = tcomp.qsgd(8).compress(tree, None, seeds, device="cpu")
    kw = np.asarray([K0, K1], np.uint32)
    plain = tagg.PlainAggregation().combine_messages(comp, kw, device="cpu")
    sec = tagg.secure().combine_messages(comp, kw, device="cpu")
    for k in tree:
        assert torch.equal(plain[k].view(torch.int32), sec[k].view(torch.int32))


def _mlp_params():
    return {"w1": np.zeros((128, 784), np.float32),
            "w2": np.zeros((10, 128), np.float32)}


LEDGER = [
    ("topk8_secure", lambda m: m.topk(0.1, bits=8), True,
     (406_564, 4_065_640, 4_065_280, 101_632)),
    ("qsgd8_plain", lambda m: m.qsgd(8), False,
     (101_640, 1_016_400, 4_065_280, 101_632)),
    ("sketch_secure", lambda m: m.sketch(4, 1024, 0.02, keep=256), True,
     (24_552, 245_520, 4_146_600, 6_129)),
]


@pytest.mark.parametrize("name,make,secure,want", LEDGER,
                         ids=[c[0] for c in LEDGER])
def test_ledger_equals_reference_at_full_width(name, make, secure, want):
    p_np = _mlp_params()
    jmod = jsketch if name.startswith("sketch") else jcomp
    tmod = tsketch if name.startswith("sketch") else tcomp
    jalg = jprotocol.SSCAUnconstrained(loss_fn=None, hp=None)
    talg = tprotocol.SSCAUnconstrained(loss_fn=None, hp=None)
    ja = jagg.secure() if secure else jagg.PlainAggregation()
    ta = tagg.secure() if secure else tagg.PlainAggregation()
    jl = jcomp.round_bytes(jalg, ja, make(jmod),
                           {k: jnp.asarray(v) for k, v in p_np.items()}, 10)
    tl = tcomp.round_bytes(talg, ta, make(tmod),
                           {k: torch.tensor(v) for k, v in p_np.items()}, 10)
    assert tl.as_dict() == jl.as_dict()
    assert (tl.uplink_per_client, tl.uplink_total, tl.downlink_total,
            tl.breakdown["wire_elements"]) == want


def test_construction_validation():
    for bad in (1, 17, True, 2.5):
        with pytest.raises(ValueError):
            tcomp.qsgd(bad)
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError):
            tcomp.topk(bad)
    with pytest.raises(ValueError):
        tcomp.topk(0.1, bits=1)
