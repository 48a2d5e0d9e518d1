"""The port's ``fed/staleness.py`` against the reference's on the same
numpy inputs.

Exact (bit for bit): ``round_times``, ``dropped_per_round``,
``diurnal_delay_probs`` (numpy copies), the staleness draw of
``partition.sample_staleness``, ``ConstantDiscount``, the polynomial
discount at τ = 0 and at a = 0, ``StalenessConfig``'s frozen fields, and
``discount_reweight``'s exact properties inside the port: scale exactly
1.0 at d ≡ 1 (the weights come back bit for bit), a dropped slot gets
exactly 0, an all-dropped round zero weights.

The packed snapshot ring (``RingMeta`` and its helpers), bit for bit
against the reference's on the same ring: a params tree holding NaN
payloads, −0.0 and an int32 leaf, over 1, 2 and 3 ranks (n = 41 pads
to 42), the ranks' placed blocks summed as the psum would (one
contributor a column); ``ring_meta`` refuses a leaf that does not route
as int32 bits, as the reference refuses a non-4-byte one.

Within tolerance: ``PolynomialDiscount`` at τ > 0 is f32 ``pow`` on both
sides (XLA's and torch's), held to 1 ulp (measured over τ = 0 … 40:
1 ulp at a = 0.5, equal at a = 1 and 2); ``discount_reweight`` sums its
S weights in another order than XLA's reduction, held to 2 ulp
(measured: equal at S = 8 and 10, 1 ulp at S = 33).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import partition as jpart
from repro.fed import staleness as jst
from repro_torch.data import partition as tpart
from repro_torch.fed import staleness as tst

TAUS = np.arange(41, dtype=np.int64)


@pytest.mark.parametrize("a", [0, 0.5, 1.0, 2.0])
def test_polynomial_discount_matches_reference(a):
    got = tst.PolynomialDiscount(a).discount(torch.as_tensor(TAUS)).numpy()
    want = np.asarray(jst.PolynomialDiscount(a).discount(jnp.asarray(TAUS)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    assert got[0] == 1.0                 # fresh uploads never perturbed
    if a == 0:
        np.testing.assert_array_equal(got, np.ones_like(got))


def test_constant_discount_and_config_discount():
    got = tst.ConstantDiscount().discount(torch.as_tensor(TAUS)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jst.ConstantDiscount().discount(jnp.asarray(TAUS))))
    cfg = tst.StalenessConfig(max_staleness=3,
                              schedule=tst.PolynomialDiscount(1.0))
    np.testing.assert_array_equal(
        cfg.discount(torch.as_tensor(TAUS)).numpy(),
        tst.PolynomialDiscount(1.0).discount(torch.as_tensor(TAUS)).numpy())


def _weights(s, seed):
    return np.random.default_rng(seed).dirichlet(np.ones(s)) \
        .astype(np.float32)


@pytest.mark.parametrize("s,seed", [(8, 0), (10, 1), (33, 2)])
def test_discount_reweight_matches_reference(s, seed):
    w = _weights(s, seed)
    rng = np.random.default_rng(seed + 10)
    tau = rng.integers(0, 4, s)
    disc = np.asarray(jst.PolynomialDiscount(0.5).discount(jnp.asarray(tau)))
    disc = np.where(rng.random(s) < 0.3, np.float32(0.0), disc)
    got = tst.discount_reweight(torch.as_tensor(w),
                                torch.as_tensor(disc)).numpy()
    want = np.asarray(jst.discount_reweight(jnp.asarray(w),
                                            jnp.asarray(disc)))
    np.testing.assert_array_max_ulp(got, want, maxulp=2)
    np.testing.assert_array_equal(got[disc == 0], 0.0)
    np.testing.assert_allclose(got.sum(), w.sum(), rtol=1e-6)


def test_discount_reweight_exact_properties():
    w = torch.as_tensor(_weights(10, 5))
    # d ≡ 1: the weights come back bit for bit
    assert torch.equal(tst.discount_reweight(w, torch.ones(10)), w)
    # all dropped: zero weights, no NaN
    out = tst.discount_reweight(w, torch.zeros(10))
    assert torch.equal(out, torch.zeros(10))
    # one survivor takes the cohort's whole mass
    d = torch.zeros(10)
    d[3] = 0.5
    out = tst.discount_reweight(w, d)
    assert torch.count_nonzero(out) == 1
    np.testing.assert_allclose(float(out[3]), float(w.sum()), rtol=1e-6)


def test_round_times_and_drops_match_reference():
    trace = jpart.sample_staleness(10, np.arange(1, 21), 0,
                                   [0.5, 0.2, 0.15, 0.1, 0.05])
    for k in (0, 1, 2, 4):
        for mode in ("sync", "async", "drop"):
            got = tst.round_times(trace, mode, k)
            np.testing.assert_array_equal(got, jst.round_times(trace, mode, k))
            assert got.dtype == np.float64
        np.testing.assert_array_equal(tst.dropped_per_round(trace, k),
                                      jst.dropped_per_round(trace, k))
    # the chip phase's trace: 33 drops at K = 2, 107 at K = 0
    assert tst.dropped_per_round(trace, 2).sum() == 33
    assert tst.dropped_per_round(trace, 0).sum() == 107
    with pytest.raises(ValueError, match="mode"):
        tst.round_times(trace, "eventually", 2)


@pytest.mark.parametrize("rounds,max_delay,frac,period",
                         [(20, 4, 0.4, 20), (7, 1, 0.9, 3)])
def test_diurnal_delay_probs_match_reference(rounds, max_delay, frac,
                                            period):
    got = tst.diurnal_delay_probs(rounds, max_delay, frac, period)
    np.testing.assert_array_equal(
        got, jst.diurnal_delay_probs(rounds, max_delay, frac, period))
    np.testing.assert_allclose(got.sum(axis=1), 1.0)
    # the port's staleness draw from it is the reference's
    ids = np.arange(1, rounds + 1)
    np.testing.assert_array_equal(
        tpart.sample_staleness(6, ids, 3, got),
        jpart.sample_staleness(6, ids, 3, got))
    with pytest.raises(ValueError, match="max_delay"):
        tst.diurnal_delay_probs(4, 0)


def test_staleness_config_is_frozen_hashable_and_validated():
    a = tst.StalenessConfig(max_staleness=np.int64(2),
                            delay_probs=np.array([0.5, 0.3, 0.2]))
    b = tst.StalenessConfig(max_staleness=2, delay_probs=[0.5, 0.3, 0.2])
    assert a == b and hash(a) == hash(b)
    assert a.delay_probs == (0.5, 0.3, 0.2) and type(a.max_staleness) is int
    ref = jst.StalenessConfig(max_staleness=2, delay_probs=[0.5, 0.3, 0.2])
    assert a.delay_probs == ref.delay_probs
    two = tst.StalenessConfig(delay_probs=[[0.9, 0.1], [0.5, 0.5]])
    assert two.delay_probs == ((0.9, 0.1), (0.5, 0.5))
    assert tst.StalenessConfig().delay_probs is None
    assert tst.StalenessConfig().schedule == tst.PolynomialDiscount(0.5)
    with pytest.raises(Exception):
        a.max_staleness = 3
    for bad in (-1, True, 1.5, "2"):
        with pytest.raises(ValueError, match="max_staleness"):
            tst.StalenessConfig(max_staleness=bad)
    with pytest.raises(ValueError, match="1-D or 2-D"):
        tst.StalenessConfig(delay_probs=np.ones((2, 2, 2)))
    for bad in (-0.5, True, "a"):
        with pytest.raises(ValueError, match="nonnegative"):
            tst.PolynomialDiscount(bad)


def ring_params(depth: int):
    """A ring of ``depth`` snapshots of a three-leaf tree (n = 41):
    (depth, …) leaves with NaN payloads, −0.0 and an int32 leaf."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((depth, 4, 7)).astype(np.float32)
    bits = w.view(np.uint32)
    bits[0, 0, 0] = 0x7FC01234
    bits[1, 2, 3] = 0x80000000
    return {"b": rng.standard_normal((depth, 5)).astype(np.float32),
            "k": rng.integers(-2 ** 31, 2 ** 31, (depth, 8)).astype(
                np.int32),
            "w": w}


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_packed_ring_matches_reference(shards):
    phist = ring_params(3)
    tp = {k: torch.as_tensor(v) for k, v in phist.items()}
    jp = {k: jnp.asarray(v) for k, v in phist.items()}
    snap0 = {k: v[0] for k, v in tp.items()}
    meta = tst.ring_meta(snap0, shards)
    jmeta = jst.ring_meta({k: v[0] for k, v in jp.items()}, shards)
    assert (meta.n, meta.chunk, meta.shards) \
        == (jmeta.n, jmeta.chunk, jmeta.shards) == (41, -(-41 // shards),
                                                    shards)
    packed = tst.pack_ring(tp, meta)
    np.testing.assert_array_equal(_bits(packed.numpy()),
                                  _bits(jst.pack_ring(jp, jmeta)))
    np.testing.assert_array_equal(
        _bits(tst.pack_snapshot(snap0, meta).numpy()),
        _bits(jst.pack_snapshot({k: v[0] for k, v in jp.items()}, jmeta)))
    # every rank's block placed and summed: the packed ring, exactly
    blocks = [tst.ring_localize(packed, meta, r) for r in range(shards)]
    for r, b in enumerate(blocks):
        assert b.shape == (3, meta.chunk) and b.dtype == torch.int32
        np.testing.assert_array_equal(
            _bits(b.numpy()),
            _bits(jst.ring_localize(jst.pack_ring(jp, jmeta), jmeta, r)))
    contributions = [tst.ring_unshard(b, meta, r, lambda x: x)
                     for r, b in enumerate(blocks)]
    whole = tst.ring_unshard(blocks[0], meta, 0,
                             lambda x: sum(contributions))
    assert torch.equal(whole, packed)
    for k, v in tst.unpack_ring(whole, meta).items():
        assert v.dtype == tp[k].dtype
        np.testing.assert_array_equal(_bits(v.numpy()), _bits(phist[k]))
    for slot in range(3):
        got = tst.unpack_snapshot(whole, meta, slot)
        want = jst.unpack_snapshot(jst.pack_ring(jp, jmeta), jmeta, slot)
        for k in phist:
            np.testing.assert_array_equal(_bits(got[k].numpy()),
                                          _bits(want[k]))


def test_ring_meta_refuses_what_does_not_route():
    assert tst.ring_meta({"h": torch.zeros(3, dtype=torch.float16)},
                         2) is None
    assert jst.ring_meta({"h": jnp.zeros(3, jnp.float16)}, 2) is None
    assert tst.ring_meta({"d": torch.zeros(3, dtype=torch.float64),
                          "w": torch.zeros(3)}, 2) is None
    assert tst.ring_meta({"w": torch.zeros(3)}, 2).chunk == 2
