"""The port's hierarchical (two-level) secure aggregation against live JAX.

Message level, on the reference's own grid (``tests/test_hierarchical.py``:
(S, n, G, seed) over G = 1, G = S, G | S, G ∤ S and S > 16), bit for bit:
the port's ``hierarchical(secure(), G)`` and the reference's, as the int32
root before finalize and dequantized; the plain inner on messages on the
2^-20 grid, where float sums are exact; count-sketch tables under the
tree; the ring mode's plain version (``masked_ring_sum_plain``) against
the reference's ``masked_ring_partial_sum``, with dropouts and an offset,
and level 2 split over group shards (``lo + hi == whole``);
``group_key_words``; ``sample_groups``; every ledger hook, and
``round_bytes`` at S = 12, G = 4 (6,736 B a round).  Inside the port, the
tree equals the flat combine bit for bit on the same messages, and its
two levels run over (group, member) tiles at their offsets add up to the
whole tree, as a mesh would run them.

Engine level (``tests/test_hierarchical.py``'s configuration: 400
samples over I = 8 clients, B = 5, T = 4, seed 3, hidden 16, eval every
2 rounds on 100 samples, the reference's initial weights):
``hierarchical(secure(), G)`` equals flat ``secure()`` in the port bit for
bit at G = 2 and 3 (3 ∤ 8: one sentinel member); the port's tree tracks
the reference's with ``History.comm`` and the eval rounds exact.  Final
weights, largest difference measured on the CPU (tolerance): secure
G = 2 and 3, 2.7e-6 (atol 2e-5: a gradient entry on the other side of a
2^-20 grid rounding); with ``topk(0.2, bits=8)``, 6.2e-5 (atol 1e-3,
``test_torch_runtime.py``'s reason: a level can round the other way);
async with dropouts (``StalenessConfig(1, delay_probs=[0.4, 0.3, 0.2,
0.1])``, 10 of 32 slots dropped, 4 (M − 1) recovery bytes each), 2.7e-6
(atol 2e-5).  Train cost 1.0e-7 relative (rtol 1e-5), test accuracy
1.5e-8 (atol 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import protocol as jprotocol
from repro.core import ssca as jssca
from repro.data import partition as jpart
from repro.data import synthetic
from repro.fed import aggregation as jagg
from repro.fed import compression as jcomp
from repro.fed import runtime as jrt
from repro.fed import sketch as jsketch
from repro.fed.staleness import StalenessConfig as JConfig
from repro.kernels import ops as jops
from repro.kernels import secure_agg as jsa
from repro.mlpapp import model as jm
from repro_torch.core import protocol, ssca
from repro_torch.data import partition as tpart
from repro_torch.fed import aggregation as tagg
from repro_torch.fed import compression as tcomp
from repro_torch.fed import runtime as trt
from repro_torch.fed.staleness import StalenessConfig
from repro_torch.kernels import ops as tops
from repro_torch.kernels import secure_agg as tsa
from repro_torch.mlpapp import model as tm

SCALE = 2.0 ** -20
GRID = [(2, 7, 1, 0), (5, 3, 2, 1), (10, 16, 4, 2), (13, 37, 5, 3),
        (8, 5, 8, 4), (21, 12, 4, 5)]
KW = dict(batch_size=5, rounds=4, eval_every=2, eval_samples=100, seed=3,
          hidden=16)
PROBS = [0.4, 0.3, 0.2, 0.1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _grid_msgs(rng, s, n):
    """Messages on the 2^-20 grid, as numpy: their float sums are exact."""
    return {"w": (rng.integers(-4000, 4001, (s, n)) * SCALE)
            .astype(np.float32),
            "b": (rng.integers(-4000, 4001, (s, max(1, n // 2))) * SCALE)
            .astype(np.float32)}


def _both(inner_name):
    return {"secure": (jagg.secure(), tagg.secure()),
            "plain": (jagg.plain(), tagg.plain())}[inner_name]


@pytest.mark.parametrize("inner", ["secure", "plain"])
@pytest.mark.parametrize("s,n,groups,seed", GRID)
def test_tree_combine_equals_reference(inner, s, n, groups, seed):
    rng = np.random.default_rng(seed)
    msgs = _grid_msgs(rng, s, n)
    key = jax.random.key(seed)
    kd = np.asarray(jax.random.key_data(key))
    j_inner, t_inner = _both(inner)
    jtree = jagg.HierarchicalAggregation(inner=j_inner, groups=groups)
    ttree = tagg.HierarchicalAggregation(inner=t_inner, groups=groups)
    jmsgs = {k: jnp.asarray(v) for k, v in msgs.items()}
    tmsgs = {k: torch.from_numpy(v) for k, v in msgs.items()}
    want = jtree.combine_messages(jmsgs, key)
    got = ttree.combine_messages(tmsgs, kd, device="cpu")
    flat = t_inner.combine_messages(tmsgs, kd, device="cpu")
    for k in msgs:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert torch.equal(got[k], flat[k])
    if inner == "secure":                    # the int32 root, pre-finalize
        jroot = jtree.partial_combine(jmsgs, key, 0, None)
        troot = ttree.partial_combine(tmsgs, kd, 0, None, device="cpu")
        for k in msgs:
            assert troot[k].dtype == torch.int32
            np.testing.assert_array_equal(troot[k].numpy(),
                                          np.asarray(jroot[k]))


@pytest.mark.parametrize("s,groups,seed", [(4, 2, 0), (9, 3, 1), (10, 4, 2)])
def test_sketch_messages_under_the_tree(s, groups, seed):
    """The reference's count-sketch tables of on-grid messages (one bare
    (S, rows, cols) tensor) through both trees and the port's flat
    secure combine: all bit for bit."""
    rng = np.random.default_rng(seed)
    comp = jsketch.sketch(rows=2, cols=64, fraction=0.1, keep=8)
    inp = {"w": jnp.asarray(rng.integers(-4000, 4001, (s, 50)) * SCALE,
                            jnp.float32)}
    sk = jax.vmap(lambda m, c: comp.encode(m, jnp.uint32(seed),
                                           jnp.uint32(seed ^ 0xA5), c)
                  )(inp, jnp.arange(s, dtype=jnp.uint32))
    key = jax.random.key(seed)
    kd = np.asarray(jax.random.key_data(key))
    want = jagg.hierarchical(jagg.secure(), groups=groups) \
        .combine_messages(sk, key)
    tsk = torch.from_numpy(np.asarray(sk))
    got = tagg.hierarchical(tagg.secure(), groups=groups) \
        .combine_messages(tsk, kd, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, tagg.secure().combine_messages(tsk, kd,
                                                           device="cpu"))


@pytest.mark.parametrize("alive", [None, [1, 0, 1, 1, 1, 1, 0, 1, 1, 1, 1,
                                           1]])
def test_tree_levels_split_over_tiles(alive):
    """``tree_local`` over (group, member) tiles at their offsets, the
    member tiles' partials added (a mesh's member reduction), then
    ``tree_merge`` over the group tiles at their offsets, added (its group
    reduction): ``tree_combine``'s root bit for bit."""
    rng = np.random.default_rng(11)
    s, g, m = 12, 4, 3
    msgs = {"w": torch.from_numpy(_grid_msgs(rng, s, 9)["w"])}
    kd = np.asarray([5, 6], np.uint32)
    tree = tagg.hierarchical(tagg.secure(), groups=g)
    grouped = tree._group(msgs, s)
    rows = None if alive is None else tree._group_alive(
        torch.tensor(alive), s)
    whole = tree.tree_combine(grouped, kd, alive=rows, device="cpu")

    def local(gs, ms):
        return tree.tree_local(
            {"w": grouped["w"][gs, ms]}, kd, group_offset=gs.start,
            member_offset=ms.start, members=m,
            alive=None if rows is None else rows[gs], device="cpu")

    root = 0
    for gs in (slice(0, 1), slice(1, 4)):
        level1 = local(gs, slice(0, 2)) + local(gs, slice(2, 3))
        root = root + tree.tree_merge(level1, kd, group_offset=gs.start,
                                      num_groups=g, device="cpu")
    assert torch.equal(root, whole)


def test_ring_sum_equals_reference_and_splits_over_shards():
    rng = np.random.default_rng(7)
    q = rng.integers(-2 ** 30, 2 ** 30, (6, 17)).astype(np.int32)
    kd = np.asarray(jax.random.key_data(jax.random.key(3)))
    whole = jops.secure_ring_partial_sum({"p": jnp.asarray(q)}, kd,
                                         group_offset=0, num_groups=6)

    def port(rows, offset):
        # the flat (G_loc, R, 128) int32 layout of level 1's buffer
        flat = torch.from_numpy(np.pad(rows, ((0, 0), (0, 128 - 17))))
        return tops.secure_ring_partial_sum(
            flat.reshape(-1, 1, 128), kd, group_offset=offset,
            num_groups=6, device="cpu").reshape(-1)[:17]

    got = port(q, 0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(whole["p"]))
    assert torch.equal(got, port(q[:2], 0) + port(q[2:], 2))
    np.testing.assert_array_equal(
        got.numpy(), np.sum(q.astype(np.int64), 0).astype(np.int32))


@pytest.mark.parametrize("num,offset,groups,alive", [
    (3, 0, 3, None), (3, 2, 7, [1, 0, 1, 1, 1, 0, 1]), (1, 0, 1, None),
    (17, 0, 17, None), (4, 5, 20, [1] * 19 + [0])])
def test_masked_ring_sum_plain_equals_reference(num, offset, groups, alive):
    """Full-range int32 rows; 17 and 20 groups take the reference's scan
    path (past 16 unrolled clients)."""
    rng = np.random.default_rng(num + groups)
    q = rng.integers(-2 ** 31, 2 ** 31, (num, 40)).astype(np.int32)
    k0, k1 = 0x8BADF00D, 0x1234567
    a_j = None if alive is None else jnp.asarray(alive, jnp.int32)
    a_t = None if alive is None else torch.tensor(alive, dtype=torch.int32)
    want = jsa.masked_ring_partial_sum(jnp.asarray(q), jnp.uint32(k0),
                                       jnp.uint32(k1), offset, groups,
                                       alive=a_j)
    got = tsa.masked_ring_sum_plain(torch.from_numpy(q), k0, k1,
                                    num_clients=groups, client_offset=offset,
                                    alive=a_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the wrapper on a CPU tensor is the plain version
    rows = torch.from_numpy(np.pad(q, ((0, 0), (0, 88)))).reshape(num, 1,
                                                                   128)
    assert torch.equal(tsa.masked_ring_sum_2d(
        rows, k0, k1, num_clients=groups, client_offset=offset, alive=a_t,
        device="cpu").reshape(-1)[:40], got)


@pytest.mark.parametrize("k0,k1", [(0, 0), (1, 2), (0xFFFFFFFF, 0x47525550),
                                   (0x8BADF00D, 0x1234567)])
def test_group_key_words_equal_reference(k0, k1):
    want = jsa.group_key_words(jnp.uint32(k0), jnp.uint32(k1))
    assert tsa.group_key_words(k0, k1) == tuple(int(w) for w in want)


@pytest.mark.parametrize("s,groups,seed", [(10, 3, 9), (6, 1, 0), (32, 4, 2),
                                           (512, 16, 0)])
def test_sample_groups_equals_reference(s, groups, seed):
    ids = np.arange(1, 9, dtype=np.int64)
    np.testing.assert_array_equal(
        tpart.sample_groups(s, groups, ids, seed),
        jpart.sample_groups(s, groups, ids, seed))


@pytest.mark.parametrize("inner", ["secure12", "secure", "plain",
                                   "sampled12"])
@pytest.mark.parametrize("groups", [1, 4, 5, 12])
def test_ledger_hooks_equal_reference(inner, groups):
    j_inner, t_inner = {
        "secure12": (jagg.secure(num_sampled=12),
                     tagg.secure(num_sampled=12)),
        "secure": (jagg.secure(), tagg.secure()),
        "plain": (jagg.plain(), tagg.plain()),
        "sampled12": (jagg.sampled(12), tagg.sampled(12))}[inner]
    j = jagg.hierarchical(j_inner, groups=groups)
    t = tagg.hierarchical(t_inner, groups=groups)
    i = 12 if inner in ("secure", "plain") else 100
    assert t.members(i) == j.members(i)
    assert t.participants(i) == j.participants(i)
    assert t.scale_bits == j.scale_bits
    assert t.uplink_wire_bytes(777, 103, i) == j.uplink_wire_bytes(777, 103,
                                                                   i)
    assert t.recovery_bytes_per_drop(i) == j.recovery_bytes_per_drop(i)
    assert t.group_uplink_bytes(777, 103, i) \
        == j.group_uplink_bytes(777, 103, i)
    assert t.mask_pair_count(i) == j.mask_pair_count(i)
    assert t.root_ingest_bytes(103, i) == j.root_ingest_bytes(103, i)


def test_round_bytes_equal_reference():
    """S = 12, G = 4, dense = 103: 12 x 420 per-client bytes and a
    1,696-byte edge hop, 6,736 in all; flat secure charges no hop."""
    alg = protocol.SSCAUnconstrained(loss_fn=None,
                                     hp=ssca.SSCAHyperParams())
    jalg = jprotocol.SSCAUnconstrained(loss_fn=None,
                                       hp=jssca.SSCAHyperParams())
    params = {"w": torch.zeros(100), "b": torch.zeros(3)}
    jparams = {"w": jnp.zeros((100,)), "b": jnp.zeros((3,))}
    for j_agg, t_agg in (
            (jagg.hierarchical(jagg.secure(num_sampled=12), groups=4),
             tagg.hierarchical(tagg.secure(num_sampled=12), groups=4)),
            (jagg.secure(num_sampled=12), tagg.secure(num_sampled=12)),
            (jagg.hierarchical(jagg.plain(), groups=4),
             tagg.hierarchical(tagg.plain(), groups=4))):
        want = jcomp.round_bytes(jalg, j_agg, None, jparams, 100)
        got = tcomp.round_bytes(alg, t_agg, None, params, 100)
        assert got.as_dict() == want.as_dict()
    assert tcomp.round_bytes(
        alg, tagg.hierarchical(tagg.secure(num_sampled=12), groups=4), None,
        params, 100).uplink_total == 12 * 420 + 1696 == 6736


@pytest.mark.parametrize("make,exc", [
    (lambda a: a.hierarchical(groups=0), ValueError),
    (lambda a: a.hierarchical(groups=-2), ValueError),
    (lambda a: a.hierarchical(groups=True), ValueError),
    (lambda a: a.hierarchical(groups=2.0), ValueError),
    (lambda a: a.hierarchical(a.hierarchical(groups=2), groups=2),
     ValueError),
    (lambda a: a.hierarchical(a.secure(num_sampled=4),
                              groups=8).cohort_size(100), ValueError),
    (lambda a: a.hierarchical(groups=2).partial_combine(
        {"w": torch.zeros(4, 3)}, np.zeros(2, np.uint32), 2, 8), ValueError),
])
def test_validation_errors(make, exc):
    """The port refuses what the reference refuses (the last case: a flat
    cohort shard, which only the port's tensors reach)."""
    if "partial_combine" not in make.__code__.co_names:
        with pytest.raises(exc):
            make(jagg)
    with pytest.raises(exc):
        make(tagg)


def test_tree_defaults_and_grid_see_through():
    t = tagg.hierarchical()
    assert t.groups == 16 and t.inner == tagg.secure()
    assert tagg.hierarchical(tagg.secure(scale_bits=18), groups=2) \
        .scale_bits == 18
    assert tagg.hierarchical(tagg.plain(), groups=2).scale_bits is None


@pytest.fixture(scope="module")
def small_setup():
    data = synthetic.classification_dataset(n_train=400, n_test=100, seed=0)
    part = jpart.iid(400, 8, seed=0)
    p0 = jm.init_params(jax.random.key(3), 784, 16, 10)
    return data, part, p0


def _port(p0):
    return tm.params_from_numpy(p0, "cpu")


def test_hier_secure_equals_flat_secure_in_the_port(small_setup):
    data, part, p0 = small_setup
    p_flat, h_flat = trt.run_alg1(data, part, params=_port(p0), secure=True,
                                  device="cpu", **KW)
    for g in (2, 3):                             # 3 ∤ 8: a padded group
        p_h, h_h = trt.run_alg1(
            data, part, params=_port(p0), device="cpu",
            aggregation=tagg.hierarchical(tagg.secure(), groups=g), **KW)
        for k in p_flat:
            assert torch.equal(p_flat[k], p_h[k]), (g, k)
        assert h_flat.metrics == h_h.metrics


CASES = [
    ("hier2_secure", lambda a, c: dict(
        aggregation=a.hierarchical(a.secure(), groups=2)), 2e-5),
    ("hier3_secure", lambda a, c: dict(
        aggregation=a.hierarchical(a.secure(), groups=3)), 2e-5),
    ("hier2_topk8_secure", lambda a, c: dict(
        aggregation=a.hierarchical(a.secure(), groups=2),
        compressor=c.topk(0.2, bits=8)), 1e-3),
]


@pytest.mark.parametrize("name,make,atol", CASES, ids=[c[0] for c in CASES])
def test_hierarchical_runs_track_jax(small_setup, name, make, atol):
    data, part, p0 = small_setup
    pj, hj = jrt.run_alg1(data, part, params=p0, **KW, **make(jagg, jcomp))
    pt, ht = trt.run_alg1(data, part, params=_port(p0), device="cpu", **KW,
                          **make(tagg, tcomp))
    assert ht.rounds == hj.rounds and ht.comm == hj.comm
    assert ht.comm["breakdown"]["group_uplink_bytes"] > 0
    for a, b in zip(tm.params_to_numpy(pt), jax.tree.leaves(pj)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=atol)
    np.testing.assert_allclose(ht.train_cost, hj.train_cost, rtol=1e-5)
    np.testing.assert_allclose(ht.test_accuracy, hj.test_accuracy,
                               atol=1e-6)


def test_async_hierarchical_run_tracks_jax(small_setup):
    """Dropouts cancel inside their own group: 4 (M − 1) = 12 recovery
    bytes a drop at G = 2, M = 4."""
    data, part, p0 = small_setup
    pj, hj = jrt.run_alg1(
        data, part, params=p0, **KW,
        aggregation=jagg.hierarchical(jagg.secure(), groups=2),
        staleness=JConfig(max_staleness=1, delay_probs=PROBS))
    pt, ht = trt.run_alg1(
        data, part, params=_port(p0), device="cpu", **KW,
        aggregation=tagg.hierarchical(tagg.secure(), groups=2),
        staleness=StalenessConfig(max_staleness=1, delay_probs=PROBS))
    assert ht.rounds == hj.rounds and ht.comm == hj.comm
    a = ht.comm["async"]
    assert a["dropped_total"] == 10 and a["recovery_bytes_per_drop"] == 12
    for x, y in zip(tm.params_to_numpy(pt), jax.tree.leaves(pj)):
        np.testing.assert_allclose(x, np.asarray(y), rtol=0, atol=2e-5)
    np.testing.assert_allclose(ht.train_cost, hj.train_cost, rtol=1e-5)
    np.testing.assert_allclose(ht.test_accuracy, hj.test_accuracy,
                               atol=1e-6)
