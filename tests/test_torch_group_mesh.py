"""The hierarchical tree on the port's 2-D (groups, clients) mesh: two gloo
ranks on the CPU at (2, 1) and (1, 2), and four at (2, 2), against the
port's own ``mesh=None`` run and, for one case, a live JAX run of the
reference.

One two-rank world runs every case of both two-rank layouts
(``torch_group_mesh_cases.py``, a module that imports nothing of JAX or
of the reference package; the ranks report the modules they loaded) and
one four-rank world the (2, 2) cases; the test process computes the
``mesh=None`` references and the JAX run meanwhile.  The configuration
is the reference's ``tests/sharded_engine_check.py`` under
``hierarchical(secure(), groups=4)`` (S = 10: G ∤ S, and on (1, 2) the
member axis padded from M = 3 to M_pad = 4).

Held:

* sync: the secure tree on (2, 1) and (1, 2) bit for bit the one-device
  tree and flat ``secure()``; with ``topk(0.2, bits=8)`` on both, the
  count-sketch on (2, 1); Algorithm 2 and FedSGD under the tree on
  (2, 1), and in a round mode (async, pipelined); on (2, 2) the tree and
  its top-k case; ``arena="sharded"`` bit for bit ``"replicated"``
  (``tests/sharded_arena_check.py``'s tree cases); a plain inner, whose
  float group sums add in another order on the mesh, within 5e-5 in
  cost and 1e-6 in weights; FedAvg (sync and async), whose local steps
  round otherwise over a rank's slots, within 5e-5 and 2e-5;
* async and pipelined rounds of ``hierarchical(groups=2)`` on both
  two-rank layouts: the zero trace bit for bit the synchronous mesh run,
  the nonzero trace bit for bit the one-device async tree (the masked
  sum's ``alive`` rows over each local group's full member row), the
  sharded snapshot ring bit for bit the replicated one; pipelined rounds
  bit for bit the async run at τ ≡ 1;
* the masked sum launched G_loc times a round a rank at the tile's
  member offset of M_pad, the ring mode once at its group offset of G;
  the psums (and chunked-ring calls) a round on each axis as
  ``PERF.md`` §4 predicts them, and their bytes;
* ``ClientMesh.ring_psum_chunked`` bit for bit the psum on each axis at
  3 and 4 pieces (the reference's mixed tree);
* the (2, 1) secure tree against the reference's ``mesh=None`` tree at
  ``test_torch_hierarchical.py``'s tolerances;
* the refusals: G not a multiple of the groups axis, a flat strategy on
  the group mesh, a world that is not g·c ranks, no process group.
"""
import jax
import numpy as np
import pytest
import torch

from repro.data import partition as jpart
from repro.data import synthetic
from repro.fed import aggregation as jagg
from repro.fed import runtime as jrt
from repro.mlpapp import model as jm
import torch_group_mesh_cases as cases
from repro_torch.fed import aggregation as tagg
from repro_torch.fed import runtime as trt
from repro_torch.launch import ClientMesh, GroupMesh, LocalWorld, \
    make_group_mesh

ROUNDS = cases.KW["rounds"]
R = 794                      # the MLP's 101,632 weights in 128-lane rows
LAYOUTS = cases.TWO_LAYOUTS + [(2, 2)]


@pytest.fixture(scope="module")
def p0():
    w = jm.init_params(jax.random.key(3), 784, 128, 10)
    return tuple(np.asarray(x) for x in w)


@pytest.fixture(scope="module")
def world(p0):
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    worlds = [LocalWorld(cases.rank_main, 2, backend="gloo",
                         args=(cases.TWO, p0), timeout_s=300),
              LocalWorld(cases.rank_main, 4, backend="gloo",
                         args=(cases.FOUR, p0), timeout_s=300)]
    try:
        ref = {(n, m): cases.run_case(n, p0, m) for n, m in cases.REFERENCE}
        data = synthetic.classification_dataset(n_train=2000, n_test=500,
                                                seed=0)
        ref_jax = jrt.run_alg1(
            data, jpart.iid(2000, 10, seed=0), params=jm.MLPParams(*p0),
            aggregation=jagg.hierarchical(jagg.secure(), groups=4),
            **cases.KW)
        two, four = (w.join() for w in worlds)
    except BaseException:
        for w in worlds:
            w.close()
        raise
    finally:
        torch.set_num_threads(saved)
    return {2: two, 4: four, "ref": ref, "jax": ref_jax}


def ranks_of(world, layout):
    return world[layout[0] * layout[1]]


def run_of(world, name, layout, arena=None, mode="sync", rank=0):
    return ranks_of(world, layout)[rank]["runs"][(name, layout, arena,
                                                  mode)]


def bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def same_params(a, b):
    return len(a) == len(b) and all(np.array_equal(bits(x), bits(y))
                                    for x, y in zip(a, b))


def same_run(got, want):
    """Weights bit for bit, and the whole history equal."""
    return same_params(got["params"], want["params"]) \
        and got["hist"] == want["hist"]


def test_ranks_load_no_jax_and_agree_bit_for_bit(world):
    for size in (2, 4):
        ranks = world[size]
        first = ranks[0]["runs"]
        for r in ranks:
            assert r["foreign"] == [], r["foreign"]
            assert r["runs"].keys() == first.keys()
            for key, run in r["runs"].items():
                assert same_run(run, first[key]), key


@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
def test_group_mesh_layout_and_axes(world, layout):
    """Groups-major ranks; the clients axis a group row, the groups axis
    a client column, each a gloo subgroup whose int32 sum wraps."""
    g, c = layout
    for r, res in enumerate(ranks_of(world, layout)):
        m = res["meshes"][layout]
        assert (m["rank"], m["size"], m["backend"]) == (r, g * c, "gloo")
        gi, ci = m["coords"]
        assert (gi, ci) == divmod(r, c)
        whole, groups, clients = m["axes"]
        assert whole == (r, g * c, "gloo", True, list(range(g * c)))
        assert groups == (gi, g, "gloo", True,
                          [i * c + ci for i in range(g)])
        assert clients == (ci, c, "gloo", True,
                           [gi * c + j for j in range(c)])


@pytest.mark.parametrize("name,layout", [
    ("hier4/secure", (2, 1)), ("hier4/secure", (1, 2)),
    ("hier4/topk8", (2, 1)), ("hier4/topk8", (1, 2)),
    ("hier4/sketch", (2, 1)), ("alg2/hier4", (2, 1)),
    ("fedsgd/hier4", (2, 1)),
    ("hier4/secure", (2, 2)), ("hier4/topk8", (2, 2)),
    ("hier2/secure", (2, 1)), ("hier2/secure", (1, 2))],
    ids=lambda v: str(v))
def test_tree_on_the_group_mesh_is_single_device(world, name, layout):
    assert same_run(run_of(world, name, layout),
                    world["ref"][(name, "sync")]), (name, layout)


@pytest.mark.parametrize("layout", cases.TWO_LAYOUTS, ids=str)
def test_tree_on_the_group_mesh_is_flat_secure(world, layout):
    got = run_of(world, "hier4/secure", layout)
    flat = world["ref"][("flat/secure", "sync")]
    assert same_params(got["params"], flat["params"])
    assert got["hist"]["metrics"] == flat["hist"]["metrics"]


@pytest.mark.parametrize("name,layout", [
    (n, lay) for lay in LAYOUTS for n in ("hier4/secure", "hier4/topk8")],
    ids=lambda v: str(v))
def test_sharded_arena_equals_replicated(world, name, layout):
    assert same_run(run_of(world, name, layout),
                    run_of(world, name, layout, "replicated"))


@pytest.mark.parametrize("name,mode,atol", [
    ("hier4/plain", "sync", 1e-6), ("fedavg/hier4", "sync", 2e-5),
    ("fedavg/hier4", "delay", 2e-5)])
def test_float_paths_track_single_device(world, name, mode, atol):
    """A plain inner's float group sums add in another order on the mesh;
    FedAvg's local steps over a rank's 6 slots give other last bits than
    over all 10 on the CPU, so a few weights quantize one 2^-20 step
    apart (9.5e-6 at most, the same as flat secure FedAvg on the 1-D
    mesh: ROADMAP queue 3, "One cohort slot a rank")."""
    got = run_of(world, name, (2, 1), mode=mode)
    want = world["ref"][(name, mode)]
    cost = np.max(np.abs(np.subtract(got["hist"]["train_cost"],
                                     want["hist"]["train_cost"])))
    assert cost < 5e-5, cost
    acc = np.max(np.abs(np.subtract(got["hist"]["test_accuracy"],
                                    want["hist"]["test_accuracy"])))
    assert acc < 2e-3, acc
    for a, b in zip(got["params"], want["params"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)
    assert got["hist"]["comm"] == want["hist"]["comm"]


@pytest.mark.parametrize("name,mode", [("alg2/hier4", "delay"),
                                       ("fedsgd/hier4", "pipeline")])
def test_other_algorithms_round_modes_are_single_device(world, name, mode):
    got = run_of(world, name, (2, 1), mode=mode)
    assert same_run(got, world["ref"][(name, mode)])
    assert ("pipeline" if mode == "pipeline" else "async") \
        in got["hist"]["comm"]


@pytest.mark.parametrize("layout", cases.TWO_LAYOUTS, ids=str)
def test_async_tree_rounds_on_the_group_mesh(world, layout):
    """Zero trace = sync; the nonzero trace = the one-device async tree,
    with the ring sharded = replicated; pipeline = async τ ≡ 1, with
    both arenas."""
    name = "hier2/secure"

    def run(mode, arena=None):
        return run_of(world, name, layout, arena, mode)

    sync, zero = run("sync"), run("zero")
    assert same_params(zero["params"], sync["params"])
    assert zero["hist"]["metrics"] == sync["hist"]["metrics"]
    delay = run("delay")
    assert same_run(delay, world["ref"][(name, "delay")])
    assert delay["hist"]["comm"]["async"]["dropped_total"] > 0
    assert same_run(run("delay", "replicated"), delay)
    tau1 = run("tau1")
    assert same_run(tau1, world["ref"][(name, "tau1")])
    for arena in (None, "replicated"):
        pipe = run("pipeline", arena)
        assert same_params(pipe["params"], tau1["params"])
        assert pipe["hist"]["metrics"] == tau1["hist"]["metrics"]
        assert "pipeline" in pipe["hist"]["comm"]


def tile(layout, groups=4, cohort=10):
    """(G_loc, M_loc, M_pad) of the layout's tile."""
    g, c = layout
    m = -(-cohort // groups)
    m_pad = -(-m // c) * c
    return groups // g, m_pad // c, m_pad


def predicted(name, layout, arena, mode):
    """``PERF.md`` §4's (psum calls, chunked-ring calls) a round on each
    axis: on the whole mesh the weight gather (sharded), a stateful
    compressor's residual gather (sharded) and replication, and the
    snapshot ring's rebuild (async, sharded); on the clients and groups
    axes each combine's level-1 and root reduction, through the chunked
    ring in pipelined rounds where the axis has two or more ranks."""
    g, c = layout
    sharded = arena is None
    stateful = "topk" in name or "sketch" in name
    combines = 2 if "sketch" in name else 1
    whole = sharded + stateful * (1 + sharded) \
        + (mode != "sync" and sharded)
    out = {"whole": (whole, 0)}
    for axis, size in (("groups", g), ("clients", c)):
        ring = mode == "pipeline" and size > 1
        out[axis] = (0, combines) if ring else (combines, 0)
    return out


@pytest.mark.parametrize("key", cases.TWO + cases.FOUR,
                         ids=lambda k: "-".join(map(str, k)))
def test_collectives_and_launches_a_round(world, key):
    name, layout, arena, mode = key
    run = run_of(world, *key)
    counts = run["counts"]
    want = predicted(name, layout, arena, mode)
    got = {a: (v[0] // ROUNDS, v[2] // ROUNDS) for a, v in counts.items()}
    assert got == want, (got, want)
    assert all(v[0] % ROUNDS == 0 and v[2] % ROUNDS == 0
               for v in counts.values())
    groups = cases.CASES[name][1]()["aggregation"].groups
    g_loc, m_loc, m_pad = tile(layout, groups)
    if mode == "sync" and name in ("hier4/secure", "hier4/topk8"):
        # the sync tree's bytes: the weights (4 B a position), the G_loc
        # group sums and the root of R x 128 int32
        assert counts["clients"][1] == ROUNDS * g_loc * R * 512
        assert counts["groups"][1] == ROUNDS * R * 512
        if name == "hier4/secure":
            assert counts["whole"][1] == ROUNDS * 4 * groups * m_pad * \
                (arena is None)
    for r, res in enumerate(ranks_of(world, layout)):
        gi, ci = divmod(r, layout[1])
        calls = res["runs"][key]["calls"]
        if "plain" in name:
            assert calls == []
            continue
        per = 2 if "sketch" in name else 1
        masked = [x for x in calls if x[0] == "masked"]
        rings = [x for x in calls if x[0] == "ring"]
        assert len(masked) == per * g_loc * ROUNDS
        assert len(rings) == per * ROUNDS
        drops = mode in ("zero", "delay", "tau1")
        for _, rows, off, n, dropped in masked:
            assert (rows, off, n) == (m_loc, ci * m_loc, m_pad)
            assert (dropped is not None) == drops
        for _, rows, off, n, dropped in rings:
            assert (rows, off, n, dropped) == (g_loc, gi * g_loc, groups,
                                               None)
        if mode == "delay":
            # each drop cancels in its group's row, on every rank of the
            # group's column of member shards
            total = sum(x[4] for x in masked)
            assert total > 0


@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
@pytest.mark.parametrize("axis", ["groups", "clients"])
def test_ring_psum_chunked_on_each_axis(world, layout, axis):
    size = layout[0] if axis == "groups" else layout[1]
    for res in ranks_of(world, layout):
        chk = res["meshes"][layout]["ring"][axis]
        for chunks in cases.RING_CHUNKS:
            got, (rings, psums, nbytes) = chk[chunks]
            for k in chk["psum"]:
                assert np.array_equal(got[k], chk["psum"][k]), (chunks, k)
            if size == 1:        # one rank: the psum
                assert (rings, psums, nbytes) == (0, 1, 0)
            else:                # the int32 leaves' 484 words, once round
                assert (rings, psums, nbytes) == (1, 1, 4 * 484)


def test_group_mesh_tracks_the_reference(world):
    got = run_of(world, "hier4/secure", (2, 1))
    pj, hj = world["jax"]
    assert got["hist"]["rounds"] == hj.rounds
    for a, b in zip(got["params"], jax.tree.leaves(pj)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["hist"]["train_cost"], hj.train_cost,
                               rtol=1e-5)
    np.testing.assert_allclose(got["hist"]["test_accuracy"],
                               hj.test_accuracy, atol=1e-6)


@pytest.mark.parametrize("size", [2, 4])
def test_group_mesh_refusals_in_the_world(world, size):
    for res in world[size]:
        ref = res["refusals"]
        assert ref["world"][0] == "ValueError" and "ranks" in ref["world"][1]
        assert ref["groups"][0] == "ValueError" \
            and "multiple of the mesh's groups axis" in ref["groups"][1]
        assert ref["flat"][0] == "ValueError" \
            and "HierarchicalAggregation" in ref["flat"][1]


def fake_group_mesh(shape):
    """A group mesh with no process group behind it: every refusal below
    raises before the first collective."""
    axis = ClientMesh(group=None, rank=0, size=shape[0] * shape[1],
                      backend="gloo", device=torch.device("cpu"))
    return GroupMesh(whole=axis, groups=axis, clients=axis, shape=shape)


def test_group_mesh_refusals():
    data = synthetic.classification_dataset(n_train=40, n_test=10, k=16, l=3,
                                            seed=0)
    part = jpart.iid(40, 4, seed=0)
    kw = dict(batch_size=5, rounds=1, hidden=4)
    with pytest.raises(ValueError, match="multiple of the mesh's groups"):
        trt.run_alg1(data, part, mesh=fake_group_mesh((2, 1)),
                     aggregation=tagg.hierarchical(tagg.secure(), 3), **kw)
    with pytest.raises(ValueError, match="HierarchicalAggregation"):
        trt.run_alg1(data, part, mesh=fake_group_mesh((2, 1)), secure=True,
                     **kw)
    with pytest.raises(RuntimeError, match="no process group"):
        make_group_mesh(2, 1, device="cpu")


def test_every_layout_gathers_from_a_contiguous_schedule():
    """A batch gathered through a strided index keeps its strides, and
    the card's matrix products can round strided and contiguous operands
    differently: FedAvg's (T, S, E, B) schedule (a transposed draw) and
    its padded and tiled copies on either mesh (numpy's fancy indexing
    puts the indexed axis outermost) are staged contiguous."""
    from repro_torch.fed.engine import (_cohort_layout, _staged_schedule,
                                        build_schedule)
    part = jpart.iid(2000, 10, seed=0)
    _, idx = build_schedule(part, 10, 3, 2, seed=3, e_axis=True)
    cpu = torch.device("cpu")
    scheds = [idx]
    for mesh, groups in ((fake_group_mesh((2, 1)), 4),
                         (fake_group_mesh((1, 2)), 4),
                         (ClientMesh(group=None, rank=1, size=3,
                                     backend="gloo", device=cpu), None)):
        layout = _cohort_layout(mesh, 10, groups)
        scheds.append(layout.pad(idx, 0)[:, layout.local])
    assert not any(s.flags.c_contiguous for s in scheds[:3])
    for s in scheds:
        staged = _staged_schedule(s, cpu)
        assert staged.is_contiguous() and np.array_equal(staged.numpy(), s)
