"""The home-sharded residual arena and the client mesh's collective.

* In one two-rank gloo world on the CPU (``torch_mesh_cases.py``), the
  collective's unit checks: ``ClientMesh.psum`` wraps int32 sums mod
  2^32 (and its int64 path for a backend that does not wrap gives the
  same bits) with one ``all_reduce`` per dtype; the ranks'
  ``secure_quant_sum`` partials at their cohort offsets, psummed, equal
  the one-device masked sum bit for bit (a cohort of 10, and of 5
  padded to 6); ``gather_rows``, ``replicate_rows`` and ``scatter_rows``
  move rows exactly, NaN payloads and −0.0 included.  (The engine's
  arena modes are held against each other in ``test_torch_mesh.py``.)
* In this process, D ranks emulated (their contributions added, as the
  reference's property tests do): the port's arena helpers against the
  reference's ``repro/fed/arena.py`` on the same inputs, bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fed import arena as jarena
import torch_mesh_cases as cases
from repro_torch.data.partition import home_addressing
from repro_torch.fed import arena
from repro_torch.kernels import ops
from repro_torch.launch import ClientMesh, LocalWorld


@pytest.fixture(scope="module")
def world():
    return LocalWorld(cases.rank_main, 2, backend="gloo",
                      args=([], None, True), timeout_s=300).join()


def bits(a):
    return np.asarray(a).view(np.uint32)


def test_psum_wraps_int32_mod_2_32(world):
    ins = [cases.wrap_inputs(r) for r in range(2)]
    want = ins[0]["i"].astype(np.int64) + ins[1]["i"].astype(np.int64)
    assert (np.abs(want) >= 2 ** 31).any()       # the sum leaves int32
    want = ((want + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)
    for rank in world:
        assert rank["foreign"] == []
        got = rank["checks"]["psum"]
        np.testing.assert_array_equal(got["i"], want)
        np.testing.assert_array_equal(rank["checks"]["psum_wide"], want)
        np.testing.assert_array_equal(got["f"], ins[0]["f"] + ins[1]["f"])
        # one psum, one all_reduce for each of its two dtypes
        assert rank["checks"]["psum_counts"] == (1, 2)


@pytest.mark.parametrize("clients", cases.MASKED)
def test_masked_partials_psum_to_the_one_device_sum(world, clients):
    msgs = {k: torch.as_tensor(v)
            for k, v in cases.masked_inputs(clients).items()}
    want = ops.secure_quant_sum(msgs, cases.KEY, scale_bits=20,
                                device="cpu")
    for rank in world:
        got = rank["checks"]["masked"][clients]
        for k in want:
            np.testing.assert_array_equal(got[k], want[k].numpy())


def test_rows_move_exactly(world):
    pop = cases.rows_population()
    cids = np.asarray(cases.COHORT)
    live = cids < pop.shape[0]
    # the sentinel (id I) reads its dead row's zeros
    want_g = np.where(live[:, None, None], pop[np.minimum(cids, 6)], 0.0)
    new = -pop[::-1][:len(cids)]
    after = pop.copy()
    after[cids[live]] = new[live]
    for rank in world:
        chk = rank["checks"]
        np.testing.assert_array_equal(bits(chk["gather"]),
                                      bits(want_g.astype(np.float32)))
        np.testing.assert_array_equal(bits(chk["replicate"]), bits(new))
        np.testing.assert_array_equal(bits(chk["after_scatter"]),
                                      bits(after))
    assert np.isnan(pop).any() and (bits(pop) == 0x80000000).any()


# ---------------------------------------------------------------------------
# D ranks emulated in this process, against the reference's helpers
# ---------------------------------------------------------------------------

class _Mesh:
    def __init__(self, size):
        self.size = size


@pytest.mark.parametrize("num_clients,ranks", [(7, 1), (7, 2), (10, 3),
                                               (10, 4), (1, 2)])
def test_plan_and_addresses_match_the_reference(num_clients, ranks):
    plan = arena.make_plan(num_clients, _Mesh(ranks))
    rows = -(-(num_clients + 1) // ranks)
    assert plan == (num_clients, rows, ranks)
    assert plan.total_rows >= num_clients + 1
    ids = torch.arange(num_clients + 1)               # the sentinel too
    ref = jarena.ArenaPlan(num_clients, rows, ("clients",), (ranks,))
    for got, want, host in zip(arena.address(plan, ids),
                               jarena.address(ref, jnp.asarray(ids.numpy())),
                               home_addressing(ids.numpy(), rows)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), host)


def _population(num_clients, seed=0):
    rng = np.random.default_rng(seed)
    return {"r": rng.standard_normal((num_clients, 3, 4)).astype(np.float32),
            "q": rng.integers(-2 ** 31, 2 ** 31, (num_clients, 5))
            .astype(np.int32)}


@pytest.mark.parametrize("num_clients,ranks,cohort", [
    (7, 2, [6, 0, 3, 7]), (10, 3, [9, 2, 5, 10, 10, 10]),
    (10, 4, [1, 8, 4, 0, 7, 3, 10, 10])])
def test_routing_matches_the_reference_bit_for_bit(num_clients, ranks,
                                                   cohort):
    pop = _population(num_clients)
    plan = arena.make_plan(num_clients, _Mesh(ranks))
    ref = jarena.ArenaPlan(num_clients, plan.rows_per_shard, ("clients",),
                           (ranks,))
    full = {k: torch.as_tensor(v) for k, v in pop.items()}
    local = [{k: arena.home_rows(plan, v, r) for k, v in full.items()}
             for r in range(ranks)]
    padded = {k: np.concatenate([v, np.zeros((plan.total_rows
                                               - num_clients,) + v.shape[1:],
                                              v.dtype)])
              for k, v in pop.items()}
    L = plan.rows_per_shard
    cids = torch.as_tensor(cohort)

    def add(contribs):
        return {k: sum(c[k] for c in contribs) for k in contribs[0]}

    # the gather: D masked contributions, summed
    took = [arena.take_rows(plan, local[r], cids, r) for r in range(ranks)]
    want = [jarena.take_rows(ref, {k: jnp.asarray(v[r * L:(r + 1) * L])
                                   for k, v in padded.items()},
                             jnp.asarray(cohort), r) for r in range(ranks)]
    for t, w in zip(took, want):
        for k in t:
            np.testing.assert_array_equal(t[k].numpy().view(np.uint32),
                                          np.asarray(w[k]))
    got = arena.gather_rows(plan, local[0], cids, 0,
                            lambda _: add(took))
    for k in got:
        np.testing.assert_array_equal(
            got[k].numpy().view(np.uint32),
            padded[k][np.asarray(cohort)].view(np.uint32))
    # replicate each rank's slots, then scatter owner-locally
    s_loc = len(cohort) // ranks
    new = {k: -v.flip(0)[:len(cohort)] if v.dtype == torch.float32
           else v.flip(0)[:len(cohort)] ^ 0x5A5A for k, v in full.items()}
    placed = []
    for r in range(ranks):
        sl = {k: v[r * s_loc:(r + 1) * s_loc] for k, v in new.items()}
        arena.replicate_rows(sl, len(cohort), r * s_loc,
                             lambda t: placed.append(t) or t)
    rows = arena.replicate_rows(
        {k: v[:s_loc] for k, v in new.items()}, len(cohort), 0,
        lambda _: add(placed))
    for k in rows:
        np.testing.assert_array_equal(rows[k].numpy().view(np.uint32),
                                      new[k].numpy().view(np.uint32))
    live = cids < num_clients
    for r in range(ranks):
        arena.scatter_rows(plan, local[r], rows, cids, live, r)
        wl = jarena.scatter_rows(
            ref, {k: jnp.asarray(v[r * L:(r + 1) * L])
                  for k, v in padded.items()},
            {k: jnp.asarray(v.numpy()) for k, v in rows.items()},
            jnp.asarray(cohort), jnp.asarray(live.numpy()), r)
        for k in wl:
            np.testing.assert_array_equal(
                local[r][k].numpy().view(np.uint32),
                np.asarray(wl[k]).view(np.uint32))
        for k, v in pop.items():
            padded[k][r * L:(r + 1) * L] = local[r][k].numpy()
    for k, v in pop.items():
        after = v.copy()
        after[np.asarray(cohort)[live.numpy()]] = \
            new[k].numpy()[live.numpy()]
        np.testing.assert_array_equal(padded[k][:num_clients].view(np.uint32),
                                      after.view(np.uint32))


def test_routing_refuses_what_it_cannot_carry():
    with pytest.raises(TypeError, match="route"):
        arena.as_bits(torch.zeros(3, dtype=torch.float64))
    plan = arena.make_plan(7, _Mesh(2))
    mesh = ClientMesh(group=None, rank=1, size=3, backend="gloo",
                      device=torch.device("cpu"))
    with pytest.raises(ValueError, match="ranks"):
        arena.shard_index(plan, mesh)
    mesh.size = 2
    assert arena.shard_index(plan, mesh) == 1
