"""The production (data, model) mesh: four gloo ranks on the CPU at (2, 2)
and (1, 4), against the port's one-device runs and live JAX runs of the
reference.

One four-rank world runs every case (``torch_production_mesh_cases.py``,
a module that imports nothing of JAX or of the reference package; the
ranks report the modules they loaded); the test process computes the
one-device references and the JAX runs meanwhile.  The configurations
are the reference's ``tests/distributed_check.py``'s.

Held:

* three sharded Algorithm-1 train steps of reduced llama3-8b and reduced
  granite-34b (one kv head: m ∤ Hkv, k and v gathered over ``model``),
  both ``act_tp``s, on both layouts: every leaf of the parameters and of
  ``lin`` (``gather_params`` on every rank, the ranks bit for bit alike)
  within 1e-5 × max |leaf| of the port's one-device steps, the loss and
  ‖g‖ within 1e-5 relative (measured at most 1.4e-6 × max |leaf| and
  2.2e-7); within ``STEP_LEAVES`` (5e-5, ``tests/test_torch_launch.py``)
  of the reference's jitted one-device step from the same weights
  (measured at most 4.0e-6); two microbatches of the local batch the
  same first step (``act_tp=None``);
* each step's collectives on each set of axes as ``PERF.md`` §6 predicts
  them (:func:`torch_production_mesh_family_cases.family_calls`), the
  layers run again in the backward included;
* the prefill step at the first weights: its logits (the vocab gathered
  over ``model``, the rows over ``data``) within 1e-5 of the largest
  |logit| of the port's one-device prefill, the ranks bit for bit alike,
  its collectives as ``family_calls`` predicts them;
* no layer's gathered weights kept for the backward (each layer under
  ``models.sharded.remat``);
* the expert-parallel forward of reduced qwen3-moe and llama4-maverick
  (shared expert) in both ``moe_weight_mode``s on both layouts: each
  layer's dropped share equal to ``moe_ffn``'s exactly, the logits
  within 1e-5 of the largest |logit| of the port's ``moe_ffn`` forward
  (measured at most 5.1e-7) and within the reference's 2e-2 of its dense
  dispatch (measured at most 5.4e-7), the collectives as predicted;
* the slot map: the port's cumsum rank restricted to local experts equal
  to the reference's ``_slots_for_experts`` integer for integer;
* ``fsdp_params=False`` (the parameters whole over ``data``) the same
  steps; each collective of ``repro_torch.parallel``'s gradient its adjoint
  collective (over ``model`` and over the whole mesh); the ``"fsdp"``
  forward's logits gathered over ``model`` (``shard_logits=False``);
* the parameters' round trip through ``shard_params`` / ``gather_params``
  bit for bit; the refusals: a grid that is not the world's size, nccl
  on a CPU device, m ∤ E, m ∤ ``rwkv_heads``, a ``"stationary"`` train
  step, a mesh decode step without the rank's decode state (and the
  KV cache block ``init_decode`` gives the rank), a ``dp_axes`` other than
  the data axes, a mesh model without its ``layer_pspec_fn``, a mesh
  without a process group; the moe family expert-parallel on a mesh and
  not off it.  (The other families' steps on the mesh:
  ``tests/test_torch_production_mesh_families.py``.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core import ssca as jssca
from repro.launch import steps as jsteps
from repro.models import build_model as jbuild_model
from repro.models import moe as jmoe
import torch_production_mesh_cases as cases
import torch_production_mesh_family_cases as family_cases
from repro_torch.launch import LocalWorld
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import build_model, moe
from repro_torch.models.transformer import params_to_numpy

STEP_LEAVES = 5e-5
DENSE_RUNS = [(a, lay, act) for a in cases.DENSE for lay in cases.LAYOUTS
              for act in cases.ACT_TPS]
MOE_RUNS = [(a, lay, mode) for a in cases.MOE for lay in cases.LAYOUTS
            for mode in cases.MODES]


def _reference_steps(arch):
    """The reference's jitted one-device steps from the port's weights."""
    cfg, params, batch = cases.dense_setup(arch)
    jm = jbuild_model(jreduced(jget_config(arch)))
    hp = jssca.SSCAHyperParams(tau=cases.HP.tau)
    step = jax.jit(jsteps.make_train_step(jm, hp))
    p = jax.tree.map(jnp.asarray, params_to_numpy(params))
    st = jssca.init(p, with_beta=False)
    b = {"tokens": jnp.asarray(batch["tokens"].numpy())}
    metrics = []
    for _ in range(cases.STEPS):
        p, st, m = step(p, st, b)
        metrics.append((float(m["loss"]), float(m["kkt_residual"])))
    return {"metrics": metrics, "params": _named(p), "lin": _named(st.lin)}


def _named(tree) -> dict:
    """'a/b' → numpy leaf of a reference parameter tree."""
    return {"/".join(str(k.key) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _reference_forward(arch):
    """The reference's dense-dispatch forward from the port's weights."""
    _, params, batch = cases.moe_setup(arch)
    jm = jbuild_model(jreduced(jget_config(arch)))
    p = jax.tree.map(jnp.asarray, params_to_numpy(params))
    return np.asarray(jm.forward(p, {"tokens": jnp.asarray(
        batch["tokens"].numpy())}))


@pytest.fixture(scope="module")
def world():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    ranks = LocalWorld(cases.rank_main, 4, backend="gloo", timeout_s=300)
    try:
        ref = {"port": {a: cases.unsharded_steps(a) for a in cases.DENSE},
               "jax": {a: _reference_steps(a) for a in cases.DENSE},
               "port_moe": {a: cases.unsharded_forward(a) for a in cases.MOE},
               "jax_moe": {a: _reference_forward(a) for a in cases.MOE}}
        out = ranks.join()
    finally:
        ranks.close()
        torch.set_num_threads(saved)
    return out, ref


def _close(got: dict, want: dict, scale: float):
    """Every leaf within ``scale`` × its largest |entry|."""
    assert set(got) == set(want)
    for k, w in want.items():
        top = float(np.abs(w).max())
        err = float(np.abs(got[k] - w).max())
        assert err <= scale * top, (k, err / top)


def test_ranks_load_no_jax_and_lay_out_row_major(world):
    out, _ = world
    for r, res in enumerate(out):
        assert res["foreign"] == []
        assert res["round_trip"]
        assert res["coords"][(2, 2)] == divmod(r, 2)
        assert res["coords"][(1, 4)] == (0, r)


@pytest.mark.parametrize("arch,layout,act_tp", DENSE_RUNS)
def test_dense_step_matches_one_device(world, arch, layout, act_tp):
    out, ref = world
    want = ref["port"][arch]
    runs = [res["runs"][(arch, layout, act_tp)] for res in out]
    for run in runs:
        for k in ("params", "lin"):
            assert all(np.array_equal(run[k][n], runs[0][k][n])
                       for n in run[k])
        _close(run["params"], want["params"], 1e-5)
        _close(run["lin"], want["lin"], 1e-5)
        np.testing.assert_allclose(run["metrics"], want["metrics"],
                                   rtol=1e-5)
        if act_tp is None:
            loss, first = run["microbatched"]
            np.testing.assert_allclose(loss, want["metrics"][0][0],
                                       rtol=1e-5)
            _close(first, want["params_1"], 1e-5)


def test_fsdp_off_step_matches_one_device(world):
    """Parameters whole over ``data`` (``fsdp_params=False``, the model's
    ``layer_pspec_fn`` to match): their gradients summed over ``data`` by
    the step's all-reduce."""
    out, ref = world
    want = ref["port"][cases.DENSE[0]]
    for res in out:
        run = res["runs"]["fsdp_off"]
        _close(run["params"], want["params"], 1e-5)
        _close(run["lin"], want["lin"], 1e-5)
        np.testing.assert_allclose(run["metrics"], want["metrics"],
                                   rtol=1e-5)
        assert "all_gather:data" not in run["calls"][0]
        assert run["calls"][0]["all_reduce:data"] == 1


def test_layers_keep_no_gathered_weight(world):
    """Each layer runs under ``models.sharded.remat``: nothing autograd
    keeps for the backward outside the layers shares storage with a
    layer's gathered leaves; without remat the 7 data-split leaves of
    each of the 2 layers are kept (14), which shows the record sees them.
    The saved bytes a rank fall (measured 722,278 against 5,839,718 on
    the (2, 2) mesh)."""
    out, _ = world
    for res in out:
        rec = res["saved"]
        assert rec["remat"]["gathered_saved"] == 0
        assert rec["plain"]["gathered_saved"] == 14
        assert rec["remat"]["saved_bytes"] < rec["plain"]["saved_bytes"]


def test_collective_gradients_are_adjoints(world):
    out, _ = world
    for res in out:
        grads = res["collective_grads"]
        assert len(grads) == 10 and all(grads.values()), grads


@pytest.mark.parametrize("arch,layout,act_tp", DENSE_RUNS)
def test_dense_step_matches_reference(world, arch, layout, act_tp):
    out, ref = world
    want = ref["jax"][arch]
    run = out[0]["runs"][(arch, layout, act_tp)]
    _close(run["params"], want["params"], STEP_LEAVES)
    _close(run["lin"], want["lin"], STEP_LEAVES)
    np.testing.assert_allclose(run["metrics"], want["metrics"], rtol=1e-5)


@pytest.mark.parametrize("arch,layout,act_tp", DENSE_RUNS)
def test_dense_collectives_as_predicted(world, arch, layout, act_tp):
    out, _ = world
    cfg = cases.dense_setup(arch)[0]
    want = family_cases.family_calls(cfg, layout[1], act_tp, train=True)
    for res in out:
        run = res["runs"][(arch, layout, act_tp)]
        assert run["calls"] == [want] * cases.STEPS


@pytest.mark.parametrize("arch,layout,act_tp", DENSE_RUNS)
def test_dense_prefill_matches_one_device(world, arch, layout, act_tp):
    out, ref = world
    want = ref["port"][arch]["prefill"]
    top = float(np.abs(want).max())
    cfg = cases.dense_setup(arch)[0]
    calls = family_cases.family_calls(cfg, layout[1], act_tp, train=False)
    runs = [res["runs"][(arch, layout, act_tp)] for res in out]
    for run in runs:
        assert run["prefill"].shape == want.shape
        assert np.array_equal(run["prefill"], runs[0]["prefill"])
        assert float(np.abs(run["prefill"] - want).max()) <= 1e-5 * top
        assert run["prefill_calls"] == calls


@pytest.mark.parametrize("arch,layout,mode", MOE_RUNS)
def test_expert_parallel_forward(world, arch, layout, mode):
    out, ref = world
    logits, dropped = ref["port_moe"][arch]
    top = float(np.abs(logits).max())
    cfg = cases.moe_setup(arch)[0]
    for res in out:
        run = res["runs"][(arch, layout, mode)]
        assert run["dropped"] == dropped and max(dropped) > 0
        assert float(np.abs(run["logits"] - logits).max()) <= 1e-5 * top
        want = ref["jax_moe"][arch]
        err = float(np.abs(run["logits"] - want).max())
        assert err <= 2e-2 * float(np.abs(want).max())
        assert run["calls"] == cases.moe_forward_calls(cfg, "model", mode)


def test_slots_match_reference():
    """The port's slots of each local expert block: the token, gate and
    validity of every (expert, slot) equal the reference's
    ``_slots_for_experts`` (valid entries; the reference's invalid ones
    read a clipped index)."""
    rng = np.random.default_rng(4)
    b, s, k, e = 3, 16, 2, 8
    idx = np.stack([np.stack([rng.choice(e, k, replace=False)
                              for _ in range(s)]) for _ in range(b)])
    gates = rng.random((b, s, k)).astype(np.float32)
    for cap in (3, 5):
        for e_loc in (2, 4):
            for e_lo in range(0, e, e_loc):
                slot, kept = moe.slots(torch.as_tensor(idx), e, cap, e_lo,
                                       e_loc)
                for i in range(b):
                    tok, gate, valid = (np.asarray(a) for a in
                                        jmoe._slots_for_experts(
                                            jnp.asarray(idx[i]),
                                            jnp.asarray(gates[i]), e_lo,
                                            e_loc, cap, k))
                    got_valid = np.zeros((e_loc * cap + 1,), bool)
                    got_tok = np.zeros((e_loc * cap + 1,), np.int64)
                    got_gate = np.zeros((e_loc * cap + 1,), np.float32)
                    flat = slot[i].numpy()
                    got_valid[flat] = kept[i].numpy()
                    got_tok[flat] = np.arange(s * k) // k
                    got_gate[flat] = gates[i].reshape(-1)
                    got_valid = got_valid[:-1].reshape(e_loc, cap)
                    np.testing.assert_array_equal(got_valid, valid)
                    np.testing.assert_array_equal(
                        got_tok[:-1].reshape(e_loc, cap)[valid], tok[valid])
                    np.testing.assert_array_equal(
                        got_gate[:-1].reshape(e_loc, cap)[valid],
                        gate[valid])


def test_refusals_in_the_world(world):
    out, _ = world
    ref = out[0]["refusals"]
    assert ref["world"][0] == "ValueError" and "8 ranks" in ref["world"][1]
    assert ref["nccl_cpu"][0] == "ValueError" and "nccl" in ref["nccl_cpu"][1]
    for key in ("experts_model", "experts_fn"):
        assert ref[key][0] == "ValueError" and "3 experts" in ref[key][1]
    assert ref["rwkv_heads"][0] == "ValueError" \
        and "3 rwkv_heads" in ref["rwkv_heads"][1]
    assert ref["stationary_train"][0] == "ValueError" \
        and "moe_weight_mode='fsdp'" in ref["stationary_train"][1]
    # decode runs on the mesh: the rank's block of the (L, B, C, Hkv, hd)
    # cache, B = 2 over data and C = 8 over model; a step from no state
    # refuses
    assert ref["decode"] == ((2, 1, 4, 4, 64),
                             (None, "data", "model", None, None))
    assert ref["decode_step"][0] == "ValueError" \
        and "MeshDecodeState" in ref["decode_step"][1]
    assert ref["placement"][0] == "ValueError" \
        and "layer_pspec_fn" in ref["placement"][1]
    assert ref["expert_parallel"] is True
    assert ref["dp_axes"][0] == "ValueError" \
        and "data axes" in ref["dp_axes"][1]


def test_refusals_without_a_world(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh()
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh((1, 1), ("data", "model"), device="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        make_host_mesh(device="cpu")
    cfg = cases.moe_setup(cases.MOE[0])[0]
    assert build_model(cfg).expert_parallel is False
    with pytest.raises(ValueError, match="moe_weight_mode"):
        build_model(cfg, moe_weight_mode="stationry")
