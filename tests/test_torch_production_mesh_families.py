"""The moe, ssm, hybrid, vlm and audio families' train and prefill steps on
the production (data, model) mesh: four gloo ranks on the CPU at (2, 2)
and at (1, 4), against the port's one-device steps and live JAX runs of
the reference.

One four-rank world a layout runs every case
(``torch_production_mesh_family_cases.py``, a module that imports
nothing of JAX or of the reference package; the ranks report the
modules they loaded); both worlds start together, and the test process
computes the one-device references, the JAX runs and the reference's own
mesh loss (``moe_aux_quirk_check.py``, a subprocess of four virtual
devices) meanwhile.  The configurations are ``reduced(get_config(arch))``
of qwen3-moe, llama4-maverick (interleaved, shared expert), rwkv6-7b,
recurrentgemma-9b (one unit; a case of 5 layers adds a recurrent tail at
(2, 2)), phi-3-vision-4.2b and whisper-large-v3, vocabulary 512, three
Algorithm-1 steps at τ = 1 on (4, 32) tokens and the stub embeddings,
and one prefill step.

Held:

* every leaf of the parameters and of ``lin`` (``gather_params`` on every
  rank, the ranks bit for bit alike) within 1e-5 × max |leaf| of the
  port's one-device steps, the loss and ‖g‖ within 1e-5 relative
  (measured at most 1.4e-6 × max |leaf| and 1.8e-7); within
  ``STEP_LEAVES`` (5e-5, ``tests/test_torch_launch.py``) of the
  reference's jitted one-device step from the same weights;
* the prefill step's logits (the last position, gathered over the vocab)
  within 1e-5 of the largest |logit| of the one-device prefill (measured
  at most 6.6e-7);
* each MoE layer's dropped share equal to ``moe_ffn``'s exactly; the loss
  carries the global batch's load-balance loss, as the one-device loss
  does.  The reference's own pjit mesh loss does not: it carries data
  rank 0's rows' aux (6.304635 against its one-device 6.304366, 4.3e-5
  relative, at reduced qwen3-moe on (2, 2); ``ROADMAP.md`` queue 3);
* each step's and each prefill's collectives on each set of axes as
  :func:`torch_production_mesh_family_cases.family_calls` predicts them
  (the dense family's: ``tests/test_torch_production_mesh.py``);
* no layer's gathered weight kept for the backward (each layer under
  ``models.sharded.remat``), per family;
* every family's parameters through ``shard_params`` / ``gather_params``
  bit for bit; ``input_specs`` of every family; the refusals: m ∤
  ``rwkv_heads``, a ``"stationary"`` train step, decode and
  ``init_decode``, the last two naming the ROADMAP item;
* the bf16 routes of reduced qwen3-moe against the reference's
  ``moe.route`` from the same inputs (no world).
"""
import dataclasses
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _subprocess import TESTS_DIR
from repro.configs import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core import ssca as jssca
from repro.launch import steps as jsteps
from repro.models import build_model as jbuild_model
from repro.models import moe as jmoe
import torch_production_mesh_family_cases as cases
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.launch import LocalWorld
from repro_torch.models import build_model, moe
from repro_torch.models.transformer import params_to_numpy

STEP_LEAVES = 5e-5
# a route's relative top-k margin, (p_k − p_{k+1}) / p_k, below which two
# paths' rounding may pick either expert (``chip_smoke.py``'s ROUTE_TIE)
ROUTE_TIE = 2.0 ** -4
RUNS = [(a, lay, "model") for a in cases.CASES for lay in cases.LAYOUTS
        if a != cases.TAIL or lay == (2, 2)] \
    + [(a, (2, 2), None) for a in cases.NO_ACT_TP]


def _reference_steps(arch):
    """The reference's jitted one-device steps from the port's weights."""
    cfg, params, batch = cases.setup(arch)
    jcfg = dataclasses.replace(jreduced(jget_config(cfg.name.split(
        "-reduced")[0])), num_layers=cfg.num_layers)
    step = jax.jit(jsteps.make_train_step(
        jbuild_model(jcfg), jssca.SSCAHyperParams(tau=cases.HP.tau)))
    p = jax.tree.map(jnp.asarray, params_to_numpy(params))
    st = jssca.init(p, with_beta=False)
    b = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    metrics = []
    for _ in range(cases.STEPS):
        p, st, m = step(p, st, b)
        metrics.append((float(m["loss"]), float(m["kkt_residual"])))
    return {"metrics": metrics, "params": _named(p), "lin": _named(st.lin)}


def _named(tree) -> dict:
    """'a/b' → numpy leaf of a reference parameter tree."""
    return {"/".join(str(k.key) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def world():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    quirk = subprocess.Popen(
        [sys.executable, str(TESTS_DIR / "moe_aux_quirk_check.py")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    worlds = {lay: LocalWorld(cases.rank_main, 4, backend="gloo",
                              args=(lay,), timeout_s=600)
              for lay in cases.LAYOUTS}
    try:
        ref = {"port": {a: cases.unsharded(a) for a in cases.CASES},
               "jax": {a: _reference_steps(a) for a in cases.CASES}}
        out = {lay: w.join() for lay, w in worlds.items()}
        text = quirk.communicate(timeout=600)[0]
        assert quirk.returncode == 0 and "MOE_AUX_QUIRK_OK" in text, text
        ref["quirk"] = json.loads(text.strip().splitlines()[-2])
    finally:
        for w in worlds.values():
            w.close()
        if quirk.poll() is None:
            quirk.kill()
        torch.set_num_threads(saved)
    return out, ref


def _close(got: dict, want: dict, scale: float):
    """Every leaf within ``scale`` × its largest |entry|."""
    assert set(got) == set(want)
    for k, w in want.items():
        top = float(np.abs(w).max())
        err = float(np.abs(got[k] - w).max())
        assert err <= scale * top, (k, err / top)


def _runs(world, arch, layout, act_tp):
    return [res["runs"][(arch, act_tp)] for res in world[0][layout]]


@pytest.mark.parametrize("layout", cases.LAYOUTS)
def test_ranks_load_no_jax_and_lay_out_row_major(world, layout):
    for r, res in enumerate(world[0][layout]):
        assert res["foreign"] == []
        assert res["coords"] == divmod(r, layout[1])


@pytest.mark.parametrize("arch,layout,act_tp", RUNS)
def test_family_step_matches_one_device(world, arch, layout, act_tp):
    want = world[1]["port"][arch]
    runs = _runs(world, arch, layout, act_tp)
    for run in runs:
        for k in ("params", "lin"):
            assert all(np.array_equal(run[k][n], runs[0][k][n])
                       for n in run[k])
        _close(run["params"], want["params"], 1e-5)
        _close(run["lin"], want["lin"], 1e-5)
        np.testing.assert_allclose(run["metrics"], want["metrics"],
                                   rtol=1e-5)


@pytest.mark.parametrize("arch,layout,act_tp", RUNS)
def test_family_step_matches_reference(world, arch, layout, act_tp):
    want = world[1]["jax"][arch]
    run = _runs(world, arch, layout, act_tp)[0]
    _close(run["params"], want["params"], STEP_LEAVES)
    _close(run["lin"], want["lin"], STEP_LEAVES)
    np.testing.assert_allclose(run["metrics"], want["metrics"], rtol=1e-5)


@pytest.mark.parametrize("arch,layout,act_tp", RUNS)
def test_family_prefill_matches_one_device(world, arch, layout, act_tp):
    want = world[1]["port"][arch]["prefill"]
    top = float(np.abs(want).max())
    for run in _runs(world, arch, layout, act_tp):
        assert run["prefill"].shape == want.shape
        assert float(np.abs(run["prefill"] - want).max()) <= 1e-5 * top


@pytest.mark.parametrize("arch,layout,act_tp", RUNS)
def test_family_collectives_as_predicted(world, arch, layout, act_tp):
    cfg = cases.setup(arch)[0]
    train = cases.family_calls(cfg, layout[1], act_tp, train=True)
    prefill = cases.family_calls(cfg, layout[1], act_tp, train=False)
    for run in _runs(world, arch, layout, act_tp):
        assert run["calls"] == [train] * cases.STEPS
        assert run["prefill_calls"] == prefill


@pytest.mark.parametrize("arch", cases.MOE)
@pytest.mark.parametrize("layout", cases.LAYOUTS)
def test_moe_train_drops_and_global_aux(world, arch, layout):
    """Each MoE layer's dropped share is ``moe_ffn``'s exactly, and the
    first loss (the global aux's) the one-device one within 1e-5; the
    reference's own mesh loss is data rank 0's rows' aux's, 4.3e-5 from
    its one-device loss, which the port's would miss by that much."""
    out, ref = world
    want = ref["port"][arch]
    for run in _runs(world, arch, layout, "model"):
        assert run["dropped"] == want["dropped"] and max(want["dropped"]) > 0
    if arch != cases.MOE[0]:
        return
    q = ref["quirk"]
    w_l = q["router_aux_weight"] / q["num_layers"]
    rank0 = q["ce"] + w_l * sum(q["aux_data_rank"][0])
    assert abs(q["loss_mesh"] - rank0) <= 1e-6 * rank0
    assert abs(q["loss_one_device"] - q["ce"] - w_l * sum(q["aux_global"])) \
        <= 1e-6 * q["loss_one_device"]
    loss = _runs(world, arch, layout, "model")[0]["metrics"][0][0]
    assert abs(loss - q["loss_one_device"]) <= 1e-5 * loss
    assert abs(q["loss_mesh"] - q["loss_one_device"]) > 2e-5 * loss


@pytest.mark.parametrize("arch", cases.ARCHS)
def test_layers_keep_no_gathered_weight(world, arch):
    """Nothing autograd keeps outside the layers shares storage with a
    layer's gathered leaves under ``remat``; without it some do, which
    shows the record sees them."""
    for res in world[0][(2, 2)]:
        rec = res["saved"][arch]
        assert rec["remat"] == 0 and rec["plain"] > 0


def test_gather_from_gradient_is_the_block(world):
    """``parallel.gather_from``'s backward: each rank's block of the
    gradient, not a sum over the group (the ``act_tp=None`` channel mix
    and image tokens rely on it)."""
    assert all(res["gather_from"] for res in world[0][(2, 2)])


def test_round_trips_and_specs(world):
    out = world[0][(2, 2)][0]
    for arch, (names, same) in out["round_trips"].items():
        assert same, arch
    names = dict(out["round_trips"])
    assert "tail/w_ri" in names["recurrentgemma-9b"][0]
    assert {"encoder/b_o", "enc_final_norm"} \
        <= set(names["whisper-large-v3"][0])
    assert "img_proj" in names["phi-3-vision-4.2b"][0]
    specs = out["refusals"]["specs"]
    assert specs["phi-3-vision-4.2b"] == {"tokens": (4, 32),
                                          "img_embeds": (4, 8, 256)}
    assert specs["whisper-large-v3"] == {"tokens": (4, 40),
                                         "frame_embeds": (4, 16, 256)}
    assert specs["rwkv6-7b"] == {"tokens": (4, 40)}


def test_refusals_in_the_world(world):
    ref = world[0][(2, 2)][0]["refusals"]
    assert ref["builds"] == ["audio", "hybrid", "moe", "moe", "ssm", "vlm"]
    assert ref["rwkv_heads"][0] == "ValueError" \
        and "3 rwkv_heads" in ref["rwkv_heads"][1]
    assert ref["stationary"][0] == "ValueError" \
        and "stationary" in ref["stationary"][1]
    for key in ("decode", "init_decode"):
        assert ref[key][0] == "NotImplementedError" \
            and "decode and ckpt/io.py on the mesh" in ref[key][1], key


def test_moe_bf16_routes_match_reference():
    """Reduced qwen3-moe in bf16 (parameters and activations, as the
    published config): each MoE layer's router input from the port's bf16
    forward of (4, 32) tokens, through the port's ``moe.route`` and the
    reference's from the same bf16 bits.  Every choice whose relative
    top-k margin exceeds ROUTE_TIE is the same expert set; the choices
    within it are counted and printed (measured: 79 of 256 token-layers
    within 2^-4, none routed apart: the two routes differ only in the f32
    product's summation order)."""
    cfg = dataclasses.replace(reduced(get_config(cases.MOE[0])),
                              param_dtype="bfloat16", activ_dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(5), device="cpu")
    tok = np.random.default_rng(6).integers(0, cfg.vocab_size, (4, 32))
    inputs = []
    real = moe.route

    def record(x, w, k):
        inputs.append((x, w))
        return real(x, w, k)

    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "route", record)
        model.forward({k: v for k, v in params.items()},
                      {"tokens": torch.as_tensor(tok, dtype=torch.int32)})
    k = cfg.experts_per_token
    within = apart = total = 0
    for x, w in inputs:
        assert x.dtype == torch.bfloat16
        _, idx, probs = real(x, w, k)
        jx, jw = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (x, w))
        _, jidx, _ = jmoe.route(jx, jw, k)
        top = torch.topk(probs, k + 1, dim=-1).values
        margin = ((top[..., k - 1] - top[..., k]) / top[..., k - 1]).numpy()
        same = (np.sort(idx.numpy(), -1)
                == np.sort(np.asarray(jidx), -1)).all(-1)
        assert same[margin > ROUTE_TIE].all()
        within += int((margin <= ROUTE_TIE).sum())
        apart += int((~same).sum())
        total += same.size
    print(f"bf16 routes: {within} of {total} token-layers within ROUTE_TIE "
          f"{ROUTE_TIE}, {apart} routed apart")
    assert total == cfg.num_layers * tok.size
