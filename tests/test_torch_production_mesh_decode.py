"""Decode, serving and checkpoints on the production (data, model) mesh:
four gloo ranks on the CPU at (2, 2) and at (1, 4), against the port's
one-device decode and the reference's own mesh decode.

One four-rank world a layout runs every case
(``torch_production_mesh_decode_cases.py``, a module that imports nothing
of JAX or of the reference package; the ranks report the modules they
loaded); both worlds start together, and the test process computes the
one-device runs and the reference's mesh decode
(``production_mesh_decode_check.py``, a subprocess of four virtual
devices, as ``moe_aux_quirk_check.py`` runs its mesh) meanwhile.  The
cases are reduced qwen3-moe and llama4-maverick in both weight modes,
rwkv6-7b, recurrentgemma-9b (its ring of 16 wraps), phi-3-vision's text,
whisper through ``precompute_cross``, llama3-8b with ``decode_window=8``
and llama3-8b on a cache of 21 slots for 3 rows (m ∤ C: the cache whole on
every model rank; the data axis ∤ B: every rank decodes all rows), and
phi-3-vision and rwkv6-7b with the residual stream whole
(``act_tp=None``), in f32; and llama3-8b and qwen3-moe in bf16
(parameters, activations and caches, as the published widths run);
each a prompt of 8 tokens and 12 more.

Held:

* every step's logits within 1e-5 × max |logit| of the one-device decode
  (measured at most 4.6e-7), every decode-state leaf within 1e-5 of its
  largest entry (measured 1.1e-6), the ranks bit for bit alike, and
  ``serve_batch``'s greedy tokens equal; the bf16 cases within
  ``tests/test_torch_launch.py``'s bf16 bounds (logits 2e-2, caches
  2^-6; measured 4.4e-3–5.5e-3 and 5.4e-3–9.0e-3), the moe one up to
  its first token routed apart from one device, which sits within
  ROUTE_TIE of a tie (measured: step 18 of 20, margin 3.6e-2), and its
  greedy tokens up to one device's first near-tie (measured: the first
  token, two logits 8.7e-4 of the largest apart);
* the reference's jitted decode under its own ``decode_state_shardings``
  on a (2, 2) mesh (llama3-8b with its ring, qwen3-moe expert-parallel)
  within the f32 bound of ``tests/test_torch_launch.py`` (1e-5 of the
  largest |logit|; measured 7.3e-7 and 5.9e-7);
* each leaf the table splits held at 1/m (the caches' sequence, the
  recurrent states' heads or channels) or 1/(d·m) (with the batch over
  ``data``) of the whole on every rank, the others whole;
* a decode step's collectives as
  :func:`torch_production_mesh_decode_cases.decode_calls` predicts them;
* a checkpoint of reduced qwen3-moe's parameters and an SSCA state in
  each weight mode's placement, saved by the mesh model (gathered by its
  own ``layer_pspec_fn``): restored onto the mesh, onto one device and
  through the reference's ``repro.ckpt.io.restore`` bit for bit; one
  rank's blocks handed to a save as whole leaves raise, and so does a
  mesh save without the model's shapes; a mesh decode refuses a whole
  state, and a state cloned by ``tree.map`` decodes as its original;
* the bf16 routes of reduced qwen3-moe's decode against the reference's
  ``moe.route`` on the same inputs, and against the teacher-forced
  forward's own choice (no world).
"""
import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _subprocess import TESTS_DIR
from repro.ckpt import io as jckpt
from repro.models import moe as jmoe
import torch_production_mesh_decode_cases as cases
from repro_torch import tree
from repro_torch.ckpt import io as ckpt_io
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.launch import LocalWorld
from repro_torch.models import build_model, moe

BOUND = cases.BOUND
ROUTE_TIE = cases.ROUTE_TIE
STEPS = cases.STEPS
RUNS = [(name, lay) for name in cases.CASES for lay in cases.LAYOUTS]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("decode")
    ref_file = tmp / "reference.npz"
    reference = subprocess.Popen(
        [sys.executable, str(TESTS_DIR / "production_mesh_decode_check.py"),
         str(ref_file)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    dirs = {lay: str(tmp / f"{lay[0]}x{lay[1]}") for lay in cases.LAYOUTS}
    worlds = {lay: LocalWorld(cases.rank_main, 4, backend="gloo",
                              args=(lay, dirs[lay]), timeout_s=600)
              for lay in cases.LAYOUTS}
    try:
        one = cases.unsharded()
        out = {lay: w.join() for lay, w in worlds.items()}
        text = reference.communicate(timeout=600)[0]
        assert reference.returncode == 0 \
            and "PRODUCTION_MESH_DECODE_OK" in text, text
        with np.load(ref_file) as z:
            ref = {name: z[name] for name in cases.REFERENCE}
    finally:
        for w in worlds.values():
            w.close()
        if reference.poll() is None:
            reference.kill()
        torch.set_num_threads(saved)
    return out, one, ref, dirs


def _runs(world, name, layout):
    return [res["runs"][name] for res in world[0][layout]]


def _split(run) -> bool:
    """Whether the run's KV caches split their sequence over ``model``."""
    spec = run["bytes"]["kv_k"][2]
    return len(spec) > 2 and spec[2] is not None


@pytest.mark.parametrize("layout", cases.LAYOUTS)
def test_ranks_load_no_jax_and_lay_out_row_major(world, layout):
    for r, res in enumerate(world[0][layout]):
        assert res["foreign"] == []
        assert res["coords"] == divmod(r, layout[1])


@pytest.mark.parametrize("name,layout", RUNS)
def test_decode_matches_one_device(world, name, layout):
    """Every step's logits and the final state within the case's bounds
    of one device (``cases.bounds``: f32 1e-5 of the largest entry; bf16
    2e-2 for the logits, 2^-6 for the caches), and the ranks bit for bit
    alike.  A bf16 moe case may route a token apart from one device
    where its top-k sits within ROUTE_TIE of a tie (the ranks sum in
    another order): the logits are then held up to that step, the caches
    on the slots before it (``cases.gaps``); an f32 case routes every
    token alike."""
    want = world[1][name]
    runs = _runs(world, name, layout)
    bound = cases.bounds(name)
    for run in runs:
        assert run["logits"].shape == want["logits"].shape
        assert np.array_equal(run["logits"], runs[0]["logits"])
        for f, w in want["state"].items():
            assert run["state"][f].shape == w.shape, f
            assert np.array_equal(run["state"][f], runs[0]["state"][f]), f
        got = cases.gaps(name, run, want)
        if cases.CASES[name].dtype == "float32":
            assert got["upto"] == STEPS
        assert got["margin"] <= ROUTE_TIE, got
        assert got["logits"] <= bound["logits"], got
        for f, err in got["state"].items():
            assert err <= bound["cache" if f in ("kv_k", "kv_v")
                                else "state"], (f, err)
        assert got["held"]


@pytest.mark.parametrize("name,layout", RUNS)
def test_greedy_tokens_match_one_device(world, name, layout):
    """``serve_batch``'s greedy tokens equal one device's.  A bf16 case's
    may part from them, only where one device's choice was near a tie: at
    the first step whose routes differ, every route apart within
    ROUTE_TIE of a tie (as in the teacher-forced decode); or, where a
    token differs before any route does, that step's two tokens within
    twice the logits' bound of each other on one device (each run within
    the bound of the other).  Every step's logits before then within the
    bound."""
    want_run = world[1][name]
    want = want_run["greedy"]
    assert want.shape == (cases.CASES[name].batch, cases.NEW)
    top = float(np.abs(want_run["served"]).max())
    logit_bound = cases.bounds(name)["logits"]
    for run in _runs(world, name, layout):
        if cases.CASES[name].dtype == "float32":
            assert cases.first_flip(run, want_run, 1)[0] == STEPS
            np.testing.assert_array_equal(run["greedy"], want)
            continue
        # token t is chosen from step PROMPT − 1 + t's logits
        apart = np.flatnonzero((run["greedy"] != want).any(0))
        chosen = cases.PROMPT - 1 + int(apart[0]) if apart.size else STEPS
        routed, margin = cases.first_flip(run, want_run, 1)
        if routed <= chosen and routed < STEPS:
            assert margin <= ROUTE_TIE, (routed, margin)
        elif chosen < STEPS:
            t = chosen - cases.PROMPT + 1
            rows = np.flatnonzero(run["greedy"][:, t] != want[:, t])
            one = want_run["served"][rows, chosen]
            gap = one[np.arange(rows.size), want[rows, t]] \
                - one[np.arange(rows.size), run["greedy"][rows, t]]
            assert float(gap.max()) <= 2 * logit_bound * top, gap
        upto = min(routed, chosen)
        err = float(np.abs(run["served"][:, :upto]
                           - want_run["served"][:, :upto]).max())
        assert err <= logit_bound * top, err


@pytest.mark.parametrize("name,layout", RUNS)
def test_decode_collectives_as_predicted(world, name, layout):
    case = cases.CASES[name]
    cfg = cases.config(name)
    for run in _runs(world, name, layout):
        want = cases.decode_calls(cfg, layout[1], case.act_tp, _split(run),
                                  case.mode)
        assert run["calls"] == want


@pytest.mark.parametrize("name,layout", RUNS)
def test_decode_state_holds_its_block(world, name, layout):
    """Each rank holds its block of every leaf the table splits: 1/m of
    the whole over ``model``, 1/(d·m) with the batch over ``data`` too;
    whole where it splits none.  The caches split their sequence where m
    divides it; the one case of 21 slots keeps them whole."""
    case = cases.CASES[name]
    cfg = cases.config(name)
    d, m = layout
    window = cfg.local_window if cfg.family == "hybrid" else case.window
    cap = min(window or cases.max_len(case), cases.max_len(case))
    for run in _runs(world, name, layout):
        over_model = set()
        for f, (local, whole, spec) in run["bytes"].items():
            n = 1
            for entry in spec:
                if entry is None:
                    continue
                for axis in (entry,) if isinstance(entry, str) else entry:
                    n *= {"data": d, "model": m}[axis]
            assert local * n == whole, (f, local, whole, spec)
            if "model" in spec:
                over_model.add(f)
            if f in ("kv_k", "kv_v") and whole:
                assert spec[2] == ("model" if cap % m == 0 else None), f
        assert bool(over_model) == (name != "llama3-8b whole cache")


@pytest.mark.parametrize("name", cases.REFERENCE)
def test_reference_mesh_decode_matches(world, name):
    """The reference's own jitted decode on its (2, 2) mesh against the
    port's one-device and mesh decodes from the same weights and
    tokens."""
    _, one, ref, _ = world
    got = ref[name]
    want = one[name]["logits"]
    assert got.shape == want.shape
    top = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= BOUND * top
    mesh = _runs(world, name, (2, 2))[0]["logits"]
    assert float(np.abs(got - mesh).max()) <= BOUND * top


@pytest.mark.parametrize("name", cases.CKPT_CASES)
@pytest.mark.parametrize("layout", cases.LAYOUTS)
def test_mesh_checkpoint_round_trips(world, layout, name):
    """Saved on the mesh by the case's model (gathered by its own
    placement, in either weight mode): each rank's blocks restored onto
    the mesh bit for bit; the archive is the whole tree, bit for bit,
    through the port's one-device restore and through the reference's."""
    out, _, _, dirs = world
    for res in out[layout]:
        assert res["ckpt"][name]["restored"]
        assert res["ckpt"][name]["step"] == 3
    _, params, _, _ = cases.setup(name)
    whole = cases.ckpt_tree(params)
    want = {k.replace("/.", "/"): v.numpy() for k, v in
            ckpt_io._flatten(whole).items()}
    directory = cases.ckpt_dir(dirs[layout], name)
    got, manifest = ckpt_io.restore(directory, device="cpu")
    assert manifest["step"] == 3
    got = {k.replace("/.", "/"): v.numpy()
           for k, v in tree.named_leaves(got)}
    jgot, _ = jckpt.restore(directory)
    jgot = {k.replace("/.", "/"): np.asarray(v)
            for k, v in tree.named_leaves(jgot)}
    assert sorted(got) == sorted(want) == sorted(jgot)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k
        assert np.array_equal(jgot[k], w), k


@pytest.mark.parametrize("name", cases.CKPT_CASES)
@pytest.mark.parametrize("layout", cases.LAYOUTS)
def test_mesh_checkpoint_refusals(world, layout, name):
    res = world[0][layout][0]["ckpt"][name]
    kind, text = res["blocks_as_whole"]
    assert kind == "ValueError" and "one rank's block" in text
    kind, text = res["no_like"]
    assert kind == "ValueError" and "like=" in text


@pytest.mark.parametrize("layout", cases.LAYOUTS)
def test_cloned_mesh_state_decodes(world, layout):
    """``tree.map(torch.clone, state)`` keeps a mesh decode state's
    placement: the clone decodes as the state it was cloned from."""
    assert all(res["clone_decodes"] for res in world[0][layout])


def test_mesh_decode_refuses_a_whole_state(world):
    for lay in cases.LAYOUTS:
        kind, text = world[0][lay][0]["refusals"]["whole_state"]
        assert kind == "ValueError" and "MeshDecodeState" in text


def test_bf16_decode_routes_near_ties():
    """Reduced qwen3-moe in bf16 (parameters and activations, as the
    published config) decodes 24 tokens of 4 rows: each MoE call's router
    input through the port's ``moe.route`` and the reference's from the
    same bf16 bits (the routes a mesh decode runs too: ``moe_ffn_sharded``
    routes by ``route``), and the teacher-forced forward over the same
    tokens (at capacity E / k: no drops), routed to decode's experts as
    ``chip_smoke.py`` routes it, against its own top-k.  Every route
    the reference's or the forward's own choice takes apart from
    decode's sits within ROUTE_TIE of a tie.  Measured: no decode route
    apart from the reference's (192 token-layers); the forward's own
    choice apart at 1 of 192, its margin 8.1e-4 (ROUTE_TIE = 2^-4 holds,
    77 times over), 42 of 192 within ROUTE_TIE."""
    cfg = dataclasses.replace(reduced(get_config(cases.MOE[0])),
                              param_dtype="bfloat16", activ_dtype="bfloat16")
    k = cfg.experts_per_token
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(5), device="cpu")
    tok = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (4, 24)), dtype=torch.int32)
    real = moe.route
    calls = []

    def record(x, w, k_):
        out = real(x, w, k_)
        calls.append((x, w, out[1], torch.topk(out[2], k_ + 1, -1).values))
        return out

    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "route", record)
        state = model.init_decode(4, tok.shape[1], device="cpu")
        for t in range(tok.shape[1]):
            _, state = model.decode_step(params, state, tok[:, t:t + 1])
    n = cfg.num_layers
    decode = [torch.cat([c[2] for c in calls[layer::n]], 1)
              for layer in range(n)]

    def margin(top):
        return ((top[..., k - 1] - top[..., k]) / top[..., k - 1]).numpy()

    apart_ref = 0
    for x, w, idx, _ in calls:
        jx, jw = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (x, w))
        jidx = np.asarray(jmoe.route(jx, jw, k)[1])
        apart_ref += int((np.sort(idx.numpy(), -1)
                          != np.sort(jidx, -1)).any(-1).sum())
    forced, own = iter(decode), []

    def routed(x, w, k_):
        gates, idx, probs = real(x, w, k_)
        own.append((idx, torch.topk(probs, k_ + 1, -1).values))
        idx = next(forced)
        gates = torch.gather(probs, -1, idx)
        return gates / gates.sum(-1, keepdim=True), idx, probs

    dropless = build_model(dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / k))
    dropped = []
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "route", routed)
        dropless.forward_with_aux(params, {"tokens": tok}, dropped)
    assert not any(float(d) for d in dropped)
    apart, worst, within = 0, 0.0, 0
    for (idx, top), want in zip(own, decode):
        flip = (idx.sort(-1).values != want.sort(-1).values).any(-1).numpy()
        mg = margin(top)
        within += int((mg <= ROUTE_TIE).sum())
        apart += int(flip.sum())
        if flip.any():
            worst = max(worst, float(mg[flip].max()))
    print(f"bf16 decode routes: {apart_ref} of {len(calls) * 4} apart from "
          f"the reference's; the forward's own {apart} of "
          f"{n * tok.numel()} apart, largest margin {worst:.3e}, {within} "
          f"within ROUTE_TIE {ROUTE_TIE}")
    assert apart_ref == 0
    assert worst <= ROUTE_TIE
