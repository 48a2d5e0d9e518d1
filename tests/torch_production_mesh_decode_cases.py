"""Decode, serving and checkpoints on the production mesh, run by every
rank of a local gloo world (``tests/test_torch_production_mesh_decode.py``)
and, without a mesh, by the test process as their reference.

The ranks are spawned processes that must load nothing of JAX or of the
reference package, so this module imports numpy, torch and
``repro_torch`` only.  The configurations are ``reduced(get_config(arch))``
(2 layers of width 256, 4 heads, vocabulary 512; recurrentgemma one unit
of 3 layers, window 16; whisper a 2-layer encoder over 16 stub frames),
in f32 or, for the bf16 cases, with bf16 parameters and activations.
Each case feeds PROMPT + NEW tokens of a (4, ·) batch through
``decode_step`` one at a time (teacher-forced), so that the caches pass
``length < C/m`` and the rings wrap (recurrentgemma's window of 16, the
dense ``decode_window`` of 8), and serves the same prompts through
``serve_batch`` for NEW greedy tokens.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.ckpt import io as ckpt_io
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.core import ssca
from repro_torch.launch import serve, sharding, specs, steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model, moe

PROMPT, NEW = 8, 12
BATCH = 4
AXES = ("data", "model")
LAYOUTS = ((2, 2), (1, 4))
MOE = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b")


class Case(NamedTuple):
    arch: str
    mode: str = "fsdp"           # the moe family's weight mode
    window: int = 0              # the dense ring's decode_window
    batch: int = BATCH
    spare: int = 0               # cache slots past PROMPT + NEW
    act_tp: Optional[str] = "model"
    dtype: str = "float32"       # the parameters' and activations'


CASES = {
    "qwen3-moe": Case(MOE[0]),
    "qwen3-moe stationary": Case(MOE[0], mode="stationary"),
    "llama4-maverick": Case(MOE[1]),
    "llama4-maverick stationary": Case(MOE[1], mode="stationary"),
    "rwkv6-7b": Case("rwkv6-7b"),
    "recurrentgemma-9b": Case("recurrentgemma-9b"),
    "phi-3-vision-4.2b": Case("phi-3-vision-4.2b"),
    "whisper-large-v3": Case("whisper-large-v3"),
    # a ring of 8 slots: it wraps past 8 tokens
    "llama3-8b window": Case("llama3-8b", window=8),
    # 21 slots: m ∤ C, the cache whole on every model rank (head-parallel
    # attention); 3 rows: the data axis does not divide them, every rank
    # decodes all three
    "llama3-8b whole cache": Case("llama3-8b", batch=3, spare=1),
    # the residual stream whole between layers
    "phi-3-vision-4.2b act_tp=None": Case("phi-3-vision-4.2b", act_tp=None),
    "rwkv6-7b act_tp=None": Case("rwkv6-7b", act_tp=None),
    # bf16 parameters, activations and caches, as the published widths
    # run: the split-K combine's f32 partials against one device's
    # bf16 P·V
    "llama3-8b bf16": Case("llama3-8b", dtype="bfloat16"),
    "qwen3-moe bf16": Case(MOE[0], dtype="bfloat16"),
}
# the cases the reference's own mesh decode runs (in a subprocess)
REFERENCE = ("llama3-8b window", "qwen3-moe")


STEPS = PROMPT + NEW
BOUND = 1e-5           # of the largest |logit| / |entry|, f32 cases
# bf16 cases: ``tests/test_torch_launch.py``'s bounds of a bf16 decode
# (logits 2e-2 of the largest, caches 2^-6: 2 ulps); measured on the CPU
# at most 5.5e-3 and 9.0e-3
BF16_LOGITS, BF16_CACHE = 2e-2, 2.0 ** -6
# a route's relative top-k margin, (p_k − p_{k+1}) / p_k, below which two
# paths' rounding may pick either expert (``chip_smoke.py``'s ROUTE_TIE)
ROUTE_TIE = 2.0 ** -4


def bounds(name: str) -> dict:
    """A case's bounds, each a share of the largest |entry| one device
    gives: ``logits``, ``cache`` (the KV caches), ``state`` (the other
    decode-state leaves)."""
    if CASES[name].dtype == "float32":
        return {"logits": BOUND, "cache": BOUND, "state": BOUND}
    return {"logits": BF16_LOGITS, "cache": BF16_CACHE, "state": BF16_LOGITS}


def first_flip(got: dict, want: dict, which: int):
    """(the first step whose routes differ between a mesh run ``got`` and
    the one-device run ``want``, the largest one-device top-k margin
    among the routes apart there) — ``which``: 0 the teacher-forced
    decode's routes, 1 ``serve_batch``'s; (STEPS, 0) where none differ or
    the family has no router."""
    if want["routes"] is None:
        return STEPS, 0.0
    (ids, _), (want_ids, margin) = got["routes"][which], \
        want["routes"][which]
    apart = (ids != want_ids).any(-1)                  # (steps, layers, B)
    steps = np.flatnonzero(apart.any((1, 2)))
    if not steps.size:
        return STEPS, 0.0
    first = int(steps[0])
    return first, float(margin[first][apart[first]].max())


def gaps(name: str, got: dict, want: dict) -> dict:
    """A mesh run's teacher-forced decode against one device's: ``upto``
    and ``margin`` (:func:`first_flip`), the logits' largest gap before
    step ``upto`` and each state leaf's (where a route parted, only the
    KV caches', on the slots before ``upto``: no case that routes has a
    ring), each a share of one device's largest |entry|; ``held``: all
    within :func:`bounds`, every route alike in an f32 case and apart
    only within ROUTE_TIE of a tie in a bf16 one."""
    upto, margin = first_flip(got, want, 0)
    top = float(np.abs(want["logits"]).max())
    out = {"upto": upto, "margin": margin,
           "logits": float(np.abs(got["logits"][:, :upto]
                                  - want["logits"][:, :upto]).max()) / top,
           "state": {}}
    for f, w in want["state"].items():
        g = got["state"][f]
        if upto < STEPS:
            if f not in ("kv_k", "kv_v"):
                continue
            assert w.shape[2] == max_len(CASES[name])
            g, w = g[:, :, :upto], w[:, :, :upto]
        if w.size and np.abs(w).max():
            out["state"][f] = float(np.abs(g - w).max()) \
                / float(np.abs(w).max())
    b = bounds(name)
    out["held"] = (upto == STEPS or CASES[name].dtype != "float32") \
        and margin <= ROUTE_TIE and out["logits"] <= b["logits"] and all(
            e <= b["cache" if f in ("kv_k", "kv_v") else "state"]
            for f, e in out["state"].items())
    return out


def max_len(case: Case) -> int:
    return PROMPT + NEW + case.spare


def config(name: str):
    """A case's reduced configuration in its dtype."""
    case = CASES[name]
    return dataclasses.replace(reduced(get_config(case.arch)),
                               param_dtype=case.dtype,
                               activ_dtype=case.dtype)


def setup(name: str):
    """(config, full parameters, tokens (B, PROMPT + NEW) int32, frames
    (B, encoder_seq, D) f32 or None) of a case, drawn from seeds of its
    index; RWKV-6's ``ln_w`` and ``bonus`` from N(0, 0.5²), as
    ``tests/test_torch_launch.py`` draws them, so that the WKV state
    counts."""
    case = CASES[name]
    seed = list(CASES).index(name)
    cfg = config(name)
    params = build_model(cfg).init(torch.Generator().manual_seed(seed),
                                   device="cpu")
    rng = np.random.default_rng(100 + seed)
    if cfg.family == "ssm":
        for leaf in ("ln_w", "bonus"):
            params["blocks"][leaf] = torch.as_tensor(rng.normal(
                0.0, 0.5, params["blocks"][leaf].shape).astype(np.float32))
    tokens = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (case.batch, PROMPT + NEW)), dtype=torch.int32)
    frames = None
    if cfg.family == "audio":
        frames = torch.as_tensor(rng.standard_normal(
            (case.batch, cfg.encoder_seq, cfg.d_model)), dtype=torch.float32)
    return cfg, params, tokens, frames


def model_for(name: str, mesh=None):
    """The case's model: one device, or on ``mesh`` with the placement
    its weight mode shards with → (model, the placement's options)."""
    case = CASES[name]
    cfg = config(name)
    place = dict(moe_fsdp_dim="f" if case.mode == "stationary" else "d")
    if mesh is None:
        return build_model(cfg, decode_window=case.window), place
    return build_model(cfg, decode_window=case.window, mesh=mesh,
                       act_tp=case.act_tp, moe_weight_mode=case.mode,
                       layer_pspec_fn=sharding.layer_pspec_fn(
                           mesh, **place)), place


def on(device, params, tokens, frames):
    """A case's parameters, tokens and frames on ``device``."""
    return (tree.map(lambda w: w.to(device), params), tokens.to(device),
            None if frames is None else frames.to(device))


@contextlib.contextmanager
def routes_recorded(calls: list):
    """Every ``moe.route`` call inside, one-device and expert-parallel
    alike, appends to ``calls`` its rows' expert ids (sorted) and each
    row's relative top-k margin (p_k − p_{k+1}) / p_k."""
    real = moe.route

    def record(x, w, k):
        out = real(x, w, k)
        top = torch.topk(out[2], k + 1, -1).values
        calls.append((out[1].sort(-1).values,
                      (top[..., k - 1] - top[..., k]) / top[..., k - 1]))
        return out

    moe.route = record
    try:
        yield
    finally:
        moe.route = real


def run(name: str, mesh=None, device="cpu") -> dict:
    """A case's decode on ``device``, one device or on ``mesh``
    (``launch.steps.make_decode_step``): every step's logits (the whole
    batch's, gathered over the data axes), the last step's collectives,
    the final state (each leaf whole, gathered by its placement), each
    leaf's bytes on this rank against the whole's, and ``serve_batch``'s
    greedy tokens from the prompts and its every step's logits; the moe
    family's routes of every
    step of both, whole batch (:func:`routes_recorded`); all on the
    host."""
    case = CASES[name]
    cfg, *drawn = setup(name)
    params, tokens, frames = on(device, *drawn)
    model, place = model_for(name, mesh)
    p = params if mesh is None else sharding.shard_params(params, mesh,
                                                          **place)

    def rows(x):
        return x if mesh is None else sharding.decode_rows(x, mesh)

    def whole(x):
        return x if mesh is None else sharding.gather_rows(x, mesh,
                                                           case.batch)

    def routes(calls):
        """(steps, MoE layers, B, k) ids and (steps, MoE layers, B)
        margins; a stationary call's rows are the whole batch already."""
        got = [tuple((x if x.shape[0] == case.batch else whole(x))[:, 0]
                     .cpu().numpy() for x in c) for c in calls]
        n = len(got) // (PROMPT + NEW)
        return tuple(np.stack([g[i] for g in got]).reshape(
            PROMPT + NEW, n, *got[0][i].shape) for i in range(2))

    state = model.init_decode(case.batch, max_len(case), device=device)
    if frames is not None:
        state = model.precompute_cross(p, {"frame_embeds": rows(frames)},
                                       state)
    step = steps.make_decode_step(model)
    logits, calls, forced = [], None, []
    with routes_recorded(forced):
        for t in range(tokens.shape[1]):
            last = t == tokens.shape[1] - 1
            if mesh is not None and last:
                mesh.reset_counts()
            out, state = step(p, state, {"tokens": rows(tokens[:, t:t + 1])})
            if mesh is not None and last:
                calls = dict(mesh.calls)
            logits.append(whole(out))
    out = {"logits": torch.cat(logits, 1).float().cpu().numpy(),
           "calls": calls}
    if mesh is None:
        out["state"] = {f: x.float().cpu().numpy() for f, x in zip(
            state._fields, state)}
    else:
        out["state"] = {f: sharding.gather_block(x, s, mesh).float().cpu()
                        .numpy() for f, x, s in zip(state._fields, state,
                                                    state.placement)}
        out["bytes"] = {f: (x.numel() * x.element_size(),
                            int(np.prod(sharding.whole_shape(x.shape, s,
                                                             mesh)))
                            * x.element_size(), s)
                        for f, x, s in zip(state._fields, state,
                                           state.placement)}
    reqs = [serve.Request(r.cpu().numpy(), NEW)
            for r in tokens[:, :PROMPT]]
    served, record = [], []
    with routes_recorded(served):
        out["greedy"] = serve.serve_batch(model, p, reqs, frame_embeds=frames,
                                          record=record)[0]
    out["served"] = torch.cat([whole(x) for x in record], 1).float() \
        .cpu().numpy()
    out["routes"] = (routes(forced), routes(served)) \
        if cfg.family == "moe" else None
    return out


def ckpt_tree(local):
    """A train step's checkpoint: the parameters and an SSCA state (its
    ``lin`` and ``beta`` placed as the parameters, the step whole) made
    from ``local``, this rank's blocks (or the whole tree)."""
    return {"params": local, "state": ssca.SSCAState(
        step=torch.tensor(3, dtype=torch.int32,
                          device=tree.leaves(local)[0].device),
        lin=tree.map(lambda w: 0.5 * w + 1.0, local),
        beta=tree.map(lambda w: -w, local))}


# a checkpoint of each weight mode's placement (the experts' data shard on
# d_model, and on d_ff in "stationary" mode)
CKPT_CASES = ("qwen3-moe", "qwen3-moe stationary")


def ckpt_case(mesh, directory: str, name: str, device="cpu") -> dict:
    """A mesh checkpoint of case ``name``'s parameters and SSCA state:
    saved by the case's mesh model (every rank calls; the leaves gathered
    by its placement), restored onto the mesh (each rank's blocks bit for
    bit its own) — and the refusals: one rank's blocks handed to a save
    as whole leaves, a mesh save without ``like``."""
    _, params, _, _ = setup(name)
    model, place = model_for(name, mesh)
    local = sharding.shard_params(tree.map(lambda w: w.to(device), params),
                                  mesh, **place)
    saved = ckpt_tree(local)
    like = ckpt_tree(specs.param_specs(model_for(name)[0]))
    size = ckpt_io.save(directory, saved, step=3, model=model, like=like)
    back, manifest = ckpt_io.restore(directory, device=device, model=model)
    want = dict(tree.named_leaves({"params": local, "state": {
        ".step": saved["state"].step, ".lin": saved["state"].lin,
        ".beta": saved["state"].beta}}))
    got = dict(tree.named_leaves(back))
    out = {"size": size, "step": manifest["step"],
           "restored": sorted(got) == sorted(want) and all(
               torch.equal(got[k], want[k]) for k in want)}
    for key, kw in (("blocks_as_whole", {"like": like}),
                    ("no_like", {"model": model})):
        try:
            ckpt_io.save(directory + "-" + key, saved, **kw)
            out[key] = (None, "")
        except ValueError as e:
            out[key] = ("ValueError", str(e))
    return out


def ckpt_dir(root: str, name: str) -> str:
    """Where :func:`rank_main` saves case ``name``'s checkpoint."""
    return f"{root}/ckpt-{CKPT_CASES.index(name)}"


def clone_decodes(mesh) -> bool:
    """A mesh decode state cloned by ``tree.map`` (as ``decode_step``'s
    docstring says to keep one) decodes, and its next step's logits
    equal those of the state it was cloned from."""
    cfg = reduced(get_config("llama3-8b"))
    model = build_model(cfg, mesh=mesh,
                        layer_pspec_fn=sharding.layer_pspec_fn(mesh))
    p = sharding.shard_params(build_model(cfg).init(
        torch.Generator().manual_seed(0), device="cpu"), mesh)
    tok = sharding.decode_rows(torch.as_tensor(np.random.default_rng(
        1).integers(0, cfg.vocab_size, (BATCH, 3)), dtype=torch.int32), mesh)
    state = model.init_decode(BATCH, 8, device="cpu")
    for t in range(2):
        _, state = model.decode_step(p, state, tok[:, t:t + 1])
    kept = tree.map(torch.clone, state)
    want, state = model.decode_step(p, state, tok[:, 2:])
    got, kept = model.decode_step(p, kept, tok[:, 2:])
    return bool(torch.equal(got, want)) and all(
        torch.equal(a, b) for a, b in zip(kept, state))


def refusals(mesh) -> dict:
    """A mesh decode refuses a state that is not the rank's blocks with
    their placement (the one-device model's whole state)."""
    cfg = reduced(get_config("llama3-8b"))
    model = build_model(cfg, mesh=mesh,
                        layer_pspec_fn=sharding.layer_pspec_fn(mesh))
    whole = build_model(cfg).init_decode(2, 8, device="cpu")
    p = sharding.shard_params(build_model(cfg).init(
        torch.Generator().manual_seed(0), device="cpu"), mesh)
    try:
        model.decode_step(p, whole, torch.zeros((2, 1), dtype=torch.int32))
    except ValueError as e:
        return {"whole_state": ("ValueError", str(e))}
    return {"whole_state": (None, "")}


def unsharded() -> dict:
    """Every case on one device."""
    return {name: run(name) for name in CASES}


def rank_main(layout, directory: str) -> dict:
    """A rank's entry for one layout: every case, the checkpoints under
    ``directory``, a cloned state's decode and the refusals."""
    mesh = make_mesh(layout, AXES, device="cpu")
    out = {"foreign": sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "jaxlib", "repro")),
           "coords": mesh.coords,
           "runs": {name: run(name, mesh) for name in CASES},
           "ckpt": {name: ckpt_case(mesh, ckpt_dir(directory, name), name)
                    for name in CKPT_CASES},
           "clone_decodes": clone_decodes(mesh),
           "refusals": refusals(mesh)}
    return out


def attn_calls(act_tp, split: bool, cross: bool = False) -> dict:
    """The collectives of one attention layer's decode (self-attention or,
    with ``cross``, whisper's cross-attention): its entry into the model
    group and its exit (:func:`_ends`); the projections' columns gathered
    over ``model`` by one call (q, k and v where the cache is split, k
    and v where it is whole; the cross-attention's q where split, nothing
    where whole); split, the scores' max and share all-reduced and the
    output reduce-scattered onto the rank's heads."""
    calls = _ends(act_tp)
    if split or not cross:
        calls = _plus(calls, {"all_gather:model": 1})
    if split:
        calls = _plus(calls, {"all_reduce_max:model": 1,
                              "all_reduce:model": 1,
                              "reduce_scatter:model": 1})
    return calls


def _ends(act_tp, entries: int = 1, exits: int = 1) -> dict:
    """Entries into the model group and exits out of it: an all-gather
    and a reduce-scatter over ``model`` each with ``act_tp="model"``; with
    None an entry moves nothing and an exit all-reduces."""
    if act_tp == "model":
        return {"all_gather:model": entries, "reduce_scatter:model": exits}
    return {"all_reduce:model": exits}


def _plus(*parts) -> dict:
    out: dict = {}
    for part in parts:
        for k, v in part.items():
            out[k] = out.get(k, 0) + v
    return out


def moe_ffn_calls(act_tp, mode: str) -> dict:
    """A MoE FFN's decode: its entry; ``"fsdp"``: the experts' three
    gathers over ``data``, the global load-balance statistics' all-reduce
    over ``data``, the combine's exit over ``model`` and the kept count's
    all-reduce over (data, model); ``"stationary"``: the rows gathered
    over ``data``, one all-reduce over (data, model) that combines, and
    the kept count's over ``model``."""
    if mode == "stationary":
        return _plus(_ends(act_tp, exits=0),
                     {"all_gather:data": 1, "all_reduce:data+model": 1,
                      "all_reduce:model": 1})
    return _plus(_ends(act_tp), {"all_gather:data": 3, "all_reduce:data": 1,
                                 "all_reduce:data+model": 1})


def decode_calls(cfg, m: int, act_tp, split: bool,
                 mode: str = "fsdp") -> dict:
    """The collectives one decode step calls on each set of axes, each call
    counted once whatever its axes' size (``ProductionMesh.calls``).
    Outside the layers: the embedding table's gather over ``data``, the
    lookup's exit, the final norm's entry, the logits' vocab gathered
    over ``model``.  Each layer gathers its leaves split over ``data``
    (``MeshContext.layer``: the dense blocks' projections, the router,
    the shared expert's; the experts move inside ``moe_ffn_sharded``),
    then its blocks: attention (:func:`attn_calls`; whisper's decoder
    adds its cross-attention, split where m divides ``encoder_seq``),
    the dense FFN (an entry and an exit), the
    MoE FFN (:func:`moe_ffn_calls`), RWKV-6 (its two shifts gathered over
    ``model`` by one call, the time mix's entry and exit, the channel
    mix's entry and its reduce-scatter, and with ``act_tp=None`` its
    ``gather_from``), the recurrent block (its entry, the branch and
    ``w_ri`` gathered over ``model``, its exit, its FFN)."""
    from torch_production_mesh_family_cases import _ffn_leaves
    fam = cfg.family
    attn = attn_calls(act_tp, split)
    ffn = _ends(act_tp)
    dense_data = 4 + _ffn_leaves(cfg)
    if fam in ("dense", "vlm"):
        layers = [(cfg.num_layers, dense_data, [attn, ffn])]
    elif fam == "moe":
        moe_data = 4 + 1 + (3 if cfg.shared_expert else 0)
        moe = moe_ffn_calls(act_tp, mode)
        layers = [(cfg.num_layers, moe_data, [attn, moe])] \
            if cfg.moe_every == 1 \
            else [(cfg.num_layers // cfg.moe_every, dense_data + moe_data,
                   [attn, ffn, attn, moe])]
    elif fam == "ssm":
        rw = _plus({"all_gather:model": 1, "reduce_scatter:model": 1},
                   _ends(act_tp), _ends(act_tp, exits=0),
                   {} if act_tp == "model" else {"all_gather:model": 1})
        layers = [(cfg.num_layers, 9, [rw])]
    elif fam == "hybrid":
        rec = _plus({"all_gather:model": 2}, _ends(act_tp), ffn)
        unit = cfg.pattern_recurrent + cfg.pattern_attn
        rec_data = 4 + _ffn_leaves(cfg)
        layers = [(cfg.num_layers // unit,
                   cfg.pattern_recurrent * rec_data
                   + cfg.pattern_attn * dense_data,
                   [rec] * cfg.pattern_recurrent
                   + [attn, ffn] * cfg.pattern_attn),
                  (cfg.num_layers % unit, rec_data, [rec])]
    else:                                                   # audio
        cross = attn_calls(act_tp, cfg.encoder_seq % m == 0, cross=True)
        layers = [(cfg.num_layers, 8 + _ffn_leaves(cfg), [attn, cross, ffn])]
    out = _plus({"all_gather:data": 1, "all_gather:model": 1}, _ends(act_tp))
    for n, data, parts in layers:
        for _ in range(n):
            out = _plus(out, {"all_gather:data": data}, *parts)
    return {k: v for k, v in out.items() if v}
