"""The production mesh's train and prefill steps of the moe, ssm, hybrid,
vlm and audio families, run by every rank of a local gloo world
(``tests/test_torch_production_mesh_families.py``) and, without a mesh,
by the test process as their reference.

The ranks are spawned processes that must load nothing of JAX or of the
reference package, so this module imports numpy, torch and
``repro_torch`` only.  The configurations are ``reduced(get_config(arch))``
(2 layers of width 256, 4 heads, vocabulary 512; recurrentgemma one unit
of 3 layers, window 16; the vlm 8 stub image tokens; whisper a 2-layer
encoder over 16 stub frames), three Algorithm-1 train steps (τ = 1) on a
batch of (4, 32) tokens, as ``torch_production_mesh_cases.py``'s dense
cases, and one prefill step from the first weights.
"""
from __future__ import annotations

import dataclasses
import sys
from unittest import mock

import numpy as np
import torch

from repro_torch import parallel, tree
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape, reduced
from repro_torch.core import ssca
from repro_torch.launch import sharding, steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.models import build_model, sharded

MOE = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b")
ARCHS = (*MOE, "rwkv6-7b", "recurrentgemma-9b", "phi-3-vision-4.2b",
         "whisper-large-v3")
# recurrentgemma at 5 layers: a unit and a recurrent tail of 2 (at (2, 2))
TAIL = "recurrentgemma-9b+tail"
CASES = (*ARCHS, TAIL)
# the cases also run with the residual stream whole (act_tp=None) at (2, 2)
NO_ACT_TP = ("rwkv6-7b", "phi-3-vision-4.2b")
LAYOUTS = ((2, 2), (1, 4))
STEPS = 3
HP = ssca.SSCAHyperParams(tau=1.0)
AXES = ("data", "model")
BATCH, SEQ = 4, 32


def draw(cfg, seed: int, tok_seed: int, shape=(BATCH, SEQ)):
    """(config, full parameters, batch): the weights drawn from a
    generator seeded ``seed``, the tokens of ``shape`` and the stub
    embeddings (f32 N(0, 1)) from numpy's ``tok_seed``."""
    params = build_model(cfg).init(torch.Generator().manual_seed(seed),
                                   device="cpu")
    rng = np.random.default_rng(tok_seed)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, shape), dtype=torch.int32)}
    for key, rows in (("img_embeds", cfg.num_image_tokens if cfg.family
                       == "vlm" else 0),
                      ("frame_embeds", cfg.encoder_seq if cfg.family
                       == "audio" else 0)):
        if rows:
            batch[key] = torch.as_tensor(rng.standard_normal(
                (shape[0], rows, cfg.d_model)), dtype=torch.float32)
    return cfg, params, batch


def setup(case):
    """(config, full parameters, batch) of a case, drawn from seeds of its
    index."""
    cfg = reduced(get_config(case.split("+")[0]))
    if case == TAIL:
        cfg = dataclasses.replace(cfg, num_layers=5)
    return draw(cfg, CASES.index(case), 11 + CASES.index(case))


def numpy_tree(params) -> dict:
    return {name: leaf.detach().float().numpy()
            for name, leaf in tree.named_leaves(params)}


def _train(step, p, batch, mesh=None):
    """STEPS steps → (the parameters and ``lin`` after the last, (loss,
    ‖g‖) a step, each step's collectives on a mesh)."""
    st = ssca.init(p, with_beta=False)
    metrics, calls = [], []
    for _ in range(STEPS):
        if mesh is not None:
            mesh.reset_counts()
        p, st, m = step(p, st, batch)
        metrics.append((float(m["loss"]), float(m["kkt_residual"])))
        if mesh is not None:
            calls.append(dict(mesh.calls))
    return p, st.lin, metrics, calls


def unsharded(arch) -> dict:
    """The port's one-device steps and prefill, and each MoE layer's
    dropped share at the first weights."""
    cfg, params, batch = setup(arch)
    model = build_model(cfg)
    p, lin, metrics, _ = _train(steps.make_train_step(model, HP), params,
                                batch)
    dropped = []
    with torch.no_grad():
        model.forward_with_aux(params, batch, dropped)
    return {"params": numpy_tree(p), "lin": numpy_tree(lin),
            "metrics": metrics, "dropped": [float(d) for d in dropped],
            "prefill": steps.make_prefill_step(model)(params, batch).numpy()}


def family_case(mesh, arch, act_tp="model") -> dict:
    """The sharded steps of a case from the same weights and batch: the
    parameters and ``lin`` gathered, (loss, ‖g‖) and the collectives a
    step, each MoE layer's dropped share and the prefill logits (rows
    gathered over ``data``) at the first weights, the prefill's
    collectives."""
    cfg, params, batch = setup(arch)
    model = build_model(cfg, mesh=mesh, act_tp=act_tp,
                        layer_pspec_fn=sharding.layer_pspec_fn(mesh))
    p0 = sharding.shard_params(params, mesh)
    b = sharding.local_batch(batch, mesh)
    dropped = []
    with torch.no_grad():
        model.forward_with_aux(p0, b, dropped)
    mesh.reset_counts()
    logits = steps.make_prefill_step(model)(p0, b)
    prefill_calls = dict(mesh.calls)
    p, lin, metrics, calls = _train(steps.make_train_step(model, HP), p0, b,
                                    mesh)
    return {"params": numpy_tree(sharding.gather_params(p, mesh)),
            "lin": numpy_tree(sharding.gather_params(lin, mesh)),
            "metrics": metrics, "calls": calls,
            "dropped": [float(d) for d in dropped],
            "prefill": mesh.all_gather(logits, "data", 0).numpy(),
            "prefill_calls": prefill_calls}


def _ffn_leaves(cfg) -> int:
    """The FFN's leaves split over ``data``: SwiGLU's 3, the GELU MLP's 2
    (its biases are replicated)."""
    return 3 if cfg.ffn == "swiglu" else 2


def _blocks(cfg, m: int) -> list:
    """Each kind of checkpointed layer of a family: (how many, leaves
    split over ``data``, entries into the model group (as many exits),
    other all-gathers over ``model`` whose backward reduce-scatters
    (k and v where m ∤ Hkv, the recurrent branch and ``w_ri``), the
    channel mix's reduce-scatters, its ``gather_from``s, exits rerun in
    the backward).  The rerun stops at a layer's last saved tensor: every
    exit is rerun but a layer's last where nothing after it is saved (the
    FFN's); a MoE block's combine is followed by its load-balance loss
    and the channel mix's reduce-scatter by its gate, so those rerun."""
    kv = 2 if cfg.num_heads and cfg.num_kv_heads % m else 0
    attn = (4 + _ffn_leaves(cfg), 2, kv, 0, 0, 1)
    fam = cfg.family
    if fam in ("dense", "vlm"):
        return [(cfg.num_layers, *attn)]
    if fam == "moe":
        moe = 4 + 1 + 3 + (3 if cfg.shared_expert else 0)
        if cfg.moe_every == 1:
            return [(cfg.num_layers, moe, 2, kv, 0, 0, 2)]
        return [(cfg.num_layers // cfg.moe_every, attn[0] + moe, 4, 2 * kv,
                 0, 0, 4)]
    if fam == "ssm":
        return [(cfg.num_layers, 9, 2, 0, 1, 1, 1)]
    if fam == "hybrid":
        unit = cfg.pattern_recurrent + cfg.pattern_attn
        rec = 4 + _ffn_leaves(cfg)
        units = [(cfg.num_layers // unit,
                  cfg.pattern_recurrent * rec + cfg.pattern_attn * attn[0],
                  2 * unit, 2 * cfg.pattern_recurrent + kv * cfg.pattern_attn,
                  0, 0, 2 * unit - 1)]
        return units + [(cfg.num_layers % unit, rec, 2, 2, 0, 0, 1)]
    enc = dataclasses.replace(cfg, ffn="gelu")
    return [(cfg.encoder_layers, 4 + _ffn_leaves(enc), 2, kv, 0, 0, 1),
            (cfg.num_layers, 8 + _ffn_leaves(cfg), 3, 2 * kv, 0, 0, 2)]


def family_calls(cfg, m: int, act_tp, *, train: bool) -> dict:
    """The collectives a train step (``train``) or a prefill step calls on
    each set of axes, each call counted once whatever its axes' size: the
    dense step's terms (``torch_production_mesh_cases.dense_calls``) from
    :func:`_blocks`' tallies, and the family's own.  Outside the layers:
    the embedding table's gather over ``data`` (the vlm's ``img_proj``'s
    too, whose output enters the stream by a ``gather_from`` with
    ``act_tp=None``), the lookup's exit, the final norm's entry (and
    whisper's encoder's), the cross-entropy's max and sums over
    ``model``.  A train step adds each layer's rerun (its data gathers,
    its entries and other gathers, the exits :func:`_blocks` names) and
    the backward (each gather's reduce-scatter, an entry's all-gather
    backward a reduce-scatter or all-reduce, an exit's an all-gather or
    nothing; not the first encoder entry's, whose frames need no
    gradient), and one all-reduce a set of axes of the leaves whole on
    it: (data, model) for the norms, mixes and biases, and the metrics;
    ``model`` for the router and ``decay_w1``; ``data`` for the leaves
    split only over ``model`` (``bonus``, ``ln_w``, ``ln_b``,
    ``decay_w2``, ``conv_w``).  The moe family's blocks add the
    load-balance statistics' all-reduce over ``data`` (forward, rerun,
    backward) and the kept count's over (data, model), forward only.
    A prefill step runs each layer once without autograd and gathers
    its last position's logits over ``model``."""
    blocks = [b for b in _blocks(cfg, m) if b[0]]
    lay_data = sum(n * d for n, d, *_ in blocks)
    top_data = 1 + (cfg.family == "vlm")
    ends = sum(n * e for n, _, e, *_ in blocks)
    gathers = sum(n * g for n, _, _, g, *_ in blocks)
    scatters = sum(n * c for n, *_, c, _, _ in blocks)
    streams = sum(n * f for n, *_, f, _ in blocks) \
        + (cfg.family == "vlm")
    entries = ends + 1 + (cfg.family == "audio")
    exits = ends + 1 - scatters
    moe = cfg.num_layers // cfg.moe_every if cfg.family == "moe" else 0
    if not train:
        calls = {"all_gather:data": lay_data + top_data,
                 "all_reduce:data": moe, "all_reduce:data+model": moe}
        if act_tp == "model":
            calls.update({"all_gather:model": entries + gathers + 1,
                          "reduce_scatter:model": exits + scatters})
        else:
            calls.update({"all_reduce:model": exits,
                          "all_gather:model": gathers + streams + 1,
                          "reduce_scatter:model": scatters})
        return {k: v for k, v in calls.items() if v}
    rerun_exits = sum(n * x for n, *_, x in blocks)
    rerun_entries = ends
    free = 1 if cfg.family == "audio" else 0
    model_whole = cfg.family == "moe" or cfg.family == "ssm"
    data_whole = cfg.family in ("ssm", "hybrid")
    calls = {"all_gather:data": 2 * lay_data + top_data,
             "reduce_scatter:data": lay_data + top_data,
             "all_reduce_max:model": 1,
             "all_reduce:data": 3 * moe + data_whole,
             "all_reduce:data+model": 2 + moe}
    if act_tp == "model":
        calls.update({
            "all_gather:model": entries + rerun_entries + exits + 2 * gathers
            + scatters,
            "reduce_scatter:model": exits + rerun_exits + entries - free
            + gathers + 2 * scatters,
            "all_reduce:model": 1 + model_whole})
    else:
        calls.update({
            "all_reduce:model": entries - free + exits + rerun_exits + 1
            + model_whole,
            "all_gather:model": 2 * gathers + scatters + streams,
            "reduce_scatter:model": gathers + 2 * scatters})
    return {k: v for k, v in calls.items() if v}


def saved_weights(mesh, arch) -> dict:
    """What autograd keeps for the backward of one sharded loss outside
    the layers' checkpoints, by an outer ``saved_tensors_hooks``: how many
    saved tensors share storage with a layer's gathered 2-D leaves
    (``MeshContext.layer``'s outputs), with the layers under
    ``sharded.remat`` and, to show that the record sees them, without."""
    cfg, params, batch = setup(arch)
    model = build_model(cfg, mesh=mesh,
                        layer_pspec_fn=sharding.layer_pspec_fn(mesh))
    p = sharding.shard_params(params, mesh)
    b = sharding.local_batch(batch, mesh)
    layer = sharded.MeshContext.layer
    out = {}
    for key, patch in (("remat", None), ("plain", lambda fn, *a: fn(*a))):
        saved, gathered = [], []

        def recorded(ctx, shards):
            leaves = layer(ctx, shards)
            gathered.extend(leaves.values())
            return leaves

        leaves = [x.detach().requires_grad_() for x in tree.leaves(p)]
        with mock.patch.object(sharded, "remat", patch or sharded.remat), \
                mock.patch.object(sharded.MeshContext, "layer", recorded), \
                torch.autograd.graph.saved_tensors_hooks(
                    lambda t: saved.append(t) or t, lambda t: t):
            loss = model.loss(tree.unflatten(p, leaves), b)
        torch.autograd.grad(loss, leaves, allow_unused=True)
        ptrs = {g.untyped_storage().data_ptr() for g in gathered
                if g.dim() >= 2}
        out[key] = sum(t.untyped_storage().data_ptr() in ptrs for t in saved)
    return out


def _error(fn) -> tuple:
    try:
        fn()
    except (ValueError, RuntimeError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return None, ""


def refusals(mesh) -> dict:
    """What a mesh still refuses: m ∤ ``rwkv_heads``, a ``"stationary"``
    train step, decode and ``init_decode``; and that every family builds there, and that ``input_specs``
    gives every family's batch."""
    pspec = sharding.layer_pspec_fn(mesh)
    out = {}
    cfg_r = dataclasses.replace(reduced(get_config("rwkv6-7b")),
                                rwkv_heads=3, d_model=192)
    out["rwkv_heads"] = _error(lambda: build_model(
        cfg_r, mesh=mesh, layer_pspec_fn=pspec))
    place = dict(moe_fsdp_dim="f")
    cfg_q = reduced(get_config(MOE[0]))
    out["stationary"] = _error(lambda: steps.make_train_step(build_model(
        cfg_q, mesh=mesh, moe_weight_mode="stationary",
        layer_pspec_fn=sharding.layer_pspec_fn(mesh, **place))))
    models = {arch: build_model(reduced(get_config(arch)), mesh=mesh,
                                layer_pspec_fn=pspec) for arch in ARCHS}
    out["builds"] = sorted(m.cfg.family for m in models.values())
    cfg, params, batch = setup("phi-3-vision-4.2b")
    model = models["phi-3-vision-4.2b"]
    p = sharding.shard_params(params, mesh)
    out["init_decode"] = _error(lambda: model.init_decode(2, 8,
                                                          device="cpu"))
    out["decode"] = _error(lambda: steps.make_decode_step(model)(
        p, None, {"tokens": batch["tokens"][:2, :1]}))
    shape = InputShape("train_small", SEQ + 8, 4, "train")
    out["specs"] = {arch: {k: tuple(v.shape) for k, v in input_specs(
        m.cfg, shape).items()} for arch, m in models.items()}
    return out


def gather_from_grad(mesh) -> bool:
    """``parallel.gather_from`` over ``model``: a loss Σ y·w that every
    rank of the group computes alike from the gathered y gives each rank
    its own block of w as the gradient of its block."""
    i, n = mesh.axis_index("model"), mesh.axis_size("model")
    x = torch.arange(6.0).reshape(2, 3) * (i + 1)
    x.requires_grad_(True)
    y = parallel.gather_from(x, mesh, "model", -1)
    w = torch.randn(y.shape, generator=torch.Generator().manual_seed(5))
    (y * w).sum().backward()
    return y.shape == (2, 3 * n) and torch.equal(x.grad, w[:, 3 * i:3 * i + 3])


def round_trips(mesh) -> dict:
    """Every family's parameters through ``shard_params`` /
    ``gather_params`` bit for bit (``tail``, ``encoder``,
    ``enc_final_norm``, ``img_proj``, the unit prefixes)."""
    out = {}
    for arch in ARCHS:
        params = setup(TAIL if arch == "recurrentgemma-9b" else arch)[1]
        back = sharding.gather_params(sharding.shard_params(params, mesh),
                                      mesh)
        out[arch] = (sorted(n for n, _ in tree.named_leaves(params)),
                     all(torch.equal(a, b) for (_, a), (_, b) in zip(
                         tree.named_leaves(params),
                         tree.named_leaves(back))))
    return out


def rank_main(layout) -> dict:
    """A rank's entry for one layout: the mesh; at (2, 2) the round trips,
    the refusals and the remat record; then every family's case (at
    (2, 2) also the recurrent tail's, and NO_ACT_TP's with
    ``act_tp=None``)."""
    mesh = make_mesh(layout, AXES, device="cpu")
    out = {"foreign": sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "jaxlib", "repro")),
           "coords": mesh.coords, "runs": {}}
    if layout == (2, 2):
        out["round_trips"] = round_trips(mesh)
        out["gather_from"] = gather_from_grad(mesh)
        out["refusals"] = refusals(mesh)
        out["saved"] = {arch: saved_weights(mesh, arch) for arch in ARCHS}
    for case in CASES if layout == (2, 2) else ARCHS:
        out["runs"][(case, "model")] = family_case(mesh, case)
    if layout == (2, 2):
        for case in NO_ACT_TP:
            out["runs"][(case, None)] = family_case(mesh, case, None)
    return out
