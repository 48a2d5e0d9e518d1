"""The production (data, model) mesh's cases, run by every rank of a local
gloo world (``tests/test_torch_production_mesh.py``) and, without a mesh,
by the test process as their reference.

The ranks are spawned processes that must load nothing of JAX or of the
reference package, so this module imports numpy, torch and
``repro_torch`` only.  The configurations are the reference's
``tests/distributed_check.py``: three Algorithm-1 train steps (τ = 1) of
the reduced dense model on a batch of (4, 32) tokens, and the
expert-parallel forward of the reduced moe model on (4, 16) tokens;
here on the (2, 2) and (1, 4) layouts, both ``act_tp``s, reduced
llama3-8b and reduced granite-34b (one kv head, so m ∤ Hkv), and both
``moe_weight_mode``s of reduced qwen3-moe and llama4-maverick.
"""
from __future__ import annotations

import dataclasses
import sys
from unittest import mock

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.core import ssca
from repro_torch import parallel, tree
from repro_torch.launch import sharding, steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model, moe, sharded
import torch_production_mesh_family_cases as family_cases

DENSE = ("llama3-8b", "granite-34b")
MOE = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b")
LAYOUTS = ((2, 2), (1, 4))
ACT_TPS = ("model", None)
MODES = ("fsdp", "stationary")
STEPS = 3
HP = ssca.SSCAHyperParams(tau=1.0)
AXES = ("data", "model")


def dense_setup(arch):
    """(config, full parameters, batch) of a dense case."""
    return family_cases.draw(reduced(get_config(arch)), 0, 7)


def moe_setup(arch):
    return family_cases.draw(reduced(get_config(arch)), 1, 9, (4, 16))


def numpy_tree(params) -> dict:
    return {name: leaf.detach().float().numpy()
            for name, leaf in tree.named_leaves(params)}


def unsharded_steps(arch):
    """The port's one-device steps: (loss, kkt) a step, the parameters and
    ``lin`` after the last, the parameters after the first; the prefill
    step's logits at the first weights."""
    cfg, p, batch = dense_setup(arch)
    step = steps.make_train_step(build_model(cfg), HP)
    st = ssca.init(p, with_beta=False)
    prefill = steps.make_prefill_step(build_model(cfg))(p, batch).numpy()
    metrics, first = [], None
    for _ in range(STEPS):
        p, st, m = step(p, st, batch)
        metrics.append((float(m["loss"]), float(m["kkt_residual"])))
        first = first or numpy_tree(p)
    return {"metrics": metrics, "params": numpy_tree(p),
            "lin": numpy_tree(st.lin), "params_1": first,
            "prefill": prefill}


def unsharded_forward(arch):
    """The port's ``moe_ffn`` forward: logits and each layer's dropped
    share."""
    cfg, p, batch = moe_setup(arch)
    dropped = []
    with torch.no_grad():
        logits = build_model(cfg).forward_with_aux(p, batch, dropped)[0]
    return logits.numpy(), [float(d) for d in dropped]


def moe_forward_calls(cfg, act_tp, mode: str) -> dict:
    """The collectives of one expert-parallel forward (logits kept
    vocab-split): a MoE block all-gathers its 4 attention projections and
    its router over ``data``, and the experts' 3 leaves (``"fsdp"``) or
    its rows of the batch (``"stationary"``), and the shared expert's 3
    leaves where there is one; an interleaved unit's dense block its 7;
    the embedding table once.  Each block enters the model group twice
    and leaves it twice, the final norm enters and the lookup leaves once:
    as the dense step's forward, except the MoE combine, which in
    ``"stationary"`` is one all-reduce over (data, model); the kept count
    is one all-reduce over (data, model) (``"fsdp"``) or ``model``; the
    load-balance loss's statistics one over ``data`` (``"fsdp"``: the
    global batch's; ``"stationary"`` routes the whole batch already)."""
    units = cfg.num_layers // cfg.moe_every
    dense = units if cfg.moe_every != 1 else 0
    moe_data = 5 + (3 if cfg.shared_expert else 0) \
        + (3 if mode == "fsdp" else 1)
    ends = 2 * (dense + units) + 1
    exits = ends - (units if mode == "stationary" else 0)
    calls = {"all_gather:data": units * moe_data + dense * 7 + 1,
             "all_reduce:data+model": units}
    if mode == "fsdp":
        calls["all_reduce:data"] = units
    if act_tp == "model":
        calls.update({"all_gather:model": ends,
                      "reduce_scatter:model": exits})
    else:
        calls["all_reduce:model"] = exits
    if mode == "stationary":
        calls["all_reduce:model"] = calls.get("all_reduce:model", 0) + units
    return calls


def dense_case(mesh, arch, act_tp, fsdp_params=True,
               microbatches=False) -> dict:
    """The sharded prefill step at the first weights (its logits' rows
    gathered over ``data``, its collectives), then the train steps."""
    cfg, params, batch = dense_setup(arch)
    place = dict(fsdp_params=fsdp_params)
    model = build_model(cfg, mesh=mesh, act_tp=act_tp,
                        layer_pspec_fn=sharding.layer_pspec_fn(mesh, **place))
    p = sharding.shard_params(params, mesh, **place)
    b = sharding.local_batch(batch, mesh)
    mesh.reset_counts()
    logits = steps.make_prefill_step(model)(p, b)
    prefill_calls = dict(mesh.calls)
    st = ssca.init(p, with_beta=False)
    step = steps.make_train_step(model, HP)
    metrics, calls = [], []
    for _ in range(STEPS):
        mesh.reset_counts()
        p, st, m = step(p, st, b)
        calls.append(dict(mesh.calls))
        metrics.append((float(m["loss"]), float(m["kkt_residual"])))
    out = {"metrics": metrics, "calls": calls,
           "params": numpy_tree(sharding.gather_params(p, mesh, **place)),
           "lin": numpy_tree(sharding.gather_params(st.lin, mesh, **place)),
           "prefill": mesh.all_gather(logits, "data", 0).numpy(),
           "prefill_calls": prefill_calls}
    if microbatches:
        # two microbatches of the local batch: the same first step
        mb = steps.make_train_step(model, HP, microbatches=2)
        p0 = sharding.shard_params(params, mesh, **place)
        p2, _, m2 = mb(p0, ssca.init(p0, with_beta=False), b)
        out["microbatched"] = (float(m2["loss"]), numpy_tree(
            sharding.gather_params(p2, mesh, **place)))
    return out


def moe_case(mesh, arch, act_tp, mode) -> dict:
    """The ``"fsdp"`` forward returns its logits gathered over ``model``
    (``shard_logits=False``), the ``"stationary"`` one its vocab block."""
    cfg, params, batch = moe_setup(arch)
    gathered = mode == "fsdp"
    place = dict(moe_fsdp_dim="f" if mode == "stationary" else "d")
    model = build_model(cfg, mesh=mesh, act_tp=act_tp, moe_weight_mode=mode,
                        shard_logits=not gathered,
                        layer_pspec_fn=sharding.layer_pspec_fn(mesh, **place))
    p = sharding.shard_params(params, mesh, **place)
    dropped = []
    mesh.reset_counts()
    with torch.no_grad():
        logits = model.forward_with_aux(p, sharding.local_batch(batch, mesh),
                                        dropped)[0]
    calls = dict(mesh.calls)
    if gathered:
        calls["all_gather:model"] -= 1
    else:
        logits = mesh.all_gather(logits, "model", -1)
    full = mesh.all_gather(logits, "data", 0)
    return {"logits": full.numpy(), "dropped": [float(d) for d in dropped],
            "calls": calls}


def collective_grads(mesh) -> dict:
    """Each collective of ``repro_torch.parallel`` over ``model`` and over the
    whole mesh: its gradient of Σ y·w (w this rank's own weights) equal to
    the adjoint collective of w, computed apart: the all-gather's the sum
    of w's blocks, the reduce-scatter's w gathered, the all-reduce's and
    ``copy_to``'s the sum of w, ``reduce_from``'s w."""
    out = {}
    for axes in ("model", AXES):
        n, i = mesh.axis_size(axes), mesh.axis_index(axes)
        rank = dist.get_rank()
        for name in ("all_gather", "reduce_scatter", "all_reduce", "copy_to",
                     "reduce_from"):
            x = torch.arange(8.0 * n).reshape(2 * n, 4) * (rank + 1)
            x.requires_grad_(True)
            y = getattr(parallel, name)(x, mesh, axes)
            w = torch.randn(y.shape, generator=torch.Generator().manual_seed(
                rank))
            (y * w).sum().backward()
            if name == "all_gather":
                want = mesh.all_reduce(w, axes).narrow(0, i * x.shape[0],
                                                       x.shape[0])
            elif name == "reduce_scatter":
                want = mesh.all_gather(w, axes, 0)
            elif name == "reduce_from":
                want = w
            else:
                want = mesh.all_reduce(w, axes)
            out[(name, "+".join(mesh.axes(axes)))] = bool(
                torch.equal(x.grad, want))
    return out


def saved_weights(mesh) -> dict:
    """What autograd keeps for the backward of one sharded loss of reduced
    llama3-8b outside the layers' checkpoints, by an outer
    ``saved_tensors_hooks``: how many of the saved tensors share storage
    with a layer's gathered leaves (``MeshContext.layer``'s outputs), and
    the bytes saved, with the layers under ``sharded.remat`` and, to show
    that the record sees them, without."""
    cfg, params, batch = dense_setup(DENSE[0])
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
                if g.dim() == 2}
        out[key] = {"gathered_saved": sum(
            t.untyped_storage().data_ptr() in ptrs for t in saved),
            "saved_bytes": sum(t.numel() * t.element_size() for t in saved)}
    return out


def _error(fn) -> tuple:
    try:
        fn()
    except (ValueError, RuntimeError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return None, ""


def refusals(mesh) -> dict:
    """What a mesh refuses: a grid that is not the world's size, nccl on
    a CPU device, m ∤ E, m ∤ ``rwkv_heads``, a ``"stationary"`` train
    step, a decode step from a state that is not the rank's blocks, a
    model without its placement; that the moe family runs
    expert-parallel there, and the shape and placement of the KV cache
    block ``init_decode`` gives the rank."""
    pspec = sharding.layer_pspec_fn(mesh)
    out = {"world": _error(lambda: make_mesh((2, 4), AXES, device="cpu"))}
    with mock.patch.object(dist, "get_backend", return_value="nccl"):
        out["nccl_cpu"] = _error(lambda: make_mesh((2, 2), AXES,
                                                   device="cpu"))
    cfg_m = dataclasses.replace(reduced(get_config(MOE[0])), num_experts=3)
    out["experts_model"] = _error(lambda: build_model(
        cfg_m, mesh=mesh, layer_pspec_fn=pspec))
    x = torch.zeros((1, 4, cfg_m.d_model))
    params = {"router": torch.zeros((cfg_m.d_model, 3)),
              **{k: torch.zeros((1, 1, 1)) for k in ("wg", "wu", "wd")}}
    out["experts_fn"] = _error(lambda: moe.moe_ffn_sharded(
        x, params, num_experts=3, k=2, mesh=mesh))
    cfg_r = dataclasses.replace(reduced(get_config("rwkv6-7b")),
                                rwkv_heads=3, d_model=192)
    out["rwkv_heads"] = _error(lambda: build_model(cfg_r, mesh=mesh,
                                                   layer_pspec_fn=pspec))
    cfg_q = reduced(get_config(MOE[0]))
    out["placement"] = _error(lambda: build_model(cfg_q, mesh=mesh))
    out["expert_parallel"] = build_model(cfg_q, mesh=mesh,
                                         layer_pspec_fn=pspec).expert_parallel
    out["stationary_train"] = _error(lambda: steps.make_train_step(
        build_model(cfg_q, mesh=mesh, moe_weight_mode="stationary",
                    layer_pspec_fn=sharding.layer_pspec_fn(
                        mesh, moe_fsdp_dim="f"))))
    cfg, params, _ = dense_setup(DENSE[0])
    state = build_model(cfg, mesh=mesh, layer_pspec_fn=pspec).init_decode(
        2, 8, device="cpu")
    out["decode"] = (tuple(state.kv_k.shape), state.placement.kv_k)
    out["decode_step"] = _error(lambda: build_model(
        cfg, mesh=mesh, layer_pspec_fn=pspec).decode_step(
            params, None, torch.zeros((2, 1), dtype=torch.int32)))
    out["dp_axes"] = _error(lambda: build_model(
        cfg, mesh=mesh, layer_pspec_fn=pspec, dp_axes=("model",)))
    return out


def rank_main() -> dict:
    """A rank's entry: a mesh of each layout (made by every rank in the
    same order), the round trip of the parameters through
    ``shard_params`` / ``gather_params``, the refusals, then every dense
    and moe case."""
    meshes = {lay: make_mesh(lay, AXES, device="cpu") for lay in LAYOUTS}
    out = {"foreign": sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "jaxlib", "repro")),
           "coords": {lay: mesh.coords for lay, mesh in meshes.items()},
           "runs": {}}
    _, params, _ = dense_setup(DENSE[1])
    mesh = meshes[(2, 2)]
    back = sharding.gather_params(sharding.shard_params(params, mesh), mesh)
    out["round_trip"] = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        tree.named_leaves(params), tree.named_leaves(back)))
    out["refusals"] = refusals(mesh)
    out["collective_grads"] = collective_grads(mesh)
    out["saved"] = saved_weights(mesh)
    out["runs"]["fsdp_off"] = dense_case(mesh, DENSE[0], "model",
                                         fsdp_params=False)
    for lay, mesh in meshes.items():
        for arch in DENSE:
            for act in ACT_TPS:
                out["runs"][(arch, lay, act)] = dense_case(
                    mesh, arch, act, microbatches=act is None)
        for arch in MOE:
            for mode in MODES:
                out["runs"][(arch, lay, mode)] = moe_case(mesh, arch,
                                                          "model", mode)
    return out
