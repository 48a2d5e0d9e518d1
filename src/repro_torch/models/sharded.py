"""The decoder's blocks under a production mesh: explicit Megatron-style
tensor parallelism over ``model`` and FSDP over ``data``.

The reference runs its sharded train step by pinning placements and
letting XLA insert the collectives; the port writes them out, on one
rank's blocks of the parameters (:func:`repro_torch.launch.sharding.
shard_params`) and its rows of the batch:

* each layer's leaves split over ``data`` are all-gathered over it inside
  the layer loop, one layer at a time (the reference's ``_cast`` re-pin),
  and each layer runs under :func:`remat`: the backward keeps only the
  layer's input and its shards and runs the layer again, gathers
  included (the reference's ``nothing_saveable`` checkpoint), so no
  layer's gathered weights outlive its forward or its backward;
* ``wq/wk/wv/wg/wu/wi`` (``[d, m]``) are column-parallel, ``wo/wd/wo2``
  (``[m, d]``) row-parallel: a block's input enters the model group
  (:meth:`MeshContext.enter`) and its rank-partial output leaves it
  summed (:meth:`MeshContext.leave`);
* with ``act_tp="model"`` the residual stream between layers is each
  rank's (B_loc, S, D/m) block: ``leave`` reduce-scatters, ``enter``
  all-gathers; with ``act_tp=None`` it stays whole: ``leave`` is
  Megatron's ``g``, ``enter`` its ``f``;
* ``embed`` (``P(model, data)``) is a vocab-parallel lookup, the tied
  unembedding gives each rank its (B_loc, S, V/m) logits block, and the
  cross-entropy all-reduces its max and its sums over ``model``
  (forward only: its backward is local);
* attention runs the flash op at the rank's H/m heads.  Where m divides
  Hkv the rank's k and v columns are its kv heads; elsewhere (granite-34b
  has one) k and v are all-gathered over ``model`` after the projection
  and the rank reads the kv head (r·H/m + j) // G of each local head j.

Gradients: the loss of a rank is its tokens' sum over the global token
count, the same on every rank of its model group.  Each leaf split over
an axis gets its gradient summed there by the collectives' backwards;
every leaf gets partial gradients on the axes it is whole on (the
norms' and the biases' through ``enter``'s partial backward; ``b_o`` is
added on model rank 0 only), so the train step sums each leaf's gradient
over the axes its placement leaves whole (:func:`reduce_replicated`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch import parallel
from repro_torch.models import attention, layers, moe
from repro_torch.tree import named_leaves, rebuild

TP = "model"
EXPERTS = ("ewg", "ewu", "ewd")


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """What the blocks read of the model's mesh: the mesh, the batch's
    data axes ``dp``, ``act_tp`` and the per-layer placement ``pspec``
    (``sharding.layer_pspec_fn``), with the activation dtype ``adtype``."""
    mesh: Any
    dp: tuple
    act_tp: Optional[str]
    pspec: Callable
    adtype: torch.dtype

    @property
    def m(self) -> int:
        return self.mesh.axis_size(TP)

    @property
    def r(self) -> int:
        return self.mesh.axis_index(TP)

    def enter(self, x):
        """The residual stream into rank-partial work, whole over
        ``model``."""
        if self.act_tp is None:
            return parallel.copy_to(x, self.mesh, TP)
        return parallel.all_gather(x, self.mesh, TP, -1)

    def leave(self, part):
        """Rank-partial sums out into the residual stream."""
        if self.act_tp is None:
            return parallel.reduce_from(part, self.mesh, TP)
        return parallel.reduce_scatter(part, self.mesh, TP, -1)

    def gathered(self, name: str, w):
        """A leaf's dims split over ``data`` all-gathered over it (expert
        weights excepted: ``moe_ffn_sharded`` places them)."""
        if not name.endswith(EXPERTS):
            for dim, entry in enumerate(self.pspec(name, tuple(w.shape))):
                axes = (entry,) if isinstance(entry, str) else entry or ()
                if "data" in axes:
                    w = parallel.all_gather(w, self.mesh, "data", dim)
        return w

    def layer(self, shards):
        """One layer's leaves (this rank's shards), gathered and cast to
        the activation dtype."""
        return {k: self.gathered(k, w).to(self.adtype)
                for k, w in shards.items()}


def layer_shards(stack):
    """Each layer's shards of a stack's leaves, one dict a layer."""
    ws = {k: w.unbind(0) for k, w in stack.items()}
    return [dict(zip(ws, layer)) for layer in zip(*ws.values())]


def remat(fn, *args):
    """``fn(*args)``, keeping for the backward only its inputs: the
    backward runs ``fn`` again (collectives and kernels included), as the
    reference's ``jax.checkpoint(policy=nothing_saveable)`` does.  Under
    ``no_grad`` a plain call."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False)


def embed(ctx: MeshContext, tokens, table):
    """Vocab-parallel lookup in this rank's rows of the table (V/m, D):
    zero for a token outside them, summed over ``model``."""
    vl = table.shape[0]
    local = tokens.long() - ctx.r * vl
    inside = (local >= 0) & (local < vl)
    rows = F.embedding(torch.where(inside, local, 0), table)
    return ctx.leave(torch.where(inside[..., None], rows, 0.0))


class _VocabParallelCE(torch.autograd.Function):
    """Per-token cross-entropy of vocab-parallel logits (…, V/m) f32: the
    max by an all-reduce, then the sum of exp and the label's logit by
    one all-reduce over ``model``; lse = log(Σ exp(l − max)) + max, as
    ``torch.logsumexp`` forms it.  The backward needs no collective (the
    loss is the same on every rank of the model group): this rank's
    logits get g · exp(l − lse), less g at the label, as the backwards of
    ``logsumexp`` and the label's gather give them, so one rank's run is
    the unsharded cross-entropy's bit for bit."""

    @staticmethod
    def forward(logits, labels, mesh):
        vl = logits.shape[-1]
        mx = mesh.all_reduce(logits.amax(-1), TP, "max")
        local = labels.long() - mesh.axis_index(TP) * vl
        inside = (local >= 0) & (local < vl)
        local = torch.where(inside, local, 0)
        picked = torch.gather(logits, -1, local[..., None])[..., 0]
        sums = mesh.all_reduce(torch.stack(
            [torch.exp(logits - mx[..., None]).sum(-1),
             torch.where(inside, picked, 0.0)]), TP)
        lse = torch.log(sums[0]) + mx
        return lse - sums[1], lse, local, inside

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, lse, local, inside = output
        ctx.save_for_backward(inputs[0], lse, local, inside)
        ctx.mark_non_differentiable(lse, local, inside)

    @staticmethod
    def backward(ctx, g, *_):
        logits, lse, local, inside = ctx.saved_tensors
        grad = g[..., None] * torch.exp(logits - lse[..., None])
        grad.scatter_add_(-1, local[..., None],
                          torch.where(inside, -g, 0.0)[..., None])
        return grad, None, None


def cross_entropy_sum(ctx: MeshContext, logits, labels):
    """Σ over tokens of the cross-entropy of this rank's vocab block of
    the logits (…, V/m) f32."""
    return _VocabParallelCE.apply(logits, labels, ctx.mesh)[0].sum()


def _kv_heads(ctx: MeshContext, cfg, k, v):
    """Full k, v (B, S, Hkv, hd) → the kv heads this rank's H/m query
    heads read, grouped as the flash op reads them."""
    hl = cfg.num_heads // ctx.m
    g = cfg.num_heads // cfg.num_kv_heads
    want = [(ctx.r * hl + j) // g for j in range(hl)]
    lo, n = want[0], want[-1] - want[0] + 1
    if hl % n == 0 and want == [lo + j // (hl // n) for j in range(hl)]:
        return k.narrow(2, lo, n), v.narrow(2, lo, n)
    idx = torch.tensor(want, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def attn_apply(ctx: MeshContext, cfg, p, x, positions):
    """Self-attention on this rank's heads, with its residual."""
    hd, m = cfg.head_dim, ctx.m
    xn = layers.rms_norm(ctx.enter(x), p["attn_norm"])
    b, s, _ = xn.shape
    hl = cfg.num_heads // m
    q = (xn @ p["wq"]).reshape(b, s, hl, hd)
    k, v = xn @ p["wk"], xn @ p["wv"]
    if cfg.num_kv_heads % m:
        k, v = (parallel.all_gather(t, ctx.mesh, TP, -1).reshape(
            b, s, cfg.num_kv_heads, hd) for t in (k, v))
        k, v = _kv_heads(ctx, cfg, k, v)
    else:
        k = k.reshape(b, s, cfg.num_kv_heads // m, hd)
        v = v.reshape(b, s, cfg.num_kv_heads // m, hd)
    q = layers.apply_rope(q, positions)
    k = layers.apply_rope(k, positions)
    o = attention.attend(q, k, v)
    return x + ctx.leave(o.reshape(b, s, hl * hd) @ p["wo"])


def ffn(ctx: MeshContext, cfg, p, x):
    """The dense FFN on this rank's d_ff columns, summed out."""
    xn = layers.rms_norm(ctx.enter(x), p["ffn_norm"])
    if cfg.ffn == "swiglu":
        return ctx.leave(layers.swiglu(xn, p["wg"], p["wu"], p["wd"]))
    fl = p["wi"].shape[-1]
    b_i = p["b_i"].narrow(0, ctx.r * fl, fl)
    part = F.gelu(xn @ p["wi"] + b_i, approximate="tanh") @ p["wo2"]
    if ctx.r == 0:
        part = part + p["b_o"]
    return ctx.leave(part)


def attn_block(ctx: MeshContext, cfg, p, x, positions):
    x = attn_apply(ctx, cfg, p, x, positions)
    return x + ffn(ctx, cfg, p, x)


def moe_block(ctx: MeshContext, cfg, p, x, positions, weight_mode: str):
    """Attention, then the expert-parallel MoE FFN → (x, its
    ``MoEOutput``)."""
    x = attn_apply(ctx, cfg, p, x, positions)
    xn = layers.rms_norm(ctx.enter(x), p["ffn_norm"])
    mp = {"router": p["router"], "wg": p["ewg"], "wu": p["ewu"],
          "wd": p["ewd"]}
    if cfg.shared_expert:
        mp.update({"shared_wg": p["swg"], "shared_wu": p["swu"],
                   "shared_wd": p["swd"]})
    out = moe.moe_ffn_sharded(
        xn, mp, num_experts=cfg.num_experts, k=cfg.experts_per_token,
        capacity_factor=cfg.capacity_factor, mesh=ctx.mesh,
        weight_mode=weight_mode, out_tp=ctx.act_tp)
    return x + out.y, out


def leaf_specs(params, pspec):
    """Each leaf's placement by the model's ``layer_pspec_fn`` (which
    gives a stacked leaf's spec from its stacked shape)."""
    return {k: leaf_specs(v, pspec) if isinstance(v, dict)
            else pspec(k, tuple(v.shape)) for k, v in params.items()}


def _whole_axes(mesh, spec) -> tuple:
    """The mesh axes a placement leaves a leaf whole on, in mesh order."""
    split = {a for e in spec if e is not None
             for a in ((e,) if isinstance(e, str) else e)}
    return tuple(a for a in mesh.axis_names if a not in split)


def reduce_replicated(grads, mesh, specs):
    """Each leaf's gradient summed over the mesh axes its spec leaves it
    whole on: one all-reduce per set of axes and dtype, of the flat
    concatenation of its leaves."""
    named = dict(named_leaves(grads))
    spec = dict(named_leaves(specs))
    by_axes: dict = {}
    for name, g in named.items():
        axes = _whole_axes(mesh, spec[name])
        if axes:
            by_axes.setdefault((axes, g.dtype), []).append(name)
    for (axes, _), names in by_axes.items():
        flat = mesh.all_reduce(torch.cat([named[n].reshape(-1)
                                          for n in names]), axes)
        off = 0
        for n in names:
            size = named[n].numel()
            named[n] = flat[off:off + size].reshape(named[n].shape)
            off += size
    return rebuild(grads, named)


def owned_sq_sum(grads, mesh, specs):
    """Σ g² over the leaves whose block this rank owns: on each axis its
    spec leaves a leaf whole, only the rank at index 0 counts it, so the
    sum over the mesh counts every element once."""
    spec = dict(named_leaves(specs))
    total = torch.zeros((), dtype=torch.float32, device=mesh.device)
    for name, g in named_leaves(grads):
        whole = _whole_axes(mesh, spec[name])
        if all(mesh.coords[mesh.axis_names.index(a)] == 0 for a in whole):
            total = total + torch.sum(torch.square(g.float()))
    return total
