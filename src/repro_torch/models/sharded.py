"""The blocks of every model family under a production mesh: explicit
Megatron-style tensor parallelism over ``model`` and FSDP over ``data``.

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
  and recurrentgemma have one) k and v are all-gathered over ``model``
  after the projection and the rank reads the kv head (r·H/m + j) // G
  of each local head j.  Whisper's encoder runs the same block
  non-causal without RoPE, its decoder adds the cross-attention (``xwq``
  column-parallel, ``xwk``/``xwv`` over the encoder's output of the
  rank's own rows, ``xwo`` row-parallel);
* RWKV-6 (:func:`rwkv_block`): ``wr/wk/wv/wg`` and ``decay_w2`` give the
  rank its D/m channels, ``bonus``, ``ln_w``, ``ln_b`` its H/m heads, so
  the WKV op runs on them; ``decay_base`` (replicated) is sliced to the
  channels, the token shift acts on the whole entered stream, and ``wo``
  is row-parallel.  The channel mix's gate ``cr`` is column-parallel
  while ``k @ cv`` is a model-partial sum over all of D: the sum is
  reduce-scattered to the rank's channels and gated there;
* Griffin's recurrent block (:func:`recurrent_block`): ``wx``, ``wgate``
  and the per-channel ``conv_w`` give the rank D/m channels and the
  RG-LRU runs on them (``lam`` sliced); ``w_ri``'s placement splits its
  2D columns, r's and i's side by side, into m blocks that are not the
  rank's channels, and the product reads the whole branch: the branch is
  all-gathered over ``model``, ``w_ri`` too, and the rank takes r's and
  i's columns of its channels;
* the vlm's ``img_proj`` (``(d@data, model)``) is a column-parallel
  product whose (B, N_img, D/m) output is the rank's block of the image
  tokens' stream;
* decode runs one token against the rank's blocks of the decode state
  (``placement.decode_state_shardings``): :func:`attn_decode`
  gathers q, k and v over ``model``, writes the token's k and v only
  into the slot its rank holds, scores every head against the rank's
  C/m slots and combines the ranks by a split-K log-sum-exp in f32
  (:func:`_split_attend`), or, where m does not divide C and every rank
  holds the whole cache, attends with the rank's heads;
  :func:`cross_decode` does the same over whisper's cached encoder K and
  V; :func:`rwkv_block` and :func:`recurrent_block` take a state of the
  rank's heads or channels and overwrite it.

Gradients: the loss of a rank is its tokens' mean over the count of data
ranks (moe's load-balance term the global batch's, its gradient carried
once over ``model``), the same on every rank of its model group.  Each
leaf split over an axis gets its gradient summed there by the
collectives' backwards;
every leaf gets partial gradients on the axes it is whole on (the
norms' and the biases' through ``enter``'s partial backward; ``b_o`` is
added on model rank 0 only), so the train step sums each leaf's gradient
over the axes its placement leaves whole (:func:`reduce_replicated`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch import parallel
from repro_torch.kernels import ops
from repro_torch.models import attention, layers, moe, rglru, rwkv6
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

    def block(self, x):
        """This rank's D/m channels of the last dim of ``x``, whole over
        ``model`` (a replicated leaf such as ``lam``, whose gradient the
        step sums over ``model``; or an input without a gradient)."""
        dl = x.shape[-1] // self.m
        return x.narrow(-1, self.r * dl, dl)

    def stream(self, y):
        """The residual stream from this rank's D/m channels ``y`` of it:
        ``y`` itself with ``act_tp="model"``, all of them gathered (each
        rank's gradient its own block) with None."""
        if self.act_tp is None:
            return parallel.gather_from(y, self.mesh, TP, -1)
        return y

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


def cross_entropy_mean(ctx: MeshContext, logits, labels):
    """The mean over tokens of the cross-entropy of this rank's vocab block
    of the logits (…, V/m) f32 (``torch.mean``, as the one-device loss
    takes it)."""
    return _VocabParallelCE.apply(logits, labels, ctx.mesh)[0].mean()


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


def _kv(ctx: MeshContext, cfg, k, v):
    """This rank's columns of the k and v projections (B, Sk, ·) → the
    (B, Sk, ·, hd) kv heads its query heads read: its own where m
    divides Hkv, else gathered over ``model`` first."""
    b, sk, _ = k.shape
    hd, m = cfg.head_dim, ctx.m
    if cfg.num_kv_heads % m:
        k, v = (parallel.all_gather(t, ctx.mesh, TP, -1).reshape(
            b, sk, cfg.num_kv_heads, hd) for t in (k, v))
        return _kv_heads(ctx, cfg, k, v)
    return (k.reshape(b, sk, cfg.num_kv_heads // m, hd),
            v.reshape(b, sk, cfg.num_kv_heads // m, hd))


def attn_apply(ctx: MeshContext, cfg, p, x, positions, *, window: int = 0,
               causal: bool = True):
    """Self-attention on this rank's heads, with its residual; RoPE at
    ``positions`` (None: none, as whisper's encoder)."""
    hd, m = cfg.head_dim, ctx.m
    xn = layers.rms_norm(ctx.enter(x), p["attn_norm"])
    b, s, _ = xn.shape
    hl = cfg.num_heads // m
    q = (xn @ p["wq"]).reshape(b, s, hl, hd)
    k, v = _kv(ctx, cfg, xn @ p["wk"], xn @ p["wv"])
    if positions is not None:
        q = layers.apply_rope(q, positions)
        k = layers.apply_rope(k, positions)
    o = attention.attend(q, k, v, causal=causal, window=window)
    return x + ctx.leave(o.reshape(b, s, hl * hd) @ p["wo"])


def cross_attn(ctx: MeshContext, cfg, p, x, enc):
    """Whisper's cross-attention on this rank's heads against ``enc``, the
    encoder's output of its rows (whole over ``model``), with the
    residual."""
    hd = cfg.head_dim
    xn = layers.rms_norm(ctx.enter(x), p["xattn_norm"])
    b, s, _ = xn.shape
    hl = cfg.num_heads // ctx.m
    q = (xn @ p["xwq"]).reshape(b, s, hl, hd)
    k, v = _kv(ctx, cfg, enc @ p["xwk"], enc @ p["xwv"])
    o = attention.attend(q, k, v, causal=False)
    return x + ctx.leave(o.reshape(b, s, hl * hd) @ p["xwo"])


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


def attn_block(ctx: MeshContext, cfg, p, x, positions, *, window: int = 0,
               causal: bool = True):
    x = attn_apply(ctx, cfg, p, x, positions, window=window, causal=causal)
    return x + ffn(ctx, cfg, p, x)


def audio_block(ctx: MeshContext, cfg, p, x, positions, enc):
    """Whisper's decoder block: causal self-attention with RoPE, the
    cross-attention to ``enc``, the FFN."""
    x = attn_apply(ctx, cfg, p, x, positions)
    x = cross_attn(ctx, cfg, p, x, enc)
    return x + ffn(ctx, cfg, p, x)


def _time_mix(ctx: MeshContext, p, xn, state=None):
    """RWKV-6's time mix on this rank's heads → (its rank-partial f32
    output sum (B, S, D), the next WKV state or None).  ``state=None``:
    ``rwkv6.time_mix``'s sequence path from a zero state (the WKV op);
    else decode's (WKV state (B, H/m, dh, dh) f32 of the rank's heads,
    the token shift (B, D) whole): one token through ``wkv_step``."""
    b, s, _ = xn.shape
    hl, dh = p["bonus"].shape
    shift = torch.zeros(b, xn.shape[2], dtype=xn.dtype, device=xn.device) \
        if state is None else state[1]
    xr, xk, xv, xw, xg = (rwkv6._token_shift(xn, p[f"mix_{c}"], shift)
                          for c in "rkvwg")
    r = (xr @ p["wr"]).reshape(b, s, hl, dh)
    k = (xk @ p["wk"]).reshape(b, s, hl, dh)
    v = (xv @ p["wv"]).reshape(b, s, hl, dh)
    g = F.silu(xg @ p["wg"])
    dec = ctx.block(p["decay_base"]) + torch.tanh(
        xw.float() @ p["decay_w1"].float()) @ p["decay_w2"].float()
    w = torch.exp(torch.clamp(-torch.exp(dec.float()), rwkv6.LOG_DECAY_FLOOR,
                              0.0)).reshape(b, s, hl, dh)
    if state is None:
        o, wkv = ops.rwkv6_wkv(r, k, v, w, p["bonus"]), None
    else:
        o, wkv = rwkv6.wkv_step(r[:, 0], k[:, 0], v[:, 0], w[:, 0],
                                p["bonus"], state[0])
        o = o[:, None]
    o = rwkv6._group_norm(o, p["ln_w"], p["ln_b"])
    return (o.reshape(b, s, hl * dh) * g).float() @ p["wo"].float(), wkv


def _channel_mix(ctx: MeshContext, p, xn, shift=None):
    """RWKV's channel mix: ``sigmoid(xr @ cr)`` on this rank's D/m
    channels times ``k @ cv``'s sum reduce-scattered to them; the token
    shift from ``shift`` (B, D) (zero when None)."""
    if shift is None:
        shift = torch.zeros(xn.shape[0], xn.shape[2], dtype=xn.dtype,
                            device=xn.device)
    xk = rwkv6._token_shift(xn, p["cmix_k"], shift)
    xr = rwkv6._token_shift(xn, p["cmix_r"], shift)
    k = torch.square(F.relu(xk @ p["ck"]))
    part = parallel.reduce_scatter(k @ p["cv"], ctx.mesh, TP, -1)
    return ctx.stream(torch.sigmoid(xr @ p["cr"]) * part)


def rwkv_block(ctx: MeshContext, p, x, state=None):
    """RWKV-6's time mix then channel mix, each on the RMS-normed entered
    stream.  ``state``: decode's (WKV state (B, H/m, dh, dh) f32, shifts
    (2, B, D/m): the rank's channels of the time mix's and the channel
    mix's last normed inputs) for one token x, overwritten in place; the
    shifts are gathered over ``model`` once, where the projections read
    all of D."""
    shifts = None if state is None \
        else ctx.mesh.all_gather(state[1], TP, -1)
    xn = layers.rms_norm(ctx.enter(x), p["tm_norm"])
    y, wkv = _time_mix(ctx, p, xn, None if state is None
                       else (state[0], shifts[0]))
    x = x + ctx.leave(y).to(x.dtype)
    xn2 = layers.rms_norm(ctx.enter(x), p["cm_norm"])
    x = x + _channel_mix(ctx, p, xn2, None if state is None else shifts[1])
    if state is not None:
        state[0].copy_(wkv)
        state[1][0].copy_(ctx.block(xn[:, -1]))
        state[1][1].copy_(ctx.block(xn2[:, -1]))
    return x


def _ri_columns(ctx: MeshContext, w_ri):
    """This rank's block (D, 2D/m) of ``w_ri`` → (D, 2D/m): r's columns
    of its D/m channels, then i's, from the leaf gathered over
    ``model``."""
    w = parallel.all_gather(w_ri, ctx.mesh, TP, -1)
    d = w.shape[-1] // 2
    dl = d // ctx.m
    return torch.cat([w.narrow(-1, ctx.r * dl, dl),
                      w.narrow(-1, d + ctx.r * dl, dl)], dim=-1)


def recurrent_block(ctx: MeshContext, cfg, p, x, state=None):
    """Griffin's recurrent block on this rank's D/m channels: the branch
    through the conv and the RG-LRU, gated, projected row-parallel; then
    the FFN.  ``state``: decode's (RG-LRU state (B, D/m) f32, conv
    context (B, T − 1, D/m)) of the rank's channels for one token x,
    overwritten in place."""
    xn = layers.rms_norm(ctx.enter(x), p["rec_norm"])
    branch = xn @ p["wx"]
    gate = F.gelu(xn @ p["wgate"], approximate="tanh")
    branch, conv = rglru.temporal_conv(branch, p["conv_w"],
                                       None if state is None else state[1])
    whole = parallel.all_gather(branch, ctx.mesh, TP, -1)
    r, i = torch.sigmoid(whole @ _ri_columns(ctx, p["w_ri"])).chunk(2, -1)
    lam = ctx.block(p["lam"])
    if state is None:
        y = rglru.rg_lru(branch, r, i, lam)[0]
    else:
        y, h = rglru.rg_lru_step(branch[:, 0], r[:, 0], i[:, 0], lam,
                                 state[0])
        y = y[:, None]
        state[0].copy_(h)
        state[1].copy_(conv)
    x = x + ctx.leave((y * gate) @ p["w_out"])
    return x + ffn(ctx, cfg, p, x)


def moe_block(ctx: MeshContext, cfg, p, x, positions, weight_mode: str):
    """Attention, then the expert-parallel MoE FFN → (x, its
    ``MoEOutput``)."""
    return moe_ffn_block(ctx, cfg, p, attn_apply(ctx, cfg, p, x, positions),
                         weight_mode)


def moe_ffn_block(ctx: MeshContext, cfg, p, x, weight_mode: str):
    """The expert-parallel MoE FFN with its residual → (x, its
    ``MoEOutput``)."""
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


# ---------------------------------------------------------------------------
# decode: one token against this rank's blocks of the decode state
# ---------------------------------------------------------------------------

class Slots(NamedTuple):
    """A layer's KV cache on this rank for one decode step: ``k``, ``v``
    (B, C_loc, Hkv, hd), written in place, and the ``length`` tokens
    written before this one; the whole cache has ``cap`` slots, of which
    the rank holds the C/m from r·C/m when ``split`` (the table splits
    the sequence over ``model`` where m divides C), else every slot."""
    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor
    cap: int
    split: bool


def _gather_cols(ctx: MeshContext, parts):
    """This rank's columns (…, w/m) of column-parallel outputs → each
    whole (…, w), all of them by one all-gather over ``model``."""
    packed = torch.cat(parts, -1) if len(parts) > 1 else parts[0]
    got = ctx.mesh.all_gather(packed[None], TP, 0)         # (m, …, Σ w/m)
    out, off = [], 0
    for t in parts:
        w = t.shape[-1]
        out.append(got[..., off:off + w].movedim(0, -2).reshape(
            *t.shape[:-1], ctx.m * w))
        off += w
    return out


def _write(ctx: MeshContext, cache: Slots, k, v):
    """The token's k and v (B, 1, Hkv, hd) into slot ``length % C``, on
    the device (no host sync): split, a masked local write on every rank
    (the rank that holds the slot takes the token, the others write back
    what their clamped slot held); else every rank writes it.  Returns
    the length after the write."""
    slot = (cache.length % cache.cap).long()
    if cache.split:
        cl = cache.k.shape[1]
        local = slot - ctx.r * cl
        own = (local >= 0) & (local < cl)
        slot = local.clamp(0, cl - 1)
    for buf, new in ((cache.k, k), (cache.v, v)):
        new = new.to(buf.dtype)
        if cache.split:
            new = torch.where(own, new, buf.index_select(1, slot.reshape(1)))
        buf.index_copy_(1, slot.reshape(1), new)
    return cache.length + 1


def _split_attend(ctx: MeshContext, q, k, v, length, cap: int, lo: int,
                  window: int = 0):
    """Every head of q (B, 1, H, hd) against this rank's slots k, v
    (B, C_loc, Hkv, hd), the absolute slots lo … lo + C_loc − 1 of a
    ``cap``-slot cache at ``length`` (:func:`attention.slot_valid`),
    combined over ``model`` by a split-K log-sum-exp in f32: the
    global max of the scores (an all-reduce max), each rank's softmax
    weighted by its share exp(local max − global max) · Σ exp(s − local
    max) of the global sum (an all-reduce), so that a rank with no valid
    slot adds zero; the probabilities are rounded to q's dtype, as
    ``decode_attend`` rounds them, each rank's partial P·V taken in f32
    and the partials summed in f32 onto this rank's H/m heads (a
    reduce-scatter), rounded once → (B, 1, H/m, hd) in q's dtype.  One
    rank: every share 1 and nothing to sum, ``decode_attend``'s
    arithmetic (P·V in q's dtype)."""
    scores = attention._scores_grouped(q, k, q.shape[-1] ** -0.5)
    slots = lo + torch.arange(k.shape[1], device=q.device)
    scores = torch.where(attention.slot_valid(length, cap, slots, window),
                         scores, attention.NEG_INF)        # (B, Hkv, G, 1, C)
    mx = scores.amax(-1, keepdim=True)
    share = torch.exp(scores - mx).sum(-1, keepdim=True) * torch.exp(
        mx - ctx.mesh.all_reduce(mx, TP, "max"))
    probs = torch.softmax(scores, dim=-1) * (
        share / ctx.mesh.all_reduce(share, TP))
    if ctx.m == 1:          # nothing to sum: decode_attend's one rounding
        o = attention._combine_grouped(probs, v, q.dtype)
    else:
        o = attention._combine_grouped(probs.to(q.dtype), v, torch.float32)
    return ctx.mesh.reduce_scatter(o, TP, 2).to(q.dtype)  # (B, 1, H/m, hd)


def _head_attend(ctx: MeshContext, cfg, q, k, v, length, window: int = 0):
    """This rank's H/m heads of q against every slot of a replicated
    cache k, v (B, C, Hkv, hd): the kv heads they read
    (:func:`_kv_heads`) through ``decode_attend``."""
    k, v = _kv_heads(ctx, cfg, k, v)
    return attention.decode_attend(q, attention.KVCache(k, v, length),
                                   window=window)


def attn_decode(ctx: MeshContext, cfg, p, x, cache: Slots, *,
                window: int = 0):
    """One token's self-attention with its residual, x (B, 1, ·) the
    residual stream: the column-parallel projections gathered over
    ``model`` (q, k and v by one call where the cache is split, else k
    and v), RoPE at ``length``, the token's k and v into its slot
    (:func:`_write`), then every head against the rank's slots combined
    over ``model`` (:func:`_split_attend`) or, where the cache is whole,
    the rank's heads against all of it; the rank's heads through the
    row-parallel ``wo``."""
    hd, m = cfg.head_dim, ctx.m
    xn = layers.rms_norm(ctx.enter(x), p["attn_norm"])
    b = xn.shape[0]
    q = xn @ p["wq"]
    if cache.split:
        q, k, v = _gather_cols(ctx, [q, xn @ p["wk"], xn @ p["wv"]])
    else:
        k, v = _gather_cols(ctx, [xn @ p["wk"], xn @ p["wv"]])
    pos = cache.length[None]              # absolute position of the token
    q = layers.apply_rope(q.reshape(b, 1, -1, hd), pos)
    k = layers.apply_rope(k.reshape(b, 1, cfg.num_kv_heads, hd), pos)
    length = _write(ctx, cache, k, v.reshape(b, 1, cfg.num_kv_heads, hd))
    if cache.split:
        o = _split_attend(ctx, q, cache.k, cache.v, length, cache.cap,
                          ctx.r * cache.k.shape[1], window)
    else:
        o = _head_attend(ctx, cfg, q, cache.k, cache.v, length, window)
    hl = cfg.num_heads // m
    return x + ctx.leave(o.reshape(b, 1, hl * hd) @ p["wo"])


def cross_decode(ctx: MeshContext, cfg, p, x, k, v, split: bool):
    """Whisper's cross-attention for one token against this rank's block
    k, v (B, S_enc/m, Hkv, hd) of the cached encoder K and V (all of
    them where m does not divide S_enc), every slot valid, with the
    residual: as :func:`attn_decode` without RoPE or a write."""
    hd, m = cfg.head_dim, ctx.m
    xn = layers.rms_norm(ctx.enter(x), p["xattn_norm"])
    b = xn.shape[0]
    q = xn @ p["xwq"]
    frames = k.shape[1] * (m if split else 1)
    length = torch.full((), frames, dtype=torch.int32, device=x.device)
    if split:
        q = _gather_cols(ctx, [q])[0].reshape(b, 1, cfg.num_heads, hd)
        o = _split_attend(ctx, q, k, v, length, frames, ctx.r * k.shape[1])
    else:
        o = _head_attend(ctx, cfg, q.reshape(b, 1, -1, hd), k, v, length)
    hl = cfg.num_heads // m
    return x + ctx.leave(o.reshape(b, 1, hl * hd) @ p["xwo"])


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
