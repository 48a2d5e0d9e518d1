"""Mixture-of-Experts feed-forward with top-k token-choice routing.

The port of ``repro/models/moe.py``'s ``moe_ffn``: the router in f32,
softmax and top-k, dispatch *per example* into an (E, C, D) buffer with
capacity C, the grouped expert SwiGLU over the whole (B, E, C, D)
buffer, the gate-weighted combine, the shared expert when there is one,
and the GShard load-balance loss.

The reference sorts each example's S·k assignments by expert (a stable
``argsort``), takes each one's position within its expert by
``searchsorted``, and scatter-adds the kept ones into the buffer; the
combine gathers them back and scatter-adds over tokens.  The port keeps
what that computes and changes how:

* the position of assignment j (flat (token, slot) order) within its
  expert is the number of earlier assignments to the same expert — the
  inclusive cumsum of the one-hot expert matrix over the flat axis,
  minus one — which is the stable sort's rank, integer for integer;
* dispatch and combine are one-hot einsums over the buffer's E·C slots:
  ``buf = Σ_s D[s, ec] x[s]`` and ``y[s] = Σ_ec W[s, ec] y_buf[ec]``,
  D holding a 1 where a kept assignment of token s fills slot ec and W
  its gate there.  Each slot is filled by at most one assignment, so
  dispatch is exact; a token's k slots are distinct, so the combine
  sums its k weighted rows.

Comparisons, cumsum, einsum and ``topk`` all have batching rules, so the
layer runs under ``torch.func.vmap`` of ``vjp`` (the engine's client
upload); and neither direction uses a scatter-add or the backward of a
repeated-index gather, which on CUDA sum floats by atomics in an order
that changes from run to run: forward and backward are deterministic on
the card.

The expert-parallel ``moe_ffn_sharded`` is the reference's
``shard_map`` path on the port's production mesh: each model rank runs
its block of experts on its rows of the batch, through the same slots,
dispatch and combine restricted to its experts, and the partial outputs
are summed over the model axis (:mod:`repro_torch.parallel`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import parallel
from repro_torch.parallel import data_axes

TP = "model"        # the expert (and tensor) parallel axis
FSDP = "data"       # the axis of the expert weights' FSDP shard


class MoEOutput(NamedTuple):
    y: torch.Tensor             # (B, S, D), x's dtype
    aux_loss: torch.Tensor      # () f32 load-balance loss
    dropped_frac: torch.Tensor  # () f32: share of assignments dropped


def capacity_for(seq: int, k: int, num_experts: int,
                 capacity_factor: float = 1.25) -> int:
    c = int(seq * k * capacity_factor / num_experts) + 1
    return max(1, min(c, seq * k))


def route(x, w_router, k: int):
    """Router in f32. x: (B, S, D) → (gates (B, S, k) renormalised to sum
    1, expert ids (B, S, k) int64, probs (B, S, E))."""
    logits = torch.einsum("bsd,de->bse", x.float(), w_router.float())
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx, probs


def _one_hot(idx, n: int, dtype=torch.int32):
    """``idx[..., None] == arange(n)`` (batches under vmap, where
    ``F.one_hot`` checks its range on the host)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def positions(idx, num_experts: int, cap: int):
    """Each assignment's slot in its expert's buffer, in the flat (token,
    slot) order of ``idx`` (B, S, k) → (expert (B, S·k), position
    (B, S·k), keep (B, S·k) bool): the position is the count of earlier
    assignments of the example to the same expert, the stable sort's
    rank; ``keep = position < cap``."""
    flat_e = idx.reshape(idx.shape[0], -1)
    hot = _one_hot(flat_e, num_experts)                    # (B, S·k, E)
    pos = (torch.cumsum(hot, dim=1) * hot).sum(-1) - 1
    return flat_e, pos, pos < cap


def load_balance_loss(probs, idx, num_experts: int):
    """GShard aux loss: E · Σ_e (mean prob to e) · (mean fraction routed
    to e by the top-1 choice)."""
    me = torch.mean(probs, dim=(0, 1))
    ce = torch.mean(_one_hot(idx[..., 0], num_experts, torch.float32),
                    dim=(0, 1))
    return num_experts * torch.sum(me * ce)


def global_load_balance_loss(probs, idx, num_experts: int, mesh, dp):
    """:func:`load_balance_loss` of the global batch from this rank's
    rows: the E per-expert sums of the probabilities and of the top-1
    counts all-reduced over the data axes ``dp`` (one call, whose
    backward sums the probabilities' gradient back over them), then
    divided by the global token count.  A product of means is not the
    mean of the ranks' products, so each rank's own loss would not
    do."""
    rows = probs.shape[0] * probs.shape[1]
    stats = parallel.all_reduce(torch.stack([
        probs.sum((0, 1)),
        _one_hot(idx[..., 0], num_experts, torch.float32).sum((0, 1))]),
        mesh, dp)
    n = rows * mesh.axis_size(dp)
    return num_experts * torch.sum((stats[0] / n) * (stats[1] / n))


def slots(idx, num_experts: int, cap: int, e_lo: int = 0,
          e_loc: int = None):
    """Each assignment's slot in the (e_loc, C) buffer of experts [e_lo,
    e_lo + e_loc) (all of them by default), in the flat (token, slot)
    order of ``idx`` (B, S, k) → (slot (B, S·k), kept (B, S·k) bool):
    (e − e_lo)·C + its :func:`positions` rank where the assignment is to
    a local expert and within capacity, else e_loc·C (past the end).
    The rank counts the example's earlier assignments to the same expert
    over all experts, so it is the reference's ``_slots_for_experts``
    (``argsort`` + ``searchsorted`` restricted to local experts) integer
    for integer."""
    e_loc = num_experts if e_loc is None else e_loc
    flat_e, pos, keep = positions(idx, num_experts, cap)
    kept = keep & (flat_e >= e_lo) & (flat_e < e_lo + e_loc)
    return torch.where(kept, (flat_e - e_lo) * cap + pos, e_loc * cap), kept


def _experts(x, gates, slot, e_loc: int, cap: int, wg, wu, wd):
    """Dispatch x (B, S, D) into the (B, e_loc, C, D) buffer by the
    one-hot of ``slot``, the experts' SwiGLU, and the gate-weighted
    combine back to (B, S, D)."""
    b, s, d = x.shape
    k = gates.shape[-1]
    # a kept assignment's one-hot row; a dropped or foreign one's falls in
    # the column past the end, cut off; summed over the token's k slots
    hot = _one_hot(slot.reshape(b, s, k), e_loc * cap + 1, x.dtype)[..., :-1]
    bufs = torch.einsum("bsc,bsd->bcd", hot.sum(2), x).reshape(
        b, e_loc, cap, d)
    g = F.silu(torch.einsum("becd,edf->becf", bufs, wg))
    u = torch.einsum("becd,edf->becf", bufs, wu)
    y_buf = torch.einsum("becf,efd->becd", g * u, wd)
    weights = torch.einsum("bskc,bsk->bsc", hot, gates.to(y_buf.dtype))
    return torch.einsum("bsc,bcd->bsd", weights,
                        y_buf.reshape(b, e_loc * cap, d))


def _shared(x, params):
    g = F.silu(x @ params["shared_wg"])
    return (g * (x @ params["shared_wu"])) @ params["shared_wd"]


def moe_ffn(x, params, *, num_experts: int, k: int,
            capacity_factor: float = 1.25) -> MoEOutput:
    """x: (B, S, D).  params: router (D, E), wg/wu (E, D, F), wd (E, F,
    D), and shared_wg/shared_wu/shared_wd for a shared expert
    (llama4-style), all in x's dtype but the router."""
    e = num_experts
    cap = capacity_for(x.shape[1], k, e, capacity_factor)
    gates, idx, probs = route(x, params["router"], k)
    slot, keep = slots(idx, e, cap)
    y = _experts(x, gates, slot, e, cap, params["wg"], params["wu"],
                 params["wd"])
    if "shared_wg" in params:
        y = y + _shared(x, params)
    aux_loss = load_balance_loss(probs, idx, e)
    kept = keep.float().sum() / keep.numel()
    return MoEOutput(y.to(x.dtype), aux_loss, 1.0 - kept)


def moe_ffn_sharded(x, params, *, num_experts: int, k: int,
                    capacity_factor: float = 1.25, mesh,
                    weight_mode: str = "fsdp", out_tp=None) -> MoEOutput:
    """Expert-parallel MoE on a :class:`repro_torch.launch.mesh.
    ProductionMesh`, the port of the reference's ``shard_map`` path.

    x: (B_loc, S, D), this rank's rows of the batch (split over the
    mesh's data axes, ``parallel.data_axes``), whole over ``model``.  The
    rank of model index r owns experts [r·E/m, (r+1)·E/m): params hold
    its blocks, router (D, E) whole, and shared_wg/shared_wu (D, F/m) and
    shared_wd (F/m, D) as column- and row-parallel blocks.  It routes its
    rows over all E experts, fills its local experts' slots
    (:func:`slots`), runs them, combines its partial output, and sums the
    partials over ``model`` (the MoE combine collective).  The experts
    always carry the ``data`` shard (``launch.sharding``'s table keeps it
    even with ``fsdp_params=False``).  ``weight_mode``:

    * ``"fsdp"`` (train default) — expert weights (E/m, D/f, F) and wd
      (E/m, F, D/f): their d_model dim is all-gathered over ``data`` each
      layer (f its size);
    * ``"stationary"`` (decode) — expert weights (E/m, D, F/f) and wd
      (E/m, F/f, D) never move: x is all-gathered over the data axes,
      every rank computes its (expert, d_ff) block of the whole batch,
      one all-reduce over (``data``, ``model``) combines, and each rank
      keeps its rows.  A forward (serving) mode.

    ``out_tp=None`` gives y whole (B_loc, S, D); ``"model"`` gives this
    rank's d_model block (B_loc, S, D/m) by a reduce-scatter instead of
    the all-reduce (fsdp mode).  ``dropped_frac`` counts the kept
    assignments over every expert and the whole global batch (an
    all-reduce over the model and data axes), so it is ``moe_ffn``'s on
    the global batch exactly.  ``aux_loss`` is the global batch's too
    (:func:`global_load_balance_loss`), the same on every rank, its
    gradient carried once over ``model``.  Raises where m does not
    divide E."""
    if weight_mode not in ("fsdp", "stationary"):
        raise ValueError(f"moe_ffn_sharded: weight_mode {weight_mode!r}")
    e = num_experts
    m = mesh.axis_size(TP)
    if e % m:
        raise ValueError(f"moe_ffn_sharded: {m} model ranks do not divide "
                         f"{e} experts")
    e_loc = e // m
    wg, wu, wd = params["wg"], params["wu"], params["wd"]
    if wg.shape[0] != e_loc:
        raise ValueError(f"moe_ffn_sharded: expert block of {wg.shape[0]}, "
                         f"want E/m = {e_loc}")
    e_lo = mesh.axis_index(TP) * e_loc
    stationary = weight_mode == "stationary"
    dp = data_axes(mesh)
    b_loc, s, d = x.shape
    cap = capacity_for(s, k, e, capacity_factor)
    xs = x
    if stationary:
        xs = parallel.all_gather(x, mesh, dp, 0)
    else:
        wg = parallel.all_gather(wg, mesh, FSDP, 1)
        wu = parallel.all_gather(wu, mesh, FSDP, 1)
        wd = parallel.all_gather(wd, mesh, FSDP, 2)
    if wg.shape[1] != d or wd.shape[2] != d:
        raise ValueError(f"moe_ffn_sharded ({weight_mode}): expert blocks "
                         f"{tuple(wg.shape)}, {tuple(wd.shape)} for d_model "
                         f"{d}; shard with moe_fsdp_dim="
                         f"{'f' if stationary else 'd'}")
    gates, idx, probs = route(xs, params["router"], k)
    slot, kept = slots(idx, e, cap, e_lo, e_loc)
    part = _experts(xs, gates, slot, e_loc, cap, wg, wu, wd)
    row0 = mesh.axis_index(dp) * b_loc
    if "shared_wg" in params:
        shared = _shared(x, params)
        if stationary:
            part = torch.cat([part[:row0], part[row0:row0 + b_loc] + shared,
                              part[row0 + b_loc:]])
        else:
            part = part + shared
    if stationary:
        y = parallel.reduce_from(part, mesh, (FSDP, TP)).narrow(0, row0,
                                                                 b_loc)
        if out_tp is not None:
            dl = d // m
            y = y.narrow(-1, mesh.axis_index(TP) * dl, dl)
    elif out_tp is None:
        y = parallel.reduce_from(part, mesh, TP)
    else:
        y = parallel.reduce_scatter(part, mesh, TP, -1)
    aux_loss = load_balance_loss(probs, idx, e) if stationary \
        else global_load_balance_loss(probs, idx, e, mesh, dp)
    # every model rank computes the same aux from the same router
    # logits: each carries 1/m of its gradient, so that the sum over
    # ``model`` (the entry's backward, the router's gradient) counts it
    # once; the value is aux's own
    aux_loss = aux_loss.detach() + (aux_loss - aux_loss.detach()) / m
    with torch.no_grad():
        kept_n = mesh.all_reduce(kept.float().sum(), TP if stationary
                                 else (TP, *dp))
        total = float(kept.numel() * (1 if stationary
                                      else mesh.axis_size(dp)))
        dropped = 1.0 - torch.clamp(kept_n / total, max=1.0)
    return MoEOutput(y.to(x.dtype), aux_loss, dropped)
