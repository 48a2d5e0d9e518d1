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

The expert-parallel ``moe_ffn_sharded`` (``shard_map`` on the
production mesh) is not ported (ROADMAP.md, queue 1).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


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


def moe_ffn(x, params, *, num_experts: int, k: int,
            capacity_factor: float = 1.25) -> MoEOutput:
    """x: (B, S, D).  params: router (D, E), wg/wu (E, D, F), wd (E, F,
    D), and shared_wg/shared_wu/shared_wd for a shared expert
    (llama4-style), all in x's dtype but the router."""
    b, s, d = x.shape
    e = num_experts
    cap = capacity_for(s, k, e, capacity_factor)
    gates, idx, probs = route(x, params["router"], k)
    flat_e, pos, keep = positions(idx, e, cap)
    # the buffer slot of each kept assignment, E·C (past the end) if
    # dropped; its one-hot rows summed over the token's k slots
    slot = torch.where(keep, flat_e * cap + pos, e * cap)
    hot = _one_hot(slot.reshape(b, s, k), e * cap + 1, x.dtype)[..., :-1]
    bufs = torch.einsum("bsc,bsd->bcd", hot.sum(2), x).reshape(b, e, cap, d)

    g = F.silu(torch.einsum("becd,edf->becf", bufs, params["wg"]))
    u = torch.einsum("becd,edf->becf", bufs, params["wu"])
    y_buf = torch.einsum("becf,efd->becd", g * u, params["wd"])

    weights = torch.einsum("bskc,bsk->bsc", hot, gates.to(y_buf.dtype))
    y = torch.einsum("bsc,bcd->bsd", weights,
                     y_buf.reshape(b, e * cap, d))
    if "shared_wg" in params:
        g = F.silu(x @ params["shared_wg"])
        y = y + (g * (x @ params["shared_wu"])) @ params["shared_wd"]

    aux_loss = load_balance_loss(probs, idx, e)
    kept = torch.mean(keep.float())
    return MoEOutput(y.to(x.dtype), aux_loss, 1.0 - kept)
