"""RWKV-6 "Finch" time mix with data-dependent decay, and the channel mix.

The port of ``repro/models/rwkv6.py`` for the training forward: per head
h with key and value size Dh, the WKV state S ∈ R^{Dh×Dh} evolves per
token as

    S_t = diag(w_t) · S_{t−1} + k_tᵀ v_t
    o_t = r_t · (S_{t−1} + diag(u) · k_tᵀ v_t)

with w_t = exp(−exp(decay_t)) the data-dependent decay and u the bonus.
The scan is the WKV op (:func:`repro_torch.kernels.ops.rwkv6_wkv`): the
hand-written kernel for CUDA tensors, the chunked plain version for CPU
ones.  The reference's ``time_mix`` runs ``wkv_chunked`` at a chunk of
min(64, S); the port's op runs chunks of 16 (the kernel steps token by
token), the same function in another summation order.  At a chunk of 64
the reference's factorised exponentials overflow for log-decays below
about −1.4 (``ROADMAP.md``, queue 3); the port's stay finite.

Like the reference's model forward, the sequence path starts every
sequence from a zero WKV state and a zero token shift.  Decode carries
an :class:`RWKVState` token by token through :func:`wkv_step`, the
one-token recurrence in f32, in plain PyTorch as the reference's is
plain XLA, and ``channel_mix`` carries its own shift.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

LOG_DECAY_FLOOR = -5.0   # per-token decay clamped to [e^-5, 1], as the
                         # reference's (its chunked form needs it for f32)


def time_mix_params_shapes(d_model: int, num_heads: int, lora: int = 64):
    head = d_model // num_heads
    return dict(
        mix_r=(d_model,), mix_k=(d_model,), mix_v=(d_model,),
        mix_w=(d_model,), mix_g=(d_model,),
        wr=(d_model, d_model), wk=(d_model, d_model), wv=(d_model, d_model),
        wg=(d_model, d_model), wo=(d_model, d_model),
        decay_w1=(d_model, lora), decay_w2=(lora, d_model),
        decay_base=(d_model,), bonus=(num_heads, head),
        ln_w=(num_heads, head), ln_b=(num_heads, head))


def _token_shift(x, mix, shift_state):
    """x ← lerp(x, x_{t−1}, mix): (B, S, D) with ``shift_state`` (B, D)
    standing for the token before the first."""
    prev = torch.cat([shift_state[:, None], x[:, :-1]], dim=1)
    return x + mix * (prev - x)


def _group_norm(x, w, b, eps: float = 64e-5):
    """Per-head LayerNorm of the WKV readout, x (B, S, H, Dh): population
    variance, scaled by w (not 1 + w), cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps) * w + b).to(x.dtype)


class RWKVState(NamedTuple):
    """The state a layer's time mix carries from token to token: the WKV
    state and the last token's (normed) input for the token shift.
    ``wkv=None`` stands for a zero WKV state (the sequence path's)."""
    wkv: Optional[torch.Tensor]   # (B, H, Dh, Dh) f32
    shift: torch.Tensor           # (B, D)


def wkv_step(r, k, v, w, u, s):
    """One decode step of the WKV recurrence, in f32.  r, k, v, w:
    (B, H, Dh); u: (H, Dh); s: (B, H, Dh, Dh) f32.  Returns
    (o (B, H, Dh), s') with o = r·(s + diag(u)·kᵀv), s' = diag(w)·s + kᵀv."""
    r, k, v, w = (t.float() for t in (r, k, v, w))
    kv = torch.einsum("bhk,bhv->bhkv", k, v)
    o = torch.einsum("bhk,bhkv->bhv", r,
                     s + u.float()[None, :, :, None] * kv)
    return o, w[..., None] * s + kv


def time_mix(params, x, state: Optional[RWKVState], num_heads: int, *,
             decode: bool = False):
    """The RWKV-6 attention replacement, x (B, S, D) → (y in x's dtype,
    new ``RWKVState`` with ``shift = x[:, -1]``).  ``state=None`` is a
    zero WKV state and a zero shift.

    ``decode=True`` (S = 1) runs :func:`wkv_step` from ``state.wkv`` and
    returns the next WKV state.  Otherwise the sequence runs the WKV op
    (the kernel on the card) from a zero WKV state, as the reference's
    Pallas kernel does, and the new state's ``wkv`` is None: the op
    returns no final state, and a nonzero carried ``state.wkv`` raises
    (the token shift carries either way)."""
    b, s, d = x.shape
    h = num_heads
    dh = d // h
    if decode and s != 1:
        raise ValueError(f"time_mix: decode takes one token, got S = {s}")
    wkv0 = None if state is None else state.wkv
    shift = torch.zeros(b, d, dtype=x.dtype, device=x.device) \
        if state is None else state.shift
    xr = _token_shift(x, params["mix_r"], shift)
    xk = _token_shift(x, params["mix_k"], shift)
    xv = _token_shift(x, params["mix_v"], shift)
    xw = _token_shift(x, params["mix_w"], shift)
    xg = _token_shift(x, params["mix_g"], shift)

    r = (xr @ params["wr"]).reshape(b, s, h, dh)
    k = (xk @ params["wk"]).reshape(b, s, h, dh)
    v = (xv @ params["wv"]).reshape(b, s, h, dh)
    g = F.silu(xg @ params["wg"])
    # data-dependent decay (Finch) in f32: w = exp(−exp(base + LoRA(x)));
    # decay_base is already in the activation dtype
    dec = params["decay_base"] + torch.tanh(
        xw.float() @ params["decay_w1"].float()) @ params["decay_w2"].float()
    w = torch.exp(torch.clamp(-torch.exp(dec.float()), LOG_DECAY_FLOOR, 0.0)
                  ).reshape(b, s, h, dh)

    if decode:
        if wkv0 is None:
            wkv0 = torch.zeros(b, h, dh, dh, device=x.device)
        o, wkv = wkv_step(r[:, 0], k[:, 0], v[:, 0], w[:, 0],
                          params["bonus"], wkv0)
        o = o[:, None]                                    # (B, 1, H, Dh)
    else:
        if wkv0 is not None and bool(wkv0.any()):
            raise NotImplementedError(
                "time_mix: a nonzero carried WKV state on the sequence path "
                "is not ported: the WKV kernel starts from a zero state, as "
                "the reference's Pallas kernel does; feed the tokens one at "
                "a time with decode=True (see ROADMAP.md, queue 3)")
        o = ops.rwkv6_wkv(r, k, v, w, params["bonus"])       # f32
        wkv = None
    o = _group_norm(o, params["ln_w"], params["ln_b"])
    # the reference's (o·g) @ wo promotes to an f32 product (o is f32);
    # torch takes no mixed-dtype matmul, so both sides are upcast
    y = (o.reshape(b, s, d) * g).float() @ params["wo"].float()
    return y.to(x.dtype), RWKVState(wkv=wkv, shift=x[:, -1])


def channel_mix(params, x, shift_state=None):
    """RWKV channel mix (the FFN analogue), squared-ReLU gated: x (B, S, D)
    → (y, x[:, -1]), the shift carried from ``shift_state`` (B, D), or
    from zero when it is None."""
    shift = torch.zeros(x.shape[0], x.shape[2], dtype=x.dtype,
                        device=x.device) if shift_state is None \
        else shift_state
    xk = _token_shift(x, params["cmix_k"], shift)
    xr = _token_shift(x, params["cmix_r"], shift)
    k = torch.square(F.relu(xk @ params["ck"]))
    return torch.sigmoid(xr @ params["cr"]) * (k @ params["cv"]), x[:, -1]
