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

Like the reference's model forward, the port starts every sequence from
a zero WKV state and a zero token shift.  Decode (``wkv_step``) and a
carried ``RWKVState`` are not ported (``ROADMAP.md``, queue 1 item 5).
"""
from __future__ import annotations

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


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet: the port runs the "
        "training forward from a zero state (see ROADMAP.md, queue 1 "
        "item 5)")


def wkv_step(*args, **kwargs):
    """One decode step of the reference; not ported."""
    raise _not_ported("rwkv6.wkv_step (decode)")


def time_mix(params, x, num_heads: int, state=None, *, decode: bool = False):
    """The RWKV-6 attention replacement over a whole sequence, x (B, S, D),
    from a zero WKV state and a zero shift.  Returns y in x's dtype.
    ``state`` (a carried ``RWKVState``) and ``decode`` raise."""
    if decode or state is not None:
        raise _not_ported("time_mix with decode or a carried RWKVState")
    b, s, d = x.shape
    h = num_heads
    dh = d // h
    shift = torch.zeros(b, d, dtype=x.dtype, device=x.device)
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

    o = ops.rwkv6_wkv(r, k, v, w, params["bonus"])           # f32
    o = _group_norm(o, params["ln_w"], params["ln_b"])
    # the reference's (o·g) @ wo promotes to an f32 product (o is f32);
    # torch takes no mixed-dtype matmul, so both sides are upcast
    y = (o.reshape(b, s, d) * g).float() @ params["wo"].float()
    return y.to(x.dtype)


def channel_mix(params, x, shift_state=None):
    """RWKV channel mix (the FFN analogue), squared-ReLU gated, from a
    zero shift (a carried ``shift_state`` raises)."""
    if shift_state is not None:
        raise _not_ported("channel_mix with a carried shift state")
    shift = torch.zeros(x.shape[0], x.shape[2], dtype=x.dtype,
                        device=x.device)
    xk = _token_shift(x, params["cmix_k"], shift)
    xr = _token_shift(x, params["cmix_r"], shift)
    k = torch.square(F.relu(xk @ params["ck"]))
    return torch.sigmoid(xr @ params["cr"]) * (k @ params["cv"])
