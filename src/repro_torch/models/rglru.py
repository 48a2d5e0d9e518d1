"""The RG-LRU recurrence of the hybrid family (RecurrentGemma / Griffin,
arXiv:2402.19427).

The port of ``repro/models/rglru.py``.  The Real-Gated Linear Recurrent
Unit, per channel:

    r_t = σ(x_t · W_a)                             (recurrence gate)
    i_t = σ(x_t · W_x)                             (input gate)
    a_t = exp(−c · softplus(Λ) ⊙ r_t)              (c = 8)
    h_t = a_t ⊙ h_{t−1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ x_t)

a, the gated input and h in f32; y = h cast to x's dtype.  The
recurrence is linear and diagonal, so the sequence is a prefix scan over
the composition (a₁, b₁)∘(a₂, b₂) = (a₁a₂, a₂b₁ + b₂).  The reference
runs XLA's ``associative_scan`` (no Pallas kernel); the port runs a
doubling scan in plain PyTorch: log2 S steps, step d combining each
position with the one 2^d before it, a few elementwise launches each,
under ``torch.func.vmap`` and autograd alike.  The two scans group the
products differently, so they agree to f32 rounding.  Decode carries h
as explicit state (:func:`rg_lru_step`).

The block around it (the temporal conv, the gates, the output gate) is
``repro_torch.models.transformer._recurrent_block``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

RGLRU_C = 8.0


def stable_decay(lam_param, r):
    """a_t = exp(−c·softplus(Λ)·r_t) in f32, through its log."""
    return torch.exp(-RGLRU_C * F.softplus(lam_param.float()) * r.float())


def _gated(a, x, i):
    """sqrt(max(1 − a², 1e-12)) · (i · x) in f32."""
    return torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) \
        * (i.float() * x.float())


def rg_lru(x, r, i, lam_param, h0=None):
    """The recurrence over the sequence, x, r, i (B, S, D), lam_param (D,),
    h0 (B, D) or None → (y (B, S, D) in x's dtype, h_last (B, D) f32).

    h0 is folded into the first element, b₀ += a₀·h0, as the reference
    does; then the doubling scan: after the step at offset d every
    position holds the composition of the 2d elements ending there (the
    elements before position 0 are the identity (1, 0))."""
    a = stable_decay(lam_param, r)                    # (B, S, D) f32
    b = _gated(a, x, i)
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]],
                      dim=1)
    s = x.shape[1]
    d = 1
    while d < s:
        a_prev = torch.cat([torch.ones_like(a[:, :d]), a[:, :-d]], dim=1)
        b_prev = torch.cat([torch.zeros_like(b[:, :d]), b[:, :-d]], dim=1)
        b = a * b_prev + b
        a = a * a_prev
        d *= 2
    return b.to(x.dtype), b[:, -1]


def rg_lru_step(x, r, i, lam_param, h):
    """One decode step, x, r, i (B, D), h (B, D) f32 → (y in x's dtype,
    the new h, f32)."""
    a = stable_decay(lam_param, r)
    h_new = a * h + _gated(a, x, i)
    return h_new.to(x.dtype), h_new


def temporal_conv(x, w, state=None):
    """Causal depthwise temporal conv of width T (Griffin's 4), x (B, S, D),
    w (T, D), ``state`` (B, T − 1, D) the trailing context of decode (zero
    when None), in x's dtype → (y (B, S, D), the new state: the last
    T − 1 rows of the padded input)."""
    t = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], t - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                   # (B, S + T − 1, D)
    y = sum(xp[:, j:j + x.shape[1]] * w[j] for j in range(t))
    return y, xp[:, -(t - 1):]
