"""Shared building blocks of the decoder.

The port of ``repro/models/layers.py``: plain functions over tensors and
explicit parameter dicts.  The decoder stack's parameters are
layer-stacked: every block leaf has a leading ``(num_layers, …)`` axis.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def normal(generator: torch.Generator, shape, scale: float, dtype,
           device) -> torch.Tensor:
    """``scale`` · N(0, 1) drawn in f32 from ``generator`` (on its own
    device), then moved to ``device`` and cast to ``dtype``; on the
    ``meta`` device an empty tensor of the shape, nothing drawn."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (scale * x).to(device=device, dtype=dtype)


def rms_norm(x, weight, eps: float = 1e-6):
    """RMSNorm in f32, scaled by (1 + w), cast back to x's dtype (the llama
    convention of the reference)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + weight.float())
    return out.to(x.dtype)


def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """Rotary embedding on the head's two halves (not interleaved).
    x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)       # (Dh/2,)
    angles = positions[..., None].float() * freqs                 # (..., S, Dh/2)
    cos = torch.cos(angles)[..., None, :]                         # (..., S, 1, Dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    """SwiGLU feed-forward (llama family): silu(x·Wg) ⊙ (x·Wu) · Wd."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x, w_in, b_in, w_out, b_out):
    """GELU MLP (tanh approximation), the GPT-BigCode feed-forward of
    granite-34b."""
    return F.gelu(x @ w_in + b_in, approximate="tanh") @ w_out + b_out


def embed(tokens, table):
    return F.embedding(tokens.long(), table)


def unembed(x, table):
    """Tied unembedding in f32: logits = x · Eᵀ."""
    return x.float() @ table.float().T


def softmax_cross_entropy(logits, labels, z_loss: float = 0.0):
    """Token-level cross-entropy in f32 over the whole last axis (the
    padded vocabulary), as a mean over tokens; labels are int ids.
    ``z_loss`` adds z · logsumexp² per token."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse ** 2
    return torch.mean(loss)
