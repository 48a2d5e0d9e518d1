"""Attention of the training forward: causal GQA with RoPE applied by the
caller.

The port of ``repro/models/attention.py::attend`` and ``attend_chunked``.
The reference has two paths for one function (full scores for short
sequences, a query-chunked scan above 1,024 tokens); the port has one,
the flash-attention op (:func:`repro_torch.kernels.ops.flash_attention`),
which takes any S and never materialises the (S, S) scores on the card.

Rounding: the reference rounds the probabilities to the activation dtype
before P·V (bf16 for llama3-8b), and so does the port's bf16 kernel on
the card (``csrc/flash_attention_sm90.cu``); the f32 kernel and the plain
version on the CPU keep them in f32 and round only the output.

Shapes: q (B, S, H, Dh); k/v (B, S, Hkv, Dh) with H a multiple of Hkv.
Sliding windows, non-causal attention and KV-cache decode are not ported
yet.
"""
from __future__ import annotations

from repro_torch.kernels import ops


def attend(q, k, v, *, causal: bool = True, window: int = 0):
    """Causal softmax attention, scaled by Dh^-½ → (B, S, H, Dh)."""
    if not causal or window:
        raise NotImplementedError(
            "attend: only causal attention without a window is ported to "
            "repro_torch (see ROADMAP.md, queue 1)")
    return ops.flash_attention(q, k, v)
