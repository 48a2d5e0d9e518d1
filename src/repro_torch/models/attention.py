"""Attention: GQA with RoPE applied by the caller, causal with an
optional sliding window or non-causal, for the training forward, and
single-token decode against a KV cache.

The port of ``repro/models/attention.py``.  Two paths:

* ``attend`` — the training and prefill forward.  The reference has two
  paths for it (full scores for short sequences, a query-chunked scan
  above 1,024 tokens); the port has one, the flash-attention op
  (:func:`repro_torch.kernels.ops.flash_attention`), which takes any S
  and never materialises the (S, S) scores on the card.  ``window`` > 0
  is the hybrid family's local attention: query i sees keys
  i − window < j <= i, and the kernels skip the key tiles below the
  band.  ``causal=False`` is the audio family's encoder self-attention
  and cross-attention: every query sees all Sk keys of k and v, whose
  length is their own (the decoder's queries against the encoder's
  1,500 frames), on the kernels' unmasked instances.
* ``decode_attend`` — one query against a (possibly ring-buffered)
  :class:`KVCache`, in plain PyTorch as the reference's is plain XLA: the
  scores of one token against C cached keys are a (B, H, C) product.

GQA is computed grouped, as the reference's: q is reshaped to (B, S, Hkv,
G, Dh) and contracted against the un-repeated (B, C, Hkv, Dh) k and v.

Rounding: the reference rounds the probabilities to the activation dtype
before P·V (bf16 for llama3-8b), and so do the port's bf16 flash kernel
on the card (``csrc/flash_attention_sm90.cu``) and ``decode_attend``; the
f32 flash kernel and the flash op's plain version on the CPU keep them in
f32 and round only the output.  The reference takes the decode scores as
an f32 result of a bf16 product (``preferred_element_type``); a torch
bf16 product returns bf16, so ``decode_attend`` upcasts q and k first,
which is exact.

Shapes: q (B, Sq, H, Dh); k/v (B, Sk, Hkv, Dh) with H a multiple of
Hkv; Sq = Sk when causal.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ops

NEG_INF = -3e4  # representable in bf16 too


def attend(q, k, v, *, causal: bool = True, window: int = 0):
    """Softmax attention scaled by Dh^-½ → (B, Sq, H, Dh): causal, banded
    to the last ``window`` keys when ``window`` > 0; or, with ``causal=
    False``, over all Sk keys of k and v (``window`` 0: the port does not
    take a band without causality, which no model asks for)."""
    return ops.flash_attention(q, k, v, window=window, causal=causal)


class KVCache(NamedTuple):
    """Ring-buffered KV cache.  ``length`` counts the tokens ever written
    (a 0-d int32 tensor on the cache's device); the buffer holds the last
    ``k.shape[1]`` of them (the whole sequence for full decode, the
    window for sliding-window decode)."""
    k: torch.Tensor        # (B, C, Hkv, Dh)
    v: torch.Tensor        # (B, C, Hkv, Dh)
    length: torch.Tensor   # () int32

    @property
    def capacity(self) -> int:
        return self.k.shape[1]


def init_cache(batch: int, capacity: int, num_kv_heads: int, head_dim: int,
               dtype=torch.bfloat16, device=None) -> KVCache:
    shape = (batch, capacity, num_kv_heads, head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros((), dtype=torch.int32, device=device))


def cache_update(cache: KVCache, k_new, v_new) -> KVCache:
    """Write one step (B, 1, Hkv, Dh) at slot ``length % capacity``, in
    place: the returned cache shares ``cache``'s k and v buffers (one
    token's rows are written, the cache is not copied), with a new
    ``length``.  The slot stays on the device: no host sync."""
    slot = (cache.length % cache.capacity).long().reshape(1)
    cache.k.index_copy_(1, slot, k_new.to(cache.k.dtype))
    cache.v.index_copy_(1, slot, v_new.to(cache.v.dtype))
    return KVCache(cache.k, cache.v, cache.length + 1)


def _scores_grouped(q, k, scale):
    """q: (B, Sq, H, Dh), k: (B, Sk, Hkv, Dh) → f32 (B, Hkv, G, Sq, Sk).
    Both are upcast to f32 first (exact), the product the reference asks
    of a bf16 contraction with an f32 result."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    qg = q.float().reshape(b, sq, hkv, h // hkv, dh)
    return torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale


def _combine_grouped(probs, v, out_dtype):
    """probs: (B, Hkv, G, Sq, Sk), v: (B, Sk, Hkv, Dh) → (B, Sq, H, Dh);
    the probabilities are rounded to ``out_dtype`` before P·V."""
    b, hkv, g, sq, _ = probs.shape
    o = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(out_dtype),
                     v.to(out_dtype))
    return o.reshape(b, sq, hkv * g, v.shape[-1])


def decode_attend(q, cache: KVCache, *, window: int = 0,
                  scale: Optional[float] = None):
    """Single-token attention: q (B, 1, H, Dh) against the cache contents,
    ``cache.length`` counted after the current token was written.

    Full caches (capacity = total sequence) and ring buffers (capacity =
    window) alike: slot i holds the absolute position p ≡ i (mod C) with
    the largest p < length; it is valid iff p ≥ 0 and p ≥ length − C,
    and, with a sliding window, p > length − 1 − window.  Invalid slots
    score ``NEG_INF``."""
    dh = q.shape[-1]
    scale = scale if scale is not None else dh ** -0.5
    cap = cache.capacity
    scores = _scores_grouped(q, cache.k, scale)          # (B, Hkv, G, 1, C)
    slots = torch.arange(cap, device=q.device)
    scores = torch.where(slot_valid(cache.length, cap, slots, window),
                         scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return _combine_grouped(probs, cache.v, q.dtype)


def slot_valid(length, cap: int, slots, window: int = 0):
    """Which of a cache's ``slots`` (absolute slot indices of a C = ``cap``
    ring, a block of them on a shard) hold a token a query at ``length``
    (counted after its own write) sees: slot i holds the absolute
    position p ≡ i (mod C) with the largest p < length; valid iff p ≥ 0
    and p ≥ length − C, and, with a sliding window, p > length − 1 −
    window."""
    newest = length - 1
    pos = newest - ((newest - slots) % cap)              # absolute position
    valid = (pos >= 0) & (pos >= length - cap)
    if window:
        valid &= pos > newest - window
    return valid
