"""Architecture and input-shape configuration.

The port's copy of ``repro/configs/base.py``: every architecture gets one
``<id>.py`` in this package exporting ``CONFIG`` (the exact published
spec, source cited) built from :class:`ModelConfig`.  ``reduced()``
derives the ≤2-layer, d_model≤512, ≤4-expert smoke variant of the same
family for CPU tests.  Dtypes are names (``"float32"``, ``"bfloat16"``)
that :data:`DTYPES` maps to ``torch`` dtypes.
"""
from __future__ import annotations

import dataclasses

import torch

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # one of FAMILIES
    num_layers: int
    d_model: int
    num_heads: int               # 0 for attention-free (rwkv)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1           # 1 = every layer MoE; 2 = alternate (llama4)
    shared_expert: bool = False
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # hybrid (recurrentgemma / griffin): repeating unit of
    # (pattern_recurrent RG-LRU blocks + pattern_attn local-attn blocks)
    pattern_recurrent: int = 0
    pattern_attn: int = 0
    local_window: int = 2048
    conv_width: int = 4
    # rwkv
    rwkv_heads: int = 0
    # encoder-decoder (whisper): encoder layers + fixed frontend frames
    encoder_layers: int = 0
    encoder_seq: int = 0
    # vlm: stub image tokens prepended to the text sequence
    num_image_tokens: int = 0
    # feed-forward type: "swiglu" (llama family) or "gelu" (GPT-2/whisper)
    ffn: str = "swiglu"
    # long-context variant for dense archs (ring-buffer decode)
    sliding_window: int = 8192
    # numerics
    param_dtype: str = "float32"     # "float32" | "bfloat16"
    activ_dtype: str = "bfloat16"
    # citation
    source: str = ""

    @property
    def pdtype(self) -> torch.dtype:
        return DTYPES[self.param_dtype]

    @property
    def adtype(self) -> torch.dtype:
        return DTYPES[self.activ_dtype]

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so the embedding table
        shards over any (data x model) <= 16x16 mesh (whisper's 51866,
        phi-3's 32064, llama4's 202048 and qwen3's 151936 need padding —
        the standard TPU practice).  Labels never index the padding."""
        return ((self.vocab_size + 255) // 256) * 256

    def param_count(self) -> int:
        """Total trainable parameters (used for 6·N·D model-FLOPs)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        hd = self.head_dim
        emb = v * d
        per_attn = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) \
            + (self.num_heads * hd) * d
        per_dense_ffn = (3 if self.ffn == "swiglu" else 2) * d * f
        per_norms = 2 * d
        total = emb
        if self.family == "ssm":
            # time-mix: 5 mixes + wr/wk/wv/wg/wo (5·d²) + decay LoRA + bonus/ln
            tm = 5 * d + 5 * d * d + d * 64 + 64 * d + d + 3 * d
            # channel-mix: ck (d,f), cv (f,d), cr (d,d) + 2 mixes
            cm = 2 * d + d * f + f * d + d * d
            total += L * (tm + cm + per_norms)
            return int(total)
        if self.family == "hybrid":
            unit = self.pattern_recurrent + self.pattern_attn
            n_rec = (L // unit) * self.pattern_recurrent + \
                min(L % unit, self.pattern_recurrent)
            n_att = L - n_rec
            # recurrent block: in/out proj (2·d·dr), gates (2·dr·dr? -> dr
            # diag), conv (w·dr), lru params; griffin uses dr = d
            rec = 2 * d * d + self.conv_width * d + 3 * d + 2 * d * d
            total += n_rec * (rec + per_dense_ffn + per_norms)
            total += n_att * (per_attn + per_dense_ffn + per_norms)
            return int(total)
        n_moe = 0
        if self.family == "moe":
            n_moe = len([i for i in range(L) if i % self.moe_every ==
                         self.moe_every - 1])
        n_dense = L - n_moe
        total += n_dense * (per_attn + per_dense_ffn + per_norms)
        if n_moe:
            per_moe = d * self.num_experts \
                + self.num_experts * 3 * d * f \
                + (3 * d * f if self.shared_expert else 0)
            total += n_moe * (per_attn + per_moe + per_norms)
        if self.encoder_layers:
            per_enc = per_attn + 2 * d * f + d * f * 0 + per_norms  # gelu mlp
            per_cross = per_attn
            total += self.encoder_layers * per_enc + L * per_cross
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k experts + shared)."""
        if self.family != "moe":
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.num_layers
        hd = self.head_dim
        per_attn = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) \
            + (self.num_heads * hd) * d
        n_moe = len([i for i in range(L) if i % self.moe_every ==
                     self.moe_every - 1])
        n_dense = L - n_moe
        total = self.vocab_size * d
        total += n_dense * (per_attn + 3 * d * f + 2 * d)
        per_moe_active = d * self.num_experts \
            + self.experts_per_token * 3 * d * f \
            + (3 * d * f if self.shared_expert else 0)
        total += n_moe * (per_attn + per_moe_active + 2 * d)
        return int(total)


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 256,
            d_ff: int = 512, vocab: int = 512, experts: int = 4) -> ModelConfig:
    """The smoke-test variant: same family/wiring, tiny dims."""
    heads = 4 if cfg.num_heads else 0
    kv = max(1, min(cfg.num_kv_heads, heads)) if heads else 0
    unit = cfg.pattern_recurrent + cfg.pattern_attn
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        num_layers=max(layers, unit) if unit else layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=d_model // heads if heads else 64,
        d_ff=d_ff,
        vocab_size=vocab,
        num_experts=min(cfg.num_experts, experts) if cfg.num_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2)
        if cfg.experts_per_token else 0,
        rwkv_heads=4 if cfg.rwkv_heads else 0,
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_seq=min(cfg.encoder_seq, 16) if cfg.encoder_seq else 0,
        num_image_tokens=min(cfg.num_image_tokens, 8),
        local_window=min(cfg.local_window, 16),
        sliding_window=min(cfg.sliding_window, 32),
        param_dtype="float32",
        activ_dtype="float32",
    )


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
