"""qwen3-moe-235b-a22b [moe] — 128 experts, top-8, fine-grained experts
(d_ff=1536 per expert), GQA kv=4.  bf16 params/state for HBM fit.
Source: hf:Qwen/Qwen3-30B-A3B (family card) / Qwen3 report."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
    head_dim=128, d_ff=1536, vocab_size=151936,
    num_experts=128, experts_per_token=8, moe_every=1, shared_expert=False,
    param_dtype="bfloat16",
    source="hf:Qwen/Qwen3-30B-A3B",
)
