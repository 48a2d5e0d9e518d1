"""llama4-maverick-400b-a17b [moe] — 128 routed experts top-1 + shared
expert, MoE on alternating layers (interleave step 2), early-fusion
multimodal (text path modeled; GQA kv=8).  bf16 params/state so the
FSDPxTP-sharded train state fits v5e HBM.
Source: hf:meta-llama/Llama-4-Scout-17B-16E (family card) / Llama 4 blog."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    head_dim=128, d_ff=8192, vocab_size=202048,
    num_experts=128, experts_per_token=1, moe_every=2, shared_expert=True,
    param_dtype="bfloat16",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
