"""rwkv6-7b [ssm] — RWKV-6 "Finch" 7B: attention-free, data-dependent
decay time-mix + channel-mix.  Source: arXiv:2404.05892."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    num_layers=32, d_model=4096, num_heads=0, num_kv_heads=0,
    head_dim=64, d_ff=14336, vocab_size=65536,
    rwkv_heads=64,
    source="arXiv:2404.05892",
)
