"""granite-8b [dense] — IBM Granite Code 8B (llama-arch, GQA kv=8).
Source: arXiv:2405.04324 (Granite Code Models)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b", family="dense",
    num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=49152,
    source="arXiv:2405.04324",
)
