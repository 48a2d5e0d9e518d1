"""granite-34b [dense] — IBM Granite Code 34B (llama-arch, GQA kv=1).
Source: arXiv:2405.04324 (Granite Code Models)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    num_layers=88, d_model=6144, num_heads=48, num_kv_heads=1,
    head_dim=128, d_ff=24576, vocab_size=49152,
    ffn="gelu",  # GPT-BigCode-style 2-matrix MLP
    source="arXiv:2405.04324",
)
