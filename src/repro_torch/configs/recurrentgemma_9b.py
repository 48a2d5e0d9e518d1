"""recurrentgemma-9b [hybrid] — Griffin architecture: RG-LRU recurrent
blocks + local attention, repeating (2 recurrent : 1 local-attn) per the
1:2 attention:recurrent ratio.  GQA kv=1 on the attention blocks,
local window 2048.  Source: arXiv:2402.19427 (Griffin/RecurrentGemma)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    head_dim=256, d_ff=12288, vocab_size=256000,
    pattern_recurrent=2, pattern_attn=1, local_window=2048, conv_width=4,
    source="arXiv:2402.19427",
)
