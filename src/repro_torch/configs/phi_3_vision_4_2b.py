"""phi-3-vision-4.2b [vlm] — phi3-mini text backbone + CLIP vision stub.
The ViT/projector frontend is a STUB per the assignment carve-out
(input_specs supplies patch embeddings, 576 image tokens).
Source: hf:microsoft/Phi-3-vision-128k-instruct."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    head_dim=96, d_ff=8192, vocab_size=32064,
    num_image_tokens=576,
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)
