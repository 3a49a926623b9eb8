"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend STUB
(input_specs() provides precomputed patch embeddings occupying the first
n_patches sequence positions). [hf:microsoft/Phi-3-vision-128k-instruct; hf]"""
from .base import ModelConfig, register

PHI3_VISION = register(ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv=32, d_ff=8192,
    vocab=32064, head_dim=96,
    layer_pattern=("global",), act="silu",
    frontend="vision", n_patches=576,
))
