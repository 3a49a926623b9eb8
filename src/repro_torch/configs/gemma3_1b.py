"""gemma3-1b [dense] — 5:1 local:global, MQA (kv=1), 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
from .base import ModelConfig, register

GEMMA3_1B = register(ModelConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv=1, d_ff=6912,
    vocab=262144, head_dim=256,
    layer_pattern=("local",) * 5 + ("global",), window=512,
    rope_theta=1_000_000.0, qk_norm=True, act="gelu",
))
