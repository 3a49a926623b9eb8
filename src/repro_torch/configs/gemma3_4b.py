"""gemma3-4b [dense] — 5:1 local:global interleave, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
from .base import ModelConfig, register

GEMMA3_4B = register(ModelConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv=4, d_ff=10240,
    vocab=262144, head_dim=256,
    layer_pattern=("local",) * 5 + ("global",), window=1024,
    rope_theta=1_000_000.0, qk_norm=True, act="gelu",
))
