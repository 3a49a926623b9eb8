"""granite-moe-1b-a400m [moe] — 32 experts top-8, tiny experts (d_ff=512):
a dispatch-overhead stress test. [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from .base import ModelConfig, register

GRANITE_MOE = register(ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv=8, d_ff=512,
    vocab=49155, head_dim=64,
    layer_pattern=("global",), act="silu",
    n_experts=32, top_k=8, moe_every=1, moe_group=64,
))
