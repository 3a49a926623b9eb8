"""llama4-maverick-400b-a17b [moe] — MoE 128e top-1 on every other layer
(interleaved MoE matches the 400B-total / 17B-active budget), early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Note: the assignment lists d_ff=8192 — used for both the per-expert FFN and
the dense layers' FFN."""
from .base import ModelConfig, register

LLAMA4_MAVERICK = register(ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv=8, d_ff=8192,
    vocab=202048, head_dim=128,
    layer_pattern=("global",), act="silu",
    n_experts=128, top_k=1, moe_every=2, moe_offset=1, moe_group=256,
    rope_theta=500_000.0,
))
