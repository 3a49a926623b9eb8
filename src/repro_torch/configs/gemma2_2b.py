"""gemma2-2b [dense] — alternating local/global attention + logit softcaps.
[arXiv:2408.00118; hf]"""
from .base import ModelConfig, register

GEMMA2_2B = register(ModelConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv=4, d_ff=9216,
    vocab=256000, head_dim=256,
    layer_pattern=("local", "global"), window=4096,
    attn_softcap=50.0, final_softcap=30.0, act="gelu",
))
