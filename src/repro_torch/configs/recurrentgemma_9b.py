"""recurrentgemma-9b [hybrid] — Griffin: RG-LRU recurrent blocks + local
attention, 1 attention : 2 recurrent. MQA (kv=1). [arXiv:2402.19427; unverified]"""
from .base import ModelConfig, register

RECURRENTGEMMA_9B = register(ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv=1, d_ff=12288,
    vocab=256000, head_dim=256,
    layer_pattern=("rglru", "rglru", "local"), window=2048,
    lru_width=4096, conv1d_size=4, act="gelu",
))
