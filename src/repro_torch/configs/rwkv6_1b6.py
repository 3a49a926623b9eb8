"""rwkv6-1.6b [ssm] — Finch: attention-free, data-dependent decay WKV.
[arXiv:2404.05892; unverified]

The channel-mix FFN is realized as a gated MLP of the listed d_ff; the
time-mix keeps RWKV6's data-dependent decay (w from a low-rank projection)
and the bonus-u term; token-shift uses static learned mix ratios."""
from .base import ModelConfig, register

RWKV6_1B6 = register(ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv=32, d_ff=7168,
    vocab=65536, head_dim=64,
    layer_pattern=("rwkv",), act="silu",
))
