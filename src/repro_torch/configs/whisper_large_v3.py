"""whisper-large-v3 [audio] — encoder-decoder backbone; the conv audio
frontend is a STUB (input_specs() provides precomputed 1500-frame embeddings).
MHA (kv=20). [arXiv:2212.04356; unverified]

Backbone deviations (documented in DESIGN.md): rotary embeddings instead of
learned absolute positions; gated MLP instead of plain GELU MLP."""
from .base import ModelConfig, register

WHISPER_LARGE_V3 = register(ModelConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv=20, d_ff=5120,
    vocab=51866, head_dim=64,
    layer_pattern=("global",), act="gelu",
    encoder_layers=32, cross_attn=True, src_seq=1500,
    frontend="audio", tie_embeddings=True,
))
