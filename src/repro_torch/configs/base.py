"""Model configuration + registry for the assigned architectures (plain
data; the same records as the reference package's ``configs/base.py``)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

# layer kinds usable in ``layer_pattern``
LAYER_KINDS = ("global", "local", "rglru", "rwkv", "enc")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | audio | ssm | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default: d_model // n_heads
    # attention structure
    layer_pattern: tuple[str, ...] = ("global",)   # cycled across layers
    window: int = 1024                             # sliding-window span
    attn_softcap: Optional[float] = None           # gemma2 logit softcapping
    final_softcap: Optional[float] = None
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1          # layer i is MoE iff n_experts>0 and i % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    moe_group: int = 1024       # GShard dispatch group size (placement-tuned)
    moe_impl: str = "einsum"    # "einsum" (GSPMD-partitionable) | "scatter"
    # recurrent blocks
    lru_width: Optional[int] = None
    conv1d_size: int = 4
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    cross_attn: bool = False
    src_seq: int = 1500         # encoder positions (whisper 30 s -> 1500 frames)
    # modality frontend stub
    frontend: Optional[str] = None   # None | "audio" | "vision"
    n_patches: int = 576             # vlm patch positions carved at seq start
    # numerics
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    act: str = "gelu"                # mlp gate activation: gelu | silu

    # ---- derived -----------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    def kind_of_layer(self, i: int) -> str:
        return self.layer_pattern[i % len(self.layer_pattern)]

    def is_moe_layer(self, i: int) -> bool:
        return self.n_experts > 0 and (i % self.moe_every) == self.moe_offset

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return all(k in ("rglru", "rwkv") for k in self.layer_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True if no layer needs full-sequence quadratic attention
        (pure local windows / recurrent) -> eligible for long_500k."""
        return all(k in ("rglru", "rwkv", "local") for k in self.layer_pattern)

    def scaled(self, **overrides) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        pat = self.layer_pattern
        return self.scaled(
            name=self.name + "-smoke",
            n_layers=max(2, len(pat)),
            d_model=64,
            n_heads=max(2, min(4, self.n_heads)),
            n_kv=1 if self.n_kv == 1 else 2,
            head_dim=16,
            d_ff=128,
            vocab=512,
            window=16,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            lru_width=32 if self.lru_width else None,
            encoder_layers=2 if self.encoder_layers else 0,
            src_seq=24 if self.encoder_layers else self.src_seq,
            n_patches=8 if self.frontend == "vision" else self.n_patches,
        )

    # params count (for 6ND model-flops accounting)
    def param_count(self) -> int:
        d, ff, V, hd = self.d_model, self.d_ff, self.vocab, self.hd
        n_q, n_kv = self.n_heads, self.n_kv
        total = V * d                       # embedding
        if not self.tie_embeddings:
            total += V * d
        for i in range(self.n_layers):
            kind = self.kind_of_layer(i)
            if kind in ("global", "local", "enc"):
                total += d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d
            elif kind == "rglru":
                w = self.lru_width or d
                total += 2 * d * w + w * d          # in(x2: x&gate), out proj
                total += w * self.conv1d_size + 3 * w   # conv + lru gates
            elif kind == "rwkv":
                total += 5 * d * d                      # r,k,v,g,o projections
                total += 2 * d * 64                     # w lora (rank 64)
                total += 7 * d + n_q * hd               # mu, bias, ln, u
            if self.cross_attn and kind == "global" and self.is_encdec:
                total += d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d
            if self.is_moe_layer(i):
                total += self.n_experts * 3 * d * ff + d * self.n_experts
            else:
                total += 3 * d * ff     # gated mlp (rwkv channel-mix incl.)
            total += 2 * d                               # norms
        for _ in range(self.encoder_layers):
            total += d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d
            total += 3 * d * ff + 2 * d
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts instead of all)."""
        if self.n_experts == 0:
            return self.param_count()
        full = self.param_count()
        n_moe = sum(1 for i in range(self.n_layers) if self.is_moe_layer(i))
        all_exp = n_moe * self.n_experts * 3 * self.d_model * self.d_ff
        act_exp = n_moe * max(1, self.top_k) * 3 * self.d_model * self.d_ff
        return full - all_exp + act_exp


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def all_configs() -> dict[str, ModelConfig]:
    if not _REGISTRY:
        _load_all()
    return dict(_REGISTRY)


def _load_all() -> None:
    from . import archs  # noqa: F401  (registers everything)
