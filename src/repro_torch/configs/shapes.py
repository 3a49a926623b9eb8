"""Assigned input shapes and their data-input specs, as in the reference
package's ``configs/shapes.py``.

LM transformer shapes are seq_len x global_batch.  ``decode_*`` /
``long_*`` are one new token against a KV cache of seq_len, not a
training step.  ``long_500k`` requires sub-quadratic attention and only
runs for recurrentgemma-9b / rwkv6-1.6b.

:func:`input_specs` returns a :class:`TensorSpec` -- a frozen (shape,
dtype) pair -- for every data input, the counterpart of the reference's
``jax.ShapeDtypeStruct``: nothing is allocated.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .base import ModelConfig, all_configs


@dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    mode: str          # "train" | "prefill" | "decode"


@dataclass(frozen=True)
class TensorSpec:
    """The shape and dtype of one data input."""

    shape: tuple
    dtype: torch.dtype


SHAPES: dict[str, Shape] = {
    "train_4k": Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: Shape) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch, shape) cell."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention layers in pattern -> quadratic at 500k; "
                       "skipped per assignment (run only for SSM/hybrid)")
    return True, ""


def cells(include_skipped: bool = False) -> list[tuple[str, str, bool, str]]:
    """All (arch, shape, runs, reason) cells in assignment order."""
    out = []
    for arch, cfg in all_configs().items():
        for shape in SHAPES.values():
            ok, why = shape_applicable(cfg, shape)
            if ok or include_skipped:
                out.append((arch, shape.name, ok, why))
    return out


def input_specs(cfg: ModelConfig, shape: Shape,
                dtype: torch.dtype = torch.bfloat16) -> dict[str, TensorSpec]:
    """A :class:`TensorSpec` for every *data* input of the step: tokens
    (and labels, or decode positions) by mode, and the modality stubs'
    precomputed embeddings (``frames`` for audio, ``patches`` for vision
    outside decode)."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    specs: dict[str, TensorSpec] = {}
    if shape.mode == "train":
        specs["tokens"] = TensorSpec((B, S), i32)
        specs["labels"] = TensorSpec((B, S), i32)
    elif shape.mode == "prefill":
        specs["tokens"] = TensorSpec((B, S), i32)
    else:  # decode: one new token against a cache of S
        specs["tokens"] = TensorSpec((B, 1), i32)
        specs["positions"] = TensorSpec((B,), i32)
    # modality frontend stubs provide precomputed embeddings
    if cfg.frontend == "audio":
        specs["frames"] = TensorSpec((B, cfg.src_seq, cfg.d_model), dtype)
    elif cfg.frontend == "vision" and shape.mode != "decode":
        specs["patches"] = TensorSpec((B, cfg.n_patches, cfg.d_model), dtype)
    return specs
