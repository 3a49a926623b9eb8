"""Gradient compression: blockwise int8 quantization with error feedback
(the reference package's ``optim/compress.py`` on PyTorch).

Each leaf is flattened, padded to blocks of :data:`BLOCK` values and
quantized to int8 with one float32 scale per block (the block's largest
magnitude over 127); the quantization residual is carried in an
error-feedback buffer, so the compression is unbiased over time.
``torch.round`` rounds half to even, as ``jnp.round`` does, so the
payload and the scales are bit-equal to the reference's.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from .. import tree as tr

Tree = Any
BLOCK = 256


def _pad_to(x: torch.Tensor, m: int) -> torch.Tensor:
    flat = x.reshape(-1)
    return F.pad(flat, (0, (-flat.numel()) % m))


def quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """g -> (int8 payload (blocks, BLOCK), per-block float32 scales)."""
    flat = _pad_to(g.float(), BLOCK).reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(flat), dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(flat / torch.clamp_min(scale, 1e-12)),
                    -127, 127)
    return q.to(torch.int8), scale[:, 0]


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape,
               dtype: torch.dtype) -> torch.Tensor:
    flat = q.float() * scale[:, None]
    n = math.prod(shape)
    return flat.reshape(-1)[:n].reshape(shape).to(dtype)


def compress_grads(grads: Tree, error: Tree) -> tuple[Tree, Tree]:
    """Returns (compressed-then-decompressed grads, new error buffers).

    ``error`` is a tree of float32 buffers shaped like grads (init zeros,
    :func:`init_error`)."""
    deq, err = [], []
    g_leaves, e_leaves = tr.leaves(grads), tr.leaves(error)
    if len(g_leaves) != len(e_leaves):
        raise ValueError("grads and error differ in structure")
    for g, e in zip(g_leaves, e_leaves):
        target = g.float() + e
        q, s = quantize(target)
        d = dequantize(q, s, tuple(g.shape), torch.float32)
        deq.append(d.to(g.dtype))
        err.append(target - d)
    return tr.unflatten(grads, deq), tr.unflatten(grads, err)


def init_error(grads_like: Tree) -> Tree:
    return tr.tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                             device=g.device), grads_like)


def compressed_bytes(grads: Tree) -> int:
    """Bytes after compression (int8 payload + float32 block scales)."""
    total = 0
    for g in tr.leaves(grads):
        n = g.numel()
        total += n + 4 * (-(-n // BLOCK))
    return total
