"""Recurrent sequence mixing on PyTorch: the RG-LRU block
(Griffin / recurrentgemma), same names and casting points as the
reference package's ``models/recurrent.py``.

RG-LRU recurrence (per channel):
    r_t = sigmoid(alpha_r * x_t + beta_r)          (recurrence gate)
    i_t = sigmoid(alpha_i * x_t + beta_i)          (input gate)
    log a_t = -c * softplus(Lambda) * r_t          (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
Training/prefill runs the scan through the LRU-scan kernel's wrapper when
``ctx.use_kernels`` (the CUDA kernel on the card, its plain version on
the CPU), else through a plain associative scan; decode is a single step.
The gates are per-channel (diagonal), as in the reference.

The RWKV6 time-mix of the reference is not ported yet.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import lru_scan as lru_kernel
from .layers import ParallelCtx, _dense_init, gelu

RG_LRU_C = 8.0


def init_rglru(gen: torch.Generator, cfg, device=None) -> dict:
    d = cfg.d_model
    w = cfg.lru_width or d
    w_x = _dense_init(gen, (d, w), device=device)
    w_gate = _dense_init(gen, (d, w), device=device)
    w_out = _dense_init(gen, (w, d), scale=1.0 / math.sqrt(2 * cfg.n_layers),
                        device=device)
    conv_w = _dense_init(gen, (cfg.conv1d_size, w), scale=1.0, device=device)
    # Lambda init so a ~ U(0.9, 0.999)^c at r=1 (griffin's init range)
    u = torch.rand((w,), generator=gen, device=device) * (0.999 - 0.9) + 0.9
    lam = torch.log(torch.expm1(-torch.log(u)))       # softplus^-1(-log u)

    def zeros():
        return torch.zeros((w,), dtype=torch.float32, device=device)
    return {"w_x": w_x, "w_gate": w_gate, "w_out": w_out, "conv_w": conv_w,
            "conv_b": zeros(), "alpha_r": zeros(), "beta_r": zeros(),
            "alpha_i": zeros(), "beta_i": zeros(), "lam": lam.float()}


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) with no linear threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _rglru_gates(p, u: torch.Tensor):
    """u: (..., W) post-conv activations -> (a_t, b_t) of the recurrence
    h_t = a_t h + b_t (all fp32)."""
    uf = u.float()
    r = torch.sigmoid(p["alpha_r"] * uf + p["beta_r"])
    i = torch.sigmoid(p["alpha_i"] * uf + p["beta_i"])
    log_a = -RG_LRU_C * _softplus(p["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * (i * uf)
    return a, b


def _causal_conv(p, x: torch.Tensor) -> torch.Tensor:
    """depthwise causal conv over (B, S, W) with kernel size K."""
    K = p["conv_w"].shape[0]
    S = x.shape[1]
    out = torch.zeros_like(x)
    for j in range(K):
        shifted = F.pad(x, (0, 0, j, 0))[:, :S]
        out = out + shifted * p["conv_w"][K - 1 - j].to(x.dtype)
    return out + p["conv_b"].to(x.dtype)


def associative_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t (h_0 = 0) over axis 1 by log-depth doubling
    with the combine (a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2): the plain
    route of the reference's ``lax.associative_scan``."""
    S = a.shape[1]
    d = 1
    while d < S:
        a_cur, b_cur = a[:, d:], b[:, d:]
        b = torch.cat([b[:, :d], b[:, :-d] * a_cur + b_cur], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a_cur], dim=1)
        d *= 2
    return b


def rglru_layer(p, x: torch.Tensor, cfg, ctx: ParallelCtx,
                return_cache: bool = False):
    """Training/prefill: (B, S, d) -> (B, S, d)."""
    dt = ctx.compute_dtype
    u_pre = x @ p["w_x"].to(dt)                    # (B, S, W) pre-conv
    u = _causal_conv(p, u_pre)
    a, b = _rglru_gates(p, u)
    if ctx.use_kernels:
        h = lru_kernel.lru_scan(a, b)
    else:
        h = associative_scan(a, b)
    gate = gelu(x @ p["w_gate"].to(dt))
    out = (h.to(dt) * gate) @ p["w_out"].to(dt)
    if return_cache:
        K = p["conv_w"].shape[0]
        conv_hist = u_pre[:, -(K - 1):]
        if conv_hist.shape[1] < K - 1:             # S < K-1: left-pad zeros
            pad = K - 1 - conv_hist.shape[1]
            conv_hist = F.pad(conv_hist, (0, 0, pad, 0))
        return out, {"h": h[:, -1].float(), "conv": conv_hist}
    return out


def rglru_decode(p, x: torch.Tensor, cache: dict, cfg, ctx: ParallelCtx):
    """One step. x: (B, 1, d); cache = {'h': (B,W) fp32, 'conv': (B,K-1,W)}.
    The cache tensors are updated **in place** and the same dict returned."""
    dt = ctx.compute_dtype
    u = x @ p["w_x"].to(dt)                        # (B, 1, W)
    hist = torch.cat([cache["conv"].to(dt), u], dim=1)   # (B,K,W)
    uc = torch.einsum("bkw,kw->bw", hist, p["conv_w"].to(dt))[:, None]
    uc = uc + p["conv_b"].to(dt)
    a, b = _rglru_gates(p, uc)                     # (B,1,W)
    h = a[:, 0] * cache["h"] + b[:, 0]
    gate = gelu(x @ p["w_gate"].to(dt))
    out = (h[:, None].to(dt) * gate) @ p["w_out"].to(dt)
    cache["h"].copy_(h)
    cache["conv"].copy_(hist[:, 1:])
    return out, cache


def init_rglru_cache(cfg, B: int, dtype: torch.dtype = torch.bfloat16,
                     device=None) -> dict:
    w = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros((B, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((B, cfg.conv1d_size - 1, w), dtype=dtype,
                                device=device)}
