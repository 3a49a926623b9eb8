"""Recurrent sequence mixing on PyTorch: the RG-LRU block
(Griffin / recurrentgemma) and the RWKV6 (Finch) time-mix, same names and
casting points as the reference package's ``models/recurrent.py``.

RG-LRU recurrence (per channel):
    r_t = sigmoid(alpha_r * x_t + beta_r)          (recurrence gate)
    i_t = sigmoid(alpha_i * x_t + beta_i)          (input gate)
    log a_t = -c * softplus(Lambda) * r_t          (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
Training/prefill runs the scan through the LRU-scan kernel's wrapper when
``ctx.use_kernels`` (the CUDA kernel on the card, its plain version on
the CPU), else through a plain associative scan; decode is a single step.
The gates are per-channel (diagonal), as in the reference.

RWKV6 time-mix: data-dependent per-channel decay w_t from a low-rank
projection; state S (dk x dv) per head:
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
Training/prefill uses the reference's exact chunked form (``wkv_chunked``,
module code: the reference has no kernel for it); decode is one step.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..kernels import lru_scan as lru_kernel
from ..launch.sharding import spec_placements
from .layers import (ParallelCtx, _dense_init, gelu, init_norm, local_param,
                     merge_heads, rms_norm, rows_and_heads, split_heads)

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
    for j in range(min(K, S)):
        # x delayed by j steps, zeros first (a shift past S adds only zeros)
        shifted = x if j == 0 else torch.cat(
            [torch.zeros_like(x[:, :j]), x[:, :S - j]], dim=1)
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
    u_pre = ctx.proj(x, p["w_x"])                      # (B, S, W) pre-conv
    u = _causal_conv(p, u_pre)
    a, b = _rglru_gates(p, u)
    if ctx.use_kernels:
        h = lru_kernel.lru_scan(a, b)
    else:
        h = associative_scan(a, b)
    gate = gelu(ctx.proj(x, p["w_gate"]))
    out = ctx.proj(h.to(dt) * gate, p["w_out"])
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
    u = ctx.proj(x, p["w_x"])                          # (B, 1, W)
    hist = torch.cat([cache["conv"].to(dt), u], dim=1)   # (B,K,W)
    uc = torch.einsum("bkw,kw->bw", hist, p["conv_w"].to(dt))[:, None]
    uc = uc + p["conv_b"].to(dt)
    a, b = _rglru_gates(p, uc)                     # (B,1,W)
    h = a[:, 0] * cache["h"] + b[:, 0]
    gate = gelu(ctx.proj(x, p["w_gate"]))
    out = ctx.proj(h[:, None].to(dt) * gate, p["w_out"])
    cache["h"].copy_(h)
    cache["conv"].copy_(hist[:, 1:])
    return out, cache


def init_rglru_cache(cfg, B: int, dtype: torch.dtype = torch.bfloat16,
                     device=None) -> dict:
    w = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros((B, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((B, cfg.conv1d_size - 1, w), dtype=dtype,
                                device=device)}


# ---------------------------------------------------------------------------
# RWKV6 time-mix
# ---------------------------------------------------------------------------
W_LORA_RANK = 64


def init_rwkv(gen: torch.Generator, cfg, device=None) -> dict:
    d = cfg.d_model
    H, hd = cfg.n_heads, cfg.hd
    if H * hd != d:
        raise ValueError("rwkv requires n_heads*head_dim == d_model")

    def dense(shape, scale=1.0):
        return _dense_init(gen, shape, scale=scale, device=device)
    return {
        # token-shift mixes (r, k, v, w, g)
        "mu": torch.full((5, d), 0.5, dtype=torch.float32, device=device),
        "w_r": dense((d, d)),
        "w_k": dense((d, d)),
        "w_v": dense((d, d)),
        "w_g": dense((d, d)),
        "w_o": dense((d, d), scale=1.0 / math.sqrt(2 * cfg.n_layers)),
        "w_lora_a": dense((d, W_LORA_RANK)),
        "w_lora_b": dense((W_LORA_RANK, d), scale=0.1),
        # decay bias (w ~ 0.87)
        "w_bias": torch.full((d,), -2.0, dtype=torch.float32, device=device),
        "u": dense((H, hd)),
        "ln_out": init_norm(d, device),
    }


def _rwkv_project(p, x: torch.Tensor, x_prev: torch.Tensor, cfg,
                  ctx: ParallelCtx):
    """Token-shift + projections. x, x_prev: (B, S, d); r, k, v and the
    decay come out (B, S, H, hd) (``split_heads``)."""
    dt = ctx.compute_dtype
    H, hd = cfg.n_heads, cfg.hd
    mu = p["mu"].to(dt)
    xs = [x + mu[i] * (x_prev - x) for i in range(5)]
    r = split_heads(ctx, ctx.proj(xs[0], p["w_r"]), H, hd)
    k = split_heads(ctx, ctx.proj(xs[1], p["w_k"]), H, hd)
    v = split_heads(ctx, ctx.proj(xs[2], p["w_v"]), H, hd)
    w_raw = ctx.proj(ctx.proj(xs[3], p["w_lora_a"]), p["w_lora_b"])
    log_w = -torch.exp(torch.clamp(w_raw.float() + p["w_bias"],
                                   -8.0, 8.0))               # (B,S,d) <= 0
    log_w = split_heads(ctx, log_w, H, hd)
    g = F.silu(ctx.proj(xs[4], p["w_g"]))
    return r, k, v, log_w, g


def _shift(x: torch.Tensor) -> torch.Tensor:
    """x delayed one step along axis 1, zeros first (by ``cat``: DTensor
    has no sharding rule for the pad of a sharded tensor)."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


# "factored" (default): per-row decay factors, no pairwise tensor.
# "pairwise": materializes the (B, c, c, H, hd) decay tensor -- the
# reference for the factored form's tests.
WKV_FORM = "factored"
# chunk length (the reference's, settled on 64)
WKV_CHUNK = 64


def wkv_chunked(r, k, v, log_w, u, chunk: int = 16,
                state0: Optional[torch.Tensor] = None,
                form: Optional[str] = None):
    """Chunked WKV6 scan, the reference's two forms.

    r, k, v, log_w: (B, S, H, hd); u: (H, hd).  Returns (out fp32, final
    state) with state (B, H, hd_k, hd_v) fp32.  The chunk is ``chunk``, or
    gcd(S, chunk) where ``chunk`` does not divide S.

    The factored form writes the intra-chunk decay exp(lwprev[t] -
    lwcum[i]) as exp(lwprev[t] - E) * exp(E - lwcum[i]) relative to the
    chunk end E: the k-side factor is <= 1 and the r-side exponent is
    clamped at +40, as in the reference.  That is the recurrence while a
    chunk's total decay stays above e^-40; past it, a pair of near
    neighbours gets e^40 times a k-side factor far below e^-40 and is
    lost, in the reference as here.  The pairwise form materializes the
    decays, clipped to [-60, 0], and is the recurrence throughout.

    Everything within a chunk is computed for all chunks at once (a chunk
    axis beside the batch); only the carried state runs chunk by chunk,
    S_{j+1} = diag(exp E_j) S_j + sum_i diag(decay_i->end) k_i v_i, one
    fused multiply-add per chunk, as the reference's scan carries it.
    """
    B, S, H, hd = r.shape
    c = math.gcd(S, chunk) if S % min(chunk, S) else min(chunk, S)
    n = S // c
    f32 = torch.float32
    rc, kc, vc, lw = (a.reshape(B, n, c, H, hd).to(f32)
                      for a in (r, k, v, log_w))
    lw_cum = torch.cumsum(lw, dim=2)                   # lw_1..t inclusive
    lw_prev = lw_cum - lw                              # lw_1..t-1
    E = lw_cum[:, :, -1:]                              # (B,n,1,H,hd) chunk total
    k_fac = kc * torch.exp(E - lw_cum)                 # decay i -> chunk end
    if (form or WKV_FORM) == "pairwise":
        decay = torch.exp(torch.clamp(
            lw_prev[:, :, :, None] - lw_cum[:, :, None, :], -60.0, 0.0))
        score = torch.einsum("bnthd,bnihd,bntihd->bnhti", rc, kc, decay)
    else:
        r_fac = rc * torch.exp(torch.clamp_max(lw_prev - E, 40.0))
        score = torch.einsum("bnthd,bnihd->bnhti", r_fac, k_fac)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                     diagonal=-1)                      # strictly causal (i < t)
    score = score * tri
    # bonus (i == t) term with u
    bonus = torch.einsum("bnthd,hd,bnthd->bnth", rc, u.to(f32), kc)
    o = torch.einsum("bnhti,bnihd->bnthd", score, vc)
    o = o + bonus[..., None] * vc
    # the state each chunk starts from: S' = diag(prod w) S + sum_i
    # diag(decay_i->end) k_i v_i
    kv = torch.einsum("bnihk,bnihv->bnhkv", k_fac, vc)
    w_end = torch.exp(E[:, :, 0])[..., None]           # (B,n,H,hd,1)
    state = (torch.zeros((B, H, hd, hd), dtype=f32, device=r.device)
             if state0 is None else state0)
    starts = []
    for j in range(n):
        starts.append(state)
        state = torch.addcmul(kv[:, j], state, w_end[:, j])
    # inter-chunk: r_t decayed back to its chunk's start hits that state
    r_dec = rc * torch.exp(lw_prev)
    o = o + torch.einsum("bnthk,bnhkv->bnthv", r_dec,
                         torch.stack(starts, dim=1))
    return o.reshape(B, S, H, hd), state


def _wkv_by_heads(ctx: ParallelCtx, r, k, v, log_w, u, chunk: int):
    """``wkv_chunked`` run by each rank on its own rows and heads, where
    the mesh splits both evenly (``layers.rows_and_heads``): the
    recurrence is independent across rows and heads, so nothing crosses
    ranks, and DTensor never sees its ops (it has no rule for the flip in
    ``cumsum``'s backward, and would gather).  Elsewhere on the tensors as
    given."""
    placements = rows_and_heads(ctx, r)
    if placements is None:
        return wkv_chunked(r, k, v, log_w, u, chunk=chunk)
    ba, m = ctx.batch_axes or None, ctx.model_axis
    local = [ctx.shard(t, ba, None, m, None).to_local()
             for t in (r, k, v, log_w)]
    o, state = wkv_chunked(*local, local_param(ctx, u, m, None), chunk=chunk)
    return (DTensor.from_local(o, ctx.mesh, placements, run_check=False),
            DTensor.from_local(state, ctx.mesh, spec_placements(
                ctx.mesh, (ba, m, None, None)), run_check=False))


def rwkv_layer(p, x: torch.Tensor, cfg, ctx: ParallelCtx,
               chunk: Optional[int] = None, return_cache: bool = False):
    dt = ctx.compute_dtype
    r, k, v, log_w, g = _rwkv_project(p, x, _shift(x), cfg, ctx)
    o, state = _wkv_by_heads(ctx, r, k, v, log_w, p["u"], chunk or WKV_CHUNK)
    o = rms_norm(merge_heads(ctx, o).to(dt), p["ln_out"], cfg.norm_eps)
    out = ctx.proj(o * g, p["w_o"])
    if return_cache:
        return out, {"state": state, "x_prev": x[:, -1:]}
    return out


def _wkv_step(rt, kt, vt, w, S0, u):
    """One WKV step: rt, kt, vt, w (B, H, hd); S0 (B, H, hd, hd)."""
    o = torch.einsum("bhk,bhkv->bhv", rt, S0)
    bonus = torch.einsum("bhk,hk,bhk->bh", rt, u.float(), kt)
    o = o + bonus[..., None] * vt
    S1 = S0 * w[..., None] + torch.einsum("bhk,bhv->bhkv", kt, vt)
    return o, S1


def _wkv_step_by_heads(ctx: ParallelCtx, rt, kt, vt, w, S0, u):
    """``_wkv_step`` run by each rank on its own rows and heads, as
    ``_wkv_by_heads`` runs the chunked form; elsewhere on the tensors as
    given."""
    placements = rows_and_heads(ctx, rt, heads=1)
    if placements is None:
        return _wkv_step(rt, kt, vt, w, S0, u)
    ba, m, mesh = ctx.batch_axes or None, ctx.model_axis, ctx.mesh
    local = [ctx.shard(t, ba, m, None).to_local() for t in (rt, kt, vt, w)]
    o, S1 = _wkv_step(*local, ctx.shard(S0, ba, m, None, None).to_local(),
                      local_param(ctx, u, m, None))
    return (DTensor.from_local(o, mesh, placements, run_check=False),
            DTensor.from_local(S1, mesh, spec_placements(
                mesh, (ba, m, None, None)), run_check=False))


def rwkv_decode(p, x: torch.Tensor, cache: dict, cfg, ctx: ParallelCtx):
    """One step. x: (B, 1, d); cache = {'state': (B,H,hd,hd) fp32,
    'x_prev': (B,1,d)}, updated **in place** and the same dict returned."""
    dt = ctx.compute_dtype
    r, k, v, log_w, g = _rwkv_project(p, x, cache["x_prev"].to(dt), cfg,
                                      ctx)
    rt, kt, vt = (a[:, 0].float() for a in (r, k, v))
    w = torch.exp(log_w[:, 0])                            # (B,H,hd)
    o, S1 = _wkv_step_by_heads(ctx, rt, kt, vt, w, cache["state"], p["u"])
    o = rms_norm(merge_heads(ctx, o)[:, None].to(dt), p["ln_out"],
                 cfg.norm_eps)
    out = ctx.proj(o * g, p["w_o"])
    cache["state"].copy_(S1)
    cache["x_prev"].copy_(x)
    return out, cache


def init_rwkv_cache(cfg, B: int, dtype: torch.dtype = torch.bfloat16,
                    device=None) -> dict:
    H, hd = cfg.n_heads, cfg.hd
    return {"state": torch.zeros((B, H, hd, hd), dtype=torch.float32,
                                 device=device),
            "x_prev": torch.zeros((B, 1, cfg.d_model), dtype=dtype,
                                  device=device)}
