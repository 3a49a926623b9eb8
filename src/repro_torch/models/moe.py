"""Mixture-of-Experts layer on PyTorch: capacity-bounded top-k routing,
with the reference package's names, routing and casting points
(``models/moe.py``).

Two dispatch implementations, selected by ``cfg.moe_impl``:

* ``einsum`` (the default) -- GShard-style one-hot dispatch / combine
  tensors of shape (G, g, E, C), contracted by ``torch.einsum``;
* ``scatter`` -- a scatter-add dispatch (``index_put_`` with
  ``accumulate=True``) and a gather combine: no one-hot tensors, the same
  routing.

Routing (identical in both): the router's logits are soft-maxed in
float32; each token's top-k experts are taken by a stable descending
sort, so that ties go to the lower expert index, as ``jax.lax.top_k``
breaks them (``torch.topk`` promises no order on ties).  Within a group of
``g`` tokens the capacity is C = ceil(g * cf * k / E); slot s of token t
claims position ``running_count[expert]`` if below C, else the token-slot
is dropped (the scatter form parks it in an overflow bin C, whose expert
output is zero).  The expert products run as plain ``torch.einsum``: the
reference computes them outside any Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .layers import ParallelCtx, _dense_init, gelu


def init_moe(gen: torch.Generator, cfg, device=None) -> dict:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": _dense_init(gen, (d, E), device=device),
        "wg": _dense_init(gen, (E, d, ff), device=device),
        "wu": _dense_init(gen, (E, d, ff), device=device),
        "wd": _dense_init(gen, (E, ff, d),
                          scale=1.0 / math.sqrt(2 * cfg.n_layers),
                          device=device),
    }


def _route(logits: torch.Tensor, k: int):
    """logits (..., E) -> (gate_vals (..., k) fp32, expert_idx (..., k))."""
    probs = torch.softmax(logits.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    vals = vals / torch.clamp_min(vals.sum(-1, keepdim=True), 1e-9)  # renormalize
    return vals, idx


def _group(cfg, tokens: int, group: Optional[int]) -> tuple[int, int, int]:
    g = min(group if group is not None else cfg.moe_group, tokens)
    while tokens % g != 0:       # shapes are powers of two; this terminates
        g //= 2
    G = tokens // g
    C = max(1, math.ceil(g * cfg.capacity_factor * max(1, cfg.top_k)
                         / cfg.n_experts))
    return G, g, C


def _one_hot(x: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot(x, n)`` as int64: a value outside [0, n) gets an
    all-zero row (``F.one_hot`` raises there)."""
    return (x[..., None] == torch.arange(n, device=x.device)).long()


def _aux_loss(logits: torch.Tensor, idx: torch.Tensor, E: int) -> torch.Tensor:
    """Switch-style load-balance loss over the full batch."""
    probs_mean = torch.softmax(logits.float(), -1).mean((0, 1))
    frac = _one_hot(idx[..., 0], E).float().mean((0, 1))
    return E * torch.sum(probs_mean * frac)


def _expert_ffn(p, xin: torch.Tensor, cfg, dt) -> torch.Tensor:
    """xin: (..., E, C, d) -> (..., E, C, d) through per-expert gated MLP."""
    act = gelu if cfg.act == "gelu" else F.silu
    h = act(torch.einsum("...ecd,edf->...ecf", xin, p["wg"].to(dt)))
    h = h * torch.einsum("...ecd,edf->...ecf", xin, p["wu"].to(dt))
    return torch.einsum("...ecf,efd->...ecd", h, p["wd"].to(dt))


def _slot_positions(oh: torch.Tensor, prev_counts: torch.Tensor):
    """Each token's position in its expert's queue for one slot: the count
    of earlier tokens of the group sent there (this slot) plus the claims of
    earlier slots.  oh (G, g, E) int one-hot; prev_counts (G, E)."""
    return torch.cumsum(oh, dim=1) - oh + prev_counts[:, None, :]


# ---------------------------------------------------------------------------
# einsum (GShard) dispatch
# ---------------------------------------------------------------------------
def moe_layer_einsum(p, x: torch.Tensor, cfg, ctx: ParallelCtx,
                     group: Optional[int] = None):
    dt = ctx.compute_dtype
    B, S, d = x.shape
    E, k = cfg.n_experts, max(1, cfg.top_k)
    G, g, C = _group(cfg, B * S, group)

    xg = x.reshape(G, g, d)
    logits = xg @ p["router"].to(dt)                         # (G, g, E)
    gate_vals, idx = _route(logits, k)
    aux = _aux_loss(logits, idx, E)

    # per-slot dispatch with capacity-priority across slots
    disp = torch.zeros((G, g, E, C), dtype=dt, device=x.device)
    comb = torch.zeros((G, g, E, C), dtype=torch.float32, device=x.device)
    prev_counts = torch.zeros((G, E), dtype=torch.long, device=x.device)
    for slot in range(k):
        oh = _one_hot(idx[..., slot], E)                     # (G, g, E)
        pos = _slot_positions(oh, prev_counts)
        keep = (pos < C) & (oh > 0)
        pos_oh = _one_hot(pos, C).to(dt) * keep[..., None].to(dt)
        slot_disp = oh[..., None].to(dt) * pos_oh           # (G,g,E,C)
        disp = disp + slot_disp
        comb = comb + slot_disp.float() * gate_vals[..., slot][..., None, None]
        prev_counts = prev_counts + torch.sum(oh * keep, dim=1)

    # dispatch -> expert FFN -> combine.  On a mesh, the constraints
    # implement EP: groups shard over the batch axes, experts over the
    # model axis; the G<->E resharding of xin/out_e is expert parallelism's
    # all-to-all.
    ba = ctx.batch_axes or None
    disp = ctx.shard(disp, ba, None, ctx.model_axis, None)
    comb = ctx.shard(comb, ba, None, ctx.model_axis, None)
    xin = torch.einsum("gsec,gsd->gecd", disp, xg)           # (G, E, C, d)
    xin = ctx.shard(xin, ba, ctx.model_axis, None, None)
    out_e = _expert_ffn(p, xin, cfg, dt)                     # (G, E, C, d)
    out_e = ctx.shard(out_e, ba, ctx.model_axis, None, None)
    out = torch.einsum("gsec,gecd->gsd", comb.to(dt), out_e)
    return out.reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# scatter/gather dispatch
# ---------------------------------------------------------------------------
def moe_layer_scatter(p, x: torch.Tensor, cfg, ctx: ParallelCtx,
                      group: Optional[int] = None):
    dt = ctx.compute_dtype
    B, S, d = x.shape
    E, k = cfg.n_experts, max(1, cfg.top_k)
    G, g, C = _group(cfg, B * S, group)

    xg = x.reshape(G, g, d)
    logits = xg @ p["router"].to(dt)
    gate_vals, idx = _route(logits, k)
    aux = _aux_loss(logits, idx, E)

    gidx = torch.arange(G, device=x.device)[:, None].expand(G, g)
    prev_counts = torch.zeros((G, E), dtype=torch.long, device=x.device)
    slot_pos, slot_keep = [], []
    for slot in range(k):
        e_s = idx[..., slot]                                 # (G, g)
        oh = _one_hot(e_s, E)                                # (G, g, E)
        pos = _slot_positions(oh, prev_counts)
        pos_tok = torch.gather(pos, -1, e_s[..., None])[..., 0]
        keep = pos_tok < C
        slot_pos.append(torch.where(keep, pos_tok, C))       # C = overflow bin
        slot_keep.append(keep)
        prev_counts = prev_counts + torch.sum(oh * keep[..., None], dim=1)

    xin = torch.zeros((G, E, C + 1, d), dtype=dt, device=x.device)
    for slot in range(k):
        xin.index_put_((gidx, idx[..., slot], slot_pos[slot]),
                       torch.where(slot_keep[slot][..., None], xg,
                                   torch.zeros((), dtype=dt, device=x.device)),
                       accumulate=True)
    out_e = _expert_ffn(p, xin[:, :, :C], cfg, dt)           # (G, E, C, d)
    out_e = F.pad(out_e, (0, 0, 0, 1))                       # overflow -> 0

    out = torch.zeros((G, g, d), dtype=dt, device=x.device)
    for slot in range(k):
        y = out_e[gidx, idx[..., slot], slot_pos[slot]]      # (G, g, d)
        w = (gate_vals[..., slot] * slot_keep[slot])[..., None].to(dt)
        out = out + y * w
    return out.reshape(B, S, d), aux


def moe_layer(p, x: torch.Tensor, cfg, ctx: ParallelCtx,
              group: Optional[int] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss).  Impl chosen by cfg.moe_impl
    ('einsum' | 'scatter'), einsum by default."""
    impl = getattr(cfg, "moe_impl", "einsum")
    fn = moe_layer_scatter if impl == "scatter" else moe_layer_einsum
    return fn(p, x, cfg, ctx, group)
