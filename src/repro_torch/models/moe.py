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

from torch.distributed.tensor import DTensor, Partial

from ..launch.sharding import spec_placements
from .layers import (ParallelCtx, _dense_init, gelu, local_param,
                     rows_and_heads)


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


def _expert_ffn(p, xin: torch.Tensor, cfg,
                ctx: ParallelCtx) -> torch.Tensor:
    """xin: (..., E, C, d) -> (..., E, C, d) through per-expert gated MLP."""
    dt = ctx.compute_dtype
    act = gelu if cfg.act == "gelu" else F.silu
    h = act(torch.einsum("...ecd,edf->...ecf", xin,
                         ctx.weight(p["wg"], xin, dt)))
    h = h * torch.einsum("...ecd,edf->...ecf", xin,
                         ctx.weight(p["wu"], xin, dt))
    return torch.einsum("...ecf,efd->...ecd", h, ctx.weight(p["wd"], h, dt))


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

    # groups split over the batch axes as the rows were, whole on the
    # model axis, and so is their gradient (the view back to (B, S, d)
    # cannot merge a dim split over two mesh axes)
    ba = ctx.batch_axes or None
    xg = ctx.shard(x.reshape(G, g, d), ba, None, None)
    logits = ctx.proj(xg, p["router"])                     # (G, g, E)
    gate_vals, idx = _route(logits, k)
    aux = _aux_loss(logits, idx, E)

    # per-slot dispatch with capacity-priority across slots.  On a mesh
    # the one-hots are split over experts from the start (the constraint
    # on disp / comb below, which XLA carries back to them), and the sums
    # start at the first slot (the same values as from zeros)
    e_axis = ctx.head_axis(E)                # the model axis iff it divides E
    disp = comb = None
    prev_counts = torch.zeros((G, E), dtype=torch.long, device=x.device)
    for slot in range(k):
        oh = ctx.shard(_one_hot(idx[..., slot], E), ba, None, e_axis)
        pos = _slot_positions(oh, prev_counts)              # (G, g, E)
        keep = (pos < C) & (oh > 0)
        # the (G, g, E, C) one-hot built as bool, not int64 (8 bytes an
        # entry: 5 GB a device in a 32k prefill); the same 0 / 1 values
        pos_oh = ((pos[..., None] == torch.arange(C, device=x.device))
                  & keep[..., None]).to(dt)
        slot_disp = oh[..., None].to(dt) * pos_oh           # (G,g,E,C)
        slot_comb = slot_disp.float() * gate_vals[..., slot][..., None, None]
        disp = slot_disp if disp is None else disp + slot_disp
        comb = slot_comb if comb is None else comb + slot_comb
        prev_counts = prev_counts + torch.sum(oh * keep, dim=1)

    # dispatch -> expert FFN -> combine.  On a mesh, the constraints
    # implement EP: groups shard over the batch axes, experts over the
    # model axis; the G<->E resharding of xin/out_e is expert parallelism's
    # all-to-all.
    disp = ctx.shard(disp, ba, None, ctx.model_axis, None)
    comb = ctx.shard(comb, ba, None, ctx.model_axis, None)
    out = _experts_by_rows(p, cfg, ctx, disp, comb, xg)
    if out is None:
        xin = torch.einsum("gsec,gsd->gecd", disp, xg)       # (G, E, C, d)
        xin = ctx.shard(xin, ba, ctx.model_axis, None, None)
        out_e = _expert_ffn(p, xin, cfg, ctx)                # (G, E, C, d)
        out_e = ctx.shard(out_e, ba, ctx.model_axis, None, None)
        out = torch.einsum("gsec,gecd->gsd", comb.to(dt), out_e)
    return ctx.shard(out, ba, None, None).reshape(B, S, d), aux


def _experts_by_rows(p, cfg, ctx: ParallelCtx, disp, comb, xg):
    """Dispatch, expert FFN and combine run by each rank on its own groups
    and experts, where the mesh splits both evenly: the rank's blocks of
    ``disp`` / ``comb`` (groups over the batch axes, experts over the model
    axis), its groups' tokens and its experts' weights (gathered over the
    other axes) as plain tensors; the combine, a sum over the rank's
    experts, comes back as a partial sum over the model axis for the
    caller's constraint to sum.  DTensor would fold groups and experts
    into one batch dim of its ``bmm``, and refuses to fold two split
    dims.  None where the mesh does not split them evenly."""
    placements = rows_and_heads(ctx, disp)
    if placements is None:
        return None
    mesh, ba, m = ctx.mesh, ctx.batch_axes or None, ctx.model_axis
    names = mesh.mesh_dim_names
    d_l, c_l = (ctx.shard(t, ba, None, m, None).to_local()
                for t in (disp, comb))
    rows = ctx.shard(xg, ba, None, None)
    x_l = rows.to_local(grad_placements=[
        Partial() if names[i] == m else pl
        for i, pl in enumerate(rows.placements)])
    plain = ctx.plain()
    weights = {n: local_param(ctx, p[n], m, None, None) for n in
               ("wg", "wu", "wd")}
    xin = torch.einsum("gsec,gsd->gecd", d_l, x_l)
    out_e = _expert_ffn(weights, xin, cfg, plain)
    out = torch.einsum("gsec,gecd->gsd", c_l.to(plain.compute_dtype), out_e)
    return DTensor.from_local(out, mesh, [
        Partial() if names[i] == m else pl for i, pl in
        enumerate(spec_placements(mesh, (ba, None, None)))], run_check=False)


# ---------------------------------------------------------------------------
# scatter/gather dispatch
# ---------------------------------------------------------------------------
def moe_layer_scatter(p, x: torch.Tensor, cfg, ctx: ParallelCtx,
                      group: Optional[int] = None):
    dt = ctx.compute_dtype
    B, S, d = x.shape
    E, k = cfg.n_experts, max(1, cfg.top_k)
    G, g, C = _group(cfg, B * S, group)

    ba = ctx.batch_axes or None
    xg = ctx.shard(x.reshape(G, g, d), ba, None, None)
    logits = ctx.proj(xg, p["router"])
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
    out_e = _expert_ffn(p, xin[:, :, :C], cfg, ctx)          # (G, E, C, d)
    out_e = F.pad(out_e, (0, 0, 0, 1))                       # overflow -> 0

    out = torch.zeros((G, g, d), dtype=dt, device=x.device)
    for slot in range(k):
        y = out_e[gidx, idx[..., slot], slot_pos[slot]]      # (G, g, d)
        w = (gate_vals[..., slot] * slot_keep[slot])[..., None].to(dt)
        out = out + y * w
    return ctx.shard(out, ba, None, None).reshape(B, S, d), aux


def moe_layer(p, x: torch.Tensor, cfg, ctx: ParallelCtx,
              group: Optional[int] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss).  Impl chosen by cfg.moe_impl
    ('einsum' | 'scatter'), einsum by default."""
    impl = getattr(cfg, "moe_impl", "einsum")
    fn = moe_layer_scatter if impl == "scatter" else moe_layer_einsum
    return fn(p, x, cfg, ctx, group)
