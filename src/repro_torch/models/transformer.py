"""Decoder/encoder stack assembly on PyTorch, with the reference's
parameter and cache layout.

Layers are grouped into *superblocks* of P = lcm(|pattern|, moe_every)
layers so every superblock is structurally identical; parameters are
stacked over superblocks (a leading ``n_super`` axis on every leaf of
``{"blocks": tuple of P dicts, "rem": tuple}``, exactly as in the
reference), and ``n_layers % P`` trailing layers form an unrolled
remainder.  The reference scans the stack; the port runs eagerly and loops
over superblocks, indexing views of the stacked parameters and caches.

Each sublayer is pre-norm residual:
    x += mix(norm(x))        mix in {attention, RG-LRU, RWKV6 time-mix}
    x += ffn(norm(x))        ffn in {gated MLP, MoE}
(+ an extra cross-attention sublayer in enc-dec decoder layers).

Three entry points share the layer code:
    apply_stack(...)                   training (no cache)
    apply_stack(..., cache=...)        prefill (fills the decode cache)
    apply_stack_decode(...)            one-token decode
Caches are updated **in place** (the reference returns updated copies).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..tree import tree_map
from . import moe as moe_mod
from . import recurrent as rec
from .layers import (ParallelCtx, attention_decode, attention_layer,
                     decode_attention, full_attention, init_attention,
                     init_attn_cache, init_mlp, init_norm, merge_heads, mlp,
                     own_layout, rms_norm, split_heads)

ATTN_KINDS = ("global", "local", "enc")


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def superblock_len(cfg) -> int:
    p = len(cfg.layer_pattern)
    if cfg.n_experts > 0:
        p = _lcm(p, cfg.moe_every)
    return p


def layer_meta(cfg, i: int) -> dict:
    return {"kind": cfg.kind_of_layer(i), "moe": cfg.is_moe_layer(i),
            "cross": cfg.cross_attn and cfg.is_encdec}


def _index(tree, i: int):
    """Views of superblock ``i`` of a stacked tree (on a mesh, each with
    its gradient in its own shards: ``layers.own_layout``)."""
    return tree_map(lambda t: own_layout(t[i]), tree)


# ---------------------------------------------------------------------------
# per-layer init
# ---------------------------------------------------------------------------
def has_cross(meta: dict) -> bool:
    """A decoder layer beside an encoder: it holds a cross-attention."""
    return meta["cross"] and meta["kind"] != "enc"


def layer_groups(meta: dict) -> tuple:
    """The parameter groups a layer of ``meta`` holds beside its two norms,
    in the order :func:`init_layer` draws them: its mixer (``attn`` /
    ``rglru`` / ``rwkv``), its cross-attention (``norm_x``, ``cross``) and
    its feed-forward (``moe`` / ``mlp``)."""
    kind = meta["kind"]
    if kind not in ATTN_KINDS + ("rglru", "rwkv"):
        raise ValueError(kind)
    return ("attn" if kind in ATTN_KINDS else kind,
            *(("norm_x", "cross") if has_cross(meta) else ()),
            "moe" if meta["moe"] else "mlp")


_INIT_GROUP = {"attn": init_attention, "cross": init_attention,
               "rglru": rec.init_rglru, "rwkv": rec.init_rwkv,
               "moe": moe_mod.init_moe, "mlp": init_mlp}


def init_layer(gen: torch.Generator, cfg, meta: dict, device=None) -> dict:
    p: dict[str, Any] = {"norm1": init_norm(cfg.d_model, device),
                         "norm2": init_norm(cfg.d_model, device)}
    for g in layer_groups(meta):
        p[g] = (init_norm(cfg.d_model, device) if g == "norm_x"
                else _INIT_GROUP[g](gen, cfg, device=device))
    return p


def init_layer_cache(cfg, meta: dict, B: int, S: int,
                     dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    kind = meta["kind"]
    c: dict[str, Any] = {}
    if kind in ATTN_KINDS:
        c["attn"] = init_attn_cache(cfg, B, S, kind, dtype, device)
    elif kind == "rglru":
        c["rec"] = rec.init_rglru_cache(cfg, B, dtype, device)
    else:
        c["rec"] = rec.init_rwkv_cache(cfg, B, dtype, device)
    if has_cross(meta):
        shape = (B, cfg.src_seq, cfg.n_kv, cfg.hd)
        c["cross_kv"] = {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
    return c


# ---------------------------------------------------------------------------
# cache write helpers (prefill)
# ---------------------------------------------------------------------------
def _write_attn_cache(entry: dict, k: torch.Tensor, v: torch.Tensor,
                      kind: str) -> dict:
    """Write S prefilled (roped) k/v into a decode cache buffer, in place.

    Global: positions [0, S) go to slots [0, S).  Local: the buffer is a
    rolling window (slot = pos % C) so the last C entries land rolled by S%C.
    """
    S = k.shape[1]
    C = entry["k"].shape[1]
    if kind == "local" and S >= C:
        r = S % C
        for name, t in (("k", k), ("v", v)):
            last = t[:, -C:]
            # ``torch.roll(last, r, dims=1)`` by slices (DTensor has a
            # sharding rule for these and none for ``roll``)
            entry[name].copy_(torch.cat([last[:, C - r:], last[:, :C - r]],
                                        dim=1) if r else last)
        return entry
    n = min(S, C)
    entry["k"][:, :n] = k[:, :n].to(entry["k"].dtype)
    entry["v"][:, :n] = v[:, :n].to(entry["v"].dtype)
    return entry


# ---------------------------------------------------------------------------
# per-layer apply
# ---------------------------------------------------------------------------
def _fill(dst: dict, src: dict) -> None:
    """Copy a prefilled state into its cache tensors, casting as it goes."""
    for name, t in src.items():
        dst[name].copy_(t)


def apply_layer(p, x, cfg, ctx: ParallelCtx, meta: dict,
                positions: torch.Tensor,
                enc_out: Optional[torch.Tensor] = None,
                cache: Optional[dict] = None):
    """Training/prefill.  Returns (x, aux_loss, cache_or_None); the cache,
    when given, is filled in place."""
    kind = meta["kind"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = ctx.rows(rms_norm(x, p["norm1"], cfg.norm_eps))
    if kind in ATTN_KINDS:
        if cache is not None:
            o, k, v = attention_layer(p["attn"], h, cfg, ctx, kind, positions,
                                      return_kv=True)
            _write_attn_cache(cache["attn"], k, v, kind)
        else:
            o = attention_layer(p["attn"], h, cfg, ctx, kind, positions)
    else:
        layer = rec.rglru_layer if kind == "rglru" else rec.rwkv_layer
        if cache is not None:
            o, st = layer(p[kind], h, cfg, ctx, return_cache=True)
            _fill(cache["rec"], st)
        else:
            o = layer(p[kind], h, cfg, ctx)
    x = x + ctx.rows(o)
    if has_cross(meta) and enc_out is not None:
        hx = ctx.rows(rms_norm(x, p["norm_x"], cfg.norm_eps))
        o, ckv = _cross_attention(p["cross"], hx, enc_out, cfg, ctx)
        x = x + ctx.rows(o)
        if cache is not None:
            _fill(cache["cross_kv"], ckv)
    h = ctx.rows(rms_norm(x, p["norm2"], cfg.norm_eps))
    if meta["moe"]:
        o, aux = moe_mod.moe_layer(p["moe"], h, cfg, ctx)
    else:
        o = mlp(p["mlp"], h, cfg, ctx)
    x = x + ctx.rows(o)
    return x, aux, cache


def _cross_attention(p, x, enc_out, cfg, ctx: ParallelCtx):
    """Decoder cross-attention over encoder output (no mask, no rope; the
    plain ``full_attention``, as in the reference: B5 takes only a query
    length equal to the key length)."""
    hd = cfg.hd
    q = split_heads(ctx, ctx.proj(x, p["wq"]), cfg.n_heads, hd)
    k = split_heads(ctx, ctx.proj(enc_out, p["wk"]), cfg.n_kv, hd)
    v = split_heads(ctx, ctx.proj(enc_out, p["wv"]), cfg.n_kv, hd)
    o = full_attention(q, k, v, causal=False, ctx=ctx)
    o = ctx.proj(merge_heads(ctx, o), p["wo"])
    return o, {"k": k, "v": v}


def _cross_decode(p, x, cross_kv, cfg, ctx: ParallelCtx) -> torch.Tensor:
    dt = ctx.compute_dtype
    B = x.shape[0]
    hd = cfg.hd
    q = split_heads(ctx, ctx.proj(x, p["wq"]), cfg.n_heads, hd)
    k = cross_kv["k"].to(dt)
    v = cross_kv["v"].to(dt)
    mask = torch.ones((B, k.shape[1]), dtype=torch.bool, device=x.device)
    o = decode_attention(q, k, v, length_mask=mask)
    return ctx.proj(merge_heads(ctx, o), p["wo"])


def apply_layer_decode(p, x, cache, cfg, ctx: ParallelCtx, meta: dict,
                       positions: torch.Tensor):
    kind = meta["kind"]
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind in ATTN_KINDS:
        o, _ = attention_decode(p["attn"], h, cache["attn"], cfg, ctx, kind,
                                positions)
    elif kind == "rglru":
        o, _ = rec.rglru_decode(p["rglru"], h, cache["rec"], cfg, ctx)
    else:
        o, _ = rec.rwkv_decode(p["rwkv"], h, cache["rec"], cfg, ctx)
    x = x + ctx.rows(o)
    if has_cross(meta) and "cross_kv" in cache:
        hx = rms_norm(x, p["norm_x"], cfg.norm_eps)
        x = x + ctx.rows(_cross_decode(p["cross"], hx, cache["cross_kv"],
                                       cfg, ctx))
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    if meta["moe"]:
        o, _ = moe_mod.moe_layer(p["moe"], h, cfg, ctx)
    else:
        o = mlp(p["mlp"], h, cfg, ctx)
    return x + ctx.rows(o), cache


# ---------------------------------------------------------------------------
# stack = loop(superblocks) + unrolled remainder
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class StackMeta:
    P: int
    n_super: int
    remainder: int
    metas: tuple           # per-sublayer meta dicts, len P
    rem_metas: tuple


def stack_meta(cfg, n_layers: Optional[int] = None,
               pattern_override: Optional[tuple] = None) -> StackMeta:
    n = n_layers if n_layers is not None else cfg.n_layers
    if pattern_override is not None:
        P = len(pattern_override)
        if P > n:
            P = n
        n_super, rem = n // P, n % P
        metas = tuple({"kind": pattern_override[j], "moe": False,
                       "cross": False} for j in range(P))
        rem_metas = tuple({"kind": pattern_override[j], "moe": False,
                           "cross": False} for j in range(rem))
        return StackMeta(P, n_super, rem, metas, rem_metas)
    P = superblock_len(cfg)
    if P > n:
        P = n
    n_super = n // P
    rem = n - n_super * P
    metas = tuple(layer_meta(cfg, j) for j in range(P))
    rem_metas = tuple(layer_meta(cfg, n_super * P + j) for j in range(rem))
    return StackMeta(P=P, n_super=n_super, remainder=rem, metas=metas,
                     rem_metas=rem_metas)


def init_stack(gen: torch.Generator, cfg, sm: StackMeta, device=None) -> dict:
    """Stacked superblock parameters + the remainder.  Each superblock is
    drawn and copied into preallocated stacks, so the peak is the model
    plus one superblock (stacking at the end would hold two copies)."""
    stacked: Any = ()
    for s in range(sm.n_super):
        layers = tuple(init_layer(gen, cfg, sm.metas[j], device)
                       for j in range(sm.P))
        if s == 0:
            stacked = tree_map(
                lambda t: t.new_empty((sm.n_super,) + tuple(t.shape)), layers)
        tree_map(lambda buf, t: buf[s].copy_(t), stacked, layers)
        del layers
    rem = tuple(init_layer(gen, cfg, sm.rem_metas[j], device)
                for j in range(sm.remainder))
    return {"blocks": stacked, "rem": rem}


def init_stack_cache(cfg, sm: StackMeta, B: int, S: int,
                     dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    stacked: Any = ()
    if sm.n_super > 0:
        per_sb = tuple(init_layer_cache(cfg, sm.metas[j], B, S, dtype, device)
                       for j in range(sm.P))
        stacked = tree_map(
            lambda x: torch.zeros((sm.n_super,) + tuple(x.shape),
                                  dtype=x.dtype, device=x.device), per_sb)
    rem = tuple(init_layer_cache(cfg, sm.rem_metas[j], B, S, dtype, device)
                for j in range(sm.remainder))
    return {"blocks": stacked, "rem": rem}


def apply_stack(stack_params, x, cfg, ctx: ParallelCtx, sm: StackMeta,
                positions, enc_out=None, cache: Optional[dict] = None):
    """Training (cache=None) or prefill (cache filled in place).  Returns
    (x, aux_total, cache_or_None)."""
    fill = cache is not None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def superblock(x, aux, p_sb, c_sb):
        for j in range(sm.P):
            x, a, _ = apply_layer(p_sb[j], x, cfg, ctx, sm.metas[j], positions,
                                  enc_out, c_sb[j] if fill else None)
            aux = aux + a
        return x, aux

    remat = ctx.remat == "block" and not fill
    if ctx.remat not in ("none", "block"):
        raise ValueError(f"remat must be 'none' or 'block', got {ctx.remat!r}")
    for s in range(sm.n_super):
        p_sb = _index(stack_params["blocks"], s)
        c_sb = _index(cache["blocks"], s) if fill else None
        if remat:
            # the superblock's activations are recomputed in the backward
            # pass; the remainder layers below are not (as in the reference)
            x, aux = checkpoint(superblock, x, aux, p_sb, c_sb,
                                use_reentrant=False)
        else:
            x, aux = superblock(x, aux, p_sb, c_sb)
    for j in range(sm.remainder):
        x, a, _ = apply_layer(stack_params["rem"][j], x, cfg, ctx,
                              sm.rem_metas[j], positions, enc_out,
                              cache["rem"][j] if fill else None)
        aux = aux + a
    return x, aux, cache


def apply_stack_decode(stack_params, x, cache, cfg, ctx: ParallelCtx,
                       sm: StackMeta, positions):
    """One-token decode; the cache is updated in place and returned."""
    for s in range(sm.n_super):
        p_sb = _index(stack_params["blocks"], s)
        c_sb = _index(cache["blocks"], s)
        for j in range(sm.P):
            x, _ = apply_layer_decode(p_sb[j], x, c_sb[j], cfg, ctx,
                                      sm.metas[j], positions)
    for j in range(sm.remainder):
        x, _ = apply_layer_decode(stack_params["rem"][j], x, cache["rem"][j],
                                  cfg, ctx, sm.rem_metas[j], positions)
    return x, cache
