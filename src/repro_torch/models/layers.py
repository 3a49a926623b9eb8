"""Model building blocks on PyTorch: norms, rotary embeddings, attention
variants, gated MLP.  Same names, shapes and casting points as the
reference package's ``models/layers.py``; parameters are plain dicts of
tensors.

Attention comes in four execution strategies:
* the flash-attention kernel (``kernels/flash_attention.py``) when
  ``ctx.use_kernels`` -- on a CUDA tensor the hand-written CUDA kernel, on
  a CPU tensor its plain PyTorch version;
* full masked attention            -- small sequences / smoke tests
* flash-style chunked attention    -- online softmax in plain PyTorch; used
                                      for 'global' layers at long S
* banded chunked local attention   -- O(S * 2w) compute for sliding windows

Parameters are float32 and are cast to ``ctx.compute_dtype`` at every use
(``x @ p["wq"].to(dt)``); norms, rotary embeddings and the softmax compute
in float32 and cast back, as in the reference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ..kernels import flash_attention as fa_kernel
from ..launch.sharding import spec_placements

NEG_INF = -2.0 ** 30   # large-but-finite mask value (bf16-safe)


@dataclass(frozen=True)
class ParallelCtx:
    """Execution context threaded through the model code.

    ``use_kernels`` defaults to **True** in the port (the reference's
    default is False): attention and the RG-LRU scan go through the
    hand-written kernels' wrappers, which launch the CUDA kernels for
    tensors on the card and run the kernels' plain PyTorch versions for
    tensors on the CPU.  On the card a model takes the plain PyTorch route
    of the reference (``full_attention`` / ``local_attention_jnp`` /
    ``flash_attention_jnp``, the associative scan; names kept from the
    reference) only when its caller passes ``use_kernels=False``.
    ``compute_dtype`` defaults to bfloat16, as in the reference.  The
    kernels are forward only: a trainer passes ``use_kernels=False``.
    ``remat="block"`` recomputes each superblock's layers in the backward
    pass instead of keeping their activations (the reference's
    ``jax.checkpoint`` of its scan body).

    The mesh fields are the reference's, and ``mesh`` carries the
    ``DeviceMesh`` that JAX keeps ambient (``with mesh:``).  A model runs
    on a mesh when its parameters are DTensors (``launch.sharding``); the
    caller runs it under ``launch.sharding.GatherOnRefusal``, which takes
    the plain tensors the model makes (rotary tables, masks) as replicated
    and gathers the arguments of an op whose sharding DTensor refuses."""

    batch_axes: tuple[str, ...] = ()     # mesh axes sharding the batch dim
    model_axis: Optional[str] = None     # tensor-parallel axis name
    model_size: int = 1                  # size of the model axis (for guards)
    use_kernels: bool = True
    remat: str = "none"                  # "none" | "block"
    compute_dtype: torch.dtype = torch.bfloat16
    flash_block: int = 1024              # q/kv chunk for chunked attention
    flash_threshold: int = 8192          # use chunked attention when S >= this
    mesh: Optional[DeviceMesh] = None

    def shard(self, x: torch.Tensor, *spec) -> torch.Tensor:
        """``x`` redistributed to the placements of ``spec`` on the mesh
        (the reference's sharding constraint); ``x`` itself without a mesh
        or when ``x`` is not a DTensor."""
        if self.mesh is None or not isinstance(x, DTensor):
            return x
        placements = spec_placements(self.mesh, spec)
        if tuple(x.placements) == placements:
            return x
        return x.redistribute(self.mesh, placements)

    def head_axis(self, n_heads: int) -> Optional[str]:
        """The model axis iff the head count divides it — sharding 8 heads
        onto a 16-way axis pads 2x and triggers SPMD full-remat copies."""
        if self.model_axis is not None and n_heads % max(self.model_size, 1) == 0:
            return self.model_axis
        return None


# ---------------------------------------------------------------------------
# initializers / norms / embeddings
# ---------------------------------------------------------------------------
def _dense_init(gen: torch.Generator, shape, scale: float = 1.0,
                device=None) -> torch.Tensor:
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale / math.sqrt(max(fan_in, 1))
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return x.mul_(std)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + gamma.float())).to(dt)


def init_norm(d: int, device=None) -> torch.Tensor:
    return torch.zeros((d,), dtype=torch.float32, device=device)


def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   device=None) -> torch.Tensor:
    return _dense_init(gen, (vocab, d), scale=1.0, device=device)


def embed(tokens: torch.Tensor, table: torch.Tensor,
          compute_dtype: torch.dtype) -> torch.Tensor:
    # gather, then cast: the same values as the reference's cast-then-gather
    # without a compute-dtype copy of the whole table
    x = table[tokens].to(compute_dtype)
    return x * torch.tensor(math.sqrt(table.shape[1]), dtype=compute_dtype,
                            device=x.device)


def unembed(x: torch.Tensor, table: torch.Tensor,
            softcap: Optional[float] = None) -> torch.Tensor:
    logits = (x @ table.to(x.dtype).T).float()
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    ang = positions[..., None].float() * freqs                # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.split(x.float(), half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention cores
# ---------------------------------------------------------------------------
def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, hd) -> (B, S, Hkv*n_rep, hd)"""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def _softcap(scores: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def _masked(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, scores, torch.full_like(scores, NEG_INF))


def full_attention(q, k, v, *, causal: bool,
                   softcap: Optional[float] = None) -> torch.Tensor:
    """Reference masked attention. q: (B,Sq,Hq,hd), k/v: (B,Skv,Hkv,hd);
    unmasked (``causal=False``) it takes Sq != Skv (cross-attention)."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    k = _repeat_kv(k, Hq // Hkv)
    v = _repeat_kv(v, Hq // Hkv)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores / math.sqrt(hd)
    scores = _softcap(scores, softcap)
    if causal:
        scores = _masked(scores, fa_kernel.attention_mask(Sq, True, None,
                                                          q.device))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def flash_attention_jnp(q, k, v, *, causal: bool = True,
                        softcap: Optional[float] = None,
                        block: int = 1024) -> torch.Tensor:
    """Chunked online-softmax attention (flash-style) in plain PyTorch
    (name kept from the reference, where it is pure jnp): q chunks in
    parallel, kv chunks in a loop with running (max, sum, acc), peak live
    memory O(S * block)."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    n_rep = Hq // Hkv
    blk = min(block, S)
    if S % blk:
        raise ValueError(f"S={S} must be divisible by the block {blk}")
    n = S // blk
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qc = q.reshape(B, n, blk, Hq, hd)
    kc = k.reshape(B, n, blk, Hkv, hd)
    vc = v.reshape(B, n, blk, Hkv, hd)
    o = torch.zeros((B, n, blk, Hq, hd), dtype=torch.float32, device=dev)
    m = torch.full((B, n, Hq, blk), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((B, n, Hq, blk), dtype=torch.float32, device=dev)
    qpos = (torch.arange(n, device=dev)[:, None] * blk
            + torch.arange(blk, device=dev)[None, :])
    for j in range(n):
        kj = _repeat_kv(kc[:, j], n_rep)                      # (B,blk,Hq,hd)
        vj = _repeat_kv(vc[:, j], n_rep)
        s = torch.einsum("bnqhd,bkhd->bnhqk", qc, kj).float() * scale
        s = _softcap(s, softcap)
        if causal:
            kpos = j * blk + torch.arange(blk, device=dev)
            mask = kpos[None, None, :] <= qpos[:, :, None]    # (n,blk,blk)
            s = _masked(s, mask[None, :, None, :, :])
        m_new = torch.maximum(m, s.amax(dim=-1))              # (B,n,H,blk)
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bnhqk,bkhd->bnqhd", p.to(q.dtype), vj)
        o = o * corr.permute(0, 1, 3, 2)[..., None] + pv.float()
        m = m_new
    l = l.permute(0, 1, 3, 2)[..., None]                       # (B,n,blk,Hq,1)
    out = (o / torch.clamp_min(l, 1e-20)).to(q.dtype)
    return out.reshape(B, S, Hq, hd)


def local_attention_jnp(q, k, v, *, window: int,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """Banded sliding-window attention in plain PyTorch (name kept from the
    reference): chunk size = window; each q chunk attends to
    its own + the previous chunk -> exact for span <= window."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    w = min(window, S)
    if S % w != 0:      # pad sequence to a chunk multiple
        pad = w - S % w
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    Sp = q.shape[1]
    n = Sp // w
    n_rep = Hq // Hkv
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    qc = q.reshape(B, n, w, Hq, hd)
    kc = k.reshape(B, n, w, Hq, hd)
    vc = v.reshape(B, n, w, Hq, hd)
    # previous chunk (zeros before chunk 0)
    kprev = torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], dim=1)
    vprev = torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], dim=1)
    k2 = torch.cat([kprev, kc], dim=2)                        # (B,n,2w,H,hd)
    v2 = torch.cat([vprev, vc], dim=2)
    s = torch.einsum("bnqhd,bnkhd->bnhqk", qc, k2).float()
    s = s / math.sqrt(hd)
    s = _softcap(s, softcap)
    dev = q.device
    qpos = torch.arange(w, device=dev)
    kpos = torch.arange(2 * w, device=dev) - w                # rel. to chunk start
    mask = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] > qpos[:, None] - w)
    first = torch.arange(n, device=dev) == 0                  # chunk 0 has no prev
    mask_first = mask & (kpos[None, :] >= 0)
    m = torch.where(first[:, None, None], mask_first[None], mask[None])
    p = torch.softmax(_masked(s, m[None, :, None, :, :]), dim=-1).to(q.dtype)
    o = torch.einsum("bnhqk,bnkhd->bnqhd", p, v2)
    return o.reshape(B, Sp, Hq, hd)[:, :S]


def decode_attention(q, k_cache, v_cache, *, length_mask: torch.Tensor,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """Single-token attention against a cache.
    q: (B,1,Hq,hd); caches: (B,Skv,Hkv,hd); length_mask: (B,Skv) bool."""
    B, _, Hq, hd = q.shape
    Hkv = k_cache.shape[2]
    k = _repeat_kv(k_cache, Hq // Hkv)
    v = _repeat_kv(v_cache, Hq // Hkv)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    s = s / math.sqrt(hd)
    s = _softcap(s, softcap)
    p = torch.softmax(_masked(s, length_mask[:, None, None, :]),
                      dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


# ---------------------------------------------------------------------------
# attention layer (projections + cache handling)
# ---------------------------------------------------------------------------
def init_attention(gen: torch.Generator, cfg, device=None) -> dict:
    d, hd = cfg.d_model, cfg.hd
    p = {
        "wq": _dense_init(gen, (d, cfg.n_heads * hd), device=device),
        "wk": _dense_init(gen, (d, cfg.n_kv * hd), device=device),
        "wv": _dense_init(gen, (d, cfg.n_kv * hd), device=device),
        "wo": _dense_init(gen, (cfg.n_heads * hd, d),
                          scale=1.0 / math.sqrt(2 * cfg.n_layers),
                          device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_norm(hd, device)
        p["k_norm"] = init_norm(hd, device)
    return p


def _project_qkv(p, x, cfg, positions, dt, use_rope: bool = True,
                 ctx: Optional[ParallelCtx] = None):
    B, S, _ = x.shape
    hd = cfg.hd
    q = (x @ p["wq"].to(dt)).reshape(B, S, cfg.n_heads, hd)
    k = (x @ p["wk"].to(dt)).reshape(B, S, cfg.n_kv, hd)
    v = (x @ p["wv"].to(dt)).reshape(B, S, cfg.n_kv, hd)
    if ctx is not None and (ctx.batch_axes or ctx.model_axis):
        ba = ctx.batch_axes or None
        q = ctx.shard(q, ba, None, ctx.head_axis(cfg.n_heads), None)
        kv_ax = ctx.head_axis(cfg.n_kv)
        k = ctx.shard(k, ba, None, kv_ax, None)
        v = ctx.shard(v, ba, None, kv_ax, None)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_layer(p, x, cfg, ctx: ParallelCtx, kind: str,
                    positions: torch.Tensor, return_kv: bool = False):
    """Training/prefill attention. kind in {'global','local','enc'}; an
    encoder ('enc') layer is unmasked on every route.  With ``return_kv``
    also returns the roped (k, v) for the decode cache."""
    dt = ctx.compute_dtype
    B, S, _ = x.shape
    causal = kind != "enc"
    q, k, v = _project_qkv(p, x, cfg, positions, dt, use_rope=True, ctx=ctx)
    if ctx.use_kernels:
        window = cfg.window if kind == "local" else None
        o = fa_kernel.flash_attention(q, k, v, causal=causal, window=window,
                                      softcap=cfg.attn_softcap)
    elif kind == "local":
        o = local_attention_jnp(q, k, v, window=cfg.window,
                                softcap=cfg.attn_softcap)
    elif S >= ctx.flash_threshold and causal:
        o = flash_attention_jnp(q, k, v, causal=True,
                                softcap=cfg.attn_softcap,
                                block=ctx.flash_block)
    else:
        o = full_attention(q, k, v, causal=causal, softcap=cfg.attn_softcap)
    o = o.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo"].to(dt)
    return (o, k, v) if return_kv else o


def attention_decode(p, x, cache, cfg, ctx: ParallelCtx, kind: str,
                     positions: torch.Tensor):
    """One-token decode. cache = {'k','v'}: (B, C, Hkv, hd); positions (B,).

    For 'local' layers the cache is a rolling buffer of size window; for
    'global' it is the full sequence length.  The port writes the new k/v
    into the cache tensors **in place** (the reference returns updated
    copies) and returns the same dict."""
    dt = ctx.compute_dtype
    B = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg, positions[:, None], dt, use_rope=True,
                           ctx=ctx)
    C = cache["k"].shape[1]
    slot = positions % C if kind == "local" else positions
    if isinstance(cache["k"], DTensor):
        # DTensor cannot index-put into a sharded cache in place; a masked
        # select writes the same slots, then copies into the cache's shards
        hit = (torch.arange(C, device=x.device)[None, :]
               == slot[:, None])[:, :, None, None]
        for name, new in (("k", k), ("v", v)):
            buf = cache[name]
            buf.copy_(torch.where(hit, new.to(buf.dtype), buf))
    else:
        bidx = torch.arange(B, device=x.device)
        cache["k"][bidx, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][bidx, slot] = v[:, 0].to(cache["v"].dtype)
    kpos = torch.arange(C, device=x.device)[None, :]
    if kind == "local":
        # rolling buffer: valid entries are the last min(pos+1, window)
        valid = kpos < torch.clamp_max(positions[:, None] + 1, C)
    else:
        valid = kpos <= positions[:, None]
    o = decode_attention(q, cache["k"].to(dt), cache["v"].to(dt),
                         length_mask=valid, softcap=cfg.attn_softcap)
    o = o.reshape(B, 1, cfg.n_heads * cfg.hd) @ p["wo"].to(dt)
    return o, cache


def init_attn_cache(cfg, B: int, S: int, kind: str,
                    dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    C = min(cfg.window, S) if kind == "local" else S
    shape = (B, C, cfg.n_kv, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# gated MLP
# ---------------------------------------------------------------------------
def init_mlp(gen: torch.Generator, cfg, d_ff: Optional[int] = None,
             device=None) -> dict:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    return {
        "wg": _dense_init(gen, (d, ff), device=device),
        "wu": _dense_init(gen, (d, ff), device=device),
        "wd": _dense_init(gen, (ff, d), scale=1.0 / math.sqrt(2 * cfg.n_layers),
                          device=device),
    }


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``jax.nn.gelu`` (tanh approximation by default)."""
    return F.gelu(x, approximate="tanh")


def mlp(p, x, cfg, ctx: ParallelCtx) -> torch.Tensor:
    dt = ctx.compute_dtype
    act = gelu if cfg.act == "gelu" else F.silu
    h = act(x @ p["wg"].to(dt)) * (x @ p["wu"].to(dt))
    h = ctx.shard(h, ctx.batch_axes or None, None, ctx.model_axis)
    return h @ p["wd"].to(dt)
