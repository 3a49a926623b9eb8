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
(``ctx.proj(x, p["wq"])``, which on a mesh also places the weight); norms,
rotary embeddings and the softmax compute in float32 and cast back, as in
the reference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                      distribute_tensor)

from ..kernels import flash_attention as fa_kernel
from ..launch.sharding import spec_placements

NEG_INF = -2.0 ** 30   # large-but-finite mask value (bf16-safe)


class _Constrain(torch.autograd.Function):
    """A DTensor redistributed to ``placements`` forward, and its gradient
    redistributed to the input's placements backward, always.  DTensor's
    own ``redistribute`` is no op at all where the placements already
    match, and a gradient that arrives as a partial sum over the model
    axis then flows on into the next matmul's backward, which gathers its
    sharded operand whole to contract with it."""

    @staticmethod
    def forward(ctx, x: DTensor, placements: tuple) -> DTensor:
        # a partial input's gradient keeps the output's placement, as in
        # DTensor's own redistribute (nothing redistributes to partial)
        ctx.placements = tuple(o if i.is_partial() else i
                               for i, o in zip(x.placements, placements))
        if tuple(x.placements) == placements:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, grad: DTensor):
        if tuple(grad.placements) != ctx.placements:
            grad = grad.redistribute(grad.device_mesh, ctx.placements)
        return grad, None


def own_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, its gradient placed as ``t`` is (reduce-scattered
    where it comes back as a partial sum): a slice of a stacked weight
    then gets its gradient in the weight's own shards, and the stack's
    gradient is never built whole."""
    if (isinstance(t, DTensor) and t.requires_grad
            and torch.is_grad_enabled()):
        return _Constrain.apply(t, tuple(t.placements))
    return t


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
        (the reference's sharding constraint), and its gradient back to
        ``x``'s placements (``_Constrain``).  ``x`` itself without a mesh
        or when ``x`` is not a DTensor."""
        if self.mesh is None or not isinstance(x, DTensor):
            return x
        placements = spec_placements(self.mesh, spec)
        if x.requires_grad and torch.is_grad_enabled():
            return _Constrain.apply(x, placements)
        if tuple(x.placements) == placements:
            return x
        return x.redistribute(self.mesh, placements)

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` split over the batch axes on its first dim, whole on every
        other (Megatron's all-reduce of a row-parallel output, a partial
        sum over the model axis, before the residual add).  Left to
        itself, DTensor reduce-scatters the sum over the hidden dim and
        then splits the next column-parallel matmul's contraction instead
        of its output."""
        return self.shard(x, self.batch_axes or None, *([None] * (x.ndim - 1)))

    def weight(self, w: torch.Tensor, x: torch.Tensor,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Weight ``w`` for its product with ``x`` (features on its last
        dim, which the product contracts): cast to ``dtype`` when one is
        given, then placed on the
        mesh the way that moves fewer bytes, as GSPMD chooses.  Where this
        rank's rows of ``x`` outnumber the weight's dims split over axes
        other than the model axis, the weight is gathered over those axes,
        its model-axis sharding kept (ZeRO-3's all-gather before use; the
        backward reduce-scatters its gradient).  Without that gather
        DTensor splits the contraction over the data axis, where the FSDP
        shard lies, and returns partial sums over every row of the batch:
        right for a decode step's few rows, ruinous for a training
        microbatch's thousands."""
        if dtype is not None:
            w = w.to(dtype)
        if self.mesh is None or not isinstance(w, DTensor):
            return w
        names = self.mesh.mesh_dim_names
        keep = tuple(p if names[i] == self.model_axis
                     or self.mesh.size(i) == 1 else Replicate()
                     for i, p in enumerate(w.placements))
        if keep == tuple(w.placements):
            return w
        gathered = math.prod(w.shape[p.dim] for p, k in zip(
            w.placements, keep) if p != k and p.is_shard())
        with torch.no_grad():
            n = (x.to_local() if isinstance(x, DTensor) else x).numel()
        if n // max(x.shape[-1], 1) < gathered:
            return w
        return w.redistribute(self.mesh, keep)

    def proj(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` in the compute dtype, ``w`` placed by :meth:`weight`."""
        return x @ self.weight(w, x, self.compute_dtype)

    def plain(self) -> "ParallelCtx":
        """This context without its mesh fields: for code running on each
        rank's local blocks as plain tensors."""
        return ParallelCtx(use_kernels=self.use_kernels, remat=self.remat,
                           compute_dtype=self.compute_dtype,
                           flash_block=self.flash_block,
                           flash_threshold=self.flash_threshold)

    def query_split(self, n_heads: int, length: int) -> bool:
        """On a mesh whose model axis does not divide ``n_heads``, split
        attention's queries over the model axis instead (a dim of
        ``length`` that it divides): keys and values stay whole on every
        rank, each computes the scores of its queries.  With the heads
        replicated instead, every rank of the model axis would compute
        the whole attention."""
        return (self.mesh is not None and self.model_axis is not None
                and self.model_size > 1 and self.head_axis(n_heads) is None
                and length % self.model_size == 0)

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
          compute_dtype: torch.dtype,
          ctx: Optional["ParallelCtx"] = None) -> torch.Tensor:
    # gather, then cast: the same values as the reference's cast-then-gather
    # without a compute-dtype copy of the whole table
    x = _lookup(ctx, tokens, table).to(compute_dtype)
    return x * torch.tensor(math.sqrt(table.shape[1]), dtype=compute_dtype,
                            device=x.device)


def _lookup(ctx, tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  On ``ctx``'s mesh, where the rows split evenly
    over the batch axes, each rank looks up its own rows in its block of
    the vocabulary (the table gathered over the other axes), zeros where
    an id lies outside the block: the rows' embeddings as a partial sum
    over the model axis, summed by the caller's ``ParallelCtx.rows``.
    DTensor's own lookup refuses ids split over two mesh axes and gathers
    them whole."""
    if ctx is None or ctx.mesh is None or not isinstance(table, DTensor):
        return table[tokens]
    mesh, ba, m = ctx.mesh, ctx.batch_axes or None, ctx.model_axis
    rows = spec_placements(mesh, (ba, None))
    n_rows = math.prod(mesh.size(i) for i, p in enumerate(rows)
                       if p.is_shard(0))
    if tokens.shape[0] % n_rows:
        return table[tokens]
    names = mesh.mesh_dim_names
    split = any(p.is_shard(0) and names[i] == m and mesh.size(i) > 1
                for i, p in enumerate(table.placements))
    local = local_param(ctx, table, m if split else None, None)
    ids = (ctx.shard(tokens, ba, None).to_local()
           if isinstance(tokens, DTensor) else
           distribute_tensor(tokens, mesh, rows,
                             src_data_rank=None).to_local())
    if split:
        first = mesh.get_local_rank(m) * local.shape[0]
        inside = (ids >= first) & (ids < first + local.shape[0])
        x = local[torch.where(inside, ids - first, 0)] * inside[..., None]
    else:
        x = local[ids]
    out = [Partial() if split and names[i] == m else p
           for i, p in enumerate(spec_placements(mesh, (ba, None, None)))]
    return DTensor.from_local(x, mesh, out, run_check=False)


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
                   softcap: Optional[float] = None,
                   ctx: Optional[ParallelCtx] = None) -> torch.Tensor:
    """Reference masked attention. q: (B,Sq,Hq,hd), k/v: (B,Skv,Hkv,hd);
    unmasked (``causal=False``) it takes Sq != Skv (cross-attention).
    On ``ctx``'s mesh the queries split over the model axis where the
    heads cannot (``ParallelCtx.query_split``)."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    if ctx is not None and ctx.query_split(Hq, Sq):
        q = ctx.shard(q, ctx.batch_axes or None, ctx.model_axis, None, None)
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
                        block: int = 1024,
                        ctx: Optional[ParallelCtx] = None) -> torch.Tensor:
    """Chunked online-softmax attention (flash-style) in plain PyTorch
    (name kept from the reference, where it is pure jnp): q chunks in
    parallel, kv chunks in a loop with running (max, sum, acc), peak live
    memory O(S * block).  The running state starts at the first kv chunk
    (the same values as from zeros and -inf).  On ``ctx``'s mesh the q
    chunks split over the model axis where the heads cannot."""
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
    if ctx is not None and ctx.query_split(Hq, n):
        qc = ctx.shard(qc, ctx.batch_axes or None, ctx.model_axis, None,
                       None, None)
    kc = k.reshape(B, n, blk, Hkv, hd)
    vc = v.reshape(B, n, blk, Hkv, hd)
    o = m = l = None
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
        s_max = s.amax(dim=-1)                                # (B,n,H,blk)
        m_new = s_max if m is None else torch.maximum(m, s_max)
        p = torch.exp(s - m_new[..., None])
        pv = torch.einsum("bnhqk,bkhd->bnqhd", p.to(q.dtype), vj)
        if m is None:
            l, o = p.sum(dim=-1), pv.float()
        else:
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            o = o * corr.permute(0, 1, 3, 2)[..., None] + pv.float()
        m = m_new
    l = l.permute(0, 1, 3, 2)[..., None]                       # (B,n,blk,Hq,1)
    out = (o / torch.clamp_min(l, 1e-20)).to(q.dtype)
    return out.reshape(B, S, Hq, hd)


def local_attention_jnp(q, k, v, *, window: int,
                        softcap: Optional[float] = None,
                        ctx: Optional[ParallelCtx] = None) -> torch.Tensor:
    """Banded sliding-window attention in plain PyTorch (name kept from the
    reference): chunk size = window; each q chunk attends to
    its own + the previous chunk -> exact for span <= window.  On
    ``ctx``'s mesh the queries of each chunk split over the model axis
    where the heads cannot, and the output is gathered back whole before
    the chunks merge."""
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
    split = ctx is not None and ctx.query_split(Hq, w)
    ba = (ctx.batch_axes or None) if split else None
    if split:
        qc = ctx.shard(qc, ba, None, ctx.model_axis, None, None)
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
    if split:
        o = ctx.shard(o, ba, None, None, None, None)
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


def split_heads(ctx: ParallelCtx, t: torch.Tensor, n: int,
                hd: int) -> torch.Tensor:
    """A projection (..., n*hd) as (..., n, hd), its last dim alone split.
    Where the model axis does not divide ``n`` the projection is gathered
    over it first, as the head constraint that follows asks: a view cannot
    split a dim sharded 16 ways into 4 heads."""
    if ctx.mesh is not None and ctx.head_axis(n) is None:
        t = ctx.rows(t)
    return t.unflatten(-1, (n, hd))


def by_heads(ctx: ParallelCtx, core, q, k, v) -> torch.Tensor:
    """``core(q, k, v, ctx)`` -- an attention over (B, S, H, hd) -- run by
    each rank on its own rows and query heads, where the batch and the
    heads split evenly over the mesh: the queries placed as (batch axes,
    -, model, -), each rank's block given to ``core`` as plain tensors
    (with a plain context) beside the key and value heads its query heads
    read (:func:`_kv_block`), and the output put back with the queries'
    placements.  Attention is independent across rows and heads, so
    nothing crosses ranks.  DTensor itself would fold the batch and head
    dims into one batch dim of its ``bmm``, and to fold two sharded dims
    it gathers the heads whole.  Elsewhere ``core`` runs on the DTensors
    (or plain tensors) as given."""
    placements = rows_and_heads(ctx, q)
    if placements is None:
        return core(q, k, v)
    ql = ctx.shard(q, ctx.batch_axes or None, None, ctx.model_axis,
                   None).to_local()
    kl, vl = (_kv_block(ctx, t, q.shape[2]) for t in (k, v))
    o = core(ql, kl, vl, ctx=ctx.plain())
    return DTensor.from_local(o, ctx.mesh, placements, run_check=False)


def rows_and_heads(ctx: ParallelCtx, x, heads: int = 2) -> Optional[tuple]:
    """The placements of ``x`` (rows first, heads on dim ``heads``) split
    by rows over the batch axes and by heads over the model axis, where
    ``x`` is a DTensor and both split evenly; else None."""
    mesh = ctx.mesh
    if not isinstance(x, DTensor) or ctx.head_axis(x.shape[heads]) is None:
        return None
    spec = [None] * x.ndim
    spec[0], spec[heads] = ctx.batch_axes or None, ctx.model_axis
    placements = spec_placements(mesh, spec)
    n_rows = math.prod(mesh.size(i) for i, p in enumerate(placements)
                       if p.is_shard(0))
    return None if x.shape[0] % n_rows else placements


def local_param(ctx: ParallelCtx, t: DTensor, *spec) -> torch.Tensor:
    """This rank's block of parameter ``t`` placed by ``spec``, for a
    computation on the rank's own rows: its gradient a partial sum over
    the mesh axes that split the rows."""
    placed = ctx.shard(t, *spec)
    names = ctx.mesh.mesh_dim_names
    return placed.to_local(grad_placements=[
        Partial() if names[i] in ctx.batch_axes else p
        for i, p in enumerate(placed.placements)])


def _kv_block(ctx: ParallelCtx, t: DTensor, n_q: int) -> torch.Tensor:
    """This rank's key (or value) heads for its block of ``n_q`` query
    heads split over the model axis, repeated as ``_repeat_kv`` repeats
    them (query head ``i`` reads head ``i // n_rep``): split over the
    model axis too where it divides them, else whole on every rank and
    the heads this rank reads picked out (their gradient then a partial
    sum over the model axis)."""
    ba = ctx.batch_axes or None
    n_kv = t.shape[2]
    n_rep = n_q // n_kv
    if n_kv % ctx.model_size == 0:
        local = ctx.shard(t, ba, None, ctx.model_axis, None).to_local()
        return _repeat_kv(local, n_rep)
    whole = ctx.shard(t, ba, None, None, None)
    names = ctx.mesh.mesh_dim_names
    local = whole.to_local(grad_placements=[
        Partial() if names[i] == ctx.model_axis else p
        for i, p in enumerate(whole.placements)])
    per = n_q // ctx.model_size
    first = ctx.mesh.get_local_rank(ctx.model_axis) * per
    heads = torch.arange(first, first + per, device=local.device) // n_rep
    return local[:, :, heads]


def merge_heads(ctx: ParallelCtx, o: torch.Tensor) -> torch.Tensor:
    """Heads (..., n, hd) merged as (..., n*hd).  Where the model axis
    does not divide ``n`` the merged tensor is made whole on the model
    axis, and so is its gradient: the backward's view cannot split a
    gradient sharded over the model axis into ``n`` heads."""
    n = o.shape[-2]
    o = o.flatten(-2)
    if ctx.mesh is not None and ctx.head_axis(n) is None:
        o = ctx.rows(o)
    return o


def _project_qkv(p, x, cfg, positions, ctx: ParallelCtx,
                 use_rope: bool = True):
    hd = cfg.hd
    q = split_heads(ctx, ctx.proj(x, p["wq"]), cfg.n_heads, hd)
    k = split_heads(ctx, ctx.proj(x, p["wk"]), cfg.n_kv, hd)
    v = split_heads(ctx, ctx.proj(x, p["wv"]), cfg.n_kv, hd)
    if ctx.batch_axes or ctx.model_axis:
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
    S = x.shape[1]
    causal = kind != "enc"
    q, k, v = _project_qkv(p, x, cfg, positions, ctx)

    def core(q, k, v, ctx=ctx):
        if ctx.use_kernels:
            window = cfg.window if kind == "local" else None
            return fa_kernel.flash_attention(q, k, v, causal=causal,
                                             window=window,
                                             softcap=cfg.attn_softcap)
        if kind == "local":
            return local_attention_jnp(q, k, v, window=cfg.window,
                                       softcap=cfg.attn_softcap, ctx=ctx)
        if S >= ctx.flash_threshold and causal:
            return flash_attention_jnp(q, k, v, causal=True,
                                       softcap=cfg.attn_softcap,
                                       block=ctx.flash_block, ctx=ctx)
        return full_attention(q, k, v, causal=causal,
                              softcap=cfg.attn_softcap, ctx=ctx)
    o = by_heads(ctx, core, q, k, v)
    o = ctx.proj(merge_heads(ctx, o), p["wo"])
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
    q, k, v = _project_qkv(p, x, cfg, positions[:, None], ctx)
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
    o = ctx.proj(merge_heads(ctx, o), p["wo"])
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
    act = gelu if cfg.act == "gelu" else F.silu
    h = act(ctx.proj(x, p["wg"])) * ctx.proj(x, p["wu"])
    h = ctx.shard(h, ctx.batch_axes or None, None, ctx.model_axis)
    return ctx.proj(h, p["wd"])
