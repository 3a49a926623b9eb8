"""Flash attention (online softmax), forward: causal, optional sliding
``window``, optional logit ``softcap``, GQA / MQA.

Replaces the TPU kernel ``repro/kernels/flash_attention.py:95``
(``flash_attention_bhsd`` / ``_attn_kernel``, wrapper ``flash_attention``
:141, reached through ``repro/kernels/ops.py:21``).  Here the kernel is
CUDA C++, one kernel per dtype, each compiled once per head dim:

* **bfloat16** (the serving dtype): ``csrc/flash_attention_tc.cuh``
  (``flash_attention_tc_hd*.cu``), Hopper's tensor cores.  A producer
  thread feeds Q and a ring of K / V tiles through TMA (4-D tensor maps
  over the model's layout, in boxes of the widest of 64, 32 or 16 columns
  that divides hd); consumer warpgroups of 64 query rows run ``wgmma``
  for Q.K^T and P.V with the online softmax in registers between them.
  The softmax is overlapped with the products twice over: each warpgroup
  issues Q.K^T of tile n and P.V of tile n-1 together and runs the
  softmax of tile n while P.V is in flight (FlashAttention-3's
  intra-warpgroup pipeline), and named barriers pass the turn to issue
  products from one warpgroup to the next (ping-pong), so one
  warpgroup's products run under another's softmax.  Tiles are per head
  dim, :data:`BF16_TILES`: 128-key tiles at hd <= 128 (three warpgroups,
  192 query rows, at hd 64; two elsewhere), 64-key tiles at hd 256.  The
  row sums come from the tensor cores (P.V runs over V and a box of
  ones, hd + 8 wide; at hd 256 they stay on the CUDA cores), and without
  a soft cap the scale is folded into the exponent (one FFMA and one
  ``exp2`` a score).  P is rounded to bfloat16 before P.V, where the
  reference keeps it in float32 (see :data:`BF16_REL`).
* **float32**: ``csrc/flash_attention.cuh`` (``flash_attention_hd*.cu``),
  CUDA cores, float32 math throughout: one thread block per (b, h) and
  64-row query tile, a loop over 32-key kv tiles.

Both read the model's (B, S, H, hd) layout directly, map query head h to
kv head ``h // (Hq // Hkv)`` without repeating k/v, and skip only kv tiles
that are masked for every row of the query tile.  Both are bound by
operations: live (q, k) pairs x 4*hd flops.  ``csrc/flash_attention.cu``
is the C entry point; it encodes the tensor maps.

Shapes: q (B, S, Hq, hd), k and v (B, S, Hkv, hd), float32 or bfloat16
(all three the same), out (B, S, Hq, hd) in ``q.dtype``; ``Hkv`` divides
``Hq``.  **Any S is taken**: the kernels mask the ragged last tile, where
the reference kernel raises ``ValueError`` for an S its block size does
not divide.  The kernels are built for hd in :data:`KERNEL_HEAD_DIMS`.

``flash_attention`` is the wrapper ``models/layers.py`` calls: the plain
version for CPU tensors, the kernel of the tensor's dtype for CUDA tensors
(or an exception; there is no fallback).  It is forward only: with autograd
recording and an input that requires grad it raises on every device
(``build.refuse_grad``); training takes ``use_kernels=False``.
"""
from __future__ import annotations

import collections
import math
from typing import Optional

import torch

from . import build

NEG_INF = -2.0 ** 30            # the reference's finite mask value
KERNEL_HEAD_DIMS = (16, 32, 64, 96, 128, 256)
# The bf16 kernel's tiles per head dim, as its source sets them
# (``fatc::Tiles`` in csrc/flash_attention_tc.cuh; the library exports them
# through ``heye_fa_tc_tiles``, see :func:`kernel_tiles`): query rows a
# block (the grid's second dimension is ceil(S / rows)), keys a kv tile,
# kv tiles in the ring.
BF16_TILES = {
    16: (128, 128, 4),
    32: (128, 128, 4),
    64: (192, 128, 4),
    96: (128, 128, 3),
    128: (128, 128, 2),
    256: (128, 64, 2),
}

launches = 0          # kernel launches made by the wrapper (not the plain path)
# the same launches by (B, S, Hq, Hkv, hd, causal, window, softcap)
launches_by_shape: collections.Counter = collections.Counter()

# What the bf16 kernel is held to against flash_attention_plain on the same
# inputs: |kernel - plain| <= BF16_REL * |plain| + BF16_ROW * rms(plain over
# that (b, i, h) row's hd entries).  The plain version keeps P in float32
# and rounds only the output; the kernel also rounds P to bf16 (2^-8
# relative each) before P.V, so an output near 0, a sum of terms that
# cancel, carries an error that scales with its row and not with itself.
# The first term is one bf16 step of the output, the second the rounded P.
BF16_REL = 2.0 ** -7
BF16_ROW = 2.0 ** -6


def bf16_allowed(plain: torch.Tensor) -> torch.Tensor:
    """The allowed |kernel - plain| of a bf16 call, element by element."""
    p = plain.double()
    rms = p.pow(2).mean(-1, keepdim=True).sqrt()
    return BF16_REL * p.abs() + BF16_ROW * rms


def attention_mask(S: int, causal: bool, window: Optional[int],
                   device) -> torch.Tensor:
    """(S, S) bool: True where query i may attend key j."""
    pos = torch.arange(S, device=device)
    mask = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: Optional[int] = None,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version: masked softmax attention, all math fp32, the
    masked scores set to the finite ``NEG_INF``; out in ``q.dtype``."""
    B, S, Hq, hd = q.shape
    rep = Hq // k.shape[2]
    qf = q.float()
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * (1.0 / math.sqrt(hd))
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = attention_mask(S, causal, window, q.device)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def launch_key(B: int, S: int, Hq: int, Hkv: int, hd: int, causal: bool,
               window: Optional[int], softcap: Optional[float]) -> tuple:
    """The key of :data:`launches_by_shape` for one call's shape and mask."""
    return (B, S, Hq, Hkv, hd, bool(causal),
            None if window is None else int(window),
            None if softcap is None else float(softcap))


def kernel_tiles(hd: int) -> tuple:
    """The bf16 kernel's (query rows, keys, stages) at head dim ``hd``, as
    the built library reports them (needs the CUDA build)."""
    import ctypes
    out = [ctypes.c_int() for _ in range(3)]
    err = build.load().heye_fa_tc_tiles(hd, *(ctypes.byref(c) for c in out))
    if err:
        raise ValueError(f"the bf16 kernel has no tiles at hd {hd}")
    return tuple(c.value for c in out)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """(B,S,Hq,hd) x (B,S,Hkv,hd) -> (B,S,Hq,hd); see the module docstring."""
    build.refuse_grad("flash_attention", q, k, v)
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    build.check_tensor("q", q, q.dtype, 4, dev)
    build.check_tensor("k", k, q.dtype, 4, dev)
    build.check_tensor("v", v, q.dtype, 4, dev)
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    if (k.shape != v.shape or k.shape[0] != B or k.shape[1] != S
            or k.shape[3] != hd or Hkv == 0 or Hq % Hkv):
        raise ValueError("shape mismatch: q %s k %s v %s" % (
            tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in the kernel's {KERNEL_HEAD_DIMS}")
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        # grid (B*Hq, q tiles); TMA reads from 16-byte aligned addresses
        check_bf16_grid(B, S, Hq, hd)
        if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
            raise ValueError("q, k and v must start at 16-byte aligned "
                             "addresses")
    elif B * Hq > 65535:
        raise ValueError(f"B*Hq = {B * Hq} exceeds the kernel's grid")
    global launches
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = build.load()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, Hq, Hkv, hd, int(bf16), int(causal),
            int(window) if window is not None else 0,
            1.0 / math.sqrt(hd), float(softcap) if softcap is not None else 0.0,
            build.raw_stream(dev.index))
    # the device is entered only where it is not the current one
    if dev.index == torch.cuda.current_device():
        err = lib.heye_flash_attention(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.heye_flash_attention(*args)
    build.check_launch(err, "flash_attention")
    launches += 1
    launches_by_shape[launch_key(B, S, Hq, Hkv, hd, causal, window,
                                 softcap)] += 1
    return out


def check_bf16_grid(B: int, S: int, Hq: int, hd: int) -> None:
    """Raise where the bf16 kernel's grid, (B*Hq, ceil(S / rows)) with the
    query rows of :data:`BF16_TILES` at ``hd``, exceeds CUDA's limits."""
    if -(-S // BF16_TILES[hd][0]) > 65535 or B * Hq > 2 ** 31 - 1:
        raise ValueError(f"S = {S}, B*Hq = {B * Hq} exceed the kernel's grid")
