"""Linear-recurrence scan ``h_t = a_t * h_{t-1} + b_t`` (h_0 = 0) over axis 1
of (B, S, W) float32 tensors: the compute core of the RG-LRU block.

Replaces the TPU kernel ``repro/kernels/lru_scan.py:45``
(``lru_scan_pallas`` / ``_lru_kernel``, reached through
``repro/kernels/ops.py:31``, which pads W and searches a time-chunk size
for the TPU's tiling).  Here the kernel is CUDA C++
(``csrc/lru_scan.cu``): each channel's chain runs in one thread, walking
t in a register, and is fed from a ring of (64 steps x 32 channels)
boxes of ``a`` and ``b`` in shared memory that the Tensor Memory
Accelerator keeps full (one warp per 32 channels of a batch row, six
stages on mbarriers); ``h`` goes back in coalesced 128-byte rows.  Any S
and W: boxes past the ends read as zeros and the walk stops at S; inputs
TMA cannot describe (W not a multiple of 4, unaligned bases) take a
thread-per-channel kernel with the same arithmetic.  It is bound by
bytes (3*B*S*W*4: a and b read once, h written once).  Products and sums
are rounded separately, so the kernel agrees to the bit with
:func:`lru_scan_plain`.

``lru_scan`` is the wrapper ``models/recurrent.py`` calls: the plain
version for CPU tensors, the kernel for CUDA tensors (or an exception;
there is no fallback).
"""
from __future__ import annotations

import torch

from . import build

launches = 0          # kernel launches made by the wrapper (not the plain path)


def lru_scan_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a loop over t, two ops per step."""
    B, S, W = a.shape
    out = torch.empty_like(a)
    h = torch.zeros((B, W), dtype=a.dtype, device=a.device)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


def lru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, S, W) float32 a, b -> (B, S, W) float32 h."""
    dev = a.device
    build.check_tensor("a", a, torch.float32, 3, dev)
    build.check_tensor("b", b, torch.float32, 3, dev)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: a {tuple(a.shape)} b {tuple(b.shape)}")
    if dev.type == "cpu":
        return lru_scan_plain(a, b)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    global launches
    B, S, W = a.shape
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.heye_lru_scan(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                B, S, W,
                                torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, "lru_scan")
    launches += 1
    return out
