"""Batched slowdown factor aggregation (H-EYE section 3.4).

    factor[i] = max(1, (1 + mt_term[i])
                       * prod_r(1 + beta[r]*x[i,r]*(1+kappa*x[i,r]) * mem[i]))

Replaces the TPU kernel ``repro/kernels/slowdown_kernel.py``
(``slowdown_factors_pallas`` / ``_factors_kernel``), which computes in
float32 over 256-row tiles with the class axis padded to the lane width.
Here the kernel is CUDA C++ in float64 (``csrc/slowdown_factors.cu``): one
thread per row, the product taken in ascending class order so that it
agrees with :func:`slowdown_factors_plain` to the bit, no padding.  It is
bound by bytes moved (each row read once, one double written) and, at
the pool sizes the scheduler produces, by launch latency.

``slowdown_factors`` is the wrapper every ``_aggregate`` site of
``core/slowdown.py`` calls: the plain version for CPU tensors, the CUDA
kernel for CUDA tensors (or an exception — there is no fallback).
"""
from __future__ import annotations

import torch

from . import build

launches = 0          # kernel launches made by the wrapper (not the plain path)


def slowdown_factors_plain(x: torch.Tensor, beta: torch.Tensor,
                           mem: torch.Tensor, mt_term: torch.Tensor,
                           kappa: float) -> torch.Tensor:
    """Plain PyTorch version (float64) of the factor aggregation."""
    b = beta[None, :]
    term = torch.where((x > 0.0) & (b > 0.0),
                       b * x * (1.0 + kappa * x), torch.zeros_like(x))
    prod = torch.prod(1.0 + term * mem[:, None], dim=-1)
    return torch.maximum((1.0 + mt_term) * prod, torch.ones_like(mt_term))


def slowdown_factors(x: torch.Tensor, beta: torch.Tensor, mem: torch.Tensor,
                     mt_term: torch.Tensor, kappa: float) -> torch.Tensor:
    """(N, R) pressures -> (N,) factors."""
    dev = x.device
    build.check_tensor("x", x, torch.float64, 2, dev)
    build.check_tensor("beta", beta, torch.float64, 1, dev)
    build.check_tensor("mem", mem, torch.float64, 1, dev)
    build.check_tensor("mt_term", mt_term, torch.float64, 1, dev)
    n, r = x.shape
    if beta.shape[0] != r or mem.shape[0] != n or mt_term.shape[0] != n:
        raise ValueError("shape mismatch: x %s beta %s mem %s mt_term %s" % (
            tuple(x.shape), tuple(beta.shape), tuple(mem.shape),
            tuple(mt_term.shape)))
    if dev.type == "cpu":
        return slowdown_factors_plain(x, beta, mem, mt_term, kappa)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    global launches
    out = torch.empty(n, dtype=torch.float64, device=dev)
    if n == 0:
        return out
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.heye_slowdown_factors(
            x.data_ptr(), beta.data_ptr(), mem.data_ptr(),
            mt_term.data_ptr(), out.data_ptr(), n, r, float(kappa),
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, "slowdown_factors")
    launches += 1
    return out
