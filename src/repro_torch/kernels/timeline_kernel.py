"""The DES timeline engine's two batched inner loops.

* **rate-advance** — settle each job's remaining virtual work to the
  shared timestamp and project its completion:
  ``W' = max(0, W - rate*(now - t_last))`` (a NaN residue, the
  ``inf * 0`` corner of infinite-bandwidth transfers, clamps to 0) and
  ``eta = now + W'/rate`` (+inf where the rate is not positive).
  ``settle`` is the same kernel without ``eta`` (compute jobs).
* **segment-min** — a transfer's bottleneck bandwidth is the min of its
  route edges' fair shares, evaluated for a whole dirty set as one
  segmented reduction over CSR ``(values, starts, counts)``; an empty
  segment yields +inf.

Replaces the TPU kernels of ``repro/kernels/timeline_kernel.py``
(``rate_advance_pallas`` / ``_rate_advance_kernel`` and
``segment_min_pallas`` / ``_segment_min_kernel``), which compute in
float32, bake ``now`` into the compiled kernel, and densify the CSR
layout on the host.  Here both are CUDA C++ in float64
(``csrc/rate_advance.cu``, ``csrc/segment_min.cu``); ``now`` is a run-time
argument and the CSR arrays are consumed where they lie on the device.
Both are bound by bytes moved (every element read once) and, at the
sizes one flush produces, by launch latency.

The wrappers take the plain version for CPU tensors and launch the
kernel for CUDA tensors (or raise — there is no fallback).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build

# launches per kernel form: the full rate-advance, its settle-only form,
# and the segment-min
launches = {"rate_advance": 0, "settle": 0, "segment_min": 0}


# ---------------------------------------------------------------------------
# plain PyTorch versions (float64)
# ---------------------------------------------------------------------------
def rate_advance_plain(W: torch.Tensor, rate: torch.Tensor,
                       t_last: torch.Tensor, now: float
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    raw = W - rate * (now - t_last)
    W2 = torch.where(raw > 0.0, raw, torch.zeros_like(raw))   # NaN -> 0
    eta = torch.where(rate > 0.0, now + W2 / rate,
                      torch.full_like(W2, float("inf")))
    return W2, eta


def settle_plain(W: torch.Tensor, rate: torch.Tensor, t_last: torch.Tensor,
                 now: float) -> torch.Tensor:
    raw = W - rate * (now - t_last)
    return torch.where(raw > 0.0, raw, torch.zeros_like(raw))


def segment_min_plain(values: torch.Tensor, starts: torch.Tensor,
                      counts: torch.Tensor) -> torch.Tensor:
    S = counts.shape[0]
    out = torch.full((S,), float("inf"), dtype=torch.float64,
                     device=values.device)
    K = int(counts.sum()) if S else 0
    if K == 0:
        return out
    seg = torch.repeat_interleave(
        torch.arange(S, device=values.device), counts)
    offs = torch.cumsum(counts, 0) - counts
    within = torch.arange(K, device=values.device) - offs[seg]
    vals = values[starts[seg] + within]
    return out.scatter_reduce(0, seg, vals, reduce="amin", include_self=True)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def _rate_advance(W, rate, t_last, now, with_eta: bool):
    dev = W.device
    for name, t in (("W", W), ("rate", rate), ("t_last", t_last)):
        build.check_tensor(name, t, torch.float64, 1, dev)
    n = W.shape[0]
    if rate.shape[0] != n or t_last.shape[0] != n:
        raise ValueError("W, rate and t_last must have one length")
    now = float(now)
    if dev.type == "cpu":
        if with_eta:
            return rate_advance_plain(W, rate, t_last, now)
        return settle_plain(W, rate, t_last, now), None
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    W2 = torch.empty(n, dtype=torch.float64, device=dev)
    eta: Optional[torch.Tensor] = (
        torch.empty(n, dtype=torch.float64, device=dev) if with_eta else None)
    if n == 0:
        return W2, eta
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.heye_rate_advance(
            W.data_ptr(), rate.data_ptr(), t_last.data_ptr(), W2.data_ptr(),
            eta.data_ptr() if with_eta else None, n, now,
            1 if with_eta else 0, torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, "rate_advance")
    launches["rate_advance" if with_eta else "settle"] += 1
    return W2, eta


def rate_advance(W: torch.Tensor, rate: torch.Tensor, t_last: torch.Tensor,
                 now: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Settle to ``now`` and project completions: ``(W', eta)``."""
    return _rate_advance(W, rate, t_last, now, True)


def settle(W: torch.Tensor, rate: torch.Tensor, t_last: torch.Tensor,
           now: float) -> torch.Tensor:
    """Settle-only form of :func:`rate_advance`: ``W'``."""
    return _rate_advance(W, rate, t_last, now, False)[0]


def segment_min(values: torch.Tensor, starts: torch.Tensor,
                counts: torch.Tensor) -> torch.Tensor:
    """Min over each CSR segment ``values[starts[s] : starts[s]+counts[s]]``."""
    dev = values.device
    build.check_tensor("values", values, torch.float64, 1, dev)
    build.check_tensor("starts", starts, torch.int64, 1, dev)
    build.check_tensor("counts", counts, torch.int64, 1, dev)
    S = counts.shape[0]
    if starts.shape[0] != S:
        raise ValueError("starts and counts must have one length")
    if dev.type == "cpu":
        return segment_min_plain(values, starts, counts)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty(S, dtype=torch.float64, device=dev)
    if S == 0:
        return out
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.heye_segment_min(
            values.data_ptr(), starts.data_ptr(), counts.data_ptr(),
            out.data_ptr(), S, torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, "segment_min")
    launches["segment_min"] += 1
    return out
