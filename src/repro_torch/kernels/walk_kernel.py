"""The fused Alg. 1 subtree-scan accounting reduce.

The wave-batched orchestrator walk lowers each hierarchical frontier
expansion to arrays over a *scan plan* — the preorder of one ORC
subtree: per node its subtree PU range ``[pu_lo, pu_hi)``, own leaf
count, child count, summed hop cost to its children and depth below the
scan root.  Given the constraint check's ``ok``/``key`` vectors over the
plan's PU order, the whole recursive TraverseChildren replay collapses
to one reduce:

    feas[n]  = any(ok[pu_lo[n]:pu_hi[n]])
    winner   = first feasible position attaining the minimum key
               (feasible even when every key is +inf; -1 when the scan
               root is infeasible)
    queries  = sum(leafcnt[feas])
    hops     = sum(nchild[feas])
    overhead = sum(hopsum[feas] + lqc*leafcnt[feas]*(depth[feas]+1))

Replaces ``repro/kernels/walk_kernel.py`` ``scan_reduce`` (there a
``jax.jit`` of ``_jax_reduce_raw``, which without 64-bit mode runs in
int32/float32); the port's counterpart is held against that module's
``scan_reduce_ref``.  Here it is a CUDA C++ kernel in float64/int64
(``csrc/scan_reduce.cu``), one block per scan, bound by bytes moved and
at device-scan sizes by launch latency.  ``winner``/``queries``/``hops``
are exact; ``overhead`` may differ from a sequential sum by
float-associativity ulps (the decisions never read it).

The wrapper returns ONE 4-element float64 tensor ``[winner, queries,
hops, overhead]`` on the inputs' device, so the caller reads the result
with a single copy; it takes the plain version for CPU tensors and
launches the kernel for CUDA tensors (or raises).
"""
from __future__ import annotations

import torch

from . import build

launches = 0


def scan_reduce_plain(ok: torch.Tensor, key: torch.Tensor,
                      pu_lo: torch.Tensor, pu_hi: torch.Tensor,
                      leafcnt: torch.Tensor, nchild: torch.Tensor,
                      hopsum: torch.Tensor, depth: torch.Tensor,
                      lqc: float) -> torch.Tensor:
    """Plain PyTorch version: ``[winner, queries, hops, overhead]``."""
    dev = ok.device
    cs = torch.zeros(ok.shape[0] + 1, dtype=torch.int64, device=dev)
    cs[1:] = torch.cumsum(ok.to(torch.int64), 0)
    feas = cs[pu_hi] > cs[pu_lo]
    inf = torch.full_like(key, float("inf"))
    masked = torch.where(ok, key, inf)
    kmin = masked.min() if key.numel() else inf.sum()
    # first feasible index attaining the feasible-row minimum (inf-safe:
    # when every feasible key is +inf, `masked == kmin` holds everywhere
    # and `ok &` keeps the first feasible row)
    cand = ok & (masked == kmin)
    w = torch.argmax(cand.to(torch.uint8)).to(torch.float64) \
        if key.numel() else torch.zeros((), dtype=torch.float64, device=dev)
    zi = torch.zeros_like(leafcnt)
    queries = torch.where(feas, leafcnt, zi).sum()
    hops = torch.where(feas, nchild, zi).sum()
    terms = hopsum + lqc * leafcnt.to(torch.float64) * (depth + 1.0)
    overhead = torch.where(feas, terms, torch.zeros_like(terms)).sum()
    out = torch.stack([w, queries.to(torch.float64),
                       hops.to(torch.float64), overhead])
    root_ok = feas[0] if feas.numel() else torch.zeros(
        (), dtype=torch.bool, device=dev)
    none = torch.tensor([-1.0, 0.0, 0.0, 0.0], dtype=torch.float64,
                        device=dev)
    return torch.where(root_ok, out, none)


def scan_reduce(ok: torch.Tensor, key: torch.Tensor, pu_lo: torch.Tensor,
                pu_hi: torch.Tensor, leafcnt: torch.Tensor,
                nchild: torch.Tensor, hopsum: torch.Tensor,
                depth: torch.Tensor, lqc: float) -> torch.Tensor:
    """One scan's ``[winner, queries, hops, overhead]`` (float64, on the
    inputs' device; integers are exact below 2**53)."""
    dev = ok.device
    build.check_tensor("ok", ok, torch.bool, 1, dev)
    build.check_tensor("key", key, torch.float64, 1, dev)
    for name, t in (("pu_lo", pu_lo), ("pu_hi", pu_hi),
                    ("leafcnt", leafcnt), ("nchild", nchild)):
        build.check_tensor(name, t, torch.int64, 1, dev)
    build.check_tensor("hopsum", hopsum, torch.float64, 1, dev)
    build.check_tensor("depth", depth, torch.float64, 1, dev)
    P = ok.shape[0]
    Nn = pu_lo.shape[0]
    if key.shape[0] != P:
        raise ValueError("ok and key must have one length")
    if any(t.shape[0] != Nn for t in (pu_hi, leafcnt, nchild, hopsum, depth)):
        raise ValueError("plan arrays must have one length")
    if Nn == 0:
        raise ValueError("a scan plan has at least its root node")
    if P >= 2 ** 31:
        raise ValueError("scan too long for the int32 prefix scratch")
    lqc = float(lqc)
    if dev.type == "cpu":
        return scan_reduce_plain(ok, key, pu_lo, pu_hi, leafcnt, nchild,
                                 hopsum, depth, lqc)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    global launches
    out = torch.empty(4, dtype=torch.float64, device=dev)
    cs = torch.empty(P + 1, dtype=torch.int32, device=dev)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.heye_scan_reduce(
            ok.data_ptr(), key.data_ptr(), pu_lo.data_ptr(), pu_hi.data_ptr(),
            leafcnt.data_ptr(), nchild.data_ptr(), hopsum.data_ptr(),
            depth.data_ptr(), cs.data_ptr(), out.data_ptr(), P, Nn, lqc,
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, "scan_reduce")
    launches += 1
    return out
