"""The fused Alg. 1 subtree-scan accounting reduce, one scan or a stack.

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

Each scan's result is SEVEN float64 values, ``[winner, queries, hops,
overhead, sa[w], f[w], cm[w]]`` — the winner's prediction columns are
gathered with it — or ``[-1, 0, 0, 0, 0, 0, 0]`` when the root is
infeasible, so the caller reads a scan (or a whole stack) with one copy.

Replaces ``repro/kernels/walk_kernel.py`` ``scan_reduce`` and
``scan_reduce_batch`` (there a ``jax.jit`` of ``_jax_reduce_raw`` and a
``jax.jit(jax.vmap)`` of it over same-shape stacks, which without 64-bit
mode run in int32/float32); the port's counterparts are held against
that module's ``scan_reduce_ref``, row by row.  Here both are ONE CUDA
C++ kernel in float64/int64 (``csrc/scan_reduce.cu``) over a *ragged*
stack: ``ok``/``key``/``sa``/``f``/``cm`` concatenated with per-scan
offsets, the plan arrays concatenated with per-scan node offsets
(:class:`ScanPlanArrays`, checked once per plan), one warp per scan of at
most ``WARP_MAX_P`` PUs and one block per larger scan up to
``BLOCK_MAX_P``; a scan of more PUs takes the whole grid in four launches
of its own (the reference has no cap, so neither has the port).  A single
scan is the stack of one (:func:`scan_reduce`); a phase-1 wave's entry
scans are one launch (:func:`scan_reduce_batch`).  Bound by bytes moved
and, at the walk's sizes, by launch latency.  ``winner``/``queries``/``hops`` and
the gathered columns are exact; ``overhead`` may differ from a
sequential sum by float-associativity ulps (the decisions never read it).

The wrappers take the plain versions for CPU tensors and launch the
kernel for CUDA tensors (or raise).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import build

# launches per entry point: a single scan, a stack of scans
launches = {"scan_reduce": 0, "scan_reduce_batch": 0}

# scans of at most this many PUs take one warp (a lane per PU), larger
# ones a block of their own, whose bit words of `ok` fill 32 KB of shared
# memory at BLOCK_MAX_P PUs; a scan of more PUs takes the grid form, its
# bit words in a global scratch (csrc/scan_reduce.cu)
WARP_MAX_P = 32
BLOCK_MAX_P = 131072

_F64 = torch.float64
_I64 = torch.int64


def _check_ranges(pu_lo, pu_hi) -> np.ndarray:
    """Raise unless every node range is ``0 <= pu_lo <= pu_hi``; returns
    ``pu_hi`` as a host array."""
    lo = np.asarray(pu_lo, dtype=np.int64)
    hi = np.asarray(pu_hi, dtype=np.int64)
    if ((lo < 0) | (hi < lo)).any():
        raise ValueError("plan node ranges must be 0 <= pu_lo <= pu_hi")
    return hi


class ScanPlanArrays:
    """The node arrays of one scan plan, or of several concatenated (each
    plan's ``pu_lo``/``pu_hi`` relative to its own PU order), checked once
    here instead of at every launch.  ``hi`` keeps ``pu_hi`` on the host,
    so a launch checks on the host that each scan's nodes lie within its
    PUs; ``span`` is its largest value.  Build it with :meth:`from_lists`,
    which checks the ranges on the host."""

    __slots__ = ("pu_lo", "pu_hi", "leafcnt", "nchild", "hopsum", "depth",
                 "n", "hi", "span", "device")

    def __init__(self, pu_lo: torch.Tensor, pu_hi: torch.Tensor,
                 leafcnt: torch.Tensor, nchild: torch.Tensor,
                 hopsum: torch.Tensor, depth: torch.Tensor,
                 hi: np.ndarray) -> None:
        dev = pu_lo.device
        for name, t in (("pu_lo", pu_lo), ("pu_hi", pu_hi),
                        ("leafcnt", leafcnt), ("nchild", nchild)):
            build.check_tensor(name, t, _I64, 1, dev)
        build.check_tensor("hopsum", hopsum, _F64, 1, dev)
        build.check_tensor("depth", depth, _F64, 1, dev)
        n = pu_lo.shape[0]
        if any(t.shape[0] != n for t in (pu_hi, leafcnt, nchild, hopsum,
                                         depth)) or hi.shape != (n,):
            raise ValueError("plan arrays must have one length")
        if n == 0:
            raise ValueError("a scan plan has at least its root node")
        self.pu_lo, self.pu_hi = pu_lo, pu_hi
        self.leafcnt, self.nchild = leafcnt, nchild
        self.hopsum, self.depth = hopsum, depth
        self.n, self.hi, self.device = n, hi, dev
        self.span = int(hi.max())

    @classmethod
    def from_lists(cls, pu_lo, pu_hi, leafcnt, nchild, hopsum, depth,
                   device: torch.device) -> "ScanPlanArrays":
        """From host sequences: two copies to ``device`` (the int64 and
        the float64 columns), each column a row of one of them."""
        hi = _check_ranges(pu_lo, pu_hi)
        ints = torch.as_tensor(np.asarray([pu_lo, pu_hi, leafcnt, nchild],
                                          dtype=np.int64), device=device)
        flts = torch.as_tensor(np.asarray([hopsum, depth], dtype=np.float64),
                               device=device)
        return cls(ints[0], ints[1], ints[2], ints[3], flts[0], flts[1],
                   hi=hi)

    def tensors(self) -> tuple:
        return (self.pu_lo, self.pu_hi, self.leafcnt, self.nchild,
                self.hopsum, self.depth)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------
def _none_row(dev) -> torch.Tensor:
    return torch.tensor([-1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], dtype=_F64,
                        device=dev)


def scan_reduce_batch_plain(ok: torch.Tensor, key: torch.Tensor,
                            sa: torch.Tensor, f: torch.Tensor,
                            cm: torch.Tensor, pu_lo: torch.Tensor,
                            pu_hi: torch.Tensor, leafcnt: torch.Tensor,
                            nchild: torch.Tensor, hopsum: torch.Tensor,
                            depth: torch.Tensor, meta: torch.Tensor,
                            lqc: float) -> torch.Tensor:
    """Plain PyTorch version of a ragged stack (a single scan is the stack
    of one), without a loop over the scans: ``meta`` is ``(S, 4)`` int64
    rows ``[ok_off, P, node_off, Nn]`` (``Nn >= 1``); returns ``(S, 7)``."""
    dev = ok.device
    S = meta.shape[0]
    if ok.shape[0] == 0:                 # no PU anywhere: every root fails
        return _none_row(dev).repeat(S, 1)
    ok_off, P, node_off, Nn = meta.unbind(1)
    scan_ids = torch.arange(S, device=dev)
    # every scan's nodes, flattened
    n_nodes = int(Nn.sum())
    nsid = torch.repeat_interleave(scan_ids, Nn, output_size=n_nodes)
    nfirst = torch.cumsum(Nn, 0) - Nn
    nidx = node_off[nsid] + torch.arange(n_nodes, device=dev) - nfirst[nsid]
    cs = torch.zeros(ok.shape[0] + 1, dtype=_I64, device=dev)
    cs[1:] = torch.cumsum(ok.to(_I64), 0)
    base = ok_off[nsid]
    feas = cs[base + pu_hi[nidx]] > cs[base + pu_lo[nidx]]
    zi = torch.zeros(S, dtype=_I64, device=dev)
    queries = zi.index_add(0, nsid, torch.where(feas, leafcnt[nidx], 0))
    hops = zi.index_add(0, nsid, torch.where(feas, nchild[nidx], 0))
    terms = hopsum[nidx] + lqc * leafcnt[nidx].to(_F64) * (depth[nidx] + 1.0)
    overhead = torch.zeros(S, dtype=_F64, device=dev).index_add(
        0, nsid, torch.where(feas, terms, torch.zeros_like(terms)))
    root_ok = feas[nfirst]
    # every scan's PUs, flattened: (key, position) argmin per scan
    n_pus = int(P.sum())
    psid = torch.repeat_interleave(scan_ids, P, output_size=n_pus)
    pos = torch.arange(n_pus, device=dev) - (torch.cumsum(P, 0) - P)[psid]
    gidx = ok_off[psid] + pos
    okg = ok[gidx]
    masked = torch.where(okg, key[gidx], torch.full((n_pus,), float("inf"),
                                                    dtype=_F64, device=dev))
    inf = torch.full((S,), float("inf"), dtype=_F64, device=dev)
    kmin = inf.scatter_reduce(0, psid, masked, "amin")
    cand = okg & (masked == kmin[psid])
    big = torch.iinfo(torch.int64).max
    w = torch.full((S,), big, dtype=_I64, device=dev).scatter_reduce(
        0, psid, torch.where(cand, pos, big), "amin")
    wg = torch.where(root_ok, ok_off + w, 0)
    out = torch.stack([w.to(_F64), queries.to(_F64), hops.to(_F64),
                       overhead, sa[wg], f[wg], cm[wg]], 1)
    return torch.where(root_ok[:, None], out, _none_row(dev))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def _check_columns(ok, key, sa, f, cm, dev) -> int:
    """The per-scan columns: ``ok`` bool, the rest float64, all 1-D,
    contiguous, of one length, on ``dev``.  Returns that length."""
    build.check_tensor("ok", ok, torch.bool, 1, dev)
    n = ok.shape[0]
    for name, t in (("key", key), ("sa", sa), ("f", f), ("cm", cm)):
        build.check_tensor(name, t, _F64, 1, dev)
        if t.shape[0] != n:
            raise ValueError(f"{name} and ok must have one length")
    return n


def _launch(ok, key, sa, f, cm, plan: ScanPlanArrays, meta, S: int,
            n_small: int, n_large: int, P0: int, lqc: float,
            out: torch.Tensor) -> None:
    lib = build.load()
    with torch.cuda.device(ok.device):
        err = lib.heye_scan_reduce_batch(
            ok.data_ptr(), key.data_ptr(), sa.data_ptr(), f.data_ptr(),
            cm.data_ptr(), *(t.data_ptr() for t in plan.tensors()),
            None if meta is None else meta.data_ptr(), S, n_small, n_large,
            P0, plan.n, lqc, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, "scan_reduce_batch")


def _launch_grid(ok, key, sa, f, cm, plan: ScanPlanArrays, ok_off: int,
                 P: int, node_off: int, Nn: int, lqc: float,
                 out: torch.Tensor, row: int) -> None:
    """The grid form of one scan (more than ``BLOCK_MAX_P`` PUs) into row
    ``row`` of ``out``: four launches through a scratch of its own."""
    lib = build.load()
    scratch = torch.empty(lib.heye_scan_reduce_big_bytes(P, Nn),
                          dtype=torch.uint8, device=ok.device)
    with torch.cuda.device(ok.device):
        err = lib.heye_scan_reduce_big(
            ok.data_ptr(), key.data_ptr(), sa.data_ptr(), f.data_ptr(),
            cm.data_ptr(), *(t.data_ptr() for t in plan.tensors()),
            ok_off, P, node_off, Nn, lqc, out.data_ptr() + 56 * row,
            scratch.data_ptr(), scratch.shape[0],
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(err, "scan_reduce (grid form)")


def scan_reduce(ok: torch.Tensor, key: torch.Tensor, sa: torch.Tensor,
                f: torch.Tensor, cm: torch.Tensor, plan: ScanPlanArrays,
                lqc: float) -> torch.Tensor:
    """One scan over all of ``plan``'s nodes: its seven values (float64,
    on the inputs' device; integers are exact below 2**53)."""
    dev = plan.device
    P = _check_columns(ok, key, sa, f, cm, dev)
    if P < plan.span:
        raise ValueError("the plan's node ranges reach past the scan")
    lqc = float(lqc)
    if dev.type == "cpu":
        meta = torch.tensor([[0, P, 0, plan.n]], dtype=_I64)
        return scan_reduce_batch_plain(ok, key, sa, f, cm, *plan.tensors(),
                                       meta, lqc)[0]
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty(7, dtype=_F64, device=dev)
    if P > BLOCK_MAX_P:
        _launch_grid(ok, key, sa, f, cm, plan, 0, P, 0, plan.n, lqc, out, 0)
    else:
        small = int(P <= WARP_MAX_P)
        _launch(ok, key, sa, f, cm, plan, None, 1, small, 1 - small, P, lqc,
                out)
    build.count_launch(launches, "scan_reduce")
    return out


def scan_reduce_batch(ok: torch.Tensor, key: torch.Tensor, sa: torch.Tensor,
                      f: torch.Tensor, cm: torch.Tensor, plan: ScanPlanArrays,
                      scans: Sequence[tuple], lqc: float) -> torch.Tensor:
    """A ragged stack of scans in one launch: ``scans`` holds one
    ``(ok_off, P, node_off, Nn)`` per scan — its PUs at
    ``ok[ok_off : ok_off + P]`` (likewise ``key``/``sa``/``f``/``cm``), its
    nodes at ``[node_off, node_off + Nn)`` of ``plan``, whose ranges must
    lie in ``[0, P]`` (checked on the host, from ``plan.hi``); ``lqc`` is
    shared.  Returns ``(S, 7)`` float64 rows."""
    dev = plan.device
    n_ok = _check_columns(ok, key, sa, f, cm, dev)
    m = np.asarray(scans, dtype=np.int64).reshape(-1, 4)
    S = m.shape[0]
    o, p, no, nn = m.T
    bad = (o < 0) | (p < 0) | (o + p > n_ok) | (no < 0) | (nn < 1) \
        | (no + nn > plan.n)
    if S and not bad.any():
        # each scan's largest node end, over its own nodes
        first = np.cumsum(nn) - nn
        nodes = np.repeat(no - first, nn) + np.arange(int(nn.sum()))
        bad = np.maximum.reduceat(plan.hi[nodes], first) > p
    if bad.any():
        raise ValueError(f"scan {np.flatnonzero(bad)[0]} lies outside its "
                         f"columns or plan, or its nodes reach past its PUs")
    lqc = float(lqc)
    if dev.type == "cpu":
        return scan_reduce_batch_plain(ok, key, sa, f, cm, *plan.tensors(),
                                       torch.from_numpy(m), lqc)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty((S, 7), dtype=_F64, device=dev)
    if S == 0:
        return out
    # the rows, then the scans in launch order: warp-sized ones first, then
    # the block-sized ones; the rest take the grid form one by one
    small = p <= WARP_MAX_P
    grid = p > BLOCK_MAX_P
    large = ~small & ~grid
    meta = torch.from_numpy(np.concatenate(
        [m.ravel(), np.flatnonzero(small), np.flatnonzero(large)])).to(dev)
    _launch(ok, key, sa, f, cm, plan, meta, S, int(small.sum()),
            int(large.sum()), 0, lqc, out)
    for i in np.flatnonzero(grid):
        _launch_grid(ok, key, sa, f, cm, plan, int(o[i]), int(p[i]),
                     int(no[i]), int(nn[i]), lqc, out, int(i))
    build.count_launch(launches, "scan_reduce_batch")
    return out
