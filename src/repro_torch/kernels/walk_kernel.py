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

A third entry point, :func:`rewalk_entry`, is the whole entry scan of a
phase-2 re-walk whose plan covers one device, in one launch
(``csrc/rewalk.cu``): B1's same-device check of the device's segment and
the constraint terms around it, the splice into the task core's scan
state, the signature's effective columns and this reduce, read back with
one copy.  Its plain version, :func:`rewalk_entry_plain`, is the
two-step path it replaces, op for op: :func:`constraint_terms`,
:func:`segment_columns` and :func:`effective_segment` are the pieces the
orchestrator's two-step path runs too.

Two more entry points write the ordered commit's state in place, one
launch each (``csrc/ledger_append.cu``): :func:`ledger_append`, the
ledger row a commit adds, and :func:`view_append`, the slot a device's
ledger view gains by that row, in column buffers that grow by doubling.

The wrappers take the plain versions for CPU tensors and launch the
kernel for CUDA tensors (or raise).
"""
from __future__ import annotations

import struct
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..device import host_list
from .. import spans
from ..spans import OPEN as _SPANS
from . import build
from .slowdown_kernel import (SameDeviceItem, _check_tables,
                              device_summary, slowdown_same_device)

# launches per entry point: a single scan, a stack of scans, a re-walk's
# fused entry scan, a ledger row, a ledger view's slot
launches = {"scan_reduce": 0, "scan_reduce_batch": 0, "rewalk_entry": 0,
            "ledger_append": 0, "view_append": 0}

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
    sp = spans.enter("launch.scan_reduce") if _SPANS else None
    try:
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
            _launch_grid(ok, key, sa, f, cm, plan, 0, P, 0, plan.n, lqc,
                         out, 0)
        else:
            small = int(P <= WARP_MAX_P)
            _launch(ok, key, sa, f, cm, plan, None, 1, small, 1 - small,
                    P, lqc, out)
        build.count_launch(launches, "scan_reduce")
        return out
    finally:
        if sp:
            spans.leave(sp)


def scan_reduce_batch(ok: torch.Tensor, key: torch.Tensor, sa: torch.Tensor,
                      f: torch.Tensor, cm: torch.Tensor, plan: ScanPlanArrays,
                      scans: Sequence[tuple], lqc: float) -> torch.Tensor:
    """A ragged stack of scans in one launch: ``scans`` holds one
    ``(ok_off, P, node_off, Nn)`` per scan — its PUs at
    ``ok[ok_off : ok_off + P]`` (likewise ``key``/``sa``/``f``/``cm``), its
    nodes at ``[node_off, node_off + Nn)`` of ``plan``, whose ranges must
    lie in ``[0, P]`` (checked on the host, from ``plan.hi``); ``lqc`` is
    shared.  Returns ``(S, 7)`` float64 rows."""
    sp = spans.enter("launch.scan_reduce_batch") if _SPANS else None
    try:
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
                             f"columns or plan, or its nodes reach past its "
                             f"PUs")
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
    finally:
        if sp:
            spans.leave(sp)


# ---------------------------------------------------------------------------
# a phase-2 re-walk's entry scan, fused
# ---------------------------------------------------------------------------
def constraint_terms(cand_idx: torch.Tensor, maxten: torch.Tensor, now: float,
                     P: torch.Tensor, est: torch.Tensor, fac: torch.Tensor,
                     dl: torch.Tensor, rel: torch.Tensor, ci: torch.Tensor,
                     ai: torch.Tensor, act_pf: torch.Tensor,
                     flips: bool) -> tuple:
    """Alg. 1's constraint terms of one block-diagonal check at ``now``:
    candidates at compiled PU indices ``cand_idx`` with tenancy caps
    ``maxten``, ledger-view rows ``P`` / ``est`` / ``fac`` / ``dl`` /
    ``rel``, and the check's (candidate ``ci``, active ``ai``) pairs with
    each active's factor ``act_pf`` if the newcomer joins.

    Returns ``(ok, wait, flags)``: per candidate whether l.15 holds for
    every pair (existing tasks keep their deadlines), and the queueing wait
    behind the earliest finisher on its PU where the tenancy cap is
    reached (None where there is no candidate or no row: nothing waits);
    with ``flips``, ``flags`` = [whether a positive wait exists, the
    earliest future instant a pair's verdict can flip (+inf without a
    pair)], from which the caller dates the check's expiry (else None)."""
    dev = cand_idx.device
    C = cand_idx.shape[0]
    ok = torch.ones(C, dtype=torch.bool, device=dev)
    if not (P.shape[0] and C):
        return ok, None, None
    inf = float("inf")
    # tenancy cap: queueing wait behind the earliest finisher, counted per
    # *candidate position* (the candidate sets are device- or
    # subtree-local)
    sci, order = torch.sort(cand_idx, stable=True)
    pp = torch.clamp_max(torch.searchsorted(sci, P), C - 1)
    on_cand = sci[pp] == P
    # actives off every candidate PU scatter a neutral element (count 0,
    # finish +inf) instead of being masked out
    cpos = order[pp]
    cnt = torch.zeros(C, dtype=_I64, device=dev).scatter_add_(
        0, cpos, on_cand.to(_I64))
    waits = cnt >= maxten
    minest = torch.full((C,), inf, dtype=_F64, device=dev)
    minest.scatter_reduce_(0, cpos, torch.where(on_cand, est,
                                                torch.full_like(est, inf)),
                           reduce="amin", include_self=True)
    wait = torch.where(waits, torch.clamp_min(minest - now, 0.0),
                       torch.zeros_like(minest))
    flip = None
    # Alg. 1 l.15 over the same-device (candidate, active) pairs
    if ci.shape[0]:
        est_a = est[ai]
        fac_a = torch.clamp_min(fac[ai], 1e-12)
        rem = torch.clamp_min(est_a - now, 0.0) / fac_a
        fin = now + rem * act_pf
        dlp = dl[ai] * (1 + 1e-9)
        fine = torch.isfinite(dlp)
        viol = fine & (fin - rel[ai] > dlp)
        bad = torch.zeros(C, dtype=_I64, device=dev).scatter_add_(
            0, ci, viol.to(_I64))
        ok = ok & (bad == 0)
        if flips:
            # earliest future instant any pair's verdict can flip.  fin(t)
            # is piecewise linear and continuous in t (slope 1-r before
            # est, slope 1 after, r = pf/fac), so each pair's violation
            # state changes only at a root of fin(t) - rel - dl': t1 inside
            # [now, est) or t2 = rel + dl' inside [max(now, est), inf)
            r = act_pf / fac_a
            rel_a = rel[ai]
            t1 = (rel_a + dlp - est_a * r) / (1.0 - r)
            inf_k = torch.full_like(t1, inf)
            flips_k = torch.where(
                fine & (r != 1.0) & (t1 >= now) & (t1 < est_a), t1, inf_k)
            t2 = rel_a + dlp
            flips_k = torch.minimum(flips_k, torch.where(
                fine & (t2 >= now) & (t2 >= est_a), t2, inf_k))
            flip = flips_k.min()
    if not flips:
        return ok, wait, None
    if flip is None:
        flip = torch.full((), inf, dtype=_F64, device=dev)
    return ok, wait, torch.stack([(waits & (minest > now)).any().to(_F64),
                                  flip])


def segment_columns(n: int, cols: torch.Tensor, terms: Optional[tuple],
                    device) -> tuple:
    """The dense check columns ``(ok, sa, f, wait)`` of a segment of ``n``
    PUs: the candidates' ``terms`` = (ok, sa, f, wait) at their eligible
    positions ``cols`` (``wait`` None: no wait; ``terms`` None: no
    candidate), and (False, +inf, 1, 0) at every other position."""
    ok = torch.zeros(n, dtype=torch.bool, device=device)
    sa = torch.full((n,), float("inf"), dtype=_F64, device=device)
    f = torch.ones(n, dtype=_F64, device=device)
    wait = torch.zeros(n, dtype=_F64, device=device)
    if terms is not None:
        o, s_, f_, w_ = terms
        ok[cols] = o
        sa[cols] = s_
        f[cols] = f_
        if w_ is not None:
            wait[cols] = w_
    return ok, sa, f, wait


def effective_segment(ok: torch.Tensor, cm: torch.Tensor, key: torch.Tensor,
                      st_ok: torch.Tensor, st_sa: torch.Tensor,
                      st_f: torch.Tensor, st_wait: torch.Tensor, lo: int,
                      hi: int, cols: torch.Tensor, comm: torch.Tensor,
                      deadline: Optional[float]) -> None:
    """Rewrite the effective columns ``ok`` / ``cm`` / ``key`` of a scan
    over its PUs ``[lo, hi)`` from the scan state's columns: ``cm`` the
    signature's ``comm`` plus the tenancy wait at its eligible positions
    ``cols`` (which lie in the range) and 0 elsewhere, the selection key
    ``cm + sa*f``, and ``ok`` masked by the deadline."""
    cm[lo:hi] = 0.0
    cm[cols] = comm + st_wait[cols]
    key[lo:hi] = cm[lo:hi] + st_sa[lo:hi] * st_f[lo:hi]
    o = st_ok[lo:hi]
    if deadline is not None:
        o = o & ~(key[lo:hi] > deadline)
    ok[lo:hi] = o


class RewalkSegment(NamedTuple):
    """A phase-2 re-walk's entry scan over a plan whose PUs all sit on one
    device, what :func:`rewalk_entry` reads and writes.

    The newcomer: ``u_new`` / ``mem_new`` its usages, ``uid_new``, its
    ``deadline`` (None: none) and the check instant ``now``.  Its eligible
    candidates on the device in the check's order: compiled PU index
    ``Pc``, device ordinal ``Dc``, position in the segment ``cols``,
    standalone ``sa`` and tenancy cap ``maxten``; the signature's
    ``comm`` per eligible candidate at plan position ``eff_cols``.  The
    device's ledger view (``Pa`` ... ``rel``, ``Da``, with ``astart`` /
    ``na`` its per-device-ordinal segments).  The scan state's columns
    ``st_*``, whose segment ``[lo, lo + nseg)`` is rewritten, and the
    signature's effective columns ``ok`` / ``cm`` / ``key`` over the whole
    plan, rewritten over the segment.  The ``plan`` and its local query
    cost ``lqc``."""
    u_new: float
    mem_new: float
    uid_new: int
    deadline: Optional[float]
    now: float
    Pc: torch.Tensor
    Dc: torch.Tensor
    cols: torch.Tensor
    sa: torch.Tensor
    maxten: torch.Tensor
    eff_cols: torch.Tensor
    comm: torch.Tensor
    Pa: torch.Tensor
    Ua: torch.Tensor
    Ma: torch.Tensor
    uid_a: torch.Tensor
    est: torch.Tensor
    fac: torch.Tensor
    dl: torch.Tensor
    rel: torch.Tensor
    Da: torch.Tensor
    astart: torch.Tensor
    na: torch.Tensor
    st_ok: torch.Tensor
    st_sa: torch.Tensor
    st_f: torch.Tensor
    st_wait: torch.Tensor
    lo: int
    nseg: int
    ok: torch.Tensor
    cm: torch.Tensor
    key: torch.Tensor
    plan: ScanPlanArrays
    lqc: float


def rewalk_entry_plain(seg: RewalkSegment, mt_vec: torch.Tensor,
                       beta: torch.Tensor, mem_cap: torch.Tensor,
                       ncr_rclass: torch.Tensor,
                       kappa: float) -> torch.Tensor:
    """Plain version of :func:`rewalk_entry`: the two-step path of the
    orchestrator for this shape, op for op — B1's same-device check of the
    segment through its wrapper (the orchestrator's
    ``factors_same_device``), :func:`constraint_terms`, the splice of
    :func:`segment_columns` into the scan state, :func:`effective_segment`
    and B4's reduce through :func:`scan_reduce`.  Returns the nine values
    as a float64 tensor."""
    dev = seg.st_ok.device
    lo, hi = seg.lo, seg.lo + seg.nseg
    terms = flags = None
    if seg.Pc.shape[0]:
        summ = (0, True, 0, 0)              # no candidate or no active
        if seg.Pa.shape[0]:
            summ = device_summary(seg.Dc, seg.astart, seg.na)
        new_f, ci, ai, act_pf = slowdown_same_device(
            [SameDeviceItem(seg.Pc, seg.Dc, seg.u_new, seg.mem_new,
                            seg.uid_new, seg.Pa, seg.Ua, seg.Ma, seg.uid_a,
                            seg.Da, seg.astart, seg.na, summ)],
            mt_vec, beta, mem_cap, ncr_rclass, kappa)[0]
        o, w, flags = constraint_terms(seg.Pc, seg.maxten, seg.now, seg.Pa,
                                       seg.est, seg.fac, seg.dl, seg.rel, ci,
                                       ai, act_pf, flips=True)
        terms = (o, seg.sa, new_f, w)
    if flags is None:
        flags = torch.tensor([0.0, float("inf")], dtype=_F64, device=dev)
    (seg.st_ok[lo:hi], seg.st_sa[lo:hi], seg.st_f[lo:hi],
     seg.st_wait[lo:hi]) = segment_columns(seg.nseg, seg.cols, terms, dev)
    effective_segment(seg.ok, seg.cm, seg.key, seg.st_ok, seg.st_sa, seg.st_f,
                      seg.st_wait, lo, hi, seg.eff_cols, seg.comm,
                      seg.deadline)
    row = scan_reduce(seg.ok, seg.key, seg.st_sa, seg.st_f, seg.cm, seg.plan,
                      seg.lqc)
    return torch.cat([row, flags])


# the kernel's argument row (csrc/rewalk.cu, RwArgs), field by field:
# "q" a pointer or an integer, "d" a double
RW_FIELDS = (
    ("Pc", "q"), ("Dc", "q"), ("cols", "q"), ("sa", "q"), ("maxten", "q"),
    ("C", "q"), ("eff_cols", "q"), ("comm", "q"), ("C2", "q"),
    ("Pa", "q"), ("Ua", "q"), ("Ma", "q"), ("uid_a", "q"), ("est", "q"),
    ("fac", "q"), ("dl", "q"), ("rel", "q"), ("astart", "q"), ("na", "q"),
    ("A", "q"), ("nd", "q"),
    ("ncr", "q"), ("nP", "q"), ("mt_vec", "q"), ("mem_cap", "q"),
    ("beta", "q"), ("R", "q"), ("kappa", "d"),
    ("u_new", "d"), ("mem_new", "d"), ("uid_new", "q"), ("has_dl", "q"),
    ("deadline", "d"), ("now", "d"),
    ("st_ok", "q"), ("st_sa", "q"), ("st_f", "q"), ("st_wait", "q"),
    ("lo", "q"), ("nseg", "q"),
    ("ok", "q"), ("cm", "q"), ("key", "q"), ("P", "q"),
    ("pu_lo", "q"), ("pu_hi", "q"), ("leafcnt", "q"), ("nchild", "q"),
    ("hopsum", "q"), ("depth", "q"), ("Nn", "q"), ("lqc", "d"),
    ("out", "q"), ("nf", "q"), ("waitc", "q"), ("bad", "q"), ("base", "q"),
    ("wide", "q"))
_RW_ROW = struct.Struct("<" + "".join(k for _, k in RW_FIELDS))
_B = torch.bool


def _check_segment(seg: RewalkSegment, dev) -> tuple:
    """Raise on anything :func:`rewalk_entry` does not take; returns the
    plan's PU count."""
    build.check_tensors(
        dev, ("Pc", seg.Pc, _I64, 1), ("Dc", seg.Dc, _I64, 1),
        ("cols", seg.cols, _I64, 1), ("sa", seg.sa, _F64, 1),
        ("maxten", seg.maxten, _I64, 1), ("eff_cols", seg.eff_cols, _I64, 1),
        ("comm", seg.comm, _F64, 1), ("Pa", seg.Pa, _I64, 1),
        ("Ua", seg.Ua, _F64, 1), ("Ma", seg.Ma, _F64, 1),
        ("uid_a", seg.uid_a, _I64, 1), ("est", seg.est, _F64, 1),
        ("fac", seg.fac, _F64, 1), ("dl", seg.dl, _F64, 1),
        ("rel", seg.rel, _F64, 1), ("Da", seg.Da, _I64, 1),
        ("astart", seg.astart, _I64, 1), ("na", seg.na, _I64, 1),
        ("st_ok", seg.st_ok, _B, 1), ("st_sa", seg.st_sa, _F64, 1),
        ("st_f", seg.st_f, _F64, 1), ("st_wait", seg.st_wait, _F64, 1),
        ("ok", seg.ok, _B, 1), ("cm", seg.cm, _F64, 1),
        ("key", seg.key, _F64, 1))
    C, A, P = seg.Pc.shape[0], seg.Pa.shape[0], seg.ok.shape[0]
    if any(t.shape[0] != C for t in (seg.Dc, seg.cols, seg.sa, seg.maxten)):
        raise ValueError("the candidates' columns disagree in length")
    if seg.comm.shape[0] != seg.eff_cols.shape[0]:
        raise ValueError("comm and eff_cols must have one length")
    if any(t.shape[0] != A for t in (seg.Ua, seg.Ma, seg.uid_a, seg.est,
                                     seg.fac, seg.dl, seg.rel, seg.Da)):
        raise ValueError("the ledger view's columns disagree in length")
    if seg.astart.shape[0] != seg.na.shape[0] or (C and not seg.na.shape[0]):
        raise ValueError("astart and na must have one length, one per "
                         "device ordinal")
    if any(t.shape[0] != P for t in (seg.cm, seg.key, seg.st_ok, seg.st_sa,
                                     seg.st_f, seg.st_wait)):
        raise ValueError("the scan's columns must have one length")
    if seg.plan.device != dev or P < seg.plan.span:
        raise ValueError("the plan is on another device or its node "
                         "ranges reach past the scan")
    if not (0 <= seg.lo and 0 <= seg.nseg and seg.lo + seg.nseg <= P):
        raise ValueError("the segment lies outside the scan")
    return P


def rewalk_entry(seg: RewalkSegment, mt_vec: torch.Tensor,
                 beta: torch.Tensor, mem_cap: torch.Tensor,
                 ncr_rclass: torch.Tensor, kappa: float) -> list:
    """A phase-2 re-walk's entry scan over a plan on one device in ONE
    launch, and its nine values read back with ONE copy: the scan's
    seven (as :func:`scan_reduce` gives them), whether the re-checked
    segment holds a positive tenancy wait, and the earliest instant one
    of its l.15 verdicts can flip.  Rewrites the scan state's segment and
    the effective columns over it in place, as the two-step path does.
    The snapshot tables are B1's (:func:`slowdown_same_device`).  The
    plan takes at most ``BLOCK_MAX_P`` PUs (one block)."""
    sp = spans.enter("launch.rewalk_entry") if _SPANS else None
    try:
        dev = seg.ok.device
        nP, R = _check_tables(mem_cap, ncr_rclass, mt_vec, beta, dev)
        P = _check_segment(seg, dev)
        if P > BLOCK_MAX_P:
            raise ValueError(f"a plan of {P} PUs takes more than one block "
                             f"(at most {BLOCK_MAX_P})")
        kappa = float(kappa)
        if dev.type == "cpu":
            out = rewalk_entry_plain(seg, mt_vec, beta, mem_cap, ncr_rclass,
                                     kappa)
        elif dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        else:
            C, A = seg.Pc.shape[0], seg.Pa.shape[0]
            lib = build.load()
            wide = lib.heye_rewalk_entry_wide_len(R)
            # the row, then the scratch: factors and waits per candidate,
            # a 4-byte flag per candidate, R + 1 base pressures per active
            nb = (C + 1) // 2
            buf = torch.empty(9 + 2 * C + nb + A * (R + 1) + wide,
                              dtype=_F64, device=dev)
            b0 = buf.data_ptr()
            o_nf = b0 + 8 * 9
            o_wait = o_nf + 8 * C
            o_bad = o_wait + 8 * C
            o_base = o_bad + 8 * nb
            o_wide = o_base + 8 * A * (R + 1)
            pl = seg.plan
            row = _RW_ROW.pack(
                seg.Pc.data_ptr(), seg.Dc.data_ptr(), seg.cols.data_ptr(),
                seg.sa.data_ptr(), seg.maxten.data_ptr(), C,
                seg.eff_cols.data_ptr(), seg.comm.data_ptr(),
                seg.eff_cols.shape[0],
                seg.Pa.data_ptr(), seg.Ua.data_ptr(), seg.Ma.data_ptr(),
                seg.uid_a.data_ptr(), seg.est.data_ptr(), seg.fac.data_ptr(),
                seg.dl.data_ptr(), seg.rel.data_ptr(),
                seg.astart.data_ptr(), seg.na.data_ptr(), A,
                seg.na.shape[0],
                ncr_rclass.data_ptr(), nP, mt_vec.data_ptr(),
                mem_cap.data_ptr(), beta.data_ptr(), R, kappa,
                float(seg.u_new), float(seg.mem_new), int(seg.uid_new),
                int(seg.deadline is not None),
                0.0 if seg.deadline is None else float(seg.deadline),
                float(seg.now),
                seg.st_ok.data_ptr(), seg.st_sa.data_ptr(),
                seg.st_f.data_ptr(), seg.st_wait.data_ptr(), seg.lo,
                seg.nseg,
                seg.ok.data_ptr(), seg.cm.data_ptr(), seg.key.data_ptr(), P,
                *(t.data_ptr() for t in pl.tensors()), pl.n, float(seg.lqc),
                b0, o_nf, o_wait, o_bad, o_base, o_wide if wide else 0)
            with torch.cuda.device(dev):
                err = lib.heye_rewalk_entry(
                    row, len(row), build.raw_stream(dev.index))
            build.check_launch(err, "rewalk_entry")
            build.count_launch(launches, "rewalk_entry")
            out = buf[:9]
    finally:
        if sp:
            spans.leave(sp)
    return host_list(out)


# ---------------------------------------------------------------------------
# the ordered commit's in-place appends (csrc/ledger_append.cu)
# ---------------------------------------------------------------------------
# a ledger row's columns, in the order ledger_append writes them; live last
LEDGER_COLS = (("est", _F64), ("fac", _F64), ("dl", _F64), ("upu", _F64),
               ("umem", _F64), ("uid", _I64), ("pu_idx", _I64),
               ("live", _B))
# a device view's columns, in the order view_append writes them
VIEW_COLS = (("P", _I64), ("est", _F64), ("fac", _F64), ("dl", _F64),
             ("upu", _F64), ("umem", _F64), ("Ma", _F64), ("uid", _I64),
             ("rel", _F64), ("Da", _I64))
# column positions by name (the kernels' structs hold the same order)
_LI = {n: k for k, (n, _) in enumerate(LEDGER_COLS)}
_VI = {n: k for k, (n, _) in enumerate(VIEW_COLS)}
# the view columns a new slot copies from the ledger row (all but Ma, rel
# and Da), and the ledger columns they come from
VIEW_ROW = tuple(_VI[n] for n in ("P", "est", "fac", "dl", "upu", "umem",
                                  "uid"))
LEDGER_OF_VIEW_ROW = tuple(_LI["pu_idx" if VIEW_COLS[k][0] == "P"
                               else VIEW_COLS[k][0]] for k in VIEW_ROW)

# the kernels' argument rows (LaArgs, VaArgs), field by field
LA_FIELDS = tuple((n, "q") for n, _ in LEDGER_COLS) + (
    ("i", "q"), ("v_est", "d"), ("v_fac", "d"), ("v_dl", "d"),
    ("v_upu", "d"), ("v_umem", "d"), ("v_uid", "q"), ("v_pidx", "q"))
VA_FIELDS = (tuple((n, "q") for n, _ in VIEW_COLS)
             + tuple(("s" + n, "q") for n, _ in VIEW_COLS)
             + (("ncopy", "q"),)
             + tuple(("l" + VIEW_COLS[k][0], "q") for k in VIEW_ROW)
             + (("i", "q"), ("mem_cap", "q"), ("pidx", "q"), ("n", "q"),
                ("v_rel", "d"), ("v_da", "q"), ("na_src", "q"),
                ("na_dst", "q"), ("nd", "q"), ("o", "q")))
_LA_ROW = struct.Struct("<" + "".join(k for _, k in LA_FIELDS))
_VA_ROW = struct.Struct("<" + "".join(k for _, k in VA_FIELDS))


class Columns:
    """Columns of one length that the append kernels write, checked once
    here and not at every launch: ``spec`` is :data:`LEDGER_COLS` or
    :data:`VIEW_COLS`, each column a 1-D contiguous tensor of its type on
    one device.  The owner builds a new set whenever it replaces a
    column."""

    __slots__ = ("spec", "cols", "n", "device", "ptrs", "row_ptrs")

    def __init__(self, spec: tuple, cols: Sequence[torch.Tensor]) -> None:
        if len(cols) != len(spec):
            raise ValueError(f"{len(spec)} columns expected, got {len(cols)}")
        dev = cols[0].device
        build.check_tensors(dev, *((n, c, t, 1)
                                   for (n, t), c in zip(spec, cols)))
        n = cols[0].shape[0]
        if any(c.shape[0] != n for c in cols):
            raise ValueError("the columns disagree in length")
        self.spec, self.cols, self.n, self.device = spec, tuple(cols), n, dev
        self.ptrs = self.row_ptrs = None
        if dev.type == "cuda":
            self.ptrs = tuple(c.data_ptr() for c in cols)
            if spec is LEDGER_COLS:
                # in the order of a view slot's row
                self.row_ptrs = tuple(self.ptrs[k]
                                      for k in LEDGER_OF_VIEW_ROW)


def _check_index(name: str, i: int, n: int) -> None:
    if not 0 <= i < n:
        raise IndexError(f"{name} {i} lies outside columns of {n} entries")


def ledger_append_plain(cols: Sequence[torch.Tensor], i: int,
                        row: Sequence) -> None:
    """Plain version of :func:`ledger_append`: one scalar write a column."""
    for c, x in zip(cols, row):
        c[i] = x
    cols[_LI["live"]][i] = True


def ledger_append(led: Columns, i: int, row: Sequence) -> None:
    """Row ``i`` of an active ledger's columns, written in place in ONE
    launch: ``led`` holds the eight columns of :data:`LEDGER_COLS`,
    ``row`` the first seven's values (floats, then the uid and the
    compiled PU index); the row's ``live`` entry becomes True."""
    sp = spans.enter("launch.ledger_append") if _SPANS else None
    try:
        if led.spec is not LEDGER_COLS or len(row) != 7:
            raise ValueError("a ledger row is seven values into the eight "
                             "columns of LEDGER_COLS")
        _check_index("row", i, led.n)
        dev = led.device
        if dev.type == "cpu":
            ledger_append_plain(led.cols, i, row)
        elif dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        else:
            lib = build.load()
            args = _LA_ROW.pack(
                *led.ptrs, i, float(row[0]), float(row[1]), float(row[2]),
                float(row[3]), float(row[4]), int(row[5]), int(row[6]))
            err = lib.heye_ledger_append(args, len(args),
                                         build.raw_stream(dev.index))
            build.check_launch(err, "ledger_append")
            build.count_launch(launches, "ledger_append")
    finally:
        if sp:
            spans.leave(sp)


def view_append_plain(dst: Sequence[torch.Tensor],
                      src: Optional[Sequence[torch.Tensor]], ncopy: int,
                      led: Sequence[torch.Tensor], i: int,
                      mem_cap: torch.Tensor, pidx: int, n: int, rel: float,
                      da: int, na_src: torch.Tensor, na_dst: torch.Tensor,
                      o: int) -> None:
    """Plain version of :func:`view_append` (``led``: the ledger's eight
    columns)."""
    if ncopy:
        for d, s in zip(dst, src):
            d[:ncopy] = s[:ncopy]
    for k, c in zip(VIEW_ROW, LEDGER_OF_VIEW_ROW):
        dst[k][n] = led[c][i]
    dst[_VI["Ma"]][n] = torch.minimum(led[_LI["umem"]][i], mem_cap[pidx])
    dst[_VI["rel"]][n] = rel
    dst[_VI["Da"]][n] = da
    na_dst.copy_(na_src)
    if o >= 0:
        na_dst[o] = n + 1


def view_append(dst: Columns, src: Optional[Sequence[torch.Tensor]],
                ncopy: int, led: Columns, i: int, mem_cap: torch.Tensor,
                pidx: int, n: int, rel: float, da: int,
                na_src: torch.Tensor, na_dst: torch.Tensor, o: int) -> None:
    """Slot ``n`` of a device view's column buffers (``dst``, the ten of
    :data:`VIEW_COLS`), written in place in ONE launch: ledger row ``i``'s
    columns (``led``, :data:`LEDGER_COLS`), ``Ma`` = ``min(umem[i],
    mem_cap[pidx])``, the release time ``rel`` and the device ordinal
    ``da``.  The same launch first copies rows ``[0, ncopy)`` of the
    previous view's ten columns ``src`` into the buffers (the caller's
    ``ncopy`` is 0, or ``n`` where the view moves to new buffers).
    ``na_dst`` becomes ``na_src`` with ``[o] = n + 1`` (``o < 0``:
    unchanged)."""
    sp = spans.enter("launch.view_append") if _SPANS else None
    try:
        dev = dst.device
        if dst.spec is not VIEW_COLS or led.spec is not LEDGER_COLS \
                or led.device != dev:
            raise ValueError("a view's buffers (VIEW_COLS) and a ledger's "
                             "columns (LEDGER_COLS), on one device")
        _check_index("slot", n, dst.n)
        _check_index("row", i, led.n)
        if not 0 <= ncopy <= n:
            raise ValueError("the copy reaches past the written slot")
        if ncopy:
            Columns(VIEW_COLS, [c[:ncopy] for c in src])
        build.check_tensors(dev, ("mem_cap", mem_cap, _F64, 1),
                            ("na_src", na_src, _I64, 1),
                            ("na_dst", na_dst, _I64, 1))
        _check_index("pidx", pidx, mem_cap.shape[0])
        nd = na_src.shape[0]
        if na_dst.shape[0] != nd or o >= nd:
            raise ValueError("the segment counts disagree in length, or the "
                             "ordinal lies outside them")
        if dev.type == "cpu":
            view_append_plain(dst.cols, src, ncopy, led.cols, i, mem_cap,
                              pidx, n, rel, da, na_src, na_dst, o)
        elif dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        else:
            lib = build.load()
            sptr = (c.data_ptr() for c in src) if ncopy else (0,) * 10
            args = _VA_ROW.pack(
                *dst.ptrs, *sptr, ncopy, *led.row_ptrs, i,
                mem_cap.data_ptr(), pidx, n, float(rel), da,
                na_src.data_ptr(), na_dst.data_ptr(), nd,
                o if o >= 0 else -1)
            err = lib.heye_view_append(args, len(args),
                                       build.raw_stream(dev.index))
            build.check_launch(err, "view_append")
            build.count_launch(launches, "view_append")
    finally:
        if sp:
            spans.leave(sp)
