"""The DES timeline engine's batched inner loops.

* **rate-advance** — settle each job's remaining virtual work to the
  shared timestamp and project its completion:
  ``W' = max(0, W - rate*(now - t_last))`` (a NaN residue, the
  ``inf * 0`` corner of infinite-bandwidth transfers, clamps to 0) and
  ``eta = now + W'/rate`` (+inf where the rate is not positive).  The
  transfer sites call it on gathered columns.
* **settle_reprice** / **settle_complete** — the two compute-job sites of
  the same settle, fused with everything around them and applied in place
  on the engine's job columns: a flush reprices its dirty pools (stamp,
  settle, ``rate = 1/factor``, ``eta``), a completion settles the
  finished slots, projects the float residues anew and hands the host
  ``(slot, finished)`` pairs in one tensor.  One launch where the unfused
  sequence took a dozen ops.
* **segment-min** — a transfer's bottleneck bandwidth is the min of its
  route edges' fair shares, evaluated for a whole dirty set as one
  segmented reduction over CSR ``(values, starts, counts)``; an empty
  segment yields +inf.
* **transfer_reprice** / **transfer_complete** — the transfer sites of
  the engine, each one launch in place on the transfer columns: a flush
  stamps its affected transfers, walks each one's CSR route row to its
  bottleneck share (the segment-min, with the per-edge member counts the
  flush changed landing in the device's edge column in the same launch),
  settles it with its old rate and projects it with the new one; a
  completion settles the finished transfers and hands the host
  ``(slot, finished)`` pairs.  The segment-min and rate-advance stay as
  kernels of their own, held against their plain versions; the engine
  runs the two fused forms.

Replaces the TPU kernels of ``repro/kernels/timeline_kernel.py``
(``rate_advance_pallas`` / ``_rate_advance_kernel`` and
``segment_min_pallas`` / ``_segment_min_kernel``), which compute in
float32, bake ``now`` into the compiled kernel, and densify the CSR
layout on the host, and the settle form of ``repro/core/timeline.py``
(``_settle_pos``) with its transfer sites.  Here all are CUDA C++ in
float64 (``csrc/rate_advance.cu``, ``csrc/segment_min.cu``,
``csrc/transfer.cu``); ``now`` is a run-time argument and the CSR arrays
are consumed where they lie on the device.  All are bound by bytes moved
(every element read once) and, at the sizes one flush produces, by
launch latency.  The fused forms are bit-equal to their plain versions,
which are the unfused op sequences.

The wrappers take the plain version for CPU tensors and launch the
kernel for CUDA tensors (or raise — there is no fallback).
"""
from __future__ import annotations

import torch

from .. import spans
from ..spans import OPEN as _SPANS
from . import build

# launches per kernel form: the rate-advance, the two fused settle forms,
# the segment-min and the two fused transfer forms
launches = {"rate_advance": 0, "settle_reprice": 0, "settle_complete": 0,
            "segment_min": 0, "transfer_reprice": 0, "transfer_complete": 0}

_F64 = torch.float64
_I64 = torch.int64


# ---------------------------------------------------------------------------
# plain PyTorch versions (float64)
# ---------------------------------------------------------------------------
def _settle(W: torch.Tensor, rate: torch.Tensor, t_last: torch.Tensor,
            now: float) -> torch.Tensor:
    raw = W - rate * (now - t_last)
    return torch.where(raw > 0.0, raw, torch.zeros_like(raw))   # NaN -> 0


def rate_advance_plain(W: torch.Tensor, rate: torch.Tensor,
                       t_last: torch.Tensor, now: float
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    W2 = _settle(W, rate, t_last, now)
    eta = torch.where(rate > 0.0, now + W2 / rate,
                      torch.full_like(W2, float("inf")))
    return W2, eta


def settle_reprice_plain(W: torch.Tensor, rate: torch.Tensor,
                         t_last: torch.Tensor, eta: torch.Tensor,
                         cstamp: torch.Tensor, members: torch.Tensor,
                         factors: torch.Tensor, now: float,
                         stamp0: int) -> None:
    """In place, for ``m = members[i]``: ``cstamp[m] = stamp0 + i``, settle
    ``W[m]`` to ``now``, ``t_last[m] = now``, ``rate[m] = 1/factors[i]``,
    ``eta[m] = now + W[m]/rate[m]``.  ``members`` holds distinct slots."""
    n = members.shape[0]
    cstamp[members] = torch.arange(stamp0, stamp0 + n, device=members.device)
    W2 = _settle(W[members], rate[members], t_last[members], now)
    r = 1.0 / factors
    W[members] = W2
    t_last[members] = now
    rate[members] = r
    eta[members] = now + W2 / r


def settle_complete_plain(W: torch.Tensor, rate: torch.Tensor,
                          t_last: torch.Tensor, eta: torch.Tensor,
                          done: torch.Tensor, now: float,
                          tol: float) -> torch.Tensor:
    """In place, for ``m = done[i]``: settle ``W[m]`` to ``now``,
    ``t_last[m] = now``; finished (``W[m] <= tol``) slots get
    ``eta = +inf``, the rest ``now + W[m]/rate[m]``.  Returns the ``(2, n)``
    int64 pairs ``[done, finished]``.  ``done`` holds distinct slots."""
    r = rate[done]
    W2 = _settle(W[done], r, t_last[done], now)
    fin = W2 <= tol
    W[done] = W2
    t_last[done] = now
    eta[done] = torch.where(fin, torch.full_like(W2, float("inf")),
                            now + W2 / r)
    return torch.stack([done, fin.to(_I64)])


def segment_min_plain(values: torch.Tensor, starts: torch.Tensor,
                      counts: torch.Tensor) -> torch.Tensor:
    S = counts.shape[0]
    out = torch.full((S,), float("inf"), dtype=_F64,
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


def transfer_reprice_plain(xW, xrate, xt_last, xeta, xstamp, xe_flat,
                           xe_start, xe_cnt, edge_bw, edge_mem, ks, upd_e,
                           upd_c, now: float, stamp0: int) -> None:
    """In place: ``edge_mem[upd_e] = upd_c``, then for ``k = ks[i]``
    stamp ``xstamp[k] = stamp0 + i``, take the bottleneck share ``bw`` of
    transfer ``k``'s route (its CSR row of ``xe_flat``; each edge's
    ``edge_bw / max(1, edge_mem)``, the min, +inf with no edge), settle
    ``xW[k]`` with the old rate, ``xt_last[k] = now``, ``xrate[k] = bw``,
    ``xeta[k] = now + (xW[k]/bw if bw > 0 else +inf)``.  ``ks`` holds
    distinct slots.  The op sequence of the engine's first transfer
    path, the CSR row gathered and densified."""
    dev = ks.device
    edge_mem[upd_e] = upd_c
    n = ks.shape[0]
    xstamp[ks] = torch.arange(stamp0, stamp0 + n, device=dev)
    starts = xe_start[ks]
    counts = xe_cnt[ks]
    K = int(counts.sum()) if n else 0
    seg_starts = torch.cumsum(counts, 0) - counts
    if K:
        within = torch.arange(K, device=dev) - torch.repeat_interleave(
            seg_starts, counts, output_size=K)
        flat = xe_flat[torch.repeat_interleave(starts, counts,
                                               output_size=K) + within]
    else:
        flat = torch.zeros(0, dtype=_I64, device=dev)
    shares = edge_bw[flat] / torch.clamp_min(edge_mem[flat], 1).to(_F64)
    bw = segment_min_plain(shares, seg_starts, counts)
    W2, _ = rate_advance_plain(xW[ks], xrate[ks], xt_last[ks], now)
    xW[ks] = W2
    xt_last[ks] = now
    xrate[ks] = bw
    xeta[ks] = now + torch.where(bw > 0.0, W2 / bw,
                                 torch.full_like(W2, float("inf")))


def transfer_complete_plain(xW, xrate, xt_last, xeta, done, now: float,
                            tol: float) -> torch.Tensor:
    """In place, for ``k = done[i]``: settle ``xW[k]``, ``xt_last[k] =
    now``; ``xeta[k]`` = +inf where finished (``xW[k] <= tol``), else the
    rate-advance projection (+inf where the rate is not positive).
    Returns the ``(2, n)`` int64 pairs ``[done, finished]``.  ``done``
    holds distinct slots."""
    W2, eta = rate_advance_plain(xW[done], xrate[done], xt_last[done], now)
    xW[done] = W2
    xt_last[done] = now
    fin = W2 <= tol
    xeta[done] = torch.where(fin, torch.full_like(eta, float("inf")), eta)
    return torch.stack([done, fin.to(_I64)])


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def rate_advance(W: torch.Tensor, rate: torch.Tensor, t_last: torch.Tensor,
                 now: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Settle to ``now`` and project completions: ``(W', eta)``."""
    sp = spans.enter("launch.rate_advance") if _SPANS else None
    try:
        dev = W.device
        for name, t in (("W", W), ("rate", rate), ("t_last", t_last)):
            build.check_tensor(name, t, _F64, 1, dev)
        n = W.shape[0]
        if rate.shape[0] != n or t_last.shape[0] != n:
            raise ValueError("W, rate and t_last must have one length")
        now = float(now)
        if dev.type == "cpu":
            return rate_advance_plain(W, rate, t_last, now)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        W2 = torch.empty(n, dtype=_F64, device=dev)
        eta = torch.empty(n, dtype=_F64, device=dev)
        if n == 0:
            return W2, eta
        lib = build.load()
        with torch.cuda.device(dev):
            err = lib.heye_rate_advance(
                W.data_ptr(), rate.data_ptr(), t_last.data_ptr(),
                W2.data_ptr(), eta.data_ptr(), n, now,
                torch.cuda.current_stream().cuda_stream)
        build.check_launch(err, "rate_advance")
        build.count_launch(launches, "rate_advance")
        return W2, eta
    finally:
        if sp:
            spans.leave(sp)


def _check_job_columns(cols: tuple, idx: torch.Tensor, idx_name: str,
                       dev) -> int:
    """The job columns (float64, 1-D, contiguous, one length) and the
    int64 slot index into them; returns the index's length."""
    n_cols = cols[0][1].shape[0]
    for name, t in cols:
        build.check_tensor(name, t, _F64, 1, dev)
        if t.shape[0] != n_cols:
            raise ValueError("the job columns must have one length")
    build.check_tensor(idx_name, idx, _I64, 1, dev)
    return idx.shape[0]


def settle_reprice(W: torch.Tensor, rate: torch.Tensor, t_last: torch.Tensor,
                   eta: torch.Tensor, cstamp: torch.Tensor,
                   members: torch.Tensor, factors: torch.Tensor, now: float,
                   stamp0: int) -> None:
    """A flush's reprice, in place on the job columns (see
    :func:`settle_reprice_plain`).  ``members`` must hold distinct slots:
    on the card each slot is written by its own thread."""
    sp = spans.enter("launch.settle_reprice") if _SPANS else None
    try:
        dev = W.device
        n = _check_job_columns((("W", W), ("rate", rate), ("t_last", t_last),
                                ("eta", eta)), members, "members", dev)
        build.check_tensor("cstamp", cstamp, _I64, 1, dev)
        build.check_tensor("factors", factors, _F64, 1, dev)
        if cstamp.shape[0] != W.shape[0] or factors.shape[0] != n:
            raise ValueError("cstamp must match the job columns and factors "
                             "the members")
        now = float(now)
        stamp0 = int(stamp0)
        if dev.type == "cpu":
            settle_reprice_plain(W, rate, t_last, eta, cstamp, members,
                                 factors, now, stamp0)
            return
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        if n == 0:
            return
        lib = build.load()
        with torch.cuda.device(dev):
            err = lib.heye_settle_reprice(
                W.data_ptr(), rate.data_ptr(), t_last.data_ptr(),
                eta.data_ptr(), cstamp.data_ptr(), members.data_ptr(),
                factors.data_ptr(), n, now, stamp0,
                torch.cuda.current_stream().cuda_stream)
        build.check_launch(err, "settle_reprice")
        build.count_launch(launches, "settle_reprice")
    finally:
        if sp:
            spans.leave(sp)


def settle_complete(W: torch.Tensor, rate: torch.Tensor, t_last: torch.Tensor,
                    eta: torch.Tensor, done: torch.Tensor, now: float,
                    tol: float) -> torch.Tensor:
    """A timestamp's compute completions, in place on the job columns (see
    :func:`settle_complete_plain`); returns the ``(2, n)`` int64 pairs
    ``[done, finished]`` for one host copy.  ``done`` must hold distinct
    slots."""
    sp = spans.enter("launch.settle_complete") if _SPANS else None
    try:
        dev = W.device
        n = _check_job_columns((("W", W), ("rate", rate), ("t_last", t_last),
                                ("eta", eta)), done, "done", dev)
        now = float(now)
        tol = float(tol)
        if dev.type == "cpu":
            return settle_complete_plain(W, rate, t_last, eta, done, now, tol)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        pairs = torch.empty((2, n), dtype=_I64, device=dev)
        if n == 0:
            return pairs
        lib = build.load()
        with torch.cuda.device(dev):
            err = lib.heye_settle_complete(
                W.data_ptr(), rate.data_ptr(), t_last.data_ptr(),
                eta.data_ptr(), done.data_ptr(), pairs.data_ptr(), n, now, tol,
                torch.cuda.current_stream().cuda_stream)
        build.check_launch(err, "settle_complete")
        build.count_launch(launches, "settle_complete")
        return pairs
    finally:
        if sp:
            spans.leave(sp)


def segment_min(values: torch.Tensor, starts: torch.Tensor,
                counts: torch.Tensor) -> torch.Tensor:
    """Min over each CSR segment ``values[starts[s] : starts[s]+counts[s]]``."""
    sp = spans.enter("launch.segment_min") if _SPANS else None
    try:
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
        out = torch.empty(S, dtype=_F64, device=dev)
        if S == 0:
            return out
        lib = build.load()
        with torch.cuda.device(dev):
            err = lib.heye_segment_min(
                values.data_ptr(), starts.data_ptr(), counts.data_ptr(),
                out.data_ptr(), S, torch.cuda.current_stream().cuda_stream)
        build.check_launch(err, "segment_min")
        build.count_launch(launches, "segment_min")
        return out
    finally:
        if sp:
            spans.leave(sp)


def transfer_reprice(xW: torch.Tensor, xrate: torch.Tensor,
                     xt_last: torch.Tensor, xeta: torch.Tensor,
                     xstamp: torch.Tensor, xe_flat: torch.Tensor,
                     xe_start: torch.Tensor, xe_cnt: torch.Tensor,
                     edge_bw: torch.Tensor, edge_mem: torch.Tensor,
                     ks: torch.Tensor, upd_e: torch.Tensor,
                     upd_c: torch.Tensor, now: float, stamp0: int) -> None:
    """A flush's link reprice, in place on the transfer columns and the
    edge column ``edge_mem`` (see :func:`transfer_reprice_plain`).  ``ks``
    must hold distinct slots and ``upd_e`` distinct edges in ascending
    order: on the card each slot is written by its own thread, and a
    thread finds an edge's new count in ``upd_e`` by binary search."""
    sp = spans.enter("launch.transfer_reprice") if _SPANS else None
    try:
        dev = xW.device
        n = _check_job_columns((("xW", xW), ("xrate", xrate),
                                ("xt_last", xt_last), ("xeta", xeta)),
                               ks, "ks", dev)
        build.check_tensors(dev, ("xstamp", xstamp, _I64, 1),
                            ("xe_flat", xe_flat, _I64, 1),
                            ("xe_start", xe_start, _I64, 1),
                            ("xe_cnt", xe_cnt, _I64, 1),
                            ("edge_bw", edge_bw, _F64, 1),
                            ("edge_mem", edge_mem, _I64, 1),
                            ("upd_e", upd_e, _I64, 1),
                            ("upd_c", upd_c, _I64, 1))
        cap = xW.shape[0]
        if (xstamp.shape[0] != cap or xe_start.shape[0] != cap
                or xe_cnt.shape[0] != cap):
            raise ValueError("xstamp, xe_start and xe_cnt must match the "
                             "transfer columns")
        if edge_mem.shape[0] != edge_bw.shape[0]:
            raise ValueError("edge_bw and edge_mem must have one length")
        if upd_c.shape[0] != upd_e.shape[0]:
            raise ValueError("upd_e and upd_c must have one length")
        now = float(now)
        stamp0 = int(stamp0)
        if dev.type == "cpu":
            transfer_reprice_plain(xW, xrate, xt_last, xeta, xstamp, xe_flat,
                                   xe_start, xe_cnt, edge_bw, edge_mem, ks,
                                   upd_e, upd_c, now, stamp0)
            return
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        u = upd_e.shape[0]
        if n == 0 and u == 0:
            return
        lib = build.load()
        with torch.cuda.device(dev):
            err = lib.heye_transfer_reprice(
                xW.data_ptr(), xrate.data_ptr(), xt_last.data_ptr(),
                xeta.data_ptr(), xstamp.data_ptr(), xe_flat.data_ptr(),
                xe_start.data_ptr(), xe_cnt.data_ptr(), edge_bw.data_ptr(),
                edge_mem.data_ptr(), ks.data_ptr(), n, upd_e.data_ptr(),
                upd_c.data_ptr(), u, now, stamp0,
                torch.cuda.current_stream().cuda_stream)
        build.check_launch(err, "transfer_reprice")
        build.count_launch(launches, "transfer_reprice")
    finally:
        if sp:
            spans.leave(sp)


def transfer_complete(xW: torch.Tensor, xrate: torch.Tensor,
                      xt_last: torch.Tensor, xeta: torch.Tensor,
                      done: torch.Tensor, now: float,
                      tol: float) -> torch.Tensor:
    """A timestamp's transfer completions, in place on the transfer
    columns (see :func:`transfer_complete_plain`); returns the ``(2, n)``
    int64 pairs ``[done, finished]`` for one host copy.  ``done`` must
    hold distinct slots."""
    sp = spans.enter("launch.transfer_complete") if _SPANS else None
    try:
        dev = xW.device
        n = _check_job_columns((("xW", xW), ("xrate", xrate),
                                ("xt_last", xt_last), ("xeta", xeta)), done,
                               "done", dev)
        now = float(now)
        tol = float(tol)
        if dev.type == "cpu":
            return transfer_complete_plain(xW, xrate, xt_last, xeta, done, now,
                                           tol)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        pairs = torch.empty((2, n), dtype=_I64, device=dev)
        if n == 0:
            return pairs
        lib = build.load()
        with torch.cuda.device(dev):
            err = lib.heye_transfer_complete(
                xW.data_ptr(), xrate.data_ptr(), xt_last.data_ptr(),
                xeta.data_ptr(), done.data_ptr(), pairs.data_ptr(), n, now,
                tol, torch.cuda.current_stream().cuda_stream)
        build.check_launch(err, "transfer_complete")
        build.count_launch(launches, "transfer_complete")
        return pairs
    finally:
        if sp:
            spans.leave(sp)
