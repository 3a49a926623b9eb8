#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
(one ``nvcc`` per source, all started together) and holds each against
its plain PyTorch version on the card: the scheduler's B1 (slowdown
factors: the row form, the pool form of the DES repricing and the
same-device form of the walk's constraint checks), B2 (rate-advance and
its two fused in-place settle forms, reprice and complete), B3
(segment-min), B4 / B4b (the scan-reduce, one scan or a ragged stack) and
the model path's flash attention (B5: bfloat16 on the tensor cores,
float32 on the CUDA cores) and LRU scan (B6, fed by TMA).  Each
kernel's row has ``ms`` (CUDA events around back-to-back calls of the
Python wrapper: the launch path included) and ``body_ms``
(the kernel's own device time: every kernel's calls traced in one
torch.profiler session after the last timed phase).
Then it drives the port's two paths through their public entry points:

* ``model_x_smoke``: recurrentgemma-9b ``.smoke()`` in float32, weights
  made on the card and copied to a CPU model; forward, prefill, 8
  teacher-forced decode steps and a ``ServeEngine`` run, card (kernels)
  against CPU (plain versions);
* ``x8`` / ``x128``: the offline scheduler session (map -> execute) on the
  Fig. 13 mining fleet at mult=8 (card vs CPU vs the port's own reference
  event loop) and at full width, mult=128 (8448 PUs, 4608 tasks), whose
  every scheduler kernel must have been launched (after ``serve_full``
  the same session runs once more under torch.profiler, for its
  device-op count), then B1's row form on its own path, the traverser's
  what-if query;
* ``model_full``: recurrentgemma-9b at full width (38 layers, d=4096,
  ~8.5 B float32 parameters from a seeded generator): prefill(1, 4096) in
  float32 through the kernels against the plain route, then prefill(2,
  4096) + 16 decode steps in bfloat16, timed;
* ``serve_full``: ``repro_torch.launch.serve`` at full width (tenant
  placement on the simulated TPU fleet, then 8 requests over 4 slots).

One JSON object per line; the last line is ``{"ok": true, "device":
{...}}``.  Any failing phase raises, and the script exits non-zero without
printing a result.  Without a CUDA device it fails at once: there is no CPU
path.
"""
from __future__ import annotations

import argparse
import json
import os
import gc
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np          # noqa: E402
import torch                # noqa: E402

import repro_torch.core as core                              # noqa: E402
import repro_torch.core.orchestrator as orc_mod              # noqa: E402
import repro_torch.core.slowdown as sd_mod                   # noqa: E402
import repro_torch.launch.serve as serve_launch              # noqa: E402
from repro_torch import device as rt_device                  # noqa: E402
from repro_torch.configs import get_config                   # noqa: E402
from repro_torch.core.workloads import mining_workload       # noqa: E402
from repro_torch.kernels import (build, slowdown_kernel,     # noqa: E402
                                 timeline_kernel, walk_kernel)
from repro_torch.kernels import flash_attention as fa_kernel  # noqa: E402
from repro_torch.kernels import lru_scan as lru_kernel       # noqa: E402
from repro_torch.models import ParallelCtx, build_model      # noqa: E402
from repro_torch.models.transformer import tree_map          # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine    # noqa: E402

# published peaks of one H100 SXM (NVIDIA data sheet): device memory rate,
# the float64 and float32 rates outside the tensor cores, the dense bf16
# tensor-core rate
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
REL_TOL = 1e-12             # floats against the plain version (decisions exact)
T_TOL = 1e-9                # finish times: card vs CPU, fused vs reference
# B5 against its plain version, same inputs.  float32 (the CUDA-core
# kernel): both sum in float32 in another order (observed ~1e-6 at unit
# scale); x100 logits make every score ~1e4, so a reordering moves it by
# ~1e-3 (the reference's own kernel test allows 2e-3 there).  bfloat16 (the
# tensor-core kernel): the kernel rounds P to bf16 before P.V where the
# plain version keeps it in float32, so an output near 0 (terms that
# cancel) carries an error that scales with its row, not with itself:
# allowed = 2^-7 * |plain| + 2^-6 * rms(plain over the row's hd entries),
# ``fa_kernel.bf16_allowed``.  A tile-wise emulation of the kernel's
# rounding on the CPU (tests/test_torch_model_kernels.py) lands at 0.55-0.61
# of that, a window off by one key two orders of magnitude above it.
ATTN_F32_TOL = 1e-4
ATTN_X100_TOL = 2e-3
# model_x_smoke: float32 logits (|logit| ~ 2), card kernels vs CPU plain
# versions, every layer in float32 -> reorderings only
SMOKE_LOGIT_TOL = 1e-4
# model_full: float32 prefill over 38 layers, kernel route (online-softmax
# attention, sequential scan) vs plain route (banded local attention,
# log-depth associative scan), max |diff| relative to the logits' RMS
FULL_REL_TOL = 1e-3
FULL_ARCH = "recurrentgemma-9b"


FULL_MULT = 128             # the full-width run: 8448 PUs, 4608 tasks


def emit(name: str, obj: dict) -> None:
    print(json.dumps({name: obj}), flush=True)


# Fig. 13 mining fleet ratios (per `mult`; mult=8 is the paper's 80 edges /
# 24 servers), 12 sensors per mult
def mining_counts(mult: int) -> tuple[dict, dict]:
    ec = {"orin_agx": 3 * mult, "xavier_agx": 3 * mult,
          "orin_nano": 2 * mult, "xavier_nx": 2 * mult}
    sc = {"server1": mult, "server2": mult, "server3": mult}
    return ec, sc


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def time_ms(fn, iters: int = 200, warm: int = 20) -> float:
    """Median over 5 rounds of (CUDA-event time of `iters` calls) / iters."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        rounds.append(a.elapsed_time(b) / iters)
    return statistics.median(rounds)


class _Body:
    """A kernel-body measurement: ``iters`` calls of ``fn``, each launching
    the kernel whose traced name holds ``kernel`` once, traced by
    :func:`measure_bodies` after the last timed phase (a torch.profiler
    trace can leave later launches of its process slower, so no phase is
    timed after one)."""

    def __init__(self, fn, kernel: str, iters: int) -> None:
        self.fn, self.kernel, self.iters = fn, kernel, iters


def body_ms(fn, kernel: str, iters: int = 200) -> _Body:
    return _Body(fn, kernel, iters)


BODY_PAUSE_S = 0.1          # device idle between two bodies' loops


def _device_events(prof) -> list:
    """(start ns, end ns, name) of every event a finished torch.profiler
    trace shows on the card (kernels, copies, fills), in start order, read
    from the raw trace: the profiler's own event list is built lazily in
    Python and takes minutes for a session's ~750k events."""
    from torch.autograd import DeviceType
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA)


def _split_loops(events: list, n: int) -> list:
    """``events`` (start, end, name) in start order, split into ``n`` runs
    at the ``n - 1`` widest gaps between one event's end and the next's
    start: the pauses between the loops of :func:`measure_bodies`."""
    gaps = sorted(range(1, len(events)), reverse=True,
                  key=lambda i: events[i][0] - events[i - 1][1])[:n - 1]
    cuts = [0, *sorted(gaps), len(events)]
    return [events[a:b] for a, b in zip(cuts, cuts[1:])]


def measure_bodies(rows: list[dict]) -> None:
    """Replace every deferred ``body_ms`` of the kernel rows (and of their
    ``other_shapes``) with the device time per launch of its kernel, from
    ONE torch.profiler session: a loop of calls per body, in order, the
    device idle for ``BODY_PAUSE_S`` between two loops, so each loop's
    device events are one run of the trace.  The mean is over the launches
    the trace shows (it may drop an odd event)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    slots = [d for row in rows for d in (row, *row.get("other_shapes",
                                                       {}).values())
             if isinstance(d.get("body_ms"), _Body)]
    if not slots:
        return
    for d in slots:
        d["body_ms"].fn()
    torch.cuda.synchronize()
    gc.disable()            # no collector pause inside a loop
    try:
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            for d in slots:
                time.sleep(BODY_PAUSE_S)
                for _ in range(d["body_ms"].iters):
                    d["body_ms"].fn()
                torch.cuda.synchronize()
    finally:
        gc.enable()
    events = _device_events(prof)
    runs = _split_loops(events, len(slots))
    if len(runs) != len(slots):
        raise AssertionError(f"the trace shows {len(events)} device events "
                             f"for {len(slots)} loops")
    for d, run in zip(slots, runs):
        b = d["body_ms"]
        durs = [e - s for s, e, name in run if b.kernel in name]
        if len(durs) < b.iters // 2:
            raise AssertionError(f"the trace shows {len(durs)} launches of "
                                 f"{b.kernel} for {b.iters} calls")
        d["body_ms"] = sum(durs) / len(durs) / 1e6


def max_err(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(max abs err, max rel err) with equal infs / nans counted as 0."""
    a = a.to(torch.float64)
    b = b.to(torch.float64)
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    d = torch.where(same, torch.zeros_like(a), (a - b).abs())
    rel = d / torch.clamp_min(b.abs(), 1e-300)
    rel = torch.where(same, torch.zeros_like(rel), rel)
    if d.numel() == 0:
        return 0.0, 0.0
    return float(d.max()), float(rel.max())


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------
def _bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal to the bit, a NaN matching a NaN."""
    return a.shape == b.shape and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def check_slowdown(dev, rng) -> dict:
    """B1's row form (the traverser's dense check) against its plain
    version, bit for bit, at N = 3, 16, 4223 rows."""
    kappa = 0.12
    for n in (3, 16, 4223):
        x = rng.uniform(0.0, 3.0, (n, 6))
        x[rng.random((n, 6)) < 0.5] = 0.0
        x[0, :] = 0.0
        beta = np.array([0.0884, 0.1330, 0.1107, 0.1786, 0.4196, 0.0])
        mem = rng.uniform(0.05, 1.0, n)
        mt = rng.uniform(0.0, 2.0, n)
        mt[rng.random(n) < 0.5] = 0.0
        args = [torch.as_tensor(a, device=dev) for a in (x, beta, mem, mt)]
        got = slowdown_kernel.slowdown_factors(*args, kappa)
        ref = slowdown_kernel.slowdown_factors_plain(*args, kappa)
        torch.cuda.synchronize()
        if not _bit_equal(got, ref):
            raise AssertionError(f"slowdown_factors N={n} is not bit-equal "
                                 "to its plain version")
    ms = time_ms(lambda: slowdown_kernel.slowdown_factors(*args, kappa))
    body = body_ms(lambda: slowdown_kernel.slowdown_factors(*args, kappa),
                   "slowdown_factors_kernel")
    plain = time_ms(lambda: slowdown_kernel.slowdown_factors_plain(*args, kappa))
    n, r = 4223, 6
    nbytes = 8 * (n * r + r + 3 * n)
    flops = n * (r * 6 + 2)
    return dict(name="slowdown_factors", route="cuda",
                source="src/repro_torch/kernels/csrc/slowdown_factors.cu",
                replaces="src/repro/kernels/slowdown_kernel.py:47",
                shape=f"N={n} R={r}", max_abs_err=0.0, max_rel_err=0.0,
                tolerance="bit-equal", ms=ms, body_ms=body, plain_ms=plain,
                **bound(nbytes, flops), library_ms=None)


# the snapshot's size at mult=128: 8448 PUs, 6 resource classes
SD_PUS, SD_R = 8448, 6
SD_KAPPA = 0.12


def _sd_tables(dev, rng) -> tuple:
    """Snapshot tables at mult=128's size: ``ncr_rclass`` (int16, classes
    -1..R-1 drawn at random), ``mem_cap`` (inf, some PUs capped),
    ``mt_vec``, ``beta`` (one class inactive)."""
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    ncr = torch.randint(-1, SD_R, (SD_PUS, SD_PUS), generator=g, device=dev,
                        dtype=torch.int16)
    cap = np.full(SD_PUS, np.inf)
    cap[rng.random(SD_PUS) < 0.2] = 0.3
    mt_vec = rng.uniform(0.2, 0.5, SD_PUS)
    beta = np.array([0.0884, 0.1330, 0.1107, 0.1786, 0.4196, 0.0])
    return (ncr, *(torch.as_tensor(a, device=dev)
                   for a in (cap, mt_vec, beta)))


def _pool_case(dev, rng, n, tables, nan=False):
    """A pool of ``n`` rows of 8192-row job columns, its PUs drawn from
    n // 3 + 1 of them (ties), uids distinct and, for the uid-masked
    mode, with repeats.  Returns (args, args of the uid-masked mode)."""
    rows = 8192
    pus = rng.choice(SD_PUS, n // 3 + 1, replace=False)
    cols = [rng.choice(pus, rows), rng.uniform(0.2, 1.5, rows),
            rng.uniform(0.05, 1.5, rows), np.arange(rows)]
    members = rng.permutation(rows)[:n]
    if nan:
        cols[1][members[n // 2]] = np.nan
    cols = [torch.as_tensor(c, device=dev) for c in cols]
    m = torch.as_tensor(members, device=dev)
    ncr, cap, mt_vec, beta = tables
    tail = (cap, ncr, mt_vec, beta, SD_KAPPA)
    dup = torch.as_tensor(rng.integers(0, n // 2 + 1, rows), device=dev)
    return ((m, *cols, *tail, True), (m, *cols[:3], dup, *tail, False))


def _pool_bytes(args) -> tuple[int, int]:
    """(bytes, operations) one pool needs: 56 bytes of gathered columns and
    tables per member, 2 per distinct ncr entry read (PU pairs that
    differ), beta, 8 per factor written; an add per pair, ~40 operations
    per member for its factor."""
    P = args[1][args[0]].cpu().numpy()
    n = len(P)
    u = len(np.unique(P))
    return 56 * n + 2 * (u * u - u) + 8 * SD_R + 8 * n, n * n + 40 * n


def check_slowdown_pool(dev, rng, tables) -> dict:
    """The pool form (the DES repricing) against its plain version, bit for
    bit, at n = 2, 8, 384, 4608 members, in both modes (distinct members,
    uid-masked), PU ties included, a NaN usage at n=384; timed at 8 (with
    384 and 4608 beside)."""
    for n in (2, 8, 384, 4608):
        for args in _pool_case(dev, rng, n, tables, nan=n == 384):
            got = slowdown_kernel.slowdown_pool(*args)
            ref = slowdown_kernel.slowdown_pool_plain(*args)
            torch.cuda.synchronize()
            if not _bit_equal(got, ref):
                raise AssertionError(f"slowdown_pool n={n} distinct="
                                     f"{args[-1]} is not bit-equal to its "
                                     "plain version")
    shapes = {}
    for n, plain_iters in ((8, 50), (384, 10), (4608, 2)):
        args = _pool_case(dev, rng, n, tables)[0]

        def fn(args=args):
            return slowdown_kernel.slowdown_pool(*args)

        def plain_fn(args=args):
            return slowdown_kernel.slowdown_pool_plain(*args)
        nbytes, ops = _pool_bytes(args)
        shapes[n] = dict(ms=time_ms(fn), body_ms=body_ms(fn,
                                                         "slowdown_pool_kernel"),
                         plain_ms=time_ms(plain_fn, plain_iters, 1),
                         **bound(nbytes, ops))
    return dict(name="slowdown_pool", route="cuda",
                source="src/repro_torch/kernels/csrc/slowdown_factors.cu",
                replaces="src/repro/kernels/slowdown_kernel.py:47 (with "
                         "src/repro/core/slowdown.py:441 _factor_batch_arrays"
                         ", the pressures around it)",
                shape="n=8 members, 8448-PU snapshot", max_abs_err=0.0,
                max_rel_err=0.0, tolerance="bit-equal", **shapes[8],
                library_ms=None, other_shapes={
                    f"n={n}": shapes[n] for n in (384, 4608)})


def _sd_view(dev, rng, A, per_dev=6):
    """A device-sorted ledger view of ``A`` actives over ``max(2, A // 4)``
    devices of ``per_dev`` PUs (device 1 empty), uids distinct, the
    newcomer's uid among them: (Pa, Ua, Ma, uid_a, Da, astart, na) on the
    card and the device count."""
    nd = max(2, A // 4)
    dev_of = np.sort(rng.choice(np.delete(np.arange(nd), 1), A))
    Pa = dev_of * per_dev + rng.integers(0, per_dev, A)
    na = np.bincount(dev_of, minlength=nd)
    cols = (Pa, rng.uniform(0.2, 1.5, A), rng.uniform(0.05, 1.0, A),
            np.arange(100, 100 + A), dev_of, np.cumsum(na) - na, na)
    return [torch.as_tensor(c, device=dev) for c in cols], nd


def _sd_stack(dev, rng, A, per_dev=6):
    """A ragged stack over one view of ``A`` actives: single-device items
    (a device with actives, the empty device 1) and several-device items
    (three devices, the first 64 devices, every device)."""
    view, nd = _sd_view(dev, rng, A, per_dev)
    Da = view[4].cpu().numpy()
    busy = int(Da[len(Da) // 2])
    uid_new = 100 + int(rng.integers(0, A))        # a dead (equal-uid) pair

    def item(devs, single):
        Pc = np.concatenate([d * per_dev + np.arange(per_dev) for d in devs])
        Pc, Dc = (torch.as_tensor(a, device=dev)
                  for a in (Pc, Pc // per_dev))
        na = view[6].cpu().numpy()
        st = view[5].cpu().numpy()
        summ = (int(devs[0]), single, int(st[devs[0]]), int(na[devs[0]]))
        return slowdown_kernel.SameDeviceItem(
            Pc, Dc, 1.0, 0.6, uid_new, *view, summ)
    items = [item([busy], True), item([1], True),
             item(sorted({0, 1, busy}), False),
             item(list(range(min(nd, 64))), False),
             item(list(range(nd)), False)]
    return items, view


def _sd_bytes(items, R=SD_R) -> tuple[int, int]:
    """(bytes, operations) a stack needs: per candidate its PU, device,
    cap, mt and factor (40); per active of a candidate device its five
    columns (40) and the segment arrays; 2 per ncr entry read (each
    candidate-active pair both ways, each active pair once); 24 per pair
    row written; the 200-byte item rows.  An add per pair read, ~40
    operations per factor."""
    nbytes = ops = 0
    for it in items:
        C = it.Pc.shape[0]
        na = it.na.cpu().numpy()
        devs = np.unique(it.Dc.cpu().numpy())
        K = int(na[it.Dc.cpu().numpy()].sum())
        seg = int(na[devs].sum())
        sq = int((na[devs] ** 2).sum())
        nbytes += 40 * C + 40 * seg + 16 * len(devs) + 2 * (2 * K + sq) \
            + 24 * K + 200
        ops += K + sq + 40 * (C + K)
    return nbytes, ops


def check_slowdown_same_device(dev, rng, tables) -> dict:
    """The same-device form (the walk's constraint checks) against its
    plain version, bit for bit, on ragged stacks over views of A = 2, 8,
    384 and 4608 actives (single- and several-device items, an empty
    device, a candidate with no same-device active, a dead pair); timed
    on a wave-depth stack of 16 single-device items over 8-active device
    views, and on the several-device stack at A=4608."""
    ncr, cap, mt_vec, beta = tables
    tail = (mt_vec, beta, cap, ncr, SD_KAPPA)
    for A in (2, 8, 384, 4608):
        items, _ = _sd_stack(dev, rng, A)
        got = slowdown_kernel.slowdown_same_device(items, *tail)
        ref = slowdown_kernel.slowdown_same_device_plain(items, *tail)
        torch.cuda.synchronize()
        for i, (g, r) in enumerate(zip(got, ref)):
            if not all(_bit_equal(a, b) for a, b in zip(g, r)):
                raise AssertionError(f"slowdown_same_device A={A} item {i} "
                                     "is not bit-equal to its plain version")
    wave = [_sd_stack(dev, rng, 8)[0][0] for _ in range(16)]
    big = _sd_stack(dev, rng, 4608)[0][2:]
    shapes = {}
    for label, items, plain_iters in (("wave", wave, 20), ("big", big, 2)):
        def fn(items=items):
            return slowdown_kernel.slowdown_same_device(items, *tail)

        def plain_fn(items=items):
            return slowdown_kernel.slowdown_same_device_plain(items, *tail)
        shapes[label] = dict(
            ms=time_ms(fn), body_ms=body_ms(fn, "slowdown_same_device_kernel"),
            plain_ms=time_ms(plain_fn, plain_iters, 1),
            **bound(*_sd_bytes(items)))
    return dict(name="slowdown_same_device", route="cuda",
                source="src/repro_torch/kernels/csrc/slowdown_factors.cu",
                replaces="src/repro/kernels/slowdown_kernel.py:47 (with "
                         "src/repro/core/slowdown.py:764 _same_device_rows, "
                         "the pressures around it)",
                shape="16 single-device items, 6 candidates x 8 actives",
                max_abs_err=0.0, max_rel_err=0.0, tolerance="bit-equal",
                **shapes["wave"], library_ms=None, other_shapes={
                    "3 several-device items over 4608 actives": shapes["big"]})


def _ra_inputs(dev, rng, n):
    W = rng.uniform(0.0, 5.0, n)
    rate = rng.uniform(0.1, 2.0, n)
    t_last = rng.uniform(0.0, 1.0, n)
    k = max(1, n // 16)
    rate[:k] = 0.0                       # rate <= 0 -> eta = +inf
    rate[k:2 * k] = -1.0
    rate[2 * k:3 * k] = np.inf           # inf * 0 -> NaN residue -> 0
    t_last[2 * k:3 * k] = 1.5
    W[3 * k:4 * k] = 0.0
    return [torch.as_tensor(a, device=dev) for a in (W, rate, t_last)], 1.5


def check_rate_advance(dev, rng) -> dict:
    worst = (0.0, 0.0)
    for n in (5, 384, 4608):
        args, now = _ra_inputs(dev, rng, n)
        W2, eta = timeline_kernel.rate_advance(*args, now)
        rW, reta = timeline_kernel.rate_advance_plain(*args, now)
        torch.cuda.synchronize()
        for e in (max_err(W2, rW), max_err(eta, reta)):
            worst = (max(worst[0], e[0]), max(worst[1], e[1]))
    n = 384
    args, now = _ra_inputs(dev, rng, n)
    ms = time_ms(lambda: timeline_kernel.rate_advance(*args, now))
    body = body_ms(lambda: timeline_kernel.rate_advance(*args, now),
                   "rate_advance_kernel")
    plain = time_ms(lambda: timeline_kernel.rate_advance_plain(*args, now))
    return dict(name="rate_advance", route="cuda",
                source="src/repro_torch/kernels/csrc/rate_advance.cu",
                replaces="src/repro/kernels/timeline_kernel.py:59",
                shape=f"N={n}", max_abs_err=worst[0], max_rel_err=worst[1],
                ms=ms, body_ms=body, plain_ms=plain,
                **bound(8 * 5 * n, 5 * n), library_ms=None)


# the job table's capacity at mult=128 (4608 tasks and the background
# jobs, grown by doubling)
SETTLE_COLS = 8192


def _job_cols(dev, rng):
    """Job columns W, rate, t_last, eta (float64) and cstamp (int64)."""
    W = rng.uniform(0.0, 5.0, SETTLE_COLS)
    W[::3] = 0.0                              # settled: finishes at once
    cols = (W, rng.uniform(0.1, 2.0, SETTLE_COLS),
            rng.uniform(0.0, 1.0, SETTLE_COLS),
            rng.uniform(0.0, 9.0, SETTLE_COLS),
            rng.integers(0, 100, SETTLE_COLS))
    return [torch.as_tensor(a, device=dev) for a in cols]


def _settle_calls(dev, rng, n):
    """The reprice and complete forms over n distinct slots and their
    plain versions, each on a copy of one set of job columns:
    (reprice, reprice plain, complete, complete plain, the columns)."""
    members = torch.as_tensor(rng.permutation(SETTLE_COLS)[:n], device=dev)
    factors = torch.as_tensor(rng.uniform(1.0, 3.0, n), device=dev)
    base = _job_cols(dev, rng)
    rc, rp, cc, cp = ([c.clone() for c in base] for _ in range(4))
    tk = timeline_kernel
    return (lambda: tk.settle_reprice(*rc, members, factors, 1.5, 77),
            lambda: tk.settle_reprice_plain(*rp, members, factors, 1.5, 77),
            lambda: tk.settle_complete(*cc[:4], members, 1.5, 1e-15),
            lambda: tk.settle_complete_plain(*cp[:4], members, 1.5, 1e-15),
            (rc, rp, cc[:4], cp[:4]))


def check_settle(dev, rng) -> list[dict]:
    """B2's two fused in-place settle forms against their plain versions,
    bit for bit (the columns and the completion pairs), at n = 1, 4 (a
    flush's average on the main path), 384 and 4608 distinct slots; timed
    at 4 and 4608."""
    for n in (1, 4, 384, 4608):
        rk, rp, ck, cp, (rc, rpc, cc, cpc) = _settle_calls(dev, rng, n)
        rk()
        rp()
        pk = ck()
        pp = cp()
        torch.cuda.synchronize()
        for name, got, ref in (("settle_reprice", rc, rpc),
                               ("settle_complete", cc + [pk], cpc + [pp])):
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                raise AssertionError(f"{name} at n={n} is not bit-equal to "
                                     "its plain version")
    out = []
    for name, idx, nbytes, flops in (
            ("settle_reprice", 0, 80, 6), ("settle_complete", 2, 72, 5)):
        shapes = {}
        for n in (4, 4608):
            calls = _settle_calls(dev, rng, n)
            kern, plain_fn = calls[idx], calls[idx + 1]
            shapes[n] = dict(
                ms=time_ms(kern), body_ms=body_ms(kern, f"{name}_kernel"),
                plain_ms=time_ms(plain_fn), **bound(nbytes * n, flops * n))
        out.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/rate_advance.cu",
            replaces="src/repro/core/timeline.py:194 (_settle_pos, the "
                     "settle form of src/repro/kernels/timeline_kernel.py:59)",
            shape="N=4 (a flush's average)", max_abs_err=0.0,
            max_rel_err=0.0, tolerance="bit-equal", **shapes[4],
            library_ms=None, other_shapes={"N=4608": shapes[4608]}))
    return out


def check_segment_min(dev, rng) -> dict:
    worst = (0.0, 0.0)
    for S in (1, 48, 768):
        counts = rng.integers(0, 9, S)
        counts[0] = 0                                 # empty segment -> +inf
        K = int(counts.sum())
        values = rng.uniform(1e6, 1e9, K + 7)         # slack: starts offset
        if K:
            values[rng.integers(0, K)] = np.inf
        starts = np.cumsum(counts) - counts + 7
        v, s, c = (torch.as_tensor(a, device=dev)
                   for a in (values, starts, counts))
        got = timeline_kernel.segment_min(v, s, c)
        ref = timeline_kernel.segment_min_plain(v, s, c)
        torch.cuda.synchronize()
        e = max_err(got, ref)
        worst = (max(worst[0], e[0]), max(worst[1], e[1]))
    ms = time_ms(lambda: timeline_kernel.segment_min(v, s, c))
    body = body_ms(lambda: timeline_kernel.segment_min(v, s, c),
                   "segment_min_kernel")
    plain = time_ms(lambda: timeline_kernel.segment_min_plain(v, s, c), 50, 5)
    # the one library call computing the same function, on the same data
    # laid out contiguously; timed here, used nowhere in the port
    nz = c > 0
    data = torch.cat([v[int(a):int(a) + int(b)]
                      for a, b in zip(s.tolist(), c.tolist())])
    lib_out = torch.segment_reduce(data, "min", lengths=c, initial=float("inf"))
    torch.cuda.synchronize()
    if max_err(lib_out[nz], got[nz])[0] != 0.0:
        raise AssertionError("segment_reduce yardstick disagrees")
    lib = time_ms(lambda: torch.segment_reduce(data, "min", lengths=c,
                                               initial=float("inf")))
    nbytes = 8 * (K + 3 * S)
    return dict(name="segment_min", route="cuda",
                source="src/repro_torch/kernels/csrc/segment_min.cu",
                replaces="src/repro/kernels/timeline_kernel.py:109",
                shape=f"S={S} K={K}", max_abs_err=worst[0],
                max_rel_err=worst[1], ms=ms, body_ms=body, plain_ms=plain,
                **bound(nbytes, K), library_ms=lib)


LQC = 5e-6                  # the walk's local query cost


def _scan_case(rng, n_dev, per_dev, mode):
    """One scan as numpy: (ok, key, sa, f, cm) over n_dev * per_dev PUs and
    a two-level plan (root + n_dev device nodes; one node that owns the
    PUs when n_dev == 1: the walk's device scan)."""
    P = n_dev * per_dev
    ok = rng.random(P) < 0.4
    key = rng.uniform(0.01, 0.2, P)
    if mode == "ties":
        key[:] = np.round(key, 2)
    elif mode == "allinf":
        key[:] = np.inf
    elif mode == "infeasible":
        ok[:] = False
    if mode != "infeasible":
        ok[rng.integers(0, P)] = True
    cols = (ok, key, rng.uniform(0.01, 0.1, P), rng.uniform(1.0, 2.0, P),
            rng.uniform(0.0, 0.01, P))
    if n_dev == 1:
        return cols, ([0], [P], [P], [0], [0.0], [0.0])
    return cols, ([0] + [d * per_dev for d in range(n_dev)],
                  [P] + [(d + 1) * per_dev for d in range(n_dev)],
                  [0] + [per_dev] * n_dev, [n_dev] + [0] * n_dev,
                  [float(rng.uniform(1e-4, 1e-3))] + [0.0] * n_dev,
                  [0.0] + [1.0] * n_dev)


def _scan_stack(dev, rng, shapes, modes):
    """A ragged stack: the concatenated columns on the card, the plan pool
    (one plan per scan) and the per-scan offsets."""
    cases = [_scan_case(rng, nd, pd, modes[i % len(modes)])
             for i, (nd, pd) in enumerate(shapes)]
    cols = [torch.as_tensor(np.concatenate(c), device=dev)
            for c in zip(*[c for c, _ in cases])]
    pool = [sum((list(p[j]) for _, p in cases), []) for j in range(6)]
    offs, o, no = [], 0, 0
    for c, p in cases:
        offs.append((o, len(c[0]), no, len(p[0])))
        o += len(c[0])
        no += len(p[0])
    return cols, walk_kernel.ScanPlanArrays.from_lists(*pool, dev), offs


def _scan_bytes(P: int, Nn: int, rows: torch.Tensor, meta: bool) -> int:
    """Bytes a stack of scans must move, given its ``(S, 7)`` result rows:
    ``ok`` (1) and ``key`` (8) per PU, 48 per plan node, ``sa``/``f``/``cm``
    (24) at each feasible scan's winner only, the offsets and launch order
    (5 x 8 per scan) where they are passed, and the 7-double rows once."""
    rows = rows.reshape(-1, 7)
    S = rows.shape[0]
    won = int((rows[:, 0] >= 0).sum())
    return 9 * P + 48 * Nn + 24 * won + (40 * S if meta else 0) + 56 * S


def _rows_agree(got: torch.Tensor, ref: torch.Tensor, what: str) -> tuple:
    """Decisions and gathered columns exact; returns the overhead's
    (max abs err, max rel err)."""
    g, r = got.reshape(-1, 7), ref.reshape(-1, 7)
    exact = [0, 1, 2, 4, 5, 6]
    if not torch.equal(g[:, exact], r[:, exact]):
        bad = (g[:, exact] != r[:, exact]).any(1).nonzero()[:3, 0].tolist()
        raise AssertionError(f"{what}: rows {bad} differ: "
                             f"{g[bad].tolist()} vs {r[bad].tolist()}")
    return max_err(g[:, 3], r[:, 3])


def _one_scan_plain(args: list, arr) -> torch.Tensor:
    """The plain version of one scan: the stack of one."""
    meta = torch.tensor([[0, args[0].shape[0], 0, arr.n]], dtype=torch.int64,
                        device=args[0].device)
    return walk_kernel.scan_reduce_batch_plain(*args, *arr.tensors(), meta,
                                               LQC)[0]


def check_scan_reduce(dev, rng) -> list[dict]:
    """B4 (one scan) and B4b (ragged stacks mixing P = 1, 6 and 8448 with
    ties, all-inf and infeasible rows) against their plain versions."""
    modes = ("plain", "ties", "allinf", "infeasible")
    worst = (0.0, 0.0)
    # warp scans up to 32 PUs, block scans above (33, a word boundary at
    # 64, the path's 8448, the largest a block takes: 131072)
    for n_dev, per_dev in ((1, 1), (1, 6), (1, 32), (1, 33), (2, 32),
                           (24, 6), (1408, 6), (3000, 3), (4096, 32)):
        for mode in modes:
            cols, plan = _scan_case(rng, n_dev, per_dev, mode)
            args = [torch.as_tensor(c, device=dev) for c in cols]
            arr = walk_kernel.ScanPlanArrays.from_lists(*plan, dev)
            got = walk_kernel.scan_reduce(*args, arr, LQC)
            ref = _one_scan_plain(args, arr)
            torch.cuda.synchronize()
            e = _rows_agree(got, ref, f"scan_reduce {n_dev}x{per_dev} {mode}")
            worst = (max(worst[0], e[0]), max(worst[1], e[1]))
    bworst = (0.0, 0.0)
    shapes = [(1, 1), (1, 6), (1408, 6), (1, 6), (24, 6), (1, 1),
              (1408, 6), (1, 6), (3, 2), (1, 6), (1, 1), (1408, 6)] * 3
    for rot in range(len(modes)):
        cols, arr, offs = _scan_stack(dev, rng, shapes,
                                      modes[rot:] + modes[:rot])
        got = walk_kernel.scan_reduce_batch(*cols, arr, offs, LQC)
        meta = torch.as_tensor(offs, dtype=torch.int64, device=dev)
        ref = walk_kernel.scan_reduce_batch_plain(*cols, *arr.tensors(),
                                                  meta, LQC)
        torch.cuda.synchronize()
        e = _rows_agree(got, ref, f"scan_reduce_batch (rotation {rot})")
        bworst = (max(bworst[0], e[0]), max(bworst[1], e[1]))
    single = {}
    for label, n_dev, per_dev in (("P=6", 1, 6), ("P=8448", 1408, 6)):
        cols, plan = _scan_case(rng, n_dev, per_dev, "plain")
        args = [torch.as_tensor(c, device=dev) for c in cols]
        arr = walk_kernel.ScanPlanArrays.from_lists(*plan, dev)
        P, Nn = len(cols[0]), arr.n

        def fn(args=args, arr=arr):
            return walk_kernel.scan_reduce(*args, arr, LQC)

        def plain_fn(args=args, arr=arr):
            return _one_scan_plain(args, arr)
        single[label] = dict(
            ms=time_ms(fn), body_ms=body_ms(fn, "scan_reduce_batch_kernel"),
            plain_ms=time_ms(plain_fn, 50, 5),
            **bound(_scan_bytes(P, Nn, plain_fn(), False), 2 * P + 6 * Nn))
    rows = [dict(
        name="scan_reduce", route="cuda",
        source="src/repro_torch/kernels/csrc/scan_reduce.cu",
        replaces="src/repro/kernels/walk_kernel.py:150",
        shape="P=6 (device scan), a stack of one", max_abs_err=worst[0],
        max_rel_err=worst[1], **single["P=6"], library_ms=None,
        other_shapes={"P=8448": single["P=8448"]})]
    # the phase-1 wave at mult=128: 1152 device scans of 6 PUs, each with
    # its own one-node plan
    S = 1152
    cols, arr, offs = _scan_stack(dev, rng, [(1, 6)] * S, ("plain",))
    meta = torch.as_tensor(offs, dtype=torch.int64, device=dev)

    def batch():
        return walk_kernel.scan_reduce_batch(*cols, arr, offs, LQC)

    def batch_plain():
        return walk_kernel.scan_reduce_batch_plain(*cols, *arr.tensors(),
                                                   meta, LQC)
    rows.append(dict(
        name="scan_reduce_batch", route="cuda",
        source="src/repro_torch/kernels/csrc/scan_reduce.cu",
        replaces="src/repro/kernels/walk_kernel.py:168",
        shape=f"S={S} scans of P=6 (a phase-1 wave at mult=128)",
        max_abs_err=bworst[0], max_rel_err=bworst[1], ms=time_ms(batch),
        body_ms=body_ms(batch, "scan_reduce_batch_kernel"),
        plain_ms=time_ms(batch_plain, 50, 5),
        **bound(_scan_bytes(6 * S, S, batch_plain(), True), S * (2 * 6 + 6)),
        library_ms=None))
    return rows


# the model path's shapes: recurrentgemma-9b's local attention layers and
# RG-LRU blocks at prefill(B=2, S=4096)
PATH_B, PATH_S = 2, 4096


def _attn_inputs(dev, rng, B, S, Hq, Hkv, hd, dtype, scale=1.0):
    q = rng.standard_normal((B, S, Hq, hd)) * scale
    k = rng.standard_normal((B, S, Hkv, hd)) * scale
    v = rng.standard_normal((B, S, Hkv, hd))
    return [torch.as_tensor(a, dtype=torch.float32, device=dev).to(dtype)
            for a in (q, k, v)]


def _attn_err(got, ref, dtype, tol):
    """(max abs err, worst ratio of the error to the tolerance)."""
    g, r = got.double(), ref.double()
    d = (g - r).abs()
    if dtype == torch.bfloat16:
        allowed = fa_kernel.bf16_allowed(ref)
    else:
        allowed = torch.full_like(r, tol)
    return float(d.max()), float((d / allowed).max())


def _sdpa(q, k, v, causal=True, window=None):
    """The one PyTorch call computing B5's function (the same boolean mask,
    kv heads repeated), in the (B, S, H, hd) layout; a yardstick compared
    here, used nowhere in the port."""
    B, S, Hq, hd = q.shape
    mask = fa_kernel.attention_mask(S, causal, window, q.device)
    kt = k.transpose(1, 2).repeat_interleave(Hq // k.shape[2], dim=1)
    vt = v.transpose(1, 2).repeat_interleave(Hq // v.shape[2], dim=1)
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), kt, vt, attn_mask=mask,
        scale=1.0 / hd ** 0.5).transpose(1, 2)


def check_flash(dev, rng) -> dict:
    """B5 on the card against its plain version: MHA / GQA / MQA, hd 16 to
    256, causal only, windows (shorter than a kv tile, S > window), softcap,
    x100 logits, non-causal, S below one tile and S that no tile divides;
    float32 (the CUDA-core kernel) and bfloat16 (the tensor-core kernel).
    SDPA's own distance from the plain version is taken on the same bf16
    inputs, where it computes the same function (no softcap)."""
    cases = [
        # (B, S, Hq, Hkv, hd, kwargs, logit scale)
        (1, 256, 4, 4, 64, {}, 1.0),
        (2, 320, 8, 2, 64, {}, 1.0),
        (1, 512, 16, 1, 256, {}, 1.0),
        (1, 512, 4, 1, 256, {"window": 16}, 1.0),
        (1, 1024, 4, 1, 256, {"window": 300}, 1.0),
        (1, 777, 4, 2, 256, {"window": 300, "softcap": 50.0}, 1.0),
        (1, 256, 4, 2, 64, {"softcap": 50.0}, 1.0),
        (1, 384, 4, 2, 128, {"softcap": 30.0, "window": 100}, 1.0),
        (1, 1000, 8, 2, 128, {}, 1.0),
        (2, 40, 4, 1, 16, {"window": 16}, 1.0),
        (1, 200, 4, 2, 32, {"causal": False}, 1.0),
        (1, 256, 2, 2, 64, {}, 100.0),
    ]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    worst_ratio = {"float32": 0.0, "bfloat16": 0.0}
    sdpa_ratio = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for B, S, Hq, Hkv, hd, kw, scale in cases:
            q, k, v = _attn_inputs(dev, rng, B, S, Hq, Hkv, hd, dtype, scale)
            got = fa_kernel.flash_attention(q, k, v, **kw)
            ref = fa_kernel.flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            if got.dtype != dtype or not torch.isfinite(got).all():
                raise AssertionError(f"flash_attention {dtype} {kw}: wrong "
                                     "dtype or non-finite output")
            tol = ATTN_X100_TOL if scale > 1.0 else ATTN_F32_TOL
            e, ratio = _attn_err(got, ref, dtype, tol)
            worst[name] = max(worst[name], e)
            if not ratio <= 1.0:
                raise AssertionError(
                    f"flash_attention {name} B={B} S={S} Hq={Hq} Hkv={Hkv} "
                    f"hd={hd} {kw} x{scale}: max err {e} over its tolerance")
            worst_ratio[name] = max(worst_ratio[name], ratio)
            if dtype == torch.bfloat16 and "softcap" not in kw:
                lib = _sdpa(q, k, v, kw.get("causal", True), kw.get("window"))
                sdpa_ratio = max(sdpa_ratio,
                                 _attn_err(lib, ref, dtype, 0.0)[1])
    # the path's shape, the serving dtype
    B, S, Hq, Hkv, hd, window = PATH_B, PATH_S, 16, 1, 256, 2048
    q, k, v = _attn_inputs(dev, rng, B, S, Hq, Hkv, hd, torch.bfloat16)
    got = fa_kernel.flash_attention(q, k, v, window=window)
    ref = fa_kernel.flash_attention_plain(q, k, v, window=window)
    torch.cuda.synchronize()
    e, ratio = _attn_err(got, ref, torch.bfloat16, 0.0)
    if not ratio <= 1.0:
        raise AssertionError(f"flash_attention at the path's shape: {e}")
    worst["bfloat16"] = max(worst["bfloat16"], e)
    worst_ratio["bfloat16"] = max(worst_ratio["bfloat16"], ratio)
    ms = time_ms(lambda: fa_kernel.flash_attention(q, k, v, window=window),
                 20, 3)
    body = body_ms(lambda: fa_kernel.flash_attention(q, k, v, window=window),
                   "flash_attention_tc_kernel", 20)
    plain = time_ms(lambda: fa_kernel.flash_attention_plain(
        q, k, v, window=window), 3, 1)
    # the library yardstick at the path's shape, kv heads expanded as views
    mask = fa_kernel.attention_mask(S, True, window, dev)
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2).expand(B, Hq, S, hd)
    vt = v.transpose(1, 2).expand(B, Hq, S, hd)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def lib_call():
        return sdpa(qt, kt, vt, attn_mask=mask, scale=1.0 / hd ** 0.5)
    lib_out = lib_call().transpose(1, 2)
    torch.cuda.synchronize()
    lib_err, lib_ratio = _attn_err(lib_out, ref, torch.bfloat16, 0.0)
    sdpa_ratio = max(sdpa_ratio, lib_ratio)
    if not lib_err < 0.1:
        raise AssertionError(f"the SDPA yardstick computes something else "
                             f"(max err {lib_err})")
    lib = time_ms(lib_call, 20, 3)
    pos = np.arange(S)
    live = int(np.minimum(pos + 1, window).sum())      # (i, j) pairs per (b, h)
    flops = 4 * hd * live * B * Hq
    nbytes = 2 * (2 * B * S * Hq * hd + 2 * B * S * Hkv * hd)
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention_tc.cuh",
                replaces="src/repro/kernels/flash_attention.py:95",
                instructions="wgmma+tma",
                float32_route=dict(
                    source="src/repro_torch/kernels/csrc/flash_attention.cuh",
                    instructions="fma (CUDA cores)"),
                shape=f"B={B} S={S} Hq={Hq} Hkv={Hkv} hd={hd} "
                      f"window={window} bf16",
                max_abs_err=max(worst.values()),
                max_abs_err_by_dtype=worst,
                worst_err_over_tolerance=worst_ratio,
                sdpa_worst_err_over_tolerance=sdpa_ratio,
                tolerance=(f"float32 {ATTN_F32_TOL} abs ({ATTN_X100_TOL} at "
                           f"x100 logits); bfloat16 {fa_kernel.BF16_REL}*|plain|"
                           f" + {fa_kernel.BF16_ROW}*rms(plain row)"),
                ms=ms, body_ms=body, plain_ms=plain,
                **bound(nbytes, flops, BF16_FLOPS),
                library_ms=lib,
                library_call="torch.nn.functional.scaled_dot_product_attention",
                library_max_abs_err=lib_err, flops=flops)


def _lru_inputs(dev, rng, B, S, W, offset=0):
    """a in (0, 1) with a = 0 and a = 1 columns, b normal; ``offset`` floats
    into a larger buffer (a base TMA cannot take)."""
    a = rng.uniform(0.0, 1.0, (B, S, W))
    a[..., 0] = 0.0
    a[..., min(1, W - 1)] = 1.0
    b = rng.standard_normal((B, S, W))
    out = []
    for x in (a, b):
        buf = torch.empty(x.size + offset, dtype=torch.float32, device=dev)
        t = buf[offset:].view(B, S, W)
        t.copy_(torch.as_tensor(x, dtype=torch.float32))
        out.append(t)
    return out


# (B, S, W, offset): ragged shapes and shapes that straddle the TMA kernel's
# (64 steps x 32 channels) box and its six-stage ring (S = 385: seven
# tiles); W % 4 != 0 and an offset base take the thread-per-channel kernel
LRU_CASES = ((1, 64, 128, 0), (2, 256, 256, 0), (1, 128, 100, 0),
             (3, 96, 64, 0), (2, 77, 33, 0), (2, 65, 36, 0), (1, 63, 32, 0),
             (2, 5, 8, 0), (1, 385, 68, 0), (2, 130, 4, 0),
             (1, 1000, 100, 0), (2, 200, 96, 1))


def check_lru(dev, rng) -> dict:
    """B6 on the card against its plain version, bit for bit, on the
    ragged and straddling shapes of ``LRU_CASES`` and at the path's shape
    (the TMA kernel)."""
    worst = 0.0
    for B, S, W, off in LRU_CASES:
        a, b = _lru_inputs(dev, rng, B, S, W, off)
        got = lru_kernel.lru_scan(a, b)
        ref = lru_kernel.lru_scan_plain(a, b)
        torch.cuda.synchronize()
        e = max_err(got, ref)[0]
        if e != 0.0:
            raise AssertionError(f"lru_scan ({B},{S},{W}) offset {off} "
                                 f"differs from its plain version by {e} "
                                 "(bit-equal expected)")
        worst = max(worst, e)
    B, S, W = PATH_B, PATH_S, 4096
    a, b = (torch.as_tensor(x, dtype=torch.float32, device=dev)
            for x in (rng.uniform(0.899, 0.999, (B, S, W)),
                      rng.standard_normal((B, S, W))))
    got = lru_kernel.lru_scan(a, b)
    ref = lru_kernel.lru_scan_plain(a, b)
    torch.cuda.synchronize()
    if max_err(got, ref)[0] != 0.0:
        raise AssertionError("lru_scan at the path's shape is not bit-equal")
    ms = time_ms(lambda: lru_kernel.lru_scan(a, b), 20, 3)
    body = body_ms(lambda: lru_kernel.lru_scan(a, b), "lru_scan_tma_kernel",
                   20)
    plain = time_ms(lambda: lru_kernel.lru_scan_plain(a, b), 2, 1)
    return dict(name="lru_scan", route="cuda",
                source="src/repro_torch/kernels/csrc/lru_scan.cu",
                replaces="src/repro/kernels/lru_scan.py:45",
                instructions="tma+mbarrier",
                shape=f"B={B} S={S} W={W} fp32", max_abs_err=worst,
                tolerance="bit-equal", ms=ms, body_ms=body, plain_ms=plain,
                **bound(3 * B * S * W * 4, 2 * B * S * W, FP32_FLOPS),
                library_ms=None)


def bound(nbytes: int, flops: int, peak: float = FP64_FLOPS) -> dict:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = flops / peak * 1e3
    return dict(bound_ms=max(tb, to),
                bound_by="bytes" if tb >= to else "operations")


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------
SCHED_KERNELS = ("slowdown_pool", "slowdown_same_device", "rate_advance",
                 "settle_reprice", "settle_complete", "segment_min",
                 "scan_reduce", "scan_reduce_batch")
MODEL_KERNELS = ("flash_attention", "lru_scan")


def reset_counts() -> None:
    fa_kernel.launches = 0
    lru_kernel.launches = 0
    for counts in (slowdown_kernel.launches, timeline_kernel.launches,
                   walk_kernel.launches):
        for k in counts:
            counts[k] = 0
    rt_device.reset_sync_count()


def read_counts() -> dict:
    return {**slowdown_kernel.launches,
            **timeline_kernel.launches, **walk_kernel.launches,
            "flash_attention": fa_kernel.launches,
            "lru_scan": lru_kernel.launches}


def run_session(mult: int, device, seed: int):
    """build_testbed -> mining_workload -> build_orchestrators ->
    SchedulerSession.map_pending / execute, through the public entry
    points.  Returns (stats, cfg, graph, session, seconds dict)."""
    ec, sc = mining_counts(mult)
    t0 = time.perf_counter()
    tb = core.build_testbed(edge_counts=ec, server_counts=sc, device=device)
    cfg = mining_workload(tb, n_sensors=12 * mult, n_readings=1)
    g = tb.graph
    root = core.build_orchestrators(g, core.heye_traverser(g))
    truth = core.ground_truth_traverser(
        g, rng=np.random.default_rng(seed))
    session = core.SchedulerSession(g, root, truth=truth)
    session.submit(cfg)
    t1 = time.perf_counter()
    session.map_pending()
    if g.device.type == "cuda":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    stats = session.execute()
    if g.device.type == "cuda":
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    secs = dict(setup_s=t1 - t0, map_pending_s=t2 - t1, execute_s=t3 - t2)
    return stats, cfg, g, session, secs


def by_order(stats, cfg):
    """Placements and finish times in cfg order (uids differ per run)."""
    return ([stats.mapping[t.uid] for t in cfg],
            [stats.timeline.finish[t.uid] for t in cfg])


def session_x8(seed: int) -> dict:
    reset_counts()
    gs, gcfg, gg, gsess, gsecs = run_session(8, None, seed)
    counts = read_counts()
    cs, ccfg, _, _, csecs = run_session(8, "cpu", seed)
    gm, gf = by_order(gs, gcfg)
    cm, cf = by_order(cs, ccfg)
    if gm != cm:
        bad = [i for i, (a, b) in enumerate(zip(gm, cm)) if a != b]
        raise AssertionError(f"x8: card and CPU placements differ at {bad[:5]}")
    if len(gs.unmapped) != len(cs.unmapped):
        raise AssertionError("x8: card and CPU unmapped counts differ")
    dt = max(abs(a - b) for a, b in zip(gf, cf))
    if not dt <= T_TOL:
        raise AssertionError(f"x8: card vs CPU finish times differ by {dt}")
    # the port's fused engine against the port's own reference event loop,
    # same mapping, each with a fresh generator from the same seed
    trav = core.ground_truth_traverser(gg, rng=np.random.default_rng(seed))
    ref_tl = trav.traverse_reference(gsess.cfg, gsess.mapping)
    de = max(abs(ref_tl.finish[u] - gs.timeline.finish[u])
             for u in ref_tl.finish)
    if not de <= T_TOL:
        raise AssertionError(f"x8: fused vs reference engine differ by {de}")
    return dict(mult=8, tasks=len(gcfg), placements_identical=True,
                max_finish_diff_cuda_vs_cpu=dt,
                max_finish_diff_fused_vs_reference=de, tolerance=T_TOL,
                unmapped=len(gs.unmapped), cuda=gsecs, cpu=csecs,
                launches=counts)


def _spread(xs: list) -> dict:
    """Count, mean, median and max of per-call sizes."""
    if not xs:
        return dict(calls=0)
    return dict(calls=len(xs), mean=float(np.mean(xs)),
                p50=float(np.median(xs)), max=int(max(xs)))


def session_full(seed: int) -> tuple[dict, dict]:
    """The session at full width: placements complete, every scheduler
    kernel launched, the size of each phase-1 wave's batched entry reduce
    and of each pool and same-device stack that reached B1 (read by
    wrapping the calls, outside the port); then the row form of B1 on its
    own path, the traverser's what-if query (:func:`what_if`).  Its
    device-op count comes later, from :func:`session_traced`."""
    mult = FULL_MULT
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    walk_call = orc_mod.scan_reduce_batch
    pool_call = sd_mod.slowdown_pool
    same_call = sd_mod.slowdown_same_device
    stacks: list[int] = []
    pools: list[int] = []
    same_items: list[int] = []
    same_pairs: list[int] = []

    def counted(*args):
        stacks.append(len(args[6]))
        return walk_call(*args)

    def counted_pool(members, *args):
        pools.append(members.shape[0])
        return pool_call(members, *args)

    def counted_same(items, *args):
        res = same_call(items, *args)
        same_items.append(len(items))
        same_pairs.append(sum(r[1].shape[0] for r in res))
        return res

    orc_mod.scan_reduce_batch = counted
    sd_mod.slowdown_pool = counted_pool
    sd_mod.slowdown_same_device = counted_same
    try:
        st, cfg, g, sess, secs = run_session(mult, None, seed)
    finally:
        orc_mod.scan_reduce_batch = walk_call
        sd_mod.slowdown_pool = pool_call
        sd_mod.slowdown_same_device = same_call
    counts = read_counts()
    syncs = rt_device.sync_count()
    peak = torch.cuda.max_memory_allocated()
    if counts["scan_reduce_batch"] != len(stacks):
        raise AssertionError(f"x{mult}: {len(stacks)} batched entry reduces,"
                             f" {counts['scan_reduce_batch']} launches")
    lat = st.latencies(cfg)
    if len(lat) != len(cfg) or not all(np.isfinite(lat)):
        raise AssertionError(f"x{mult}: unfinished or non-finite latencies")
    if len(st.mapping) != len(cfg):
        raise AssertionError(f"x{mult}: {len(cfg) - len(st.mapping)} tasks "
                             "have no mapping")
    if st.unmapped:
        raise AssertionError(f"x{mult}: {len(st.unmapped)} tasks unmapped")
    for name in SCHED_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"x{mult}: kernel {name} was never launched "
                                 "on the main path")
    pct = st.latency_percentiles(cfg, (50.0, 99.0))
    comp = g.compiled()
    wif = what_if(g, cfg, st)
    counts["slowdown_factors"] = wif["launches"]
    return dict(mult=mult, device=str(g.device), pus=len(comp.pu_names),
                tasks=len(cfg), mapped=len(st.mapping),
                unmapped=len(st.unmapped), **secs,
                p50_latency_s=pct[50.0], p99_latency_s=pct[99.0],
                qos_failures=st.qos_failures(cfg), launches=counts,
                entry_wave_scans=stacks, pool_members=_spread(pools),
                same_device_items=_spread(same_items),
                same_device_pairs=_spread(same_pairs),
                device_to_host_syncs=syncs, peak_device_bytes=peak,
                what_if=wif), counts


def what_if(g, cfg, st) -> dict:
    """The path of B1's row form: ``Traverser.predict_active_with`` — the
    updated factor of every task the session placed on the busiest device
    if one more task joins each of its PUs in turn (the Alg. 1 l.15
    re-check, the dense form of ``factors_with_candidates``), on the
    full-width fleet, counted from 0."""
    comp = g.compiled()
    by_dev: dict = {}
    for t in cfg:
        pu = st.mapping[t.uid]
        by_dev.setdefault(comp.device_name(pu), []).append((t, pu))
    dev_name, active = max(by_dev.items(), key=lambda kv: len(kv[1]))
    pus = [p.name for p in g.pus(under=dev_name)]
    trav = core.heye_traverser(g)
    reset_counts()
    out = [trav.predict_active_with(core.make_task("svm"), pu, active)
           for pu in pus]
    n = read_counts()["slowdown_factors"]
    # two launches a query: the newcomer's row, then the actives' rows
    if n != 2 * len(pus) or any(len(o) != len(active) for o in out) or not all(
            np.isfinite(list(o.values())).all() for o in out):
        raise AssertionError(f"what_if: {n} row-form launches for "
                             f"{len(pus)} queries, or missing factors")
    return dict(device=dev_name, actives=len(active), queries=len(pus),
                launches=n)


def session_traced(seed: int) -> dict:
    """The full-width session once more, under torch.profiler (CUDA
    activity): its device-op count (every kernel, copy and fill on the
    card) and device-busy seconds.  Run after the last timed phase."""
    from torch.profiler import ProfilerActivity
    wall, prof = _traced_session(FULL_MULT, seed, [ProfilerActivity.CUDA])
    ops = [e - s for s, e, _ in _device_events(prof) if e > s]
    if not ops:
        raise AssertionError("the traced session shows no device op")
    return dict(mult=FULL_MULT, traced_wall_s=wall,
                device_busy_s=sum(ops) / 1e9, device_ops=len(ops))


# ---------------------------------------------------------------------------
# the model path
# ---------------------------------------------------------------------------
def _logit_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.detach().cpu().double() - b.detach().cpu().double())
                 .abs().max())


def model_x_smoke(seed: int) -> dict:
    """recurrentgemma-9b smoke in float32: the card (kernels) against the
    CPU (the kernels' plain versions) on the same weights and tokens."""
    cfg = get_config(FULL_ARCH).smoke()
    ctx = ParallelCtx(compute_dtype=torch.float32)
    gm = build_model(cfg, ctx)
    gparams = gm.init(torch.Generator(device=gm.device).manual_seed(seed))
    cm = build_model(cfg, ctx, device="cpu")
    cparams = tree_map(lambda t: t.cpu(), gparams)
    rng = np.random.default_rng(seed)
    B, S, P, n_dec = 2, 40, 29, 8          # S, P > window 16; no tile divides
    toks = rng.integers(0, cfg.vocab, (B, S))
    errs = {"forward": 0.0, "prefill": 0.0, "decode": 0.0}
    reset_counts()
    runs = {}
    for name, m, prm in (("cuda", gm, gparams), ("cpu", cm, cparams)):
        fwd, _ = m.forward(prm, {"tokens": toks})
        cache = m.init_cache(B, S, dtype=torch.float32)
        pre, cache = m.prefill(prm, {"tokens": toks[:, :P]}, cache)
        steps = []
        for t in range(P, P + n_dec):
            lt, cache = m.decode_step(prm, cache, toks[:, t:t + 1],
                                      np.full((B,), t))
            steps.append(lt)
        if name == "cuda":
            torch.cuda.synchronize()
            counts = read_counts()
        runs[name] = (fwd, pre, steps)
    (gf, gp, gs), (cf, cp, cs) = runs["cuda"], runs["cpu"]
    errs["forward"] = _logit_err(gf, cf)
    errs["prefill"] = _logit_err(gp, cp)
    errs["decode"] = max(_logit_err(a, b) for a, b in zip(gs, cs))
    for k, e in errs.items():
        if not e <= SMOKE_LOGIT_TOL:
            raise AssertionError(f"model_x_smoke {k}: card vs CPU logits "
                                 f"differ by {e} > {SMOKE_LOGIT_TOL}")
    for name in MODEL_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"model_x_smoke: {name} never launched")
    # the same requests through ServeEngine on both
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(2, 7)))
               for _ in range(6)]
    served = []
    for m, prm in ((gm, gparams), (cm, cparams)):
        eng = ServeEngine(m, prm, max_slots=3, max_len=24)
        done = eng.run([Request(i, p, max_new=5)
                        for i, p in enumerate(prompts)])
        served.append(({r.rid: r.out for r in done}, eng.admitted_total,
                       eng.slot_rejections))
    if served[0] != served[1]:
        raise AssertionError(f"model_x_smoke: ServeEngine tokens differ: "
                             f"card {served[0]} cpu {served[1]}")
    return dict(config=cfg.name, batch=B, seq=S, prefill=P, decode_steps=n_dec,
                max_abs_logit_err=errs, tolerance=SMOKE_LOGIT_TOL,
                served_tokens_identical=True, served=len(served[0][0]),
                launches={k: counts[k] for k in MODEL_KERNELS})


def model_full(seed: int) -> tuple[dict, dict]:
    """recurrentgemma-9b at full width: the float32 kernel route against the
    plain route, then the bfloat16 serving dtype timed."""
    cfg = get_config(FULL_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mk = build_model(cfg, ParallelCtx(compute_dtype=torch.float32))
    dev = mk.device
    params = mk.init(torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(seed)
    S = PATH_S
    toks1 = torch.as_tensor(rng.integers(0, cfg.vocab, (1, S)), device=dev)
    mp = build_model(cfg, ParallelCtx(compute_dtype=torch.float32,
                                      use_kernels=False))
    last = {}
    for name, m in (("kernels", mk), ("plain", mp)):
        cache = m.init_cache(1, S, dtype=torch.float32)
        last[name], cache = m.prefill(params, {"tokens": toks1}, cache)
        del cache
    torch.cuda.synchronize()
    lk, lp = last["kernels"], last["plain"]
    if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
        raise AssertionError("model_full: non-finite float32 logits")
    rms = float(lp.double().pow(2).mean().sqrt())
    err = _logit_err(lk, lp)
    if not err <= FULL_REL_TOL * rms:
        raise AssertionError(f"model_full: float32 kernel vs plain route "
                             f"differ by {err} (logit RMS {rms})")
    del last, lk, lp

    # the serving dtype: bfloat16 compute, kernels on, bfloat16 cache
    mb = build_model(cfg)
    B, n_dec = PATH_B, 16
    toks2 = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)), device=dev)

    def prefill():
        cache = mb.init_cache(B, S + n_dec)
        return mb.prefill(params, {"tokens": toks2}, cache)
    prefill()                                      # warm: cuBLAS, allocator
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logits, cache = prefill()
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts = read_counts()
    want = {"flash_attention": sum(m["kind"] == "local" for m in _metas(mb)),
            "lru_scan": sum(m["kind"] == "rglru" for m in _metas(mb))}
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"model_full: {name} launched "
                                 f"{counts[name]} times per prefill, "
                                 f"expected {n}")
    finite = torch.isfinite(logits).all()
    tok = logits.argmax(-1)[:, None]
    t0 = time.perf_counter()
    for i in range(n_dec):              # next token chosen on the device
        logits, cache = mb.decode_step(params, cache, tok,
                                       torch.full((B,), S + i, device=dev))
        finite &= torch.isfinite(logits).all()
        tok = logits.argmax(-1)[:, None]
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    if not bool(finite):
        raise AssertionError("model_full: non-finite bfloat16 logits")
    peak = torch.cuda.max_memory_allocated()
    del params, cache, logits
    torch.cuda.empty_cache()
    return dict(config=cfg.name, params=n_params, init_s=init_s,
                fp32_check=dict(batch=1, seq=S, max_abs_logit_err=err,
                                logit_rms=rms, rel_err=err / rms,
                                tolerance_rel_to_rms=FULL_REL_TOL,
                                tf32=torch.backends.cuda.matmul.allow_tf32),
                bf16=dict(batch=B, seq=S, prefill_s=prefill_s,
                          prefill_tok_per_s=B * S / prefill_s,
                          decode_steps=n_dec, decode_s=decode_s,
                          decode_tok_per_s=B * n_dec / decode_s),
                launches_per_prefill={k: counts[k] for k in MODEL_KERNELS},
                peak_device_bytes=peak), counts


def _leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _metas(model) -> tuple:
    sm = model.sm
    return sm.metas * sm.n_super + sm.rem_metas


def serve_full(seed: int) -> dict:
    """``repro_torch.launch.serve`` at full width, no --smoke: tenant
    placement on the simulated fleet (scheduler kernels), then 8 requests
    over 4 slots.  The engine prefills by decoding, as the reference does,
    so it reaches neither model kernel."""
    import contextlib
    import io
    args = serve_launch.parse_args(
        ["--arch", FULL_ARCH, "--requests", "8", "--slots", "4",
         "--max-len", "64"])
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        report = serve_launch.run(args)
    counts = read_counts()
    if len(report.done) != args.requests or any(
            len(r.out) != args.max_new for r in report.done):
        raise AssertionError(f"serve_full: {len(report.done)} of "
                             f"{args.requests} requests answered in full")
    for name in ("scan_reduce", "slowdown_same_device"):
        if counts[name] <= 0:
            raise AssertionError(f"serve_full: {name} never launched")
    pct = core.percentiles(report.latencies, (50.0, 99.0))
    torch.cuda.empty_cache()
    return dict(config=FULL_ARCH, requests=len(report.done),
                tokens=report.tokens, seconds=report.seconds,
                tok_per_s=report.tokens / report.seconds,
                p50_latency_s=pct[50.0], p99_latency_s=pct[99.0],
                tokens_decoded=report.tokens_decoded,
                placements=report.placements, launches=counts,
                peak_device_bytes=torch.cuda.max_memory_allocated(),
                driver_output=out.getvalue().splitlines()[:3])


def _traced_session(mult: int, seed: int, activities) -> tuple:
    """(wall s, the finished torch.profiler) of one session traced."""
    from torch.profiler import profile as tprofile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tprofile(activities=activities) as prof:
        run_session(mult, None, seed)
        torch.cuda.synchronize()
    return time.perf_counter() - t0, prof


def _device_busy(mult: int, seed: int,
                 activities) -> tuple[float, float, list, int]:
    """(wall s, device-busy s, top kernels, device ops) of one traced
    session; the device ops are every kernel, copy and fill the trace
    shows on the card."""
    wall, prof = _traced_session(mult, seed, activities)
    rows = prof.key_averages()
    dev_t = [getattr(r, "self_device_time_total", 0.0) for r in rows]
    n_ops = sum(r.count for r, t in zip(rows, dev_t) if t > 0)
    top = sorted(zip(rows, dev_t), key=lambda x: -x[1])
    return wall, sum(dev_t) / 1e6, [
        (r.key[:60], r.count, t / 1e3) for r, t in top[:12]], n_ops


def profile(seed: int, out: str) -> None:
    """Where the time goes: the device's busy share of a mult=8 and of a
    full-width session (kernel durations from torch.profiler; at full
    width over the wall of an untraced run as well, since tracing
    stretches the host's wall), and the host profile of the full-width
    session (cProfile), written under ``out``."""
    import cProfile
    import io
    import pstats
    from torch.profiler import ProfilerActivity
    os.makedirs(out, exist_ok=True)
    run_session(8, None, seed)                         # warm: build, caches
    mult = FULL_MULT
    torch.cuda.synchronize()
    t0 = time.perf_counter()                           # before any tracing
    run_session(mult, None, seed)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    wall, busy, top, n_ops = _device_busy(mult, seed, [ProfilerActivity.CUDA])
    if not busy > 0.0:
        raise AssertionError("the trace shows no device time")
    emit(f"device_busy_x{mult}", dict(
        untraced_wall_s=plain_wall, traced_wall_s=wall, device_busy_s=busy,
        device_ops=n_ops,
        device_busy_share_of_untraced_wall=busy / plain_wall,
        device_busy_share_of_traced_wall=busy / wall, top_device=top))
    wall, busy, top, _ = _device_busy(
        8, seed, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    emit("profile_x8", dict(wall_s=wall, device_busy_s=busy,
                            device_busy_share=busy / wall, top_device=top))
    pr = cProfile.Profile()
    pr.enable()
    _, _, _, _, secs = run_session(mult, None, seed)
    pr.disable()
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats("tottime").print_stats(35)
    path = os.path.join(out, f"host_profile_x{mult}.txt")
    with open(path, "w") as fh:
        fh.write(json.dumps(secs) + "\n" + buf.getvalue())
    emit(f"profile_x{mult}", dict(**secs, written=path))
    print(buf.getvalue()[:6000], flush=True)


def profile_model(seed: int, out: str) -> None:
    """Where the model path's time goes at full width, bf16: the untraced
    wall of one prefill(2, 4096) and of 8 decode steps, then the same work
    under a CUDA-only torch.profiler trace (device time by kernel, device
    kernels launched); the busy share is device time over the untraced
    wall.  Prints one line per phase and writes the tables under ``out``."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    os.makedirs(out, exist_ok=True)
    cfg = get_config(FULL_ARCH)
    m = build_model(cfg)
    params = m.init(torch.Generator(device=m.device).manual_seed(seed))
    rng = np.random.default_rng(seed)
    B, S, n_dec = PATH_B, PATH_S, 8
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)), device=m.device)

    def prefill():
        cache = m.init_cache(B, S + 2 * n_dec)
        return m.prefill(params, {"tokens": toks}, cache)

    def decode(state, start):
        logits, cache = state
        tok = logits.argmax(-1)[:, None]
        for i in range(n_dec):
            logits, cache = m.decode_step(
                params, cache, tok, torch.full((B,), start + i, device=m.device))
            tok = logits.argmax(-1)[:, None]
        return logits, cache

    state = prefill()                                  # warm
    decode(state, S)
    torch.cuda.synchronize()
    walls = {}
    t0 = time.perf_counter()
    state = prefill()
    torch.cuda.synchronize()
    walls["prefill"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    decode(state, S)
    torch.cuda.synchronize()
    walls["decode"] = time.perf_counter() - t0
    for name in ("prefill", "decode"):
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            if name == "prefill":
                state = prefill()
            else:
                decode(state, S + n_dec)
            torch.cuda.synchronize()
        rows = prof.key_averages()
        dev_t = [getattr(r, "self_device_time_total", 0.0) for r in rows]
        busy = sum(dev_t) / 1e6
        n_kern = sum(r.count for r, t in zip(rows, dev_t) if t > 0)
        top = sorted(zip(rows, dev_t), key=lambda x: -x[1])
        path = os.path.join(out, f"model_{name}_kernels.txt")
        with open(path, "w") as fh:
            fh.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=40))
        steps = 1 if name == "prefill" else n_dec
        emit(f"profile_model_{name}", dict(
            batch=B, seq=S, steps=steps, untraced_wall_s=walls[name],
            device_busy_s=busy, device_busy_share=busy / walls[name],
            device_kernels=n_kern, device_kernels_per_step=n_kern / steps,
            top_device=[(r.key[:60], r.count, t / 1e3) for r, t in top[:12]],
            written=path))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="instead of the checks: profile the session (device "
                         "busy share at mult=8 and at full width from "
                         "torch.profiler, host profile at full width) into "
                         "--out; prints no ok line")
    ap.add_argument("--profile-model", action="store_true",
                    help="instead of the checks: profile the model path at "
                         "full width (bf16 prefill and decode: device busy "
                         "share, kernels by device time) into --out; prints "
                         "no ok line")
    ap.add_argument("--out", default="profile_out",
                    help="directory for the profiles' files")
    ap.add_argument("--stop-after", default=None,
                    choices=("kernels", "model_x_smoke", "x8", "x128",
                             "model_full"),
                    help="debugging: end (without the ok line) after a phase")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: "
                         "torch.cuda.is_available() is False")
    # float32 means float32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit("device", dict(nvidia_smi=smi, torch=torch.__version__,
                        cuda=torch.version.cuda,
                        python=sys.version.split()[0]))

    t0 = time.perf_counter()
    build.load()
    info = build.info()
    emit("build", dict(seconds=time.perf_counter() - t0,
                       cached=info.get("cached"), lib=info.get("lib"),
                       nvcc_line=info.get("nvcc_line")))

    if args.profile:
        profile(args.seed, args.out)
        raise SystemExit("profiling run: no result line")
    if args.profile_model:
        profile_model(args.seed, args.out)
        raise SystemExit("profiling run: no result line")
    phases: dict = {}
    mark = [time.perf_counter()]

    def done(phase: str) -> None:
        now = time.perf_counter()
        phases[phase] = now - mark[0]
        mark[0] = now

    def stop(phase: str) -> None:
        if args.stop_after == phase:
            measure_bodies(kernels)
            emit("kernel_bodies", {k["name"]: dict(
                body_ms=k["body_ms"], **{n: o["body_ms"] for n, o in
                                         k.get("other_shapes", {}).items()})
                for k in kernels})
            raise SystemExit(f"stopped after the {phase} phase (debugging)")

    rng = np.random.default_rng(args.seed)
    tables = _sd_tables(dev, rng)
    kernels = [check_slowdown(dev, rng), check_slowdown_pool(dev, rng, tables),
               check_slowdown_same_device(dev, rng, tables),
               check_rate_advance(dev, rng),
               *check_settle(dev, rng), check_segment_min(dev, rng),
               *check_scan_reduce(dev, rng)]
    for k in kernels:
        if not (k["max_rel_err"] <= REL_TOL):
            raise AssertionError(
                f"kernel {k['name']} disagrees with its plain version: "
                f"rel err {k['max_rel_err']}")
        k.setdefault("tolerance",
                     f"decisions exact, floats <= {REL_TOL} relative")
    # B5 and B6 raise inside their checks, against their own tolerances
    kernels += [check_flash(dev, rng), check_lru(dev, rng)]

    done("kernels")
    emit("kernels_checked", {k["name"]: dict(
        max_abs_err=k["max_abs_err"], tolerance=k["tolerance"], ms=k["ms"],
        plain_ms=k["plain_ms"]) for k in kernels})
    stop("kernels")
    emit("model_x_smoke", model_x_smoke(args.seed))
    done("model_x_smoke")
    stop("model_x_smoke")
    emit("session_x8", session_x8(args.seed))
    done("x8")
    stop("x8")
    full, counts = session_full(args.seed)
    emit(f"session_x{FULL_MULT}", full)
    done(f"x{FULL_MULT}")
    stop("x128")
    mfull, mcounts = model_full(args.seed)
    emit("model_full", mfull)
    done("model_full")
    stop("model_full")
    emit("serve_full", serve_full(args.seed))
    done("serve_full")
    # the traces, after every timed phase
    measure_bodies(kernels)
    done("bodies")
    emit(f"session_x{FULL_MULT}_traced", session_traced(args.seed))
    done(f"x{FULL_MULT}_traced")

    # launches: each kernel's count from the run of its own path
    for k in kernels:
        k["launches"] = (mcounts if k["name"] in MODEL_KERNELS
                         else counts)[k["name"]]
    emit("total", dict(seconds=time.perf_counter() - t_start,
                       phases=phases))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
