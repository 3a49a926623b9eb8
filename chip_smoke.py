#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
(one ``nvcc`` per source, all started together) and holds each against
its plain PyTorch version on the card: the scheduler's B1 (slowdown
factors: the row form, the pool form of the DES repricing and the
same-device form of the walk's constraint checks, each at 6 and at 44
resource classes), B2 (rate-advance and its two fused in-place settle
forms, reprice and complete), B3 (segment-min), B3 with B2's transfer
form (the two fused in-place transfer kernels, reprice and complete),
B4 / B4b (the scan-reduce, one scan or a ragged stack, up to the grid
form of a 200000-PU scan) and the model path's flash attention (B5:
bfloat16 on the tensor cores, float32 on the CUDA cores; also at the
model families' shapes: phi-3-vision's hd 96, causal, and whisper's
encoder, unmasked at S = 1500) and LRU scan (B6, fed by TMA).  Each
kernel's row has ``ms`` (CUDA events around back-to-back calls of the
Python wrapper: the launch path included) and ``body_ms``
(the kernel's own device time: every kernel's calls traced in one
torch.profiler session after the last timed phase).
Then it drives the port's paths through their public entry points:

* ``model_x_smoke``: recurrentgemma-9b ``.smoke()`` in float32, weights
  made on the card and copied to a CPU model; forward, prefill, 8
  teacher-forced decode steps and a ``ServeEngine`` run, card (kernels)
  against CPU (plain versions);
* ``vr``: the paper's VR session (its testbed: 5 edges, 3 servers; 30
  frames, 1050 tasks; then the mult=8 fleet, 4 frames), card vs CPU, the
  transfer kernels' path;
* ``x8`` / ``x128``: the offline scheduler session (map -> execute) on the
  Fig. 13 mining fleet at mult=8 (card vs CPU vs the port's own reference
  event loop) and at full width, mult=128 (8448 PUs, 4608 tasks), whose
  every scheduler kernel must have been launched (after ``serve_full``
  the same session runs once more under torch.profiler, for its
  device-op count), then B1's row form on its own path, the traverser's
  what-if query; the full-width map walks group-sharded by default (its
  form is reported), equals the CPU's and, with
  ``REPRO_SHARDED_WALK=0``, the fused walk's bit for bit; a mixed-origin
  wave (a task from every device) takes the sharded driver's threaded
  branch, against the fused walk and the CPU;
* ``walk_oracle``: the object walk on the card (``REPRO_FUSED_WALK=0``)
  against the fused walk at mult=8 and on the paper's VR testbed; the
  ``first_fit`` objective, the ground-truth traverser as the policy's
  traverser, a noisy slowdown model and a tuple-surface one (B1's row
  form), each card vs CPU;
* ``serve_x64``: the online path — ``ServeLoop`` over one
  session-resident timeline with admission control, the reference's
  ``benchmarks/serve.py::_serve_once(64)`` (the mining fleet at mult=64,
  4224 PUs; Poisson ``svm`` and diurnal ``mlp`` tenants, ~1.1k requests),
  card vs CPU request for request, over the session-resident walk
  context; then the card once more with ``REPRO_SERVE_FASTPATH=0``;
* ``serve_churn``: the same loop at mult=8 under a seeded wireless churn
  schedule (a ``Churn`` wave every horizon/8) and an edge's death and
  revival, card vs CPU, every batch absorbed as one snapshot delta;
* ``bwchurn_x128``: ``benchmarks/des.py::_bwchurn(128)``, eight
  bandwidth waves each followed by a mapping wave of 576 tasks, card vs
  CPU placements, no rebuild and no topology-layer copy;
* ``model_full``: recurrentgemma-9b at full width (38 layers, d=4096,
  ~8.5 B float32 parameters from a seeded generator): prefill(1, 4096) in
  float32 through the kernels against the plain route, then prefill(2,
  4096) + 16 decode steps in bfloat16, timed;
* ``model_families``: granite-moe-1b-a400m (MoE), rwkv6-1.6b (RWKV6),
  whisper-large-v3 (encoder-decoder: 1500 frames, a 448-token prompt)
  and phi-3-vision-4.2b (hd 96, 576 patch positions) at full width and
  depth, one after the other, each freed before the next: prefill(1, S)
  in float32 through the kernels against the plain route, then
  prefill(2, S) + 16 decode steps in bfloat16, timed, with B5 launched
  once per attention layer (24, 0, 32 + 32, 32);
* ``serve_full``: ``repro_torch.launch.serve`` at full width (tenant
  placement on the simulated TPU fleet, then 8 requests over 4 slots);
* ``train_smoke``: three train steps (the second over two microbatches)
  of gemma3-1b and granite-moe-1b-a400m ``.smoke()`` in float32, card
  against CPU from the same weights (made on the CPU, copied);
* ``train_full``: ``repro_torch.launch.train`` on gemma3-1b at full width
  and depth (~1.0 B float32 parameters, bf16 compute): 20 steps of batch
  4 x 1024 tokens through ``launch/train.py``'s data, prefetch, step and FT
  manager, whose checkpoint of the whole state at step 20 is restored and
  compared bit for bit; one step more under ``remat="block"`` against
  ``"none"``; the AdamW update timed alone; the kernel wrappers' refusal
  of a tensor that requires grad.  Training takes the plain route, as
  the reference's does: B5 and B6 must launch 0 times.  ``launch.train``
  runs its step on the card's mesh of one ((1, 1), NCCL) as DTensors;
* ``placement``: the placement search (``core/placement.py``) for every
  config x shape on both production meshes, on the host;
* ``train_mesh``: ``repro_torch.launch.train`` on gemma3-1b at full width
  on the (1, 1) mesh, 10 steps of 4 x 1024, each step's loss against the
  same steps on plain tensors (1e-6 relative), with both median step
  times;
* ``dryrun``: ``python -m repro_torch.launch.dryrun`` on three cells
  (gemma3-1b train_4k on the (16, 16) mesh, granite-moe-1b-a400m
  decode_32k and rwkv6-1.6b prefill_32k on (2, 16, 16)), each in a
  process of its own on a fake process group: each must end ok with its
  counted FLOPs at least the model FLOPs (a prefill's less the unembedding
  it skips) and its peak at most 4x the reference's own dry run of the
  cell (``tests/data/torch_dryrun_reference.json``); the port /
  reference ratios of peak, FLOPs and collective bytes are printed.

The phases run in the order kernels, ``model_x_smoke``, ``x8``,
``walk_oracle``, ``vr``,
``x128``, ``serve_x64``, ``serve_churn``, ``bwchurn_x128``,
``model_full``, ``model_families``, ``serve_full``, ``train_smoke``,
``train_full``, ``placement``, ``train_mesh``, ``dryrun``.
``--compare PARENT --session
vr|x128`` instead runs a session of the tree at PARENT and of this one in
turns, each in a fresh process; ``--session flash`` there times B5's rows
(``ms``, ``body_ms``, SDPA's ``library_ms``) and the bf16 prefill of the
families that run B5, per tree.  One JSON object per line; the last line
is ``{"ok": true, "device": {...}}``.  Any failing phase raises, and the
script exits non-zero without printing a result.  Without a CUDA device
it fails at once: there is no CPU path.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import gc
import math
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# the port this process imports: this checkout's, or in a turn of
# --compare the one of the tree that --tree names
TREE = (os.path.abspath(sys.argv[sys.argv.index("--tree") + 1])
        if "--tree" in sys.argv[:-1] else HERE)
sys.path.insert(0, os.path.join(TREE, "src"))

import numpy as np          # noqa: E402
import torch                # noqa: E402

import repro_torch.core as core                              # noqa: E402
import repro_torch.core.orchestrator as orc_mod              # noqa: E402
import repro_torch.core.slowdown as sd_mod                   # noqa: E402
import repro_torch.launch.serve as serve_launch              # noqa: E402
from repro_torch import device as rt_device                  # noqa: E402
from repro_torch.configs import get_config, shapes           # noqa: E402
from repro_torch.configs import SHAPES, all_configs          # noqa: E402
import repro_torch.core.placement as placement_mod           # noqa: E402
from repro_torch.core.workloads import (mining_workload,     # noqa: E402
                                         vr_workload)
from repro_torch.kernels import (build, slowdown_kernel,     # noqa: E402
                                 timeline_kernel, walk_kernel)
from repro_torch.kernels import flash_attention as fa_kernel  # noqa: E402
from repro_torch.kernels import lru_scan as lru_kernel       # noqa: E402
from repro_torch.models import ParallelCtx, build_model      # noqa: E402
from repro_torch.models.transformer import (ATTN_KINDS,      # noqa: E402
                                            tree_map)
from repro_torch.serve.engine import Request, ServeEngine    # noqa: E402
import repro_torch.checkpoint as train_ckpt                  # noqa: E402
import repro_torch.data.pipeline as train_data               # noqa: E402
import repro_torch.launch.train as train_launch              # noqa: E402
import repro_torch.optim as train_optim                      # noqa: E402
import repro_torch.train.step as train_step                  # noqa: E402
from repro_torch import tree as train_tree                   # noqa: E402

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
# rounding on the CPU (tests/test_torch_model_kernels.py) lands at 0.54-0.63
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
    ``per_call`` kernels whose traced names hold ``kernel``, traced by
    :func:`measure_bodies` after the last timed phase (a torch.profiler
    trace can leave later launches of its process slower, so no phase is
    timed after one); the body is their device time per call."""

    def __init__(self, fn, kernel: str, iters: int, per_call: int) -> None:
        self.fn, self.kernel, self.iters = fn, kernel, iters
        self.per_call = per_call


def body_ms(fn, kernel: str, iters: int = 200, per_call: int = 1) -> _Body:
    return _Body(fn, kernel, iters, per_call)


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
        if len(durs) < b.iters * b.per_call // 2:
            raise AssertionError(f"the trace shows {len(durs)} launches of "
                                 f"{b.kernel} for {b.iters} calls")
        d["body_ms"] = sum(durs) * b.per_call / len(durs) / 1e6


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
    # more classes than the kernel's registers hold: the row read in place
    r = WIDE_R
    x = rng.uniform(0.0, 3.0, (n, r))
    x[rng.random((n, r)) < 0.5] = 0.0
    wide = [torch.as_tensor(a, device=dev) for a in (
        x, _wide_beta(rng), rng.uniform(0.05, 1.0, n), rng.uniform(0.0, 2.0, n))]
    got = slowdown_kernel.slowdown_factors(*wide, kappa)
    ref = slowdown_kernel.slowdown_factors_plain(*wide, kappa)
    torch.cuda.synchronize()
    if not _bit_equal(got, ref):
        raise AssertionError(f"slowdown_factors N={n} R={r} is not "
                             "bit-equal to its plain version")
    wide_shape = dict(
        ms=time_ms(lambda: slowdown_kernel.slowdown_factors(*wide, kappa)),
        body_ms=body_ms(lambda: slowdown_kernel.slowdown_factors(*wide, kappa),
                        "slowdown_factors_kernel"),
        plain_ms=time_ms(lambda: slowdown_kernel.slowdown_factors_plain(
            *wide, kappa), 50, 5),
        **bound(8 * (n * r + r + 3 * n), n * (r * 6 + 2)))
    return dict(name="slowdown_factors", route="cuda",
                source="src/repro_torch/kernels/csrc/slowdown_factors.cu",
                replaces="src/repro/kernels/slowdown_kernel.py:47",
                shape=f"N={n} R=6", max_abs_err=0.0, max_rel_err=0.0,
                tolerance="bit-equal", ms=ms, body_ms=body, plain_ms=plain,
                **bound(nbytes, flops), library_ms=None,
                other_shapes={f"N={n} R={WIDE_R}": wide_shape})


# the snapshot's size at mult=128: 8448 PUs, 6 resource classes; WIDE_R
# classes: the paper's testbed with one class per storage node, past the
# 16 a kernel keeps in registers
SD_PUS, SD_R = 8448, 6
WIDE_R = 44
SD_KAPPA = 0.12


def _wide_beta(rng) -> np.ndarray:
    b = rng.uniform(0.05, 0.45, WIDE_R)
    b[::7] = 0.0
    return b


def _sd_tables(dev, rng, R: int = SD_R) -> tuple:
    """Snapshot tables at mult=128's size: ``ncr_rclass`` (int16, classes
    -1..R-1 drawn at random), ``mem_cap`` (inf, some PUs capped),
    ``mt_vec``, ``beta`` (some classes inactive)."""
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    ncr = torch.randint(-1, R, (SD_PUS, SD_PUS), generator=g, device=dev,
                        dtype=torch.int16)
    cap = np.full(SD_PUS, np.inf)
    cap[rng.random(SD_PUS) < 0.2] = 0.3
    mt_vec = rng.uniform(0.2, 0.5, SD_PUS)
    beta = (np.array([0.0884, 0.1330, 0.1107, 0.1786, 0.4196, 0.0])
            if R == SD_R else _wide_beta(rng))
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
    R = args[8].shape[0]
    return 56 * n + 2 * (u * u - u) + 8 * R + 8 * n, n * n + 40 * n


def check_slowdown_pool(dev, rng, tables, wide_tables) -> dict:
    """The pool form (the DES repricing) against its plain version, bit for
    bit, at n = 2, 8, 384, 4608 members, in both modes (distinct members,
    uid-masked), PU ties included, a NaN usage at n=384, on the 6-class
    and the 44-class table; timed at 8 (with 384 and 4608 beside, and 8
    and 4608 at 44 classes)."""
    for tabs in (tables, wide_tables):
        for n in (2, 8, 384, 4608):
            for args in _pool_case(dev, rng, n, tabs, nan=n == 384):
                got = slowdown_kernel.slowdown_pool(*args)
                ref = slowdown_kernel.slowdown_pool_plain(*args)
                torch.cuda.synchronize()
                if not _bit_equal(got, ref):
                    raise AssertionError(
                        f"slowdown_pool n={n} R={args[8].shape[0]} distinct="
                        f"{args[-1]} is not bit-equal to its plain version")
    shapes = {}
    for n, plain_iters, tabs in ((8, 50, tables), (384, 10, tables),
                                 (4608, 2, tables), ("R=44 n=8", 50, wide_tables),
                                 ("R=44 n=4608", 2, wide_tables)):
        args = _pool_case(dev, rng, n if isinstance(n, int)
                          else int(n.split("=")[-1]), tabs)[0]

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
                    (f"n={n}" if isinstance(n, int) else n): shapes[n]
                    for n in (384, 4608, "R=44 n=8", "R=44 n=4608")})


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


def check_slowdown_same_device(dev, rng, tables, wide_tables) -> dict:
    """The same-device form (the walk's constraint checks) against its
    plain version, bit for bit, on ragged stacks over views of A = 2, 8,
    384 and 4608 actives (single- and several-device items, an empty
    device, a candidate with no same-device active, a dead pair), on the
    6-class and the 44-class table; timed on a wave-depth stack of 16
    single-device items over 8-active device views, and on the
    several-device stack at A=4608 (and the wave at 44 classes)."""
    ncr, cap, mt_vec, beta = tables
    tail = (mt_vec, beta, cap, ncr, SD_KAPPA)
    wncr, wcap, wmt_vec, wbeta = wide_tables
    wide_tail = (wmt_vec, wbeta, wcap, wncr, SD_KAPPA)
    for tl in (tail, wide_tail):
        for A in (2, 8, 384, 4608):
            items, _ = _sd_stack(dev, rng, A)
            got = slowdown_kernel.slowdown_same_device(items, *tl)
            ref = slowdown_kernel.slowdown_same_device_plain(items, *tl)
            torch.cuda.synchronize()
            for i, (g, r) in enumerate(zip(got, ref)):
                if not all(_bit_equal(a, b) for a, b in zip(g, r)):
                    raise AssertionError(
                        f"slowdown_same_device A={A} R={tl[1].shape[0]} "
                        f"item {i} is not bit-equal to its plain version")
    wave = [_sd_stack(dev, rng, 8)[0][0] for _ in range(16)]
    big = _sd_stack(dev, rng, 4608)[0][2:]
    shapes = {}
    for label, items, plain_iters, tl in (
            ("wave", wave, 20, tail), ("big", big, 2, tail),
            ("wide", wave, 20, wide_tail)):
        def fn(items=items, tail=tl):
            return slowdown_kernel.slowdown_same_device(items, *tail)

        def plain_fn(items=items, tail=tl):
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
                    "3 several-device items over 4608 actives": shapes["big"],
                    f"the wave at R={WIDE_R}": shapes["wide"]})


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


# the transfer table: 8192 slots (the VR session's transfers, grown by
# doubling), 64 edges; a flush reprices 1 to 4608 of them
XFER_SLOTS, XFER_EDGES = 8192, 64
XTOL = 1e-6


def _xfer_state(rng):
    """Transfer columns (xW, xrate, xt_last, xeta, xstamp), CSR rows
    (xe_flat, xe_start, xe_cnt: routes of 0-6 edges, starts offset), the
    edge table (edge_bw with zero-bandwidth edges and a NaN one, edge_mem)
    and the new counts of some edges: numpy arrays."""
    cnt = rng.integers(0, 7, XFER_SLOTS)
    cnt[::50] = 0
    start = np.cumsum(cnt) - cnt + 5
    flat = rng.integers(0, XFER_EDGES, int(cnt.sum()) + 5)
    bw = rng.uniform(1e6, 1e9, XFER_EDGES)
    bw[::9] = 0.0
    bw[4] = np.nan
    mem = rng.integers(0, 6, XFER_EDGES)
    W = rng.uniform(0.0, 5e6, XFER_SLOTS)
    W[::4] = 0.0
    rate = rng.uniform(1e5, 1e8, XFER_SLOTS)
    rate[::7] = 0.0
    t_last = rng.uniform(0.0, 1.0, XFER_SLOTS)
    rate[1::97] = np.inf
    t_last[1::97] = 1.5
    cols = [W, rate, t_last, rng.uniform(0.0, 9.0, XFER_SLOTS),
            rng.integers(0, 1000, XFER_SLOTS) // 3]
    return cols, [flat, start, cnt], bw, mem


def _xfer_calls(dev, rng, n):
    """The two fused transfer forms over n distinct slots and their plain
    versions, each on a copy of one state: (reprice, reprice plain,
    complete, complete plain, the copies, the route shares' layout)."""
    cols, csr, bw, mem = _xfer_state(rng)
    ks = np.sort(rng.permutation(XFER_SLOTS)[:n])
    upd = np.sort(rng.permutation(XFER_EDGES)[:int(rng.integers(0, 9))])
    upd_c = rng.integers(0, 6, len(upd))
    cuda = [torch.as_tensor(a, device=dev) for a in (*cols, *csr, bw, mem)]
    ks_t, upd_t, updc_t = (torch.as_tensor(a, device=dev)
                           for a in (ks, upd, upd_c))
    done = ks_t[torch.argsort(cuda[4][ks_t], stable=True)]
    rk, rp, ck, cp = ([c.clone() for c in cuda] for _ in range(4))
    tk = timeline_kernel
    new_mem = mem.copy()
    new_mem[upd] = upd_c
    return (lambda: tk.transfer_reprice(*rk, ks_t, upd_t, updc_t, 1.5, 77),
            lambda: tk.transfer_reprice_plain(*rp, ks_t, upd_t, updc_t, 1.5,
                                              77),
            lambda: tk.transfer_complete(*ck[:4], done, 1.5, XTOL),
            lambda: tk.transfer_complete_plain(*cp[:4], done, 1.5, XTOL),
            (rk, rp, ck, cp), (csr, bw, new_mem, ks, len(upd)))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def _route_entries(layout) -> np.ndarray:
    """The route edges of the affected transfers, in slot order."""
    (flat, start, cnt), _, _, ks, _ = layout
    return np.concatenate([flat[start[k]:start[k] + cnt[k]] for k in ks])


def check_transfer(dev, rng) -> list[dict]:
    """B3 with B2's transfer form: the two fused in-place transfer kernels
    against their plain versions (the unfused op sequence), bit for bit
    (every column, the edge column and the completion pairs), at n = 1,
    16, 384 and 4608 affected transfers, routes of 0-6 edges, zero- and
    NaN-bandwidth edges, zero and infinite old rates, stamp ties; timed
    at 16 (with 384 and 4608 beside).  ``library_ms``: torch.segment_reduce
    over the same route shares laid out contiguously, the segment-min
    part alone."""
    for n in (1, 16, 384, 4608):
        rk, rp, ck, cp, (a, b, c, d), _ = _xfer_calls(dev, rng, n)
        rk()
        rp()
        pk = ck()
        pp = cp()
        torch.cuda.synchronize()
        for name, got, ref in (("transfer_reprice", a, b),
                               ("transfer_complete", c[:4] + [pk],
                                d[:4] + [pp])):
            if not all(torch.equal(_bits(x), _bits(y))
                       for x, y in zip(got, ref)):
                raise AssertionError(f"{name} at n={n} is not bit-equal to "
                                     "its plain version")
    out = []
    for name, idx in (("transfer_reprice", 0), ("transfer_complete", 2)):
        shapes = {}
        for n in (16, 384, 4608):
            calls = _xfer_calls(dev, rng, n)
            kern, plain_fn = calls[idx], calls[idx + 1]
            (_, _, cnt), bw, mem, ks, u = calls[5]
            entries = _route_entries(calls[5])
            if idx == 0:
                # per transfer its slot, CSR row, the settle columns read
                # and written, rate, eta and stamp written (88 bytes); 8 per
                # route entry, 16 per distinct edge read, 24 per changed
                # count; a division and a compare per entry
                cost = bound(88 * n + 8 * len(entries)
                             + 16 * len(np.unique(entries)) + 24 * u,
                             3 * len(entries) + 8 * n)
                # the yardstick: the segment-min of the same shares
                shares = torch.as_tensor(
                    bw[entries] / np.maximum(mem[entries], 1), device=dev)
                lengths = torch.as_tensor(cnt[ks], device=dev)
                cost["library_ms"] = time_ms(
                    lambda: torch.segment_reduce(shares, "min",
                                                 lengths=lengths,
                                                 initial=float("inf")))
            else:
                # per transfer its slot, the settle columns, eta and its
                # pair (72 bytes)
                cost = dict(bound(72 * n, 5 * n), library_ms=None)
            shapes[n] = dict(
                ms=time_ms(kern), body_ms=body_ms(kern, f"{name}_kernel"),
                plain_ms=time_ms(plain_fn, 50, 5), **cost)
        out.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/transfer.cu",
            replaces=("src/repro/kernels/timeline_kernel.py:109 and :59 "
                      "(segment_min_pallas and rate_advance_pallas at the "
                      "transfer reprice, src/repro/core/timeline.py _flush)"
                      if idx == 0 else
                      "src/repro/kernels/timeline_kernel.py:59 "
                      "(rate_advance_pallas at the transfer completions, "
                      "src/repro/core/timeline.py _complete_transfers)"),
            shape="N=16 affected transfers", max_abs_err=0.0,
            max_rel_err=0.0, tolerance="bit-equal", **shapes[16],
            library_call=("torch.segment_reduce (min), the segment-min part"
                          if idx == 0 else "none exists"),
            other_shapes={f"N={n}": shapes[n] for n in (384, 4608)}))
    return out


LQC = 5e-6                  # the walk's local query cost
# a root scan past one block (the mining fleet at mult ~3030): 40000
# device nodes of 5 PUs; its overhead held to the bound the block form
# showed against the plain version (6e-14 relative), here against the
# exactly rounded sum
GRID_SCAN = (40000, 5)
GRID_REL_TOL = 6e-14


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
    return _stack_of(dev, [_scan_case(rng, nd, pd, modes[i % len(modes)])
                           for i, (nd, pd) in enumerate(shapes)])


def _exact_overhead(case) -> float:
    """The exactly rounded sum of one scan's feasible node terms (each
    term rounded as the kernel and the plain version round it), 0 when
    its root is infeasible."""
    (ok, *_), (lo, hi, leaf, _, hop, dep) = case
    P = len(ok)
    cs = np.concatenate([[0], np.cumsum(ok)])
    feas = cs[np.minimum(hi, P)] > cs[np.minimum(lo, P)]
    if not feas[0]:
        return 0.0
    terms = np.asarray(hop) + LQC * np.asarray(leaf, dtype=np.float64) \
        * (np.asarray(dep) + 1.0)
    return math.fsum(terms[feas])


def _stack_of(dev, cases):
    """:func:`_scan_stack` of given numpy cases."""
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
    # past one block's 131072 PUs: the grid form, alone and in a stack.
    # Decisions and gathered columns exact against the plain version, the
    # overhead within REL_TOL of the plain version's (the rows' worst) and
    # within GRID_REL_TOL of the exactly rounded sum of its feasible terms
    # (the plain version's own sum of 40000 equal terms drifts further
    # from it)
    grid_err = {"kernel": 0.0, "plain": 0.0}

    def exact_err(val, case):
        ex = _exact_overhead(case)
        return abs(val - ex) / abs(ex) if ex else abs(val)
    cases = [_scan_case(rng, *GRID_SCAN, mode) for mode in modes]
    for case, mode in zip(cases, modes):
        args = [torch.as_tensor(c, device=dev) for c in case[0]]
        arr = walk_kernel.ScanPlanArrays.from_lists(*case[1], dev)
        got = walk_kernel.scan_reduce(*args, arr, LQC)
        ref = _one_scan_plain(args, arr)
        torch.cuda.synchronize()
        e = _rows_agree(got, ref, f"scan_reduce P={len(case[0][0])} {mode}")
        worst = (max(worst[0], e[0]), max(worst[1], e[1]))
        grid_err["kernel"] = max(grid_err["kernel"],
                                 exact_err(float(got[3]), case))
        grid_err["plain"] = max(grid_err["plain"],
                                exact_err(float(ref[3]), case))
    stack = [_scan_case(rng, 1, 6, "plain"), cases[0],
             _scan_case(rng, 1, 1, "ties"), _scan_case(rng, 24, 6, "allinf"),
             cases[1]]
    cols, arr, offs = _stack_of(dev, stack)
    got = walk_kernel.scan_reduce_batch(*cols, arr, offs, LQC)
    ref = walk_kernel.scan_reduce_batch_plain(
        *cols, *arr.tensors(), torch.as_tensor(offs, dtype=torch.int64,
                                               device=dev), LQC)
    torch.cuda.synchronize()
    e = _rows_agree(got, ref, "scan_reduce_batch with grid-form scans")
    bworst = (max(bworst[0], e[0]), max(bworst[1], e[1]))
    for i, case in enumerate(stack):
        grid_err["kernel"] = max(grid_err["kernel"],
                                 exact_err(float(got[i, 3]), case))
        grid_err["plain"] = max(grid_err["plain"],
                                exact_err(float(ref[i, 3]), case))
    if not grid_err["kernel"] <= GRID_REL_TOL:
        raise AssertionError(f"grid-form overhead {grid_err['kernel']} "
                             f"relative to the exact sum, over {GRID_REL_TOL}")
    single = {}
    for label, n_dev, per_dev in (("P=6", 1, 6), ("P=8448", 1408, 6),
                                  (f"P={GRID_SCAN[0] * GRID_SCAN[1]}",
                                   *GRID_SCAN)):
        cols, plan = _scan_case(rng, n_dev, per_dev, "plain")
        args = [torch.as_tensor(c, device=dev) for c in cols]
        arr = walk_kernel.ScanPlanArrays.from_lists(*plan, dev)
        P, Nn = len(cols[0]), arr.n

        def fn(args=args, arr=arr):
            return walk_kernel.scan_reduce(*args, arr, LQC)

        def plain_fn(args=args, arr=arr):
            return _one_scan_plain(args, arr)
        grid = P > walk_kernel.BLOCK_MAX_P
        single[label] = dict(
            ms=time_ms(fn, 50 if grid else 200),
            body_ms=(body_ms(fn, "big_", 50, per_call=4) if grid else
                     body_ms(fn, "scan_reduce_batch_kernel")),
            plain_ms=time_ms(plain_fn, 10 if grid else 50, 2 if grid else 5),
            **bound(_scan_bytes(P, Nn, plain_fn(), False), 2 * P + 6 * Nn))
    grid_label = f"P={GRID_SCAN[0] * GRID_SCAN[1]}"
    single[grid_label]["form"] = "grid (four launches)"
    rows = [dict(
        name="scan_reduce", route="cuda",
        source="src/repro_torch/kernels/csrc/scan_reduce.cu",
        replaces="src/repro/kernels/walk_kernel.py:150",
        shape="P=6 (device scan), a stack of one", max_abs_err=worst[0],
        max_rel_err=worst[1],
        grid_form_overhead_rel_err_to_exact_sum=grid_err["kernel"],
        grid_form_tolerance=GRID_REL_TOL,
        plain_overhead_rel_err_to_exact_sum=grid_err["plain"],
        **single["P=6"], library_ms=None,
        other_shapes={"P=8448": single["P=8448"],
                      grid_label: single[grid_label]})]
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


# a fused re-walk's segment on the main path (mining-paper.batch's
# re-walks: 3 candidates on a device of 6 PUs against 6 actives at the
# median and 11 at the most, 6 classes)
REWALK_N, REWALK_C, REWALK_A = 6, 3, (6, 11)


def _rewalk_bytes(seg, R: int) -> int:
    """Bytes one fused re-walk must move: each input read once (the
    candidates' five columns, the signature's two, the device's eight
    ledger columns and its segment's start and length, the class table
    over every (candidate or active, active) pair, mt-beta and the memory
    cap of each candidate's and active's PU, beta, the plan's six node
    columns, ``ok`` and ``key`` off the segment, the winner's three
    columns) and each output written once (the scan state's four columns
    and the effective three over the segment, the nine values)."""
    C, C2, A = seg.Pc.shape[0], seg.eff_cols.shape[0], seg.Pa.shape[0]
    n, P = seg.nseg, seg.ok.shape[0]
    rd = (40 * C + 16 * C2 + 64 * A + 16 + 2 * (C * A + A * A)
          + 16 * (C + A) + 8 * R + 48 * seg.plan.n + 9 * (P - n) + 24)
    return rd + 42 * n + 72


def check_rewalk_entry(dev) -> dict:
    """The fused re-walk (``rewalk_entry``: B1's same-device check, the
    constraint terms, the splice, the effective layer and B4's reduce in
    one launch) against its plain version on the card, which is the
    two-step path it replaces (B1's and B4's kernels with PyTorch between
    them): its nine values and every column it rewrites, as bit patterns.
    Every case of ``tests/rewalk_cases.py`` on four seeds, then the main
    path's segment (``REWALK_*``) in the cases a re-walk meets, at 44
    classes (the strided scratch) and on a device of 40 PUs (the block
    scan).  Timed at the main path's median segment, each call with its
    read."""
    sys.path.insert(1, os.path.join(HERE, "tests"))
    import rewalk_cases as rc
    segs = [rc.segment(dev, case, seed) for case in rc.CASES
            for seed in range(4)]
    path = dict(n=REWALK_N, C=REWALK_C)
    for A in REWALK_A:
        segs += [rc.segment(dev, case, seed, A=A, **path)
                 for case in ("plain", "capped", "inf_deadlines",
                              "infeasible", "self", "offset", "wide")
                 for seed in range(4)]
    segs += [rc.segment(dev, "block", seed, n=40, C=REWALK_C,
                        A=REWALK_A[1]) for seed in range(4)]
    for i, (seg, tables) in enumerate(segs):
        ref = rc.copy_of(seg)
        got = walk_kernel.rewalk_entry(seg, *tables)
        want = rt_device.host_list(walk_kernel.rewalk_entry_plain(ref,
                                                                  *tables))
        what = (f"rewalk_entry segment {i} (C={seg.Pc.shape[0]} "
                f"A={seg.Pa.shape[0]} P={seg.ok.shape[0]} "
                f"R={tables[1].shape[0]})")
        if not (rc.bits(got) == rc.bits(want)).all():
            raise AssertionError(f"{what}: {got} vs its plain version's "
                                 f"{want} (bit-equal expected)")
        for name in rc.MUTABLE:
            a, b = getattr(seg, name), getattr(ref, name)
            same = (torch.equal(a, b) if a.dtype == torch.bool
                    else bool((rc.bits(a) == rc.bits(b)).all()))
            if not same:
                raise AssertionError(f"{what}: column {name} differs from "
                                     "its plain version's")
    seg, tables = rc.segment(dev, "plain", 0, A=REWALK_A[0], **path)
    R = tables[1].shape[0]
    C, A = seg.Pc.shape[0], seg.Pa.shape[0]

    def fn():
        return walk_kernel.rewalk_entry(seg, *tables)

    def plain_fn():
        return rt_device.host_list(walk_kernel.rewalk_entry_plain(seg,
                                                                  *tables))
    return dict(
        name="rewalk_entry", route="cuda",
        source="src/repro_torch/kernels/csrc/rewalk.cu",
        replaces="none: the reference re-walks through B1's same-device "
                 "form and B4 (src/repro/core/orchestrator.py:1421 "
                 "_tracked_checks, :1483 _effective, :1543 _scan_reduce)",
        shape=f"C={C} A={A} P={seg.ok.shape[0]} R={R}, a mining re-walk's "
              "median segment, each call with its read",
        segments_compared=len(segs), max_abs_err=0.0, max_rel_err=0.0,
        tolerance="bit-equal: the nine values and the rewritten columns",
        ms=time_ms(fn), body_ms=body_ms(fn, "rewalk_entry_kernel"),
        plain_ms=time_ms(plain_fn, 50, 5),
        **bound(_rewalk_bytes(seg, R), (C + C * A) * (5 * R + 4)),
        library_ms=None)


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


def flash_edge_cases() -> list:
    """B5's cases at the edges of the bf16 kernel's tiles at hd 64 and 96
    (:data:`fa_kernel.BF16_TILES`): S one below, one above and one above
    twice a kv tile, windows one key either side of a kv tile, GQA 2:1 at
    an S no tile divides, hd 96 unmasked at such an S."""
    bk = fa_kernel.BF16_TILES[64][1]
    bq = fa_kernel.BF16_TILES[64][0]
    return [
        # (B, S, Hq, Hkv, hd, kwargs, logit scale)
        (1, bk - 1, 4, 2, 64, {}, 1.0),
        (1, bk + 1, 4, 2, 64, {}, 1.0),
        (2, 2 * bk + 1, 4, 4, 64, {}, 1.0),
        (1, 2 * bq + 1, 4, 4, 64, {"causal": False}, 1.0),
        (1, 4 * bk + 3, 4, 2, 64, {"window": bk - 1}, 1.0),
        (1, 4 * bk + 3, 4, 2, 64, {"window": bk + 1}, 1.0),
        (2, 3 * bk + 5, 8, 4, 64, {}, 1.0),
        (1, fa_kernel.BF16_TILES[96][1] * 2 + 37, 4, 4, 96,
         {"causal": False}, 1.0),
    ]


def check_flash(dev, rng) -> dict:
    """B5 on the card against its plain version: MHA / GQA / MQA, hd 16 to
    256 (96 among them: three 32-column boxes), causal only, windows
    (shorter than a kv tile, S > window), softcap, x100 logits,
    non-causal, S below one tile and S that no tile divides, and the
    tile edges of :func:`flash_edge_cases`; float32 (the CUDA-core
    kernel) and bfloat16 (the tensor-core kernel).  The library's own
    tile table must equal the wrapper's (``BF16_TILES``).
    SDPA's own distance from the plain version is taken on the same bf16
    inputs, where it computes the same function (no softcap)."""
    tiles = {hd: fa_kernel.kernel_tiles(hd) for hd in fa_kernel.KERNEL_HEAD_DIMS}
    if tiles != fa_kernel.BF16_TILES:
        raise AssertionError(f"the library's bf16 tiles {tiles} differ from "
                             f"the wrapper's {fa_kernel.BF16_TILES}")
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
        (1, 333, 4, 2, 96, {}, 1.0),
        (1, 512, 4, 4, 96, {"window": 100, "softcap": 30.0}, 1.0),
        (2, 300, 4, 4, 96, {"causal": False}, 1.0),
        (1, 256, 2, 2, 96, {}, 100.0),
        *flash_edge_cases(),
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
    # the path's shape
    row = flash_row(dev, rng, "flash_attention", PATH_B, PATH_S, 16, 1, 256,
                    window=2048)
    for name in worst:
        worst[name] = max(worst[name], row["max_abs_err_by_dtype"][name])
        worst_ratio[name] = max(worst_ratio[name],
                                row["err_over_tolerance_by_dtype"][name])
    sdpa_ratio = max(sdpa_ratio, row.pop("library_err_over_tolerance"))
    row.update(max_abs_err=max(worst.values()), max_abs_err_by_dtype=worst,
               err_over_tolerance_by_dtype=worst_ratio,
               sdpa_worst_err_over_tolerance=sdpa_ratio,
               bf16_tiles={str(hd): t for hd, t in tiles.items()},
               tolerance=(f"float32 {ATTN_F32_TOL} abs ({ATTN_X100_TOL} at "
                          f"x100 logits); bfloat16 {fa_kernel.BF16_REL}*"
                          f"|plain| + {fa_kernel.BF16_ROW}*rms(plain row)"))
    return row


def flash_row(dev, rng, name, B, S, Hq, Hkv, hd, causal=True, window=None,
              softcap=None, **extra) -> dict:
    """B5's kernel row at one shape: float32 (the CUDA-core kernel, 1e-4)
    and bfloat16 (the tensor-core kernel, ``bf16_allowed``) against the
    plain version, then the bf16 call timed beside the plain version and
    SDPA (kv heads expanded outside the timed call, a boolean mask only
    where there is a window); ``bound_ms`` from the live (q, k) pairs of
    this mask.  ``extra`` goes into the row."""
    kw = dict(causal=causal, window=window, softcap=softcap)
    worst, ratios = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _attn_inputs(dev, rng, B, S, Hq, Hkv, hd, dtype)
        got = fa_kernel.flash_attention(q, k, v, **kw)
        ref = fa_kernel.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        if got.dtype != dtype or not torch.isfinite(got).all():
            raise AssertionError(f"{name} {dtype}: wrong dtype or non-finite "
                                 "output")
        e, ratio = _attn_err(got, ref, dtype, ATTN_F32_TOL)
        if not ratio <= 1.0:
            raise AssertionError(f"{name} {dtype} B={B} S={S} Hq={Hq} "
                                 f"Hkv={Hkv} hd={hd} {kw}: max err {e} over "
                                 "its tolerance")
        dname = str(dtype).split(".")[-1]
        worst[dname], ratios[dname] = e, ratio
        del got
    # q, k, v and ref are the bf16 ones now: the serving dtype is timed
    ms = time_ms(lambda: fa_kernel.flash_attention(q, k, v, **kw), 20, 3)
    body = body_ms(lambda: fa_kernel.flash_attention(q, k, v, **kw),
                   "flash_attention_tc_kernel", 20)
    plain = time_ms(lambda: fa_kernel.flash_attention_plain(q, k, v, **kw),
                    3, 1)
    mask = fa_kernel.attention_mask(S, causal, window, dev)
    live = int(mask.sum())                         # (i, j) pairs per (b, h)
    lib = lib_err = lib_ratio = None
    if softcap is None:
        # kv heads expanded: a view where Hkv = 1, one copy otherwise
        qt = q.transpose(1, 2)
        kt, vt = (t.transpose(1, 2)[:, :, None].expand(
            B, Hkv, Hq // Hkv, S, hd).flatten(1, 2) for t in (k, v))
        lib_mask = mask if window is not None else None
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def lib_call():
            return sdpa(qt, kt, vt, attn_mask=lib_mask,
                        is_causal=causal and window is None,
                        scale=1.0 / hd ** 0.5)
        lib_err, lib_ratio = _attn_err(lib_call().transpose(1, 2), ref,
                                       torch.bfloat16, 0.0)
        if not lib_err < 0.1:
            raise AssertionError(f"the SDPA yardstick computes something "
                                 f"else (max err {lib_err})")
        lib = time_ms(lib_call, 20, 3)
    del ref, mask
    flops = 4 * hd * live * B * Hq
    nbytes = 2 * (2 * B * S * Hq * hd + 2 * B * S * Hkv * hd)
    masking = ("unmasked" if not causal else "causal" if window is None
               else f"window={window}")
    return dict(name=name, route="cuda",
                source=f"src/repro_torch/kernels/csrc/flash_attention_tc_hd"
                       f"{hd}.cu (src/repro_torch/kernels/csrc/"
                       "flash_attention_tc.cuh)",
                replaces="src/repro/kernels/flash_attention.py:95",
                instructions="wgmma+tma",
                float32_route=dict(
                    source=f"src/repro_torch/kernels/csrc/flash_attention_hd"
                           f"{hd}.cu (src/repro_torch/kernels/csrc/"
                           "flash_attention.cuh)",
                    instructions="fma (CUDA cores)"),
                **extra,
                shape=f"B={B} S={S} Hq={Hq} Hkv={Hkv} hd={hd} {masking}"
                      + (f" softcap={softcap}" if softcap else "") + " bf16",
                launch_key=list(fa_kernel.launch_key(B, S, Hq, Hkv, hd, causal,
                                                     window, softcap)),
                max_abs_err=max(worst.values()), max_abs_err_by_dtype=worst,
                err_over_tolerance_by_dtype=ratios,
                tolerance=(f"float32 {ATTN_F32_TOL} abs; bfloat16 "
                           f"{fa_kernel.BF16_REL}*|plain| + "
                           f"{fa_kernel.BF16_ROW}*rms(plain row)"),
                ms=ms, body_ms=body, plain_ms=plain,
                **bound(nbytes, flops, BF16_FLOPS),
                library_ms=lib,
                library_call=("torch.nn.functional.scaled_dot_product_attention"
                              if lib is not None else "none (softcap)"),
                library_max_abs_err=lib_err,
                library_err_over_tolerance=lib_ratio, flops=flops)


def family_flash_shapes() -> list[dict]:
    """B5's distinct shapes in the bfloat16 prefill(PATH_B, S) of each
    family of ``FAMILIES``, read from its config and stack metas: one per
    (stack, mask) -- whisper's encoder at ``src_seq`` unmasked, every
    decoder at S -- with the number of its layers at that shape, the B5
    launches one prefill makes there."""
    rows = []
    for arch, S in FAMILIES:
        cfg = get_config(arch)
        m = build_model(cfg)
        stacks = [("decoder", S, _metas(m))]
        if m.enc_sm is not None:
            sm = m.enc_sm
            stacks.append(("encoder", cfg.src_seq,
                           sm.metas * sm.n_super + sm.rem_metas))
        for stack, seq, metas in stacks:
            layers = collections.Counter(
                meta["kind"] for meta in metas if meta["kind"] in ATTN_KINDS)
            for kind, n in sorted(layers.items()):
                rows.append(dict(
                    name=f"flash_attention[{arch} {stack} {kind}]",
                    arch=arch, B=PATH_B, S=seq, Hq=cfg.n_heads, Hkv=cfg.n_kv,
                    hd=cfg.hd, causal=kind != "enc",
                    window=cfg.window if kind == "local" else None,
                    softcap=cfg.attn_softcap, layers=n))
    return rows


def check_flash_families(dev, rng) -> list[dict]:
    """:func:`flash_row` at every shape of :func:`family_flash_shapes`."""
    out = []
    for f in family_flash_shapes():
        f = dict(f)
        out.append(flash_row(
            dev, rng, f.pop("name"), f.pop("B"), f.pop("S"), f.pop("Hq"),
            f.pop("Hkv"), f.pop("hd"), f.pop("causal"), f.pop("window"),
            f.pop("softcap"), model=f.pop("arch"),
            layers_at_shape=f.pop("layers")))
    return out


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
SCHED_KERNELS = ("slowdown_pool", "slowdown_same_device", "settle_reprice",
                 "settle_complete", "transfer_reprice", "transfer_complete",
                 "scan_reduce", "scan_reduce_batch", "rewalk_entry")
# kernels held against their plain versions that no path runs any more:
# the engine's transfer sites run the fused transfer_reprice and
# transfer_complete in their place
OFF_PATH_KERNELS = {"rate_advance": "transfer_reprice, transfer_complete",
                    "segment_min": "transfer_reprice"}
# the transfer kernels' launches are counted on their own path, the VR
# session (the mining session's transfers all start and end together)
VR_KERNELS = ("transfer_reprice", "transfer_complete")
MODEL_KERNELS = ("flash_attention", "lru_scan")


def _fresh_peak() -> int:
    """Free what earlier phases left to the collector, restart the peak
    count, and return the device bytes still allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def reset_counts() -> None:
    fa_kernel.launches = 0
    fa_kernel.launches_by_shape.clear()
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
    return _drive(tb, cfg, seed, t0)


def run_vr(mult, n_frames: int, device, seed: int):
    """The paper's VR discipline: build_testbed (its default 5 edges and 3
    servers, or the mining fleet's ratios at ``mult``) -> vr_workload ->
    build_orchestrators -> SchedulerSession.map_pending / execute.
    Returns what :func:`run_session` returns."""
    t0 = time.perf_counter()
    if mult is None:
        tb = core.build_testbed(device=device)
    else:
        ec, sc = mining_counts(mult)
        tb = core.build_testbed(edge_counts=ec, server_counts=sc,
                                device=device)
    cfg = vr_workload(tb, n_frames=n_frames)
    return _drive(tb, cfg, seed, t0)


def _drive(tb, cfg, seed: int, t0: float):
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
    dt = _card_vs_cpu("x8", gs, gcfg, cs, ccfg)
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


def _card_vs_cpu(what: str, gs, gcfg, cs, ccfg) -> float:
    """Placements identical, nothing unmapped, finish times within T_TOL;
    returns the largest finish-time difference."""
    gm, gf = by_order(gs, gcfg)
    cm, cf = by_order(cs, ccfg)
    if gm != cm:
        bad = [i for i, (a, b) in enumerate(zip(gm, cm)) if a != b]
        raise AssertionError(f"{what}: card and CPU placements differ at "
                             f"{bad[:5]}")
    if gs.unmapped or cs.unmapped:
        raise AssertionError(f"{what}: {len(gs.unmapped)} tasks unmapped on "
                             f"the card, {len(cs.unmapped)} on the CPU")
    dt = max(abs(a - b) for a, b in zip(gf, cf))
    if not dt <= T_TOL:
        raise AssertionError(f"{what}: card vs CPU finish times differ by "
                             f"{dt}")
    return dt


# the VR phase: the paper's testbed at its 30 frames (1050 tasks), then
# the mining fleet's ratios at mult=8 (80 edges, 24 servers) for 4 frames
VR_RUNS = (("paper", None, 30), ("x8", 8, 4))


def session_vr(seed: int) -> tuple[dict, dict]:
    """The VR session on the card and on the CPU, through the public entry
    points: placements identical, finish times within 1e-9, nothing
    unmapped, both fused transfer kernels launched on the card.  Returns
    the phase's line and the paper run's launch counts."""
    out: dict = {}
    first = None
    for label, mult, frames in VR_RUNS:
        reset_counts()
        gs, gcfg, g, _, gsecs = run_vr(mult, frames, None, seed)
        counts = read_counts()
        syncs = rt_device.sync_count()
        cs, ccfg, _, _, csecs = run_vr(mult, frames, "cpu", seed)
        dt = _card_vs_cpu(f"vr {label}", gs, gcfg, cs, ccfg)
        for name in VR_KERNELS:
            if counts[name] <= 0:
                raise AssertionError(f"vr {label}: {name} was never launched")
        if first is None:
            first = counts
        out[label] = dict(
            mult=mult, pus=len(g.compiled().pu_names), frames=frames,
            tasks=len(gcfg), mapped=len(gs.mapping),
            unmapped=len(gs.unmapped), placements_identical=True,
            max_finish_diff_cuda_vs_cpu=dt, tolerance=T_TOL, cuda=gsecs,
            cpu=csecs, qos_failures=gs.qos_failures(gcfg),
            device_to_host_syncs=syncs, launches=counts)
    return out, first


def _spread(xs: list) -> dict:
    """Count, mean, median and max of per-call sizes."""
    if not xs:
        return dict(calls=0)
    return dict(calls=len(xs), mean=float(np.mean(xs)),
                p50=float(np.median(xs)), max=int(max(xs)))


class env_switch:
    """Set one of the port's walk switches for a block, then restore it."""

    def __init__(self, name: str, value: str) -> None:
        self.name, self.value = name, value

    def __enter__(self) -> None:
        self.old = os.environ.get(self.name)
        os.environ[self.name] = self.value

    def __exit__(self, *exc) -> None:
        if self.old is None:
            os.environ.pop(self.name, None)
        else:
            os.environ[self.name] = self.old


def map_rows(results: dict, cfg) -> list:
    """Every mapping decision of a session in cfg order: (pu, standalone,
    factor, comm, queries, hops, overhead)."""
    out = []
    for t in cfg:
        r = results[t.uid]
        out.append((r.pu, r.prediction.standalone, r.prediction.factor,
                    r.prediction.comm, r.queries, r.hops, r.overhead))
    return out


def map_session(mult: int, device, seed: int) -> tuple[list, float]:
    """The session of :func:`run_session` up to its map only: (decisions
    in cfg order, map_pending seconds)."""
    ec, sc = mining_counts(mult)
    tb = core.build_testbed(edge_counts=ec, server_counts=sc, device=device)
    cfg = mining_workload(tb, n_sensors=12 * mult, n_readings=1)
    g = tb.graph
    session = core.SchedulerSession(
        g, core.build_orchestrators(g, core.heye_traverser(g)),
        truth=core.ground_truth_traverser(g, rng=np.random.default_rng(seed)))
    session.submit(cfg)
    t0 = time.perf_counter()
    res = session.map_pending()
    if g.device.type == "cuda":
        torch.cuda.synchronize()
    return map_rows(res, cfg), time.perf_counter() - t0


class _WalkForm:
    """Records which form the walk took, by wrapping (outside the port)
    the orchestrator's sharded wave driver, its per-bucket drive and its
    thread pool: per sharded wave, the walks of each drive (a group's,
    or the whole wave's when every walk starts in one group), and the
    pools made."""

    def __init__(self) -> None:
        self.waves: list[list] = []
        self.pools: list[int] = []
        self.sharded = orc_mod.Orchestrator._walk_wave_sharded
        self.drive = orc_mod.Orchestrator._drive_wave
        self.pool = orc_mod.ThreadPoolExecutor

    def __enter__(self) -> "_WalkForm":
        log, sharded, drive, pool_cls = (self, self.sharded, self.drive,
                                         self.pool)

        def wave(orc, *a, **k):
            log.waves.append([])
            return sharded(orc, *a, **k)

        def logged(orc, order, now, ctx, stop_root=False):
            if log.waves:
                log.waves[-1].append((len(order), stop_root))
            return drive(orc, order, now, ctx, stop_root)

        class Pool(pool_cls):
            def __init__(self, *a, **k):
                log.pools.append(k.get("max_workers", 0))
                super().__init__(*a, **k)

        orc_mod.Orchestrator._walk_wave_sharded = wave
        orc_mod.Orchestrator._drive_wave = logged
        orc_mod.ThreadPoolExecutor = Pool
        return self

    def __exit__(self, *exc) -> None:
        orc_mod.Orchestrator._walk_wave_sharded = self.sharded
        orc_mod.Orchestrator._drive_wave = self.drive
        orc_mod.ThreadPoolExecutor = self.pool

    def line(self, root) -> dict:
        led = root.ledger
        sharded = isinstance(led, core.ShardedLedger)
        per_group = any(g for w in self.waves for _, g in w)
        return dict(
            form=("threaded" if self.pools else
                  "serial" if per_group else
                  "one group a wave" if self.waves else "fused"),
            sharded_ledger=sharded,
            shards=len(led.shards) if sharded else 1,
            shard_pus=([len(s) for s in root._sharded_hw.shards]
                       if sharded else None),
            sharded_waves=len(self.waves),
            # the first waves' drives: (walks, a group's drive or not)
            wave_drives=self.waves[:4], thread_pools=self.pools)


def mixed_wave(mult: int, device) -> tuple[list, float, dict]:
    """One wave of one task from every device of the mining fleet at
    ``mult`` (edges and servers, kinds svm / mlp / knn / dnn in turn,
    each its own deadline): its walks start in both root groups, so at
    full width the sharded driver fans them out over host threads.
    Returns (decisions in task order, map seconds, walk form)."""
    ec, sc = mining_counts(mult)
    tb = core.build_testbed(edge_counts=ec, server_counts=sc, device=device)
    g = tb.graph
    devs = list(tb.edges) + list(tb.servers)
    kinds = ("svm", "mlp", "knn", "dnn")
    tasks = [core.make_task(kinds[i % 4], origin=d, deadline=0.2 + 1e-6 * i)
             for i, d in enumerate(devs)]
    root = core.build_orchestrators(g, core.heye_traverser(g)).prepare()
    with _WalkForm() as form:
        t0 = time.perf_counter()
        res = root.map_batch(tasks, 0.0, route=True)
        if g.device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    rows = [(r.pu, r.prediction.standalone, r.prediction.factor,
             r.prediction.comm, r.queries, r.hops, r.overhead) for r in res]
    return rows, dt, form.line(root)


def _time_sharding(slices: list):
    """Wrap ``CompiledHWGraph.sharded`` (outside the port) so each slicing
    records its seconds and the bytes its shards hold."""
    real = core.CompiledHWGraph.sharded

    def timed(comp, groups, validate=True):
        t0 = time.perf_counter()
        sh = real(comp, groups, validate)
        if comp.device.type == "cuda":
            torch.cuda.synchronize()
        slices.append(dict(
            seconds=time.perf_counter() - t0, pus=len(comp.pu_names),
            shard_bytes=sum(t.numel() * t.element_size() for g_ in sh.shards
                            for t in (g_.pu_idx, g_.pu_alive, g_.mem_cap,
                                      g_.max_tenancy, g_.ncr_res,
                                      g_.ncr_rclass, g_.pu_dev_ord))))
        return sh
    return real, timed


def session_full(seed: int) -> tuple[dict, dict, dict]:
    """The session at full width, walked in its default form (sharded at
    the root's two groups): placements complete, every scheduler kernel
    launched, the size of each phase-1 wave's batched entry reduce and of
    each pool and same-device stack that reached B1 (read by wrapping the
    calls, outside the port), the walk's form and the snapshot slicing's
    seconds and bytes; then the row form of B1 on its own path, the
    traverser's what-if query (:func:`what_if`); then the same session's
    map on the CPU (placements equal) and on the card with
    ``REPRO_SHARDED_WALK=0`` (every decision bit-identical), both timed.
    Its device-op count comes later, from :func:`session_traced`."""
    mult = FULL_MULT
    base = _fresh_peak()
    reset_counts()
    walk_call = orc_mod.scan_reduce_batch
    pool_call = sd_mod.slowdown_pool
    same_call = sd_mod.slowdown_same_device
    stacks: list[int] = []
    pools: list[int] = []
    same_items: list[int] = []
    same_pairs: list[int] = []
    slices: list[dict] = []
    real_sharded, timed_sharded = _time_sharding(slices)

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
    core.CompiledHWGraph.sharded = timed_sharded
    try:
        with _WalkForm() as form:
            st, cfg, g, sess, secs = run_session(mult, None, seed)
    finally:
        orc_mod.scan_reduce_batch = walk_call
        sd_mod.slowdown_pool = pool_call
        sd_mod.slowdown_same_device = same_call
        core.CompiledHWGraph.sharded = real_sharded
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
    walk_form = form.line(sess.policy)
    if not walk_form["sharded_ledger"] or not walk_form["sharded_waves"] \
            or len(slices) != 1:
        raise AssertionError(f"x{mult}: the default walk did not shard: "
                             f"{walk_form}, {len(slices)} slicings")
    pct = st.latency_percentiles(cfg, (50.0, 99.0))
    comp = g.compiled()
    wif = what_if(g, cfg, st)
    counts["slowdown_factors"] = wif["launches"]
    # the same session's map on the CPU, then fused on the card
    rows = map_rows(sess.results, cfg)
    cpu_rows, cpu_map_s = map_session(mult, "cpu", seed)
    if [r[0] for r in cpu_rows] != [r[0] for r in rows]:
        bad = [i for i, (a, b) in enumerate(zip(cpu_rows, rows))
               if a[0] != b[0]]
        raise AssertionError(f"x{mult}: sharded card and CPU placements "
                             f"differ at {bad[:5]}")
    reset_counts()
    with env_switch("REPRO_SHARDED_WALK", "0"), _WalkForm() as fform:
        fused_rows, fused_map_s = map_session(mult, None, seed)
    fcounts = read_counts()
    if fform.waves or fused_rows != rows:
        bad = [i for i, (a, b) in enumerate(zip(fused_rows, rows)) if a != b]
        raise AssertionError(f"x{mult}: the fused walk's decisions differ "
                             f"from the sharded walk's at {bad[:5]}")
    # walks from both groups: the threaded branch, against the fused walk
    # and the CPU
    mrows, m_s, mform = mixed_wave(mult, None)
    with env_switch("REPRO_SHARDED_WALK", "0"):
        mfused, mf_s, _ = mixed_wave(mult, None)
    mcpu, mc_s, _ = mixed_wave(mult, "cpu")
    if mform["form"] != "threaded" or mrows != mfused \
            or [r[0] for r in mrows] != [r[0] for r in mcpu]:
        raise AssertionError(f"x{mult}: the mixed-origin wave walked "
                             f"{mform['form']}, or its decisions differ "
                             "from the fused walk's or the CPU's")
    return dict(mult=mult, device=str(g.device), pus=len(comp.pu_names),
                tasks=len(cfg), mapped=len(st.mapping),
                unmapped=len(st.unmapped), **secs,
                p50_latency_s=pct[50.0], p99_latency_s=pct[99.0],
                qos_failures=st.qos_failures(cfg), launches=counts,
                walk_form=walk_form, sharding=slices[0],
                entry_wave_scans=stacks, pool_members=_spread(pools),
                same_device_items=_spread(same_items),
                same_device_pairs=_spread(same_pairs),
                device_to_host_syncs=syncs, device_bytes_at_start=base,
                peak_device_bytes=peak, what_if=wif,
                cpu_map_pending_s=cpu_map_s,
                cpu_placements_identical=True,
                fused=dict(map_pending_s=fused_map_s,
                           decisions_bit_identical=True,
                           launches=fcounts),
                mixed_wave=dict(tasks=len(mrows), walk_form=mform,
                                map_s=m_s, fused_map_s=mf_s, cpu_map_s=mc_s,
                                fused_bit_identical=True,
                                cpu_placements_identical=True)
                ), counts, fcounts


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
# the object walk: the parity oracle, first_fit, the policies' traversers
# ---------------------------------------------------------------------------
ORACLE_MULT = 8              # the paper's mining fleet: 528 PUs, 288 tasks
ORACLE_VR_FRAMES = 10        # the paper's VR testbed: 350 tasks


class _TupleSurface:
    """A noise-free slowdown model with only the tuple surface (``factor``
    / ``factors_with_candidates``), as a user's own model may have: no
    block-diagonal check, so ``map_batch`` walks it with the object walk
    and scores per device — B1's row form, through
    ``factors_with_candidates_idx``."""

    def __init__(self, sd) -> None:
        self._sd = sd

    def factor(self, *a):
        return self._sd.factor(*a)

    def factors_with_candidates(self, *a):
        return self._sd.factors_with_candidates(*a)

    def factor_batch(self, *a):
        return self._sd.factor_batch(*a)

    def invalidate(self) -> None:
        self._sd.invalidate()


def oracle_map(kind: str, device, seed: int, policy: str = "heye",
               objective=None) -> tuple[list, float, object]:
    """One session map of the walk_oracle phase through the public entry
    points: ``kind`` "mining" (the fleet at ORACLE_MULT, one reading) or
    "vr" (the paper's testbed, ORACLE_VR_FRAMES frames); the policy's
    traverser ``policy`` — "heye", "truth" (``ground_truth_traverser(g,
    seed)``), "noisy" (a slowdown model drawing from a generator seeded
    with ``seed``) or "tuple" (:class:`_TupleSurface`).  Returns (the
    decisions in cfg order, map seconds, the generator's next draw or
    None)."""
    if kind == "mining":
        ec, sc = mining_counts(ORACLE_MULT)
        tb = core.build_testbed(edge_counts=ec, server_counts=sc,
                                device=device)
        cfg = mining_workload(tb, n_sensors=12 * ORACLE_MULT, n_readings=1)
    else:
        tb = core.build_testbed(device=device)
        cfg = vr_workload(tb, n_frames=ORACLE_VR_FRAMES)
    g = tb.graph
    rng = None
    if policy == "truth":
        trav = core.ground_truth_traverser(g, seed)
    elif policy == "noisy":
        rng = np.random.default_rng(seed)
        trav = core.Traverser(g, slowdown=core.DecoupledSlowdown(
            g, core.truth_params(), rng=rng))
    elif policy == "tuple":
        trav = core.Traverser(g, slowdown=_TupleSurface(
            core.heye_traverser(g).slowdown))
    else:
        trav = core.heye_traverser(g)
    root = core.build_orchestrators(
        g, trav,
        config=core.OrcConfig(objective=objective) if objective else None)
    session = core.SchedulerSession(g, root)
    session.submit(cfg)
    t0 = time.perf_counter()
    res = session.map_pending()
    if g.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if session.unmapped:
        raise AssertionError(f"walk_oracle {kind}/{policy}: "
                             f"{len(session.unmapped)} tasks unmapped")
    return map_rows(res, cfg), dt, (rng.random() if rng else None)


def _decisions_agree(what: str, got: list, want: list,
                     exact: bool) -> float:
    """Placements, queries and hops identical; standalone, factor and
    comm identical (``exact``) or within T_TOL relative; overhead within
    T_TOL relative.  Returns the largest relative overhead difference."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} vs {len(want)} tasks")
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        same = (a[0], a[4], a[5]) == (b[0], b[4], b[5])
        for k in (1, 2, 3):
            same = same and (a[k] == b[k] if exact else
                             abs(a[k] - b[k]) <= T_TOL * max(abs(b[k]), 1e-12))
        d = abs(a[6] - b[6]) / max(abs(b[6]), 1e-12)
        if not same or not d <= T_TOL:
            raise AssertionError(f"{what}: task {i} differs: {a} vs {b}")
        worst = max(worst, d)
    return worst


def walk_oracle(seed: int) -> tuple[dict, dict]:
    """The object walk on the card at the paper's mining fleet (mult=8)
    and VR testbed: against the fused walk (``REPRO_FUSED_WALK=0``:
    decisions exact, overhead 1e-9), the ``first_fit`` objective card vs
    CPU, the ground-truth traverser as the policy's traverser card vs CPU,
    a noisy slowdown model card vs CPU (the generator left in the same
    state), and a tuple-surface model card vs CPU and against the fused
    walk — the path of B1's row form, whose launches must show."""
    reset_counts()
    out: dict = {}
    for kind in ("mining", "vr"):
        fused, fused_s, _ = oracle_map(kind, None, seed)
        with env_switch("REPRO_FUSED_WALK", "0"):
            obj, obj_s, _ = oracle_map(kind, None, seed)
        d_obj = _decisions_agree(f"walk_oracle {kind}: object vs fused walk",
                                 obj, fused, exact=True)
        ff, ff_s, _ = oracle_map(kind, None, seed, objective="first_fit")
        ff_c, ff_cs, _ = oracle_map(kind, "cpu", seed, objective="first_fit")
        d_ff = _decisions_agree(f"walk_oracle {kind}: first_fit card vs CPU",
                                ff, ff_c, exact=False)
        out[kind] = dict(
            tasks=len(fused), fused_map_s=fused_s, object_map_s=obj_s,
            object_vs_fused=dict(decisions_exact=True,
                                 max_overhead_rel_diff=d_obj),
            first_fit=dict(map_s=ff_s, cpu_map_s=ff_cs,
                           max_overhead_rel_diff_cuda_vs_cpu=d_ff,
                           queries=sum(r[4] for r in ff),
                           best_fit_queries=sum(r[4] for r in fused)))
    fused = None
    for policy in ("truth", "noisy", "tuple"):
        got, g_s, g_next = oracle_map("mining", None, seed, policy=policy)
        want, c_s, c_next = oracle_map("mining", "cpu", seed, policy=policy)
        d = _decisions_agree(f"walk_oracle {policy}: card vs CPU", got, want,
                             exact=False)
        if g_next != c_next:
            raise AssertionError(f"walk_oracle {policy}: the generator's "
                                 "streams parted card vs CPU")
        line = dict(map_s=g_s, cpu_map_s=c_s,
                    max_overhead_rel_diff_cuda_vs_cpu=d)
        if policy == "tuple":
            if fused is None:
                fused, _, _ = oracle_map("mining", None, seed)
            line["max_overhead_rel_diff_vs_fused"] = _decisions_agree(
                "walk_oracle tuple vs the fused walk", got, fused,
                exact=False)
        out[f"mining_{policy}"] = line
    counts = read_counts()
    # the mining walks' re-walks take the fused entry scan; VR's escalate
    # and every escalation reduces through B4
    for name in ("slowdown_factors", "slowdown_same_device", "scan_reduce",
                 "rewalk_entry"):
        if counts[name] <= 0:
            raise AssertionError(f"walk_oracle: kernel {name} was never "
                                 "launched on the phase's path")
    out.update(mult=ORACLE_MULT, vr_frames=ORACLE_VR_FRAMES, launches=counts,
               device_to_host_syncs=rt_device.sync_count())
    return out, counts


# ---------------------------------------------------------------------------
# the online path: ServeLoop on the session-resident timeline, and churn
# absorbed as snapshot deltas
# ---------------------------------------------------------------------------
# benchmarks/serve.py::_serve_once: per-mult request rates over a horizon
# of 10/mult s (about 1.1k requests at any mult)
SERVE_MULT = 64
SERVE_HORIZON = 10.0
SERVE_MINING_RATE = 75.0
SERVE_VISION_BASE, SERVE_VISION_PEAK = 20.0, 60.0
CHURN_MULT = 8               # serve_churn: the same loop, a wave per 1/8
CHURN_WAVES = 8
CHURN_SEED = 1234            # the wireless schedule's seed (both drivers)
BWCHURN_MULT = 128           # benchmarks/des.py::_bwchurn(mult=128)
# the scheduler kernels whose launches the serving run must show
SERVE_KERNELS = ("slowdown_pool", "settle_reprice", "settle_complete")


def _serve_loop(mult: int, device, interventions=None):
    """benchmarks/serve.py::_serve_once rebuilt from the port's own
    modules: the mining fleet at ``mult``, a Poisson ``svm`` tenant from
    edges[0] (SLA 0.10 s) and a diurnal ``mlp`` tenant from edges[1] (SLA
    0.15 s) over ``horizon`` = 10/mult s, ``AdmissionController(slack=4,
    defer_delay=0.005, max_defers=1)``, per-arrival admission.
    ``interventions(tb, horizon, root)`` gives the loop's (t, Churn)
    list.
    Returns (loop, stats, graph)."""
    from repro_torch.serve.admission import AdmissionController
    ec, sc = mining_counts(mult)
    tb = core.build_testbed(edge_counts=ec, server_counts=sc, device=device)
    g = tb.graph
    root = core.build_orchestrators(g, core.heye_traverser(g))
    horizon = SERVE_HORIZON / mult
    tenants = [
        core.TenantSpec("mining", core.PoissonArrivals(
            rate=SERVE_MINING_RATE * mult, seed=11),
            core.single_task_request("svm", origin=tb.edges[0], sla=0.10),
            sla=0.10),
        core.TenantSpec("vision", core.DiurnalArrivals(
            base_rate=SERVE_VISION_BASE * mult,
            peak_rate=SERVE_VISION_PEAK * mult, period=horizon, seed=12),
            core.single_task_request("mlp", origin=tb.edges[1], sla=0.15),
            sla=0.15)]
    loop = core.ServeLoop(
        g, root, tenants,
        truth=core.ground_truth_traverser(g, rng=np.random.default_rng(0)),
        admission=AdmissionController(slack=4.0, defer_delay=0.005,
                                      max_defers=1),
        batch_window=0.0, horizon=horizon,
        interventions=(interventions(tb, horizon, root) if interventions
                       else ()))
    st = loop.run()
    if g.device.type == "cuda":
        torch.cuda.synchronize()
    return loop, st, g


def _serve_card_vs_cpu(what: str, gl, gs, cl, cs) -> float:
    """Accepted and rejected sets, reject reasons, deferrals and
    placements identical card vs CPU, finish times within T_TOL; returns
    the largest finish-time difference."""
    if len(gs.requests) != len(cs.requests):
        raise AssertionError(f"{what}: {len(gs.requests)} requests on the "
                             f"card, {len(cs.requests)} on the CPU")
    dt = 0.0
    for a, b in zip(gs.requests, cs.requests):
        if (a.rid, a.tenant, a.verdict, a.reject_reason, a.defers,
                a.arrival) != (b.rid, b.tenant, b.verdict, b.reject_reason,
                               b.defers, b.arrival):
            raise AssertionError(f"{what}: request {a.rid} differs card vs "
                                 f"CPU: {a.verdict}/{a.reject_reason} vs "
                                 f"{b.verdict}/{b.reject_reason}")
        if a.verdict == "accepted":
            pa = [gl.session.mapping[t.uid] for t in a.tasks]
            pb = [cl.session.mapping[t.uid] for t in b.tasks]
            if pa != pb:
                raise AssertionError(f"{what}: request {a.rid} placed on "
                                     f"{pa} on the card, {pb} on the CPU")
        if math.isnan(a.finish) != math.isnan(b.finish):
            raise AssertionError(f"{what}: request {a.rid} finished on one "
                                 "side only")
        if not math.isnan(a.finish):
            dt = max(dt, abs(a.finish - b.finish))
    if not dt <= T_TOL:
        raise AssertionError(f"{what}: card vs CPU finish times differ by "
                             f"{dt}")
    if gs.deferrals != cs.deferrals:
        raise AssertionError(f"{what}: {gs.deferrals} deferrals on the card,"
                             f" {cs.deferrals} on the CPU")
    return dt


def _contexts(loop) -> dict:
    """The walk contexts the loop's root built and rebased."""
    root = loop.session.policy
    return dict(context_builds=root.context_builds,
                context_rebases=root.context_rebases)


def _serve_line(st, g, counts: dict, syncs: int, dt: float, cpu_st) -> dict:
    s = st.summary()
    n = len(st.requests)
    return dict(
        pus=len(g.compiled().pu_names), horizon_s=st.horizon, requests=n,
        accepted=s["accepted"], rejected=s["rejected"],
        reject_reasons=s["reject_reasons"], deferrals=s["deferrals"],
        engine_opens=s["engine_opens"], n_events=s["n_events"],
        p50_ms=s["p50_ms"], p99_ms=s["p99_ms"], p999_ms=s["p999_ms"],
        sla_by_tenant=s["sla_by_tenant"], offered_rps=s["offered_rps"],
        wall_s=st.wall_s, wall_rps=s["wall_rps"], phase_wall=st.phase_wall,
        waves=len(st.wave_sizes), launches=counts,
        launches_per_request={k: v / n for k, v in counts.items() if v},
        device_to_host_syncs=syncs, syncs_per_request=syncs / n,
        placements_identical=True, max_finish_diff_cuda_vs_cpu=dt,
        tolerance=T_TOL, cpu_wall_s=cpu_st.wall_s,
        cpu_wall_rps=cpu_st.wall_rps, cpu_phase_wall=cpu_st.phase_wall)


def _check_serve_launches(what: str, st, counts: dict) -> None:
    if st.engine_opens != 1:
        raise AssertionError(f"{what}: {st.engine_opens} TimelineEngine "
                             "builds (the resident timeline opens once)")
    # every wave's entry scans reduce in one B4b launch and its later
    # scans through B4 (its waves re-walk nothing in a fused entry)
    for name in SERVE_KERNELS + ("scan_reduce", "scan_reduce_batch"):
        if counts[name] <= 0:
            raise AssertionError(f"{what}: kernel {name} was never launched")


def serve_x64() -> tuple[dict, dict, dict]:
    """benchmarks/serve.py::_serve_once(64) on the port: the card run over
    the session-resident walk context (its launches, syncs, serving
    metrics, contexts built and rebased, peak device bytes) against the
    same loop on the CPU, then the card run once more with
    ``REPRO_SERVE_FASTPATH=0`` (a cold walk per wave): verdicts,
    placements and finish times equal.  The arrivals and the ground
    truth take the reference driver's own seeds (11, 12, 0), not
    ``--seed``."""
    what = f"serve_x{SERVE_MULT}"
    base = _fresh_peak()
    reset_counts()
    gl, gs, g = _serve_loop(SERVE_MULT, None)
    peak = torch.cuda.max_memory_allocated()
    counts = read_counts()
    syncs = rt_device.sync_count()
    cl, cs, _ = _serve_loop(SERVE_MULT, "cpu")
    dt = _serve_card_vs_cpu(what, gl, gs, cl, cs)
    _check_serve_launches(what, gs, counts)
    ctxs = _contexts(gl)
    if ctxs["context_builds"] != 1 or _contexts(cl) != ctxs:
        raise AssertionError(f"{what}: the resident context was rebuilt: "
                             f"card {ctxs}, CPU {_contexts(cl)}")
    reset_counts()
    with env_switch("REPRO_SERVE_FASTPATH", "0"):
        kl, ks, _ = _serve_loop(SERVE_MULT, None)
    kcounts = read_counts()
    ksyncs = rt_device.sync_count()
    dk = _serve_card_vs_cpu(f"{what} resident vs cold", gl, gs, kl, ks)
    if kl.session.policy._resident_ctx is not None:
        raise AssertionError(f"{what}: REPRO_SERVE_FASTPATH=0 kept a "
                             "resident context")
    n = len(gs.requests)
    out = _serve_line(gs, g, counts, syncs, dt, cs)
    out.update(mult=SERVE_MULT, recompile_count=g.recompile_count,
               delta_count=g.delta_count, **ctxs,
               device_bytes_at_start=base, peak_device_bytes=peak,
               cold=dict(wall_s=ks.wall_s, wall_rps=ks.wall_rps,
                         phase_wall=ks.phase_wall,
                         max_finish_diff_resident_vs_cold=dk,
                         same_verdicts_and_placements=True,
                         **_contexts(kl), launches=kcounts,
                         launches_per_request={k: v / n for k, v in
                                               kcounts.items() if v},
                         device_to_host_syncs=ksyncs,
                         syncs_per_request=ksyncs / n))
    return out, counts, kcounts


class _ChurnLog:
    """Records, around each ``HWGraph.apply_churn`` call of one graph, what
    the call did to the graph's snapshot counters (outside the port: the
    graph instance's method is wrapped)."""

    KEYS = ("delta_count", "recompile_count", "route_holder_copies",
            "route_overlay_copies")

    def __init__(self, g, root) -> None:
        self.g = g
        self.root = root
        self.calls: list[dict] = []
        real = g.apply_churn

        def logged(churn):
            before = {k: getattr(g, k) for k in self.KEYS}
            real(churn)
            self.calls.append(dict(
                kind=("bandwidth" if not (churn.dead or churn.alive)
                      else "dead" if churn.dead else "alive"),
                entries=len(churn),
                **{k: getattr(g, k) - before[k] for k in self.KEYS},
                # the walk contexts built and rebased before this batch
                context_builds=root.context_builds,
                context_rebases=root.context_rebases))
        g.apply_churn = logged


def _churn_interventions(logs: list):
    """The serve_churn schedule: one wireless ``Churn`` wave every
    horizon/8 (``wireless_churn_schedule(tb, 8, seed=1234)``, at the
    middle of each eighth), then edges[1] dies at horizon/3 and revives
    at 2 horizon/3 (the reference's test_serve_loop_with_mid_run_churn)."""
    def make(tb, horizon, root):
        logs.append(_ChurnLog(tb.graph, root))
        waves = core.wireless_churn_schedule(tb, CHURN_WAVES, seed=CHURN_SEED)
        iv = [((k + 0.5) * horizon / CHURN_WAVES, w)
              for k, w in enumerate(waves)]
        e = tb.edges[1]
        iv += [(horizon / 3, core.Churn(dead=[e])),
               (2 * horizon / 3, core.Churn(alive=[e]))]
        return sorted(iv, key=lambda x: x[0])
    return make


def _edge_refresh(device) -> tuple[list, dict]:
    """Transfers in flight through a bandwidth ``Churn``: four 8 MB inputs
    from two edges to two servers, the uplinks throttled at 2 ms and one
    restored at 40 ms (``Traverser.traverse`` with ``interventions``).
    Returns the finish times and the launches of the run."""
    tb = core.build_testbed(device=device)
    cfg = core.TaskGraph()
    ts = [core.make_task("render", origin=tb.edges[k % 2], input_bytes=8e6,
                         release_time=1e-3 * k) for k in range(4)]
    for t in ts:
        cfg.add(t)
    mapping = {t.uid: f"{tb.servers[k % 2]}.gpu" for k, t in enumerate(ts)}
    iv = [(2e-3, core.Churn(bandwidth=[(f"link_{tb.edges[0]}", 5e5),
                                       (f"link_{tb.edges[1]}", 2e6)])),
          (4e-2, core.Churn(bandwidth=[(f"link_{tb.edges[1]}", 1e9)]))]
    reset_counts()
    tl = core.heye_traverser(tb.graph).traverse(cfg, mapping,
                                                interventions=iv)
    return [tl.finish[t.uid] for t in ts], read_counts()


def serve_churn() -> tuple[dict, dict]:
    """The serving loop at mult=8 under a wireless churn schedule and an
    edge's death and revival, card vs CPU: every churn batch absorbed as
    one delta, no rebuild, no topology-layer copy under a bandwidth
    wave."""
    logs: list = []
    reset_counts()
    gl, gs, g = _serve_loop(CHURN_MULT, None, _churn_interventions(logs))
    counts = read_counts()
    syncs = rt_device.sync_count()
    cl, cs, _ = _serve_loop(CHURN_MULT, "cpu", _churn_interventions(logs))
    dt = _serve_card_vs_cpu(f"serve_churn x{CHURN_MULT}", gl, gs, cl, cs)
    _check_serve_launches(f"serve_churn x{CHURN_MULT}", gs, counts)
    calls = logs[0].calls
    if len(calls) != CHURN_WAVES + 2:
        raise AssertionError(f"serve_churn: {len(calls)} churn batches "
                             f"applied, {CHURN_WAVES + 2} scheduled")
    bw = [c for c in calls if c["kind"] == "bandwidth"]
    for c in calls:
        if c["delta_count"] != 1 or c["recompile_count"] != 0:
            raise AssertionError(f"serve_churn: a {c['kind']} batch was not "
                                 f"absorbed as one delta: {c}")
    if any(c["route_holder_copies"] for c in bw):
        raise AssertionError("serve_churn: a bandwidth-only wave copied the "
                             "route topology layer")
    if logs[1].calls != calls or _contexts(cl) != _contexts(gl):
        raise AssertionError("serve_churn: the CPU run's deltas or walk "
                             "contexts differ")
    ctxs = _contexts(gl)
    # a bandwidth wave rebases the resident context, a death or a revival
    # drops it: one build, then one per death/revival, a rebase per wave
    if ctxs != dict(context_builds=1 + len(calls) - len(bw),
                    context_rebases=len(bw)):
        raise AssertionError(f"serve_churn: walk contexts {ctxs} under "
                             f"{len(bw)} bandwidth waves and "
                             f"{len(calls) - len(bw)} deaths/revivals")
    # the serving run's one-task requests run on their origin edge, so
    # its transfer kernels may see no churn: the device edge column's
    # refresh is held on a path of its own, card against CPU
    gf, ecounts = _edge_refresh(None)
    cf, _ = _edge_refresh("cpu")
    de = max(abs(a - b) for a, b in zip(gf, cf))
    if not de <= T_TOL or ecounts["transfer_reprice"] <= 0:
        raise AssertionError(f"serve_churn: transfers under a bandwidth "
                             f"churn differ card vs CPU by {de}, "
                             f"{ecounts['transfer_reprice']} reprices")
    out = _serve_line(gs, g, counts, syncs, dt, cs)
    out.update(mult=CHURN_MULT, churn_batches=calls, **ctxs,
               edge_refresh=dict(finish=gf, max_finish_diff_cuda_vs_cpu=de,
                                 transfer_reprice=ecounts["transfer_reprice"],
                                 transfer_complete=ecounts[
                                     "transfer_complete"]),
               recompile_count=g.recompile_count, delta_count=g.delta_count,
               route_holder_copies=g.route_holder_copies,
               route_overlay_copies=g.route_overlay_copies,
               transfer_reprice=counts["transfer_reprice"])
    return out, counts


def _bwchurn(mult: int, device, n_waves: int = 8):
    """benchmarks/des.py::_bwchurn on the port: seeded uplink degrade /
    recover ``Churn`` waves interleaved with mapping waves over the mining
    fleet; each wave ``session.churn(wave)``, then
    ``mining_workload(n_sensors=12 mult / n_waves, n_readings=1)`` and
    ``map_pending()``.  Returns (session, cfgs, per-wave map seconds,
    counter deltas, with the walk contexts (built, rebased) per wave)."""
    ec, sc = mining_counts(mult)
    tb = core.build_testbed(edge_counts=ec, server_counts=sc, device=device)
    g = tb.graph
    g.compiled()                         # snapshot outside the churn timer
    root = core.build_orchestrators(g, core.heye_traverser(g))
    session = core.SchedulerSession(g, root)
    waves = core.wireless_churn_schedule(tb, n_waves, seed=CHURN_SEED)
    per_wave = max(1, (12 * mult) // n_waves)
    before = {k: getattr(g, k) for k in _ChurnLog.KEYS}
    cfgs, secs, ctxs = [], [], []
    for churn in waves:
        t0 = time.perf_counter()
        b0, r0 = root.context_builds, root.context_rebases
        session.churn(churn)
        cfg = mining_workload(tb, n_sensors=per_wave, n_readings=1)
        session.submit(cfg)
        session.map_pending()
        if g.device.type == "cuda":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        cfgs.append(cfg)
        ctxs.append((root.context_builds - b0, root.context_rebases - r0))
    moved = {k: getattr(g, k) - before[k] for k in _ChurnLog.KEYS}
    moved["contexts_per_wave"] = ctxs
    return session, cfgs, secs, moved


def bwchurn_x128() -> tuple[dict, dict]:
    """The bandwidth-churn mapping driver at full width, card vs CPU."""
    reset_counts()
    gsess, gcfgs, gsecs, gmoved = _bwchurn(BWCHURN_MULT, None)
    counts = read_counts()
    syncs = rt_device.sync_count()
    csess, ccfgs, csecs, cmoved = _bwchurn(BWCHURN_MULT, "cpu")
    n_waves = len(gcfgs)
    # every wave is bandwidth-only: one context built, then rebased
    want_ctx = [(1, 0)] + [(0, 1)] * (n_waves - 1)
    for what, moved in (("card", gmoved), ("CPU", cmoved)):
        if moved["delta_count"] != n_waves or moved["recompile_count"] \
                or moved["route_holder_copies"] \
                or moved["contexts_per_wave"] != want_ctx:
            raise AssertionError(f"bwchurn_x{BWCHURN_MULT} ({what}): "
                                 f"{moved} over {n_waves} waves")
    for sess in (gsess, csess):
        if sess.unmapped:
            raise AssertionError(f"bwchurn_x{BWCHURN_MULT}: "
                                 f"{len(sess.unmapped)} tasks unmapped")
    gp = [gsess.mapping[t.uid] for cfg in gcfgs for t in cfg]
    cp = [csess.mapping[t.uid] for cfg in ccfgs for t in cfg]
    if gp != cp:
        bad = [i for i, (a, b) in enumerate(zip(gp, cp)) if a != b]
        raise AssertionError(f"bwchurn_x{BWCHURN_MULT}: card and CPU "
                             f"placements differ at {bad[:5]}")
    n_tasks = len(gp)
    if n_tasks != 12 * BWCHURN_MULT * 3:
        raise AssertionError(f"bwchurn_x{BWCHURN_MULT}: {n_tasks} tasks")
    # each wave's entry scans (B4b), the fused re-walks (rewalk_entry) and
    # the walk's other single scans (B4)
    for name in ("scan_reduce", "scan_reduce_batch", "rewalk_entry"):
        if counts[name] <= 0:
            raise AssertionError(f"bwchurn_x{BWCHURN_MULT}: kernel {name} "
                                 "was never launched")
    out = dict(mult=BWCHURN_MULT, waves=n_waves, tasks=n_tasks,
               map_s_per_wave=gsecs, map_s=sum(gsecs),
               tasks_per_s=n_tasks / sum(gsecs),
               cpu_map_s_per_wave=csecs, cpu_tasks_per_s=n_tasks / sum(csecs),
               placements_identical=True, unmapped=0, **gmoved,
               device_to_host_syncs=syncs, launches=counts)
    return out, counts


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


# model_families: the configs the port runs beyond recurrentgemma, at full
# width and depth (granite-moe-1b-a400m ~1.4 B parameters, rwkv6-1.6b ~1.8
# B, whisper-large-v3 ~2.0 B with its encoder, phi-3-vision-4.2b ~3.8 B),
# each with its prompt length: S = 4096, whisper's published text context
# of 448 tokens (over the encoder's 1500 frames)
FAMILIES = (("granite-moe-1b-a400m", 4096), ("rwkv6-1.6b", 4096),
            ("whisper-large-v3", 448), ("phi-3-vision-4.2b", 4096))
FAMILY_DECODE = 16


def _family_batch(cfg, B: int, S: int, dev, seed: int,
                  dtype: torch.dtype) -> dict:
    """Tokens and the frontend's inputs (``frames`` / ``patches``) of a
    prefill(B, S), shaped by ``configs/shapes.py``'s ``input_specs``; tokens
    uniform over the vocabulary, embeddings standard normal, from ``seed``."""
    specs = shapes.input_specs(cfg, shapes.Shape("model_families", S, B,
                                                 "prefill"), dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch = {}
    for name, spec in specs.items():
        if name == "tokens":
            batch[name] = torch.randint(0, cfg.vocab, spec.shape,
                                        generator=gen, device=dev)
        else:
            batch[name] = torch.randn(spec.shape, generator=gen,
                                      device=dev).to(spec.dtype)
    return batch


def _attention_layers(model) -> int:
    """B5 launches one prefill makes: an attention layer of the decoder
    stack, and of the encoder stack where there is one, launches once."""
    metas = list(_metas(model))
    if model.enc_sm is not None:
        sm = model.enc_sm
        metas += list(sm.metas * sm.n_super + sm.rem_metas)
    return sum(m["kind"] in ATTN_KINDS for m in metas)


def model_family(arch: str, S: int, seed: int) -> tuple[dict, dict]:
    """One config at full width and depth, seeded fp32 weights: the float32
    kernel route's prefill(1, S) logits against the plain route's, then a
    bfloat16 prefill(2, S) timed, its B5 launches counted, and
    FAMILY_DECODE decode steps; every logit finite."""
    cfg = get_config(arch)
    held = _fresh_peak()
    t0 = time.perf_counter()
    mk = build_model(cfg, ParallelCtx(compute_dtype=torch.float32))
    dev = mk.device
    params = mk.init(torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    batch1 = _family_batch(cfg, 1, S, dev, seed, torch.float32)
    mp = build_model(cfg, ParallelCtx(compute_dtype=torch.float32,
                                      use_kernels=False))
    last = {}
    t0 = time.perf_counter()
    for name, m in (("kernels", mk), ("plain", mp)):
        cache = m.init_cache(1, S, dtype=torch.float32)
        last[name], cache = m.prefill(params, batch1, cache)
        del cache
    torch.cuda.synchronize()
    fp32_s = time.perf_counter() - t0
    lk, lp = last["kernels"], last["plain"]
    if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
        raise AssertionError(f"model_families {arch}: non-finite float32 "
                             "logits")
    rms = float(lp.double().pow(2).mean().sqrt())
    err = _logit_err(lk, lp)
    if not err <= FULL_REL_TOL * rms:
        raise AssertionError(f"model_families {arch}: float32 kernel vs "
                             f"plain route differ by {err} (logit RMS {rms})")
    del last, lk, lp, batch1

    # the serving dtype: bfloat16 compute, kernels on, bfloat16 cache
    mb = build_model(cfg)
    B, n_dec = PATH_B, FAMILY_DECODE
    batch2 = _family_batch(cfg, B, S, dev, seed + 1, torch.bfloat16)

    def prefill():
        cache = mb.init_cache(B, S + n_dec)
        return mb.prefill(params, batch2, cache)
    prefill()                                      # warm: cuBLAS, allocator
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logits, cache = prefill()
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts = read_counts()
    counts["flash_attention_by_shape"] = dict(fa_kernel.launches_by_shape)
    want = {"flash_attention": _attention_layers(mb), "lru_scan": 0}
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"model_families {arch}: {name} launched "
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
        raise AssertionError(f"model_families {arch}: non-finite bfloat16 "
                             "logits")
    peak = torch.cuda.max_memory_allocated()
    inputs = {k: list(v.shape) for k, v in batch2.items()}
    del params, cache, logits, batch2
    torch.cuda.empty_cache()
    return dict(config=arch, params=n_params, init_s=init_s, inputs=inputs,
                fp32_check=dict(batch=1, seq=S, seconds=fp32_s,
                                max_abs_logit_err=err, logit_rms=rms,
                                rel_err=err / rms,
                                tolerance_rel_to_rms=FULL_REL_TOL),
                bf16=dict(batch=B, seq=S, prefill_s=prefill_s,
                          prefill_tok_per_s=B * S / prefill_s,
                          decode_steps=n_dec, decode_s=decode_s,
                          decode_tok_per_s=B * n_dec / decode_s),
                launches_per_prefill={k: counts[k] for k in MODEL_KERNELS},
                flash_attention_launches_by_shape={
                    " ".join(map(str, key)): n for key, n in
                    counts["flash_attention_by_shape"].items()},
                expected_launches=want,
                peak_device_bytes=peak, held_at_start_bytes=held), counts


def model_families(seed: int) -> tuple[dict, dict]:
    """Every family of ``FAMILIES`` in turn, each freeing its memory before
    the next.  Returns the phase's line and each config's launch counts."""
    out, counts = {}, {}
    for arch, S in FAMILIES:
        out[arch], counts[arch] = model_family(arch, S, seed)
    return out, counts


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
    # the placement's second tenant re-walks its origin chip in a fused
    # entry scan: the path's one check against actives, so B1's
    # same-device form runs inside that launch; nothing escalates, so B4
    # does not launch
    if counts["rewalk_entry"] <= 0:
        raise AssertionError("serve_full: rewalk_entry never launched")
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


# ---------------------------------------------------------------------------
# training (the plain route, as the reference trains)
# ---------------------------------------------------------------------------
TRAIN_SMOKE_ARCHS = ("gemma3-1b", "granite-moe-1b-a400m")
TRAIN_SMOKE_MICRO = (1, 2, 1)      # microbatches of the three steps
TRAIN_REL_TOL = 1e-5               # loss and grad_norm, card vs CPU
TRAIN_PARAM_TOL = 1e-5             # moments; parameters, plus the below
# Adam's step m_hat / (sqrt(v_hat) + eps) is ill conditioned where
# sqrt(v_hat) is near eps (1e-8): a gradient of 1e-9 that two sum orders
# give 1e-10 apart moves the step by a tenth of lr.  So a parameter is held
# to TRAIN_PARAM_TOL plus the sum over the steps so far of lr * |ratio_card
# - ratio_cpu|, the ratio computed in float64 from each side's own moments
# (themselves held to TRAIN_PARAM_TOL); that term passes TRAIN_PARAM_TOL on
# under 1 % of the parameters (held).  tests/test_torch_train.py holds the
# port against the reference the same way.
TRAIN_OPT = dict(lr=1e-2, warmup_steps=4, decay_steps=100)
TRAIN_FULL_ARCH = "gemma3-1b"
TRAIN_FULL_ARGS = ("--arch", TRAIN_FULL_ARCH, "--steps", "20", "--batch", "4",
                   "--seq", "1024", "--log-every", "5", "--ckpt-every", "20")
TRAIN_REMAT_TOL = 1e-3             # grad_norm, remat="block" vs "none"


def _adam_ratio(m: torch.Tensor, v: torch.Tensor, step: int,
                cfg) -> torch.Tensor:
    m, v = m.detach().cpu().double(), v.detach().cpu().double()
    return (m / (1 - cfg.b1 ** step)) / (
        torch.sqrt(v / (1 - cfg.b2 ** step)) + cfg.eps)


def _train_state_err(gs, cs, explained: list, lr: float, cfg) -> tuple:
    """(max |param diff| beyond what the moments explain, max |m| / |v|
    diff, the explained term per leaf after this step); raises where the
    explained term is wide on 1 % of the parameters or more."""
    step = int(cs["opt"]["step"])
    p_err = mv_err = 0.0
    out, n_wide, n = [], 0, 0
    for g, c, gm, gv, cm, cv, before in zip(
            *(train_tree.leaves(t) for t in (
                gs["params"], cs["params"], gs["opt"]["m"], gs["opt"]["v"],
                cs["opt"]["m"], cs["opt"]["v"])), explained):
        wide = before + lr * (_adam_ratio(gm, gv, step, cfg)
                              - _adam_ratio(cm, cv, step, cfg)).abs()
        out.append(wide)
        n_wide, n = n_wide + int((wide > TRAIN_PARAM_TOL).sum()), n + wide.numel()
        d = (g.detach().cpu().double() - c.detach().double()).abs() - wide
        p_err = max(p_err, float(d.max()))
        mv_err = max(mv_err, _logit_err(gm, cm), _logit_err(gv, cv))
    if n_wide >= 0.01 * n:
        raise AssertionError(f"train_smoke: Adam's step explains more than "
                             f"{TRAIN_PARAM_TOL} on {n_wide} of {n} "
                             "parameters")
    return p_err, mv_err, out


def train_smoke(seed: int) -> dict:
    """Three train steps (the second over two microbatches) of gemma3-1b and
    granite-moe-1b-a400m ``.smoke()`` in float32 on the card against the
    same steps on the CPU, from weights made on the CPU and copied."""
    out = {}
    reset_counts()
    for arch in TRAIN_SMOKE_ARCHS:
        cfg = get_config(arch).smoke()
        ctx = ParallelCtx(use_kernels=False, compute_dtype=torch.float32)
        opt_cfg = train_optim.OptConfig(**TRAIN_OPT)
        cm = build_model(cfg, ctx, device="cpu")
        gm = build_model(cfg, ctx)
        cparams = cm.init(torch.Generator().manual_seed(seed))
        states = {"cpu": {"params": cparams},
                  "cuda": {"params": tree_map(lambda t: t.to(gm.device, copy=True),
                                              cparams)}}
        for st in states.values():
            st["opt"] = train_optim.init_opt_state(st["params"], opt_cfg)
        it = train_data.synthetic_batches(train_data.DataConfig(
            batch=4, seq=32, vocab=cfg.vocab, seed=seed), cfg)
        batches = [next(it) for _ in TRAIN_SMOKE_MICRO]
        steps, explained = [], [0.0] * len(train_tree.leaves(cparams))
        for mb, batch in zip(TRAIN_SMOKE_MICRO, batches):
            mets = {}
            for name, m in (("cuda", gm), ("cpu", cm)):
                fn = train_step.make_train_step(m, opt_cfg, microbatches=mb)
                states[name], mets[name] = fn(states[name], batch)
            g, c = ({k: float(v) for k, v in mets[d].items()}
                    for d in ("cuda", "cpu"))
            rel = {k: abs(g[k] - c[k]) / max(abs(c[k]), 1e-30)
                   for k in ("loss", "grad_norm")}
            if not (max(rel.values()) <= TRAIN_REL_TOL and g["lr"] == c["lr"]
                    and abs(g["aux"] - c["aux"]) <= TRAIN_PARAM_TOL):
                raise AssertionError(f"train_smoke {arch}: card {g} vs CPU "
                                     f"{c}")
            p_err, mv_err, explained = _train_state_err(
                states["cuda"], states["cpu"], explained, c["lr"], opt_cfg)
            if not (p_err <= TRAIN_PARAM_TOL and mv_err <= TRAIN_PARAM_TOL):
                raise AssertionError(f"train_smoke {arch}: params {p_err}, "
                                     f"moments {mv_err} past "
                                     f"{TRAIN_PARAM_TOL}")
            steps.append(dict(microbatches=mb, loss=g["loss"], aux=g["aux"],
                              grad_norm=g["grad_norm"], rel_err=rel,
                              param_err_beyond_explained=p_err,
                              moment_err=mv_err,
                              explained_max=max(float(x.max())
                                                for x in explained),
                              explained_wide=sum(
                                  int((x > TRAIN_PARAM_TOL).sum())
                                  for x in explained)))
        out[arch] = steps
    counts = read_counts()
    if counts["flash_attention"] or counts["lru_scan"]:
        raise AssertionError(f"train_smoke launched a model kernel: {counts}")
    return dict(steps=out, tolerance=dict(
        rel=TRAIN_REL_TOL, abs=TRAIN_PARAM_TOL,
        params="abs + sum of lr * |adam ratio card - cpu|"),
        launches={k: counts[k] for k in MODEL_KERNELS})


def _train_flops(model, B: int, S: int, n_params: int) -> float:
    """6 N tokens plus the attention's score and value products (2 matmuls
    x 2 flops x hd per live (query, key) pair and head, forward; x3 with
    the backward)."""
    cfg = model.cfg
    pairs = 0
    for meta in _metas(model):
        if meta["kind"] == "local":
            pairs += sum(min(i + 1, cfg.window) for i in range(S))
        elif meta["kind"] in ATTN_KINDS:
            pairs += S * (S + 1) // 2
    attn = 3 * 4 * B * cfg.n_heads * cfg.hd * pairs
    return 6.0 * n_params * B * S + attn


def _grad_step(model, opt_cfg, state, batch) -> dict:
    """One train step on the card: loss, grad_norm, its ms (host clock to
    the loss's read, the allocator's cache emptied before) and the peak
    bytes above what was allocated before it."""
    fn = train_step.make_train_step(model, opt_cfg)
    base = _fresh_peak()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, m = fn(state, batch)
    loss = float(m["loss"])
    ms = (time.perf_counter() - t0) * 1e3
    return dict(loss=loss, grad_norm=float(m["grad_norm"]), ms=ms,
                peak_bytes=torch.cuda.max_memory_allocated(),
                bytes_before=base,
                peak_above_before=torch.cuda.max_memory_allocated() - base)


def _time_update(state, opt_cfg, seed: int, reps: int = 3) -> float:
    """ms of one ``adamw_update`` over the whole state (CUDA events), on
    seeded gradients of the parameters' shapes; the state is consumed."""
    dev = train_tree.leaves(state["params"])[0].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen,
                                           device=p.device) * 1e-3,
                     state["params"])
    opt = state["opt"]
    train_optim.adamw_update(state["params"], grads, opt, opt_cfg)   # warm
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(reps):
        _, opt, _ = train_optim.adamw_update(state["params"], grads, opt,
                                             opt_cfg)
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def train_full(seed: int) -> dict:
    """``repro_torch.launch.train`` on gemma3-1b at full width and depth
    (bf16 compute, fp32 master weights and AdamW state): 20 steps of the
    entry point's own path (data -> Prefetcher -> train step -> FTManager, a
    checkpoint of the whole state at step 20), then the checkpoint restored
    and compared bit for bit, one step more under ``remat="block"``
    against ``"none"``, and the forward-only guard on the card."""
    import contextlib
    import dataclasses
    import io
    import shutil
    import tempfile
    ckpt_dir = tempfile.mkdtemp(prefix="train_full_ckpt_")
    try:
        args = train_launch.parse_args(
            [*TRAIN_FULL_ARGS, "--ckpt-dir", ckpt_dir])
        base = _fresh_peak()
        reset_counts()
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rep = train_launch.run(args)
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        model, state = rep.model, rep.state
        if not (all(math.isfinite(x) for x in rep.losses + rep.grad_norms)
                and rep.losses[-1] < rep.losses[0]):
            raise AssertionError(f"train_full: losses {rep.losses}")
        n_params = sum(p.numel() for p in train_tree.leaves(state["params"]))
        B, S = args.batch, args.seq
        step_ms = statistics.median(rep.step_ms[4:])
        flops = _train_flops(model, B, S, n_params)
        out = dict(
            config=TRAIN_FULL_ARCH, params=n_params, batch=B, seq=S,
            steps=rep.steps[-1], wall_s=wall, step_ms=rep.step_ms,
            step_ms_median_5_20=step_ms,
            tokens_per_s=B * S / (step_ms * 1e-3),
            flops_per_step=flops,
            tflops_per_s=flops / (step_ms * 1e-3) / 1e12,
            bf16_peak_share=flops / (step_ms * 1e-3) / BF16_FLOPS,
            loss_first=rep.losses[0], loss_last=rep.losses[-1],
            losses=rep.losses, grad_norms=rep.grad_norms, lrs=rep.lrs,
            peak_device_bytes=peak, bytes_before=base,
            train_log=log.getvalue().splitlines())

        # the checkpoint launch.train's FTManager took at step 20, restored
        ckpt_bytes = sum(os.path.getsize(os.path.join(d, f))
                         for d, _, fs in os.walk(ckpt_dir) for f in fs)
        t1 = time.perf_counter()
        restored = train_ckpt.restore(ckpt_dir, state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
        n_leaves = 0
        for (key, a), b in zip(train_tree.flatten_with_paths(restored),
                               train_tree.leaves(state)):
            if not (a.dtype == b.dtype and a.device == b.device
                    and torch.equal(a, b)):
                raise AssertionError(f"train_full: checkpoint leaf {key} "
                                     "not restored bit for bit")
            n_leaves += 1
        del restored
        out["checkpoint"] = dict(
            step=rep.steps[-1], bytes=ckpt_bytes,
            save_s=rep.ckpt_seconds, restore_s=restore_s,
            leaves_equal=n_leaves, what="the whole state: params, m, v, step")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    # one step more, remat "none" (on a copy) against "block"
    it = train_data.synthetic_batches(train_data.DataConfig(
        batch=B, seq=S, vocab=model.cfg.vocab, seed=args.steps), model.cfg)
    batch = {k: torch.as_tensor(v).to(model.device)
             for k, v in next(it).items()}
    opt_cfg = train_optim.OptConfig(lr=args.lr, warmup_steps=max(
        args.steps // 20, 5), decay_steps=args.steps)
    copy = tree_map(torch.clone, state)
    none = _grad_step(model, opt_cfg, copy, batch)
    none["ms_second_call"] = _grad_step(model, opt_cfg, copy, batch)["ms"]
    update_ms = _time_update(copy, opt_cfg, seed)
    del copy
    block_model = build_model(model.cfg, dataclasses.replace(
        model.ctx, remat="block"))
    block = _grad_step(block_model, opt_cfg, state, batch)
    # the first checkpointed step pays a one-time warm-up: time a second
    block["ms_second_call"] = _grad_step(block_model, opt_cfg, state,
                                         batch)["ms"]
    del state, rep, model
    if block["loss"] != none["loss"]:
        raise AssertionError(f"train_full: remat loss {block['loss']} != "
                             f"{none['loss']}")
    gn_rel = abs(block["grad_norm"] - none["grad_norm"]) / none["grad_norm"]
    if not gn_rel <= TRAIN_REMAT_TOL:
        raise AssertionError(f"train_full: remat grad_norm rel err {gn_rel}")
    out.update(remat=dict(none=none, block=block, grad_norm_rel=gn_rel,
                          loss_equal=True, tolerance=TRAIN_REMAT_TOL),
               update_ms=update_ms, update_share=update_ms / step_ms)

    # the forward-only guard, on the card
    dev = torch.device("cuda", 0)
    q = torch.randn((1, 64, 4, 256), device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    a = torch.rand((1, 64, 128), device=dev, requires_grad=True)
    for name, call in (
            ("flash_attention",
             lambda: fa_kernel.flash_attention(q, q.detach(), q.detach())),
            ("lru_scan", lambda: lru_kernel.lru_scan(a, a.detach()))):
        try:
            call()
        except RuntimeError as e:
            if "use_kernels=False" not in str(e):
                raise
        else:
            raise AssertionError(f"train_full: {name} took a tensor that "
                                 "requires grad")
    after = read_counts()
    if any(counts[k] or after[k] for k in MODEL_KERNELS):
        raise AssertionError(f"train_full launched a model kernel: "
                             f"{counts} {after}")
    out["launches"] = {k: counts[k] + after[k] for k in MODEL_KERNELS}
    out["guard_raised"] = ["flash_attention", "lru_scan"]
    _fresh_peak()
    return out


PLACEMENT_MESHES = (((16, 16), ("data", "model")),
                    ((2, 16, 16), ("pod", "data", "model")))
TRAIN_MESH_ARGS = ("--arch", TRAIN_FULL_ARCH, "--steps", "10", "--batch", "4",
                   "--seq", "1024", "--log-every", "100", "--ckpt-every",
                   "100")
TRAIN_MESH_TOL = 1e-6              # per-step loss, mesh of one vs plain
# the dry run's cells: a train cell on the pod mesh, a decode cell and a
# prefill cell on two pods, each in a process of its own (the fake group
# is process-global)
DRYRUN_CELLS = (("gemma3-1b", "train_4k", "single"),
                ("granite-moe-1b-a400m", "decode_32k", "multi"),
                ("rwkv6-1.6b", "prefill_32k", "multi"))
DRYRUN_TIMEOUT_S = 600
# the reference's dry run of every cell (``python -m repro.launch.dryrun
# --all --mesh both`` on the CPU, trimmed by
# tests/data/make_torch_dryrun_reference.py): the card's host has no JAX
DRYRUN_REFERENCE = os.path.join("tests", "data",
                                "torch_dryrun_reference.json")
DRYRUN_PEAK_RATIO = 4.0            # port peak / the reference's, at most


def placement() -> dict:
    """The placement search over every config x shape on both production
    meshes, on the host: the plans, and the cells no plan fits (notes)."""
    plans, notes = {}, []
    t0 = time.perf_counter()
    for arch in all_configs():
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            for mesh_shape, axes in PLACEMENT_MESHES:
                plan, cost = placement_mod.choose_plan(cfg, shape,
                                                       mesh_shape, axes)
                key = f"{arch}|{sname}|{'multi' if len(axes) == 3 else 'single'}"
                plans[key] = f"{plan.describe()} {cost.mem_bytes / 1e9:.2f}GB"
                if plan.notes:
                    notes.append(key)
    return dict(cells=len(plans), cells_with_notes=len(notes), notes=notes,
                seconds=time.perf_counter() - t0, plans=plans,
                budget="the planner's v5e chip: 0.9 x 16 GB (not the card)")


def _plain_train(args, steps: int) -> tuple[list, list]:
    """The steps ``launch.train`` runs, on plain tensors: (losses, step
    ms by CUDA events)."""
    cfg = get_config(args.arch)
    model = build_model(cfg, ParallelCtx(use_kernels=False,
                                         compute_dtype=torch.bfloat16))
    dev = model.device
    opt_cfg = train_optim.OptConfig(lr=args.lr,
                                    warmup_steps=max(args.steps // 20, 5),
                                    decay_steps=args.steps)
    state = train_step.init_train_state(
        model, torch.Generator(device=dev).manual_seed(0), opt_cfg)
    step = train_step.make_train_step(model, opt_cfg)
    data = train_data.synthetic_batches(train_data.DataConfig(
        batch=args.batch, seq=args.seq, vocab=cfg.vocab, seed=0), cfg)
    losses, ev = [], [torch.cuda.Event(enable_timing=True)]
    ev[0].record()
    for _ in range(steps):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in next(data).items()}
        state, m = step(state, batch)
        losses.append(m["loss"])
        ev.append(torch.cuda.Event(enable_timing=True))
        ev[-1].record()
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
    return [float(x) for x in losses], ms


def train_mesh() -> dict:
    """``repro_torch.launch.train`` on gemma3-1b at full width on the card's
    mesh of one, (1, 1) over NCCL: 10 steps of 4 x 1024, each step's loss
    against the same steps on plain tensors, and the median step ms of
    both (what DTensor dispatch costs a step)."""
    import contextlib
    import io
    import shutil
    import tempfile
    ckpt_dir = tempfile.mkdtemp(prefix="train_mesh_ckpt_")
    try:
        args = train_launch.parse_args([*TRAIN_MESH_ARGS, "--ckpt-dir",
                                        ckpt_dir])
        _fresh_peak()
        reset_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            rep = train_launch.run(args)
        counts = read_counts()
        mesh_peak = torch.cuda.max_memory_allocated()
        del rep.state, rep.ft
        rep.model = None
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    _fresh_peak()
    losses, plain_ms = _plain_train(args, len(rep.losses))
    plain_peak = torch.cuda.max_memory_allocated()
    rel = [abs(a - b) / abs(b) for a, b in zip(rep.losses, losses)]
    if not max(rel) <= TRAIN_MESH_TOL:
        raise AssertionError(f"train_mesh: losses {rep.losses} against "
                             f"plain {losses}")
    if any(counts[k] for k in MODEL_KERNELS):
        raise AssertionError(f"train_mesh launched a model kernel: {counts}")
    mesh_ms = statistics.median(rep.step_ms[2:])
    plain_med = statistics.median(plain_ms[2:])
    _fresh_peak()
    return dict(config=TRAIN_FULL_ARCH, batch=args.batch, seq=args.seq,
                steps=len(rep.losses), mesh="(1, 1) data x model, NCCL",
                losses_mesh=rep.losses, losses_plain=losses,
                max_rel_loss_diff=max(rel), bit_equal=rep.losses == losses,
                tolerance=TRAIN_MESH_TOL,
                step_ms_mesh=rep.step_ms, step_ms_plain=plain_ms,
                step_ms_median_3_10_mesh=mesh_ms,
                step_ms_median_3_10_plain=plain_med,
                dtensor_ms_per_step=mesh_ms - plain_med,
                peak_bytes_mesh=mesh_peak, peak_bytes_plain=plain_peak)


def dryrun() -> dict:
    """``python -m repro_torch.launch.dryrun`` on the cells, each in a
    process of its own, started together; each must end ok with a useful
    FLOP ratio in (0, 1] (a prefill's counted FLOPs at least the model
    FLOPs less the unembedding of every position but the last), and its
    peak at most ``DRYRUN_PEAK_RATIO`` times the reference's
    (``DRYRUN_REFERENCE``); the port / reference ratios of peak, FLOPs
    and collective bytes are printed.  Host only: the steps run on fake
    tensors."""
    import tempfile
    out = {}
    reference = os.path.join(TREE, DRYRUN_REFERENCE)
    ref_cells = json.load(open(reference))["cells"]
    env = dict(os.environ, PYTHONPATH=os.path.join(TREE, "src"))
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        procs = []
        t0 = time.perf_counter()
        for arch, shape, mesh in DRYRUN_CELLS:
            path = os.path.join(tmp, f"{arch}_{shape}_{mesh}.json")
            log = open(path + ".log", "w")
            procs.append((arch, shape, mesh, path, log, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--mesh", mesh, "--out", path,
                 "--reference", reference],
                env=env, stdout=log, stderr=subprocess.STDOUT)))
        try:
            for arch, shape, mesh, path, log, proc in procs:
                proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S
                                      - (time.perf_counter() - t0)))
        finally:
            for *_, log, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
        wall = time.perf_counter() - t0
        for arch, shape, mesh, path, _, proc in procs:
            key = f"{arch}|{shape}|{mesh}"
            if proc.returncode != 0 or not os.path.exists(path):
                tail = open(path + ".log").read()[-3000:]
                raise AssertionError(f"dryrun {key}: exit {proc.returncode}"
                                     f"\n{tail}")
            rec = json.load(open(path))[f"{key}|baseline"]
            terms = rec["roofline"]
            cfg, sh = get_config(arch), SHAPES[shape]
            tokens = sh.global_batch * (1 if sh.mode == "decode"
                                        else sh.seq_len)
            # a prefill unembeds each row's last position only
            skipped = (2.0 * (tokens - sh.global_batch) * cfg.d_model
                       * cfg.vocab if sh.mode == "prefill" else 0.0)
            if not (rec["status"] == "ok"
                    and 0.0 < terms["useful_flops_ratio"]
                    and terms["hlo_flops_total"]
                    >= terms["model_flops_total"] - skipped):
                raise AssertionError(f"dryrun {key}: {rec.get('status')} "
                                     f"ratio {terms['useful_flops_ratio']}")
            vs = rec["reference"]
            print(f"dryrun {key} against the reference: peak "
                  f"{vs['peak_gb'][0]:.3f} / {vs['peak_gb'][1]:.3f} GB = "
                  f"{vs['peak_ratio']:.3f}, FLOPs {vs['flops_ratio']:.3f}, "
                  f"collective bytes {vs['collective_ratio']:.3f}",
                  flush=True)
            if not vs["peak_ratio"] <= DRYRUN_PEAK_RATIO:
                raise AssertionError(f"dryrun {key}: peak {vs['peak_gb']} "
                                     f"GB, {vs['peak_ratio']:.2f}x the "
                                     f"reference's")
            if ref_cells[key]["plan"] != rec["plan"]:
                raise AssertionError(f"dryrun {key}: plan {rec['plan']}")
            n = math.prod(16 if a != "pod" else 2 for a in
                          (("pod", "data", "model") if mesh == "multi"
                           else ("data", "model")))
            out[key] = dict(
                status=rec["status"], plan=rec["plan"],
                counted=rec.get("counted", "the step once"),
                flops_per_device=terms["hlo_flops_total"] / n,
                model_flops_total=terms["model_flops_total"],
                useful_flops_ratio=terms["useful_flops_ratio"],
                collective_bytes_per_device=terms["collective_breakdown"],
                collective_count=rec["collective_count"],
                peak_gb_per_device=rec["memory"]["peak_gb"],
                argument_gb_per_device=rec["memory"]["argument_gb"],
                fits_16gb=rec["memory"]["fits_hbm"],
                gathered=rec["gathered"], build_s=rec["build_s"],
                run_s=rec["run_s"], vs_reference=vs,
                v5e_planner_terms_s=dict(
                    compute=terms["t_compute_s"], memory=terms["t_memory_s"],
                    collective=terms["t_collective_s"],
                    bound=terms["bottleneck"]))
    return dict(cells=out, wall_s=wall,
                note="counts per fake device; the v5e terms are the "
                     "reference's planner model, not the card")


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


def session_turn(kind: str, seed: int) -> dict:
    """One turn of :func:`compare`, in a process of its own on the port of
    the tree ``--tree`` names, through the entry points both trees share:
    a small warm-up session, the timed one (``kind`` "vr": the paper's
    testbed at 30 frames, warm-up 2; "x128": the mining fleet at full
    width, warm-up mult=8), then the timed one once more under
    torch.profiler for its device-op count."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    def run(small: bool):
        if kind == "vr":
            return run_vr(None, 2 if small else 30, None, seed)
        return run_session(8 if small else FULL_MULT, None, seed)
    run(True)
    stats, cfg, _, _, secs = run(False)
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        run(False)
        torch.cuda.synchronize()
    placements, finish = by_order(stats, cfg)
    return dict(secs, tasks=len(cfg), unmapped=len(stats.unmapped),
                placements=placements, finish=finish,
                device_ops=len(_device_events(prof)))


FLASH_PREFILL_REPS = 5      # timed bf16 prefills of a family in a turn


def _family_prefill(arch: str, S: int, seed: int):
    """A family's bfloat16 prefill(PATH_B, S) at full width and depth (the
    serving route of ``model_families``: seeded weights, kernels on), as a
    callable, warmed once."""
    cfg = get_config(arch)
    mb = build_model(cfg)
    dev = mb.device
    params = mb.init(torch.Generator(device=dev).manual_seed(seed))
    batch = _family_batch(cfg, PATH_B, S, dev, seed + 1, torch.bfloat16)

    def prefill():
        return mb.prefill(params, batch, mb.init_cache(PATH_B, S))[0]
    prefill()
    torch.cuda.synchronize()
    return prefill


def family_prefill_s(arch: str, S: int, seed: int) -> dict:
    """The median of FLASH_PREFILL_REPS timed prefills of
    :func:`_family_prefill` and the B5 launches of one."""
    prefill = _family_prefill(arch, S, seed)
    secs = []
    for _ in range(FLASH_PREFILL_REPS):
        reset_counts()
        t0 = time.perf_counter()
        logits = prefill()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch}: non-finite bfloat16 logits")
    launches = fa_kernel.launches
    del prefill, logits
    torch.cuda.empty_cache()
    return dict(prefill_s=statistics.median(secs), runs=secs,
                flash_attention_launches=launches)


def family_prefill_device_ms(arch: str, S: int, seed: int) -> dict:
    """One prefill of :func:`_family_prefill` under torch.profiler: the
    device's busy time (the union of its events) and B5's share of it.
    The wall time of these prefills is the host's (the MoE and frontend
    glue at B=2); the busy time is what a kernel moves."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    prefill = _family_prefill(arch, S, seed)
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        prefill()
        torch.cuda.synchronize()
    events = _device_events(prof)
    busy, end = 0, None
    for start, stop, _ in events:
        if end is None or start > end:
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    flash = sum(e - s_ for s_, e, name in events
                if "flash_attention_tc_kernel" in name)
    del prefill
    torch.cuda.empty_cache()
    return dict(device_busy_ms=busy / 1e6, flash_attention_ms=flash / 1e6)


def flash_turn(seed: int) -> dict:
    """One turn of ``--compare --session flash``, on the port of ``--tree``:
    the bf16 prefill seconds of each family that runs B5, then B5's rows
    at the path's shape and at every family shape (:func:`flash_row`: each
    held fp32 and bf16 against the plain version, then ``ms``, ``body_ms``
    and SDPA's ``library_ms``), then each family's prefill once more under
    torch.profiler for its device time (the traces last: nothing is timed
    after one)."""
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)
    families = dict(FAMILIES)
    archs = sorted({f["arch"] for f in family_flash_shapes()})
    prefill = {arch: family_prefill_s(arch, families[arch], seed)
               for arch in archs}
    rows = [flash_row(dev, rng, "flash_attention", PATH_B, PATH_S, 16, 1, 256,
                      window=2048), *check_flash_families(dev, rng)]
    measure_bodies(rows)
    for arch in archs:
        prefill[arch].update(family_prefill_device_ms(arch, families[arch],
                                                      seed))
    return dict(
        rows={r["name"]: dict(shape=r["shape"], ms=r["ms"],
                              body_ms=r["body_ms"], bound_ms=r["bound_ms"],
                              library_ms=r["library_ms"]) for r in rows},
        prefill=prefill)


def _flash_summary(runs: dict) -> dict:
    """Per B5 row, each tree's medians; per family, each tree's prefill
    seconds and (device busy ms, B5 ms) of every turn."""
    out: dict = {"rows": {}, "prefill_s": {}, "prefill_device_ms": {}}
    first = runs["parent"][0]
    for name in first["rows"]:
        out["rows"][name] = {"shape": first["rows"][name]["shape"]}
        for key in ("ms", "body_ms", "library_ms"):
            for tree in ("parent", "change"):
                xs = [r["rows"][name][key] for r in runs[tree]]
                if None not in xs:
                    out["rows"][name][f"{tree}_{key}"] = statistics.median(xs)
    for arch in first["prefill"]:
        out["prefill_s"][arch] = {
            tree: [r["prefill"][arch]["prefill_s"] for r in runs[tree]]
            for tree in ("parent", "change")}
        out["prefill_device_ms"][arch] = {
            tree: [(r["prefill"][arch]["device_busy_ms"],
                    r["prefill"][arch]["flash_attention_ms"])
                   for r in runs[tree]] for tree in ("parent", "change")}
    return out


def compare(parent: str, kind: str, pairs: int, seed: int) -> None:
    """Parent tree against this one on one session (``kind`` "vr" or
    "x128"), each run a :func:`session_turn` in a fresh process, in turns
    (parent, change, change, parent, ...) for ``pairs`` pairs: map and
    execute seconds per run, each tree's device-op count, and the results
    held equal (placements identical, finish times within 1e-9).  ``kind``
    "flash" runs :func:`flash_turn` instead: B5's times and the families'
    prefill seconds per tree (each tree's kernel held against its plain
    version inside the turn)."""
    trees = {"parent": os.path.abspath(parent), "change": HERE}
    order = [("parent", "change") if i % 2 == 0 else ("change", "parent")
             for i in range(pairs)]
    runs: dict = {"parent": [], "change": []}
    for turn in order:
        for name in turn:
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--session-turn",
                 kind, "--seed", str(seed), "--tree", trees[name]],
                capture_output=True, text=True, check=True).stdout
            r = json.loads(out.strip().splitlines()[-1])["session_turn"]
            runs[name].append(r)
            emit("compare_turn", dict(tree=name, session=kind, **(
                r if kind == "flash" else dict(
                    map_pending_s=r["map_pending_s"],
                    execute_s=r["execute_s"], device_ops=r["device_ops"]))))
    if kind == "flash":
        emit("compare_flash", dict(pairs=pairs, **_flash_summary(runs)))
        return
    ref = runs["parent"][0]
    for r in runs["parent"] + runs["change"]:
        dt = max(abs(a - b) for a, b in zip(r["finish"], ref["finish"]))
        if r["placements"] != ref["placements"] or not dt <= T_TOL \
                or r["unmapped"]:
            raise AssertionError(f"compare {kind}: the trees' sessions "
                                 "differ")
    summary = {}
    for key in ("map_pending_s", "execute_s", "device_ops"):
        p = [r[key] for r in runs["parent"]]
        c = [r[key] for r in runs["change"]]
        summary[key] = dict(parent=p, change=c,
                            parent_median=statistics.median(p),
                            change_median=statistics.median(c),
                            change_lower_pairs=sum(b < a for a, b in
                                                   zip(p, c)))
    emit(f"compare_{kind}", dict(pairs=pairs, tasks=ref["tasks"], **summary))


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
    ap.add_argument("--compare", default=None, metavar="PARENT",
                    help="instead of the checks: a session of the tree at "
                         "PARENT against this one's, in turns, each run in "
                         "a fresh process; prints no ok line")
    ap.add_argument("--session", default="vr",
                    choices=("vr", "x128", "flash"),
                    help="the session --compare runs (flash: B5's rows and "
                         "the bf16 prefills of the families that run it)")
    ap.add_argument("--pairs", type=int, default=4,
                    help="parent/change pairs of --compare")
    ap.add_argument("--session-turn", default=None,
                    choices=("vr", "x128", "flash"),
                    help="one turn of --compare: the session's line, on the "
                         "port of --tree")
    ap.add_argument("--tree", default=HERE,
                    help="the tree whose port --session-turn runs")
    ap.add_argument("--out", default="profile_out",
                    help="directory for the profiles' files")
    ap.add_argument("--stop-after", default=None,
                    choices=("kernels", "model_x_smoke", "x8", "walk_oracle",
                             "vr", "x128", "serve_x64", "serve_churn",
                             "bwchurn_x128", "model_full",
                             "model_families", "train_smoke", "train_full",
                             "placement", "train_mesh", "dryrun"),
                    help="debugging: end (without the ok line) after a phase")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: "
                         "torch.cuda.is_available() is False")
    # float32 means float32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.session_turn:
        emit("session_turn", flash_turn(args.seed)
             if args.session_turn == "flash"
             else session_turn(args.session_turn, args.seed))
        return
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
    if args.compare:
        compare(args.compare, args.session, args.pairs, args.seed)
        raise SystemExit("comparison run: no result line")
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
    wide_tables = _sd_tables(dev, rng, WIDE_R)
    kernels = [check_slowdown(dev, rng),
               check_slowdown_pool(dev, rng, tables, wide_tables),
               check_slowdown_same_device(dev, rng, tables, wide_tables),
               check_rate_advance(dev, rng),
               *check_settle(dev, rng), check_segment_min(dev, rng),
               *check_transfer(dev, rng), *check_scan_reduce(dev, rng),
               check_rewalk_entry(dev)]
    del tables, wide_tables
    for k in kernels:
        if not (k["max_rel_err"] <= REL_TOL):
            raise AssertionError(
                f"kernel {k['name']} disagrees with its plain version: "
                f"rel err {k['max_rel_err']}")
        k.setdefault("tolerance",
                     f"decisions exact, floats <= {REL_TOL} relative")
    # B5 and B6 raise inside their checks, against their own tolerances
    kernels += [check_flash(dev, rng),
                *check_flash_families(dev, rng),
                check_lru(dev, rng)]

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
    wo, ocounts = walk_oracle(args.seed)
    emit("walk_oracle", wo)
    done("walk_oracle")
    stop("walk_oracle")
    vr, vcounts = session_vr(args.seed)
    emit("session_vr", vr)
    done("vr")
    stop("vr")
    full, counts, fcounts = session_full(args.seed)
    emit(f"session_x{FULL_MULT}", full)
    done(f"x{FULL_MULT}")
    stop("x128")
    sv, scounts, kcounts = serve_x64()
    emit(f"serve_x{SERVE_MULT}", sv)
    done(f"serve_x{SERVE_MULT}")
    stop("serve_x64")
    sc, ccounts = serve_churn()
    emit("serve_churn", sc)
    done("serve_churn")
    stop("serve_churn")
    bw, bcounts = bwchurn_x128()
    emit(f"bwchurn_x{BWCHURN_MULT}", bw)
    done(f"bwchurn_x{BWCHURN_MULT}")
    stop("bwchurn_x128")
    mfull, mcounts = model_full(args.seed)
    emit("model_full", mfull)
    done("model_full")
    stop("model_full")
    fam, famcounts = model_families(args.seed)
    emit("model_families", fam)
    done("model_families")
    stop("model_families")
    emit("serve_full", serve_full(args.seed))
    done("serve_full")
    emit("train_smoke", train_smoke(args.seed))
    done("train_smoke")
    stop("train_smoke")
    emit("train_full", train_full(args.seed))
    done("train_full")
    stop("train_full")
    emit("placement", placement())
    done("placement")
    stop("placement")
    emit("train_mesh", train_mesh())
    done("train_mesh")
    stop("train_mesh")
    emit("dryrun", dryrun())
    done("dryrun")
    stop("dryrun")
    # the traces, after every timed phase
    measure_bodies(kernels)
    done("bodies")
    emit(f"session_x{FULL_MULT}_traced", session_traced(args.seed))
    done(f"x{FULL_MULT}_traced")

    # launches: each kernel's count from the run of its own path
    for k in kernels:
        if "model" in k:
            # a B5 row at a family's shape: the launches of that family's
            # prefill at this row's shape, one per layer there
            k["launches"] = famcounts[k["model"]]["flash_attention_by_shape"
                                                 ].get(tuple(k["launch_key"]), 0)
            if k["launches"] != k["layers_at_shape"]:
                raise AssertionError(
                    f"{k['name']}: {k['launches']} launches at its shape in "
                    f"the prefill, expected {k['layers_at_shape']}")
            continue
        k["launches"] = (mcounts if k["name"] in MODEL_KERNELS else
                         vcounts if k["name"] in VR_KERNELS
                         else counts)[k["name"]]
        # and from each scheduler path of its own run (counts set to 0
        # just before the path, read just after)
        if k["name"] not in MODEL_KERNELS:
            k["launches_by_path"] = {
                f"x{FULL_MULT}": counts[k["name"]],
                f"x{FULL_MULT}_fused": fcounts[k["name"]],
                "walk_oracle": ocounts[k["name"]],
                "vr": vcounts[k["name"]],
                f"serve_x{SERVE_MULT}": scounts[k["name"]],
                f"serve_x{SERVE_MULT}_cold": kcounts[k["name"]],
                "serve_churn": ccounts[k["name"]],
                f"bwchurn_x{BWCHURN_MULT}": bcounts[k["name"]]}
        if k["name"] in OFF_PATH_KERNELS:
            k["on_main_path"] = False
            k["path_runs_instead"] = OFF_PATH_KERNELS[k["name"]]
    emit("total", dict(seconds=time.perf_counter() - t_start,
                       phases=phases))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
