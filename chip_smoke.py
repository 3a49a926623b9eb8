#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card, then drives
the port's main path — the offline scheduler session (map -> execute) on
the Fig. 13 mining fleet — at mult=8 (card vs CPU vs the port's own
reference event loop) and at full width, mult=128 (8448 PUs, 4608
tasks).  One JSON object per line; the last line is
``{"ok": true, "device": {...}}``.  Any failing phase raises, and the
script exits non-zero without printing a result.  Without a CUDA device
it fails at once: there is no CPU path.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np          # noqa: E402
import torch                # noqa: E402

import repro_torch.core as core                              # noqa: E402
from repro_torch import device as rt_device                  # noqa: E402
from repro_torch.core.workloads import mining_workload       # noqa: E402
from repro_torch.kernels import (build, slowdown_kernel,     # noqa: E402
                                 timeline_kernel, walk_kernel)

# published peaks of one H100 SXM (NVIDIA data sheet): device memory rate
# and the float64 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12
REL_TOL = 1e-12             # floats against the plain version (decisions exact)
T_TOL = 1e-9                # finish times: card vs CPU, fused vs reference


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
def check_slowdown(dev, rng) -> dict:
    kappa = 0.12
    worst = (0.0, 0.0)
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
        e = max_err(got, ref)
        worst = (max(worst[0], e[0]), max(worst[1], e[1]))
    ms = time_ms(lambda: slowdown_kernel.slowdown_factors(*args, kappa))
    plain = time_ms(lambda: slowdown_kernel.slowdown_factors_plain(*args, kappa))
    n, r = 4223, 6
    nbytes = 8 * (n * r + r + 3 * n)
    flops = n * (r * 6 + 2)
    return dict(name="slowdown_factors", route="cuda",
                source="src/repro_torch/kernels/csrc/slowdown_factors.cu",
                replaces="src/repro/kernels/slowdown_kernel.py:47",
                shape=f"N={n} R={r}", max_abs_err=worst[0],
                max_rel_err=worst[1], ms=ms, plain_ms=plain,
                **bound(nbytes, flops), library_ms=None)


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


def check_rate_advance(dev, rng) -> list[dict]:
    worst = [(0.0, 0.0), (0.0, 0.0)]
    for n in (5, 384, 4608):
        args, now = _ra_inputs(dev, rng, n)
        W2, eta = timeline_kernel.rate_advance(*args, now)
        rW, reta = timeline_kernel.rate_advance_plain(*args, now)
        s = timeline_kernel.settle(*args, now)
        rs = timeline_kernel.settle_plain(*args, now)
        torch.cuda.synchronize()
        for i, e in ((0, max_err(W2, rW)), (0, max_err(eta, reta)),
                     (1, max_err(s, rs))):
            worst[i] = (max(worst[i][0], e[0]), max(worst[i][1], e[1]))
    out = []
    for form, n, idx in (("rate_advance", 384, 0), ("settle", 4608, 1)):
        args, now = _ra_inputs(dev, rng, n)
        if form == "rate_advance":
            ms = time_ms(lambda: timeline_kernel.rate_advance(*args, now))
            plain = time_ms(
                lambda: timeline_kernel.rate_advance_plain(*args, now))
            nbytes, flops = 8 * 5 * n, 5 * n
        else:
            ms = time_ms(lambda: timeline_kernel.settle(*args, now))
            plain = time_ms(lambda: timeline_kernel.settle_plain(*args, now))
            nbytes, flops = 8 * 4 * n, 3 * n
        out.append(dict(
            name="rate_advance" if form == "rate_advance"
            else "rate_advance_settle", route="cuda",
            source="src/repro_torch/kernels/csrc/rate_advance.cu",
            replaces="src/repro/kernels/timeline_kernel.py:59",
            shape=f"N={n}", max_abs_err=worst[idx][0],
            max_rel_err=worst[idx][1], ms=ms, plain_ms=plain,
            **bound(nbytes, flops), library_ms=None))
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
                max_rel_err=worst[1], ms=ms, plain_ms=plain,
                **bound(nbytes, K), library_ms=lib)


def _scan_inputs(dev, rng, n_dev, per_dev, mode):
    """A two-level plan: root + n_dev device nodes of per_dev PUs."""
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
    lo = [0] + [d * per_dev for d in range(n_dev)]
    hi = [P] + [(d + 1) * per_dev for d in range(n_dev)]
    if n_dev == 1:                       # a device scan: the root owns the PUs
        lo, hi, leaf, nch = [0], [P], [P], [0]
        hop, dep = [0.0], [0.0]
    else:
        leaf = [0] + [per_dev] * n_dev
        nch = [n_dev] + [0] * n_dev
        hop = [float(rng.uniform(1e-4, 1e-3))] + [0.0] * n_dev
        dep = [0.0] + [1.0] * n_dev
    t = lambda a, dt: torch.as_tensor(np.asarray(a, dtype=dt), device=dev)
    return (t(ok, bool), t(key, np.float64), t(lo, np.int64), t(hi, np.int64),
            t(leaf, np.int64), t(nch, np.int64), t(hop, np.float64),
            t(dep, np.float64), 5e-6)


def check_scan_reduce(dev, rng) -> dict:
    worst = (0.0, 0.0)
    for n_dev, per_dev in ((1, 6), (24, 6), (1408, 6), (3000, 3)):
        for mode in ("plain", "ties", "allinf", "infeasible"):
            args = _scan_inputs(dev, rng, n_dev, per_dev, mode)
            got = walk_kernel.scan_reduce(*args)
            ref = walk_kernel.scan_reduce_plain(*args)
            torch.cuda.synchronize()
            if got[:3].tolist() != ref[:3].tolist():
                raise AssertionError(
                    f"scan_reduce decisions differ ({n_dev}x{per_dev} {mode}): "
                    f"{got.tolist()} vs {ref.tolist()}")
            e = max_err(got[3:], ref[3:])
            worst = (max(worst[0], e[0]), max(worst[1], e[1]))
    shapes = {}
    for label, n_dev, per_dev in (("P=6", 1, 6), ("P=8448", 1408, 6)):
        args = _scan_inputs(dev, rng, n_dev, per_dev, "plain")
        ms = time_ms(lambda: walk_kernel.scan_reduce(*args))
        plain = time_ms(lambda: walk_kernel.scan_reduce_plain(*args), 50, 5)
        P, Nn = args[0].shape[0], args[2].shape[0]
        shapes[label] = dict(ms=ms, plain_ms=plain,
                             **bound(9 * P + 48 * Nn + 32, 2 * P + 6 * Nn))
    main = shapes["P=6"]
    return dict(name="scan_reduce", route="cuda",
                source="src/repro_torch/kernels/csrc/scan_reduce.cu",
                replaces="src/repro/kernels/walk_kernel.py:150",
                shape="P=6 (device scan)", max_abs_err=worst[0],
                max_rel_err=worst[1], ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=None,
                other_shapes={"P=8448": shapes["P=8448"]})


def bound(nbytes: int, flops: int) -> dict:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = flops / FP64_FLOPS * 1e3
    return dict(bound_ms=max(tb, to),
                bound_by="bytes" if tb >= to else "operations")


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------
def reset_counts() -> None:
    slowdown_kernel.launches = 0
    walk_kernel.launches = 0
    for k in timeline_kernel.launches:
        timeline_kernel.launches[k] = 0
    rt_device.reset_sync_count()


def read_counts() -> dict:
    return {"slowdown_factors": slowdown_kernel.launches,
            "rate_advance": timeline_kernel.launches["rate_advance"],
            "rate_advance_settle": timeline_kernel.launches["settle"],
            "segment_min": timeline_kernel.launches["segment_min"],
            "scan_reduce": walk_kernel.launches}


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


def session_full(seed: int) -> tuple[dict, dict]:
    mult = FULL_MULT
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    st, cfg, g, sess, secs = run_session(mult, None, seed)
    counts = read_counts()
    syncs = rt_device.sync_count()
    lat = st.latencies(cfg)
    if len(lat) != len(cfg) or not all(np.isfinite(lat)):
        raise AssertionError(f"x{mult}: unfinished or non-finite latencies")
    if len(st.mapping) != len(cfg):
        raise AssertionError(f"x{mult}: {len(cfg) - len(st.mapping)} tasks "
                             "have no mapping")
    if st.unmapped:
        raise AssertionError(f"x{mult}: {len(st.unmapped)} tasks unmapped")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"x{mult}: kernel {name} was never launched "
                                 "on the main path")
    pct = st.latency_percentiles(cfg, (50.0, 99.0))
    comp = g.compiled()
    return dict(mult=mult, device=str(g.device), pus=len(comp.pu_names),
                tasks=len(cfg), mapped=len(st.mapping),
                unmapped=len(st.unmapped), **secs,
                p50_latency_s=pct[50.0], p99_latency_s=pct[99.0],
                qos_failures=st.qos_failures(cfg), launches=counts,
                device_to_host_syncs=syncs,
                peak_device_bytes=torch.cuda.max_memory_allocated()), counts


def _device_busy(mult: int, seed: int, activities) -> tuple[float, float, list]:
    """(wall s, device-busy s, top kernels) of one traced session."""
    from torch.profiler import profile as tprofile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tprofile(activities=activities) as prof:
        run_session(mult, None, seed)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = prof.key_averages()
    dev_us = sum(getattr(r, "self_device_time_total", 0.0) for r in rows)
    top = sorted(rows, key=lambda r: -getattr(r, "self_device_time_total", 0.0))
    return wall, dev_us / 1e6, [
        (r.key[:60], r.count, getattr(r, "self_device_time_total", 0.0) / 1e3)
        for r in top[:12]]


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
    wall, busy, top = _device_busy(mult, seed, [ProfilerActivity.CUDA])
    if not busy > 0.0:
        raise AssertionError("the trace shows no device time")
    emit(f"device_busy_x{mult}", dict(
        untraced_wall_s=plain_wall, traced_wall_s=wall, device_busy_s=busy,
        device_busy_share_of_untraced_wall=busy / plain_wall,
        device_busy_share_of_traced_wall=busy / wall, top_device=top))
    wall, busy, top = _device_busy(
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="instead of the checks: profile the session (device "
                         "busy share at mult=8 and at full width from "
                         "torch.profiler, host profile at full width) into "
                         "--out; prints no ok line")
    ap.add_argument("--out", default="profile_out",
                    help="directory for --profile's files")
    ap.add_argument("--stop-after", choices=("kernels", "x8"), default=None,
                    help="debugging: end (without the ok line) after a phase")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: "
                         "torch.cuda.is_available() is False")
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

    rng = np.random.default_rng(args.seed)
    kernels = [check_slowdown(dev, rng), *check_rate_advance(dev, rng),
               check_segment_min(dev, rng), check_scan_reduce(dev, rng)]
    for k in kernels:
        if not (k["max_rel_err"] <= REL_TOL):
            raise AssertionError(
                f"kernel {k['name']} disagrees with its plain version: "
                f"rel err {k['max_rel_err']}")
        k["tolerance"] = f"decisions exact, floats <= {REL_TOL} relative"

    emit("kernels_checked", {k["name"]: dict(
        max_abs_err=k["max_abs_err"], max_rel_err=k["max_rel_err"],
        ms=k["ms"], plain_ms=k["plain_ms"]) for k in kernels})
    if args.stop_after == "kernels":
        raise SystemExit("stopped after the kernels phase (debugging)")
    emit("session_x8", session_x8(args.seed))
    if args.stop_after == "x8":
        raise SystemExit("stopped after the x8 phase (debugging)")
    full, counts = session_full(args.seed)
    emit(f"session_x{FULL_MULT}", full)

    for k in kernels:
        k["launches"] = counts[k["name"]]
    emit("total", dict(seconds=time.perf_counter() - t_start))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
