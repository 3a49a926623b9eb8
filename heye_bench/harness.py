"""One run of one cell: set-up, warm-up, the measured window, the traced
iteration's device readings, and the check of one iteration against the
plain reference.

The window runs whole iterations: one starts only while less than
``seconds`` has passed, and every one started is counted; rates divide
all the work by the time to the end of the last.  Iteration ``i`` draws
its arrival and noise seeds from the run's seed and ``i``.  The
window's iterations are never traced: with ``--trace 1`` the per-layer
metrics of the host's clock and the program's counters are taken over
them, and one more iteration after the window carries the launch
recorder, the device trace and the program's own span recorder
(``repro_torch.spans``), whose summary the readers find under
``reading["program"]``.
"""
from __future__ import annotations

import gc
import math
import sys
import time

import numpy as np

from . import check, workload
from .roofline import LaunchRecorder, is_port_kernel

BANNED = ("jax", "jaxlib", "flax", "repro")
# share of the configuration's application (or of the horizon) that the
# warm-up runs: every kernel and code path of an iteration, at less cost
WARMUP_SCALE = 0.125
WARMUP_INDEX = 1 << 30


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


class Tracer:
    """Opens and closes the launch recorder and the device trace
    together, once."""

    def __init__(self, parts: list) -> None:
        self.parts = [p for p in parts if p is not None]
        self.state = "ready"

    def open(self) -> None:
        if self.state == "ready":
            for p in self.parts:
                p.__enter__()
            self.state = "open"

    def close(self) -> None:
        if self.state == "open":
            for p in reversed(self.parts):
                p.__exit__(None, None, None)
            self.state = "closed"


class HostClock:
    """Per iteration, the process's CPU seconds and the collector's
    pauses: an iteration whose CPU seconds grow with its wall time ran on
    a slower host, not behind a pause."""

    def __init__(self) -> None:
        self.gc_s = 0.0
        self._gc0 = None
        gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase, info) -> None:
        if phase == "start":
            self._gc0 = time.perf_counter()
        elif self._gc0 is not None:
            self.gc_s += time.perf_counter() - self._gc0
            self._gc0 = None

    def now(self) -> tuple:
        return time.process_time(), self.gc_s

    def close(self) -> None:
        gc.callbacks.remove(self._on_gc)


def host_probe(dev) -> list:
    """Two fixed probes, in milliseconds: a pure-Python loop (the host's
    speed) and 200 one-element reads from the device (the launch and
    read path's latency)."""
    t = time.perf_counter()
    s = 0
    for i in range(300000):
        s += i * i % 7
    py_ms = (time.perf_counter() - t) * 1e3
    dev_ms = 0.0
    if dev.type == "cuda":
        import torch
        x = torch.zeros(1, dtype=torch.float64, device=dev)
        t = time.perf_counter()
        for _ in range(200):
            (x + 1.0).item()
        dev_ms = (time.perf_counter() - t) * 1e3
    return [py_ms, dev_ms]


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The entries of ``bench[kind]`` that ``cell`` reports."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]}
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def load_metric(name: str):
    """A per-layer metric's reader: ``metrics/<stem>.py`` for the metric
    ``<stem>.<suffix>``."""
    return workload.load("metrics", name.split(".")[0])


def run_cell(bench: dict, cell: str, cfg: dict, traffic: dict, seed: int,
             seconds: float, trace: bool, device, t_start: float,
             log=print) -> dict:
    """One run; returns the result line's object (``checks`` last)."""
    import repro_torch.core as core
    from repro_torch import device as rt_device
    from repro_torch.kernels import (slowdown_kernel, timeline_kernel,
                                     walk_kernel)
    parts = {}
    t = time.perf_counter()
    if getattr(device, "type", device) == "cuda":
        from repro_torch.kernels import build
        build.load()
    parts["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    tb = workload.build_testbed(core, cfg, device)
    tb.graph.compiled()
    dev = tb.graph.device
    mode = workload.load("modes", traffic["mode"])
    prog = mode.Program(core, tb, cfg, traffic)
    parts["graph_s"] = time.perf_counter() - t
    t = time.perf_counter()
    prog.iteration(workload.iteration_seeds(seed, WARMUP_INDEX),
                   WARMUP_SCALE)
    workload.sync(dev)
    parts["warmup_s"] = time.perf_counter() - t
    # set-up's own work leaves the counters and the spans
    prog = mode.Program(core, tb, cfg, traffic)
    counters = (slowdown_kernel.launches, timeline_kernel.launches,
                walk_kernel.launches)

    def launches() -> int:
        return sum(sum(c.values()) for c in counters)

    probes = [host_probe(dev)]
    # one iteration is kept for the check, drawn uniformly from the seed
    # as the window runs (reservoir sampling: the window keeps no more)
    pick = np.random.default_rng([seed, 1 << 20])
    kept = None
    host = HostClock()
    marks = [host.now()]
    launches0, syncs0 = launches(), rt_device.sync_count()
    times = []
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while not times or time.perf_counter() - t0 < seconds:
        i = len(times)
        seeds = workload.iteration_seeds(seed, i)
        a = time.perf_counter()
        out = prog.iteration(seeds)
        times.append(time.perf_counter() - a)
        marks.append(host.now())
        if pick.integers(i + 1) == 0:
            kept = (i, seeds, prog.rows(out))
        del out
    window_s = time.perf_counter() - t0
    host.close()
    probes.append(host_probe(dev))
    reading = {"work": prog.work, "spans": _span_sums(prog.spans),
               "phase_wall": dict(prog.phase_wall),
               "launches": launches() - launches0,
               "syncs": rt_device.sync_count() - syncs0,
               "window_s": 0.0, "busy_s": 0.0, "roofline": (0.0, 0.0),
               "program": None}
    e2e = mode.end_to_end(prog, window_s)
    e2e["setup_s"] = setup_s
    log(f"set-up {setup_s:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()))
    log("iterations (wall, cpu, gc s): " + "; ".join(
        f"{w:.3f} {b[0] - a[0]:.3f} {b[1] - a[1]:.3f}"
        for w, a, b in zip(times, marks, marks[1:])))
    log("probes before / after the window (python ms, device reads ms): "
        + " / ".join(f"{a:.2f} {b:.3f}" for a, b in probes))
    result = {"correct": False, "attempted": prog.work, "failed": 0,
              "metrics": {},
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                         "kind": _device_kind(dev), "count": 1,
                         "memory_peak_bytes": 0},
              "setup_parts": parts, "host_probes_ms": probes}

    # -- the traced iteration, after the window ----------------------------
    if trace:
        prog.spans.clear()
        rec = LaunchRecorder([slowdown_kernel, timeline_kernel, walk_kernel,
                              sys.modules["repro_torch.core.slowdown"],
                              sys.modules["repro_torch.core.orchestrator"]])
        win = None
        if dev.type == "cuda":
            from .trace import Window
            win = Window()
        try:
            from repro_torch import spans
            prec = spans.record()
        except ImportError:     # a tree without the program's recorder
            prec = None
        # the program's recorder opens last and closes first
        tracer = Tracer([rec, win, prec])
        prog.traced(workload.iteration_seeds(seed, len(times)), tracer)
        if tracer.state != "closed":
            raise RuntimeError("the traced window never opened")
        reading["roofline"] = (rec.least_seconds(), 0.0)
        if prec is not None:
            reading["program"] = program_reading(prec)
        if win is not None:
            reading.update(window_s=win.window_s, busy_s=win.busy_s(),
                           roofline=(reading["roofline"][0],
                                     win.kernel_device_s(is_port_kernel)))
            log(f"trace: {len(win.events)} device operations, profiler "
                f"stop {win.stop_s:.2f} s, read {win.read_s:.2f} s")
            result["device"]["busy_s"] = reading["busy_s"]
            result["device"]["window_s"] = reading["window_s"]
            named = list(prog.spans)
            if prec is not None:
                named += [(sp.start, sp.end, sp.name) for sp in prec.spans]
            result["breakdown"] = {
                "device_ops": win.top_ops(),
                "idle_gaps": win.idle_by_span(named, "between")}
        for m in cell_metrics(bench, cell, "per_layer"):
            v = load_metric(m["name"]).read(reading)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        del rec, win, tracer, prec
    else:
        for m in cell_metrics(bench, cell, "end_to_end"):
            result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                            "unit": m["unit"]}
    if dev.type == "cuda":
        import torch
        result["device"]["memory_peak_bytes"] = int(
            torch.cuda.max_memory_allocated(dev))

    # -- the check, after the window, the program's state freed ----------
    k, seeds, got = kept
    result["failed"] = sum(1 for r in got if r[4] is not None
                           and not math.isfinite(r[4]))
    del kept, prog, tb
    gc.collect()
    if dev.type == "cuda":
        import torch
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = check.compare(got, mode.reference_rows(cfg, traffic, seeds))
    log(f"reference check of iteration {k}: {time.perf_counter() - t:.2f} s")
    result["correct"] = check.verdict(numbers)
    result["checks"] = {name: {"value": v, "limit": check.LIMITS[name]}
                        for name, v in numbers.items()}
    for name, c in result["checks"].items():
        log(f"{name} {c['value']!r} (limit {c['limit']!r})")
    log(f"correct {result['correct']}")
    return result


def program_reading(rec) -> dict:
    """The program's recorder after it closed: its summary, and under
    ``layers``, per layer (a span name's part before its first dot), the
    count, seconds, reads and launches of its outermost spans, those with
    no enclosing span of the same layer, their descendants' included."""
    out = rec.summary()
    layers: dict = {}
    for sp, t in zip(rec.spans, rec.totals()):
        layer = sp.name.split(".")[0]
        p = sp.parent
        while p is not None and p.name.split(".")[0] != layer:
            p = p.parent
        if p is None:
            e = layers.setdefault(layer, dict.fromkeys(
                ("count", "total_s", "reads", "launches"), 0))
            e["count"] += 1
            e["total_s"] += t["seconds"]
            e["reads"] += t["reads"]
            e["launches"] += t["launches"]
    out["layers"] = layers
    return out


def _span_sums(spans: list) -> dict:
    out: dict = {}
    for a, b, name in spans:
        out[name] = out.get(name, 0.0) + (b - a)
    return out


def _device_kind(dev) -> str:
    if dev.type == "cuda":
        import torch
        return torch.cuda.get_device_name(dev)
    return "cpu"
