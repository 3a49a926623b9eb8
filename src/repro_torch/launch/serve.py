"""Serving driver of the port: multi-tenant engine placement via the H-EYE
Orchestrator, then continuous-batching serving on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
        --requests 12 --smoke --device cpu

Two layers cooperate, as in the reference package's ``launch/serve.py``:

* the H-EYE Orchestrator places request streams ("tenants") onto the chips
  of a simulated TPU-fleet HW-GRAPH (``build_tpu_fleet``), using the
  Traverser's slowdown model to keep every tenant's latency SLO intact
  under multi-tenancy, and
* a ServeEngine (continuous batching over a slot pool) executes the stream
  placed on THIS process's device.

``--device`` picks that device: the CUDA card by default (the scheduler
session and the model both live there), ``cpu`` on request.  Without
``--smoke`` the model is the config at full width with bfloat16 compute;
weights are random, drawn from a seeded ``torch.Generator``.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..configs import get_config
from ..core import (CallableModel, SchedulerSession, Task, build_orchestrators,
                    build_tpu_fleet, heye_traverser, percentiles)
from ..models import ParallelCtx, build_model
from ..serve.engine import Request, ServeEngine


def place_tenants(n_tenants: int, slo_s: float, est_s: float, device=None):
    """Map tenant streams onto fleet chips in one batch-first session;
    returns {tenant -> chip} and the scheduling overhead ledger."""
    tb = build_tpu_fleet(n_pods=1, hosts_per_pod=2, chips_per_host=4,
                         device=device)
    # a profiled model for 'serve_stream' tasks: est_s per stream
    model = CallableModel(fn=lambda t, pu, unit: est_s * t.size)
    for chip in tb.graph.pus():
        chip.model = model
        chip.max_tenancy = 4
    root = build_orchestrators(tb.graph, heye_traverser(tb.graph))
    orc = next(o for o in root.iter_tree() if o.is_device_orc())
    tenants = []
    for _ in range(n_tenants):
        t = Task(kind="serve_stream", deadline=slo_s,
                 usage={"pu": 1.0, "mem": 0.6})
        t.origin = orc.group
        tenants.append(t)
    session = SchedulerSession(tb.graph, root, charge_overhead=False)
    session.submit(tenants)
    session.map_pending()
    placements = {i: session.mapping.get(t.uid)
                  for i, t in enumerate(tenants)}
    overheads = [session.results[t.uid].overhead
                 if session.results.get(t.uid) else 0.0 for t in tenants]
    return placements, overheads


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--slo-ms", type=float, default=50.0)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device for the session and the model "
                         "(default: the CUDA card; 'cpu' on request)")
    return ap.parse_args(argv)


@dataclass
class ServeReport:
    """What one serving run did: the finished requests (by rid), the
    wall clock of the serving loop and each request's wall latency."""

    done: list[Request]
    seconds: float
    latencies: list[float]
    tokens_decoded: int
    admitted_total: int
    slot_rejections: int
    placements: dict = field(default_factory=dict)

    @property
    def tokens(self) -> int:
        return sum(len(r.out) for r in self.done)


def run(args: argparse.Namespace) -> ServeReport:
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model = build_model(cfg, ParallelCtx(
        compute_dtype=torch.float32 if args.smoke else torch.bfloat16),
        device=args.device)
    gen = torch.Generator(device=model.device).manual_seed(0)
    params = model.init(gen)

    # fleet-level placement: one tenant per batch of requests
    n_tenants = max(1, args.requests // args.slots)
    placements, overheads = place_tenants(
        n_tenants, slo_s=args.slo_ms * 1e-3, est_s=args.slo_ms * 0.4e-3,
        device=model.device)
    spread = len(set(filter(None, placements.values())))
    print(f"[serve] orchestrator placed {n_tenants} tenants on {spread} chips "
          f"(mean placement overhead {np.mean(overheads) * 1e6:.0f} us)")

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, size=rng.integers(2, 6)
                                        ).astype(np.int32),
                    max_new=args.max_new)
            for i in range(args.requests)]
    eng = ServeEngine(model, params, max_slots=args.slots,
                      max_len=args.max_len)
    # continuous batching with per-request wall latency (all requests
    # arrive at t0: open-loop burst, so latency includes slot queueing);
    # every step reads its logits back, so the clock sees the device's work
    t0 = time.perf_counter()
    pending, done, lat = list(reqs), [], []
    while pending or eng.active:
        if pending and eng.free:
            admitted = eng.admit_many(pending[:len(eng.free)])
            del pending[:len(admitted)]
        for r in eng.step():
            lat.append(time.perf_counter() - t0)
            done.append(r)
    report = ServeReport(done=done, seconds=time.perf_counter() - t0,
                         latencies=lat, tokens_decoded=eng._tokens_decoded,
                         admitted_total=eng.admitted_total,
                         slot_rejections=eng.slot_rejections,
                         placements=placements)
    dt = report.seconds
    print(f"[serve] {len(done)} requests, {report.tokens} tokens in {dt:.2f}s "
          f"({report.tokens / dt:.1f} tok/s, {eng._tokens_decoded} decode "
          f"steps) on {model.device}")
    pct = percentiles(lat)
    print(f"[serve] wall latency p50 {pct[50.0] * 1e3:.0f}ms  "
          f"p99 {pct[99.0] * 1e3:.0f}ms  p999 {pct[99.9] * 1e3:.0f}ms  "
          f"({eng.admitted_total} slot admissions, "
          f"{eng.slot_rejections} slot-exhaustion refusals)")
    for r in sorted(done, key=lambda r: r.rid)[:4]:
        print(f"  req {r.rid}: prompt {list(r.prompt)} -> {r.out}")
    return report


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
