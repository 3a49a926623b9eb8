"""Traffic mode ``serve``: an iteration is one online serving loop
(``ServeLoop.run``) over the graph that set-up built.  Every source of
the configuration's application (a sensor) sends one request per
reading, at the instants that the mix's ``arrivals`` kind draws from the
iteration's seed, for ``horizon_periods`` of its period; a request holds
the reading's tasks, and the program's ``AdmissionController`` decides
it on arrival.  Work is counted in requests.

The admission controller that the loop is handed times each request's
wait, from the start of the admission wave that decides it to its
verdict, through its public ``pre_admit`` / ``post_admit``.
"""
from __future__ import annotations

import math
import time

import numpy as np

from heye_bench import workload
from heye_bench.reference import des, scheduler
from heye_bench.reference.fleet import TaskMaker

# the share of a traced loop's verdicts over which the device is traced
# (the middle, so the loop's start and drain are left out); the rest of
# the loop runs untraced, which keeps the trace's read short
TRACE_SHARE = (0.35, 0.65)


def _admission(spans: list, on_verdict, **knobs):
    """The program's AdmissionController, timing each request's wait;
    ``on_verdict(n)`` is told the number of verdicts so far."""
    from repro_torch.serve.admission import AdmissionController

    class Timed(AdmissionController):
        def __init__(self) -> None:
            super().__init__(**knobs)
            self.wait: dict = {}
            self._t0 = None
            self._closed = True

        def pre_admit(self, req, now, inflight):
            if self._closed:
                self._t0 = time.perf_counter()
                self._closed = False
            d = super().pre_admit(req, now, inflight)
            if d is not None:
                self.wait[req.rid] = time.perf_counter() - self._t0
            return d

        def post_admit(self, req, results, now):
            d = super().post_admit(req, results, now)
            t = time.perf_counter()
            self.wait[req.rid] = t - self._t0
            if not self._closed:
                spans.append((self._t0, t, "admit"))
            self._closed = True
            on_verdict(len(self.wait))
            return d
    return Timed()


def horizon(cfg: dict, traffic: dict) -> float:
    return traffic["horizon_periods"] / cfg["application"]["hz"]


def arrival_times(cfg: dict, traffic: dict, seeds: list,
                  span: float) -> list:
    """(edge, instants) per source, drawn in source order."""
    rng = np.random.default_rng(seeds[0])
    arrivals = workload.load("arrivals", traffic["arrivals"])
    return [(edge, arrivals.times(period, span, rng))
            for edge, period in workload.application(cfg).sources(cfg)]


class _Instants:
    """Arrival instants drawn by the benchmark, in the shape of the
    program's open-loop arrival processes."""

    def __init__(self, t) -> None:
        self._t = t

    def times(self, horizon: float):
        return self._t[self._t < horizon]


class Program:
    """The program's side of the cell."""

    def __init__(self, core, tb, cfg: dict, traffic: dict) -> None:
        self.core, self.tb, self.cfg, self.traffic = core, tb, cfg, traffic
        self.app = workload.application(cfg)
        self.spans: list = []
        self.phase_wall = dict.fromkeys(("advance", "sync", "map", "admit"),
                                        0.0)
        self.waits: list = []
        self.work = 0

    def _loop(self, seeds: list, scale: float, on_verdict):
        core, g, cfg = self.core, self.tb.graph, self.cfg
        span = horizon(cfg, self.traffic) * scale
        root = core.build_orchestrators(g, core.heye_traverser(g))
        adm = _admission(self.spans, on_verdict,
                         **self.traffic["admission"])
        tenants = []
        for i, (edge, t) in enumerate(arrival_times(cfg, self.traffic,
                                                    seeds, span)):
            def make(k, at, edge=edge):
                return self.app.program_request(core, self.tb, cfg, edge, at)
            tenants.append(core.TenantSpec(f"s{i}", _Instants(t), make))
        loop = core.ServeLoop(
            g, root, tenants,
            truth=core.ground_truth_traverser(
                g, rng=np.random.default_rng(seeds[-1])),
            admission=adm, batch_window=self.traffic["batch_window_s"],
            horizon=span)
        st = loop.run()
        workload.sync(g.device)
        return loop, st, adm

    def iteration(self, seeds: list, scale: float = 1.0):
        loop, st, adm = self._loop(seeds, scale, lambda n: None)
        for k, v in st.phase_wall.items():
            self.phase_wall[k] += v
        self.work += len(st.requests)
        self.waits.extend(adm.wait.values())
        return loop, st

    def traced(self, seeds: list, tracer) -> None:
        """One loop, traced over the middle of its verdicts."""
        n = sum(len(t) for _, t in arrival_times(
            self.cfg, self.traffic, seeds, horizon(self.cfg, self.traffic)))
        lo, hi = (int(f * n) for f in TRACE_SHARE)

        def on_verdict(k):
            if k == lo:
                tracer.open()
            elif k == hi:
                tracer.close()
        self._loop(seeds, 1.0, on_verdict)
        tracer.close()

    def rows(self, out) -> list:
        """Per task of each request, in rid order: the request's inputs,
        its verdict and deferrals, and, if accepted, the task's placement,
        charged release and finish."""
        loop, st = out
        rows = []
        for r in sorted(st.requests, key=lambda r: r.rid):
            acc = r.verdict == "accepted"
            for t in r.tasks:
                rows.append(((r.rid, r.tenant, r.arrival, t.kind, t.origin),
                             (r.verdict, r.defers),
                             loop.session.mapping.get(t.uid) if acc else None,
                             t.release_time if acc else None,
                             loop.engine.finish_of(t.uid) if acc else None))
        return rows


def end_to_end(prog: Program, window_s: float) -> dict:
    return {"requests_per_s": prog.work / window_s,
            "admit_p99_ms": float(np.percentile(prog.waits, 99)) * 1e3}


def reference_rows(cfg: dict, traffic: dict, seeds: list,
                   rnd=scheduler.f64) -> list:
    """The reference's loop over its own resident ground truth, on the
    same arrivals, as ``Program.rows``."""
    if traffic["batch_window_s"] != 0.0:
        raise ValueError("the reference admits each arrival on its own")
    fl = workload.ref_fleet_of(cfg)
    model = scheduler.Model(fl, rnd)
    walker = scheduler.Walker(model, scheduler.Ledger(fl))
    truth = des.Truth(model, np.random.default_rng(seeds[-1]))
    app, mk = workload.application(cfg), TaskMaker()
    tenants = []
    for i, (edge, t) in enumerate(arrival_times(cfg, traffic, seeds,
                                                horizon(cfg, traffic))):
        def make(k, at, edge=edge):
            return app.reference_request(fl, mk, cfg, edge, at)
        tenants.append((f"s{i}", t, make))
    reqs = scheduler.serve(walker, tenants, traffic["admission"], truth)
    rows = []
    for r in sorted(reqs, key=lambda r: r.rid):
        acc = r.verdict == "accepted"
        for t, res in zip(r.tasks, r.results):
            rows.append(((r.rid, r.tenant, r.arrival, t.kind,
                          fl.devices[t.origin].name), (r.verdict, r.defers),
                         fl.pus[res.pu].name if acc else None,
                         t.release if acc else None,
                         truth.finish.get(t.uid, math.nan) if acc else None))
    return rows
