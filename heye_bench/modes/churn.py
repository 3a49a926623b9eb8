"""Traffic mode ``churn``: an iteration sends the configuration's sources
in waves over volatile uplinks, through one scheduling session whose
ground truth is its resident timeline.

Wave ``w`` is one reading of every source (``sources`` of the
configuration's application), released at ``w * wave_period_s``.  Before
it, one bandwidth batch goes in: every uplink that the previous batch
degraded returns to nominal, then a fresh ``churn_frac`` of the edge
uplinks drops to ``uniform(min_scale, max_scale)`` of nominal.  The
schedule is drawn from the iteration's first seed as a plain list, and
the same list goes to the program and to the reference.

The program's side, per wave: the resident timeline advances to the
wave's instant (``execute``), ``SchedulerSession.churn`` applies the
batch there, repricing transfers in flight (``churn``), the wave is
submitted and mapped on the snapshot that follows (``map_pending``), and
injected (``execute``); the timeline drains after the last wave
(``execute``) and a closing batch returns the last degraded uplinks to
nominal (``churn``).  Each part ends synchronised.  Work is counted in
tasks, waves in ``phase_wall["waves"]``.
"""
from __future__ import annotations

import math
import time

import numpy as np

from heye_bench import workload
from heye_bench.reference import churn as ref_churn
from heye_bench.reference import scheduler
from heye_bench.reference.fleet import TaskMaker


def nominal(cfg: dict) -> list:
    """The nominal bandwidth of each edge's uplink, in the deployment's
    edge order."""
    fl = workload.ref_fleet_of(cfg)
    return [fl.links[fl.devices[d].link][0] for d in fl.edges]


def schedule(traffic: dict, seeds: list, nom: list) -> list:
    """Per wave, its batch of (edge index, bandwidth): the recoveries of
    the previous batch's degraded uplinks, then the new degradations."""
    rng = np.random.default_rng(seeds[0])
    n = len(nom)
    k = max(1, int(n * traffic["churn_frac"]))
    out, degraded = [], []
    for _ in range(traffic["waves"]):
        batch = [(e, nom[e]) for e in degraded]
        degraded = sorted(int(e) for e in rng.choice(n, k, replace=False))
        scale = rng.uniform(traffic["min_scale"], traffic["max_scale"], k)
        batch += [(e, nom[e] * float(s)) for e, s in zip(degraded, scale)]
        out.append(batch)
    return out


class Program:
    """The program's side of the cell."""

    def __init__(self, core, tb, cfg: dict, traffic: dict) -> None:
        self.core, self.tb, self.cfg, self.traffic = core, tb, cfg, traffic
        self.app = workload.application(cfg)
        self.nominal = nominal(cfg)
        # each edge's uplink in the program's graph: its bandwidth is what
        # the program maps against
        self.uplinks = [next(e for _, e in tb.graph.neighbors(name)
                             if e.name == f"link_{name}")
                        for name in tb.edges]
        self.spans: list = []
        self.phase_wall = {"waves": 0}
        self.work = 0

    def _churn(self, sess, batch: list) -> None:
        sess.churn(self.core.Churn(bandwidth=[
            (self.uplinks[e].name, bw) for e, bw in batch]))

    def iteration(self, seeds: list, scale: float = 1.0):
        core, tb, cfg, g = self.core, self.tb, self.cfg, self.tb.graph
        sched = schedule(self.traffic, seeds, self.nominal)
        sources = self.app.sources(cfg)
        sources = sources[:max(1, int(len(sources) * scale))]
        spans, sync = self.spans, workload.sync
        tasks, bws = [], []
        t0 = time.perf_counter()
        root = core.build_orchestrators(g, core.heye_traverser(g))
        truth = core.ground_truth_traverser(
            g, rng=np.random.default_rng(seeds[-1]))
        sess = core.SchedulerSession(g, root, truth=truth)
        sess.open_timeline()
        sync(g.device)
        spans.append((t0, time.perf_counter(), "session"))
        for w, batch in enumerate(sched):
            at = w * self.traffic["wave_period_s"]
            a = time.perf_counter()
            sess.engine.advance(at)
            sync(g.device)
            b = time.perf_counter()
            self._churn(sess, batch)
            sync(g.device)
            c = time.perf_counter()
            wave = []
            for edge, _ in sources:
                req = self.app.program_request(core, tb, cfg, edge, at)
                sess.submit(req)
                wave += req.tasks
                bws += [self.uplinks[edge].bandwidth] * len(req.tasks)
            sess.map_pending()
            sync(g.device)
            d = time.perf_counter()
            sess.inject(wave)
            sync(g.device)
            spans += [(a, b, "execute"), (b, c, "churn"),
                      (c, d, "map_pending"), (d, time.perf_counter(),
                                              "execute")]
            tasks += wave
        a = time.perf_counter()
        stats = sess.finalize_online(drain=True)
        sync(g.device)
        b = time.perf_counter()
        self._churn(sess, [(e, self.nominal[e]) for e, bw in sched[-1]
                           if bw != self.nominal[e]])
        sync(g.device)
        spans += [(a, b, "execute"), (b, time.perf_counter(), "churn")]
        self.phase_wall["waves"] += len(sched)
        self.work += len(tasks)
        return tasks, bws, stats

    def traced(self, seeds: list, tracer) -> None:
        """One iteration, traced whole."""
        tracer.open()
        self.iteration(seeds)
        tracer.close()

    def rows(self, out) -> list:
        """Per task in submission order: its inputs with its origin
        uplink's bandwidth when it was mapped, no verdict, its placement,
        charged release and finish."""
        tasks, bws, stats = out
        return [((t.kind, t.origin, t.deadline, t.input_bytes,
                  t.output_bytes, bw), None, stats.mapping[t.uid],
                 t.release_time, stats.timeline.finish.get(t.uid, math.nan))
                for t, bw in zip(tasks, bws)]


def end_to_end(prog: Program, window_s: float) -> dict:
    return {"tasks_per_s": prog.work / window_s}


def reference_rows(cfg: dict, traffic: dict, seeds: list,
                   rnd=scheduler.f64) -> list:
    """The reference's waves over its own resident ground truth, on the
    same schedule, as ``Program.rows``."""
    fl = workload.ref_fleet_of(cfg)
    model = scheduler.Model(fl, rnd)
    walker = scheduler.Walker(model, scheduler.Ledger(fl))
    truth = ref_churn.ChurnTruth(model, np.random.default_rng(seeds[-1]))
    app, mk = workload.application(cfg), TaskMaker()
    uplink = [fl.devices[d].link for d in fl.edges]
    done = []
    for w, batch in enumerate(schedule(traffic, seeds, nominal(cfg))):
        at = w * traffic["wave_period_s"]
        truth.advance(at)
        truth.churn([(uplink[e], bw) for e, bw in batch], at)
        wave = [t for edge, _ in app.sources(cfg)
                for t in app.reference_request(fl, mk, cfg, edge, at)]
        bws = [fl.links[fl.devices[t.origin].link][0] for t in wave]
        placed = scheduler.map_session(walker, wave)
        truth.inject(wave, {u: r.pu for u, r in placed.items()})
        done += [(t, bw, placed[t.uid]) for t, bw in zip(wave, bws)]
    truth.advance()
    return [((t.kind, fl.devices[t.origin].name, t.deadline, t.input_bytes,
              t.output_bytes, bw), None, fl.pus[r.pu].name, t.release,
             truth.finish.get(t.uid, math.nan))
            for t, bw, r in done]
