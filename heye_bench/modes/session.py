"""Traffic mode ``session``: an iteration is one offline scheduling
session over the configuration's whole application — build the
orchestrator tree, submit, map every dependency frontier
(``map_pending``), execute on the ground truth (``execute``), each part
ending synchronised.  Work is counted in tasks.
"""
from __future__ import annotations

import math
import time

import numpy as np

from heye_bench import workload
from heye_bench.reference import des, scheduler


class Program:
    """The program's side of the cell."""

    def __init__(self, core, tb, cfg: dict, traffic: dict) -> None:
        self.core, self.tb, self.cfg = core, tb, cfg
        self.app = workload.application(cfg)
        self.spans: list = []
        self.phase_wall: dict = {}
        self.work = 0

    def iteration(self, seeds: list, scale: float = 1.0):
        core, g = self.core, self.tb.graph
        t0 = time.perf_counter()
        root = core.build_orchestrators(g, core.heye_traverser(g))
        truth = core.ground_truth_traverser(
            g, rng=np.random.default_rng(seeds[-1]))
        sess = core.SchedulerSession(g, root, truth=truth)
        app = self.app.program_session(core, self.tb, self.cfg, scale)
        sess.submit(app)
        t1 = time.perf_counter()
        sess.map_pending()
        workload.sync(g.device)
        t2 = time.perf_counter()
        stats = sess.execute()
        workload.sync(g.device)
        t3 = time.perf_counter()
        self.spans += [(t0, t1, "session"), (t1, t2, "map_pending"),
                       (t2, t3, "execute")]
        self.work += len(app.tasks)
        return app, stats

    def traced(self, seeds: list, tracer) -> None:
        """One iteration, traced whole."""
        tracer.open()
        self.iteration(seeds)
        tracer.close()

    def rows(self, out) -> list:
        """Per task in submission order: its inputs, no verdict, its
        placement, charged release and finish."""
        app, stats = out
        return [((t.kind, t.origin, t.deadline, t.input_bytes,
                  t.output_bytes, len(app.preds(t))), None,
                 stats.mapping[t.uid], t.release_time,
                 stats.timeline.finish.get(t.uid, math.nan))
                for t in app.tasks]


def end_to_end(prog: Program, window_s: float) -> dict:
    return {"tasks_per_s": prog.work / window_s}


def reference_rows(cfg: dict, traffic: dict, seeds: list,
                   rnd=scheduler.f64) -> list:
    """The reference's session on the same inputs, as ``Program.rows``."""
    fl = workload.ref_fleet_of(cfg)
    tasks = workload.application(cfg).reference_session(fl, cfg)
    model = scheduler.Model(fl, rnd)
    walker = scheduler.Walker(model, scheduler.Ledger(fl))
    placed = scheduler.map_session(walker, tasks)
    fin = des.simulate(model, tasks, {u: r.pu for u, r in placed.items()},
                       np.random.default_rng(seeds[-1]))
    return [((t.kind, fl.devices[t.origin].name, t.deadline, t.input_bytes,
              t.output_bytes, len(t.preds)), None,
             fl.pus[placed[t.uid].pu].name, t.release, fin[t.uid])
            for t in tasks]

