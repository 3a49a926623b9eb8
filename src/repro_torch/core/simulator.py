"""Ground-truth simulator + experiment runtime.

The paper evaluates on a physical testbed; we stand in a discrete-event
ground truth built on the same contention-interval engine as the Traverser
but with *richer physics*: superlinear contention and per-task
irregular-access noise (see core/slowdown.truth_params).  Predictors under
test (H-EYE / ACE-like / LaTS-like) never see these parameters.

``Runtime`` co-drives an assignment policy and the ground truth:

  phase 1 (online assignment): tasks are presented in release order; the
  policy (an Orchestrator, or a baseline) assigns each using only its own
  predictions + its belief ledger.  Scheduling overhead is accrued per task
  and delays the task's release (the paper counts orchestrator communication
  as overhead, Fig. 14).

  phase 2 (execution): the full workload with the frozen mapping runs
  through the ground-truth engine, yielding real latencies / QoS failures.

Both phases are driven by :class:`core.session.SchedulerSession`:
``Runtime.run`` is a thin delegate that keeps the seed's strict per-task
release-order semantics by default and exposes the frontier-batched wave
discipline via ``frontier=True``.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from .hwgraph import HWGraph, ProcessingUnit
from .orchestrator import ActiveLedger, MapResult, Orchestrator
from .session import RunStats, SchedulerSession, _any_supporting
from .slowdown import DecoupledSlowdown, SlowdownParams, heye_params, truth_params
from .task import Task, TaskGraph
from .traverser import Traverser


def ground_truth_traverser(graph: HWGraph, seed: int = 0,
                           params: Optional[SlowdownParams] = None,
                           rng: Optional[np.random.Generator] = None,
                           ) -> Traverser:
    """The ground-truth engine.  Its work-noise draws come from ``rng`` —
    an explicit ``numpy.random.Generator`` (host scalars in event order);
    when none is given one is made from ``seed``.  Nothing is seeded
    globally."""
    p = params or truth_params()
    if rng is None:
        rng = np.random.default_rng(seed)
    sd = DecoupledSlowdown(graph, p)
    return Traverser(graph, slowdown=sd, noise=p.noise, rng=rng)


def heye_traverser(graph: HWGraph) -> Traverser:
    return Traverser(graph, slowdown=DecoupledSlowdown(graph, heye_params()))


class Runtime:
    """Drives (policy -> mapping) then (ground truth -> outcomes).

    Thin delegate over :class:`SchedulerSession`: the default keeps the
    seed's strict per-task release-order semantics; ``frontier=True``
    switches to dependency-frontier batching (``map_batch`` waves)."""

    def __init__(self, graph: HWGraph, seed: int = 0,
                 truth: Optional[Traverser] = None) -> None:
        self.graph = graph
        self.truth = truth or ground_truth_traverser(graph, seed=seed)

    def run(self, cfg: TaskGraph,
            assign: Callable[[Task, float], Optional[MapResult]],
            charge_overhead: bool = True, frontier: bool = False) -> RunStats:
        """``assign(task, now)`` returns a MapResult (policy decision)."""
        session = SchedulerSession(self.graph, assign, truth=self.truth,
                                   charge_overhead=charge_overhead,
                                   frontier=frontier)
        return session.run(cfg)


# ---------------------------------------------------------------------------
# Baseline assignment policies (§5.1.1)
# ---------------------------------------------------------------------------
class AcePolicy:
    """ACE-like: static application orchestration, contention-blind.

    Maps each task kind once (at first sight) to the PU with the best
    *standalone* time reachable under its deadline, then reuses that static
    choice — "limited to static application orchestration ... does not
    consider shared resource utilization".
    """

    def __init__(self, graph: HWGraph, blind_traverser: Traverser) -> None:
        self.graph = graph
        self.trav = blind_traverser
        self.static_choice: dict[tuple[str, str], str] = {}   # (origin, kind) -> pu

    def map_batch(self, tasks, now: float):
        """Baseline batch entry: per-task decisions in order (this policy
        carries no batchable state beyond its static-choice cache)."""
        return [self(t, now) for t in tasks]

    def __call__(self, task: Task, now: float) -> Optional[MapResult]:
        key = (task.origin or "", task.kind)
        if key not in self.static_choice:
            best, best_pred = None, None
            for pu in self.graph.pus():
                if pu.model is None or not pu.model.supports(task, pu):
                    continue
                if (task.attrs.get("pinned") and
                        self.graph.device_of(pu.name).name != task.origin):
                    continue
                pred = self.trav.predict_task(task, pu.name, [])
                if task.deadline is not None and pred.total > task.deadline:
                    continue
                if best_pred is None or pred.total < best_pred.total:
                    best, best_pred = pu.name, pred
            if best is None:
                return None
            self.static_choice[key] = best
        pu = self.static_choice[key]
        pred = self.trav.predict_task(task, pu, [])
        return MapResult(pu=pu, prediction=pred, overhead=20e-6, queries=1)


class LatsPolicy:
    """Hetero-Edge/LaTS-like: latency-aware, availability-monitored, but
    contention-blind — picks the *available* PU with the best standalone
    time + communication, no shared-resource model (§5.1.1)."""

    def __init__(self, graph: HWGraph, blind_traverser: Traverser,
                 ledger: Optional[ActiveLedger] = None) -> None:
        self.graph = graph
        self.trav = blind_traverser
        self.ledger = ledger or ActiveLedger(graph.device)

    def __call__(self, task: Task, now: float) -> Optional[MapResult]:
        self.ledger.prune(now)
        best: Optional[MapResult] = None
        queries = 0
        for pu in self.graph.pus():
            if pu.model is None or not pu.model.supports(task, pu):
                continue
            if (task.attrs.get("pinned") and
                    self.graph.device_of(pu.name).name != task.origin):
                continue
            queries += 1
            pred = self.trav.predict_task(task, pu.name, [])
            busy = self.ledger.count(pu.name)
            if busy >= pu.max_tenancy:       # availability monitoring
                continue
            if best is None or pred.total < best.prediction.total:
                best = MapResult(pu=pu.name, prediction=pred)
        if best is not None:
            best.queries = queries
            best.overhead = queries * 5e-6
            self.ledger.add(task, best.pu, best.prediction, now)
        return best

    def map_batch(self, tasks, now: float):
        """Baseline batch entry: per-task decisions in order (availability
        monitoring reads its own ledger between decisions)."""
        return [self(t, now) for t in tasks]


class OrchestratorPolicy:
    """H-EYE: route each task to its origin device's ORC (paper §3.2)."""

    def __init__(self, root: Orchestrator) -> None:
        self.root = root

    def __call__(self, task: Task, now: float) -> Optional[MapResult]:
        orc = None
        if task.origin is not None:
            orc = self.root.find_device_orc(task.origin)
        if orc is None:
            orc = next((o for o in self.root.iter_tree() if o.is_device_orc()),
                       self.root)
        return orc.map_batch([task], now)[0]

    def map_batch(self, tasks, now: float):
        """Frontier entry: the whole batch goes through the root ORC's
        ``map_batch`` (origin-routed).  Subclasses that customize per-task
        ``__call__`` (sticky / grouped / direct-server strategies) keep
        their semantics — the batch falls back to per-task calls for them."""
        if type(self).__call__ is not OrchestratorPolicy.__call__:
            return [self(t, now) for t in tasks]
        return self.root.map_batch(tasks, now, route=True)
