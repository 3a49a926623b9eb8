"""Batch-first scheduling sessions: the public mapping surface.

``SchedulerSession`` owns the mapping loop the seed's ``Runtime.run``
hand-rolled per task: callers ``submit()`` whole ``TaskGraph``s (or
streaming batches of independent tasks) and the session drives
**dependency-frontier batches** through the policy — every ready task in
a frontier is scored in one ``Orchestrator.map_batch`` call against the
compiled snapshot, replacing N independent ``map_task`` walks whose
Python dispatch dominated exactly where the compiled HW-GRAPH engine
made the math cheap.

Two wave disciplines:

* ``frontier=True`` (default) — tasks are grouped into waves of
  dependency-ready tasks sharing a release instant, in (release, uid)
  order.  Producers are always placed before consumers, so inter-device
  ``src_devices`` provenance is exact, and a wave maps in one batched
  call.
* ``frontier=False`` — one task per wave in strict (release, uid) order
  regardless of readiness: byte-for-byte the seed's ``Runtime.run``
  semantics (``Runtime`` delegates here).

Scheduling overhead accounting matches the paper (Fig. 14): each task's
overhead delays its own release before the ground-truth execution.

Device: the session inherits the graph's device (CUDA unless the graph
was built with ``device="cpu"``; it raises when CUDA is absent and the CPU
was not asked for).  The session itself is host control flow: waves,
commits, overhead charging; all array math happens in the policy and the
ground-truth traverser.

Topology churn during a session (``churn``, or ``HWGraph.apply_churn``)
is absorbed by ``CompiledHWGraph.apply_delta``: the session keeps mapping
against copy-on-write patched snapshots instead of full recompiles.  The
online half — ``withdraw``, the session-resident timeline
(``open_timeline`` / ``inject`` / ``finalize_online``) — is what
``core.serving.ServeLoop`` drives.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional, Union

import numpy as np

from .hwgraph import Churn, HWGraph
from .orchestrator import MapResult, Orchestrator
from .task import Task, TaskGraph
from .timeline import TimelineEngine
from .traverser import TaskPrediction, Timeline, Traverser


def percentiles(values: Iterable[float],
                qs: Iterable[float] = (50.0, 99.0, 99.9)) -> dict[float, float]:
    """Tail percentiles (numpy linear interpolation) keyed by q; nan on an
    empty sample.  Shared by offline ``RunStats`` and online ``ServeStats``
    so p50/p99/p999 mean the same thing in both reports."""
    arr = np.asarray([v for v in values], dtype=np.float64)
    if arr.size == 0:
        return {float(q): float("nan") for q in qs}
    qlist = [float(q) for q in qs]
    vals = np.percentile(arr, qlist)
    return dict(zip(qlist, (float(v) for v in vals)))


def _tenant_of(task: Task) -> str:
    return str(task.attrs.get("tenant", "default"))


@dataclass
class RunStats:
    timeline: Timeline
    mapping: dict[int, str]
    overhead: dict[int, float] = field(default_factory=dict)   # uid -> seconds
    queries: dict[int, int] = field(default_factory=dict)
    hops: dict[int, int] = field(default_factory=dict)
    unmapped: list[int] = field(default_factory=list)

    def qos_failures(self, cfg: TaskGraph) -> int:
        return sum(0 if self.timeline.deadline_met(t) else 1 for t in cfg)

    def qos_failure_rate(self, cfg: TaskGraph) -> float:
        dl = [t for t in cfg if t.deadline is not None]
        if not dl:
            return 0.0
        return sum(0 if self.timeline.deadline_met(t) else 1
                   for t in dl) / len(dl)

    def mean_overhead_ratio(self, cfg: TaskGraph) -> float:
        """Fig. 14 metric: scheduling overhead / task execution time."""
        ratios = []
        for t in cfg:
            exec_t = (self.timeline.finish[t.uid] - self.timeline.start[t.uid])
            if exec_t > 0 and t.uid in self.overhead:
                ratios.append(self.overhead[t.uid] / exec_t)
        return float(np.mean(ratios)) if ratios else 0.0

    # -- tail metrics (same definitions as serving.ServeStats) -------------
    def latencies(self, cfg: TaskGraph) -> list[float]:
        """Per-task ready-to-finish latencies over ``cfg``, in cfg order
        (tasks that never finished — partial timelines — are skipped)."""
        return [self.timeline.latency(t) for t in cfg
                if t.uid in self.timeline.finish]

    def latency_percentiles(self, cfg: TaskGraph,
                            qs: Iterable[float] = (50.0, 99.0, 99.9),
                            ) -> dict[float, float]:
        """p50/p99/p999 task latency — the offline counterpart of the
        serving report's request tails."""
        return percentiles(self.latencies(cfg), qs)

    def latencies_by_tenant(self, cfg: TaskGraph) -> dict[str, list[float]]:
        """Latencies grouped by each task's ``attrs["tenant"]`` (tasks
        without one land in the "default" group)."""
        out: dict[str, list[float]] = {}
        for t in cfg:
            if t.uid in self.timeline.finish:
                out.setdefault(_tenant_of(t), []).append(
                    self.timeline.latency(t))
        return out

    def latency_percentiles_by_tenant(
            self, cfg: TaskGraph,
            qs: Iterable[float] = (50.0, 99.0, 99.9),
            ) -> dict[str, dict[float, float]]:
        return {ten: percentiles(vals, qs)
                for ten, vals in self.latencies_by_tenant(cfg).items()}

    def sla_attainment(self, cfg: TaskGraph) -> dict[str, float]:
        """Per-tenant fraction of deadline-carrying tasks that met their
        deadline (tenants with no deadlines are omitted)."""
        tot: dict[str, int] = {}
        ok: dict[str, int] = {}
        for t in cfg:
            if t.deadline is None or t.uid not in self.timeline.finish:
                continue
            ten = _tenant_of(t)
            tot[ten] = tot.get(ten, 0) + 1
            ok[ten] = ok.get(ten, 0) + (1 if self.timeline.deadline_met(t)
                                        else 0)
        return {ten: ok[ten] / tot[ten] for ten in tot}


def _any_supporting(graph: HWGraph, task: Task) -> Optional[MapResult]:
    """Degraded fallback when the policy declines a task: any PU that can
    run it at all, so execution remains defined."""
    for pu in graph.pus():
        if pu.model is None or not pu.model.supports(task, pu):
            continue
        if (task.attrs.get("pinned") and
                graph.device_of(pu.name).name != task.origin):
            continue
        return MapResult(pu=pu.name,
                         prediction=TaskPrediction(pu.predict(task), 1.0, 0.0))
    return None


Policy = Union[Callable[[Task, float], Optional[MapResult]], Orchestrator]


class SchedulerSession:
    """Batch-first scheduling over one graph: submit, map, execute.

    ``policy`` may be

    * an :class:`Orchestrator` (typically the root): waves go through
      ``map_batch(..., route=True)``, entering at each task's origin
      device ORC;
    * any object with a ``map_batch(tasks, now)`` method (e.g. the
      simulator policies);
    * a plain ``assign(task, now) -> MapResult`` callable: waves fall
      back to per-task calls in order (sequential-compatible).

    Typical use::

        session = SchedulerSession(graph, root, truth=truth)
        session.submit(cfg)                  # a TaskGraph, or more later
        stats = session.run()                # map frontiers + execute
    """

    def __init__(self, graph: HWGraph, policy: Policy,
                 truth: Optional[Traverser] = None,
                 charge_overhead: bool = True,
                 frontier: bool = True) -> None:
        self.graph = graph
        self.device = graph.device      # raises without CUDA unless "cpu"
        self.policy = policy
        self.truth = truth
        self.charge_overhead = charge_overhead
        self.frontier = frontier
        if isinstance(policy, Orchestrator):
            # lower the ORC tree to its compiled scan plans up front so
            # the first mapping wave doesn't pay the one-time build
            policy.prepare(graph.compiled())
        self._cfg = TaskGraph("session")
        self._mapped: set[int] = set()
        # submitted-but-unmapped tasks: the wave loop scans this instead
        # of the whole (ever-growing) session CFG, so a serving session's
        # per-wave mapping cost tracks the wave size, not the history
        self._pending: list[Task] = []
        self.results: dict[int, Optional[MapResult]] = {}
        self.mapping: dict[int, str] = {}
        self.unmapped: list[int] = []
        # session-resident timeline (serving mode); opens count full engine
        # builds — a healthy serving run opens exactly once
        self.engine: Optional[TimelineEngine] = None
        self.engine_opens = 0

    # -- submission ---------------------------------------------------------
    def submit(self, work: Union[TaskGraph, Iterable[Task]]) -> "SchedulerSession":
        """Enqueue a whole TaskGraph, or a streaming batch of independent
        tasks.  May be called repeatedly (uids are globally unique)."""
        if isinstance(work, TaskGraph):
            for t in work.tasks:
                self._cfg.tasks.append(t)
                self._cfg._succ.setdefault(t.uid, []).extend(work.succs(t))
                self._cfg._pred.setdefault(t.uid, []).extend(work.preds(t))
                self._pending.append(t)
        else:
            for t in work:
                self._cfg.add(t)
                self._pending.append(t)
        return self

    @property
    def cfg(self) -> TaskGraph:
        return self._cfg

    # -- frontier construction ---------------------------------------------
    def _waves(self) -> Iterable[tuple[float, list[Task]]]:
        """Yield (now, tasks) mapping waves over the pending tasks.

        Frontier mode: dependency-ready tasks sharing the earliest pending
        release instant.  Sequential mode: singleton waves in strict
        (release, uid) order with no readiness gating (seed semantics).
        Release times are read before any overhead is charged."""
        still = [t for t in self._pending if t.uid not in self._mapped]
        self._pending = still
        pending = sorted(still, key=lambda t: (t.release_time, t.uid))
        if not self.frontier:
            for t in pending:
                yield t.release_time, [t]
            return
        done = set(self._mapped)
        remaining = pending
        while remaining:
            ready = [t for t in remaining
                     if all(p.uid in done for p in self._cfg.preds(t))]
            if not ready:
                raise ValueError("dependency cycle or missing producer in "
                                 f"submitted tasks: {remaining[:3]}")
            r0 = ready[0].release_time
            wave = [t for t in ready if t.release_time == r0]
            yield r0, wave
            for t in wave:
                done.add(t.uid)
            remaining = [t for t in remaining if t.uid not in done]

    # -- mapping ------------------------------------------------------------
    def _assign_wave(self, wave: list[Task],
                     now: float) -> list[Optional[MapResult]]:
        pol = self.policy
        if isinstance(pol, Orchestrator):
            return pol.map_batch(wave, now, route=True)
        batch = getattr(pol, "map_batch", None)
        if batch is not None and (self.frontier or len(wave) > 1):
            return batch(wave, now)
        return [pol(t, now) for t in wave]

    def map_pending(self, fallback: bool = True,
                    ) -> dict[int, Optional[MapResult]]:
        """Drive the wave loop over everything submitted but not yet
        mapped; commits assignments and charges overhead.  Returns the
        results of this call only.

        ``fallback=False`` records a declined task as ``None`` instead of
        degrading to any supporting PU — the admission-control path, where
        infeasibility must surface as a reject/defer signal rather than a
        desperate placement (withdraw the task afterwards)."""
        out: dict[int, Optional[MapResult]] = {}
        comp = self.graph.compiled()
        for now, wave in self._waves():
            for t in wave:
                preds = self._cfg.preds(t)
                placed = [p.assigned_pu for p in preds if p.assigned_pu]
                if placed:
                    t.attrs["src_devices"] = sorted(
                        {comp.device_name(pu) for pu in placed})
            results = self._assign_wave(wave, now)
            for t, res in zip(wave, results):
                self._mapped.add(t.uid)
                if res is None:
                    self.unmapped.append(t.uid)
                    if not fallback:
                        out[t.uid] = None
                        self.results[t.uid] = None
                        continue
                    # fall back to any supporting PU so execution remains
                    # defined
                    res = _any_supporting(self.graph, t)
                    if res is None:
                        raise RuntimeError(f"no PU supports {t}")
                self.mapping[t.uid] = res.pu
                out[t.uid] = res
                self.results[t.uid] = res
                if self.charge_overhead and res.overhead:
                    # a release-time change on a ledger-resident row: tell
                    # the ledger so cached views re-read it
                    t.release_time += res.overhead
                    pol = self.policy
                    if isinstance(pol, Orchestrator):
                        touch = getattr(pol.ledger, "touch", None)
                        if touch is not None:
                            touch(comp.device_name(res.pu))
        return out

    def withdraw(self, task: Task) -> None:
        """Undo a mapping commit and drop ``task`` from the session — the
        admission-rejection path.  Reverts the overhead charge, clears the
        ledger belief and ``assigned_pu``, and removes the task from the
        session CFG.  Tasks already injected into a resident timeline
        cannot be withdrawn (their intervals are settled history)."""
        if self.engine is not None and task.uid in self.engine.slot_of:
            raise ValueError(
                f"{task} is already injected into the resident timeline")
        res = self.results.pop(task.uid, None)
        self.mapping.pop(task.uid, None)
        self._mapped.discard(task.uid)
        self._pending = [t for t in self._pending if t.uid != task.uid]
        if task.uid in self.unmapped:
            self.unmapped.remove(task.uid)
        if res is not None:
            if self.charge_overhead:
                task.release_time -= res.overhead
            task.assigned_pu = None
            if isinstance(self.policy, Orchestrator):
                self.policy.ledger.remove(task)
        self._cfg.remove(task)

    # -- resident timeline (online serving) ---------------------------------
    def open_timeline(self, interventions=()) -> TimelineEngine:
        """Open the session-resident DES timeline: built once, advanced to
        each admission instant, fed by ``inject``.  The engine shares this
        session's CFG and mapping dict, so later ``map_pending`` commits
        are visible without copying.  Anything already submitted must be
        mapped first (its releases enter the event heap at open)."""
        if self.engine is not None:
            raise RuntimeError("resident timeline already open")
        if self.truth is None:
            from .simulator import ground_truth_traverser
            self.truth = ground_truth_traverser(self.graph)
        self.engine = TimelineEngine.open(
            self.truth, cfg=self._cfg, mapping=self.mapping,
            interventions=interventions)
        self.engine_opens += 1
        return self.engine

    def inject(self, tasks: Iterable[Task]) -> None:
        """Push freshly mapped tasks into the resident timeline."""
        if self.engine is None:
            raise RuntimeError("open_timeline() first")
        self.engine.inject(list(tasks))

    def churn(self, delta: Churn, at: Optional[float] = None) -> None:
        """Apply (or schedule) one :class:`~.hwgraph.Churn` delta batch.

        * ``at`` set: queued on the resident timeline at simulated time
          ``at`` (requires an open engine).
        * engine open, ``at`` omitted: applied at the current engine
          clock through the one-flush reprice path.
        * no engine: applied to the graph immediately; the compiled
          snapshot absorbs it via ``apply_delta`` and the next
          ``map_pending`` sees the new topology.
        """
        if at is not None:
            if self.engine is None:
                raise RuntimeError(
                    "churn(at=...) schedules on the resident timeline — "
                    "open_timeline() first (or omit `at`)")
            self.engine.schedule(at, delta)
        elif self.engine is not None:
            self.engine.apply_churn(delta)
        else:
            self.graph.apply_churn(delta)

    def finalize_online(self, drain: bool = True) -> RunStats:
        """Collect RunStats from the resident timeline.  ``drain=True``
        advances to quiescence first (every injected task finishes);
        ``drain=False`` snapshots mid-flight (partial timeline)."""
        if self.engine is None:
            raise RuntimeError("open_timeline() first")
        if drain:
            self.engine.advance()
        return self._stats(self.engine.timeline(partial=not drain))

    # -- execution ----------------------------------------------------------
    def _stats(self, tl: Timeline) -> RunStats:
        stats = RunStats(timeline=tl, mapping=dict(self.mapping),
                         unmapped=list(self.unmapped))
        for uid, res in self.results.items():
            if res is not None:
                stats.overhead[uid] = res.overhead
                stats.queries[uid] = res.queries
                stats.hops[uid] = res.hops
        return stats

    def execute(self) -> RunStats:
        """Run everything mapped so far through the ground-truth engine
        (a fresh one-shot traverse — the offline path)."""
        if self.truth is None:
            from .simulator import ground_truth_traverser
            self.truth = ground_truth_traverser(self.graph)
        tl = self.truth.traverse(self._cfg, self.mapping)
        return self._stats(tl)

    def run(self, work: Optional[Union[TaskGraph, Iterable[Task]]] = None,
            ) -> RunStats:
        """submit (optional) + map every pending frontier + execute."""
        if work is not None:
            self.submit(work)
        self.map_pending()
        return self.execute()
