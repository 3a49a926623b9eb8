"""Traverser: predict performance of a CFG of tasks on mapped PUs, accounting
for shared-resource slowdown between concurrently running tasks (paper §3.4).

The Traverser walks the CFG in time order and splits execution into
**contention intervals** (Fig. 6): maximal time spans during which the set of
co-running tasks is constant.  Within an interval each task progresses at
``1 / slowdown_factor`` of its standalone speed; at interval boundaries the
factors are recomputed.  The simulation itself runs on the struct-of-arrays
``core.timeline.TimelineEngine`` (dense job/transfer tables on the
traverser's device, one kernel settle per timestamp, one repricing call per
flush across every dirty device); the seed's per-job ``heapq`` event loop
survives as :meth:`Traverser.traverse_reference` — the port's own parity
oracle (1e-9 agreement).  Transfer routes come from the compiled (lazily
materialized) route tables instead of per-query Dijkstra runs.

Randomness: the only draws are per-task work noise at job start, one host
scalar each, from the ``numpy.random.Generator`` passed in as ``rng`` (the
traverser never seeds anything globally).

The same engine serves two roles:

* **Prediction** (H-EYE's Traverser proper): linear calibrated slowdown
  model, no noise — called by the Orchestrator for constraint checks.
* **Ground truth** (core/simulator.py): superlinear slowdown + per-task
  irregular-access noise — stands in for the paper's physical testbed.

Communication is first-class: data moving between devices becomes a
TransferJob that *shares link bandwidth* with concurrent transfers
(paper Fig. 12's dynamic-bandwidth experiments rely on this).
"""
from __future__ import annotations

import heapq
import itertools
import math
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from ..device import host_list
from .hwgraph import EdgeAttr, HWGraph, ProcessingUnit
from .slowdown import DecoupledSlowdown
from .task import Task, TaskGraph
from .timeline import Timeline, TimelineEngine


@dataclass
class TaskPrediction:
    """Closed-form single-task prediction used by Orchestrator checks."""

    standalone: float
    factor: float
    comm: float

    @property
    def total(self) -> float:
        return self.comm + self.standalone * self.factor


class _ComputeJob:
    __slots__ = ("task", "pu", "device", "W", "rate", "t_last", "version", "start")

    def __init__(self, task: Task, pu: str, device: str, work: float, t: float):
        self.task = task
        self.pu = pu
        self.device = device
        self.W = work
        self.rate = 1.0
        self.t_last = t
        self.version = 0
        self.start = t


class _TransferJob:
    __slots__ = ("key", "consumer_uid", "edges", "W", "rate", "t_last",
                 "version", "latency")

    def __init__(self, key: int, consumer_uid: int, edges: list[EdgeAttr],
                 nbytes: float, latency: float, t: float):
        self.key = key
        self.consumer_uid = consumer_uid
        self.edges = edges
        self.W = max(nbytes, 0.0)
        self.rate = 1.0
        self.t_last = t
        self.version = 0
        self.latency = latency


class Traverser:
    """Predicts CFG performance on a given task->PU mapping (no scheduling)."""

    def __init__(self, graph: HWGraph, slowdown: Optional[DecoupledSlowdown] = None,
                 noise: float = 0.0, rng: Optional[np.random.Generator] = None):
        self.graph = graph
        self.device = graph.device      # raises without CUDA unless "cpu"
        self.slowdown = slowdown or DecoupledSlowdown(graph)
        self.noise = noise
        self.rng = rng or np.random.default_rng(0)

    # ------------------------------------------------------------------
    # Closed-form single-task prediction (Orchestrator constraint checks)
    # ------------------------------------------------------------------
    def predict_task(self, task: Task, pu_name: str,
                     active: list[tuple[Task, str]] = ()) -> TaskPrediction:
        pu = self.graph.nodes[pu_name]
        assert isinstance(pu, ProcessingUnit)
        comp = self.graph.compiled()
        standalone = pu.predict(task)
        factor = self.slowdown.factor(task, pu_name, list(active))
        comm = self.comm_time(task, pu_name, comp)
        return TaskPrediction(standalone=standalone, factor=factor, comm=comm)

    def comm_time(self, task: Task, pu_name: str, comp=None) -> float:
        """Inbound transfer time of ``task``'s input onto ``pu_name``'s device."""
        comp = comp or self.graph.compiled()
        return self.comm_time_dev(task, comp.device_name(pu_name), comp)

    def comm_time_dev(self, task: Task, dst_dev: str, comp=None) -> float:
        """Inbound transfer time of ``task``'s input onto device ``dst_dev``.

        Data comes from the producers' devices (set by the runtime once
        predecessors are placed), falling back to the task's origin."""
        if task.input_bytes <= 0:
            return 0.0
        comp = comp or self.graph.compiled()
        srcs = task.attrs.get("src_devices")
        if not srcs and task.origin is not None:
            srcs = [task.origin]
        comm = 0.0
        for src_dev in srcs or []:
            if src_dev != dst_dev:
                comm = max(comm, comp.transfer_time(
                    src_dev, dst_dev, task.input_bytes))
        return comm

    def predict_active_with(self, new_task: Task, new_pu: str,
                            active: list[tuple[Task, str]]) -> dict[int, float]:
        """Updated slowdown factor of each active task if new_task joins."""
        batch = getattr(self.slowdown, "factors_with_candidates", None)
        if batch is not None:
            _, act_f = batch(new_task, [new_pu], list(active))
            return {t.uid: float(f)
                    for (t, _), f in zip(active, host_list(act_f[0]))}
        out: dict[int, float] = {}
        pool = list(active) + [(new_task, new_pu)]
        for t, p in active:
            others = [(t2, p2) for t2, p2 in pool if t2.uid != t.uid]
            out[t.uid] = self.slowdown.factor(t, p, others)
        return out

    # ------------------------------------------------------------------
    # Full CFG traverse (contention-interval event simulation)
    # ------------------------------------------------------------------
    def traverse(self, cfg: TaskGraph, mapping: dict[int, str],
                 background: list[tuple[Task, str, float]] = (),
                 interventions: list[tuple[float, Any]] = (),
                 engine: str = "fused",
                 ) -> Timeline:
        """Simulate ``cfg`` under ``mapping`` (task.uid -> pu name).

        ``background``: (task, pu, remaining_standalone_seconds) triples of
        already-running tasks that contend but whose dependencies are done.
        ``interventions``: (t, fn) pairs applied at simulated time ``t``
        — ``fn`` a zero-arg callable or a :class:`~.hwgraph.Churn` delta
        batch; every active device pool and link set is repriced at that
        instant.

        ``engine`` selects the event loop — the single selector over the
        two DES implementations:

        * ``"fused"`` (default): the array-native
          :class:`core.timeline.TimelineEngine` (``interventions`` are
          not supported on it in this slice).  A *noisy slowdown
          model* (rng-bearing) draws inside ``factor()`` in per-device
          pool order, which only the seed event loop reproduces
          byte-for-byte — those configurations fall back to the
          reference engine automatically (note: the ground-truth
          engine's per-task work noise is NOT this case; it is drawn at
          job start and the array engine preserves its stream).
        * ``"reference"``: the seed's per-job heapq event loop, kept
          as the port's 1e-9 parity oracle.
        """
        if engine not in ("fused", "reference"):
            raise ValueError(
                f"engine must be 'fused' or 'reference', got {engine!r}")
        if (engine == "reference"
                or bool(getattr(self.slowdown, "_noisy", lambda: False)())):
            return self._traverse_seed(cfg, mapping, background,
                                       interventions)
        return TimelineEngine(self, cfg, mapping, background,
                              interventions).run()

    def traverse_reference(self, cfg: TaskGraph, mapping: dict[int, str],
                           background: list[tuple[Task, str, float]] = (),
                           interventions: list[tuple[float, Any]] = (),
                           ) -> Timeline:
        """Alias for ``traverse(..., engine="reference")``."""
        return self.traverse(cfg, mapping, background, interventions,
                             engine="reference")

    def _traverse_seed(self, cfg: TaskGraph, mapping: dict[int, str],
                       background: list[tuple[Task, str, float]] = (),
                       interventions: list[tuple[float, Any]] = (),
                       ) -> Timeline:
        """The seed's per-job heapq event loop: the parity oracle for
        ``TimelineEngine`` (1e-9)."""
        tl = Timeline(mapping=dict(mapping))
        heap: list[tuple[float, int, str, Any]] = []
        seq = itertools.count()
        time = 0.0
        comp = self.graph.compiled()      # topology is frozen during a traverse
        from .timeline import warm_transfer_routes
        # freeze transfer routes against the pre-churn topology (route
        # rows are lazily materialized; both engines warm identically so
        # interventions cannot skew which graph version a route sees)
        warm_transfer_routes(comp, cfg, mapping)
        factor_batch = getattr(self.slowdown, "factor_batch", None)

        # --- state ---
        compute: dict[int, _ComputeJob] = {}               # task.uid -> job
        dev_members: dict[str, set[int]] = defaultdict(set)
        transfers: dict[int, _TransferJob] = {}
        xfer_seq = itertools.count()
        edge_members: dict[int, set[int]] = defaultdict(set)   # id(edge) -> xfer keys
        pu_running: dict[str, int] = defaultdict(int)
        pu_queue: dict[str, deque[Task]] = defaultdict(deque)
        waiting: dict[int, int] = {}                        # uid -> inbound count
        ready_at: dict[int, float] = {}                     # uid -> data-arrival time
        task_by_uid = {t.uid: t for t in cfg}
        finished: set[int] = set()

        def push(t: float, kind: str, payload: Any) -> None:
            heapq.heappush(heap, (t, next(seq), kind, payload))

        # --- rate maintenance -------------------------------------------
        # Repricing is *frontier-batched*: handlers only mark devices/edges
        # dirty, and one flush per distinct event timestamp reprices each
        # dirty device pool and the union of touched links once — a
        # producer fanning out K transfers (or a release wave starting K
        # tasks) costs one repricing call, not K.  Rates are piecewise
        # constant and settle() at an unchanged timestamp is a no-op, so
        # the deferred flush computes exactly the rates the per-change
        # repricing would have.
        dirty_devs: set[str] = set()
        dirty_edges: dict[int, EdgeAttr] = {}

        def settle(job) -> None:
            job.W = max(0.0, job.W - job.rate * (time - job.t_last))
            job.t_last = time

        def reprice_device(dev: str) -> None:
            """Contention-interval boundary: recompute every member's rate.

            The whole pool is evaluated in one vectorized shot against the
            compiled arrays instead of O(n^2) Python pair loops."""
            members = [compute[u] for u in sorted(dev_members[dev])]
            pool = [(j.task, j.pu) for j in members]
            if factor_batch is not None:
                factors = factor_batch(pool)
                if isinstance(factors, torch.Tensor):
                    factors = host_list(factors)
            else:
                factors = [self.slowdown.factor(j.task, j.pu, pool)
                           for j in members]
            for j, f in zip(members, factors):
                settle(j)
                j.rate = 1.0 / float(f)
                j.version += 1
                push(time + j.W / j.rate, "cdone", (j.task.uid, j.version))
            tl.n_intervals += 1

        def reprice_edges(edges: list[EdgeAttr]) -> None:
            affected: set[int] = set()
            for e in edges:
                affected |= edge_members[id(e)]
            # deterministic tie-break: transfers repriced (and hence their
            # completion events pushed) in key order, so simultaneous
            # completions settle in a pinned order — the array engine's
            # scan order, and stable across hash seeds
            for k in sorted(affected):
                x = transfers[k]
                settle(x)
                bw = min(e.bandwidth / max(1, len(edge_members[id(e)]))
                         for e in x.edges) if x.edges else float("inf")
                x.rate = bw
                x.version += 1
                eta = time + (x.W / x.rate if x.rate > 0 else float("inf"))
                push(eta, "xdone", (x.key, x.version))

        def flush() -> None:
            if dirty_devs:
                for dev in sorted(dirty_devs):   # deterministic tie-break
                    reprice_device(dev)
                dirty_devs.clear()
            if dirty_edges:
                reprice_edges(list(dirty_edges.values()))
                dirty_edges.clear()

        # --- job lifecycle ----------------------------------------------
        def start_compute(task: Task) -> None:
            pu_name = mapping[task.uid]
            pu = self.graph.nodes[pu_name]
            assert isinstance(pu, ProcessingUnit), pu_name
            if pu_running[pu_name] >= pu.max_tenancy:
                pu_queue[pu_name].append(task)
                return
            pu_running[pu_name] += 1
            sa = pu.predict(task)
            work = sa
            if self.noise > 0.0:
                irr = task.attrs.get("irregularity", 1.0)
                work = sa * float(np.exp(self.rng.normal(0.0, self.noise * irr)))
            dev = comp.device_name(pu_name)
            job = _ComputeJob(task, pu_name, dev, work, time)
            compute[task.uid] = job
            dev_members[dev].add(task.uid)
            tl.start[task.uid] = time
            tl.standalone[task.uid] = sa
            tl.queue_wait[task.uid] = time - ready_at.get(task.uid, task.release_time)
            dirty_devs.add(dev)

        def launch_transfer(consumer: Task, src_dev: str, dst_dev: str,
                            nbytes: float) -> bool:
            """Returns True if a transfer was started (False = local/no data)."""
            if src_dev == dst_dev or nbytes <= 0:
                return False
            edges = comp.route_edges(src_dev, dst_dev)
            lat = sum(e.latency for e in edges)
            key = next(xfer_seq)
            x = _TransferJob(key, consumer.uid, edges, nbytes, lat, time)
            transfers[key] = x
            for e in edges:
                edge_members[id(e)].add(key)
                dirty_edges[id(e)] = e
            return True

        def data_arrived(uid: int) -> None:
            waiting[uid] -= 1
            if waiting[uid] == 0:
                ready_at[uid] = time
                dep_done = max(task_by_uid[uid].release_time, _dep_finish(uid))
                tl.ready[uid] = dep_done
                tl.comm[uid] = time - dep_done
                start_compute(task_by_uid[uid])

        def _dep_finish(uid: int) -> float:
            preds = cfg.preds(task_by_uid[uid])
            return max((tl.finish[p.uid] for p in preds if p.uid in tl.finish),
                       default=task_by_uid[uid].release_time)

        def finish_compute(uid: int) -> None:
            job = compute.pop(uid)
            dev_members[job.device].discard(uid)
            pu_running[job.pu] -= 1
            tl.finish[uid] = time
            finished.add(uid)
            # successors: dependency bookkeeping + inter-device transfers
            t = task_by_uid.get(uid)
            if t is not None:
                for s in cfg.succs(t):
                    dst_dev = comp.device_name(mapping[s.uid])
                    if launch_transfer(s, job.device, dst_dev, t.output_bytes):
                        pass  # data_arrived fires on xdone
                    else:
                        data_arrived(s.uid)
            # wake queued tasks on this PU
            q = pu_queue[job.pu]
            if q:
                start_compute(q.popleft())
            dirty_devs.add(job.device)

        # --- initialization ----------------------------------------------
        for t in cfg:
            if t.uid not in mapping:
                raise KeyError(f"{t} has no mapping")
            waiting[t.uid] = len(cfg.preds(t)) + 1     # +1 for the release event
        for it, ifn in interventions:
            push(it, "intervene", ifn)
        for bt, bpu, brem in background:
            dev = comp.device_name(bpu)
            job = _ComputeJob(bt, bpu, dev, brem, 0.0)
            compute[bt.uid] = job
            dev_members[dev].add(bt.uid)
            pu_running[bpu] += 1
            tl.start[bt.uid] = 0.0
            tl.standalone[bt.uid] = brem
            dirty_devs.add(dev)
        flush()
        for t in cfg:
            if not cfg.preds(t):
                push(t.release_time, "release", t.uid)
            else:
                push(t.release_time, "release", t.uid)

        # --- event loop ---------------------------------------------------
        # all events sharing one timestamp drain before a single flush
        # reprices the devices/links they touched (frontier batching)
        while heap:
            time = max(time, heap[0][0])
            while heap and heap[0][0] <= time:
                _, _, kind, payload = heapq.heappop(heap)
                tl.n_events += 1
                if kind == "cdone":
                    uid, ver = payload
                    job = compute.get(uid)
                    if job is None or job.version != ver:
                        continue
                    settle(job)
                    if job.W > 1e-15:   # stale estimate; a fresh one is queued
                        continue
                    finish_compute(uid)
                elif kind == "xdone":
                    key, ver = payload
                    x = transfers.get(key)
                    if x is None or x.version != ver:
                        continue
                    settle(x)
                    if x.W > 1e-6:
                        continue
                    # latency tail: propagate arrival after fixed route latency
                    transfers.pop(key)
                    for e in x.edges:
                        edge_members[id(e)].discard(key)
                        dirty_edges[id(e)] = e
                    if x.latency > 0:
                        push(time + x.latency, "arrive", x.consumer_uid)
                    else:
                        data_arrived(x.consumer_uid)
                elif kind == "arrive":
                    data_arrived(payload)
                elif kind == "release":
                    uid = payload
                    t = task_by_uid[uid]
                    # initial input payload from the origin device
                    pu_dev = comp.device_name(mapping[uid])
                    if (t.origin is not None and t.input_bytes > 0
                            and not cfg.preds(t)):
                        if launch_transfer(t, t.origin, pu_dev, t.input_bytes):
                            continue
                    data_arrived(uid)
                elif kind == "intervene":
                    # churn boundary: apply the mutation, then reprice
                    # every occupied device pool and active link set.
                    # A Churn batch coalesces its bandwidth entries into
                    # one snapshot delta (layered route table); the
                    # repricing below reads live EdgeAttr bandwidths, so
                    # the oracle loop and TimelineEngine see identical
                    # post-churn link rates either way.
                    from .hwgraph import Churn
                    if isinstance(payload, Churn):
                        self.graph.apply_churn(payload)
                    else:
                        payload()
                    for dev, members in dev_members.items():
                        if members:
                            dirty_devs.add(dev)
                    for x in transfers.values():
                        for e in x.edges:
                            dirty_edges[id(e)] = e
                else:  # pragma: no cover
                    raise AssertionError(kind)
            flush()

        missing = [u for u in task_by_uid if u not in tl.finish]
        if missing:
            raise RuntimeError(f"traverse deadlock: unfinished {missing[:5]}")
        # background tasks may legitimately still be running; report their
        # projected finish assuming the final interval persists.
        for bt, bpu, _ in background:
            if bt.uid not in tl.finish and bt.uid in compute:
                job = compute[bt.uid]
                tl.finish[bt.uid] = time + job.W / job.rate
        return tl
