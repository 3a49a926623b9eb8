"""Array-native discrete-event timeline engine (paper §3.4, Alg. 2).

``TimelineEngine`` is the struct-of-arrays successor of the seed's
per-job ``heapq`` event loop (kept as ``Traverser.traverse_reference`` —
the port's own parity oracle).  The contention-interval semantics are
identical; what changes is the representation and the unit of work:

* **Dense job tables on the device** — every compute job and transfer
  lives in float64/int64 torch columns on the session's device
  (remaining virtual work ``W``, progress ``rate``, last-settle time
  ``t_last``, projected completion ``eta``, PU ordinals, reprice
  stamps).  Completion detection is a tensor compare against the shared
  timestamp.
* **Per-timestamp draining** — all events sharing one timestamp drain
  before a single flush reprices the devices/links they touched.  The
  settle of every compute completion across all devices is one launch
  of the fused settle-complete kernel, and the flush reprices *every*
  dirty device pool in one ``factor_batch_idx`` call, the pool form of
  the factor kernel over the job columns and the pool's rows (compute
  paths never cross device boundaries, so the union pool factors
  block-diagonally)
  and one launch of the fused settle-reprice kernel, both in place on
  the job columns.
* **Batched link repricing** — the bottleneck share of each affected
  transfer is the min over its route edges' fair shares, evaluated for
  the whole dirty set in one launch of the fused transfer-reprice
  kernel, which walks the CSR route-edge rows where they lie on the
  device, stamps, settles and re-projects every affected transfer in
  place, and lands the flush's changed per-edge member counts in the
  device's edge column (one packed upload: the affected slots, the
  changed edges, their counts).  A timestamp's finished transfers
  settle in one launch of the fused transfer-complete kernel.

Host and device: the control plane is host Python — the event heap,
dependency lists, tenancy counters, dirty sets, per-slot scalars that
handlers read one at a time (release time, standalone time, start and
finish stamps, a transfer's edge list).  Handlers never write a device
column one scalar at a time: job starts and transfer launches are queued
on the host and land in the columns as one batched write at the head of
the next flush (no column is read in between), and finished slots are
retired with one indexed store.  Columns grow by reallocation on the
device; no view of an old buffer is kept across a growth.

The inner loops are the port's float64 kernels
(``kernels.timeline_kernel``): CUDA for columns on the card, the plain
PyTorch versions for columns on the CPU.

Noise semantics: the ground-truth engine draws per-task irregularity
noise at job start, in event order, as one host scalar per job from the
``numpy.random.Generator`` the traverser was given — the array engine
preserves the draw order of the seed loop.  A *noisy slowdown model*
draws inside ``factor()`` in pool order; ``Traverser.traverse`` routes
that configuration to the reference loop.

**Interventions** (topology churn mid-run): ``traverse(...,
interventions=[(t, fn), ...])`` applies each ``fn`` — a zero-arg callable
or a declarative ``Churn`` batch — at simulated time ``t`` and reprices
every active device pool and link set at that instant.  The host
bandwidth list of the edges the engine has seen is refreshed from the
graph and the device edge column is dropped, so the next transfer
reprice uploads the post-churn bandwidths (a stale column would keep
dividing by the old ones, with results that still look plausible).

**Resident mode** (the serving path): ``TimelineEngine.open(...)`` brings
an engine live without draining it, ``advance(until)`` drains every event
up to ``until`` and parks the clock there, and ``inject(tasks)`` lands
newly mapped work in the live job and transfer columns mid-run (new rows
append to the device columns, releases enter the same host event heap,
and output handed over by an already-finished producer is priced by the
same one-flush reprice path as churn).  Submitting a full workload
upfront through a resident engine reproduces ``run()`` to 1e-9.
``drain_finished`` / ``finish_of`` / ``timeline(partial=True)`` observe
progress without disturbing it.  ``next_event_time`` reads the earliest
compute and transfer eta back from the card: one synchronising read per
call.
"""
from __future__ import annotations

import heapq
import itertools
import math
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from .. import spans
from ..device import FLOAT, INT, f64, host_item, host_list, i64, nonzero
from ..kernels import timeline_kernel as tk
from ..spans import OPEN as _SPANS
from .hwgraph import EdgeAttr, ProcessingUnit
from .task import Task, TaskGraph

# settle tolerances of the seed event loop (virtual work residue below
# which a projected completion is real, not a stale float artifact)
CTOL = 1e-15        # compute jobs
XTOL = 1e-6         # transfers (bytes)

_INF = float("inf")


@dataclass
class Timeline:
    """Result of a CFG traverse."""

    start: dict[int, float] = field(default_factory=dict)      # task.uid -> t
    finish: dict[int, float] = field(default_factory=dict)
    ready: dict[int, float] = field(default_factory=dict)      # deps resolved at
    standalone: dict[int, float] = field(default_factory=dict)
    comm: dict[int, float] = field(default_factory=dict)       # inbound comm time
    queue_wait: dict[int, float] = field(default_factory=dict)
    mapping: dict[int, str] = field(default_factory=dict)
    n_intervals: int = 0
    n_events: int = 0        # drained DES events (timed + completions)

    @property
    def makespan(self) -> float:
        return max(self.finish.values(), default=0.0)

    def latency(self, task: Task) -> float:
        """Ready-to-finish latency (comm + queueing + slowdown + compute).

        'Ready' = dependencies resolved (or release time for roots) — the
        moment the paper's runtime hands the task to the Orchestrator."""
        t0 = self.ready.get(task.uid, task.release_time)
        return self.finish[task.uid] - t0

    def slowdown_of(self, task: Task) -> float:
        busy = self.finish[task.uid] - self.start[task.uid]
        sa = self.standalone[task.uid]
        return busy / sa if sa > 0 else 1.0

    def deadline_met(self, task: Task) -> bool:
        if task.deadline is None:
            return True
        return self.latency(task) <= task.deadline * (1 + 1e-9)


def warm_transfer_routes(comp, cfg: TaskGraph, mapping: dict) -> int:
    """Batch-materialize every route row a traverse of ``cfg`` under
    ``mapping`` can touch: origins of root tasks with off-device initial
    payloads, and producer devices with off-device consumers.  Returns
    the number of rows built."""
    srcs: set[str] = set()
    for t in cfg:
        dev = comp.device_name(mapping[t.uid])
        if (t.origin is not None and t.input_bytes > 0
                and not cfg.preds(t) and t.origin != dev):
            srcs.add(t.origin)
        if t.output_bytes > 0 and any(
                comp.device_name(mapping[s.uid]) != dev
                for s in cfg.succs(t)):
            srcs.add(dev)
    ensure = getattr(comp, "ensure_routes", None)
    if srcs and ensure is not None:
        return ensure(srcs)
    return 0


# timed-event kinds, ordered only by (time, push seq) like the seed heap
_INTERVENE, _RELEASE, _ARRIVE = 0, 1, 2


class TimelineEngine:
    """A DES timeline over SoA state: one-shot (``run()``) or resident
    (``open`` / ``advance`` / ``inject``).

    Instantiated per ``Traverser.traverse`` call — or opened once per
    ``SchedulerSession`` for online serving; the engine freezes the
    compiled snapshot for transfer routes/device names (seed semantics)
    while slowdown factors read the live compiled snapshot through the
    model — exactly like the seed loop — so interventions that patch the
    topology take effect at the next contention-interval boundary.
    """

    def __init__(self, traverser, cfg: TaskGraph, mapping: dict[int, str],
                 background: Sequence[tuple[Task, str, float]] = (),
                 interventions: Sequence[tuple[float, Callable[[], Any]]] = (),
                 ) -> None:
        self.trav = traverser
        self.graph = traverser.graph
        self.device = traverser.device
        self.slowdown = traverser.slowdown
        self.noise = traverser.noise
        self.rng = traverser.rng
        self.cfg = cfg
        self.mapping = mapping
        self.background = list(background)
        self.interventions = list(interventions)
        self._opened = False

    # -- setup --------------------------------------------------------------
    _JCAP0 = 64         # initial job-table capacity (doubles on growth)
    _JCOLS_F = (("W", 0.0), ("rate", 1.0), ("t_last", 0.0), ("eta", _INF),
                ("U", 1.0), ("memraw", 1.0))
    _JCOLS_I = ("cstamp", "pu_i", "uid_col")
    _XCOLS_F = (("xW", 0.0), ("xrate", 1.0), ("xt_last", 0.0), ("xeta", _INF))
    # reprice stamps and each transfer's CSR row (start, count) in xe_flat
    _XCOLS_I = ("xstamp", "xe_start_col", "xe_cnt_col")

    def _grow_cols(self, fcols, icols, cap: int) -> None:
        """Reallocate device columns at ``cap`` slots.  Fresh slots carry
        each column's neutral fill (``eta`` +inf, so whole-column scans
        never see unused capacity); old contents are copied over and the
        old buffers dropped."""
        dev = self.device
        for col, fill in fcols:
            old = getattr(self, col, None)
            arr = torch.full((cap,), fill, dtype=FLOAT, device=dev)
            if old is not None:
                arr[:old.shape[0]] = old
            setattr(self, col, arr)
        for col in icols:
            old = getattr(self, col, None)
            arr = torch.zeros(cap, dtype=INT, device=dev)
            if old is not None:
                arr[:old.shape[0]] = old
            setattr(self, col, arr)

    def _jgrow(self, cap: int) -> None:
        self._grow_cols(self._JCOLS_F, self._JCOLS_I, cap)

    def _xgrow(self, cap: int) -> None:
        self._grow_cols(self._XCOLS_F, self._XCOLS_I, cap)

    def _init_state(self) -> None:
        g = self.graph
        comp = g.compiled()          # frozen: routes + device name space
        self.comp = comp
        self.n = 0
        self.slot_of: dict[int, int] = {}
        self._jgrow(self._JCAP0)
        # host mirrors of per-slot scalars the handlers read one at a time
        self.pu_il: list[int] = []
        self.Ul: list[float] = []
        self.meml: list[float] = []
        self.dev_ol: list[int] = []
        self.dev_name: list[str] = []
        self.pu_name: list[str] = []
        self.allt: list[Task] = []
        self.is_bg: list[bool] = []
        self.uidl: list[int] = []
        self._uid_monotone = True
        self.irr: list[float] = []
        self.rel: list[float] = []
        self.in_bytes: list[float] = []
        self.sa: list[float] = []
        self.preds: list[list[int]] = []
        self.succs: list[list[int]] = []
        self.waiting: list[int] = []
        # reprice stamps emulate the reference heap's push sequence so
        # *simultaneous* completions settle in the seed's event order
        self._stamp = 0
        # timeline columns (host: written and read one scalar at a time)
        self.start: list[float] = []
        self.finish: list[float] = []
        self.standalone: list[float] = []
        self.ready_t: list[float] = []
        self.comm_t: list[float] = []
        self.qwait: list[float] = []
        self.ready_at: list[float] = []
        # completion log for resident consumers (``drain_finished``)
        self._finish_log: list[int] = []
        self._finish_cursor = 0
        # tenancy
        self.pu_running = [0] * len(comp.pu_names)
        self.max_ten = host_list(comp.max_tenancy)
        self.pu_queue: dict[int, deque] = {}
        # device pools + repricing dirt
        self.dev_members: dict[int, set[int]] = {}
        self.dirty_devs: set[int] = set()
        self.dirty_edges: set[int] = set()
        self.n_intervals = 0
        self.n_events = 0
        # job starts queued for the next batched column write: (slot, work, t)
        self._pend_start: list[tuple[int, float, float]] = []
        # transfers (growable SoA) + edge table
        self._xgrow(64)
        self.xn = 0
        self.xlive = 0
        self.xconsumer: list[int] = []
        self.xlat: list[float] = []
        # per-transfer route edges in CSR form on the device:
        # xe_flat[xe_start_col[k] : xe_start_col[k] + xe_cnt_col[k]] are
        # transfer k's edge indices (host mirrors: xe_edges / xe_start /
        # xe_cnt)
        self.xe_flat = torch.zeros(256, dtype=INT, device=self.device)
        self.xe_top = 0
        self.xe_edges: list[list[int]] = []
        self.xe_start: list[int] = []
        self.xe_cnt: list[int] = []
        self._xe_synced = 0          # transfers whose CSR rows are on device
        # transfer launches queued for the next batched write: (k, bytes, t)
        self._pend_x: list[tuple[int, float, float]] = []
        self.edge_idx: dict[int, int] = {}
        self.edge_objs: list[EdgeAttr] = []
        self.edge_bw: list[float] = []
        # device copies of edge_bw / edge_members, rebuilt whole when a
        # route brings new edges; between rebuilds the counts of the edges
        # in _edge_unsynced land with the next transfer reprice
        self._edge_bw_arr: Optional[torch.Tensor] = None
        self._edge_mem_arr: Optional[torch.Tensor] = None
        self._edge_unsynced: set[int] = set()
        self.edge_members: list[int] = []
        self.edge_xfers: dict[int, set[int]] = {}
        self.route_cache: dict[tuple[str, str], tuple[list[int], float]] = {}
        # timed events
        self.heap: list[tuple[float, int, int, Any]] = []
        self.seq = itertools.count()
        self.time = 0.0
        # factor path: array-native when the model exposes ledger-column
        # scoring; otherwise per-device pools through the tuple surface
        self._fbi = getattr(self.slowdown, "factor_batch_idx", None)
        # memoized repricing: a pool's joint factors depend only on the
        # multiset of (PU, pu-usage, mem-usage) triples (uids are distinct
        # by construction), so pools that recur across readings/devices
        # hit a canonical-order cache.  The key is built from the host
        # mirrors — no device read.  Keyed per compiled snapshot.
        self._fcache: dict = {}
        self._fcache_comp = None

    def _ingest(self, new_tasks: Sequence[Task]) -> None:
        """Append ``new_tasks`` to the job tables (one batched write per
        device column).

        Dependencies must point at tasks in this batch or at ones already
        ingested (inject producers before — or together with — their
        consumers).  A producer that already *finished* hands its output
        over at the current instant: the cross-device transfer launches
        now and is priced by the caller's flush."""
        cfg, mapping, g, comp = self.cfg, self.mapping, self.graph, self.comp
        base = self.n
        need = base + len(new_tasks)
        if need > self.W.shape[0]:
            cap = self.W.shape[0]
            while cap < need:
                cap *= 2
            self._jgrow(cap)
        slot_of = self.slot_of
        last_uid = self.uidl[-1] if self.uidl else None
        mono = self._uid_monotone
        nan = float("nan")
        for i, t in enumerate(new_tasks):
            s = base + i
            if t.uid in slot_of:
                raise ValueError(f"{t} is already in the timeline")
            if t.uid not in mapping:
                raise KeyError(f"{t} has no mapping")
            pu_name = mapping[t.uid]
            pu = g.nodes[pu_name]
            assert isinstance(pu, ProcessingUnit), pu_name
            slot_of[t.uid] = s
            p = comp.pu_index[pu_name]
            self.pu_il.append(p)
            d = comp.pu_dev_ord_l[p]
            self.dev_ol.append(d)
            self.dev_name.append(comp.dev_ord_names[d])
            self.pu_name.append(comp.pu_names[p])
            self.allt.append(t)
            self.is_bg.append(False)
            if mono and last_uid is not None and t.uid <= last_uid:
                mono = False
            last_uid = t.uid
            self.uidl.append(t.uid)
            self.Ul.append(t.usage.get("pu", 1.0))
            self.meml.append(t.usage.get("mem", 1.0))
            self.irr.append(t.attrs.get("irregularity", 1.0))
            self.rel.append(t.release_time)
            self.in_bytes.append(t.input_bytes)
            # standalone predictions are pure per (task, PU)
            self.sa.append(pu.predict(t))
            for col in (self.start, self.finish, self.standalone,
                        self.ready_t, self.comm_t, self.qwait,
                        self.ready_at):
                col.append(nan)
        self._uid_monotone = mono
        self.n = need
        self._write_static(base, need)
        # dependency structure as slot lists: within-batch edges are wired
        # from cfg order (one-shot parity); cross-batch producers get this
        # consumer appended to their successor lists
        done_preds: list[tuple[int, int]] = []
        for i, t in enumerate(new_tasks):
            s = base + i
            pl: list[int] = []
            for pt in cfg.preds(t):
                ps = slot_of.get(pt.uid)
                if ps is None:
                    raise ValueError(
                        f"dependency {pt} of {t} is not in the timeline — "
                        "inject producers before (or together with) their "
                        "consumers")
                pl.append(ps)
                if ps < base:
                    self.succs[ps].append(s)
                    if self.finish[ps] == self.finish[ps]:   # already done
                        done_preds.append((s, ps))
            self.preds.append(pl)
            self.succs.append([slot_of[x.uid] for x in cfg.succs(t)
                               if slot_of.get(x.uid, -1) >= base])
            self.waiting.append(len(pl) + 1)   # +1: release event
        # pre-run route freeze (the incremental form of
        # warm_transfer_routes): origins of roots with off-device input
        # payloads, producer devices with off-device consumers
        srcs: set[str] = set()
        for i, t in enumerate(new_tasks):
            s = base + i
            dev = self.dev_name[s]
            if (t.origin is not None and t.input_bytes > 0
                    and not self.preds[s] and t.origin != dev):
                srcs.add(t.origin)
            if t.output_bytes > 0 and any(
                    self.dev_name[ss] != dev for ss in self.succs[s]):
                srcs.add(dev)
            for ps in self.preds[s]:
                if ps < base and self.allt[ps].output_bytes > 0 \
                        and self.dev_name[ps] != dev:
                    srcs.add(self.dev_name[ps])
        ensure = getattr(comp, "ensure_routes", None)
        if srcs and ensure is not None:
            ensure(srcs)
        # producers that finished before this batch arrived hand their
        # output over now; the release event still gates readiness (the
        # waiting floor is 1 until it drains), so a direct decrement never
        # starts compute early
        for s, ps in done_preds:
            ob = self.allt[ps].output_bytes
            if not self._launch(s, self.dev_name[ps], self.dev_name[s], ob):
                self.waiting[s] -= 1

    def _write_static(self, lo: int, hi: int) -> None:
        """Land the static per-slot columns of slots ``[lo, hi)`` on the
        device (W / rate / t_last / eta / cstamp keep their fresh fill)."""
        if hi <= lo:
            return
        dev = self.device
        self.pu_i[lo:hi] = i64(self.pu_il[lo:hi], dev)
        self.uid_col[lo:hi] = i64(self.uidl[lo:hi], dev)
        self.U[lo:hi] = f64(self.Ul[lo:hi], dev)
        self.memraw[lo:hi] = f64(self.meml[lo:hi], dev)

    def _ingest_background(self) -> None:
        """Background jobs occupy their PU from t=0 with known remaining
        standalone work; they have no deps, releases, or successors."""
        comp = self.comp
        base = self.n
        need = base + len(self.background)
        if need > self.W.shape[0]:
            cap = self.W.shape[0]
            while cap < need:
                cap *= 2
            self._jgrow(cap)
        last_uid = self.uidl[-1] if self.uidl else None
        mono = self._uid_monotone
        nan = float("nan")
        for k, (bt, bpu, brem) in enumerate(self.background):
            s = base + k
            self.slot_of[bt.uid] = s
            p = comp.pu_index[bpu]
            self.pu_il.append(p)
            d = comp.pu_dev_ord_l[p]
            self.dev_ol.append(d)
            self.dev_name.append(comp.dev_ord_names[d])
            self.pu_name.append(comp.pu_names[p])
            self.allt.append(bt)
            self.is_bg.append(True)
            if mono and last_uid is not None and bt.uid <= last_uid:
                mono = False
            last_uid = bt.uid
            self.uidl.append(bt.uid)
            self.Ul.append(bt.usage.get("pu", 1.0))
            self.meml.append(bt.usage.get("mem", 1.0))
            self.irr.append(bt.attrs.get("irregularity", 1.0))
            self.rel.append(bt.release_time)
            self.in_bytes.append(0.0)
            self.sa.append(brem)
            self.preds.append([])
            self.succs.append([])
            self.waiting.append(0)
            # running from t=0: occupy the PU and dirty its device pool
            self._pend_start.append((s, brem, 0.0))
            for col, v in ((self.start, 0.0), (self.finish, nan),
                           (self.standalone, brem), (self.ready_t, nan),
                           (self.comm_t, nan), (self.qwait, nan),
                           (self.ready_at, nan)):
                col.append(v)
            self.pu_running[p] += 1
            m = self.dev_members.get(d)
            if m is None:
                m = self.dev_members[d] = set()
            m.add(s)
            self.dirty_devs.add(d)
        self._uid_monotone = mono
        self.n = need
        self._write_static(base, need)

    def _push(self, t: float, kind: int, payload: Any) -> None:
        heapq.heappush(self.heap, (t, next(self.seq), kind, payload))

    # -- job lifecycle ------------------------------------------------------
    def _start_compute(self, s: int) -> None:
        p = self.pu_il[s]
        if self.pu_running[p] >= self.max_ten[p]:
            q = self.pu_queue.get(p)
            if q is None:
                q = self.pu_queue[p] = deque()
            q.append(s)
            return
        self.pu_running[p] = self.pu_running[p] + 1
        sa = self.sa[s]
        work = sa
        if self.noise > 0.0:
            work = sa * float(np.exp(self.rng.normal(
                0.0, self.noise * self.irr[s])))
        t = self.time
        # W / rate / t_last land with the next batched column write
        self._pend_start.append((s, work, t))
        self.start[s] = t
        self.standalone[s] = sa
        ra = self.ready_at[s]
        self.qwait[s] = t - (ra if ra == ra else self.rel[s])
        d = self.dev_ol[s]
        m = self.dev_members.get(d)
        if m is None:
            m = self.dev_members[d] = set()
        m.add(s)
        self.dirty_devs.add(d)

    def _route(self, src: str, dst: str) -> tuple[list[int], float]:
        key = (src, dst)
        hit = self.route_cache.get(key)
        if hit is None:
            edges = self.comp.route_edges(src, dst)
            idxs: list[int] = []
            lat = 0.0
            for e in edges:
                ei = self.edge_idx.get(id(e))
                if ei is None:
                    ei = len(self.edge_objs)
                    self.edge_idx[id(e)] = ei
                    self.edge_objs.append(e)
                    self.edge_bw.append(e.bandwidth)
                    self.edge_members.append(0)
                    self._edge_bw_arr = None
                idxs.append(ei)
                lat += e.latency
            hit = self.route_cache[key] = (idxs, lat)
        return hit

    def _launch(self, consumer: int, src_dev: str, dst_dev: str,
                nbytes: float) -> bool:
        """Start a transfer for ``consumer``'s input; False = local/no data."""
        if src_dev == dst_dev or nbytes <= 0:
            return False
        eidx, lat = self._route(src_dev, dst_dev)
        k = self.xn
        self.xn = k + 1
        self.xlive += 1
        # xW / xt_last land with the next batched column write (a fresh
        # slot already carries rate 1 and eta +inf: priced at the flush)
        self._pend_x.append((k, nbytes, self.time))
        self.xlat.append(lat)
        self.xconsumer.append(consumer)
        self.xe_edges.append(eidx)
        self.xe_start.append(self.xe_top)
        self.xe_cnt.append(len(eidx))
        self.xe_top += len(eidx)
        dirty = self.dirty_edges
        members = self.edge_members
        xfers = self.edge_xfers
        for e in eidx:
            members[e] += 1
            xs = xfers.get(e)
            if xs is None:
                xs = xfers[e] = set()
            xs.add(k)
            dirty.add(e)
        return True

    def _arrived(self, s: int) -> None:
        w = self.waiting[s] - 1
        self.waiting[s] = w
        if w == 0:
            t = self.time
            self.ready_at[s] = t
            dep = self.rel[s]
            for p in self.preds[s]:
                f = self.finish[p]
                if f > dep:
                    dep = f
            self.ready_t[s] = dep
            self.comm_t[s] = t - dep
            self._start_compute(s)

    def _finish(self, s: int) -> None:
        """Host bookkeeping of a finished job (its ``eta`` slot was
        already retired by the caller's batched store)."""
        t = self.time
        p = self.pu_il[s]
        self.pu_running[p] = self.pu_running[p] - 1
        self.finish[s] = t
        d = self.dev_ol[s]
        self.dev_members[d].discard(s)
        self._finish_log.append(s)
        out_bytes = self.allt[s].output_bytes
        src = self.dev_name[s]
        for ss in self.succs[s]:
            if not self._launch(ss, src, self.dev_name[ss], out_bytes):
                self._arrived(ss)
        q = self.pu_queue.get(p)
        if q:
            self._start_compute(q.popleft())
        self.dirty_devs.add(d)

    # -- batched column writes ------------------------------------------------
    def _apply_pending(self) -> None:
        """Land queued job starts and transfer launches in the device
        columns: one indexed store per column."""
        dev = self.device
        if self._pend_start:
            idx = i64([p[0] for p in self._pend_start], dev)
            self.W[idx] = f64([p[1] for p in self._pend_start], dev)
            self.t_last[idx] = f64([p[2] for p in self._pend_start], dev)
            self.rate[idx] = 1.0
            self._pend_start = []
        if self._pend_x:
            if self.xn > self.xW.shape[0]:
                cap = self.xW.shape[0]
                while cap < self.xn:
                    cap *= 2
                self._xgrow(cap)
            # the queued launches are the new slots [lo, xn), in order
            lo, hi = self._xe_synced, self.xn
            m = hi - lo
            pend = self._pend_x
            assert pend[0][0] == lo and len(pend) == m
            self._pend_x = []
            flts = f64([p[1] for p in pend] + [p[2] for p in pend], dev)
            self.xW[lo:hi] = flts[:m]
            self.xt_last[lo:hi] = flts[m:]
            # CSR rows of the new transfers: one upload of their starts,
            # counts and edges
            flat = [e for row in self.xe_edges[lo:] for e in row]
            top0 = self.xe_start[lo]
            if self.xe_top > self.xe_flat.shape[0]:
                buf = torch.zeros(max(2 * self.xe_flat.shape[0], self.xe_top),
                                  dtype=INT, device=dev)
                buf[:top0] = self.xe_flat[:top0]
                self.xe_flat = buf
            ints = i64(self.xe_start[lo:] + self.xe_cnt[lo:] + flat, dev)
            self.xe_start_col[lo:hi] = ints[:m]
            self.xe_cnt_col[lo:hi] = ints[m:2 * m]
            if flat:
                self.xe_flat[top0:self.xe_top] = ints[2 * m:]
            self._xe_synced = hi

    # -- repricing ----------------------------------------------------------
    def _pool_factors(self, mem_list: list[int],
                      members: torch.Tensor) -> torch.Tensor:
        n = len(mem_list)
        dev = self.device
        if self._fbi is not None:
            if n == 1:
                return torch.ones(1, dtype=FLOAT, device=dev)
            comp = self.graph.compiled()
            if comp is not self._fcache_comp:
                self._fcache_comp = comp
                self._fcache = {}
            pl, ul, ml = self.pu_il, self.Ul, self.meml
            trip = [(pl[m], ul[m], ml[m]) for m in mem_list]
            order = sorted(range(n), key=trip.__getitem__)
            key = tuple(trip[k] for k in order)
            hit = self._fcache.get(key)
            order_t = i64(order, dev)
            if hit is not None:
                out = torch.empty(n, dtype=FLOAT, device=dev)
                out[order_t] = hit
                return out
            f = self._fbi(self.pu_i, self.U, self.memraw, self.uid_col,
                          members=members)
            self._fcache[key] = f[order_t]
            return f
        # tuple fallback (custom slowdown models): per-device pools, like
        # the seed — cross-device interactions are not assumed absent
        out = [1.0] * n
        fb = getattr(self.slowdown, "factor_batch", None)
        allt = self.allt
        by_dev: dict[int, list[int]] = {}
        for k, m in enumerate(mem_list):
            by_dev.setdefault(self.dev_ol[m], []).append(k)
        for d in sorted(by_dev):
            sel = by_dev[d]
            pool = [(allt[mem_list[k]], self.pu_name[mem_list[k]])
                    for k in sel]
            if fb is not None:
                vals = fb(pool)
                vals = host_list(vals) if isinstance(vals, torch.Tensor) \
                    else list(vals)
            else:
                vals = [self.slowdown.factor(tk_, pu, pool)
                        for tk_, pu in pool]
            for k, v in zip(sel, vals):
                out[k] = float(v)
        return f64(out, dev)

    def _flush(self) -> bool:
        """Reprice every dirty device pool (one factor call) and every
        dirty link set (one segment-min).  Returns True when any rate was
        re-projected — i.e. when same-timestamp work may now exist."""
        sp = spans.enter("des.flush") if _SPANS else None
        t = self.time
        dev = self.device
        flushed = False
        self._apply_pending()
        if self.dirty_devs:
            self.n_intervals += len(self.dirty_devs)
            dm = self.dev_members
            # pool order replays the reference's completion-push sequence
            # (device name, then uid) so reprice stamps line up exactly
            names = self.comp.dev_ord_names
            uidl = self.uidl
            mem_list: list[int] = []
            if self._uid_monotone:
                for d in sorted(self.dirty_devs, key=names.__getitem__):
                    mem_list.extend(sorted(dm[d]))
            else:
                for d in sorted(self.dirty_devs, key=names.__getitem__):
                    mem_list.extend(sorted(dm[d], key=uidl.__getitem__))
            self.dirty_devs.clear()
            total = len(mem_list)
            if total:
                members = i64(mem_list, dev)
                factors = self._pool_factors(mem_list, members)
                # stamp, settle, reprice and project in one launch
                tk.settle_reprice(self.W, self.rate, self.t_last, self.eta,
                                  self.cstamp, members, factors, t,
                                  self._stamp)
                self._stamp += total
                flushed = True
        if self.dirty_edges:
            affected: set[int] = set()
            xfers = self.edge_xfers
            for e in self.dirty_edges:
                xs = xfers.get(e)
                if xs:
                    affected |= xs
            self._edge_unsynced |= self.dirty_edges
            self.dirty_edges.clear()
            if affected:
                if self._edge_bw_arr is None:
                    self._edge_bw_arr = f64(self.edge_bw, dev)
                    self._edge_mem_arr = i64(self.edge_members, dev)
                    self._edge_unsynced.clear()
                ks_l = sorted(affected)
                upd = sorted(self._edge_unsynced)
                self._edge_unsynced.clear()
                n_k, u = len(ks_l), len(upd)
                members = self.edge_members
                # one upload: the slots, the changed edges, their counts
                pack = i64(ks_l + upd + [members[e] for e in upd], dev)
                # stamp, bottleneck share, settle and project in one launch
                tk.transfer_reprice(self.xW, self.xrate, self.xt_last,
                                    self.xeta, self.xstamp, self.xe_flat,
                                    self.xe_start_col, self.xe_cnt_col,
                                    self._edge_bw_arr, self._edge_mem_arr,
                                    pack[:n_k], pack[n_k:n_k + u],
                                    pack[n_k + u:], t, self._stamp)
                self._stamp += n_k
                flushed = True
        if sp:
            spans.leave(sp)
        return flushed

    def _intervene(self, fn) -> None:
        from .hwgraph import Churn
        is_churn = isinstance(fn, Churn)
        if is_churn:
            # declarative delta batch: applied through the graph's churn
            # surface (bandwidth entries coalesce into one overlay copy)
            self.graph.apply_churn(fn)
        else:
            fn()
        # an intervention may mutate anything factors depend on (topology
        # OR model params): drop the memoized pool factors outright
        self._fcache = {}
        self._fcache_comp = None
        # churn boundary: reprice every occupied device pool and active
        # link set against the post-mutation model/bandwidths
        for d, members in self.dev_members.items():
            if members:
                self.dirty_devs.add(d)
        if is_churn and not (fn.dead or fn.alive):
            # bandwidth-only batch: only the named links moved
            changed = {name for name, _ in fn.bandwidth}
            for i, e in enumerate(self.edge_objs):
                if e.name in changed:
                    self.edge_bw[i] = e.bandwidth
        else:
            for i, e in enumerate(self.edge_objs):
                self.edge_bw[i] = e.bandwidth
        # the device edge column is rebuilt from the refreshed host list
        # at the next transfer reprice
        self._edge_bw_arr = None
        for e, xs in self.edge_xfers.items():
            if xs:
                self.dirty_edges.add(e)

    # -- completions --------------------------------------------------------
    def _complete_compute(self, done: torch.Tensor) -> None:
        sp = spans.enter("des.complete") if _SPANS else None
        t = self.time
        if done.shape[0] > 1:   # simultaneous: settle in reprice-stamp order
            done = done[torch.argsort(self.cstamp[done], stable=True)]
        # settle in place; finished slots get eta = +inf, a float residue
        # keeps running with a fresh estimate
        done_l, fin_l = host_list(tk.settle_complete(
            self.W, self.rate, self.t_last, self.eta, done, t, CTOL))
        self.n_events += len(done_l)
        for s, ok in zip(done_l, fin_l):
            if ok:
                self._finish(s)
        if sp:
            spans.leave(sp)

    def _complete_transfers(self, done: torch.Tensor) -> None:
        sp = spans.enter("des.complete") if _SPANS else None
        t = self.time
        if done.shape[0] > 1:   # simultaneous: settle in reprice-stamp order
            done = done[torch.argsort(self.xstamp[done], stable=True)]
        # settle in place; finished transfers get eta = +inf, a residue
        # keeps running with a fresh estimate
        done_l, fin_l = host_list(tk.transfer_complete(
            self.xW, self.xrate, self.xt_last, self.xeta, done, t, XTOL))
        self.n_events += len(done_l)
        members = self.edge_members
        for k, ok in zip(done_l, fin_l):
            if not ok:
                continue
            self.xlive -= 1
            for e in self.xe_edges[k]:
                members[e] -= 1
                self.edge_xfers[e].discard(k)
                self.dirty_edges.add(e)
            lat = self.xlat[k]
            if lat > 0:
                # latency tail: arrival after the fixed route latency
                self._push(t + lat, _ARRIVE, self.xconsumer[k])
            else:
                self._arrived(self.xconsumer[k])
        if sp:
            spans.leave(sp)

    # -- lifecycle ----------------------------------------------------------
    def _start(self) -> None:
        """Bring the engine live: ingest the CFG + background jobs, price
        the opening intervals, and enqueue releases.  Event push order
        (interventions, then releases) replays the one-shot loop's
        sequence numbers exactly."""
        if self._opened:
            raise RuntimeError("TimelineEngine is already open")
        self._init_state()
        self._ingest(list(self.cfg))
        for t, fn in self.interventions:
            self._push(float(t), _INTERVENE, fn)
        self._ingest_background()
        self._flush()
        for t in self.cfg:
            self._push(t.release_time, _RELEASE, self.slot_of[t.uid])
        self._opened = True

    @classmethod
    def open(cls, traverser, cfg: Optional[TaskGraph] = None,
             mapping: Optional[dict[int, str]] = None,
             background: Sequence[tuple[Task, str, float]] = (),
             interventions: Sequence[tuple[float, Callable[[], Any]]] = (),
             ) -> "TimelineEngine":
        """Open a **session-resident** engine: live immediately, advanced
        incrementally (``advance``), and accepting ``inject`` mid-run.

        ``cfg``/``mapping`` may start empty (the serving case) or carry an
        initial workload; ``mapping`` is read live, so a dict shared with
        a ``SchedulerSession`` picks up later commits without copying.
        Noisy *slowdown models* (rng-bearing ``factor()``) are rejected:
        their draw stream only replays on the reference loop, which has
        no resident form."""
        eng = cls(traverser,
                  cfg if cfg is not None else TaskGraph("resident"),
                  mapping if mapping is not None else {},
                  background, interventions)
        noisy = getattr(eng.slowdown, "_noisy", None)
        if noisy is not None and noisy():
            raise ValueError(
                "resident timelines require a deterministic slowdown "
                "model (noisy factor() draws only replay on "
                "Traverser.traverse_reference)")
        eng._start()
        return eng

    def inject(self, tasks: Sequence[Task],
               mapping: Optional[dict[int, str]] = None) -> "TimelineEngine":
        """Land newly mapped work in the live job tables mid-run.

        Each task enters at its own ``release_time`` (>= the engine clock:
        injecting into the past would rewrite settled intervals)."""
        if not self._opened:
            raise RuntimeError(
                "inject() requires an open engine — TimelineEngine.open() "
                "or SchedulerSession.open_timeline()")
        tasks = list(tasks)
        if mapping:
            self.mapping.update(mapping)
        for t in tasks:
            if t.release_time < self.time:
                raise ValueError(
                    f"{t} releases at {t.release_time:.6g}, before the "
                    f"engine clock {self.time:.6g}")
        self._ingest(tasks)
        for t in tasks:
            self._push(t.release_time, _RELEASE, self.slot_of[t.uid])
        if self.dirty_devs or self.dirty_edges:
            self._flush()
        return self

    def schedule(self, t: float, fn) -> None:
        """Queue an intervention at simulated time ``t`` — the resident
        counterpart of the ``interventions=`` argument.  ``fn`` is either
        a zero-arg callable or a declarative ``Churn`` batch."""
        self._push(float(t), _INTERVENE, fn)

    def apply_churn(self, churn) -> "TimelineEngine":
        """Apply a ``Churn`` batch (or a zero-arg callable) at the current
        engine clock through the same one-flush reprice path as scheduled
        interventions."""
        self._intervene(churn)
        self._flush()
        return self

    def finish_of(self, uid: int) -> float:
        """Finish time of task ``uid`` (nan while pending or running)."""
        s = self.slot_of.get(uid)
        return float("nan") if s is None else self.finish[s]

    def drain_finished(self) -> list[Task]:
        """Tasks that completed since the previous drain (background slots
        excluded) — the ledger-reconciliation feed for serving loops."""
        sp = spans.enter("des.drain") if _SPANS else None
        log = self._finish_log
        out = [self.allt[s] for s in log[self._finish_cursor:]
               if not self.is_bg[s]]
        self._finish_cursor = len(log)
        if sp:
            spans.leave(sp)
        return out

    @property
    def live_jobs(self) -> int:
        """Compute jobs currently occupying a PU."""
        return int(sum(self.pu_running))

    def next_event_time(self) -> float:
        """Timestamp of the earliest pending event (compute finish,
        transfer finish, or heap entry), ``inf`` at quiescence — the same
        minimum :meth:`advance` computes before draining.  Reads the two
        eta minima back from the device: one synchronising read."""
        sp = spans.enter("des.next") if _SPANS else None
        em, xm = self._next_times()
        t_next = self.heap[0][0] if self.heap else _INF
        if sp:
            spans.leave(sp)
        return min(em, xm, t_next)

    def _next_times(self) -> tuple[float, float]:
        """(earliest compute eta, earliest transfer eta) in one host copy;
        unused capacity and retired slots carry +inf."""
        em, xm = host_list(torch.stack([self.eta.min(), self.xeta.min()]))
        return em, xm

    def _done_slots(self, col: torch.Tensor, time: float) -> torch.Tensor:
        return nonzero(col <= time)

    # -- main loop ----------------------------------------------------------
    def advance(self, until: float = _INF) -> "TimelineEngine":
        """Drain every event with timestamp <= ``until``, then park the
        clock at ``until`` (when finite).  ``advance()`` with no bound
        drains to quiescence — the one-shot behaviour."""
        sp = spans.enter("des.advance") if _SPANS else None
        heap = self.heap
        while True:
            em, xm = self._next_times()
            t_next = heap[0][0] if heap else _INF
            if em < t_next:
                t_next = em
            if xm < t_next:
                t_next = xm
            if t_next == _INF or t_next > until:
                break
            if t_next > self.time:
                self.time = t_next
            time = self.time
            # all events at this timestamp drain before one flush reprices
            # what they touched; repeat while the flush re-projected rates
            # (zero-duration pileups surface as fresh same-time work)
            first = True
            while True:
                while heap and heap[0][0] <= time:
                    _, _, kind, payload = heapq.heappop(heap)
                    self.n_events += 1
                    if kind == _RELEASE:
                        s = payload
                        task = self.allt[s]
                        # initial input payload from the origin device
                        if (task.origin is not None and self.in_bytes[s] > 0
                                and not self.preds[s]):
                            if self._launch(s, task.origin, self.dev_name[s],
                                            self.in_bytes[s]):
                                continue
                        self._arrived(s)
                    elif kind == _ARRIVE:
                        self._arrived(payload)
                    else:
                        self._intervene(payload)
                if first or em <= time:
                    done = self._done_slots(self.eta, time)
                    if done.shape[0]:
                        self._complete_compute(done)
                if self.xlive and (first or xm <= time):
                    xdone = self._done_slots(self.xeta, time)
                    if xdone.shape[0]:
                        self._complete_transfers(xdone)
                first = False
                if not self._flush():
                    break
                # a flush ran: re-projected rates may complete at `time`
                em, xm = self._next_times()
                if em > time and xm > time and not (heap and
                                                    heap[0][0] <= time):
                    break
        if until != _INF and until > self.time:
            self.time = until
        if sp:
            spans.leave(sp)
        return self

    def run(self) -> Timeline:
        """One-shot traverse: open, drain to quiescence, report."""
        self._start()
        self.advance()
        return self._timeline()

    def timeline(self, partial: bool = False) -> Timeline:
        """Snapshot the timeline.  ``partial=True`` reports whatever has
        happened so far (pending/running tasks simply lack entries);
        ``partial=False`` asserts quiescence, as ``run()`` does."""
        return self._timeline(partial=partial)

    def _timeline(self, partial: bool = False) -> Timeline:
        self._apply_pending()
        if not partial:
            missing = [self.uidl[s] for s in range(self.n)
                       if not self.is_bg[s]
                       and self.finish[s] != self.finish[s]]
            if missing:
                raise RuntimeError(
                    f"traverse deadlock: unfinished {missing[:5]}")
        tl = Timeline(mapping=dict(self.mapping))
        tl.n_intervals = self.n_intervals
        tl.n_events = self.n_events
        for s in range(self.n):
            uid = self.uidl[s]
            if self.is_bg[s]:
                # background jobs may legitimately still be running; report
                # a projected finish assuming the final interval persists
                tl.start[uid] = self.start[s]
                tl.standalone[uid] = self.standalone[s]
                if not math.isnan(self.finish[s]):
                    tl.finish[uid] = self.finish[s]
                elif s in self.dev_members.get(self.dev_ol[s], ()):
                    tl.finish[uid] = self.time + host_item(
                        self.W[s] / self.rate[s])
                continue
            if not math.isnan(self.standalone[s]):
                tl.start[uid] = self.start[s]
                tl.standalone[uid] = self.standalone[s]
            if not math.isnan(self.finish[s]):
                tl.finish[uid] = self.finish[s]
            if not math.isnan(self.ready_t[s]):
                tl.ready[uid] = self.ready_t[s]
                tl.comm[uid] = self.comm_t[s]
            if not math.isnan(self.qwait[s]):
                tl.queue_wait[uid] = self.qwait[s]
        return tl
