"""Hierarchical, de-centralized Orchestrator (paper §3.5, Alg. 1).

ORCs form a tree mirroring the upper layers of the HW-GRAPH: a root ORC,
one ORC per virtual cluster (edge cluster / server cluster), and one ORC
per device.  Each ORC knows only its parent and children (resource
segregation); a device ORC has full knowledge of the PUs inside its device.

The scheduling surface is **batch-first**: ``map_batch`` maps a whole
frontier of ready tasks in one call.  Each task's placement follows
Alg. 1 —

  TraverseChildren: check own leaf PUs (constraint check via the Traverser,
  including *existing* tasks' constraints) and recurse into child ORCs;
  if nothing satisfies the constraints, AskParent: the parent tries the
  siblings, then escalates further up (DFS).  Communication latency from the
  task's origin to a remote PU is folded into the constraint check, and every
  remote hop is charged to the *scheduling overhead* ledger (paper Fig. 14).

— in one of three walk forms, chosen by the same three switches (and
defaults) as the reference package:

* the **fused wave-batched walk** (``REPRO_FUSED_WALK``, default on):
  every ORC subtree is a scan plan (device tensors), each escalation
  depth's constraint checks batch into one factor-kernel call, a wave's
  entry scans are reduced together in one launch of the batched
  scan-reduce kernel, and every later scan (re-walks, escalations) is
  one launch of it at a stack of one — but the ordered commit's re-walk
  of a task whose entry plan covers one device, stale for that device
  alone, which re-checks the device, patches the scan and reduces it in
  one launch of the fused re-walk kernel and one host read
  (``_entry_fused``);
* its **group-sharded** driver (``REPRO_SHARDED_WALK``, default on, at a
  root ORC with two or more children): the snapshot is sliced into
  block-diagonal per-group views (``CompiledHWGraph.sharded``), the
  ledger into per-group shards (``ShardedLedger``), and each group's
  phase-1 walks run on their own (host threads on a big enough wave),
  reconciling only at the root ORC boundary;
* the **object walk** (Alg. 1's recursion as written: ``_map_once``,
  ``_traverse_children``, ``_ask_parent``): the parity oracle
  (``REPRO_FUSED_WALK=0``), and the only walk of the ``first_fit``
  objective and of noisy slowdown models (their rng stream follows the
  scalar order).

Serving waves reuse one **session-resident** walk context
(``REPRO_SERVE_FASTPATH``, default on): scan states, splices, views and
the identity factor cache survive across ``map_batch`` calls, and a
bandwidth-only snapshot delta rebases the context instead of dropping
it.  ``=0`` builds a context per multi-task batch and walks single-task
waves with the object walk.  Mapping is optimistic-concurrency: every
task is first scored against the ledger as it stood at the start of the
batch, then committed in task order; a task is re-scored only when an
earlier commit landed on a device its search actually scored, which
keeps ``map_batch`` identical to N sequential one-task batches.

Host and device: the ORC tree, the plans' name lists, the walk caches
and the ledger's dict indexes are host Python; the ledger columns, the
scan plans' arrays, the scan states and every constraint-check column
are float64/int64/bool tensors on the graph's device.
"""
from __future__ import annotations

import bisect
import dataclasses
import os
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np
import torch

from .. import spans
from ..device import (BOOL, FLOAT, INT, DeviceLike, bytes_key, f64, host_item,
                      host_list, host_numpy, i64, resolve_device)
from ..spans import OPEN as _SPANS
from ..kernels.walk_kernel import (BLOCK_MAX_P, RewalkSegment,
                                   ScanPlanArrays, constraint_terms,
                                   effective_segment, scan_reduce,
                                   scan_reduce_batch, segment_columns)
from .hwgraph import HWGraph
from .task import Task
from .traverser import TaskPrediction, Traverser

QUERY_BYTES = 1024.0          # size of a MapTask query/response message

_INF = float("inf")


def _expiry(now: float, waiting: float, flip: float) -> float:
    """The instant until which a single-device check made at ``now``
    stays exact, from its two expiry values: whether a positive queueing
    wait exists (it decays with every clock tick, so the check is stale
    the instant ``now`` moves) and the earliest instant an l.15 verdict
    can flip."""
    expiry = _INF
    if waiting:
        expiry = now
    if flip < expiry:
        # pull a hair early: the analytic root and the float-evaluated
        # predicate may disagree by ulps, and an early re-splice is merely
        # redundant
        expiry = flip - max(abs(flip), 1.0) * 1e-9
    return expiry


@dataclass
class ActiveEntry:
    """Object view of one ledger row."""

    task: Task
    pu: str
    est_finish: float
    factor: float

    def remaining_standalone(self, now: float) -> float:
        return max(0.0, self.est_finish - now) / max(self.factor, 1e-12)


class _LedgerView:
    """Dense columns of live ledger rows (one device, or the device-sorted
    global view with per-device-ordinal segment offsets).  ``rows`` is a
    host list; the numeric columns are device tensors."""

    __slots__ = ("rows", "pu_names", "P", "est", "fac", "dl", "rel",
                 "upu", "umem", "Ma", "uid", "tasks", "Da", "astart", "na")

    def __len__(self) -> int:
        return len(self.rows)

    def pairs(self) -> list[tuple[Task, str]]:
        return list(zip(self.tasks, self.pu_names))


class ActiveLedger:
    """The runtime's belief of which tasks occupy which PUs.

    Estimates come from the Orchestrator's own predictions (it cannot
    observe ground truth).  Storage is struct-of-arrays: one row per
    active task with dense device columns (estimated finish, slowdown
    factor, deadline, usage, uid, compiled PU index, liveness) plus
    incremental host dict indexes (live count per PU, live rows per
    device).  Columns grow by reallocation on the device.
    """

    _FCOLS = ("_est", "_fac", "_dl", "_upu", "_umem")
    _ICOLS = ("_uid", "_pu_idx")

    def __init__(self, device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self._n = 0
        self._tasks: list[Optional[Task]] = []
        self._pus: list[Optional[str]] = []
        for col in self._FCOLS:
            setattr(self, col, torch.empty(0, dtype=FLOAT, device=self.device))
        for col in self._ICOLS:
            setattr(self, col, torch.empty(0, dtype=INT, device=self.device))
        self._live = torch.empty(0, dtype=BOOL, device=self.device)
        self._live_l: list[bool] = []              # host mirror of _live
        self._pu_idx_comp = None                   # snapshot the column is for
        self._dead = 0
        self.version = 0
        self._count: dict[str, int] = {}
        self._pu_dev: dict[str, str] = {}          # pu name -> device name
        self._dev_rows: Optional[dict[str, list[int]]] = None
        self._live_view: Optional[tuple] = None    # (comp, version, view)
        # fine-grained invalidation: adds, device-attributed kills and
        # ``touch`` bump only their device's version; unattributable
        # mutations bump the epoch.  ``mut_log`` journals the device name
        # of every attributed mutation in order — scan states refresh
        # exactly the suffix they have not seen yet.
        self.dev_epoch = 0
        self.dev_version: dict[str, int] = {}
        self.mut_log: list[str] = []

    # -- bookkeeping -------------------------------------------------------
    def __len__(self) -> int:
        return self._n - self._dead

    def _grow(self) -> None:
        cap = max(16, 2 * self._est.shape[0])
        n = self._n
        for col in self._FCOLS:
            arr = torch.empty(cap, dtype=FLOAT, device=self.device)
            arr[:n] = getattr(self, col)[:n]
            setattr(self, col, arr)
        for col in self._ICOLS:
            arr = torch.empty(cap, dtype=INT, device=self.device)
            arr[:n] = getattr(self, col)[:n]
            setattr(self, col, arr)
        live = torch.zeros(cap, dtype=BOOL, device=self.device)
        live[:n] = self._live[:n]
        self._live = live

    def add(self, task: Task, pu: str, pred: TaskPrediction,
            now: float) -> ActiveEntry:
        if self._n == self._est.shape[0]:
            self._grow()
        i = self._n
        self._n += 1
        est = now + pred.total
        self._tasks.append(task)
        self._pus.append(pu)
        self._est[i] = est
        self._fac[i] = pred.factor
        self._dl[i] = task.deadline if task.deadline is not None else _INF
        self._upu[i] = task.usage.get("pu", 1.0)
        self._umem[i] = task.usage.get("mem", 1.0)
        self._uid[i] = task.uid
        self._pu_idx[i] = (self._pu_idx_comp.get(pu, -1)
                           if self._pu_idx_comp is not None else -1)
        self._live[i] = True
        self._live_l.append(True)
        self._count[pu] = self._count.get(pu, 0) + 1
        self.version += 1
        dev = self._pu_dev.get(pu)
        if dev is None:
            self.dev_epoch += 1
        else:
            self.dev_version[dev] = self.dev_version.get(dev, 0) + 1
            self.mut_log.append(dev)
        if self._dev_rows is not None:
            if dev is None:
                self._dev_rows = None
            else:
                self._dev_rows.setdefault(dev, []).append(i)
        return ActiveEntry(task=task, pu=pu, est_finish=est, factor=pred.factor)

    def _kill(self, rows: list[int]) -> None:
        # attribute each kill to its device where possible so scan states
        # only re-check those devices; fall back to the epoch when any
        # row's PU has no known device
        devs: Optional[list[str]] = []
        for i in rows:
            pu = self._pus[i]
            dev = self._pu_dev.get(pu) if devs is not None else None
            if devs is not None:
                if dev is None:
                    devs = None
                else:
                    devs.append(dev)
            self._live_l[i] = False
            self._count[pu] -= 1
            if not self._count[pu]:
                del self._count[pu]
            self._tasks[i] = None
            self._dead += 1
        self._live[i64(rows, self.device)] = False
        self.version += 1
        if devs is None:
            self.dev_epoch += 1
            self._dev_rows = None
        else:
            killed = set(rows)
            for dev in set(devs):
                self.dev_version[dev] = self.dev_version.get(dev, 0) + 1
                self.mut_log.append(dev)
                if self._dev_rows is not None:
                    old = self._dev_rows.get(dev)
                    if old is not None:
                        self._dev_rows[dev] = [i for i in old
                                               if i not in killed]
        if self._dead > 32 and self._dead * 2 > self._n:
            self._compact()

    def _compact(self) -> None:
        keep = [i for i in range(self._n) if self._live_l[i]]
        keep_t = i64(keep, self.device)
        self._tasks = [self._tasks[i] for i in keep]
        self._pus = [self._pus[i] for i in keep]
        for col in self._FCOLS + self._ICOLS:
            setattr(self, col, getattr(self, col)[keep_t].clone())
        self._live = torch.ones(len(keep), dtype=BOOL, device=self.device)
        self._live_l = [True] * len(keep)
        self._n = len(keep)
        self._dead = 0
        # row numbers changed; per-device row lists must be rebuilt
        self._dev_rows = None

    def touch(self, dev: str) -> None:
        """Record an out-of-band state change on device ``dev`` (e.g. the
        session charging scheduling overhead into a resident task's
        release_time) so cached views and scan states refresh that
        device's rows."""
        self.version += 1
        self.dev_version[dev] = self.dev_version.get(dev, 0) + 1
        self.mut_log.append(dev)
        self._live_view = None

    def occupied_devices(self, comp) -> set:
        """Device names with at least one live ledger row."""
        out = set()
        dev_of = self._pu_dev
        for pu in self._count:
            dev = dev_of.get(pu)
            if dev is None:
                dev = dev_of[pu] = comp.device_name(pu)
            out.add(dev)
        return out

    def _kill_where(self, mask: torch.Tensor) -> int:
        rows = [i for i, hit in enumerate(host_list(mask)) if hit]
        if rows:
            self._kill(rows)
        return len(rows)

    def prune(self, now: float) -> None:
        if not len(self):
            return
        self._kill_where(self._live[:self._n] & (self._est[:self._n] <= now))

    def remove(self, task: Task) -> None:
        if not len(self):
            return
        self._kill_where(self._live[:self._n]
                         & (self._uid[:self._n] == task.uid))

    def retire(self, uids) -> int:
        """Batch-remove *actually completed* tasks; returns rows killed
        (uids already pruned or never ledgered are ignored)."""
        uids = list(uids)
        if not len(self) or not uids:
            return 0
        return self._kill_where(
            self._live[:self._n]
            & torch.isin(self._uid[:self._n], i64(uids, self.device)))

    def count(self, pu: str) -> int:
        return self._count.get(pu, 0)

    def shard_for(self, dev: str) -> "ActiveLedger":
        """The ledger shard owning device ``dev`` — a monolithic ledger
        is its own (only) shard."""
        return self

    # -- array views -------------------------------------------------------
    def _fill_pu_idx(self, comp) -> None:
        """(Re)fill the compiled-index column for this snapshot — ``add``
        keeps it current incrementally afterwards."""
        if self._pu_idx_comp is not comp.pu_index:
            self._pu_idx_comp = comp.pu_index
            if self._n:
                self._pu_idx[:self._n] = i64(
                    [(comp.pu_index.get(pu, -1) if pu is not None else -1)
                     for pu in self._pus[:self._n]], self.device)

    def _device_rows(self, comp) -> dict[str, list[int]]:
        if self._dev_rows is None:
            dev_of = self._pu_dev
            rows: dict[str, list[int]] = {}
            for i in range(self._n):
                if not self._live_l[i]:
                    continue
                pu = self._pus[i]
                dev = dev_of.get(pu)
                if dev is None:
                    dev = dev_of[pu] = comp.device_name(pu)
                rows.setdefault(dev, []).append(i)
            self._dev_rows = rows
        return self._dev_rows

    def _gather(self, v: _LedgerView, comp, rows: list[int],
                r: torch.Tensor) -> None:
        v.rows = rows
        v.pu_names = [self._pus[i] for i in rows]
        v.P = self._pu_idx[r]
        v.est = self._est[r]
        v.fac = self._fac[r]
        v.dl = self._dl[r]
        v.upu = self._upu[r]
        v.umem = self._umem[r]
        v.Ma = torch.minimum(v.umem, comp.mem_cap[v.P])
        v.uid = self._uid[r]
        v.tasks = [self._tasks[i] for i in rows]
        # release times are read LIVE from the tasks: the runtime charges
        # scheduling overhead into release_time after a commit, and the
        # Alg. 1 l.15 re-check must see the charged value
        v.rel = f64([t.release_time for t in v.tasks], self.device)

    def device_view(self, comp, dev: str) -> _LedgerView:
        """Dense ledger columns of the live rows on device ``dev``, with
        the same per-device-ordinal segment arrays as :meth:`live_view`
        (zero everywhere but ``dev``)."""
        rows = list(self._device_rows(comp).get(dev, ()))
        v = _LedgerView()
        self._fill_pu_idx(comp)
        self._gather(v, comp, rows, i64(rows, self.device))
        o = comp.dev_ord.get(dev)
        nd = len(comp.dev_ord_names)
        v.na = torch.zeros(nd, dtype=INT, device=self.device)
        v.astart = torch.zeros(nd, dtype=INT, device=self.device)
        if o is not None:
            v.na[o] = len(rows)
            v.Da = torch.full((len(rows),), o, dtype=INT, device=self.device)
        else:
            v.Da = torch.zeros(len(rows), dtype=INT, device=self.device)
        return v

    def live_view(self, comp) -> _LedgerView:
        """All live rows, sorted by device ordinal (stable, so per-device
        row order matches ``device_view``), with segment offsets for the
        block-diagonal constraint check.  Cached per (snapshot, ledger
        version)."""
        cached = self._live_view
        if cached is not None and cached[0] is comp and cached[1] == self.version:
            return cached[2]
        self._fill_pu_idx(comp)
        v = _LedgerView()
        live = [i for i in range(self._n) if self._live_l[i]]
        # the stable device-ordinal sort runs on host mirrors (names ->
        # ordinals), so the row order needs no device read
        dl = comp.pu_dev_ord_l
        pidx = comp.pu_index
        dev_of = [dl[pidx[self._pus[i]]] for i in live]
        order = sorted(range(len(live)), key=dev_of.__getitem__)
        rows = [live[k] for k in order]
        self._gather(v, comp, rows, i64(rows, self.device))
        v.Da = i64([dev_of[k] for k in order], self.device)
        nd = len(comp.dev_ord_names)
        na = [0] * nd
        for k in dev_of:
            na[k] += 1
        v.na = i64(na, self.device)
        v.astart = torch.cumsum(v.na, 0) - v.na
        self._live_view = (comp, self.version, v)
        return v

    # -- object-view compatibility accessors -------------------------------
    def _entry(self, i: int) -> ActiveEntry:
        return ActiveEntry(task=self._tasks[i], pu=self._pus[i],
                           est_finish=host_item(self._est[i]),
                           factor=host_item(self._fac[i]))

    @property
    def by_pu(self) -> dict[str, list[ActiveEntry]]:
        out: dict[str, list[ActiveEntry]] = {}
        for i in range(self._n):
            if self._live_l[i]:
                out.setdefault(self._pus[i], []).append(self._entry(i))
        return out

    def on_device(self, graph: HWGraph, pu_name: str) -> list[ActiveEntry]:
        comp = graph.compiled()
        dev = comp.device_name(pu_name)
        return [self._entry(i)
                for i in self._device_rows(comp).get(dev, ())]

    def pairs_on_device(self, graph: HWGraph, pu_name: str) -> list[tuple[Task, str]]:
        return [(e.task, e.pu) for e in self.on_device(graph, pu_name)]


class _ShardDevVersions:
    """Dict-shaped dispatch of per-device version stamps to the owning
    ledger shard (the surface scan states read via ``dev_version.get``)."""

    __slots__ = ("_led",)

    def __init__(self, led: "ShardedLedger") -> None:
        self._led = led

    def get(self, dev: str, default: int = 0) -> int:
        return self._led.shard_for(dev).dev_version.get(dev, default)


class ShardedLedger:
    """Per-ORC-group :class:`ActiveLedger` shards behind the monolithic
    ledger surface.

    Each shard owns exactly the rows of its group's devices (commits
    dispatch by the committed PU's enclosing device), so per-device reads
    hit one shard, and independent groups' walks can fan out over host
    threads without sharing ledger state.  The thin cross-group
    reconciler is :meth:`live_view`: the shards' device segments
    interleaved back into global device-ordinal order (stable), which
    equals the monolithic ledger's global view.  Every shard lives on the
    ledger's device; one mutation journal (``mut_log``) and one PU ->
    device map are shared by all of them."""

    def __init__(self, comp, sharded_hw, device: DeviceLike = None) -> None:
        self.hw = sharded_hw
        self.device = comp.device if device is None else resolve_device(
            device)
        self.shards: list[ActiveLedger] = [ActiveLedger(self.device)
                                           for _ in sharded_hw.shards]
        self._pu_dev: dict[str, str] = {}      # shared by every shard
        self._by_dev: dict[str, ActiveLedger] = {}
        self._by_pu: dict[str, ActiveLedger] = {}
        self._default = self.shards[0]
        for gs, led in zip(sharded_hw.shards, self.shards):
            led._pu_dev = self._pu_dev
            for d in gs.devices:
                self._by_dev[d] = led
            for p in gs.pu_names:
                self._by_pu[p] = led
        self._pu_dev.update(comp._pu_device_name)
        self._dev_versions = _ShardDevVersions(self)
        self._merged: Optional[tuple] = None
        # one shared mutation journal across shards: attributed mutations
        # must stay globally ordered for scan-state refreshes
        self.mut_log: list[str] = []
        for led in self.shards:
            led.mut_log = self.mut_log

    # -- shard dispatch ----------------------------------------------------
    def shard_for(self, dev: str) -> ActiveLedger:
        return self._by_dev.get(dev, self._default)

    def _shard_for_pu(self, pu: str) -> ActiveLedger:
        led = self._by_pu.get(pu)
        if led is None:
            dev = self._pu_dev.get(pu)
            led = self._by_dev.get(dev, self._default) if dev is not None \
                else self._default
        return led

    # -- monolithic surface ------------------------------------------------
    def __len__(self) -> int:
        return sum(len(s) for s in self.shards)

    @property
    def version(self) -> int:
        return sum(s.version for s in self.shards)

    @property
    def dev_epoch(self) -> int:
        return sum(s.dev_epoch for s in self.shards)

    @property
    def dev_version(self) -> _ShardDevVersions:
        return self._dev_versions

    @property
    def _live_view(self) -> Optional[tuple]:
        return self._merged

    @_live_view.setter
    def _live_view(self, value) -> None:
        # map_batch drops the cross-batch global view (release times may
        # have been charged since); propagate to every shard's cache
        self._merged = value
        if value is None:
            for s in self.shards:
                s._live_view = None

    def add(self, task: Task, pu: str, pred: TaskPrediction,
            now: float) -> ActiveEntry:
        return self._shard_for_pu(pu).add(task, pu, pred, now)

    def prune(self, now: float) -> None:
        for s in self.shards:
            s.prune(now)

    def remove(self, task: Task) -> None:
        for s in self.shards:
            s.remove(task)

    def retire(self, uids) -> int:
        uids = list(uids)
        return sum(s.retire(uids) for s in self.shards)

    def count(self, pu: str) -> int:
        return self._shard_for_pu(pu).count(pu)

    def touch(self, dev: str) -> None:
        self.shard_for(dev).touch(dev)
        self._merged = None

    def occupied_devices(self, comp) -> set:
        out: set = set()
        for s in self.shards:
            out |= s.occupied_devices(comp)
        return out

    def _fill_pu_idx(self, comp) -> None:
        for s in self.shards:
            s._fill_pu_idx(comp)

    def device_view(self, comp, dev: str) -> _LedgerView:
        return self.shard_for(dev).device_view(comp, dev)

    def live_view(self, comp) -> _LedgerView:
        """The cross-group reconciler: every shard's live rows interleaved
        back into global device-ordinal order.  Within one device ordinal
        all rows come from the one shard owning that device, already in
        insertion order, so a stable sort over the concatenation equals
        the monolithic global view.  The order is computed on the host
        mirrors (names -> ordinals), so the merge needs no device read."""
        cached = self._merged
        if cached is not None and cached[0] is comp \
                and cached[1] == self.version:
            return cached[2]
        views = [s.live_view(comp) for s in self.shards]
        dl = comp.pu_dev_ord_l
        pidx = comp.pu_index
        names = [n for w in views for n in w.pu_names]
        dev_of = [dl[pidx[n]] for n in names]
        order = sorted(range(len(names)), key=dev_of.__getitem__)
        o = i64(order, self.device)
        v = _LedgerView()
        for col in ("P", "est", "fac", "dl", "rel", "upu", "umem", "Ma",
                    "uid"):
            setattr(v, col, torch.cat([getattr(w, col) for w in views])[o])
        rows = [r for w in views for r in w.rows]
        tasks = [t for w in views for t in w.tasks]
        v.rows = [rows[k] for k in order]
        v.pu_names = [names[k] for k in order]
        v.tasks = [tasks[k] for k in order]
        v.Da = i64([dev_of[k] for k in order], self.device)
        na = [0] * len(comp.dev_ord_names)
        for k in dev_of:
            na[k] += 1
        v.na = i64(na, self.device)
        v.astart = torch.cumsum(v.na, 0) - v.na
        self._merged = (comp, self.version, v)
        return v

    # -- object-view compatibility accessors -------------------------------
    @property
    def by_pu(self) -> dict[str, list[ActiveEntry]]:
        out: dict[str, list[ActiveEntry]] = {}
        for s in self.shards:
            for pu, entries in s.by_pu.items():
                out.setdefault(pu, []).extend(entries)
        return out

    def on_device(self, graph: HWGraph, pu_name: str) -> list[ActiveEntry]:
        comp = graph.compiled()
        dev = comp.device_name(pu_name)
        return self.shard_for(dev).on_device(graph, pu_name)

    def pairs_on_device(self, graph: HWGraph,
                        pu_name: str) -> list[tuple[Task, str]]:
        return [(e.task, e.pu) for e in self.on_device(graph, pu_name)]


@dataclass
class MapResult:
    pu: str
    prediction: TaskPrediction
    overhead: float = 0.0        # scheduling overhead in seconds (Fig. 14)
    queries: int = 0             # constraint checks performed
    hops: int = 0                # remote ORC-to-ORC messages


@dataclass
class OrcConfig:
    local_query_cost: float = 5e-6    # CPU time per candidate constraint check
    objective: str = "best_fit"       # "best_fit" | "first_fit" | "min_load"
    allow_best_effort: bool = True    # if nothing satisfies, pick least-bad PU


class _StaticScore:
    """The ledger-independent half of a fused candidate scoring: shared
    across a batch for every (task signature, candidate set) pair.
    ``cols_l`` is the host mirror of ``cols`` (bisected per device
    segment by ``_effective``)."""

    __slots__ = ("pu_names", "cols", "cols_l", "cand_idx", "cand_dev", "sa",
                 "comm", "maxten", "single_dev")


class _ScanPlan:
    """One ORC subtree lowered to arrays: the preorder node list of a scan
    root with per-node subtree PU ranges, leaf/child counts, summed hop
    costs and depths (``rows`` on the host, ``arrays`` on the device) —
    everything the scan-reduce kernel needs to replay Alg. 1's
    TraverseChildren accounting in closed form.  Built lazily per compiled
    snapshot (hop costs are snapshot functions)."""

    __slots__ = ("pus", "rows", "arrays", "leaf_groups", "devs",
                 "dev_ranges", "dev_sublists")


class _ChildPlan:
    """One ORC's children lowered for the AskParent sibling scan: every
    child subtree concatenated into one candidate list, with per-child
    slice bounds and the running hop-cost prefix Alg. 1 charges while
    iterating siblings.  One plan serves every asking child (the asker's
    own slice is masked out at selection time)."""

    __slots__ = ("children", "child_pos", "pus", "bounds", "hc",
                 "hop_prefix", "devs", "dev_ranges", "dev_sublists",
                 "leaf_groups")


class _ScanState:
    """The origin-independent core of one (task core, candidate list)
    scan — eligibility+l.15 feasibility, standalone, factor and additive
    tenancy-wait columns on the device — plus the freshness stamps that
    tell a later walk which device segments an intervening commit
    invalidated."""

    __slots__ = ("ok", "sa", "f", "wait", "epoch", "stamps", "log_pos",
                 "now", "refresh_log", "expiry")

    def __init__(self, n: int, device: torch.device) -> None:
        self.ok = torch.zeros(n, dtype=BOOL, device=device)
        self.sa = torch.full((n,), _INF, dtype=FLOAT, device=device)
        self.f = torch.ones(n, dtype=FLOAT, device=device)
        self.wait = torch.zeros(n, dtype=FLOAT, device=device)
        self.expiry: dict = {}
        self.now = None
        self.refresh_log: list[str] = []

    def spliced(self, dev: str, version: int, expiry: float) -> None:
        """Record a re-check of ``dev``'s segment: the device version it
        saw, the instant it stays exact until, and its place in the
        refresh journal that effective layers over this state follow."""
        self.stamps[dev] = version
        self.expiry[dev] = expiry
        self.refresh_log.append(dev)


class _Effective:
    """One task signature's effective columns over a plan (``ok`` /
    ``cm`` / ``key``), layered over the scan state ``st`` and current up
    to ``pos`` of the commit journal and ``rpos`` of ``st``'s refresh
    journal."""

    __slots__ = ("st", "pos", "rpos", "ok", "cm", "key")

    def __init__(self, st: _ScanState, ok: torch.Tensor, cm: torch.Tensor,
                 key: torch.Tensor, log: list) -> None:
        self.st = st
        self.ok = ok
        self.cm = cm
        self.key = key
        self.caught_up(log)

    def caught_up(self, log: list) -> None:
        """Mark the columns current with the journals as they stand."""
        self.pos = len(log)
        self.rpos = len(self.st.refresh_log)


class _Walk:
    """One deduplicated phase-1 walk being wave-stepped through Alg. 1."""

    __slots__ = ("orc", "task", "cur", "scored", "res")

    def __init__(self, orc: "Orchestrator", task: Task) -> None:
        self.orc = orc
        self.task = task
        self.cur = orc          # the ORC whose parent is asked next
        self.scored: set = set()
        self.res: Optional["MapResult"] = None


def _fifo_put(cache: OrderedDict, key, value, cap: int) -> None:
    """Insert into a bounded FIFO cache.  ``popitem`` drops the oldest
    entry in one call, so the group threads of the sharded walk may
    insert and evict at once (two of them may evict one entry each)."""
    cache[key] = value
    if len(cache) > cap:
        cache.popitem(last=False)


class _BatchContext:
    """Caches shared by every walk of one frontier — or, as the root's
    session-resident context (:meth:`Orchestrator._session_context`), of
    every wave of a serving session.

    Everything here is a pure function of (snapshot, task signature) or of
    (ledger version, device), so sharing across the batch cannot change any
    individual mapping decision — it only removes repeated work."""

    def __init__(self, graph: HWGraph, comp, traverser: Traverser,
                 ledger: ActiveLedger) -> None:
        self.graph = graph
        self.comp = comp
        self.device = comp.device
        self.trav = traverser
        self.ledger = ledger
        self._supports: dict = {}
        self._standalone: dict = {}
        self._comm: dict = {}
        self._views: dict = {}
        self._static: dict = {}
        self._sigs: dict = {}
        self._cores: dict = {}
        self._mkeys: dict = {}
        self._puidx: dict = {}
        self._static_core: dict = {}
        # fused-walk scan states: (task core, candidate-list id) -> _ScanState
        self.scan_states: dict = {}
        # per-(task sig, plan) effective columns (_Effective), patched
        # per committed device on reuse — small FIFO
        self.eff_cache: OrderedDict = OrderedDict()
        # canonical-pattern cache of single-device core checks (splices)
        self.splice_cache: OrderedDict = OrderedDict()
        # slowdown-factor cache of single-device checks, keyed by view
        # *identity*: (core sig, dev) -> (view, static, factors).  Factors
        # are now-independent, so a clock-moved re-splice of an unchanged
        # device skips the kernel and both canonical-key constructions
        self.factor_cache: OrderedDict = OrderedDict()
        # the ledger's attributed-mutation journal, aliased so scan states
        # refresh exactly the suffix of commits they have not seen yet
        self.commit_log: list[str] = ledger.mut_log
        # teach the ledger every PU's device up front so commits bump only
        # their device's version (not the global epoch)
        ledger._pu_dev.update(comp._pu_device_name)

    def rebase(self, comp) -> None:
        """Adopt a bandwidth-only successor snapshot without dropping the
        persistent walk state.  Only the comm-bearing caches go (comm
        times, per-signature static scores and effective layers, and the
        identity factor cache keyed on them); the core scan states,
        canonical splices, views and static cores are bandwidth-independent
        (the caller has checked that ``pu_alive``, the route topology, the
        PU index, ``ncr_rclass`` and ``mem_cap`` are the same objects)."""
        self.comp = comp
        self._comm = {}
        self._static = {}
        self.eff_cache = OrderedDict()
        self.factor_cache = OrderedDict()

    def _model_key(self, task: Task) -> tuple:
        hit = self._mkeys.get(id(task))
        if hit is None:
            hit = ((task.kind, task.size,
                    tuple((k, task.attrs[k]) for k in ("flops", "bytes",
                                                       "coll_bytes")
                          if k in task.attrs)), task)
            self._mkeys[id(task)] = hit     # task ref keeps the id stable
        return hit[0]

    def supports_mask(self, task: Task) -> torch.Tensor:
        key = self._model_key(task)
        mask = self._supports.get(key)
        if mask is None:
            g = self.graph
            mask = torch.as_tensor(np.fromiter(
                ((n.model is not None and n.model.supports(task, n))
                 for n in (g.nodes[p] for p in self.comp.pu_names)),
                dtype=bool, count=len(self.comp.pu_names)),
                device=self.device)
            self._supports[key] = mask
        return mask

    def standalone(self, task: Task) -> torch.Tensor:
        key = self._model_key(task)
        sa = self._standalone.get(key)
        if sa is None:
            g = self.graph
            vals = np.full(len(self.comp.pu_names), np.inf)
            for i, p in enumerate(self.comp.pu_names):
                n = g.nodes[p]
                if n.model is not None and n.model.supports(task, n):
                    vals[i] = n.predict(task)
            sa = torch.as_tensor(vals, device=self.device)
            self._standalone[key] = sa
        return sa

    def comm(self, task: Task, dev: str) -> float:
        key = (dev, task.input_bytes, task.origin,
               tuple(task.attrs.get("src_devices") or ()))
        c = self._comm.get(key)
        if c is None:
            c = self.trav.comm_time_dev(task, dev, self.comp)
            self._comm[key] = c
        return c

    def core_sig(self, task: Task) -> tuple:
        """The origin-independent slice of :meth:`task_sig`: exactly the
        fields the eligibility and factor/constraint kernels read (kind,
        size, usage, compute attrs — plus origin for pinned tasks).
        Signatures sharing a core share one tracked scan state; comm and
        deadline are layered back on per signature."""
        sig = self._cores.get(id(task))
        if sig is None:
            pinned = bool(task.attrs.get("pinned"))
            s = (task.kind, task.size, pinned,
                 task.origin if pinned else None,
                 tuple(sorted(task.usage.items())),
                 tuple((k, task.attrs[k]) for k in ("flops", "bytes",
                                                    "coll_bytes")
                       if k in task.attrs))
            sig = (s, task)
            self._cores[id(task)] = sig     # task ref keeps the id stable
        return sig[0]

    def pu_idx(self, pu_names: list[str]) -> torch.Tensor:
        """Compiled PU ordinal (or -1) per name, cached per candidate
        list.  The cached entry holds the list itself so its id stays
        live."""
        key = id(pu_names)
        hit = self._puidx.get(key)
        if hit is None:
            idx = i64([self.comp.pu_index.get(p, -1) for p in pu_names],
                      self.device)
            hit = (idx, pu_names)
            self._puidx[key] = hit
        return hit[0]

    def view(self, dev: str) -> _LedgerView:
        led = self.ledger.shard_for(dev)
        epoch = led.dev_epoch
        ver = led.dev_version.get(dev, 0)
        hit = self._views.get(dev)
        if hit is not None and hit[0] == epoch and hit[1] == ver:
            return hit[2]
        v = None
        if hit is not None and hit[0] == epoch and hit[1] == ver - 1:
            # a device-version bump within one epoch whose row count grew
            # by one is exactly one ledger add: extend the previous view
            # by that row instead of re-gathering every column
            v = self._extend_view(hit[2], dev)
        if v is None:
            v = led.device_view(self.comp, dev)
        self._views[dev] = (epoch, ver, v)
        return v

    def _extend_view(self, prev: _LedgerView,
                     dev: str) -> Optional[_LedgerView]:
        led = self.ledger.shard_for(dev)
        comp = self.comp
        rows = led._device_rows(comp).get(dev)
        if rows is None or len(rows) != len(prev.rows) + 1:
            return None
        led._fill_pu_idx(comp)
        i = rows[-1]
        pu = led._pus[i]
        pidx = comp.pu_index.get(pu, -1)
        if pidx < 0:
            return None
        one = slice(i, i + 1)
        v = _LedgerView()
        v.rows = prev.rows + [i]
        v.pu_names = prev.pu_names + [pu]
        v.P = torch.cat([prev.P, led._pu_idx[one]])
        v.est = torch.cat([prev.est, led._est[one]])
        v.fac = torch.cat([prev.fac, led._fac[one]])
        v.dl = torch.cat([prev.dl, led._dl[one]])
        v.upu = torch.cat([prev.upu, led._upu[one]])
        v.umem = torch.cat([prev.umem, led._umem[one]])
        v.Ma = torch.cat([prev.Ma, torch.minimum(
            led._umem[one], comp.mem_cap[pidx:pidx + 1])])
        v.uid = torch.cat([prev.uid, led._uid[one]])
        t = led._tasks[i]
        v.tasks = prev.tasks + [t]
        v.rel = torch.cat([prev.rel, f64([t.release_time], self.device)])
        o = comp.dev_ord.get(dev)
        v.na = prev.na.clone()
        v.astart = prev.astart
        if o is not None:
            v.na[o] = len(rows)
            v.Da = torch.full((len(rows),), o, dtype=INT, device=self.device)
        else:
            v.Da = torch.zeros(len(rows), dtype=INT, device=self.device)
        return v

    def task_sig(self, task: Task) -> tuple:
        sig = self._sigs.get(id(task))
        if sig is None:
            sig = (Orchestrator._task_signature(None, task), task)
            self._sigs[id(task)] = sig      # task ref keeps the id stable
        return sig[0]

    def static_score(self, orc: "Orchestrator", task: Task,
                     pu_names: list[str]) -> _StaticScore:
        """Ledger-independent scoring inputs, cached per (task signature,
        candidate list)."""
        key = (self.task_sig(task), id(pu_names))
        hit = self._static.get(key)
        if hit is None:
            hit = (orc._static_score(task, pu_names, self.comp, self),
                   pu_names)
            self._static[key] = hit
        return hit[0]

    def static_core(self, orc: "Orchestrator", task: Task,
                    pu_names: list[str]) -> _StaticScore:
        """Like :meth:`static_score` but keyed by the task *core* and
        without the (origin-dependent) comm column."""
        key = (self.core_sig(task), id(pu_names))
        hit = self._static_core.get(key)
        if hit is None:
            hit = (orc._static_score(task, pu_names, self.comp, self,
                                     skip_comm=True),
                   pu_names)
            self._static_core[key] = hit
        return hit[0]


class Orchestrator:
    def __init__(self, graph: HWGraph, group: str, traverser: Traverser,
                 ledger: ActiveLedger, config: Optional[OrcConfig] = None,
                 parent: Optional["Orchestrator"] = None) -> None:
        self.graph = graph
        self.device = graph.device      # raises without CUDA unless "cpu"
        self.group = group
        self.traverser = traverser
        self.ledger = ledger
        self.config = config or OrcConfig()
        self.parent = parent
        self.children: list["Orchestrator"] = []
        self.leaf_pus: list[str] = []
        self._device_orcs: Optional[dict[str, "Orchestrator"]] = None
        self._subtree_pus_cache: Optional[list[str]] = None
        self._hop_cache: Optional[tuple] = None
        self._plan_cache: Optional[tuple] = None   # (comp, _ScanPlan)
        self._child_cache: Optional[tuple] = None  # (comp, _ChildPlan)
        self._sharded_hw = None                    # ShardedHWGraph (root)
        # session-resident batch context (the serving fast path): survives
        # map_batch calls so steady-state waves pay only dirty-device work
        self._resident_ctx: Optional[_BatchContext] = None
        # walk contexts this ORC's map_batch built (resident or per batch)
        # and resident contexts it rebased onto a bandwidth-only delta
        self.context_builds = 0
        self.context_rebases = 0

    # -- hierarchy ----------------------------------------------------------
    def add_child(self, child: "Orchestrator") -> "Orchestrator":
        child.parent = self
        self.children.append(child)
        node: Optional["Orchestrator"] = self
        while node is not None:
            node._device_orcs = None
            node._subtree_pus_cache = None
            node._plan_cache = None
            node._child_cache = None
            node._resident_ctx = None
            node = node.parent
        return child

    def _subtree_pus(self) -> list[str]:
        """Every leaf PU managed below (and at) this ORC, in tree order —
        the candidate universe one fused constraint check covers."""
        if self._subtree_pus_cache is None:
            out: list[str] = []
            for orc in self.iter_tree():
                out.extend(orc.leaf_pus)
            self._subtree_pus_cache = out
        return self._subtree_pus_cache

    def is_device_orc(self) -> bool:
        return bool(self.leaf_pus)

    def prepare(self, comp=None) -> "Orchestrator":
        """Prebuild the compiled scan/child plans of the whole ORC tree
        against ``comp`` (default: the graph's current snapshot) — pure
        one-time lowering work, kept out of the first mapping wave — and,
        where group sharding applies, shard the snapshot and the ledger."""
        if comp is None:
            comp = self.graph.compiled()
        for orc in self.iter_tree():
            orc._scan_plan(comp)
            if orc.children:
                orc._child_plan(comp)
        if self._sharding_enabled():
            self._install_sharding(comp)
        return self

    # -- group sharding ------------------------------------------------------
    def _sharding_enabled(self) -> bool:
        """Group sharding applies at a root ORC with >=2 group subtrees
        and is switched off by ``REPRO_SHARDED_WALK=0`` (the fused walk over
        the monolithic ledger, its parity baseline)."""
        return (self.parent is None and len(self.children) > 1
                and os.environ.get("REPRO_SHARDED_WALK", "1") != "0")

    def _install_sharding(self, comp) -> None:
        """Shard the snapshot and ledger per root-child ORC group: one
        :class:`ShardedHWGraph` shard per root child (its subtree's device
        groups), validated block-diagonal, and a :class:`ShardedLedger`
        over that partition (on the ledger's device) swapped into the
        whole tree.  A non-empty or already-sharded ledger, or a partition
        that fails validation, leaves the monolithic setup untouched.
        Slicing happens here only: afterwards device names alone route the
        ledger, and no delta re-slices."""
        if type(self.ledger) is not ActiveLedger or len(self.ledger):
            return
        groups = {c.group: [o.group for o in c.iter_tree()
                            if o.is_device_orc()]
                  for c in self.children}
        try:
            shg = comp.sharded(groups)
        except ValueError:
            return                    # not block-diagonal: stay monolithic
        led = ShardedLedger(comp, shg, self.ledger.device)
        for orc in self.iter_tree():
            orc.ledger = led
        self._sharded_hw = shg

    @property
    def factor_cache_hits(self) -> int:
        return int(getattr(self.traverser.slowdown, "factor_cache_hits", 0))

    @property
    def factor_cache_misses(self) -> int:
        return int(getattr(self.traverser.slowdown, "factor_cache_misses", 0))

    def __repr__(self) -> str:
        return f"ORC({self.group})"

    # -- Alg. 1, batch-first -------------------------------------------------
    def map_batch(self, tasks: Iterable[Task], now: float = 0.0,
                  commit: bool = True,
                  route: bool = False) -> list[Optional[MapResult]]:
        """Map a frontier of ready tasks in one call (Alg. 1 per task).

        Semantics are identical to running Alg. 1 once per task in
        order: tasks are scored optimistically against the ledger as of
        batch start, committed in order, and re-scored only when an
        earlier commit touched a device their search scored.  With
        ``route=True`` each task enters at the device ORC of its origin
        (the session/policy entry path) instead of at ``self``.
        """
        tasks = list(tasks)
        if not tasks:
            return []
        sp = spans.enter("walk.map_batch") if _SPANS else None
        self.ledger.prune(now)
        # release_time of resident tasks may have been charged with overhead
        # since the last batch (a mutation the ledger version cannot see):
        # drop the cross-batch global view so l.15 reads the charged values
        self.ledger._live_view = None
        comp = self.graph.compiled()
        sd = self.traverser.slowdown
        noisy = bool(getattr(sd, "_noisy", lambda: False)())
        # the fused walk is the deterministic batch path: noisy models need
        # the scalar rng stream order and first_fit the early-return walk,
        # both of which the object walk keeps
        fusable = (not noisy and self.config.objective != "first_fit"
                   and hasattr(sd, "factors_same_device_multi")
                   and os.environ.get("REPRO_FUSED_WALK", "1") != "0")
        if fusable and os.environ.get("REPRO_SERVE_FASTPATH", "1") != "0":
            # serving fast path: a session-resident context keeps the
            # walk state across waves, and single-task waves run the fused
            # walk too.  REPRO_SERVE_FASTPATH=0 builds a context per batch
            # (and walks single-task waves with the object walk)
            ctx = self._session_context(comp)
        else:
            ctx = None
            if len(tasks) > 1:
                ctx = _BatchContext(self.graph, comp, self.traverser,
                                    self.ledger)
                self.context_builds += 1
        fast = fusable and ctx is not None
        # phase 1: optimistic walks against the frozen ledger, deduped by
        # task signature (identical tasks walk once; commits are replayed
        # per task in phase 2)
        tentative: list[tuple["Orchestrator", Optional[MapResult], set]] = []
        if fast:
            if self._sharding_enabled():
                walks = self._walk_wave_sharded(tasks, now, ctx, route)
            else:
                walks = self._walk_wave(tasks, now, ctx, route)
            n_walks = len(walks)
            for t in tasks:
                orc = self._entry_orc(t) if route else self
                w = walks[self._task_signature(orc, t)]
                res = (dataclasses.replace(w.res)
                       if w.res is not None else None)
                tentative.append((orc, res, w.scored))
        else:
            phase1: dict = {}
            n_walks = 0
            for t in tasks:
                orc = self._entry_orc(t) if route else self
                # a noisy walk draws from the rng: every task walks
                key = None if noisy else self._task_signature(orc, t)
                hit = phase1.get(key) if key is not None else None
                if hit is not None:
                    res0, scored = hit
                    res = (dataclasses.replace(res0)
                           if res0 is not None else None)
                else:
                    scored = set()
                    res = orc._map_once(t, now, ctx, scored)
                    n_walks += 1
                    if key is not None:
                        phase1[key] = (res, scored)
                tentative.append((orc, res, scored))
        # phase 2: ordered commit; re-walk when the optimistic result is
        # stale (an earlier commit landed on a device this walk scored).
        # Fast re-walks splice only the committed devices' segments back
        # into the tracked scans.
        dirty: set[str] = set()
        out: list[Optional[MapResult]] = []
        warmed = not fast
        rewalks = 0
        rewalks_fused = 0
        cp = sp and spans.enter("walk.commit")
        for i, (t, (orc, res, scored)) in enumerate(zip(tasks, tentative)):
            if dirty and not dirty.isdisjoint(scored):
                rewalks += 1
                if not warmed:
                    # first re-walk of the batch: warm the comm-LUT route
                    # rows of every task still to commit in one batched
                    # Dijkstra instead of one lazy row build per re-walk
                    warm: set = set()
                    for t2 in tasks[i:]:
                        if t2.origin is not None:
                            warm.add(t2.origin)
                        warm.update(t2.attrs.get("src_devices") or ())
                    comp.ensure_routes(warm)
                    warmed = True
                if fast:
                    entry = orc._entry_fused(t, now, ctx)
                    rewalks_fused += entry[0]
                    res = orc._map_once_fast(t, now, ctx, None, entry)
                else:
                    res = orc._map_once(t, now, ctx, set())
            if res is not None and commit:
                # ledger.add journals the commit's device into mut_log —
                # the log every batch context aliases as its commit_log
                self.ledger.add(t, res.pu, res.prediction, now)
                t.assigned_pu = res.pu
                dirty.add(comp.device_name(res.pu))
            out.append(res)
        if sp:
            spans.leave(cp)
            spans.leave(sp)
            spans.add("walk.tasks", len(tasks))
            spans.add("walk.walks", n_walks)
            spans.add("walk.rewalks", rewalks)
            spans.add("walk.rewalks_fused", rewalks_fused)
        return out

    def _session_context(self, comp) -> _BatchContext:
        """The session-resident :class:`_BatchContext` for ``comp``,
        reused across ``map_batch`` calls (the serving fast path).

        Reuse rules: same graph and ledger, a mutation journal of at most
        50 000 entries, and either the same snapshot or a bandwidth-only
        successor (``pu_alive``, the route topology layer, the PU index,
        ``ncr_rclass`` and ``mem_cap`` all the *same objects*: then the
        core scan states, splices and ledger views stay valid and only the
        comm-bearing caches are rebuilt).  Anything else — a death or
        revival, an NCR refresh, a swapped ledger — drops the context and
        the next wave pays one cold build."""
        ctx = self._resident_ctx
        led = self.ledger
        if ctx is not None and (ctx.ledger is not led
                                or ctx.graph is not self.graph
                                or len(led.mut_log) > 50_000):
            ctx = None
        if ctx is not None and ctx.comp is not comp:
            old = ctx.comp
            if (comp.pu_alive is old.pu_alive
                    and comp._rt.topo is old._rt.topo
                    and comp.pu_index is old.pu_index
                    and comp.ncr_rclass is old.ncr_rclass
                    and comp.mem_cap is old.mem_cap):
                ctx.rebase(comp)
                self.context_rebases += 1
            else:
                ctx = None
        if ctx is None:
            if len(led.mut_log) > 50_000 and self._resident_ctx is not None:
                # no live context references the journal any more; reset
                # it in place (the shards alias the same list)
                del led.mut_log[:]
            ctx = _BatchContext(self.graph, comp, self.traverser, led)
            self._resident_ctx = ctx
            self.context_builds += 1
        elif len(ctx._sigs) > 8192:
            # id(task)-keyed memos accrete one entry per request over a
            # serving session; they are pure memos, safe to drop
            ctx._sigs = {}
            ctx._cores = {}
            ctx._mkeys = {}
        return ctx

    # -- fused wave-batched walk (the array lowering of Alg. 1) --------------
    def _scan_plan(self, comp) -> _ScanPlan:
        """This ORC's subtree lowered to scan arrays (cached per snapshot)."""
        cache = self._plan_cache
        if cache is not None and cache[0] is comp:
            return cache[1]
        p = _ScanPlan()
        p.pus = self._subtree_pus()
        pu_lo: list[int] = []
        pu_hi: list[int] = []
        leafcnt: list[int] = []
        nchild: list[int] = []
        hopsum: list[float] = []
        depth: list[int] = []
        p.leaf_groups = []
        p.devs = []
        p.dev_ranges = {}
        p.dev_sublists = {}
        cursor = 0

        def build(orc: "Orchestrator", d: int) -> None:
            nonlocal cursor
            i = len(pu_lo)
            pu_lo.append(cursor)
            pu_hi.append(0)          # patched after the subtree is laid out
            n_leaf = len(orc.leaf_pus)
            leafcnt.append(n_leaf)
            nchild.append(len(orc.children))
            depth.append(d)
            h = 0.0
            for c in orc.children:
                h += orc._hop_cost(c)
            hopsum.append(h)
            if n_leaf:
                p.leaf_groups.append(orc.group)
                p.devs.append(orc.group)
                p.dev_ranges[orc.group] = (cursor, cursor + n_leaf)
                p.dev_sublists[orc.group] = orc.leaf_pus
            cursor += n_leaf
            for c in orc.children:
                build(c, d + 1)
            pu_hi[i] = cursor

        build(self, 0)
        p.rows = (pu_lo, pu_hi, leafcnt, nchild, hopsum, depth)
        p.arrays = ScanPlanArrays.from_lists(*p.rows, comp.device)
        self._plan_cache = (comp, p)
        return p

    def _child_plan(self, comp) -> _ChildPlan:
        """Every child subtree concatenated into one AskParent candidate
        list (cached per snapshot).  All asking children share this one
        plan — and therefore one tracked scan state per task core — with
        the asker's own slice masked out at selection time."""
        cache = self._child_cache
        if cache is not None and cache[0] is comp:
            return cache[1]
        cp = _ChildPlan()
        cp.children = list(self.children)
        cp.child_pos = {id(c): i for i, c in enumerate(cp.children)}
        cp.pus = []
        cp.devs = []
        cp.dev_ranges = {}
        cp.dev_sublists = {}
        cp.leaf_groups = []
        bounds = [0]
        hc = []
        prefix = []
        running = 0.0
        for c in cp.children:
            plan = c._scan_plan(comp)
            lo = len(cp.pus)
            cp.pus.extend(plan.pus)
            bounds.append(lo + len(plan.pus))
            h = self._hop_cost(c)
            hc.append(h)
            running += h
            prefix.append(running)
            for dev, (a, b) in plan.dev_ranges.items():
                cp.dev_ranges[dev] = (lo + a, lo + b)
                cp.dev_sublists[dev] = plan.dev_sublists[dev]
            cp.devs.extend(plan.devs)
            cp.leaf_groups.extend(plan.leaf_groups)
        # host lists: the walk reads bounds / hop costs one scalar at a time
        cp.bounds = bounds
        cp.hc = hc
        cp.hop_prefix = prefix
        # scan states key on id(plan.pus): when a snapshot swap rebuilds
        # this plan with the same candidate list (bandwidth churn), keep
        # the previous list object so the resident context's states and
        # per-list memos survive
        if cache is not None and cache[1].pus == cp.pus:
            cp.pus = cache[1].pus
        self._child_cache = (comp, cp)
        return cp

    def _check_arrays(self, task: Task, pu_names: list[str], now: float,
                      ctx: "_BatchContext") -> tuple:
        """Fused core check returning dense (ok, sa, f, wait) columns over
        ``pu_names`` (ineligible rows keep the infeasible defaults) —
        origin-independent, see :class:`_ScanState`.

        Single-device checks — the shape of every commit splice — are
        additionally cached by the device's *canonical* occupancy pattern
        (the slowdown model's structural key extended with everything
        else the constraint blocks read: active finish/factor/deadline/
        release columns, the candidates' standalone/tenancy inputs and
        the check instant).  Replicated fleets then pay one real check
        per occupancy stage instead of one per device."""
        n = len(pu_names)
        dev = ctx.device
        static = ctx.static_core(self, task, pu_names)
        cols = static.cols
        ck = None
        fused = None
        fkey = None
        view = None
        if len(static.cols_l) and static.single_dev is not None:
            sd = self.traverser.slowdown
            view = ctx.view(static.single_dev)
            fkey = (ctx.core_sig(task), static.single_dev)
            fent = ctx.factor_cache.get(fkey)
            if fent is not None and fent[0] is view and fent[1] is static:
                # identity hit: the device view object survives exactly
                # while (epoch, version) are unchanged, so the factors —
                # which never read the clock — are still exact
                fused = (fent[2], view)
            else:
                canon = getattr(sd, "_canon_key", None)
                if canon is not None and len(view):
                    key, _ = canon(ctx.comp, task, static.cand_idx,
                                   static.cand_dev, view.P, view.upu,
                                   view.Ma, view.uid, view.astart, view.na)
                    if key is not None:
                        ck = (ctx.core_sig(task), key, n, now,
                              tuple(static.cols_l),
                              bytes_key(static.sa, static.maxten, view.est,
                                        view.fac, view.dl, view.rel))
                        hit = ctx.splice_cache.get(ck)
                        if hit is not None:
                            return (hit[0].clone(), hit[1].clone(),
                                    hit[2].clone(), hit[3].clone(), hit[4])
        terms = None
        expiry = _INF
        if len(static.cols_l):
            if fused is None and fkey is not None:
                sd = self.traverser.slowdown
                fac = sd.factors_same_device(
                    ctx.comp, task, static.cand_idx, static.cand_dev,
                    view.P, view.upu, view.Ma, view.uid, view.Da,
                    view.astart, view.na)
                _fifo_put(ctx.factor_cache, fkey, (view, static, fac), 4096)
                fused = (fac, view)
            *terms, expiry = self._score_fused_arrays(
                task, static, now, with_constraints=True, ctx=ctx,
                split_comm=True, fused=fused)
        ok, sa, f, wait = segment_columns(n, cols, terms, dev)
        if ck is not None:
            # keys embed the check instant, so a resident serving context
            # would otherwise accrete one generation of entries per wave
            _fifo_put(ctx.splice_cache, ck,
                      (ok.clone(), sa.clone(), f.clone(), wait.clone(),
                       expiry), 512)
        return ok, sa, f, wait, expiry

    def _scan_state(self, task: Task, plan, ctx: "_BatchContext") -> tuple:
        """``(key, st)``: the key of the task core's tracked scan state
        over ``plan`` in ``ctx.scan_states``, and that state where it is
        still valid — the ledger's epoch unchanged and its refresh journal
        within its bound — else None."""
        key = (ctx.core_sig(task), id(plan.pus))
        st = ctx.scan_states.get(key)
        if st is not None and (st.epoch != self.ledger.dev_epoch
                               or len(st.refresh_log) > 65536):
            st = None
        return key, st

    def _tracked_checks(self, task: Task, plan, now: float,
                        ctx: "_BatchContext",
                        looked: Optional[tuple] = None) -> _ScanState:
        """Core constraint checks over ``plan.pus`` with commit-aware
        reuse.

        The first walk of a (task core, candidate list) pair pays one
        fused check; every later walk — same task or any task sharing its
        core — splices fresh single-device checks over exactly the devices
        committed since.  The block-diagonal check scores devices
        independently, so the untouched segments equal a full rescan.
        ``looked`` is what :meth:`_entry_fused` found of this plan before
        it declined: :meth:`_scan_state`'s pair and, where the state is
        valid, its stale devices."""
        led = self.ledger
        key, st, refresh = (looked if looked is not None
                            else (*self._scan_state(task, plan, ctx), None))
        if st is None:
            st = _ScanState(len(plan.pus), ctx.device)
            st.ok, st.sa, st.f, st.wait, _ = self._check_arrays(
                task, plan.pus, now, ctx)
            st.epoch = led.dev_epoch
            st.stamps = {d: led.dev_version.get(d, 0) for d in plan.devs}
            st.log_pos = len(ctx.commit_log)
            st.now = now
            ctx.scan_states[key] = st
            return st
        if refresh is None:
            refresh = self._stale_devices(st, plan, now, ctx)
        st.log_pos = len(ctx.commit_log)
        st.now = now
        # deterministic splice order (the columns are disjoint per device)
        for dev in sorted(refresh):
            lo, hi = plan.dev_ranges[dev]
            o, s_, f_, w_, e = self._check_arrays(
                task, plan.dev_sublists[dev], now, ctx)
            st.ok[lo:hi] = o
            st.sa[lo:hi] = s_
            st.f[lo:hi] = f_
            st.wait[lo:hi] = w_
            st.spliced(dev, led.dev_version.get(dev, 0), e)
        return st

    def _stale_devices(self, st: _ScanState, plan, now: float,
                       ctx: "_BatchContext") -> set:
        """The devices of ``plan`` whose segment of ``st`` a check at
        ``now`` re-checks: those committed to since the state last looked
        (by the journal and the devices' versions) and, when the clock
        moved, the occupied ones whose last check has expired.  Reads
        only: the caller advances ``st.log_pos`` and ``st.now``."""
        led = self.ledger
        log = ctx.commit_log
        refresh: set = set()
        if st.log_pos < len(log):
            for dev in set(log[st.log_pos:]):
                if dev in plan.dev_ranges \
                        and st.stamps.get(dev) != led.dev_version.get(dev, 0):
                    refresh.add(dev)
        if st.now != now:
            # the clock moved since the columns were checked: occupied
            # devices' tenancy-wait and l.15 terms read ``now``
            for dev in led.occupied_devices(ctx.comp):
                if dev in plan.dev_ranges and dev not in refresh:
                    e = st.expiry.get(dev)
                    if e is None or e <= now:
                        refresh.add(dev)
        return refresh

    @staticmethod
    def _eff_entry(task: Task, st: _ScanState, plan,
                   ctx: "_BatchContext") -> tuple:
        """``(key, entry)``: the key of the signature's effective columns
        over ``plan`` in ``ctx.eff_cache``, and the cached
        :class:`_Effective` where it was layered over ``st`` (else
        None)."""
        ck = (ctx.task_sig(task), id(plan.pus))
        ent = ctx.eff_cache.get(ck)
        return ck, (ent if ent is not None and ent.st is st else None)

    @staticmethod
    def _eff_put(ctx: "_BatchContext", ck, st: _ScanState, ok: torch.Tensor,
                 cm: torch.Tensor, key: torch.Tensor) -> None:
        _fifo_put(ctx.eff_cache, ck,
                  _Effective(st, ok, cm, key, ctx.commit_log), 24)

    def _effective(self, task: Task, st: _ScanState, plan, now: float,
                   ctx: "_BatchContext") -> tuple:
        """Layer the per-signature pieces over a shared core state: the
        comm column (origin / provenance / return leg, plus the tenancy
        wait) gathered onto the plan, the selection key ``cm + sa*f``,
        and the deadline mask.  Cached per (task signature, plan) and
        patched per committed device, mirroring the tracked scan
        states."""
        static = ctx.static_score(self, task, plan.pus)
        cols = static.cols
        cols_l = static.cols_l
        dl = task.deadline
        log = ctx.commit_log
        rlog = st.refresh_log
        ck, ent = self._eff_entry(task, st, plan, ctx)
        if ent is not None:
            ok, cm, key = ent.ok, ent.cm, ent.key
            if ent.pos < len(log) or ent.rpos < len(rlog):
                for dev in sorted(set(log[ent.pos:]).union(rlog[ent.rpos:])):
                    rng = plan.dev_ranges.get(dev)
                    if rng is None:
                        continue
                    lo, hi = rng
                    jlo = bisect.bisect_left(cols_l, lo)
                    jhi = bisect.bisect_left(cols_l, hi)
                    effective_segment(ok, cm, key, st.ok, st.sa, st.f,
                                      st.wait, lo, hi, cols[jlo:jhi],
                                      static.comm[jlo:jhi], dl)
                ent.caught_up(log)
            return ok, cm, key
        cm = torch.zeros(len(plan.pus), dtype=FLOAT, device=ctx.device)
        if len(cols_l):
            cm[cols] = static.comm + st.wait[cols]
        key = cm + st.sa * st.f
        if dl is not None:
            ok = st.ok & ~(key > dl)
        else:
            ok = st.ok.clone()         # the cache owns a mutable copy
        self._eff_put(ctx, ck, st, ok, cm, key)
        return ok, cm, key

    def _scan_reduce(self, ok_d: torch.Tensor, cm_d: torch.Tensor,
                     key_d: torch.Tensor, st: _ScanState, plan: _ScanPlan,
                     offset: int = 0) -> Optional[MapResult]:
        """Replay TraverseChildren's accounting over one scan in closed
        form (one launch of the scan-reduce kernel) and return its winner.
        ``ok_d``/``cm_d`` and the precomputed ``cm + sa*f`` selection
        column ``key_d`` are the per-signature effective columns over the
        plan that ``st`` (plus ``offset``) is sliced against.  The kernel's
        results, the winner's prediction columns among them, come back to
        the host in ONE copy."""
        n = len(plan.pus)
        ok, sa, f, cm, key = ok_d, st.sa, st.f, cm_d, key_d
        if offset or ok.shape[0] != n:
            sl = slice(offset, offset + n)
            ok, sa, f, cm, key = ok[sl], sa[sl], f[sl], cm[sl], key[sl]
        if self.config.objective == "min_load":
            cnt = self.ledger.count
            key = f64([cnt(p) for p in plan.pus], ok.device)
        return self._scan_result(host_list(scan_reduce(
            ok, key, sa, f, cm, plan.arrays, self.config.local_query_cost)),
            plan)

    @staticmethod
    def _scan_result(row: list, plan) -> Optional[MapResult]:
        """The winner of a scan from its seven values (``row`` may hold
        more after them), or None where its root is infeasible."""
        w, queries, hops, overhead, sa_w, f_w, cm_w = row[:7]
        if w < 0:
            return None
        pred = TaskPrediction(sa_w, f_w, cm_w)
        return MapResult(pu=plan.pus[int(w)], prediction=pred,
                         overhead=overhead, queries=int(queries),
                         hops=int(hops))

    def _entry_columns(self, task: Task, now: float, ctx: "_BatchContext",
                       scored: Optional[set],
                       looked: Optional[tuple] = None) -> Optional[tuple]:
        """The entry TraverseChildren scan over this ORC's subtree, up to
        its reduce: ``(ok, cm, key, st, plan)`` as :meth:`_scan_reduce`
        takes them, or None when the subtree holds no PU.  ``looked``:
        as :meth:`_tracked_checks` takes it."""
        plan = self._scan_plan(ctx.comp)
        if scored is not None:
            scored.update(plan.leaf_groups)
        if not plan.pus:
            return None
        st = self._tracked_checks(task, plan, now, ctx, looked)
        ok, cm, key = self._effective(task, st, plan, now, ctx)
        return ok, cm, key, st, plan

    def _traverse_fast(self, task: Task, now: float, ctx: "_BatchContext",
                       scored: Optional[set],
                       looked: Optional[tuple] = None) -> Optional[MapResult]:
        """TraverseChildren over this ORC's subtree as one tracked scan."""
        cols = self._entry_columns(task, now, ctx, scored, looked)
        return None if cols is None else self._scan_reduce(*cols)

    def _ask_level_fast(self, task: Task, now: float, ctx: "_BatchContext",
                        scored: Optional[set]) -> Optional[MapResult]:
        """One AskParent level as a flat selection over every sibling
        subtree at once.

        Alg. 1 picks each sibling's winner, then selects among them — and
        neither selection key depends on the escalation hops charged along
        the way, so the overall winner is the flat first-wins argmin over
        all sibling candidates.  Only the winning sibling's subtree
        replays its accounting; the hop/overhead running charges come
        from the plan's prefix.  The scan runs over the parent's shared
        child plan with the asker's own slice masked out of the
        selection, exactly as Alg. 1 skips the asking child."""
        parent = self.parent
        comp = ctx.comp
        cp = parent._child_plan(comp)
        if scored is not None:
            scored.update(cp.leaf_groups)
        ci = cp.child_pos[id(self)]
        lo_c = cp.bounds[ci]
        hi_c = cp.bounds[ci + 1]
        if len(cp.pus) == hi_c - lo_c:
            return None                       # no siblings at this level
        names = [self.group, parent.group]
        if task.origin is not None:
            names.append(task.origin)
        names.extend(task.attrs.get("src_devices") or ())
        comp.ensure_routes(names)
        st = self._tracked_checks(task, cp, now, ctx)
        ok_d, cm_d, key_d = self._effective(task, st, cp, now, ctx)
        # flat first-wins argmin over the siblings' feasible candidates
        sel = ok_d.clone()
        sel[lo_c:hi_c] = False
        if self.config.objective == "min_load":
            cnt = self.ledger.count
            keys = f64([cnt(p) for p in cp.pus], sel.device)
        else:
            keys = key_d
        masked = torch.where(sel, keys, torch.full_like(keys, _INF))
        kmin = masked.min()
        cand = sel & (masked == kmin)
        any_ok, w = host_list(torch.stack(
            [sel.any().to(INT), torch.argmax(cand.to(torch.uint8))]))
        if not any_ok:
            return None
        k = bisect.bisect_right(cp.bounds, w) - 1
        sibling = cp.children[k]
        sub = sibling._scan_reduce(ok_d, cm_d, key_d, st,
                                   sibling._scan_plan(comp),
                                   offset=cp.bounds[k])
        # the running Alg. 1 charges at the winning sibling's position:
        # one hop up to the parent plus one per *sibling* asked so far
        # (the asker itself is skipped in the iteration order)
        k_sib = k - (1 if ci < k else 0)
        sub.hops += 1 + (k_sib + 1)
        ov = cp.hop_prefix[k] - (cp.hc[ci] if ci < k else 0.0)
        sub.overhead += self._hop_cost(parent) + ov
        return sub

    def _entry_fused(self, task: Task, now: float,
                     ctx: "_BatchContext") -> tuple:
        """A phase-2 re-walk's entry scan in ONE launch and ONE host read,
        where the re-walk's shape allows it: an entry plan over one device
        (a device ORC's), whose task core's scan state is current at
        ``now`` but for exactly that device's segment, under an objective
        that reads no ledger counts and a slowdown model that offers the
        route (``rewalk_entry``, which runs
        :func:`~repro_torch.kernels.walk_kernel.rewalk_entry`).  The launch
        re-checks the segment, splices it into the scan state and rewrites
        the signature's effective columns over it as
        :meth:`_tracked_checks` and :meth:`_effective` do, then reduces the
        plan as :meth:`_scan_reduce` does; the bookkeeping below is theirs,
        so every later walk finds the state the two-step path leaves (the
        splice and factor caches, being caches, are left as they are).

        Returns ``(True, winner)`` where it ran the entry scan (``winner``
        None where no PU of the plan is feasible), else ``(False,
        looked)``: the caller walks the two-step path, handing
        :meth:`_tracked_checks` what was looked up here (None where
        nothing was)."""
        sd = self.traverser.slowdown
        fused = getattr(sd, "rewalk_entry", None)
        if self.config.objective == "min_load" or fused is None:
            return False, None
        comp = ctx.comp
        plan = self._scan_plan(comp)
        if len(plan.devs) != 1 or len(plan.pus) > BLOCK_MAX_P:
            return False, None
        key, st = self._scan_state(task, plan, ctx)
        if st is None:
            return False, (key, None, None)
        refresh = self._stale_devices(st, plan, now, ctx)
        looked = (key, st, refresh)
        dev = plan.devs[0]
        if st.now != now or refresh != {dev}:
            return False, looked
        core = ctx.static_core(self, task, plan.dev_sublists[dev])
        if core.cols_l and core.single_dev != dev:
            return False, looked
        # the plan holds this one device: every eligible column of the
        # signature lies in its segment
        static = ctx.static_score(self, task, plan.pus)
        lo, hi = plan.dev_ranges[dev]
        ck, ent = self._eff_entry(task, st, plan, ctx)
        if ent is None:
            n = len(plan.pus)
            ok = torch.empty(n, dtype=BOOL, device=ctx.device)
            cm = torch.empty(n, dtype=FLOAT, device=ctx.device)
            key = torch.empty(n, dtype=FLOAT, device=ctx.device)
        else:
            ok, cm, key = ent.ok, ent.cm, ent.key
        view = ctx.view(dev)
        row = fused(comp, RewalkSegment(
            task.usage.get("pu", 1.0), task.usage.get("mem", 1.0), task.uid,
            task.deadline, now, core.cand_idx, core.cand_dev, core.cols,
            core.sa, core.maxten, static.cols, static.comm, view.P,
            view.upu, view.Ma, view.uid, view.est, view.fac, view.dl,
            view.rel, view.Da, view.astart, view.na, st.ok, st.sa, st.f,
            st.wait, lo, hi - lo, ok, cm, key, plan.arrays,
            self.config.local_query_cost))
        # _tracked_checks' bookkeeping of the splice (``st.now`` is ``now``)
        st.log_pos = len(ctx.commit_log)
        st.spliced(dev, self.ledger.dev_version.get(dev, 0),
                   _expiry(now, row[7], row[8]))
        # _effective's of the patched entry
        if ent is None:
            self._eff_put(ctx, ck, st, ok, cm, key)
        else:
            ent.caught_up(ctx.commit_log)
        return True, self._scan_result(row, plan)

    def _map_once_fast(self, task: Task, now: float, ctx: "_BatchContext",
                       scored: Optional[set],
                       entry: Optional[tuple] = None) -> Optional[MapResult]:
        """One full Alg. 1 walk on the fused path (phase-2 re-walks);
        ``entry`` is :meth:`_entry_fused`'s result where it was asked
        first."""
        if entry is not None and entry[0]:
            res = entry[1]
        else:
            res = self._traverse_fast(task, now, ctx, scored,
                                      None if entry is None else entry[1])
        cur = self
        while res is None and cur.parent is not None:
            res = cur._ask_level_fast(task, now, ctx, scored)
            cur = cur.parent
        if res is None and self.config.allow_best_effort:
            res = self._best_effort(task, now, ctx, scored)
        return res

    def _batch_checks(self, ctx: "_BatchContext", reqs: list,
                      now: float) -> None:
        """Seed the tracked scan states of ``reqs`` — (orc, task, plan)
        triples sharing one wave depth — with a single
        ``factors_same_device_multi`` call (one factor-kernel launch for
        the whole depth)."""
        sp = spans.enter("walk.checks") if _SPANS else None
        sd = self.traverser.slowdown
        led = self.ledger
        comp = ctx.comp
        items = []
        metas = []
        for orc, task, plan in reqs:
            if not plan.pus:
                continue
            key = (ctx.core_sig(task), id(plan.pus))
            if key in ctx.scan_states:
                continue
            static = ctx.static_core(orc, task, plan.pus)
            st = _ScanState(len(plan.pus), ctx.device)
            st.epoch = led.dev_epoch
            st.stamps = {d: led.dev_version.get(d, 0) for d in plan.devs}
            st.log_pos = len(ctx.commit_log)
            st.now = now
            ctx.scan_states[key] = st
            if not len(static.cols_l):
                continue
            if static.single_dev is not None:
                view = ctx.view(static.single_dev)
            else:
                view = led.live_view(comp)
            items.append((task, static.cand_idx, static.cand_dev, view.P,
                          view.upu, view.Ma, view.uid, view.Da,
                          view.astart, view.na))
            metas.append((orc, task, static, view, st))
        outs = sd.factors_same_device_multi(comp, items) if items else ()
        for (orc, task, static, view, st), fused in zip(metas, outs):
            o, s_, f_, w_, e = orc._score_fused_arrays(
                task, static, now, with_constraints=True, ctx=ctx,
                fused=(fused, view), split_comm=True)
            cols = static.cols
            st.ok[cols] = o
            st.sa[cols] = s_
            st.f[cols] = f_
            st.wait[cols] = w_
            if static.single_dev is not None:
                st.expiry[static.single_dev] = e
        if sp:
            spans.leave(sp)

    def _dedup_walks(self, tasks: list, route: bool,
                     ) -> tuple[dict, list["_Walk"]]:
        """Dedup a frontier by task signature: identical tasks walk once
        in phase 1 (commits are replayed per task in phase 2)."""
        walks: dict = {}
        order: list[_Walk] = []
        for t in tasks:
            orc = self._entry_orc(t) if route else self
            key = self._task_signature(orc, t)
            if key not in walks:
                w = walks[key] = _Walk(orc, t)
                order.append(w)
        return walks, order

    def _escalate_walks(self, active: list["_Walk"], now: float,
                        ctx: "_BatchContext",
                        stop_root: bool = False) -> None:
        """Advance unresolved walks through AskParent levels in lockstep,
        batching each escalation depth's constraint checks into one
        kernel call and each depth's route rows into one batched
        Dijkstra.  With ``stop_root=True`` walks park *below* the root
        level (``cur.parent.parent is None``) instead of asking it — the
        group-sharded driver escalates intra-group levels per group and
        keeps the root scan (the only cross-group one) for the serial
        boundary reconciliation."""
        sp = spans.enter("walk.escalate") if _SPANS else None
        comp = ctx.comp
        while active:
            warm: set = set()
            for w in active:
                warm.add(w.cur.group)
                warm.add(w.cur.parent.group)
                if w.task.origin is not None:
                    warm.add(w.task.origin)
                warm.update(w.task.attrs.get("src_devices") or ())
            comp.ensure_routes(warm)
            self._batch_checks(
                ctx, [(w.orc, w.task, w.cur.parent._child_plan(comp))
                      for w in active], now)
            nxt: list[_Walk] = []
            for w in active:
                w.res = w.cur._ask_level_fast(w.task, now, ctx, w.scored)
                if w.res is None:
                    w.cur = w.cur.parent
                    if w.cur.parent is not None and not (
                            stop_root and w.cur.parent.parent is None):
                        nxt.append(w)
            active = nxt
        if sp:
            spans.leave(sp)

    def _drive_wave(self, order: list["_Walk"], now: float,
                    ctx: "_BatchContext", stop_root: bool = False) -> None:
        """Resolve a set of deduped walks: batched entry checks, one
        tracked entry scan per walk, then lockstep escalation."""
        comp = ctx.comp
        self._batch_checks(
            ctx, [(w.orc, w.task, w.orc._scan_plan(comp)) for w in order],
            now)
        self._entry_reduce_batch(order, now, ctx)
        active = [w for w in order
                  if w.res is None and w.cur.parent is not None and not (
                      stop_root and w.cur.parent.parent is None)]
        self._escalate_walks(active, now, ctx, stop_root=stop_root)

    def _entry_reduce_batch(self, ws: list["_Walk"], now: float,
                            ctx: "_BatchContext") -> None:
        """Resolve every walk's entry TraverseChildren scan: the wave's
        scans go to ONE ``scan_reduce_batch`` launch (one per distinct
        local query cost), over the wave's plans concatenated on this
        call, and come back in one host copy.  Phase 1 reads a frozen
        ledger, so reducing after every walk's checks equals reducing walk
        by walk.  ``min_load`` walks keep the per-walk reduce — their
        selection key reads live ledger counts."""
        sp = spans.enter("walk.entry") if _SPANS else None
        groups: dict = {}
        for w in ws:
            cols = w.orc._entry_columns(w.task, now, ctx, w.scored)
            if cols is None:
                w.res = None
            elif w.orc.config.objective == "min_load":
                w.res = w.orc._scan_reduce(*cols)
            else:
                groups.setdefault(w.orc.config.local_query_cost, []).append(
                    (w, cols))
        for lqc, rows in groups.items():
            scans = []
            plan_cols: tuple = ([], [], [], [], [], [])
            off = 0
            for _, (_, _, _, _, plan) in rows:
                n = len(plan.pus)
                scans.append((off, n, len(plan_cols[0]), plan.arrays.n))
                off += n
                for col, row in zip(plan_cols, plan.rows):
                    col.extend(row)
            out = host_list(scan_reduce_batch(
                torch.cat([c[0] for _, c in rows]),
                torch.cat([c[2] for _, c in rows]),
                torch.cat([c[3].sa for _, c in rows]),
                torch.cat([c[3].f for _, c in rows]),
                torch.cat([c[1] for _, c in rows]),
                ScanPlanArrays.from_lists(*plan_cols, ctx.comp.device),
                scans, lqc))
            for (w, cols), (wi, q, h, ov, sa_w, f_w, cm_w) in zip(rows, out):
                w.res = None if wi < 0 else MapResult(
                    pu=cols[4].pus[int(wi)],
                    prediction=TaskPrediction(sa_w, f_w, cm_w),
                    overhead=ov, queries=int(q), hops=int(h))
        if sp:
            spans.leave(sp)

    def _walk_wave(self, tasks: list, now: float, ctx: "_BatchContext",
                   route: bool) -> dict:
        """Phase 1: walk every distinct task signature against the frozen
        ledger, advancing all walks in lockstep."""
        walks, order = self._dedup_walks(tasks, route)
        self._drive_wave(order, now, ctx)
        if self.config.allow_best_effort:
            for w in order:
                if w.res is None:
                    w.res = w.orc._best_effort(w.task, now, ctx, w.scored)
        return walks

    def _shard_root_of(self, orc: "Orchestrator",
                       ) -> Optional["Orchestrator"]:
        """The root-child subtree (= group shard) an ORC belongs to, or
        None for the root itself (serial bucket)."""
        while orc.parent is not None and orc.parent.parent is not None:
            orc = orc.parent
        return orc if orc.parent is not None else None

    def _walk_wave_sharded(self, tasks: list, now: float,
                           ctx: "_BatchContext", route: bool) -> dict:
        """Group-sharded phase 1: partition the deduped walks by root
        child (= ORC device group), drive each group's walks up to (but
        excluding) the root escalation level — on host threads when the
        host has two or more cores and the wave is big enough — then
        reconcile at the group boundary, the root's child-plan scan (the
        only one whose NCR rows cross groups), serially.

        Equal to :meth:`_walk_wave` because phase 1 is pure against the
        frozen ledger and every scan an intra-group walk touches reads
        only its own group's PU columns: the partition of walks is a
        partition of all reads.  A group thread's error propagates (the
        executor's ``map`` re-raises it here)."""
        comp = ctx.comp
        walks, order = self._dedup_walks(tasks, route)
        buckets: dict = {}
        serial: list[_Walk] = []
        for w in order:
            root = self._shard_root_of(w.orc)
            if root is None:
                serial.append(w)
            else:
                buckets.setdefault(id(root), []).append(w)
        groups = list(buckets.values())
        if len(groups) < 2:
            self._drive_wave(order, now, ctx)
        else:
            # host-thread fan-out only where it can win: >=2 cores and a
            # wave big enough to amortize the pool and the route pre-warm
            nthreads = min(len(groups), os.cpu_count() or 1)
            if nthreads < 2 or len(order) < 64 * len(groups):
                for ws in groups:
                    self._drive_wave(ws, now, ctx, stop_root=True)
            else:
                # warm every route row a group thread could need up front:
                # one batched Dijkstra instead of contended lazy builds
                warm: set = set()
                for w in order:
                    if w.task.origin is not None:
                        warm.add(w.task.origin)
                    warm.update(w.task.attrs.get("src_devices") or ())
                    cur = w.orc
                    while cur is not None:
                        warm.add(cur.group)
                        cur = cur.parent
                comp.ensure_routes(warm)
                # each group's spans nest under this thread's open span
                parent = spans.current() if _SPANS else None
                with ThreadPoolExecutor(max_workers=nthreads) as ex:
                    list(ex.map(
                        lambda ws: spans.under(parent, self._drive_wave, ws,
                                               now, ctx, stop_root=True),
                        groups))
            if serial:
                self._drive_wave(serial, now, ctx)
            # boundary reconciliation: walks that exhausted their group
            # escalate through the root's cross-group scan, serially
            pend = [w for w in order
                    if w.res is None and w.cur.parent is not None]
            self._escalate_walks(pend, now, ctx)
        if self.config.allow_best_effort:
            for w in order:
                if w.res is None:
                    w.res = w.orc._best_effort(w.task, now, ctx, w.scored)
        return walks

    @staticmethod
    def _task_signature(orc: "Orchestrator", t: Task) -> tuple:
        """Signature of everything a walk reads off the task: tasks with
        equal signatures produce identical phase-1 walks."""
        return (id(orc), t.kind, t.size, t.deadline, t.origin, t.input_bytes,
                bool(t.attrs.get("pinned")),
                t.attrs.get("succ_pinned_bytes", 0.0),
                tuple(t.attrs.get("src_devices") or ()),
                tuple(sorted(t.usage.items())),
                tuple((k, t.attrs[k]) for k in ("flops", "bytes", "coll_bytes")
                      if k in t.attrs))

    def _entry_orc(self, task: Task) -> "Orchestrator":
        if self._device_orcs is None:
            self._device_orcs = {o.group: o for o in self.iter_tree()
                                 if o.is_device_orc()}
        orc = (self._device_orcs.get(task.origin)
               if task.origin is not None else None)
        if orc is None:
            orc = next(iter(self._device_orcs.values()), self)
        return orc

    # -- the object walk (Alg. 1 as written) ---------------------------------
    def _map_once(self, task: Task, now: float, ctx: Optional[_BatchContext],
                  scored: set) -> Optional[MapResult]:
        res = self._traverse_children(task, now, ctx, scored)
        if res is None:
            res = self._ask_parent(task, now, origin=self, ctx=ctx,
                                   scored=scored)
        if res is None and self.config.allow_best_effort:
            res = self._best_effort(task, now, ctx, scored)
        return res

    # TraverseChildren (Alg. 1 line 20)
    def _traverse_children(self, task: Task, now: float,
                           ctx: Optional[_BatchContext] = None,
                           scored: Optional[set] = None,
                           pre: Optional[dict] = None,
                           ) -> Optional[MapResult]:
        candidates: list[MapResult] = []
        queries = 0
        hops = 0
        overhead = 0.0
        if pre is None and self.children:
            # fuse the whole subtree's constraint check into one call;
            # the recursion below only replays Alg. 1's accounting
            pus = self._subtree_pus()
            pre = dict(zip(pus, self._check_candidates(task, pus, now,
                                                       ctx=ctx)))
        if scored is not None and self.leaf_pus:
            scored.add(self.group)
        if pre is not None and self.leaf_pus:
            checks = [pre[p] for p in self.leaf_pus]
        else:
            checks = self._check_candidates(task, self.leaf_pus, now, ctx=ctx)
        for pu_name, (ok, pred) in zip(self.leaf_pus, checks):
            queries += 1
            if ok:
                r = MapResult(pu=pu_name, prediction=pred)
                if self.config.objective == "first_fit":
                    r.queries = queries
                    r.overhead = overhead + queries * self.config.local_query_cost
                    r.hops = hops
                    return r
                candidates.append(r)
        for child in self.children:
            hops += 1
            overhead += self._hop_cost(child)
            sub = child._traverse_children(task, now, ctx, scored, pre)
            if sub is not None:
                queries += sub.queries
                hops += sub.hops
                overhead += sub.overhead
                if self.config.objective == "first_fit":
                    sub.queries = queries
                    sub.hops = hops
                    sub.overhead = overhead + queries * self.config.local_query_cost
                    return sub
                candidates.append(sub)
        if not candidates:
            return None
        best = self._select(candidates)
        best.queries = queries
        best.hops = hops
        best.overhead = overhead + queries * self.config.local_query_cost
        return best

    # AskParent (Alg. 1 line 30)
    def _ask_parent(self, task: Task, now: float,
                    origin: "Orchestrator",
                    ctx: Optional[_BatchContext] = None,
                    scored: Optional[set] = None) -> Optional[MapResult]:
        if self.parent is None:
            return None
        parent = self.parent
        results: list[MapResult] = []
        hops = 1                       # message up to the parent
        overhead = self._hop_cost(parent)
        siblings = [s for s in parent.children if s is not self]
        # fuse the sibling scan's constraint checks into one call
        sib_pus = [p for s in siblings for p in s._subtree_pus()]
        pre = (dict(zip(sib_pus, self._check_candidates(task, sib_pus, now,
                                                        ctx=ctx)))
               if sib_pus else None)
        for sibling in siblings:
            hops += 1
            overhead += parent._hop_cost(sibling)
            sub = sibling._traverse_children(task, now, ctx, scored, pre)
            if sub is not None:
                sub.hops += hops
                sub.overhead += overhead
                if parent.config.objective == "first_fit":
                    return sub
                results.append(sub)
        if results:
            return self._select(results)
        # no sibling satisfies: propagate the search further up (DFS)
        return parent._ask_parent(task, now, origin=origin, ctx=ctx,
                                  scored=scored)

    # CheckTaskConstraints (Alg. 1 line 11)
    def _check_constraints(self, task: Task, pu_name: str,
                           now: float) -> tuple[bool, TaskPrediction]:
        return self._check_candidates(task, [pu_name], now)[0]

    def _check_candidates(self, task: Task, pu_names: list[str],
                          now: float, ctx: Optional[_BatchContext] = None,
                          ) -> list[tuple[bool, TaskPrediction]]:
        """CheckTaskConstraints over every candidate PU in one shot."""
        return self._score_candidates(task, pu_names, now,
                                      with_constraints=True, ctx=ctx)

    def _select(self, candidates: list[MapResult]) -> MapResult:
        if self.config.objective == "min_load":
            return min(candidates, key=lambda r: self.ledger.count(r.pu))
        return min(candidates, key=lambda r: r.prediction.total)

    # -- helpers --------------------------------------------------------------
    def _eligibility(self, task: Task, pu_names: list[str], comp,
                     ctx: Optional[_BatchContext]) -> tuple:
        """(compiled index per name, eligibility mask): alive, supported
        by the PU's model, and — for pinned tasks — on the origin device.
        Without a context the model's support is asked per named PU."""
        if ctx is not None:
            idx = ctx.pu_idx(pu_names)
            sup = ctx.supports_mask(task)[idx.clamp(min=0)]
        else:
            g = self.graph
            idx_l = [comp.pu_index.get(p, -1) for p in pu_names]
            idx = i64(idx_l, comp.device)
            sup = torch.as_tensor(
                [i >= 0 and g.nodes[p].model is not None
                 and g.nodes[p].model.supports(task, g.nodes[p])
                 for p, i in zip(pu_names, idx_l)],
                dtype=BOOL, device=comp.device)
        known = idx >= 0
        ki = idx.clamp(min=0)
        elig = known & comp.pu_alive[ki] & sup
        if task.attrs.get("pinned"):
            # device-local peripherals pin a task to its origin
            elig = elig & (comp.pu_dev_ord[ki]
                           == comp.dev_ord.get(task.origin, -1))
        return idx, elig

    def _static_score(self, task: Task, pu_names: list[str], comp,
                      ctx: Optional[_BatchContext],
                      skip_comm: bool = False) -> "_StaticScore":
        """The ledger-independent half of fused scoring: eligibility,
        candidate index/device arrays, standalone predictions, inbound
        communication (with the pinned-return leg), tenancy limits.
        ``skip_comm`` leaves ``comm = None`` for the core-keyed variant
        whose consumers never read it."""
        dev = comp.device
        idx, elig = self._eligibility(task, pu_names, comp, ctx)
        s = _StaticScore()
        s.pu_names = pu_names
        s.cols_l = [c for c, e in enumerate(host_list(elig)) if e]
        s.cols = i64(s.cols_l, dev)
        s.single_dev = None
        if not len(s.cols_l):
            s.cand_idx = s.cand_dev = s.maxten = s.cols
            s.sa = s.comm = torch.zeros(0, dtype=FLOAT, device=dev)
            return s
        s.cand_idx = idx[s.cols]
        s.cand_dev = comp.pu_dev_ord[s.cand_idx]
        # device ordinals of the candidates, from the host mirrors
        dl = comp.pu_dev_ord_l
        pidx = comp.pu_index
        cand_dev_l = [dl[pidx[pu_names[c]]] for c in s.cols_l]
        uniq = sorted(set(cand_dev_l))
        if len(uniq) == 1:
            s.single_dev = comp.dev_ord_names[uniq[0]]
        if ctx is not None:
            s.sa = ctx.standalone(task)[s.cand_idx]
        else:
            g = self.graph
            s.sa = f64([g.nodes[pu_names[c]].predict(task) for c in s.cols_l],
                       dev)
        s.maxten = comp.max_tenancy[s.cand_idx]
        if skip_comm:
            s.comm = None
            return s
        # communication per distinct destination device (+ return leg),
        # from the host route table; one upload of the finished LUT
        ret_bytes = task.attrs.get("succ_pinned_bytes", 0.0)
        comm_lut = np.zeros(len(comp.dev_ord_names))
        uniq_a = np.asarray(uniq, dtype=np.int64)
        if not self._comm_lut_fast(task, comp, uniq_a, ret_bytes, comm_lut):
            if ret_bytes > 0 and task.origin is not None and len(uniq) > 1:
                # the return leg routes *from* each candidate device: warm
                # all those rows in one batched Dijkstra
                comp.ensure_routes([comp.dev_ord_names[o] for o in uniq])
            for o in uniq:
                d = comp.dev_ord_names[o]
                c = (ctx.comm(task, d) if ctx is not None
                     else self.traverser.comm_time_dev(task, d, comp))
                if (ret_bytes > 0 and task.origin is not None
                        and d != task.origin):
                    c += comp.transfer_time(d, task.origin, ret_bytes)
                comm_lut[o] = c
        s.comm = torch.as_tensor(comm_lut[np.asarray(cand_dev_l)], device=dev)
        return s

    def _comm_lut_fast(self, task: Task, comp, uniq: np.ndarray,
                       ret_bytes: float, comm_lut: np.ndarray) -> bool:
        """Fill ``comm_lut`` for the ``uniq`` destination devices straight
        off the compiled route table — elementwise the same
        ``lat + nbytes * ibw`` doubles ``transfer_time`` computes.
        Returns False (LUT untouched) when any endpoint falls outside the
        routable space or a route is missing; the caller's scalar loop
        then reproduces the oracle semantics, including its KeyError."""
        rt = comp._rt
        ri = comp.routable_index
        if len(uniq) < 2:
            return False
        srcs = task.attrs.get("src_devices")
        if not srcs and task.origin is not None:
            srcs = [task.origin]
        srcs = list(srcs or ())
        ib = task.input_bytes
        dev2r = comp.__dict__.get("_dev_routable")
        if dev2r is None:
            dev2r = comp._dev_routable = np.fromiter(
                (ri.get(d, -1) for d in comp.dev_ord_names),
                dtype=np.int64, count=len(comp.dev_ord_names))
        j_arr = dev2r[uniq]
        i_src = [ri.get(d, -1) for d in srcs]
        ret = ret_bytes > 0 and task.origin is not None
        j_org = ri.get(task.origin, -1) if ret else -1
        if not (j_arr >= 0).all() or any(i < 0 for i in i_src) \
                or (ret and j_org < 0):
            return False
        need = set(i_src)
        if ret:
            need.update(int(j) for j in j_arr)
        comp.ensure_routes(need)
        vals = np.zeros(len(uniq))
        if ib > 0:
            for i in i_src:
                leg = rt.lat[i, j_arr] + ib * rt.ibw_row(i)[j_arr]
                leg = np.where(j_arr == i, 0.0, leg)
                if not np.isfinite(leg).all():
                    return False
                np.maximum(vals, leg, out=vals)
        if ret:
            leg = rt.lat[j_arr, j_org] + ret_bytes * rt.ibw_col(j_arr, j_org)
            leg = np.where(j_arr == j_org, 0.0, leg)
            if not np.isfinite(leg).all():
                return False
            vals = vals + leg
        comm_lut[uniq] = vals
        return True

    def _score_candidates(self, task: Task, pu_names: list[str], now: float,
                          *, with_constraints: bool,
                          ctx: Optional[_BatchContext] = None,
                          ) -> list[tuple[bool, TaskPrediction]]:
        """Candidate scoring against the compiled HW-GRAPH, returned as
        per-candidate ``(ok, prediction)`` objects (the object walk and
        the best-effort selection read them on the host).

        Per candidate: standalone prediction, inbound communication (with
        the pinned-return leg), the newcomer's slowdown factor amid the
        device's active tasks, and — with ``with_constraints`` — the
        tenancy queueing wait, the deadline check and Alg. 1 line 15
        (existing tasks keep their constraints).  Noise-free models with
        the block-diagonal check score every candidate in one fused check;
        noisy models and models with only the tuple surface score per
        device (:meth:`_score_grouped`)."""
        comp = ctx.comp if ctx is not None else self.graph.compiled()
        n = len(pu_names)
        infeasible = (False, TaskPrediction(float("inf"), 1.0, 0.0))
        results: list[tuple[bool, TaskPrediction]] = [infeasible] * n
        if not n:
            return results
        sd = self.traverser.slowdown
        noisy = bool(getattr(sd, "_noisy", lambda: False)())
        if (not noisy) and hasattr(sd, "factors_same_device"):
            static = (ctx.static_score(self, task, pu_names)
                      if ctx is not None
                      else self._static_score(task, pu_names, comp, None))
            if len(static.cols_l):
                self._score_fused(task, static, now, results,
                                  with_constraints=with_constraints, ctx=ctx)
        else:
            _, elig = self._eligibility(task, pu_names, comp, ctx)
            cols = [c for c, e in enumerate(host_list(elig)) if e]
            if cols:
                self._score_grouped(task, pu_names, cols, now, results,
                                    with_constraints=with_constraints,
                                    ctx=ctx)
        return results

    def _score_grouped(self, task: Task, pu_names: list[str],
                       cols: list[int], now: float, results: list, *,
                       with_constraints: bool,
                       ctx: Optional[_BatchContext]) -> None:
        """Per-device scoring via the tuple-based slowdown surface
        (``factors_with_candidates``): the path for noisy models, whose
        rng draws must come in the scalar reference's order — one
        ``factor`` per candidate, then per (candidate, active), device by
        device in the order the eligible candidates first name them — and
        for slowdown models without the block-diagonal check.  Each
        device's ledger columns, the candidates' tenancy caps and
        standalones and the factors reach the host in ONE copy; the
        constraint arithmetic then runs there, as in the reference."""
        graph = self.graph
        comp = ctx.comp if ctx is not None else graph.compiled()
        sd = self.traverser.slowdown
        batch = getattr(sd, "factors_with_candidates", None)
        by_dev: dict[str, list[int]] = {}
        for c in cols:
            by_dev.setdefault(
                comp.pu_device[comp.pu_index[pu_names[c]]], []).append(c)
        sa_vec = ctx.standalone(task) if ctx is not None else None
        ret_bytes = task.attrs.get("succ_pinned_bytes", 0.0)
        P = len(comp.pu_names)
        for dev, dcols in by_dev.items():
            names = [pu_names[c] for c in dcols]
            cand_l = [comp.pu_index[nm] for nm in names]
            cand = i64(cand_l, comp.device)
            view = (ctx.view(dev) if ctx is not None
                    else self.ledger.device_view(comp, dev))
            A = len(view)
            C = len(dcols)
            parts = [view.P.to(FLOAT), view.est, view.fac, view.dl,
                     view.rel, view.uid.to(FLOAT),
                     comp.max_tenancy[cand].to(FLOAT)]
            if sa_vec is not None:
                parts.append(sa_vec[cand])
            act_f = None
            if batch is not None:
                new_f_t, act_f_t = batch(task, names, view.pairs())
                parts += [new_f_t.reshape(-1).to(FLOAT),
                          act_f_t.reshape(-1).to(FLOAT)]
            else:
                pairs = view.pairs()
                new_f = [sd.factor(task, p, pairs) for p in names]
            flat = host_numpy(torch.cat(parts))
            cuts = np.cumsum([0, A, A, A, A, A, A, C])
            vP, vest, vfac, vdl, vrel, vuid, maxten = (
                flat[cuts[k]:cuts[k + 1]] for k in range(7))
            vP = vP.astype(np.int64)
            vuid = vuid.astype(np.int64)
            pos = int(cuts[-1])
            sa_l = None
            if sa_vec is not None:
                sa_l = flat[pos:pos + C]
                pos += C
            if batch is not None:
                new_f = flat[pos:pos + C]
                act_f = flat[pos + C:pos + C + C * A].reshape(C, A)
            if ctx is not None:
                comm = ctx.comm(task, dev)
            else:
                comm = self.traverser.comm_time_dev(task, dev, comp)
            if ret_bytes > 0 and task.origin is not None and dev != task.origin:
                comm += comp.transfer_time(dev, task.origin, ret_bytes)
            # tenancy occupancy per candidate PU (live rows only)
            if with_constraints and A:
                cnt = np.bincount(vP, minlength=P)[cand_l]
                minest = np.full(P, np.inf)
                np.minimum.at(minest, vP, vest)
                minest = minest[cand_l]
            else:
                cnt = np.zeros(C, dtype=np.int64)
                minest = np.full(C, np.inf)
            # Alg. 1 l.15: existing tasks keep their constraints
            ok15 = np.ones(C, dtype=bool)
            if with_constraints and A:
                if act_f is not None:
                    rem = np.maximum(0.0, vest - now) / np.maximum(vfac, 1e-12)
                    fin = now + rem[None, :] * act_f
                    viol = fin - vrel[None, :] > vdl[None, :] * (1 + 1e-9)
                    ok15 = ~viol.any(axis=1)
                else:
                    pairs = view.pairs()
                    for c_pos, name in enumerate(names):
                        new_factors = self.traverser.predict_active_with(
                            task, name, pairs)
                        for a in range(A):
                            if not np.isfinite(vdl[a]):
                                continue
                            rem = max(0.0, vest[a] - now) / max(vfac[a], 1e-12)
                            fin = now + rem * new_factors[int(vuid[a])]
                            if fin - vrel[a] > vdl[a] * (1 + 1e-9):
                                ok15[c_pos] = False
                                break
            for c_pos, c in enumerate(dcols):
                name = names[c_pos]
                sa = (sa_l[c_pos] if sa_l is not None
                      else graph.nodes[name].predict(task))
                pred = TaskPrediction(standalone=float(sa),
                                      factor=float(new_f[c_pos]), comm=comm)
                if not with_constraints:
                    results[c] = (True, pred)
                    continue
                # tenancy cap: queueing wait behind the earliest finisher
                if cnt[c_pos] >= maxten[c_pos]:
                    wait = float(minest[c_pos]) - now
                    pred = TaskPrediction(standalone=pred.standalone,
                                          factor=pred.factor,
                                          comm=pred.comm + max(0.0, wait))
                if task.deadline is not None and pred.total > task.deadline:
                    results[c] = (False, pred)
                    continue
                results[c] = (bool(ok15[c_pos]), pred)

    def _score_fused(self, task: Task, static: "_StaticScore", now: float,
                     results: list, *, with_constraints: bool,
                     ctx: Optional[_BatchContext],
                     fused: Optional[tuple] = None) -> None:
        """One-shot scoring of an arbitrary mixed-device candidate set: a
        single block-diagonal check replaces one slowdown/constraint
        evaluation per device; the four columns come back in one copy."""
        ok_a, sa_a, f_a, cm_a = self._score_fused_arrays(
            task, static, now, with_constraints=with_constraints,
            ctx=ctx, fused=fused)
        ok_l, sa_l, f_l, cm_l = host_list(torch.stack(
            [ok_a.to(FLOAT), sa_a, f_a, cm_a]))
        for c, ok, sa, f, cm in zip(static.cols_l, ok_l, sa_l, f_l, cm_l):
            results[c] = (bool(ok), TaskPrediction(sa, f, cm))

    def _score_fused_arrays(self, task: Task, static: "_StaticScore",
                            now: float, *, with_constraints: bool,
                            ctx: Optional[_BatchContext],
                            fused: Optional[tuple] = None,
                            split_comm: bool = False) -> tuple:
        """The array core of :meth:`_score_fused`: per eligible candidate
        (``static.cols`` order) the feasibility, standalone, factor and
        comm columns.

        With ``split_comm`` the comm column is withheld: the last column
        is the additive tenancy wait and ``ok`` excludes the deadline
        mask — the origin-independent core the tracked scan states share
        across task signatures; a fifth value is the instant until which
        those outputs stay exact."""
        comp = ctx.comp if ctx is not None else self.graph.compiled()
        dev = comp.device
        sd = self.traverser.slowdown
        cand_idx = static.cand_idx
        if fused is not None:
            (new_f, ci, ai, act_pf), view = fused
        else:
            # single-device candidate sets (the common local check) read
            # the per-device segment view; mixed-device sets (and checks
            # without a context) read the global view
            if ctx is not None and static.single_dev is not None:
                view = ctx.view(static.single_dev)
            else:
                view = self.ledger.live_view(comp)
            new_f, ci, ai, act_pf = sd.factors_same_device(
                comp, task, cand_idx, static.cand_dev, view.P, view.upu,
                view.Ma, view.uid, view.Da, view.astart, view.na)
        C = len(static.cols_l)
        if with_constraints:
            ok, wait, flags = constraint_terms(
                cand_idx, static.maxten, now, view.P, view.est, view.fac,
                view.dl, view.rel, ci, ai, act_pf, flips=split_comm)
        else:
            ok, wait, flags = torch.ones(C, dtype=BOOL, device=dev), None, None
        expiry = _INF
        if flags is not None:
            expiry = _expiry(now, *host_list(flags))
        if split_comm:
            return ok, static.sa, new_f, (wait if wait is not None
                                          else torch.zeros(
                                              C, dtype=FLOAT, device=dev)
                                          ), expiry
        comm = static.comm if wait is None else static.comm + wait
        if with_constraints and task.deadline is not None:
            totals = comm + static.sa * new_f
            ok = ok & ~(totals > task.deadline)
        return ok, static.sa, new_f, comm

    def _hop_cost(self, other: "Orchestrator") -> float:
        """Round-trip query cost between this ORC's group and another's
        (cached per compiled snapshot)."""
        comp = self.graph.compiled()
        cache = self._hop_cache
        if cache is None or cache[0] is not comp:
            cache = self._hop_cache = (comp, {})
        cost = cache[1].get(id(other))
        if cost is None:
            try:
                one_way = comp.transfer_time(self.group, other.group,
                                             QUERY_BYTES)
            except KeyError:
                one_way = 0.0
            cost = cache[1][id(other)] = 2.0 * one_way
        return cost

    def _best_effort(self, task: Task, now: float,
                     ctx: Optional[_BatchContext] = None,
                     scored: Optional[set] = None) -> Optional[MapResult]:
        """Nothing satisfies the deadline anywhere: pick the globally least-bad
        PU so the system degrades instead of dropping work (QoS failure is
        recorded by the evaluation layer)."""
        root = self
        while root.parent is not None:
            root = root.parent
        best: Optional[MapResult] = None
        all_pus = root._subtree_pus()
        scores = self._score_candidates(task, all_pus, now,
                                        with_constraints=False, ctx=ctx)
        pre = dict(zip(all_pus, scores))
        for orc in root.iter_tree():
            if not orc.leaf_pus:
                continue
            if scored is not None:
                scored.add(orc.group)
            for pu_name in orc.leaf_pus:
                ok, pred = pre[pu_name]
                if not ok:
                    continue
                if best is None or pred.total < best.prediction.total:
                    best = MapResult(pu=pu_name, prediction=pred)
        return best

    def iter_tree(self):
        yield self
        for c in self.children:
            yield from c.iter_tree()

    def find_device_orc(self, device: str) -> Optional["Orchestrator"]:
        for orc in self.iter_tree():
            if orc.group == device:
                return orc
        return None


def build_orchestrators(graph: HWGraph, traverser: Traverser,
                        ledger: Optional[ActiveLedger] = None,
                        config: Optional[OrcConfig] = None,
                        max_fanout: Optional[int] = None,
                        cls: type = None) -> Orchestrator:
    """Build the ORC tree from GROUP nodes tagged with attrs['orc_level'].

    Levels: 'root' (exactly one), 'cluster' (virtual groupings), 'device'
    (manages every PU in its subtree).  Matches Fig. 4b.  The ledger (and
    everything else the tree computes with) lives on the graph's device.

    ``max_fanout``: the paper's scalability device (§3.5) — when a cluster
    ORC ends up with more than max_fanout children, intermediate virtual
    ORCs are inserted so every node's fanout stays bounded and a MapTask
    escalation touches O(log n) ORCs instead of O(n) siblings.

    ``cls``: Orchestrator subclass to instantiate.
    """
    cls = cls or Orchestrator
    ledger = ledger if ledger is not None else ActiveLedger(graph.device)
    config = config or OrcConfig()
    roots = [n for n in graph.nodes.values()
             if n.attrs.get("orc_level") == "root"]
    if len(roots) != 1:
        raise ValueError(f"expected exactly one root group, got {len(roots)}")
    root = cls(graph, roots[0].name, traverser, ledger, config)

    def attach(parent_orc: Orchestrator, group_name: str) -> None:
        for child in graph.children_of(group_name):
            lvl = child.attrs.get("orc_level")
            if lvl == "cluster":
                orc = parent_orc.add_child(
                    cls(graph, child.name, traverser, ledger, config))
                attach(orc, child.name)
            elif lvl == "device":
                orc = parent_orc.add_child(
                    cls(graph, child.name, traverser, ledger, config))
                orc.leaf_pus = [p.name for p in graph.pus(under=child.name)]
            elif child.kind.name == "GROUP":
                attach(parent_orc, child.name)

    attach(root, roots[0].name)
    if max_fanout is not None and max_fanout >= 2:
        for orc in list(root.iter_tree()):
            _bound_fanout(orc, max_fanout)
    return root


def _bound_fanout(orc: Orchestrator, k: int) -> None:
    """Insert virtual intermediate ORCs under ``orc`` until every node in
    its subtree has at most k children (device ORCs are leaves)."""
    level = 0
    while len(orc.children) > k:
        groups: list[Orchestrator] = []
        kids = orc.children
        for i in range(0, len(kids), k):
            chunk = kids[i:i + k]
            if len(chunk) == 1:
                groups.append(chunk[0])
                continue
            virt = Orchestrator(orc.graph, f"{orc.group}.virt{level}_{i // k}",
                                orc.traverser, orc.ledger, orc.config)
            virt.parent = orc
            for c in chunk:
                c.parent = virt
                virt.children.append(c)
            groups.append(virt)
        orc.children = groups
        level += 1
