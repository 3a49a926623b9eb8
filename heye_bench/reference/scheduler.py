"""H-EYE's mapping (Alg. 1) and its online admission, in plain Python.

The model, as the paper sets it out (sections 3.4-3.5):

* a task's slowdown on a PU is ``(1 + mt) * prod_r (1 + p_r * m)``: ``mt``
  the multi-tenancy pressure of the other tasks on the same PU, ``p_r``
  the pressure on each shared resource class ``r`` from tasks on the
  other PUs of the device whose nearest common resource is of that
  class, ``m`` the task's own memory usage; a pressure term is
  ``beta * x * (1 + kappa * x)``;
* a PU passes the constraint check when the task is supported there,
  its communication, tenancy wait and slowed standalone time meet the
  deadline, and every task already on that device still meets its own
  (Alg. 1 line 15);
* the walk starts at the task's origin device, escalates to sibling
  devices, then to the other clusters, and falls back to the globally
  least-bad PU; each step picks the least predicted total, the first in
  scan order on a tie.  A placement charges ``queries x 5 us`` of
  scheduling overhead to the task's release.

Every float can be rounded through ``rnd`` (float64 by default; float32
for the control that must fail the comparison).
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from .fleet import Fleet, Task, nearest_shared

RCLASSES = ("l2", "l3", "llc", "sram", "dram", "hbm", "vmem", "nic")
BETA = {"l2": 0.0884, "l3": 0.1330, "llc": 0.1107, "sram": 0.1786,
        "dram": 0.4196, "hbm": 0.2679, "vmem": 0.0, "nic": 0.0893}
MT_BETA = {"cpu": 0.3125, "gpu": 0.4598, "dla": 0.3571, "vic": 0.2232,
           "pva": 0.2679, "tpu": 0.4018}
KAPPA = 0.12
NOISE = 0.035
LOCAL_QUERY_COST = 5e-6


def f64(x: float) -> float:
    return x


def f32(x: float) -> float:
    return float(np.float32(x))


def pterm(beta: float, x: float) -> float:
    if x <= 0.0 or beta <= 0.0:
        return 0.0
    return beta * x * (1.0 + KAPPA * x)


class Model:
    """The fleet's static tables: per task kind the standalone seconds on
    every PU (nan where unsupported) and the resource class each pair of
    PUs on one device meets at."""

    def __init__(self, fl: Fleet, rnd: Callable = f64) -> None:
        self.fl = fl
        self.rnd = rnd
        self._sa: dict = {}
        self._ncr: dict = {}
        self._comm: dict = {}
        self.cap = [p.mem_cap for p in fl.pus]

    def sa(self, kind: str) -> np.ndarray:
        arr = self._sa.get(kind)
        if arr is None:
            vals = []
            for pu in range(len(self.fl.pus)):
                s = self.fl.standalone_s(kind, pu)
                vals.append(np.nan if s is None else self.rnd(s))
            arr = self._sa[kind] = np.array(vals)
        return arr

    def ncr(self, a: int, b: int) -> Optional[str]:
        key = (a, b)
        if key not in self._ncr:
            self._ncr[key] = nearest_shared(self.fl, a, b)
        return self._ncr[key]

    def mem(self, t: Task, pu: int) -> float:
        return min(t.u_mem, self.cap[pu])

    def factor(self, t: Task, pu: int, others) -> float:
        """Slowdown of ``t`` on ``pu`` amid ``others`` ((task, pu) pairs
        on the same device, in ledger order)."""
        mt = 0.0
        x = dict.fromkeys(RCLASSES, 0.0)
        for o, opu in others:
            if o.uid == t.uid:
                continue
            if opu == pu:
                mt += o.u_pu
            else:
                rc = self.ncr(pu, opu)
                if rc is not None:
                    x[rc] += self.mem(o, opu)
        m = self.mem(t, pu)
        f = 1.0 + pterm(MT_BETA[self.fl.pus[pu].klass], mt) * t.u_pu
        for rc in RCLASSES:
            f *= 1.0 + pterm(BETA[rc], x[rc]) * m
        return self.rnd(max(1.0, f))

    def comm(self, t: Task, srcs: list, dst: int) -> float:
        """Inbound transfer time onto device ``dst`` from the producers'
        devices (the origin when there are none), plus the return leg
        when the successor is pinned to the origin."""
        key = (tuple(srcs), t.input_bytes, t.succ_pinned_bytes, t.origin,
               dst)
        c = self._comm.get(key)
        if c is None:
            fl = self.fl
            c = 0.0
            if t.input_bytes > 0:
                for s in srcs:
                    if s != dst:
                        c = max(c, fl.transfer_time(s, dst, t.input_bytes))
            if t.succ_pinned_bytes > 0 and dst != t.origin:
                c += fl.transfer_time(dst, t.origin, t.succ_pinned_bytes)
            c = self._comm[key] = self.rnd(c)
        return c


@dataclass
class Entry:
    task: Task
    pu: int
    est: float          # predicted finish
    fac: float          # predicted slowdown at placement


class Ledger:
    """The orchestrator's belief of what runs where: one row per placed
    task, kept per device in placement order."""

    def __init__(self, fl: Fleet) -> None:
        self.by_dev: dict = {}
        self.dev_of = [p.device for p in fl.pus]

    def add(self, t: Task, pu: int, est: float, fac: float) -> None:
        self.by_dev.setdefault(self.dev_of[pu], []).append(
            Entry(t, pu, est, fac))

    def _drop(self, keep) -> None:
        for d in list(self.by_dev):
            rows = [e for e in self.by_dev[d] if keep(e)]
            if rows:
                self.by_dev[d] = rows
            else:
                del self.by_dev[d]

    def prune(self, now: float) -> None:
        self._drop(lambda e: e.est > now)

    def remove(self, uids: set) -> None:
        if uids:
            self._drop(lambda e: e.task.uid not in uids)


@dataclass
class Result:
    pu: int
    sa: float
    f: float
    comm: float
    queries: int = 0
    overhead: float = 0.0

    @property
    def total(self) -> float:
        return self.comm + self.sa * self.f


class Walker:
    """Alg. 1 over the fleet's orchestrator tree: the root, the fleet's
    clusters in the order of the program's root children, a device
    orchestrator per device."""

    def __init__(self, model: Model, ledger: Ledger) -> None:
        self.m = model
        self.led = ledger
        self.clusters = [list(c) for c in model.fl.clusters]
        self.cluster_of = {}
        for c, devs in enumerate(self.clusters):
            for d in devs:
                self.cluster_of[d] = c
        self.order = [d for devs in self.clusters for d in devs]

    # -- the constraint check -------------------------------------------
    def check(self, t: Task, srcs: list, d: int, now: float,
              constrained: bool = True) -> list:
        """(pu, ok, Result) for each PU of device ``d``, in scan order."""
        m, rnd = self.m, self.m.rnd
        sa_k = m.sa(t.kind)
        dev = m.fl.devices[d]
        rows = self.led.by_dev.get(d, ())
        pairs = [(e.task, e.pu) for e in rows]
        comm0 = m.comm(t, srcs, d)
        out = []
        for pu in dev.pus:
            sa = sa_k[pu]
            if math.isnan(sa) or (t.pinned and d != t.origin):
                out.append((pu, False, None))
                continue
            f = m.factor(t, pu, pairs) if rows else 1.0
            comm = comm0
            ok = True
            if constrained and rows:
                on = [e.est for e in rows if e.pu == pu]
                if len(on) >= m.fl.pus[pu].max_tenancy:
                    comm = rnd(comm + max(0.0, min(on) - now))
                for e in rows:
                    a = e.task
                    if a.deadline is None:
                        continue
                    pool = [(o, opu) for o, opu in pairs if o is not a]
                    pool.append((t, pu))
                    pf = m.factor(a, e.pu, pool)
                    rem = max(0.0, e.est - now) / max(e.fac, 1e-12)
                    fin = rnd(now + rem * pf)
                    if fin - a.release > a.deadline * (1 + 1e-9):
                        ok = False
                        break
            r = Result(pu, sa, f, comm)
            if constrained and t.deadline is not None \
                    and rnd(r.total) > t.deadline:
                ok = False
            out.append((pu, ok, r))
        return out

    def device_best(self, t, srcs, d, now) -> Optional[Result]:
        best = None
        checks = self.check(t, srcs, d, now)
        for pu, ok, r in checks:
            if ok and (best is None or r.total < best.total):
                best = r
        if best is None:
            return None
        best.queries = len(checks)
        best.overhead = 0.0 + best.queries * LOCAL_QUERY_COST
        return best

    def cluster_best(self, t, srcs, c, now) -> Optional[Result]:
        best, queries, overhead = None, 0, 0.0
        for d in self.clusters[c]:
            sub = self.device_best(t, srcs, d, now)
            if sub is None:
                continue
            queries += sub.queries
            overhead += sub.overhead
            if best is None or sub.total < best.total:
                best = sub
        if best is None:
            return None
        best.queries = queries
        best.overhead = overhead + queries * LOCAL_QUERY_COST
        return best

    def map(self, t: Task, srcs: list, now: float) -> Result:
        d0 = t.origin
        res = self.device_best(t, srcs, d0, now)
        if res is None:
            c0 = self.cluster_of[d0]
            for d in self.clusters[c0]:
                if d == d0:
                    continue
                sub = self.device_best(t, srcs, d, now)
                if sub is not None and (res is None or sub.total < res.total):
                    res = sub
        if res is None:
            for c in range(len(self.clusters)):
                if c == self.cluster_of[d0]:
                    continue
                sub = self.cluster_best(t, srcs, c, now)
                if sub is not None and (res is None or sub.total < res.total):
                    res = sub
        if res is None:
            res = self.best_effort(t, srcs, now)
        return res

    def best_effort(self, t, srcs, now) -> Result:
        best = None
        for d in self.order:
            for pu, ok, r in self.check(t, srcs, d, now, constrained=False):
                if ok and (best is None or r.total < best.total):
                    best = r
        if best is None:
            raise RuntimeError(f"no PU supports {t.kind}")
        return best


# ---------------------------------------------------------------------------
# the offline session: dependency-frontier waves, then the ground truth
# ---------------------------------------------------------------------------
def map_session(walker: Walker, tasks: list) -> dict:
    """Map every task wave by wave (dependency-ready tasks sharing the
    earliest release, in (release, uid) order); charge each placement's
    overhead to its task's release.  Returns uid -> Result."""
    by_uid = {t.uid: t for t in tasks}
    fl = walker.m.fl
    rnd = walker.m.rnd
    placed: dict = {}
    remaining = sorted(tasks, key=lambda t: (t.release, t.uid))
    while remaining:
        ready = [t for t in remaining if all(p in placed for p in t.preds)]
        r0 = ready[0].release
        wave = [t for t in ready if t.release == r0]
        walker.led.prune(r0)
        for t in wave:
            srcs = sorted({fl.pus[placed[p].pu].device for p in t.preds},
                          key=lambda d: fl.devices[d].name)
            res = walker.map(t, srcs or [t.origin], r0)
            walker.led.add(t, res.pu, rnd(r0 + res.total), res.f)
            placed[t.uid] = res
            if res.overhead:
                t.release = rnd(t.release + res.overhead)
        done = {t.uid for t in wave}
        remaining = [t for t in remaining if t.uid not in done]
    assert set(placed) == set(by_uid)
    return placed


# ---------------------------------------------------------------------------
# the online loop: admission waves over open-loop arrivals
# ---------------------------------------------------------------------------
@dataclass
class Request:
    rid: int
    tenant: str
    arrival: float
    tasks: list
    defers: int = 0
    verdict: str = "pending"
    reason: str = ""
    results: list = field(default_factory=list)


def serve(walker: Walker, tenants: list, admission: dict, truth) -> list:
    """Replay the serving loop with per-arrival admission.  ``tenants``
    holds (name, arrival times, make(k, t) -> the request's tasks);
    ``truth`` is the resident ground truth (``des.Truth``): before each
    admission instant it runs through every earlier timestamp and the
    ledger retires what it finished.  Every task of a wave is mapped, in
    uid order, before any request of it is judged; a request is accepted
    when each of its tasks is projected within ``slack`` times its
    deadline, and its tasks are injected into the truth.  Returns the
    requests in arrival order."""
    rnd = walker.m.rnd
    slack = admission["slack"]
    delay = admission["defer_delay"]
    max_defers = admission["max_defers"]
    n = len(tenants)
    events = []
    for ti, (_, times, _) in enumerate(tenants):
        for k, t in enumerate(times.tolist()):
            events.append((t, 0, k * n + ti, ti))
    heapq.heapify(events)
    requests = []
    while events:
        t0 = events[0][0]
        wave = []
        while events and events[0][0] <= t0:
            t, kind, rid, payload = heapq.heappop(events)
            if kind == 0:
                name, _, make = tenants[payload]
                req = Request(rid, name, t, make(rid // n, t))
                requests.append(req)
            else:
                req = payload
            wave.append(req)
        walker.led.remove(set(truth.advance(t0)))
        walker.led.prune(t0)
        placed = {}
        for task in sorted((t for r in wave for t in r.tasks),
                           key=lambda t: t.uid):
            res = walker.map(task, [task.origin], t0)
            walker.led.add(task, res.pu, rnd(t0 + res.total), res.f)
            placed[task.uid] = res
            if res.overhead:
                task.release = rnd(task.release + res.overhead)
        for req in wave:
            req.results = [placed[t.uid] for t in req.tasks]
            if all(t.deadline is None or not r.total > t.deadline * slack
                   for t, r in zip(req.tasks, req.results)):
                req.verdict = "accepted"
                truth.inject(req.tasks, {t.uid: r.pu for t, r in
                                         zip(req.tasks, req.results)})
                continue
            walker.led.remove({t.uid for t in req.tasks})
            if delay > 0.0 and req.defers < max_defers:
                req.defers += 1
                for t in req.tasks:
                    t.release = t0 + delay
                heapq.heappush(events, (t0 + delay, 1, req.rid, req))
            else:
                req.verdict = "rejected"
                req.reason = "projected_sla"
    truth.advance()
    return requests
