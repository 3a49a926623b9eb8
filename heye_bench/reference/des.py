"""The ground truth in plain Python: a per-job event loop over contention
intervals (paper section 3.4, Fig. 6).

Within an interval each task on a device progresses at ``1 / factor`` of
its standalone speed, the factor being the slowdown model's for the
tasks then running on that device; a transfer moves at the narrowest
fair share of its route's links.  All events of one timestamp drain
before the devices and links they touched are repriced.  Each job's work
is its standalone time times ``exp(N(0, noise * irregularity))``, drawn
from the run's generator when the job starts, in event order.  Tasks may
be injected between advances (the online loop's resident timeline).
"""
from __future__ import annotations

import heapq
import itertools
import math
from collections import defaultdict, deque

import numpy as np

from .fleet import Fleet, Task
from .scheduler import NOISE, Model


class Truth:
    """The event loop's state; ``inject`` tasks placed by a mapping,
    ``advance`` through every timestamp before a given instant."""

    def __init__(self, model: Model, rng: np.random.Generator) -> None:
        self.m = model
        self.fl: Fleet = model.fl
        self.rng = rng
        self.rnd = model.rnd
        self.by_uid: dict = {}
        self.pu_of: dict = {}
        self.heap: list = []
        self.seq = itertools.count()
        self.now = 0.0
        self.compute: dict = {}       # uid -> [W, rate, t_last, version, pu]
        self.dev_members = defaultdict(set)
        self.transfers: dict = {}     # key -> [W, rate, t_last, ver, links, uid]
        self.xseq = itertools.count()
        self.link_members = defaultdict(set)
        self.pu_running = defaultdict(int)
        self.pu_queue = defaultdict(deque)
        self.waiting: dict = {}
        self.finish: dict = {}
        self.dirty_devs: set = set()
        self.dirty_links: set = set()

    # -- rates ---------------------------------------------------------------
    def _push(self, t: float, kind: str, payload) -> None:
        heapq.heappush(self.heap, (t, next(self.seq), kind, payload))

    def _settle(self, job: list) -> None:
        job[0] = self.rnd(max(0.0, job[0] - job[1] * (self.now - job[2])))
        job[2] = self.now

    def _reprice_device(self, d: int) -> None:
        members = sorted(self.dev_members[d])
        pool = [(self.by_uid[u], self.compute[u][4]) for u in members]
        for u in members:
            job = self.compute[u]
            f = self.m.factor(self.by_uid[u], job[4], pool)
            self._settle(job)
            job[1] = self.rnd(1.0 / f)
            job[3] += 1
            self._push(self.now + job[0] / job[1], "cdone", (u, job[3]))

    def _reprice_links(self) -> None:
        affected = set()
        for k in self.dirty_links:
            affected |= self.link_members[k]
        for key in sorted(affected):
            x = self.transfers[key]
            self._settle(x)
            x[1] = self.rnd(min(self.fl.links[k][0]
                                / max(1, len(self.link_members[k]))
                                for k in x[4]))
            x[3] += 1
            self._push(self.now + x[0] / x[1], "xdone", (key, x[3]))

    def _flush(self) -> None:
        for d in sorted(self.dirty_devs,
                        key=lambda d: self.fl.devices[d].name):
            self._reprice_device(d)
        self.dirty_devs.clear()
        if self.dirty_links:
            self._reprice_links()
            self.dirty_links.clear()

    # -- jobs ----------------------------------------------------------------
    def _start(self, t: Task) -> None:
        pu = self.pu_of[t.uid]
        if self.pu_running[pu] >= self.fl.pus[pu].max_tenancy:
            self.pu_queue[pu].append(t)
            return
        self.pu_running[pu] += 1
        sa = float(self.m.sa(t.kind)[pu])
        work = self.rnd(sa * float(np.exp(self.rng.normal(
            0.0, NOISE * t.irregularity))))
        self.compute[t.uid] = [work, 1.0, self.now, 0, pu]
        d = self.fl.pus[pu].device
        self.dev_members[d].add(t.uid)
        self.dirty_devs.add(d)

    def _launch(self, uid: int, src: int, dst: int, nbytes: float) -> bool:
        if src == dst or nbytes <= 0:
            return False
        links = self.fl.route(src, dst)
        key = next(self.xseq)
        self.transfers[key] = [nbytes, 1.0, self.now, 0, links, uid]
        for k in links:
            self.link_members[k].add(key)
            self.dirty_links.add(k)
        return True

    def _arrived(self, uid: int) -> None:
        self.waiting[uid] -= 1
        if self.waiting[uid] == 0:
            self._start(self.by_uid[uid])

    def _done(self, uid: int) -> None:
        job = self.compute.pop(uid)
        pu = job[4]
        d = self.fl.pus[pu].device
        self.dev_members[d].discard(uid)
        self.pu_running[pu] -= 1
        self.finish[uid] = self.now
        t = self.by_uid[uid]
        for s in t.succs:
            dst = self.fl.pus[self.pu_of[s]].device
            if not self._launch(s, d, dst, t.output_bytes):
                self._arrived(s)
        q = self.pu_queue[pu]
        if q:
            self._start(q.popleft())
        self.dirty_devs.add(d)

    def _event(self, kind: str, payload) -> None:
        if kind == "cdone":
            uid, ver = payload
            job = self.compute.get(uid)
            if job is None or job[3] != ver:
                return
            self._settle(job)
            if job[0] <= 1e-15:
                self._done(uid)
        elif kind == "xdone":
            key, ver = payload
            x = self.transfers.get(key)
            if x is None or x[3] != ver:
                return
            self._settle(x)
            if x[0] > 1e-6:
                return
            self.transfers.pop(key)
            lat = 0
            for k in x[4]:
                self.link_members[k].discard(key)
                self.dirty_links.add(k)
                lat += self.fl.links[k][1]
            if lat > 0:
                self._push(self.now + lat, "arrive", x[5])
            else:
                self._arrived(x[5])
        elif kind == "arrive":
            self._arrived(payload)
        else:
            t = self.by_uid[payload]
            dst = self.fl.pus[self.pu_of[payload]].device
            if not (t.input_bytes > 0 and not t.preds
                    and self._launch(payload, t.origin, dst, t.input_bytes)):
                self._arrived(payload)

    # -- the surface ---------------------------------------------------------
    def inject(self, tasks: list, mapping: dict) -> None:
        """Tasks placed by ``mapping`` (uid -> PU index), released at each
        task's ``release`` (never before the clock)."""
        for t in tasks:
            self.by_uid[t.uid] = t
            self.pu_of[t.uid] = mapping[t.uid]
            self.waiting[t.uid] = len(t.preds) + 1
        for t in tasks:
            self._push(t.release, "release", t.uid)

    def advance(self, until: float = math.inf) -> list:
        """Drain every timestamp before ``until``; returns the uids that
        finished meanwhile, in order."""
        done0 = len(self.finish)
        heap = self.heap
        while heap and heap[0][0] < until:
            self.now = max(self.now, heap[0][0])
            while heap and heap[0][0] <= self.now:
                _, _, kind, payload = heapq.heappop(heap)
                self._event(kind, payload)
            self._flush()
        return list(self.finish)[done0:]


def simulate(model: Model, tasks: list, mapping: dict,
             rng: np.random.Generator) -> dict:
    """Finish time per uid of ``tasks`` placed by ``mapping`` (uid -> PU
    index), released at each task's ``release``."""
    truth = Truth(model, rng)
    truth.inject(tasks, mapping)
    truth.advance()
    if len(truth.finish) != len(tasks):
        raise RuntimeError("the ground truth deadlocked")
    return truth.finish
