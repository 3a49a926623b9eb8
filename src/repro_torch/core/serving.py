"""Online serving continuum: co-simulated mapping + execution.

The offline path runs H-EYE's two halves as separate passes: a
``SchedulerSession`` maps everything, then a fresh ``TimelineEngine``
executes the frozen mapping.  The paper's orchestrator is pitched for
*live* edge-cloud continua — tasks arrive continuously and must be mapped
against resources whose load changes under them.

``ServeLoop`` closes that gap on the **session-resident timeline**
(``SchedulerSession.open_timeline``).  Each admission wave:

1. advances the live DES to just *before* the arrival instant (so
   releases enter the event heap ahead of the clock — arrival-coincident
   completions then drain in the same order the one-shot engine would
   use, which keeps online == offline at 1e-9 when every request is
   admitted);
2. reconciles the orchestrator's belief ledger with *actual* completions
   from ``drain_finished`` (``ActiveLedger.retire``);
3. maps the wave through the session — ``Orchestrator.map_batch``
   feasibility against current occupancy, Fig. 14 overhead charging;
4. runs the admission controller (accept / reject / defer per tenant
   against SLA deadlines, ``serve/admission.py``); rejected work is
   withdrawn (ledger + overhead reverted), accepted work is injected
   into the running job tables.

Host and device: the event heap, the request records and the admission
verdicts are the control plane and stay on the host; the job tables, the
ledger columns and the walk's reductions live on the graph's device, so
a CUDA graph drives the same kernels as ``SchedulerSession.run``.

Traffic comes from **open-loop arrival processes** — seeded Poisson and
diurnal (raised-cosine) rate curves drawn in vectorized blocks from an
explicit, seeded ``numpy.random.Generator``, so a serving run replays
exactly — and from **closed-loop client populations**.

``ServeStats`` reports the serving-side metrics the paper's mean-latency
figures omit: p50/p99/p999 request latency, per-tenant SLA attainment,
offered/served request rates, and rejected/deferred counts.  The
percentile definitions are shared with the offline ``RunStats``
(``session.percentiles``).
"""
from __future__ import annotations

import heapq
import time as _time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np

from .. import spans
from ..serve.admission import (AdaptiveWindow, AdmissionController, Decision,
                               Verdict)
from ..spans import OPEN as _SPANS
from .hwgraph import HWGraph
from .orchestrator import Orchestrator
from .session import Policy, SchedulerSession, percentiles
from .task import Task, TaskGraph
from .traverser import Traverser


# ---------------------------------------------------------------------------
# open-loop arrival processes (seeded, deterministic, batched draws)
# ---------------------------------------------------------------------------
class PoissonArrivals:
    """Homogeneous Poisson stream at ``rate`` requests/second.

    Deterministic per ``(rate, seed)``: every ``times`` call re-seeds a
    fresh generator, so two loops over the same spec see byte-identical
    streams.  Inter-arrival gaps are drawn in vectorized blocks of
    ``batch`` (one ``rng.exponential`` + cumsum per block), so
    fleet-scale rates cost microseconds per thousand arrivals instead of
    a Python loop per request.
    """

    def __init__(self, rate: float, seed: int = 0,
                 batch: int = 4096) -> None:
        if rate <= 0:
            raise ValueError(f"rate must be positive, got {rate}")
        self.rate = float(rate)
        self.seed = int(seed)
        self.batch = int(batch)

    def times(self, horizon: float) -> np.ndarray:
        """All arrival instants in ``[0, horizon)``, sorted ascending."""
        rng = np.random.default_rng(self.seed)
        out = []
        t = 0.0
        while t < horizon:
            ts = t + np.cumsum(rng.exponential(1.0 / self.rate, self.batch))
            out.append(ts)
            t = float(ts[-1])
        arr = np.concatenate(out)
        return arr[arr < horizon]


class DiurnalArrivals:
    """Nonhomogeneous Poisson with a raised-cosine diurnal rate curve.

    ``rate(t) = base + (peak - base) * 0.5 * (1 - cos(2 pi (t/period +
    phase)))`` — the load trough sits at ``t = -phase * period`` and the
    peak half a period later.  Sampled by thinning against the peak rate
    (Lewis & Shedler), in the same vectorized blocks as
    :class:`PoissonArrivals`, and equally deterministic per seed.
    """

    def __init__(self, base_rate: float, peak_rate: float,
                 period: float = 86_400.0, seed: int = 0,
                 phase: float = 0.0, batch: int = 4096) -> None:
        if not 0 < base_rate <= peak_rate:
            raise ValueError(
                f"need 0 < base_rate <= peak_rate, got {base_rate}, "
                f"{peak_rate}")
        self.base_rate = float(base_rate)
        self.peak_rate = float(peak_rate)
        self.period = float(period)
        self.seed = int(seed)
        self.phase = float(phase)
        self.batch = int(batch)

    def rate(self, t) -> np.ndarray:
        swing = 0.5 * (1.0 - np.cos(2.0 * np.pi
                                    * (np.asarray(t) / self.period
                                       + self.phase)))
        return self.base_rate + (self.peak_rate - self.base_rate) * swing

    def times(self, horizon: float) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        kept = []
        t = 0.0
        while t < horizon:
            gaps = rng.exponential(1.0 / self.peak_rate, self.batch)
            cand = t + np.cumsum(gaps)
            u = rng.random(self.batch)          # one thinning draw per
            keep = u < self.rate(cand) / self.peak_rate    # candidate
            kept.append(cand[keep])
            t = float(cand[-1])
        arr = np.concatenate(kept)
        return arr[arr < horizon]


class ClosedLoopClients:
    """Closed-loop population of ``clients`` users: each client issues one request, waits for its
    completion (or terminal rejection), *thinks* for an exponential
    ``think_mean`` interval, then issues the next — so offered load
    self-regulates with system latency instead of piling up open-loop.

    Deterministic per ``(clients, think_mean, seed)``: every client owns
    its own ``default_rng([seed, k])`` substream, consumed in that
    client's request order (which a seeded serving run fixes), and
    :meth:`initial_arrivals` re-seeds all substreams — two loops over the
    same spec replay byte-identically.
    """

    def __init__(self, clients: int, think_mean: float,
                 seed: int = 0) -> None:
        if clients <= 0:
            raise ValueError(f"clients must be positive, got {clients}")
        if think_mean <= 0:
            raise ValueError(
                f"think_mean must be positive, got {think_mean}")
        self.clients = int(clients)
        self.think_mean = float(think_mean)
        self.seed = int(seed)
        self._rngs: list = []

    def initial_arrivals(self, horizon: float) -> list[tuple[float, int]]:
        """``(t, client)`` first-request instants in ``[0, horizon)``, at
        most one per client (an initial think delay desynchronizes the
        population).  Resets every client substream."""
        self._rngs = [np.random.default_rng([self.seed, k])
                      for k in range(self.clients)]
        out = []
        for k, rng in enumerate(self._rngs):
            t = float(rng.exponential(self.think_mean))
            if t < horizon:
                out.append((t, k))
        return out

    def think(self, client: int) -> float:
        """Next think-time draw from ``client``'s substream."""
        return float(self._rngs[client].exponential(self.think_mean))


ArrivalProcess = Union[PoissonArrivals, DiurnalArrivals, ClosedLoopClients]


# ---------------------------------------------------------------------------
# tenants and requests
# ---------------------------------------------------------------------------
@dataclass
class TenantSpec:
    """One tenant's traffic contract.

    ``make_request(rid, t)`` builds the request's TaskGraph with release
    times at ``t`` (tasks inherit ``attrs["tenant"]``/``["request"]``
    stamps from the loop).  ``sla`` is informational default plumbing:
    per-task deadlines on the built tasks are what admission checks.
    """

    name: str
    arrivals: ArrivalProcess
    make_request: Callable[[int, float], TaskGraph]
    sla: Optional[float] = None
    max_inflight: Optional[int] = None


def single_task_request(kind: str, origin: str,
                        sla: Optional[float] = None,
                        **task_kw: Any) -> Callable[[int, float], TaskGraph]:
    """Factory for one-task requests (the mining-reading shape): returns
    a ``make_request`` callable for :class:`TenantSpec`."""
    from .topology import make_task

    def make(rid: int, t: float) -> TaskGraph:
        g = TaskGraph(f"{kind}#{rid}")
        g.add(make_task(kind, origin=origin, deadline=sla,
                        release_time=t, **task_kw))
        return g

    return make


@dataclass
class ServeRequest:
    """One request's lifecycle record."""

    tenant: str
    rid: int
    arrival: float                 # first arrival (defer wait counts
    graph: TaskGraph               # toward latency)
    tasks: list[Task]
    sla: Optional[float] = None
    max_inflight: Optional[int] = None
    defers: int = 0
    verdict: str = "pending"       # pending | accepted | rejected
    reject_reason: str = ""
    remaining: int = 0             # unfinished tasks (accepted requests)
    finish: float = float("nan")
    client: int = -1               # closed-loop client ordinal (-1: open)

    @property
    def latency(self) -> float:
        """Arrival-to-last-task-finish (nan until complete)."""
        return self.finish - self.arrival

    def met_sla(self) -> bool:
        if self.sla is None:
            return True
        return self.latency <= self.sla * (1 + 1e-9)


# ---------------------------------------------------------------------------
# the serving report
# ---------------------------------------------------------------------------
@dataclass
class ServeStats:
    """Tail-latency serving report (simulated-time rates + wall-clock)."""

    requests: list[ServeRequest]
    horizon: float
    wall_s: float
    n_events: int = 0
    mapped_tasks: int = 0
    engine_opens: int = 0          # full TimelineEngine builds (target: 1)
    deferrals: int = 0
    # wall seconds per loop phase (advance / sync / map / admit) and the
    # admission-wave sizes, in wave order — where the serving wall went
    phase_wall: dict[str, float] = field(default_factory=dict)
    wave_sizes: list[int] = field(default_factory=list)

    def wave_size_hist(self) -> dict[int, int]:
        """Histogram of admission-wave sizes (size -> wave count)."""
        out: dict[int, int] = {}
        for n in self.wave_sizes:
            out[n] = out.get(n, 0) + 1
        return out

    # -- request partitions -------------------------------------------------
    @property
    def accepted(self) -> list[ServeRequest]:
        return [r for r in self.requests if r.verdict == "accepted"]

    @property
    def rejected(self) -> list[ServeRequest]:
        return [r for r in self.requests if r.verdict == "rejected"]

    def reject_reasons(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for r in self.rejected:
            out[r.reject_reason] = out.get(r.reject_reason, 0) + 1
        return out

    # -- latency tails ------------------------------------------------------
    def latencies(self) -> list[float]:
        return [r.latency for r in self.accepted if r.finish == r.finish]

    def latency_percentiles(self, qs: Sequence[float] = (50.0, 99.0, 99.9),
                            ) -> dict[float, float]:
        return percentiles(self.latencies(), qs)

    def latency_percentiles_by_tenant(
            self, qs: Sequence[float] = (50.0, 99.0, 99.9),
            ) -> dict[str, dict[float, float]]:
        by: dict[str, list[float]] = {}
        for r in self.accepted:
            if r.finish == r.finish:
                by.setdefault(r.tenant, []).append(r.latency)
        return {ten: percentiles(v, qs) for ten, v in by.items()}

    # -- SLA + rates --------------------------------------------------------
    def sla_attainment(self) -> dict[str, float]:
        """Per-tenant fraction of *offered* SLA-carrying requests that
        finished within SLA — a reject counts as a miss (refusing work
        must not launder the attainment number)."""
        tot: dict[str, int] = {}
        ok: dict[str, int] = {}
        for r in self.requests:
            if r.sla is None:
                continue
            tot[r.tenant] = tot.get(r.tenant, 0) + 1
            met = r.verdict == "accepted" and r.finish == r.finish \
                and r.met_sla()
            ok[r.tenant] = ok.get(r.tenant, 0) + (1 if met else 0)
        return {ten: ok[ten] / tot[ten] for ten in tot}

    @property
    def accept_rate(self) -> float:
        return len(self.accepted) / len(self.requests) if self.requests \
            else 1.0

    @property
    def offered_rps(self) -> float:
        """Offered load in simulated time."""
        return len(self.requests) / self.horizon if self.horizon else 0.0

    @property
    def served_rps(self) -> float:
        """Sustained accepted-and-completed request rate, simulated."""
        done = sum(1 for r in self.accepted if r.finish == r.finish)
        return done / self.horizon if self.horizon else 0.0

    @property
    def wall_rps(self) -> float:
        """Requests processed per wall-clock second — the co-simulation
        throughput the benchmark gates."""
        return len(self.requests) / self.wall_s if self.wall_s else 0.0

    def summary(self) -> dict[str, Any]:
        pct = self.latency_percentiles()
        att = self.sla_attainment()
        return {
            "requests": len(self.requests),
            "accepted": len(self.accepted),
            "rejected": len(self.rejected),
            "deferrals": self.deferrals,
            "mapped_tasks": self.mapped_tasks,
            "engine_opens": self.engine_opens,
            "n_events": self.n_events,
            "offered_rps": self.offered_rps,
            "served_rps": self.served_rps,
            "wall_rps": self.wall_rps,
            "p50_ms": pct[50.0] * 1e3,
            "p99_ms": pct[99.0] * 1e3,
            "p999_ms": pct[99.9] * 1e3,
            "sla_attainment": (min(att.values()) if att else 1.0),
            "sla_by_tenant": att,
            "reject_reasons": self.reject_reasons(),
        }


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------
class ServeLoop:
    """Drive open-loop traffic through online mapping + execution.

    One ``SchedulerSession`` with one resident ``TimelineEngine`` serves
    the whole run — ``stats.engine_opens == 1`` is the zero-rebuild
    guarantee the benchmark asserts.  ``batch_window > 0`` coalesces
    arrivals within that many seconds into one admission wave (larger
    map_batch calls, slightly staler occupancy at admission); an
    :class:`~..serve.admission.AdaptiveWindow` widens that window with
    queue depth / projected slowdown and collapses to per-arrival
    admission when idle.  Closed-loop tenants
    (:class:`ClosedLoopClients`) issue each client's next request on
    completion; open- and closed-loop tenants mix freely.
    """

    def __init__(self, graph: HWGraph, policy: Policy,
                 tenants: Sequence[TenantSpec],
                 truth: Optional[Traverser] = None,
                 admission: Optional[AdmissionController] = None,
                 horizon: float = 1.0,
                 charge_overhead: bool = True,
                 batch_window: Union[float, AdaptiveWindow] = 0.0,
                 interventions: Sequence[tuple[float, Callable[[], Any]]] = (),
                 ) -> None:
        self.tenants = list(tenants)
        self.admission = admission if admission is not None \
            else AdmissionController()
        self.horizon = float(horizon)
        self.batch_window = batch_window \
            if isinstance(batch_window, AdaptiveWindow) \
            else float(batch_window)
        self.session = SchedulerSession(graph, policy, truth=truth,
                                        charge_overhead=charge_overhead)
        self.engine = self.session.open_timeline(interventions)
        self.requests: list[ServeRequest] = []
        self.deferrals = 0
        self._inflight: dict[str, int] = {}
        self._by_uid: dict[int, ServeRequest] = {}   # pending task -> req
        self._events: list[tuple[float, int, int, Any]] = []
        self._rid_next: list[int] = []     # per-tenant arrival counters
        self._ti_of = {s.name: i for i, s in enumerate(self.tenants)}
        self._last_proj = 0.0              # last wave's worst proj/deadline
        self.phase_wall: dict[str, float] = {
            "advance": 0.0, "sync": 0.0, "map": 0.0, "admit": 0.0}
        self.wave_sizes: list[int] = []

    def _push_arrival(self, ti: int, t: float, client: int) -> None:
        """Mint the next rid for tenant ``ti`` and enqueue a kind-0
        arrival at ``t`` (closed-loop follow-ups reuse the same path as
        pre-generated open-loop arrivals)."""
        rid = self._rid_next[ti] * len(self.tenants) + ti
        self._rid_next[ti] += 1
        heapq.heappush(self._events, (t, 0, rid, (ti, client)))

    def _issue_next(self, req: ServeRequest, at: float) -> None:
        """Closed-loop continuation: ``req``'s client thinks, then issues
        its next request (dropped past the horizon)."""
        if req.client < 0:
            return
        ti = self._ti_of[req.tenant]
        t = at + self.tenants[ti].arrivals.think(req.client)
        if t < self.horizon:
            self._push_arrival(ti, t, req.client)

    # -- internals ----------------------------------------------------------
    def _sync_completions(self) -> None:
        """Reconcile the belief ledger with *actual* completions.  The
        ledger's own ``prune`` trusts estimated finishes; the resident
        timeline knows the truth — slow tasks keep occupying their PU
        beliefs past the estimate, fast ones free capacity early."""
        fin = self.engine.drain_finished()
        if not fin:
            return
        pol = self.session.policy
        if isinstance(pol, Orchestrator):
            pol.ledger.retire([t.uid for t in fin])
        for t in fin:
            req = self._by_uid.pop(t.uid, None)
            if req is None:
                continue
            req.remaining -= 1
            if req.remaining == 0:
                req.finish = max(self.engine.finish_of(x.uid)
                                 for x in req.tasks)
                self._inflight[req.tenant] -= 1
                self._issue_next(req, req.finish)

    def _refuse(self, req: ServeRequest, d: Decision, events: list,
                now: float) -> None:
        if d.verdict is Verdict.DEFER:
            req.defers += 1
            self.deferrals += 1
            for t in req.tasks:
                t.release_time = d.retry_at
            heapq.heappush(events, (d.retry_at, 1, req.rid, req))
        else:
            req.verdict = "rejected"
            req.reject_reason = d.reason
            # a terminal reject ends the closed-loop client's wait too —
            # it thinks, then tries again with a fresh request
            self._issue_next(req, now)

    def _admit_wave(self, now: float, wave: list[ServeRequest],
                    events: list) -> None:
        adm = self.admission
        live: list[ServeRequest] = []
        for req in wave:
            d = adm.pre_admit(req, now, self._inflight.get(req.tenant, 0))
            if d is None:
                live.append(req)
            else:
                if _SPANS and d.verdict is not Verdict.DEFER:
                    spans.decided(req.rid)
                self._refuse(req, d, events, now)
        if not live:
            return
        for req in live:
            self.session.submit(req.graph)
        w0 = _time.perf_counter()
        results = self.session.map_pending(fallback=False)
        self.phase_wall["map"] += _time.perf_counter() - w0
        proj = 0.0
        for req in live:
            rs = [results.get(t.uid) for t in req.tasks]
            d = adm.post_admit(req, rs, now)
            if _SPANS and d.verdict is not Verdict.DEFER:
                spans.decided(req.rid)
            if d.verdict is Verdict.ACCEPT:
                req.verdict = "accepted"
                req.remaining = len(req.tasks)
                for t, r in zip(req.tasks, rs):
                    self._by_uid[t.uid] = req
                    if t.deadline:
                        proj = max(proj, r.prediction.total / t.deadline)
                self._inflight[req.tenant] = \
                    self._inflight.get(req.tenant, 0) + 1
                self.session.inject(req.tasks)
            else:
                for t in req.tasks:
                    self.session.withdraw(t)
                self._refuse(req, d, events, now)
        # the adaptive window's slowdown-pressure input: this wave's worst
        # projected completion / deadline ratio (0.0 when nothing carried
        # a deadline — depth pressure still applies)
        self._last_proj = proj

    # -- the run ------------------------------------------------------------
    def run(self) -> ServeStats:
        wall0 = _time.perf_counter()
        pw = self.phase_wall
        # event tuples: (t, kind, rid, payload) — kind 0 = fresh arrival
        # (payload: (tenant index, client)), kind 1 = deferred retry
        # (payload: the request).  (t, kind, rid) is unique per push, so
        # heap ordering never compares payloads.
        events = self._events
        self._rid_next = [0] * len(self.tenants)
        for ti, spec in enumerate(self.tenants):
            arr = spec.arrivals
            if hasattr(arr, "think"):          # closed-loop population
                first = arr.initial_arrivals(self.horizon)
                for k, (t, client) in enumerate(first):
                    events.append((t, 0, k * len(self.tenants) + ti,
                                   (ti, client)))
                self._rid_next[ti] = len(first)
            else:
                times = arr.times(self.horizon).tolist()
                for k, t in enumerate(times):
                    events.append((t, 0, k * len(self.tenants) + ti,
                                   (ti, -1)))
                self._rid_next[ti] = len(times)
        heapq.heapify(events)
        bw = self.batch_window
        adaptive = isinstance(bw, AdaptiveWindow)
        while True:
            target = (float(np.nextafter(events[0][0], -np.inf))
                      if events else np.inf)
            tn = self.engine.next_event_time()
            if tn <= target and tn != np.inf:
                # engine work due before the next admission instant:
                # drain that batch and reconcile — a completion may spawn
                # a closed-loop arrival ahead of the current heap head,
                # so re-read the target each step.  (When nothing is due,
                # the advance call — which would only park the clock —
                # is skipped entirely: the idle fast path.)
                w0 = _time.perf_counter()
                sp = spans.enter("serve.step", w0) if _SPANS else None
                self.engine.advance(tn)
                w1 = _time.perf_counter()
                self._sync_completions()
                w2 = _time.perf_counter()
                if sp:
                    spans.leave(sp, w2)
                pw["advance"] += w1 - w0
                pw["sync"] += w2 - w1
                continue
            if not events:
                break
            t0 = events[0][0]
            now = t0
            window = bw.window(sum(self._inflight.values()),
                               self._last_proj) if adaptive else bw
            wave: list[ServeRequest] = []
            while events and events[0][0] <= t0 + window:
                t, kind, rid, payload = heapq.heappop(events)
                now = t
                if kind == 0:
                    ti, client = payload
                    spec = self.tenants[ti]
                    g = spec.make_request(rid // len(self.tenants), t)
                    tasks = list(g)
                    for task in tasks:
                        task.attrs.setdefault("tenant", spec.name)
                        task.attrs["request"] = rid
                    req = ServeRequest(tenant=spec.name, rid=rid,
                                       arrival=t, graph=g, tasks=tasks,
                                       sla=spec.sla,
                                       max_inflight=spec.max_inflight,
                                       client=client)
                    self.requests.append(req)
                else:
                    req = payload
                wave.append(req)
            # admit at the arrival instant: every engine event strictly
            # before the wave's earliest arrival has drained above, so
            # injected releases enter the heap ahead of the clock — same
            # event order as a one-shot run (with a window, occupancy is
            # as of t0, slightly stale for the later arrivals it
            # coalesced)
            w0 = _time.perf_counter()
            sp = spans.enter("serve.wave", w0) if _SPANS else None
            sy = sp and spans.enter("serve.sync", w0)
            self._sync_completions()
            w1 = _time.perf_counter()
            if sp:
                spans.leave(sy, w1)
                sy = spans.enter("serve.admit", w1)
            m0 = pw["map"]
            self._admit_wave(now, wave, events)
            w2 = _time.perf_counter()
            if sp:
                spans.leave(sy, w2)
                spans.leave(sp, w2)
            pw["sync"] += w1 - w0
            pw["admit"] += (w2 - w1) - (pw["map"] - m0)
            self.wave_sizes.append(len(wave))
        wall = _time.perf_counter() - wall0
        return ServeStats(requests=list(self.requests),
                          horizon=self.horizon, wall_s=wall,
                          n_events=self.engine.n_events,
                          mapped_tasks=self.engine.n,
                          engine_opens=self.session.engine_opens,
                          deferrals=self.deferrals,
                          phase_wall=dict(pw),
                          wave_sizes=list(self.wave_sizes))
