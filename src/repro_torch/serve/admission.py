"""Multi-tenant admission control for the online serving continuum.

Decides per request — **accept**, **reject**, or **defer** — against
per-tenant SLA deadlines, using the Orchestrator's own Alg. 1 signals:

* *feasibility* — ``Orchestrator.map_batch`` returning ``None`` for a
  task means no PU passed the constraint walk at current occupancy
  (eligibility, tenancy, memory, the l.15 deadline re-check of resident
  tasks), so the request cannot be placed without degrading someone;
* *projected slowdown* — for a placed task, ``MapResult.prediction.total``
  is the orchestrator's own end-to-end estimate (standalone x slowdown
  + comm); a projection beyond ``deadline * slack`` is an SLA miss the
  controller can refuse up front instead of discovering at p99.

Deferral re-enqueues the request ``defer_delay`` seconds later, up to
``max_defers`` times — the knob that turns a hard burst into a short
queue instead of a reject storm.

This module is host control flow with no array dependency (no torch, no
numpy): it is imported by ``core.serving``, and every verdict is made on
host floats the orchestrator already returned.
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Optional, Sequence


class Verdict(Enum):
    ACCEPT = "accept"
    REJECT = "reject"
    DEFER = "defer"


@dataclass
class Decision:
    """One admission outcome.  ``retry_at`` is set iff deferred."""

    verdict: Verdict
    reason: str = ""
    retry_at: Optional[float] = None

    @classmethod
    def accept(cls) -> "Decision":
        return cls(Verdict.ACCEPT)

    @classmethod
    def reject(cls, reason: str) -> "Decision":
        return cls(Verdict.REJECT, reason)

    @classmethod
    def defer(cls, reason: str, retry_at: float) -> "Decision":
        return cls(Verdict.DEFER, reason, retry_at)


class AdmissionController:
    """Accept / reject / defer per-tenant bursts against SLA deadlines.

    Knobs:

    ``slack``
        Projected-completion multiplier: a task whose mapped
        ``prediction.total`` exceeds ``deadline * slack`` is refused.
        ``slack=1.0`` admits only what the orchestrator projects to meet
        its deadline outright; ``>1`` tolerates optimistic projections
        (the prediction ignores future arrivals); ``float("inf")``
        disables the projection check (feasibility-only, see
        :func:`admit_all`).
    ``defer_delay`` / ``max_defers``
        A refused request is re-enqueued ``defer_delay`` seconds later
        instead of rejected, up to ``max_defers`` times per request.
        ``max_defers=0`` (default) rejects immediately.
    ``max_inflight``
        Global per-tenant concurrent-request cap, checked before mapping
        (a tenant's own ``TenantSpec.max_inflight`` overrides it).
    """

    def __init__(self, slack: float = 1.0, defer_delay: float = 0.0,
                 max_defers: int = 0,
                 max_inflight: Optional[int] = None) -> None:
        self.slack = float(slack)
        self.defer_delay = float(defer_delay)
        self.max_defers = int(max_defers)
        self.max_inflight = max_inflight

    def _back_off(self, req, now: float, reason: str) -> Decision:
        if self.defer_delay > 0.0 and req.defers < self.max_defers:
            return Decision.defer(reason, retry_at=now + self.defer_delay)
        return Decision.reject(reason)

    def pre_admit(self, req, now: float,
                  inflight: int) -> Optional[Decision]:
        """Quota gate before any mapping work is spent.  ``None`` means
        proceed to mapping; a Decision is a refusal."""
        cap = req.max_inflight if req.max_inflight is not None \
            else self.max_inflight
        if cap is not None and inflight >= cap:
            return self._back_off(req, now, "inflight_cap")
        return None

    def post_admit(self, req, results: Sequence, now: float) -> Decision:
        """Judge the mapped placement: ``results`` holds one
        ``MapResult`` (or ``None``) per task of the request, from
        ``map_pending(fallback=False)``."""
        if any(r is None for r in results):
            return self._back_off(req, now, "infeasible")
        if self.slack != float("inf"):
            for t, r in zip(req.tasks, results):
                if (t.deadline is not None
                        and r.prediction.total > t.deadline * self.slack):
                    return self._back_off(req, now, "projected_sla")
        return Decision.accept()


@dataclass
class AdaptiveWindow:
    """Overload-adaptive admission coalescing for ``ServeLoop``.

    Replaces a fixed ``batch_window`` with one that tracks *pressure*:
    when the loop is idle every arrival is admitted on its own instant
    (``min_window``, zero by default — no added queueing delay), and as
    either the in-flight queue depth or the last wave's worst projected
    slowdown rises toward its high-water mark the window widens linearly
    toward ``max_window`` — waves grow exactly when batch amortization
    pays and requests are waiting anyway.

    ``window(depth, proj)`` is a pure function of its inputs, so wave
    boundaries stay deterministic for a seeded arrival process.

    Knobs:

    ``max_window``
        Widest coalescing window (seconds), reached at/beyond a
        high-water mark.
    ``depth_hi``
        In-flight request count at which depth pressure alone saturates
        the window.
    ``proj_hi``
        Projected completion/deadline ratio at which slowdown pressure
        alone saturates the window (pressure starts at ratio 1.0 — a
        projection at its deadline).
    ``min_window``
        Window when idle (default 0.0 — per-arrival admission).
    """

    max_window: float
    depth_hi: int = 16
    proj_hi: float = 2.0
    min_window: float = 0.0

    def window(self, depth: int, proj: float) -> float:
        p_d = depth / self.depth_hi if self.depth_hi > 0 else 0.0
        p_s = ((proj - 1.0) / (self.proj_hi - 1.0)
               if self.proj_hi > 1.0 else 0.0)
        press = max(p_d, p_s, 0.0)
        if press <= 0.0:
            return self.min_window
        return self.min_window + (self.max_window - self.min_window) \
            * min(1.0, press)


def admit_all() -> AdmissionController:
    """Feasibility-only controller: admit everything the orchestrator can
    place at all, regardless of projected SLA."""
    return AdmissionController(slack=float("inf"))
