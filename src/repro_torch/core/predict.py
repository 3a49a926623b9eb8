"""Modular performance-model interface (paper §3.3 ``predict()``).

The paper's design principle: *different performance prediction models could
be integrated in a modular way* — empirical profiling, roofline, ML-based,
analytic.  Each model implements ``predict(task, pu, unit) -> float``.

Two concrete families are provided:

* ``ProfiledModel`` — a lookup table of standalone execution times per
  (task kind, PU), scaled by ``task.size``.  This is what the paper uses for
  its experiments ("we use profiling and record execution times of each TASK
  ... for every target PU").

* ``RooflineModel`` — three-term roofline for accelerator fleets:
  seconds = max(flops/peak_flops, bytes/mem_bw, coll_bytes/link_bw).
  The per-task flops/bytes come from ``task.attrs`` (filled from the compiled
  dry-run artifact or from analytic layer math).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from .hwgraph import ProcessingUnit, Unit
from .task import Task


class PerfModel:
    def predict(self, task: Task, pu: ProcessingUnit, unit: Unit = Unit.SECONDS) -> float:
        raise NotImplementedError

    def supports(self, task: Task, pu: ProcessingUnit) -> bool:
        """Whether this PU can run this task kind at all."""
        try:
            self.predict(task, pu)
            return True
        except KeyError:
            return False


@dataclass
class ProfiledModel(PerfModel):
    """table[(task.kind, pu.name)] -> standalone seconds at size=1.0.

    ``fallback_by_class`` allows tables keyed by a PU *class* attribute
    (e.g. all "orin_agx.gpu"-class PUs share one profile) so fleets with
    thousands of identical devices need one profile per device type —
    exactly how the paper scales its simulations from individual profiles.
    """

    table: dict[tuple[str, str], float] = field(default_factory=dict)
    scaling: str = "linear"        # how seconds scale with task.size

    def key_for(self, task: Task, pu: ProcessingUnit) -> tuple[str, str]:
        cls = pu.attrs.get("pu_class", pu.name)
        if (task.kind, cls) in self.table:
            return (task.kind, cls)
        return (task.kind, pu.name)

    def predict(self, task: Task, pu: ProcessingUnit, unit: Unit = Unit.SECONDS) -> float:
        if unit is not Unit.SECONDS:
            raise ValueError(f"ProfiledModel only predicts SECONDS, not {unit}")
        base = self.table[self.key_for(task, pu)]
        if self.scaling == "linear":
            return base * task.size
        if self.scaling == "const":
            return base
        raise ValueError(f"unknown scaling {self.scaling!r}")

    def supports(self, task: Task, pu: ProcessingUnit) -> bool:
        cls = pu.attrs.get("pu_class", pu.name)
        return (task.kind, cls) in self.table or (task.kind, pu.name) in self.table


@dataclass
class RooflineModel(PerfModel):
    """Three-term roofline against the PU's hardware attrs.

    PU attrs used: ``peak_flops`` (FLOP/s), ``mem_bw`` (B/s), ``link_bw``
    (B/s aggregate off-chip).  Task attrs used: ``flops``, ``bytes``,
    ``coll_bytes`` (any may be absent -> term is 0).
    """

    def predict(self, task: Task, pu: ProcessingUnit, unit: Unit = Unit.SECONDS) -> float:
        flops = task.attrs.get("flops", 0.0) * task.size
        nbytes = task.attrs.get("bytes", 0.0) * task.size
        coll = task.attrs.get("coll_bytes", 0.0) * task.size
        if unit is Unit.FLOPS:
            return flops
        if unit is Unit.BYTES:
            return nbytes
        t_c = flops / pu.attrs["peak_flops"] if flops else 0.0
        t_m = nbytes / pu.attrs["mem_bw"] if nbytes else 0.0
        t_l = coll / pu.attrs["link_bw"] if coll else 0.0
        if t_c == t_m == t_l == 0.0:
            raise KeyError(f"task {task.kind} carries no cost attrs for roofline")
        return max(t_c, t_m, t_l)

    def supports(self, task: Task, pu: ProcessingUnit) -> bool:
        has_cost = any(k in task.attrs for k in ("flops", "bytes", "coll_bytes"))
        has_hw = "peak_flops" in pu.attrs and "mem_bw" in pu.attrs
        return has_cost and has_hw


@dataclass
class CallableModel(PerfModel):
    """Adapter for arbitrary analytic/learned predictors."""

    fn: Callable[[Task, ProcessingUnit, Unit], float]

    def predict(self, task: Task, pu: ProcessingUnit, unit: Unit = Unit.SECONDS) -> float:
        return self.fn(task, pu, unit)
