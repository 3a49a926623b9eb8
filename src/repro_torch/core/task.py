"""Tasks and control-flow graphs (CFGs) of tasks.

A ``Task`` is the unit the Orchestrator maps onto a PU.  Per the paper it
carries (i) identification info used to look up modeled performance
(``kind``, ``size``), (ii) per-task constraints (a latency deadline), and
(iii) its *generalized resource usage* per shared resource class — the
quantity the decoupled slowdown models consume (requested memory bandwidth,
link bandwidth, PU utilization; §3.4 "Slowdown calculation" step 2).

A ``TaskGraph`` is a DAG with serial & parallel regions (paper Fig. 6/7/8).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Iterable, Optional

_task_counter = itertools.count()


@dataclass
class Task:
    kind: str                                   # e.g. "render", "svm", "layer_fwd"
    size: float = 1.0                           # work-amount scale (1.0 = profiled size)
    deadline: Optional[float] = None            # latency constraint in seconds (None = best effort)
    input_bytes: float = 0.0                    # bytes that must reach the PU before start
    output_bytes: float = 0.0                   # bytes produced (to successors)
    origin: Optional[str] = None                # device name where the task is generated
    # generalized usage per shared-resource class, e.g. {"dram_bw": 6e9, "pu": 1.0}
    usage: dict[str, float] = field(default_factory=dict)
    attrs: dict[str, Any] = field(default_factory=dict)
    uid: int = field(default_factory=lambda: next(_task_counter))
    # runtime state (filled by Orchestrator / simulator)
    assigned_pu: Optional[str] = None
    release_time: float = 0.0                   # earliest start (arrival)

    def __hash__(self) -> int:
        return self.uid

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Task) and other.uid == self.uid

    def clone(self, **overrides: Any) -> "Task":
        t = Task(kind=self.kind, size=self.size, deadline=self.deadline,
                 input_bytes=self.input_bytes, output_bytes=self.output_bytes,
                 origin=self.origin, usage=dict(self.usage), attrs=dict(self.attrs))
        for k, v in overrides.items():
            setattr(t, k, v)
        return t

    def __repr__(self) -> str:  # keep logs readable
        dl = f", dl={self.deadline * 1e3:.1f}ms" if self.deadline else ""
        return f"Task({self.kind}#{self.uid}{dl})"


class TaskGraph:
    """A DAG of Tasks; edges are dependencies (data flows producer->consumer)."""

    def __init__(self, name: str = "cfg") -> None:
        self.name = name
        self.tasks: list[Task] = []
        self._succ: dict[int, list[Task]] = {}
        self._pred: dict[int, list[Task]] = {}

    # -- construction ------------------------------------------------------
    def add(self, task: Task, deps: Iterable[Task] = ()) -> Task:
        self.tasks.append(task)
        self._succ.setdefault(task.uid, [])
        self._pred.setdefault(task.uid, [])
        for d in deps:
            self.add_dep(d, task)
        return task

    def add_dep(self, producer: Task, consumer: Task) -> None:
        self._succ.setdefault(producer.uid, []).append(consumer)
        self._pred.setdefault(consumer.uid, []).append(producer)

    def chain(self, tasks: Iterable[Task]) -> list[Task]:
        """Convenience: serial region."""
        out: list[Task] = []
        prev: Optional[Task] = None
        for t in tasks:
            self.add(t, deps=[prev] if prev is not None else [])
            out.append(t)
            prev = t
        return out

    def remove(self, task: Task) -> None:
        """Withdraw ``task`` from the graph (the admission-rejection
        path).  Dependents of a removed task lose the dependency edge;
        callers withdrawing whole requests remove every member."""
        self.tasks = [t for t in self.tasks if t.uid != task.uid]
        for s in self._succ.pop(task.uid, []):
            self._pred[s.uid] = [p for p in self._pred.get(s.uid, [])
                                 if p.uid != task.uid]
        for p in self._pred.pop(task.uid, []):
            self._succ[p.uid] = [s for s in self._succ.get(p.uid, [])
                                 if s.uid != task.uid]

    # -- queries -----------------------------------------------------------
    def preds(self, task: Task) -> list[Task]:
        return self._pred.get(task.uid, [])

    def succs(self, task: Task) -> list[Task]:
        return self._succ.get(task.uid, [])

    def roots(self) -> list[Task]:
        return [t for t in self.tasks if not self._pred.get(t.uid)]

    def topological(self) -> list[Task]:
        indeg = {t.uid: len(self._pred.get(t.uid, [])) for t in self.tasks}
        ready = [t for t in self.tasks if indeg[t.uid] == 0]
        order: list[Task] = []
        i = 0
        while i < len(ready):
            t = ready[i]
            i += 1
            order.append(t)
            for s in self._succ.get(t.uid, []):
                indeg[s.uid] -= 1
                if indeg[s.uid] == 0:
                    ready.append(s)
        if len(order) != len(self.tasks):
            raise ValueError(f"cycle detected in TaskGraph {self.name!r}")
        return order

    def __len__(self) -> int:
        return len(self.tasks)

    def __iter__(self):
        return iter(self.tasks)
