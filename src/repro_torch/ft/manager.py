"""Fault tolerance and elasticity, driven by the H-EYE HW-GRAPH — the
reference package's ``ft/manager.py`` over the port's graph:

* a failed host is marked dead through a ``Churn`` delta batch, which the
  compiled snapshot absorbs as a delta; ``remap`` pushes the orphaned
  work back through ``Orchestrator.map_batch`` in one frontier;
* ``plan_mesh`` recomputes the largest healthy (data, model) grid, to
  replay from the last committed checkpoint;
* stragglers are step-time outliers against the fleet median, confirmed
  after ``straggler_patience`` consecutive flags;
* periodic async checkpoints (``checkpoint.AsyncSaver``) bound the work
  lost to one interval.
"""
from __future__ import annotations

import math
import os
import tempfile
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..checkpoint import AsyncSaver
from ..core.hwgraph import Churn, HWGraph
from ..core.orchestrator import Orchestrator


@dataclass
class FTConfig:
    checkpoint_every: int = 100
    straggler_factor: float = 1.8        # step time > f * median => straggler
    straggler_patience: int = 3          # consecutive flags before action
    min_hosts: int = 1


@dataclass
class RecoveryPlan:
    restore_step: int
    mesh_shape: tuple[int, ...]
    mesh_axes: tuple[str, ...]
    lost_hosts: tuple[str, ...]


class FTManager:
    def __init__(self, graph: HWGraph, cfg: Optional[FTConfig] = None,
                 ckpt_dir: Optional[str] = None) -> None:
        self.graph = graph
        self.cfg = cfg or FTConfig()
        self.ckpt_dir = ckpt_dir or os.path.join(tempfile.gettempdir(),
                                                 "repro_ckpt")
        self.saver = AsyncSaver()
        self.last_committed = -1
        self._strikes: dict[str, int] = {}

    # -- checkpointing --------------------------------------------------------
    def maybe_checkpoint(self, state, step: int) -> bool:
        if step % self.cfg.checkpoint_every != 0:
            return False
        self.saver.save(state, self.ckpt_dir, step)
        self.last_committed = step
        return True

    # -- health ------------------------------------------------------------------
    def alive_hosts(self) -> list[str]:
        return sorted({n.name for n in self.graph.nodes.values()
                       if n.attrs.get("orc_level") == "device" and n.alive})

    def alive_chips(self) -> int:
        return len(self.graph.pus())

    def report_step_times(self, times: dict[str, float]) -> list[str]:
        """Feed per-host step times; returns hosts confirmed as stragglers."""
        if len(times) < 2:
            return []
        med = float(np.median(list(times.values())))
        confirmed = []
        for host, t in times.items():
            if t > self.cfg.straggler_factor * med:
                self._strikes[host] = self._strikes.get(host, 0) + 1
                if self._strikes[host] >= self.cfg.straggler_patience:
                    confirmed.append(host)
            else:
                self._strikes[host] = 0
        return confirmed

    # -- failure / elastic rescale ---------------------------------------------
    def on_failure(self, hosts: list[str]) -> RecoveryPlan:
        self.graph.apply_churn(Churn(dead=tuple(hosts)))
        return self.plan_mesh()

    def on_join(self, host: str) -> RecoveryPlan:
        self.graph.apply_churn(Churn(alive=(host,)))
        return self.plan_mesh()

    def remap(self, scheduler, tasks, now: float = 0.0):
        """Re-place orphaned tasks after ``on_failure`` in one batch.

        ``scheduler`` is an Orchestrator root (or anything exposing
        ``map_batch(tasks, now)``); the dead hosts are already invisible
        to its eligibility masks through the delta-patched snapshot."""
        if isinstance(scheduler, Orchestrator):
            return scheduler.map_batch(tasks, now, route=True)
        return scheduler.map_batch(tasks, now)

    def plan_mesh(self, model_parallel: int = 16) -> RecoveryPlan:
        """Largest (data, model) grid over surviving chips, keeping the model
        axis if divisible (the checkpoint is stored unsharded, so a new
        model-parallel degree needs no conversion)."""
        chips = self.alive_chips()
        if chips == 0:
            raise RuntimeError("no healthy chips remain")
        tp = model_parallel
        while tp > 1 and chips % tp:
            tp //= 2
        dp = chips // tp
        # largest power-of-two dp for clean batch sharding
        dp = 2 ** int(math.floor(math.log2(dp))) if dp > 0 else 1
        dead = tuple(n.name for n in self.graph.nodes.values()
                     if n.attrs.get("orc_level") == "device" and not n.alive)
        return RecoveryPlan(restore_step=max(self.last_committed, 0),
                            mesh_shape=(dp, tp), mesh_axes=("data", "model"),
                            lost_hosts=dead)
