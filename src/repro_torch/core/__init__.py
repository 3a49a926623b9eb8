"""H-EYE core on PyTorch: holistic resource modeling + management (paper §3).

Public surface of the port (same names as the reference package's
``core``):
  HWGraph / Node / ProcessingUnit / Predictable  — graph-based HW repr (§3.3)
  CompiledHWGraph                                — tensor snapshot
  Task / TaskGraph                               — CFGs of constrained tasks
  ProfiledModel / RooflineModel / CallableModel  — modular predict() (§3.3)
  DecoupledSlowdown / SlowdownParams             — decoupled slowdown (§3.4)
  Traverser / Timeline / TaskPrediction          — contention intervals (§3.4)
  Orchestrator / build_orchestrators / ActiveLedger — Alg. 1 (§3.5)
  SchedulerSession                               — batch-first mapping API
  ServeLoop / ServeStats / TenantSpec            — online serving continuum
  PoissonArrivals / DiurnalArrivals              — open-loop traffic models
  ClosedLoopClients                              — closed-loop population
  build_testbed / build_tpu_fleet                — topology (Fig. 4, TPU fleet)
  Runtime / policies                             — experiment harness (§5)
"""
from .compiled import CompiledHWGraph
from .hwgraph import (Churn, EdgeAttr, HWGraph, Node, NodeKind, Predictable,
                      ProcessingUnit, Unit)
from .orchestrator import (ActiveLedger, MapResult, OrcConfig, Orchestrator,
                           build_orchestrators)
from .predict import CallableModel, PerfModel, ProfiledModel, RooflineModel
from .serving import (ClosedLoopClients, DiurnalArrivals, PoissonArrivals,
                      ServeLoop, ServeRequest, ServeStats, TenantSpec,
                      single_task_request)
from .session import RunStats, SchedulerSession, percentiles
from .simulator import (AcePolicy, LatsPolicy, OrchestratorPolicy,
                        Runtime, ground_truth_traverser, heye_traverser)
from .slowdown import (DecoupledSlowdown, NoSlowdown, SlowdownParams,
                       heye_params, truth_params)
from .task import Task, TaskGraph
from .topology import (EDGE_FPS, Testbed, build_edge_device, build_server,
                       build_testbed, build_tpu_fleet, make_task,
                       vr_mining_profile)
from .traverser import TaskPrediction, Timeline, Traverser
from .workloads import (MINING_DEADLINE, mining_workload, vr_frame,
                        vr_workload, wireless_churn_schedule)

__all__ = [n for n in dir() if not n.startswith("_")]
