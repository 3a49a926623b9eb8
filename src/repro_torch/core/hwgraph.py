"""HW-GRAPH: multi-layer graph-based hardware representation (paper §3.3).

A ``HWGraph`` holds nodes (compute units, storage, controllers, abstract
components, and GROUP sub-graphs) connected by interconnect edges.  Layers of
abstraction are expressed two ways, both from the paper's Fig. 4:

* GROUP nodes contain children (a CPU with cores+caches inside; a pod with
  hosts inside).  The parent/child relation is the Orchestrator hierarchy.
* ``abstraction links`` (the red dashed edges in Fig. 4) tie an ABSTRACT
  placeholder in a coarse layer to its detailed realization in a finer layer.

Every component a ``Task`` can be mapped to is a ``ProcessingUnit`` which
implements the ``Predictable`` interface: ``predict(task, unit)`` and
``get_compute_path()`` (single-source shortest path from the PU to the
storage/controller resources it relies on — the mechanism by which shared
resources between concurrently-running PUs are discovered algorithmically).

Two-layer architecture: this module is the mutable **authoring layer** —
topology constructors build it, and ``apply_churn`` mutates it at
runtime.  It is host Python (the control plane).  Hot-path consumers (the
slowdown model, the Traverser's contention repricing, the Orchestrator's
candidate checks) evaluate against the dense **compiled layer** instead:
a ``core.compiled.CompiledHWGraph`` snapshot of torch tensors on the
graph's device, obtained via :meth:`HWGraph.compiled`.  Runtime churn
(deaths, revivals, bandwidth changes) patches the snapshot as a
copy-on-write delta; construction-time mutations drop it for a rebuild.

The graph carries the **device request** of everything built from it:
``HWGraph(device=None)`` means the CUDA device (``.device`` raises when
there is none), ``HWGraph(device="cpu")`` asks for the CPU explicitly.
"""
from __future__ import annotations

import heapq
import itertools
import warnings
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Iterable, Optional, Sequence

from ..device import DeviceLike, resolve_device


class NodeKind(Enum):
    COMPUTE = "compute"        # a PU: CPU core cluster, GPU, DLA, accelerator chip, ...
    STORAGE = "storage"        # cache, DRAM, HBM, SRAM
    CONTROLLER = "controller"  # memory controller, network switch, router
    ABSTRACT = "abstract"      # internals unknown (e.g. WAN fabric, DCN)
    GROUP = "group"            # sub-graph: SoC, server, rack, pod, cluster


class Unit(Enum):
    """What ``predict`` should return (paper: the UNIT parameter)."""

    SECONDS = "seconds"
    JOULES = "joules"
    FLOPS = "flops"
    BYTES = "bytes"


@dataclass
class Node:
    """A vertex of the HW-GRAPH."""

    name: str
    kind: NodeKind
    attrs: dict[str, Any] = field(default_factory=dict)
    parent: Optional[str] = None          # enclosing GROUP node name
    alive: bool = True                    # dynamic adaptability: dead nodes are skipped

    def __hash__(self) -> int:  # nodes are identified by name
        return hash(self.name)


@dataclass
class EdgeAttr:
    """An interconnect. ``bandwidth`` in bytes/s, ``latency`` in seconds."""

    bandwidth: float = float("inf")
    latency: float = 0.0
    name: str = ""
    attrs: dict[str, Any] = field(default_factory=dict)

    def transfer_time(self, nbytes: float) -> float:
        if nbytes <= 0:
            return self.latency
        return self.latency + nbytes / self.bandwidth


class Predictable(ABC):
    """Interface every mappable HW component must implement (paper §3.3)."""

    @abstractmethod
    def predict(self, task: "Task", unit: Unit = Unit.SECONDS) -> float:  # noqa: F821
        """Standalone cost of ``task`` on this component (no co-runners)."""

    @abstractmethod
    def get_compute_path(self) -> list[str]:
        """Names of storage/controller nodes this PU relies on (via SSSP)."""


class ProcessingUnit(Node, Predictable):
    """A COMPUTE node with an attached performance model.

    ``model`` is any object with ``predict(task, pu, unit) -> float`` —
    the modular performance-model interface (profiled tables, roofline,
    analytic, learned; see core/predict.py).
    """

    def __init__(self, name: str, model: Any = None, max_tenancy: int = 8,
                 attrs: Optional[dict[str, Any]] = None, parent: Optional[str] = None):
        super().__init__(name=name, kind=NodeKind.COMPUTE, attrs=dict(attrs or {}),
                         parent=parent)
        self.model = model
        self.max_tenancy = max_tenancy      # concurrent tasks beyond this queue up
        self._graph: Optional["HWGraph"] = None
        self._compute_path: Optional[list[str]] = None

    # -- Predictable ------------------------------------------------------
    def predict(self, task, unit: Unit = Unit.SECONDS) -> float:
        if self.model is None:
            raise ValueError(f"PU {self.name} has no performance model attached")
        return self.model.predict(task, self, unit)

    def get_compute_path(self) -> list[str]:
        """SSSP from this PU to every reachable STORAGE/CONTROLLER node.

        The result is cached: it is topology-dependent, not task-dependent.
        Only intra-device resources are considered (the search does not cross
        GROUP boundaries upward past this PU's device), matching the paper:
        the path list is "obtained during profiling and stored in the TASK".
        """
        if self._compute_path is None:
            if self._graph is None:
                raise ValueError(f"PU {self.name} is not part of a graph")
            self._compute_path = self._graph.resource_path(self.name)
        return self._compute_path

    def invalidate(self) -> None:
        self._compute_path = None


@dataclass(frozen=True)
class Churn:
    """One batch of topology churn: deaths, then revivals, then
    bandwidth changes (coalesced last-writer-wins per link into one
    multi-edge delta, so N link changes pay one overlay copy).  Applied
    immediately (``HWGraph.apply_churn``), scheduled on a resident
    timeline (``TimelineEngine.schedule``), applied at its clock
    (``TimelineEngine.apply_churn``), or routed by
    ``SchedulerSession.churn``."""

    dead: Sequence[str] = ()
    alive: Sequence[str] = ()
    bandwidth: Sequence[tuple[str, float]] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "dead", tuple(self.dead))
        object.__setattr__(self, "alive", tuple(self.alive))
        object.__setattr__(self, "bandwidth",
                           tuple((e, float(b)) for e, b in self.bandwidth))

    def __bool__(self) -> bool:
        return bool(self.dead or self.alive or self.bandwidth)

    def __len__(self) -> int:
        return len(self.dead) + len(self.alive) + len(self.bandwidth)


class HWGraph:
    """Connected multi-layer graph topology of a DECS."""

    def __init__(self, device: DeviceLike = None) -> None:
        self._device_req = device
        self.nodes: dict[str, Node] = {}
        self._adj: dict[str, list[tuple[str, EdgeAttr]]] = {}
        self._children: dict[str, list[str]] = {}
        # red dashed links in Fig. 4: detailed-node -> abstract-node (and back)
        self.abstraction: dict[str, str] = {}
        self.refinement: dict[str, str] = {}
        self._compiled = None        # lazy CompiledHWGraph snapshot
        self.recompile_count = 0     # full snapshot builds
        self.delta_count = 0         # incremental apply_delta patches
        self.route_row_builds = 0    # lazily materialized route rows (Dijkstras)
        # layered route-table copy counters (see docs/timeline.md,
        # "Route-table layering"): holder = O(D^2) topology-layer copies
        # (death/revival churn only), overlay = O(changed rows) bandwidth
        # overlay copies (one per coalesced bandwidth delta batch)
        self.route_holder_copies = 0
        self.route_overlay_copies = 0
        # overlay folds into a solely-owned topology layer (bounds the
        # overlay dict on long bandwidth-volatile serving runs)
        self.route_overlay_compactions = 0

    @property
    def device(self):
        """The torch device of everything compiled from this graph
        (raises when CUDA was asked for, by default, and is absent)."""
        return resolve_device(self._device_req)

    # -- construction ------------------------------------------------------
    def add_node(self, node: Node) -> Node:
        if node.name in self.nodes:
            raise ValueError(f"duplicate node {node.name!r}")
        self.nodes[node.name] = node
        self._adj.setdefault(node.name, [])
        self._children.setdefault(node.name, [])
        if node.parent is not None:
            self._children.setdefault(node.parent, []).append(node.name)
        if isinstance(node, ProcessingUnit):
            node._graph = self
        self._compiled = None
        return node

    def add_edge(self, u: str, v: str, bandwidth: float = float("inf"),
                 latency: float = 0.0, name: str = "",
                 attrs: Optional[dict[str, Any]] = None) -> EdgeAttr:
        for n in (u, v):
            if n not in self.nodes:
                raise KeyError(f"unknown node {n!r}")
        e = EdgeAttr(bandwidth=bandwidth, latency=latency,
                     name=name or f"{u}--{v}", attrs=dict(attrs or {}))
        self._adj[u].append((v, e))
        self._adj[v].append((u, e))
        self._compiled = None
        return e

    def add_abstraction_link(self, detailed: str, abstract: str) -> None:
        """Tie a detailed node to its coarse placeholder (Fig. 4 red dashes)."""
        self.abstraction[detailed] = abstract
        self.refinement[abstract] = detailed

    # -- queries -----------------------------------------------------------
    def node(self, name: str) -> Node:
        return self.nodes[name]

    def children_of(self, name: str) -> list[Node]:
        return [self.nodes[c] for c in self._children.get(name, [])]

    def parent_of(self, name: str) -> Optional[Node]:
        p = self.nodes[name].parent
        return self.nodes[p] if p is not None else None

    def neighbors(self, name: str) -> list[tuple[Node, EdgeAttr]]:
        return [(self.nodes[v], e) for v, e in self._adj[name]]

    def pus(self, under: Optional[str] = None) -> list[ProcessingUnit]:
        """All (alive) ProcessingUnits, optionally restricted to a GROUP subtree."""
        if under is None:
            return [n for n in self.nodes.values()
                    if isinstance(n, ProcessingUnit) and n.alive]
        out: list[ProcessingUnit] = []
        stack = [under]
        while stack:
            cur = stack.pop()
            n = self.nodes[cur]
            if isinstance(n, ProcessingUnit) and n.alive:
                out.append(n)
            stack.extend(self._children.get(cur, []))
        return out

    def device_of(self, name: str) -> Node:
        """The physical-device GROUP containing ``name``.

        A device group is tagged ``attrs['orc_level'] == 'device'`` by the
        topology constructors (SoCs, servers, accelerator hosts).  Falls back to the
        top-most group below the root for untagged graphs.
        """
        node: Optional[Node] = self.nodes[name]
        tagged: Optional[Node] = None
        while node is not None:
            if node.attrs.get("orc_level") == "device":
                tagged = node
            node = self.nodes[node.parent] if node.parent is not None else None
        if tagged is not None:
            return tagged
        cur = self.nodes[name]
        while cur.parent is not None and self.nodes[cur.parent].parent is not None:
            cur = self.nodes[cur.parent]
        return cur

    # -- shortest paths ----------------------------------------------------
    def sssp(self, src: str, weight: Callable[[EdgeAttr], float] | None = None,
             within_device: bool = False) -> tuple[dict[str, float], dict[str, str]]:
        """Dijkstra from ``src``. Returns (dist, predecessor).

        ``within_device`` restricts exploration to nodes sharing ``src``'s
        enclosing device group (used by get_compute_path so a PU's resource
        list does not leak across the network).
        """
        if weight is None:
            weight = lambda e: e.latency if e.latency > 0 else 1e-9
        home = self.device_of(src).name if within_device else None
        dist: dict[str, float] = {src: 0.0}
        pred: dict[str, str] = {}
        pq: list[tuple[float, str]] = [(0.0, src)]
        while pq:
            d, u = heapq.heappop(pq)
            if d > dist.get(u, float("inf")):
                continue
            for v, e in self._adj[u]:
                if not self.nodes[v].alive:
                    continue
                if home is not None and self.device_of(v).name != home:
                    continue
                nd = d + weight(e)
                if nd < dist.get(v, float("inf")):
                    dist[v] = nd
                    pred[v] = u
                    heapq.heappush(pq, (nd, v))
        return dist, pred

    def path(self, src: str, dst: str) -> list[tuple[str, Optional[EdgeAttr]]]:
        """Node/edge sequence of the shortest path src -> dst (global graph)."""
        dist, pred = self.sssp(src)
        if dst not in dist:
            raise KeyError(f"no path {src} -> {dst}")
        seq: list[str] = [dst]
        while seq[-1] != src:
            seq.append(pred[seq[-1]])
        seq.reverse()
        out: list[tuple[str, Optional[EdgeAttr]]] = [(seq[0], None)]
        for a, b in itertools.pairwise(seq):
            edge = min((e for v, e in self._adj[a] if v == b),
                       key=lambda e: e.latency)
            out.append((b, edge))
        return out

    def transfer_time(self, src: str, dst: str, nbytes: float) -> float:
        """End-to-end transfer cost along the shortest path (store-and-forward
        latency sum; bandwidth bottleneck = min along path)."""
        if src == dst:
            return 0.0
        hops = self.path(src, dst)
        lat = sum(e.latency for _, e in hops if e is not None)
        bw = min((e.bandwidth for _, e in hops if e is not None),
                 default=float("inf"))
        return lat + (nbytes / bw if bw != float("inf") else 0.0)

    def route_edges(self, src: str, dst: str) -> list[EdgeAttr]:
        return [e for _, e in self.path(src, dst) if e is not None]

    def resource_path(self, pu: str) -> list[str]:
        """The memory-hierarchy chain the PU relies on (paper: SSSP between
        the PU and the memory/control sources it uses).

        Returns the STORAGE/CONTROLLER nodes on the shortest path from the PU
        to its device's main memory (nearest dram/hbm node), ordered
        PU-outward — e.g. cpu core -> [L2, L3, LLC, DRAM].  Two PUs' chains
        intersect exactly at the resources they genuinely contend on, and the
        first intersection is the nearest contention point.
        """
        dist, pred = self.sssp(pu, within_device=True)
        sinks = [n for n in dist
                 if self.nodes[n].attrs.get("rclass") in ("dram", "hbm")]
        if sinks:
            sink = min(sinks, key=lambda n: dist[n])
            seq = [sink]
            while seq[-1] != pu:
                seq.append(pred[seq[-1]])
            seq.reverse()
            return [n for n in seq if self.nodes[n].kind in
                    (NodeKind.STORAGE, NodeKind.CONTROLLER)]
        out = [n for n in dist
               if self.nodes[n].kind in (NodeKind.STORAGE, NodeKind.CONTROLLER)]
        out.sort(key=lambda n: dist[n])
        return out

    def shared_resources(self, pu_a: str, pu_b: str) -> list[str]:
        """Resources two PUs contend on = intersection of compute paths.

        This is the paper's Fig. 4 example: DLA and PVA both reach SRAM and
        LPDDR4x, so concurrent execution contends on those.
        """
        a = self.nodes[pu_a]
        b = self.nodes[pu_b]
        pa = a.get_compute_path() if isinstance(a, ProcessingUnit) else self.resource_path(pu_a)
        pb = b.get_compute_path() if isinstance(b, ProcessingUnit) else self.resource_path(pu_b)
        shared = set(pa) & set(pb)
        return sorted(shared)

    # -- dynamic adaptability ------------------------------------------------
    def _subtree(self, name: str) -> list[str]:
        out: list[str] = []
        stack = [name]
        while stack:
            cur = stack.pop()
            out.append(cur)
            stack.extend(self._children.get(cur, []))
        return out

    def apply_churn(self, churn: "Churn") -> None:
        """Apply one :class:`Churn` delta batch — the single topology-churn
        entrypoint (deaths, then revivals, then bandwidth changes).
        Deaths and revivals route through ``_after_mutation`` exactly
        like the old per-call surface.  Bandwidth entries are coalesced
        **last-writer-wins per link** and applied as one multi-edge
        ``set_bandwidth`` delta, so N bandwidth changes in one batch pay
        a single overlay copy; the final snapshot is identical to the
        sequential per-entry patches (each patch reprices a route from
        its edges' live bandwidths, and only the last write to a link
        survives either way)."""
        for name in churn.dead:
            self._mark_dead(name)
        for name in churn.alive:
            self._mark_alive(name)
        if churn.bandwidth:
            final: dict[str, float] = {}
            for edge_name, bandwidth in churn.bandwidth:
                final[edge_name] = bandwidth
            self._set_bandwidths(final)

    def _mark_dead(self, name: str) -> None:
        """Node failure: the node (and its subtree) stops being schedulable."""
        names = self._subtree(name)
        for cur in names:
            self.nodes[cur].alive = False
        self._after_mutation("mark_dead", names=names)

    def _mark_alive(self, name: str) -> None:
        names = self._subtree(name)
        for cur in names:
            self.nodes[cur].alive = True
        self._after_mutation("mark_alive", names=names)

    def _set_bandwidths(self, updates: dict[str, float]) -> None:
        """Dynamic network conditions (paper §5.4.1): re-provision many
        links in one delta.  Validates every name before mutating (the
        authoring layer is never left half-applied on a bad batch)."""
        hit: set[str] = set()
        edges: list[EdgeAttr] = []
        for adj in self._adj.values():
            for _, e in adj:
                if e.name in updates:
                    edges.append(e)
                    hit.add(e.name)
        missing = set(updates) - hit
        if missing:
            raise KeyError(f"no edge named {sorted(missing)[0]!r}")
        for e in edges:
            e.bandwidth = updates[e.name]
        self._after_mutation("set_bandwidth", edge_names=tuple(updates))

    # -- deprecated per-call churn shims ------------------------------------
    # (each is a one-entry Churn: the batch surface is the only delta
    # plumbing left, so the shims cannot drift from apply_churn)
    def mark_dead(self, name: str) -> None:
        """.. deprecated:: batch churn through :meth:`apply_churn` (or
        ``SchedulerSession.churn``)."""
        warnings.warn(
            "HWGraph.mark_dead is deprecated: apply churn as a delta batch "
            "via HWGraph.apply_churn(Churn(dead=[...])) or "
            "SchedulerSession.churn(...)", DeprecationWarning, stacklevel=2)
        self.apply_churn(Churn(dead=(name,)))

    def mark_alive(self, name: str) -> None:
        """.. deprecated:: batch churn through :meth:`apply_churn` (or
        ``SchedulerSession.churn``)."""
        warnings.warn(
            "HWGraph.mark_alive is deprecated: apply churn as a delta batch "
            "via HWGraph.apply_churn(Churn(alive=[...])) or "
            "SchedulerSession.churn(...)", DeprecationWarning, stacklevel=2)
        self.apply_churn(Churn(alive=(name,)))

    def set_bandwidth(self, edge_name: str, bandwidth: float) -> None:
        """.. deprecated:: batch churn through :meth:`apply_churn` (or
        ``SchedulerSession.churn``)."""
        warnings.warn(
            "HWGraph.set_bandwidth is deprecated: apply churn as a delta "
            "batch via HWGraph.apply_churn(Churn(bandwidth=[(edge, bw)])) "
            "or SchedulerSession.churn(...)", DeprecationWarning,
            stacklevel=2)
        self.apply_churn(Churn(bandwidth=((edge_name, bandwidth),)))

    def _after_mutation(self, kind: str, names=(), edge_names=()) -> None:
        """Invalidate object-layer caches, then delta-patch the compiled
        snapshot instead of dropping it (a full rebuild only when the
        delta engine declines — see ``CompiledHWGraph.apply_delta``)."""
        for n in self.nodes.values():
            if isinstance(n, ProcessingUnit):
                n.invalidate()
        if self._compiled is not None:
            patched = self._compiled.apply_delta(kind, names=names,
                                                 edge_names=edge_names)
            self._compiled = patched
            if patched is not None:
                self.delta_count += 1

    def _invalidate_paths(self) -> None:
        for n in self.nodes.values():
            if isinstance(n, ProcessingUnit):
                n.invalidate()
        self._compiled = None

    def compiled(self):
        """The array-native snapshot of the current topology version, on
        this graph's device.  Built lazily on first use.  Construction-time
        mutations drop the snapshot; runtime churn patches it through
        ``apply_delta``, so callers may simply re-fetch it per decision.
        ``recompile_count`` / ``delta_count`` record which path each
        topology version took."""
        if self._compiled is None:
            from .compiled import CompiledHWGraph
            self._compiled = CompiledHWGraph(self)
            self.recompile_count += 1
        return self._compiled

    # -- convenience ---------------------------------------------------------
    def __contains__(self, name: str) -> bool:
        return name in self.nodes

    def __len__(self) -> int:
        return len(self.nodes)

    def summary(self) -> str:
        kinds: dict[str, int] = {}
        for n in self.nodes.values():
            kinds[n.kind.value] = kinds.get(n.kind.value, 0) + 1
        edges = sum(len(v) for v in self._adj.values()) // 2
        parts = ", ".join(f"{k}={v}" for k, v in sorted(kinds.items()))
        return f"HWGraph({len(self.nodes)} nodes [{parts}], {edges} edges)"
