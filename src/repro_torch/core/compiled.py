"""Compiled, array-native HW-GRAPH snapshot.

The HW-GRAPH lives in two layers:

* **Authoring layer** (`hwgraph.HWGraph`) — the mutable object graph the
  topology constructors build and ``apply_churn`` mutates.  Host Python.

* **Compiled layer** (this module) — a dense snapshot built once per
  topology version and shared by every consumer that evaluates *many*
  PUs or PU pairs per decision: the vectorized slowdown model, the
  Traverser's contention repricing, the Orchestrator's batched candidate
  constraint checks.  Its numeric arrays are torch tensors on the
  graph's device:

  - a **PU index space** (every ``ProcessingUnit``, alive or not, in
    insertion order) with per-PU effective-memory caps (``mem_cap``),
    tenancy limits, aliveness and dense enclosing-device ordinals;
  - per-PU **compute-path membership masks** over the resource index
    space, and the all-pairs **nearest-common-resource matrix**
    ``ncr_res`` with its resource-class projection ``ncr_rclass`` —
    entry ``[i, j]`` is the first resource on PU ``i``'s compute path
    that PU ``j``'s path also visits (the contention point of the pair).
    Compute paths never cross device boundaries, so the matrix is
    block-diagonal by device and is built per device block.

  The **route table** stays on the host (numpy + ``EdgeAttr`` lists): it
  is written row by row by lazily run shortest-path searches and read a
  scalar or a short row at a time by the control plane.  It is layered:
  a *topology layer* (latency, routes, built rows; shared copy-on-write,
  privately copied only by death/revival deltas) and a per-snapshot
  *bandwidth overlay* (inverse-bandwidth row shadows owned by
  ``set_bandwidth`` deltas), so bandwidth churn copies O(changed rows).

``HWGraph.compiled()`` returns the current snapshot.  Construction-time
mutations drop it for a full rebuild; the runtime mutations (deaths,
revivals, bandwidth changes) go through :meth:`CompiledHWGraph.apply_delta`,
which returns a copy-on-write clone with only the affected state patched.
A device column the delta changes (``pu_alive``, and on a revival
``path_mask`` / ``ncr_res`` / ``ncr_rclass`` / ``resource_rclass``) is
cloned on the card and the clone patched — never written in place, since
the previous snapshot may still be held by a walk's batch context or a
timeline's frozen routes.  ``apply_delta`` returns ``None`` when the
effects exceed what can be patched (a resource dying under still-alive
PUs), and the graph then rebuilds.

Compute paths never cross device boundaries, so PUs of different
devices share no compute-path resource: the walk's per-group drive
reads only its group's columns of this one snapshot.
"""
from __future__ import annotations

import threading
import weakref
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import host_item, host_list
from .hwgraph import EdgeAttr, HWGraph, NodeKind, ProcessingUnit


# bandwidth-overlay compaction threshold: fold the overlay back into a
# solely-owned topology layer once this many distinct links are dirty
_OVERLAY_COMPACT_DIRTY = 64


class _RouteTopo:
    """The **topology layer** of the route table: dense latency matrix,
    build-time base inverse-bandwidth matrix, concrete ``EdgeAttr`` route
    lists, per-row materialization state, and the crossed-edge id set.

    Shared copy-on-write across snapshots and privately copied only by
    death/revival patches.  Lazy route-row builds *write through* to it,
    so every sharer sees the same ``built`` flags and freshly built rows.
    Built rows are never mutated while shared: bandwidth repricing lives
    in the per-snapshot overlay (:class:`_RouteTable`), and
    ``_invalidate_row`` only ever runs after a private topology copy."""

    __slots__ = ("lat", "ibw", "routes", "built", "edge_ids", "fast",
                 "owners")

    def __init__(self, D: int) -> None:
        self.lat = np.full((D, D), np.inf)
        np.fill_diagonal(self.lat, 0.0)
        self.ibw = np.zeros((D, D))
        self.routes: dict[tuple[int, int], list[EdgeAttr]] = {}
        self.built = np.zeros(D, dtype=bool)
        # ids of every EdgeAttr any built route crosses (delta prefilter)
        self.edge_ids: set[int] = set()
        # rows built in batch: row -> (predecessor array over the global
        # node space, sorted crossed edge ordinals); their EdgeAttr route
        # lists materialize per pair on first access
        self.fast: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        # the _RouteTables currently sharing this layer (weak: dead
        # snapshots drop out) — overlay compaction is legal exactly when
        # one table is the sole surviving sharer
        self.owners: "weakref.WeakSet" = weakref.WeakSet()

    def copy(self) -> "_RouteTopo":
        c = object.__new__(_RouteTopo)
        c.lat = self.lat.copy()
        c.ibw = self.ibw.copy()
        c.routes = dict(self.routes)
        c.built = self.built.copy()
        c.edge_ids = set(self.edge_ids)
        c.fast = dict(self.fast)
        c.owners = weakref.WeakSet()
        return c


class _RouteTable:
    """One snapshot's route view: a shared :class:`_RouteTopo` plus a
    private **bandwidth overlay** — per-row effective inverse-bandwidth
    shadows (``over``) and the set of links repriced since the topology
    layer was last privately owned (``dirty``).

    A bandwidth delta clones through :meth:`overlay_clone` (the topology
    layer stays shared, only the overlay dict is copied: O(changed
    rows)); a death/revival delta clones through :meth:`copy` (a private
    topology copy with the overlay flattened into the base ``ibw``:
    O(D^2)).  Effective inverse bandwidth is read through :meth:`ibw_row`
    / :meth:`ibw_col`; there is deliberately no ``.ibw`` attribute, so a
    consumer reading the base matrix without the overlay fails loudly."""

    __slots__ = ("topo", "over", "dirty", "__weakref__")

    def __init__(self, D: int) -> None:
        self.topo = _RouteTopo(D)
        self.over: dict[int, np.ndarray] = {}
        self.dirty: set[str] = set()
        self.topo.owners.add(self)

    # -- topology-layer views (shared; see _RouteTopo) -------------------
    @property
    def lat(self) -> np.ndarray:
        return self.topo.lat

    @property
    def routes(self) -> dict:
        return self.topo.routes

    @property
    def built(self) -> np.ndarray:
        return self.topo.built

    @property
    def edge_ids(self) -> set:
        return self.topo.edge_ids

    @property
    def fast(self) -> dict:
        return self.topo.fast

    # -- effective inverse bandwidth (base + overlay) --------------------
    def ibw_row(self, i: int) -> np.ndarray:
        """Effective inverse-bandwidth row ``i`` (overlay shadow wins)."""
        r = self.over.get(i)
        return r if r is not None else self.topo.ibw[i]

    def ibw_col(self, rows: np.ndarray, j: int) -> np.ndarray:
        """Effective inverse bandwidth of the pairs ``(rows, j)``."""
        col = self.topo.ibw[rows, j]
        if self.over:
            for k, i in enumerate(np.asarray(rows).tolist()):
                r = self.over.get(int(i))
                if r is not None:
                    col[k] = r[j]
        return col

    # -- the two copy-on-write clones ------------------------------------
    def overlay_clone(self) -> "_RouteTable":
        """Bandwidth-delta clone: share the topology layer, copy the
        overlay dict (row arrays stay shared until shadowed)."""
        c = object.__new__(_RouteTable)
        c.topo = self.topo
        c.over = dict(self.over)
        c.dirty = set(self.dirty)
        self.topo.owners.add(c)
        return c

    def copy(self) -> "_RouteTable":
        """Topology-delta clone: private topology copy with the overlay
        flattened into the base ``ibw``."""
        c = object.__new__(_RouteTable)
        c.topo = self.topo.copy()
        for i, row in self.over.items():
            c.topo.ibw[i, :] = row
        c.over = {}
        c.dirty = set()
        c.topo.owners.add(c)
        return c

    def compact(self) -> None:
        """Fold the bandwidth overlay back into the (solely owned)
        topology layer.  ``ibw_row``/``ibw_col`` read identical values
        before and after; ONLY legal when ``len(topo.owners) == 1``."""
        for i, row in self.over.items():
            self.topo.ibw[i, :] = row
        self.over = {}
        self.dirty = set()


def _have_scipy() -> bool:
    global _SCIPY
    if _SCIPY is None:
        try:
            from scipy.sparse.csgraph import dijkstra  # noqa: F401
            _SCIPY = True
        except Exception:                # pragma: no cover - no scipy
            _SCIPY = False
    return _SCIPY


_SCIPY: Optional[bool] = None


class _FastRouteCtx:
    """Shared state of the batched route-row build for one snapshot:
    the integer-compressed alive adjacency (a scipy CSR weight matrix),
    per-directed-pair best-edge value arrays, and gather tables over the
    edge-ordinal space."""

    __slots__ = ("idx", "N", "keys", "hlat", "hibw", "kord", "ord_ids",
                 "W", "r_idx")

    def __init__(self, comp: "CompiledHWGraph") -> None:
        from scipy.sparse import csr_matrix
        g = comp.graph
        names, idx = comp._node_space()
        self.idx = idx
        self.N = N = len(names)
        alive = np.fromiter((g.nodes[n].alive for n in names), bool, N)
        ord_edges = comp._edge_ord_edges()
        key_l: list[int] = []
        w_l: list[float] = []
        hl_l: list[float] = []
        hb_l: list[float] = []
        ko_l: list[int] = []
        for o, ((a, b), e) in enumerate(comp._best_edge.items()):
            bi = idx[b]
            if not alive[bi]:
                continue
            key_l.append(idx[a] * N + bi)
            # the exact sssp() weight rule: zero-latency hops cost 1e-9
            w_l.append(e.latency if e.latency > 0 else 1e-9)
            hl_l.append(e.latency)
            bw = e.bandwidth
            hb_l.append(0.0 if bw == float("inf") else 1.0 / bw)
            ko_l.append(o)
        keys = np.asarray(key_l, dtype=np.int64)
        order = np.argsort(keys, kind="stable")
        self.keys = keys[order]
        self.hlat = np.asarray(hl_l)[order]
        self.hibw = np.asarray(hb_l)[order]
        self.kord = np.asarray(ko_l, dtype=np.int64)[order]
        w = np.asarray(w_l)[order]
        self.W = csr_matrix((w, (self.keys // N, self.keys % N)),
                            shape=(N, N))
        self.ord_ids = np.fromiter((id(e) for e in ord_edges),
                                   dtype=np.int64, count=len(ord_edges))
        self.r_idx = np.fromiter((idx[nm] for nm in comp.routable_names),
                                 dtype=np.int64,
                                 count=len(comp.routable_names))


class CompiledHWGraph:
    """Array-native snapshot of one topology version, on ``device``."""

    def __init__(self, graph: HWGraph) -> None:
        self.graph = graph
        self.device = graph.device
        self.version = 0
        self._build_pus()
        self._build_ncr()
        self._build_routes()
        self._rt_lock = threading.RLock()

    # ------------------------------------------------------------------
    # build: PU index space
    # ------------------------------------------------------------------
    def _build_pus(self) -> None:
        g = self.graph
        dev = self.device
        self.pu_names: list[str] = [n.name for n in g.nodes.values()
                                    if isinstance(n, ProcessingUnit)]
        self.pu_index: dict[str, int] = {n: i for i, n in enumerate(self.pu_names)}
        P = len(self.pu_names)
        pu_alive = np.zeros(P, dtype=bool)
        mem_cap = np.full(P, np.inf)
        max_tenancy = np.zeros(P, dtype=np.int64)
        self.pu_class_kind: list[str] = []
        self._pu_device_name: dict[str, str] = {}
        for i, name in enumerate(self.pu_names):
            pu = g.nodes[name]
            pu_alive[i] = pu.alive
            cap = pu.attrs.get("mem_usage_cap")
            if cap is not None:
                mem_cap[i] = cap
            max_tenancy[i] = pu.max_tenancy
            self.pu_class_kind.append(
                pu.attrs.get("pu_class_kind", pu.attrs.get("pu_class", "default")))
            self._pu_device_name[name] = g.device_of(name).name
        # enclosing-device name per PU index (host: names are control plane)
        self.pu_device: list[str] = [self._pu_device_name[n]
                                     for n in self.pu_names]
        # dense device ordinals (block-diagonal slowdown pairing, comm LUTs)
        self.dev_ord: dict[str, int] = {}
        self.dev_ord_names: list[str] = []
        ords = np.empty(P, dtype=np.int64)
        for i, name in enumerate(self.pu_names):
            d = self._pu_device_name[name]
            o = self.dev_ord.get(d)
            if o is None:
                o = self.dev_ord[d] = len(self.dev_ord_names)
                self.dev_ord_names.append(d)
            ords[i] = o
        self.pu_alive = torch.as_tensor(pu_alive, device=dev)
        self.mem_cap = torch.as_tensor(mem_cap, device=dev)
        self.max_tenancy = torch.as_tensor(max_tenancy, device=dev)
        self.pu_dev_ord = torch.as_tensor(ords, device=dev)
        # host mirror of the small read-mostly ordinal table: the control
        # plane maps PU index -> device ordinal one scalar at a time
        self.pu_dev_ord_l: list[int] = ords.tolist()

    # ------------------------------------------------------------------
    # build: compute paths + nearest-common-resource matrix
    # ------------------------------------------------------------------
    def _build_ncr(self) -> None:
        g = self.graph
        dev = self.device
        P = len(self.pu_names)
        paths: list[list[str]] = []
        self.resource_names: list[str] = []
        self.resource_index: dict[str, int] = {}
        for name in self.pu_names:
            node = g.nodes[name]
            path = (node.get_compute_path() if isinstance(node, ProcessingUnit)
                    else g.resource_path(name))
            paths.append(path)
            for r in path:
                if r not in self.resource_index:
                    self.resource_index[r] = len(self.resource_names)
                    self.resource_names.append(r)
        self.compute_paths: list[list[str]] = paths
        R = len(self.resource_names)
        self.rclass_names: list[str] = []
        rclass_index: dict[str, int] = {}
        resource_rclass = np.zeros(R, dtype=np.int64)
        for r, name in enumerate(self.resource_names):
            rc = g.nodes[name].attrs.get("rclass", "dram")
            if rc not in rclass_index:
                rclass_index[rc] = len(self.rclass_names)
                self.rclass_names.append(rc)
            resource_rclass[r] = rclass_index[rc]
        # membership mask: does PU j's compute path visit resource r?
        path_mask = np.zeros((P, R), dtype=bool)
        for j, path in enumerate(paths):
            for r in path:
                path_mask[j, self.resource_index[r]] = True
        # ncr_res[i, j] = first resource on i's path that j's path visits.
        # Block-diagonal by enclosing device: each device's small block is
        # assembled on the host, the finished matrices move to the device
        # once.  (int32/int16 keep the P x P matrices compact at fleet
        # scale; gathers widen to int64.)
        ncr_res = np.full((P, P), -1, dtype=np.int32)
        ncr_rclass = np.full((P, P), -1, dtype=np.int16)
        by_dev: dict[str, list[int]] = {}
        for i, name in enumerate(self.pu_names):
            by_dev.setdefault(self._pu_device_name[name], []).append(i)
        for rows in by_dev.values():
            idx = np.asarray(rows, dtype=np.int64)
            for i in rows:
                unset = np.ones(len(rows), dtype=bool)
                for r in paths[i]:
                    ri = self.resource_index[r]
                    hit = unset & path_mask[idx, ri]
                    ncr_res[i, idx[hit]] = ri
                    ncr_rclass[i, idx[hit]] = resource_rclass[ri]
                    unset &= ~hit
        self.resource_rclass = torch.as_tensor(resource_rclass, device=dev)
        self.path_mask = torch.as_tensor(path_mask, device=dev)
        self.ncr_res = torch.as_tensor(ncr_res, device=dev)
        self.ncr_rclass = torch.as_tensor(ncr_rclass, device=dev)

    # ------------------------------------------------------------------
    # build: transfer tables over routable (GROUP) nodes, lazily by row
    # ------------------------------------------------------------------
    def _build_routes(self) -> None:
        g = self.graph
        self.routable_names: list[str] = [n.name for n in g.nodes.values()
                                          if n.kind is NodeKind.GROUP]
        self.routable_index: dict[str, int] = {n: i for i, n
                                               in enumerate(self.routable_names)}
        # min-latency edge per ordered node pair: O(1) per reconstruction hop
        self._best_edge: dict[tuple[str, str], EdgeAttr] = {}
        for a, adj in g._adj.items():
            for b, e in adj:
                cur = self._best_edge.get((a, b))
                if cur is None or e.latency < cur.latency:
                    self._best_edge[(a, b)] = e
        self._rt = _RouteTable(len(self.routable_names))

    def _ensure_row(self, i: int) -> None:
        if not self._rt.built[i]:
            with self._rt_lock:
                if self._rt.built[i]:
                    return
                if _have_scipy():
                    self._build_rows_fast([i])
                else:
                    self._rebuild_route_row(i)

    def _node_space(self) -> tuple[list, dict]:
        """Global node name list / index map in ``graph.nodes`` order —
        the coordinate space of fast-row predecessor arrays."""
        ns = self.__dict__.get("_node_names")
        if ns is None:
            ns = self._node_names = list(self.graph.nodes)
            self._node_idx = {n: k for k, n in enumerate(ns)}
        return ns, self._node_idx

    def _edge_ord_edges(self) -> list:
        """EdgeAttr per edge ordinal (``_best_edge`` insertion order)."""
        el = self.__dict__.get("_edge_ords_list")
        if el is None:
            el = self._edge_ords_list = list(self._best_edge.values())
        return el

    def _fast_ctx(self) -> _FastRouteCtx:
        ctx = self.__dict__.get("_fast_route_ctx")
        if ctx is None:
            ctx = self._fast_route_ctx = _FastRouteCtx(self)
        return ctx

    def ensure_routes(self, srcs) -> int:
        """Batch-materialize the route rows of ``srcs`` (names or indices);
        returns how many rows were actually built.  With scipy present
        every build goes through the batched build (one multi-source
        Dijkstra); the per-row heapq path is the no-scipy fallback."""
        with self._rt_lock:
            idxs: list[int] = []
            seen: set[int] = set()
            for s in srcs:
                i = self.routable_index.get(s) if isinstance(s, str) else int(s)
                if i is None or i in seen or self._rt.built[i]:
                    continue
                seen.add(i)
                idxs.append(i)
            if idxs and _have_scipy():
                self._build_rows_fast(idxs)
            else:
                for i in idxs:
                    self._rebuild_route_row(i)
            return len(idxs)

    def _build_rows_fast(self, idxs: list) -> None:
        """Materialize many route rows at once: one multi-source scipy
        Dijkstra over the alive adjacency, then a vectorized
        predecessor-tree accumulation per row.  Per-hop latencies
        accumulate source-outward (left to right) and the bottleneck
        inverse bandwidth is a running max of reciprocals, so the values
        equal the per-row heapq build's bit for bit."""
        from scipy.sparse.csgraph import dijkstra
        ctx = self._fast_ctx()
        g = self.graph
        si = np.fromiter((ctx.idx[self.routable_names[i]] for i in idxs),
                         dtype=np.int64, count=len(idxs))
        dist, pred = dijkstra(ctx.W, directed=True, indices=si,
                              return_predecessors=True)
        dist = np.atleast_2d(dist)
        pred = np.atleast_2d(pred)
        for k, i in enumerate(idxs):
            self._fill_fast_row(i, int(si[k]), dist[k], pred[k], ctx)
            g.route_row_builds += 1

    def _fill_fast_row(self, i: int, s: int, d: np.ndarray, p: np.ndarray,
                       ctx: _FastRouteCtx) -> None:
        # writes go to the (possibly shared) topology layer: a lazy build
        # is a write-through, so every sharer sees the same built flags
        topo = self._rt.topo
        if topo.built[i]:
            for j in range(len(self.routable_names)):
                topo.routes.pop((i, j), None)
            topo.fast.pop(i, None)
        topo.built[i] = True
        reach = np.isfinite(d)
        reach[s] = False
        vs = np.flatnonzero(reach)
        if not vs.size:
            topo.lat[i, :] = np.inf
            topo.lat[i, i] = 0.0
            topo.ibw[i, :] = 0.0
            return
        pv = p[vs].astype(np.int64)
        pos = np.searchsorted(ctx.keys, pv * ctx.N + vs)
        el = ctx.hlat[pos]
        eb = ctx.hibw[pos]
        lat_to = np.zeros(ctx.N)
        ibw_to = np.zeros(ctx.N)
        known = np.zeros(ctx.N, dtype=bool)
        known[s] = True
        rem = np.arange(vs.size)
        while rem.size:
            ready = known[pv[rem]]
            sel = rem[ready]
            v = vs[sel]
            lat_to[v] = lat_to[pv[sel]] + el[sel]
            ibw_to[v] = np.maximum(ibw_to[pv[sel]], eb[sel])
            known[v] = True
            rem = rem[~ready]
        fin = known[ctx.r_idx]
        topo.lat[i, :] = np.where(fin, lat_to[ctx.r_idx], np.inf)
        topo.lat[i, i] = 0.0
        topo.ibw[i, :] = np.where(fin, ibw_to[ctx.r_idx], 0.0)
        topo.ibw[i, i] = 0.0
        ue = np.unique(ctx.kord[pos])
        topo.fast[i] = (p, ue)
        topo.edge_ids.update(ctx.ord_ids[ue].tolist())

    def _route_from_fast(self, i: int, j: int) -> Optional[list]:
        """Materialize the concrete EdgeAttr route of pair ``(i, j)`` from
        fast row ``i``'s stored predecessor tree (first route_edges hit)."""
        fast = self._rt.fast.get(i)
        if fast is None:
            return None
        names, idx = self._node_space()
        s = idx[self.routable_names[i]]
        p = fast[0]
        seq = [idx[self.routable_names[j]]]
        while seq[-1] != s:
            a = int(p[seq[-1]])
            if a < 0:
                return None
            seq.append(a)
        seq.reverse()
        edges = [self._best_edge[(names[a], names[b])]
                 for a, b in zip(seq, seq[1:])]
        rt = self._rt
        rt.routes[(i, j)] = edges
        rt.edge_ids.update(id(e) for e in edges)
        return edges

    def _rebuild_route_row(self, i: int) -> None:
        """(Re)compute all routes from source ``i`` against the current
        authoring graph — the unit of materialization without scipy."""
        g = self.graph
        topo = self._rt.topo          # write-through (see _fill_fast_row)
        src = self.routable_names[i]
        topo.lat[i, :] = np.inf
        topo.lat[i, i] = 0.0
        topo.ibw[i, :] = 0.0
        for j in range(len(self.routable_names)):
            topo.routes.pop((i, j), None)
        topo.fast.pop(i, None)
        topo.built[i] = True
        g.route_row_builds += 1
        if not g._adj[src]:
            return
        dist, pred = g.sssp(src)
        for j, dst in enumerate(self.routable_names):
            if i == j or dst not in dist:
                continue
            seq = [dst]
            while seq[-1] != src:
                seq.append(pred[seq[-1]])
            seq.reverse()
            edges = [self._best_edge[(a, b)] for a, b in zip(seq, seq[1:])]
            topo.routes[(i, j)] = edges
            topo.edge_ids.update(id(e) for e in edges)
            topo.lat[i, j] = sum(e.latency for e in edges)
            bw = min((e.bandwidth for e in edges), default=float("inf"))
            topo.ibw[i, j] = 0.0 if bw == float("inf") else 1.0 / bw

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def device_name(self, name: str) -> str:
        """Enclosing device-group name (precomputed for PUs)."""
        dev = self._pu_device_name.get(name)
        if dev is None:
            return self.graph.device_of(name).name
        return dev

    def nearest_common_resource(self, pu_a: str, pu_b: str) -> Optional[str]:
        """First resource on ``pu_a``'s compute path also on ``pu_b``'s."""
        i = self.pu_index.get(pu_a)
        j = self.pu_index.get(pu_b)
        if i is None or j is None:
            # non-PU queries keep the object-path semantics
            g = self.graph
            pa = self.compute_paths[i] if i is not None else g.resource_path(pu_a)
            pb = set(self.compute_paths[j] if j is not None
                     else g.resource_path(pu_b))
            return next((r for r in pa if r in pb), None)
        r = host_item(self.ncr_res[i, j])
        return self.resource_names[r] if r >= 0 else None

    def transfer_time(self, src: str, dst: str, nbytes: float) -> float:
        """Parity twin of ``HWGraph.transfer_time`` (KeyError when no path)."""
        if src == dst:
            return 0.0
        i = self.routable_index.get(src)
        j = self.routable_index.get(dst)
        if i is None or j is None:
            return self.graph.transfer_time(src, dst, nbytes)
        self._ensure_row(i)
        lat = self._rt.lat[i, j]
        if not np.isfinite(lat):
            raise KeyError(f"no path {src} -> {dst}")
        return float(lat + (nbytes * self._rt.ibw_row(i)[j]
                            if nbytes > 0 else 0.0))

    def route_edges(self, src: str, dst: str) -> list[EdgeAttr]:
        """The shortest-path interconnects src -> dst (shared EdgeAttr refs,
        so concurrent transfers keep contending on the same objects)."""
        i = self.routable_index.get(src)
        j = self.routable_index.get(dst)
        if i is None or j is None:
            return self.graph.route_edges(src, dst)
        if i == j:
            return []
        self._ensure_row(i)
        edges = self._rt.routes.get((i, j))
        if edges is None and np.isfinite(self._rt.lat[i, j]):
            edges = self._route_from_fast(i, j)
        if edges is None:
            raise KeyError(f"no path {src} -> {dst}")
        return edges

    # ------------------------------------------------------------------
    # incremental snapshot deltas (deaths / revivals / bandwidth changes)
    # ------------------------------------------------------------------
    def apply_delta(self, kind: str, names=(), edge_name: Optional[str] = None,
                    edge_names: Sequence[str] = (),
                    ) -> Optional["CompiledHWGraph"]:
        """Patch this snapshot into a *new* snapshot reflecting one
        authoring-layer mutation (already applied to ``self.graph``),
        without a full recompile.

        Returns a copy-on-write clone — only the state the mutation
        touches is copied, device columns included — or ``None`` when the
        effects exceed what can be patched (the caller then rebuilds).
        ``kind="set_bandwidth"`` takes many links at once (``edge_names``:
        a ``Churn`` bandwidth batch pays one overlay copy) and never
        copies the topology layer.  Where several equal-latency shortest
        paths exist, a patched route may differ from the one a fresh
        search would pick; latency is exact either way."""
        if kind == "set_bandwidth":
            en = tuple(edge_names) or ((edge_name,) if edge_name else ())
            return self._delta_bandwidth(en)
        if kind in ("mark_dead", "mark_alive"):
            return self._delta_alive(kind == "mark_alive", set(names))
        return None

    def _clone(self) -> "CompiledHWGraph":
        c = object.__new__(CompiledHWGraph)
        c.__dict__.update(self.__dict__)
        c.version = self.version + 1
        # the batched-builder ctx bakes in aliveness; re-derive post-delta
        c.__dict__.pop("_fast_route_ctx", None)
        return c

    def _delta_bandwidth(self, edge_names: Sequence[str],
                         ) -> "CompiledHWGraph":
        # Shortest-path selection weighs latency only, so routes never
        # change with bandwidth; the EdgeAttr objects are shared with the
        # authoring layer, so route_edges already sees the new values.
        # Only the effective inverse bandwidth of *built* rows crossing a
        # changed link needs repair, and it lives in the private overlay:
        # the topology layer stays shared (route_holder_copies stays 0)
        # and no device column is touched.
        g = self.graph
        names = set(edge_names)
        rt = self._rt
        # overlay compaction (bounded shadows on long serving runs): once
        # the dirty-link set is large and no other snapshot shares the
        # topology layer, fold the overlay into it
        if (len(rt.dirty) >= _OVERLAY_COMPACT_DIRTY
                and len(rt.topo.owners) == 1):
            rt.compact()
            g.route_overlay_compactions += 1
        c = self._clone()
        changed_ids = {id(e) for adj in g._adj.values() for _, e in adj
                       if e.name in names}
        if not (changed_ids & rt.edge_ids):
            return c          # no built route crosses a changed link:
                              # share both layers untouched
        c._rt = rt = rt.overlay_clone()
        g.route_overlay_copies += 1
        rt.dirty.update(names)
        topo = rt.topo
        # rows privately owned by *this* delta (safe to mutate in place);
        # rows inherited from the parent overlay stay shared until copied
        fresh: set[int] = set()
        replayed: set[int] = set()
        if topo.fast:
            # a fast-built row whose shortest-path tree crosses a changed
            # link is replayed against the live bandwidths into a private
            # overlay row (the stored tree stays valid: no search, no
            # shared-state mutation)
            name_ords = np.asarray(
                [o for o, e in enumerate(self._edge_ord_edges())
                 if e.name in names], dtype=np.int64)
            if name_ords.size:
                ctx = c._fast_ctx()
                for i, (p, eords) in topo.fast.items():
                    if bool(np.isin(name_ords, eords).any()):
                        rt.over[i] = c._overlay_row_from_tree(i, p, ctx)
                        fresh.add(i)
                        replayed.add(i)
        # materialized routes are authoritative per pair: repair every
        # pair crossing a changed link, and *all* materialized pairs of
        # tree-replayed rows (a revival-mirror pair is materialized but
        # invisible to the stored tree, so the replay zeroed it)
        for (i, j), edges in topo.routes.items():
            if not (i in replayed or any(e.name in names for e in edges)):
                continue
            row = rt.over.get(i)
            if i not in fresh:
                row = rt.over[i] = (row.copy() if row is not None
                                    else topo.ibw[i].copy())
                fresh.add(i)
            bw = min((e.bandwidth for e in edges), default=float("inf"))
            row[j] = 0.0 if bw == float("inf") else 1.0 / bw
        return c

    def _overlay_row_from_tree(self, i: int, p: np.ndarray,
                               ctx: _FastRouteCtx) -> np.ndarray:
        """Effective inverse-bandwidth row ``i`` replayed from the stored
        shortest-path tree against the live edge bandwidths — the same
        running max of reciprocals as ``_fill_fast_row``.  Hops into
        nodes that died since the row was built gather nothing (their
        columns were wiped, and the finite-latency mask zeroes them)."""
        topo = self._rt.topo
        row = np.zeros(len(self.routable_names))
        vs = np.flatnonzero(p >= 0)
        if not vs.size or not ctx.keys.size:
            return row
        s = int(ctx.idx[self.routable_names[i]])
        pv = p[vs].astype(np.int64)
        key = pv * ctx.N + vs
        pos = np.searchsorted(ctx.keys, key).clip(0, len(ctx.keys) - 1)
        eb = np.where(ctx.keys[pos] == key, ctx.hibw[pos], 0.0)
        ibw_to = np.zeros(ctx.N)
        known = np.zeros(ctx.N, dtype=bool)
        known[s] = True
        rem = np.arange(vs.size)
        while rem.size:
            ready = known[pv[rem]]
            sel = rem[ready]
            v = vs[sel]
            ibw_to[v] = np.maximum(ibw_to[pv[sel]], eb[sel])
            known[v] = True
            rem = rem[~ready]
        fin = known[ctx.r_idx] & np.isfinite(topo.lat[i, :])
        row[:] = np.where(fin, ibw_to[ctx.r_idx], 0.0)
        row[i] = 0.0
        return row

    def _delta_alive(self, alive: bool,
                     names: set) -> Optional["CompiledHWGraph"]:
        g = self.graph
        c = self._clone()
        # -- PU aliveness: a fresh device column, patched ----------------
        rows = [self.pu_index[n] for n in names if n in self.pu_index]
        c.pu_alive = self.pu_alive.clone()
        if rows:
            c.pu_alive[torch.as_tensor(rows, device=self.device)] = alive
        # -- compute-path effects of dead/revived resources --------------
        # (ABSTRACT nodes are included conservatively: they could sit on
        # an intra-device shortest path even though they never appear in
        # the STORAGE/CONTROLLER path lists themselves)
        res_nodes = [n for n in names if g.nodes[n].kind in
                     (NodeKind.STORAGE, NodeKind.CONTROLLER, NodeKind.ABSTRACT)]
        if res_nodes:
            res_devs = {self.device_name(n) for n in res_nodes}
            stale = [i for i, p in enumerate(self.pu_names)
                     if self._pu_device_name[p] in res_devs]
            if not alive:
                # a resource dying under still-alive PUs re-routes their
                # compute paths: only the whole-subtree case is patchable
                # (the stale NCR entries then belong to dead PUs, which
                # eligibility masks filter; revival recomputes them)
                if stale and bool(host_item(c.pu_alive[torch.as_tensor(
                        stale, device=self.device)].any())):
                    return None
            elif stale:
                c._refresh_ncr(stale)
        # -- transfer routes --------------------------------------------
        if not c._patch_routes(alive, names):
            return None
        return c

    def _rclass_of(self, ncr: torch.Tensor) -> torch.Tensor:
        return torch.where(ncr >= 0,
                           self.resource_rclass[ncr.clamp(min=0).long()],
                           -1).to(torch.int16)

    def _refresh_ncr(self, rows: list) -> None:
        """Recompute compute paths + NCR rows/columns for ``rows`` (PUs of
        devices whose resources were revived), extending the resource
        space when the snapshot was first built while they were dead.
        Every device column touched here is a fresh copy."""
        g = self.graph
        dev = self.device
        new_paths: dict[int, list[str]] = {}
        for i in rows:
            node = g.nodes[self.pu_names[i]]
            new_paths[i] = (node.get_compute_path()
                            if isinstance(node, ProcessingUnit)
                            else g.resource_path(self.pu_names[i]))
        # copy-on-write for everything this repair mutates
        self.compute_paths = list(self.compute_paths)
        self.resource_names = list(self.resource_names)
        self.resource_index = dict(self.resource_index)
        self.rclass_names = list(self.rclass_names)
        rclass_index = {rc: k for k, rc in enumerate(self.rclass_names)}
        fresh = [r for p in new_paths.values() for r in p
                 if r not in self.resource_index]
        if fresh:
            res_rclass = host_list(self.resource_rclass)
            for r in dict.fromkeys(fresh):
                self.resource_index[r] = len(self.resource_names)
                self.resource_names.append(r)
                rc = g.nodes[r].attrs.get("rclass", "dram")
                if rc not in rclass_index:
                    rclass_index[rc] = len(self.rclass_names)
                    self.rclass_names.append(rc)
                res_rclass.append(rclass_index[rc])
            self.resource_rclass = torch.as_tensor(
                np.asarray(res_rclass, dtype=np.int64), device=dev)
        P = len(self.pu_names)
        R = len(self.resource_names)
        mask = torch.zeros((P, R), dtype=torch.bool, device=dev)
        mask[:, :self.path_mask.shape[1]] = self.path_mask
        self.path_mask = mask
        self.ncr_res = ncr = self.ncr_res.clone()
        for i, path in new_paths.items():
            self.compute_paths[i] = path
            mask[i, :] = False
            if path:
                mask[i, torch.as_tensor([self.resource_index[r]
                                         for r in path], device=dev)] = True
        for i in rows:                       # rows of the refreshed PUs
            row = torch.full((P,), -1, dtype=ncr.dtype, device=dev)
            unset = torch.ones(P, dtype=torch.bool, device=dev)
            for r in new_paths[i]:
                ri = self.resource_index[r]
                hit = unset & mask[:, ri]
                row = torch.where(hit, ri, row)
                unset &= ~hit
            ncr[i, :] = row
        # columns of the refreshed PUs: -1 wherever the other PU's path
        # shares no resource with any refreshed path, so only the PUs
        # whose paths meet one of those resources are scanned
        rowset = set(rows)
        cols = torch.as_tensor(rows, device=dev)
        others = [j for j in range(P) if j not in rowset]
        if others:
            ncr[torch.as_tensor(others, device=dev)[:, None],
                cols[None, :]] = -1
        touched = {r for p in new_paths.values() for r in p}
        for j in others:
            path = self.compute_paths[j]
            if touched.isdisjoint(path):
                continue
            val = torch.full((len(rows),), -1, dtype=ncr.dtype, device=dev)
            unset = torch.ones(len(rows), dtype=torch.bool, device=dev)
            for r in path:
                ri = self.resource_index[r]
                hit = unset & mask[cols, ri]
                val = torch.where(hit, ri, val)
                unset &= ~hit
            ncr[j, cols] = val
        self.ncr_rclass = ncr_rc = self.ncr_rclass.clone()
        ncr_rc[cols, :] = self._rclass_of(ncr[cols, :])
        ncr_rc[:, cols] = self._rclass_of(ncr[:, cols])

    def _patch_routes(self, alive: bool, names: set) -> bool:
        """Repair the route table after an aliveness flip of ``names``.

        Death keeps the table warm: endpoints into the dead subtree
        become unroutable; built routes *transiting* the subtree fall
        back to lazy.  Revival invalidates exactly the built rows whose
        routes can change: the revived sources themselves, rows a
        boundary-node scan shows could improve through the revived
        subtree, and rows of still-dead sources the scan cannot see."""
        g = self.graph
        if alive:
            # private topology copy (overlay flattened): aliveness repair
            # mutates lat/routes/built in place, which is only legal on
            # an owned topology layer
            self._rt = rt = self._rt.copy()
            g.route_holder_copies += 1
            r_s = sorted(self.routable_index[n] for n in names
                         if n in self.routable_index)
            for r in r_s:                # rows of revived sources (eager:
                self._rebuild_route_row(r)   # their columns mirror below)
            # mirror into the revived columns of built rows: undirected
            # fabric, so the reverse of a fresh shortest path is exact
            built = np.nonzero(rt.built)[0]
            for r in r_s:
                for j in built.tolist():
                    if j == r or j in r_s:
                        continue
                    lat = rt.lat[r, j]
                    if np.isfinite(lat):
                        rt.routes[(j, r)] = list(
                            reversed(rt.routes[(r, j)]))
                        rt.lat[j, r] = lat
                        rt.topo.ibw[j, r] = rt.topo.ibw[r, j]
                    else:
                        rt.routes.pop((j, r), None)
                        rt.lat[j, r] = np.inf
                        rt.topo.ibw[j, r] = 0.0
            # transit improvements: a new shortest path through the
            # revived subtree must pass one of its boundary nodes — one
            # search per boundary node flags exactly the built rows that
            # can improve; they fall back to lazy
            invalid: set[int] = set()
            boundary = [n for n in names
                        if any(v not in names and g.nodes[v].alive
                               for v, _ in g._adj.get(n, ()))]
            for b in boundary:
                dist, _ = g.sssp(b)
                d = np.array([dist.get(nm, np.inf)
                              for nm in self.routable_names])
                thru = d[:, None] + d[None, :]
                with np.errstate(invalid="ignore"):
                    imp = np.nonzero((thru < rt.lat).any(axis=1))[0]
                invalid.update(int(i) for i in imp if i not in r_s)
            # rows of still-dead sources are invisible to the boundary
            # scan (a dead node is unreachable as a destination but still
            # routes outward as a source)
            for j, nm in enumerate(self.routable_names):
                if j not in r_s and not g.nodes[nm].alive:
                    invalid.add(j)
            for i in invalid:
                if rt.built[i]:
                    self._invalidate_row(i)
            return True
        rt = self._rt
        # eid -> the subtree endpoints of that edge: a route *transits* the
        # subtree iff it crosses an edge owned by a node that is not one of
        # the route's own endpoints
        eid_owners: dict[int, set] = {}
        for n in names:
            for _, e in g._adj.get(n, ()):
                eid_owners.setdefault(id(e), set()).add(n)
        touched = set(eid_owners) & rt.edge_ids
        r_s = {self.routable_index[n] for n in names
               if n in self.routable_index}
        if not touched and not r_s:
            return True      # a node no built route crosses died
        self._rt = rt = rt.copy()    # private topology copy (see above)
        g.route_holder_copies += 1
        # endpoints into the dead subtree become unroutable; routes *from*
        # dead sources stay valid (the search explores outward from them)
        stale: set[int] = set()
        for (i, j), edges in list(rt.routes.items()):
            if j in r_s:
                del rt.routes[(i, j)]
                continue
            si, sj = self.routable_names[i], self.routable_names[j]
            for e in edges:
                owners = eid_owners.get(id(e))
                if owners and not owners <= {si, sj}:
                    stale.add(i)
                    break
        if r_s:
            cols = sorted(r_s)
            rt.lat[:, cols] = np.inf
            rt.topo.ibw[:, cols] = 0.0
            for r in cols:
                rt.lat[r, r] = 0.0
        for i in stale:
            self._invalidate_row(i)
        # fast rows: unmaterialized pairs transiting the dead subtree are
        # exactly those whose predecessor chain passes a dead node as an
        # interior tree node (a dead *source* keeps routing outward)
        if rt.fast:
            _, idx = self._node_space()
            da = np.asarray([idx[n] for n in names if n in idx],
                            dtype=np.int64)
            if da.size:
                for i, (p, _) in list(rt.fast.items()):
                    si = idx[self.routable_names[i]]
                    hit = da[np.isin(da, p)]
                    if any(int(x) != si for x in hit):
                        self._invalidate_row(i)
        return True

    def _invalidate_row(self, i: int) -> None:
        """Return row ``i`` to the unbuilt state (rebuilt on next access).
        Only ever called on a privately owned topology layer."""
        rt = self._rt
        rt.built[i] = False
        rt.lat[i, :] = np.inf
        rt.lat[i, i] = 0.0
        rt.topo.ibw[i, :] = 0.0
        for j in range(len(self.routable_names)):
            rt.routes.pop((i, j), None)
        rt.fast.pop(i, None)
        rt.over.pop(i, None)

    def summary(self) -> str:
        P = len(self.pu_names)
        return (f"CompiledHWGraph({P} PUs, {len(self.resource_names)} resources, "
                f"{len(self.rclass_names)} rclasses, "
                f"{len(self.routable_names)} routable, v{self.version})")
