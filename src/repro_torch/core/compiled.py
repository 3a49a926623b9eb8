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
  scalar or a short row at a time by the control plane.  It is a single
  layer here — the copy-on-write topology/bandwidth layering that
  absorbs churn deltas belongs to a later slice; in this one a mutation
  of the graph drops the whole snapshot.

``HWGraph.compiled()`` returns the current snapshot.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from ..device import host_item
from .hwgraph import EdgeAttr, HWGraph, NodeKind, ProcessingUnit


class _RouteTable:
    """Dense latency / inverse-bandwidth matrices over the routable
    (GROUP) nodes, the concrete ``EdgeAttr`` route lists, and per-row
    materialization state.  Host numpy: rows are filled lazily by
    shortest-path searches and read by the control plane."""

    __slots__ = ("lat", "ibw", "routes", "built", "edge_ids", "fast")

    def __init__(self, D: int) -> None:
        self.lat = np.full((D, D), np.inf)
        np.fill_diagonal(self.lat, 0.0)
        self.ibw = np.zeros((D, D))
        self.routes: dict[tuple[int, int], list[EdgeAttr]] = {}
        self.built = np.zeros(D, dtype=bool)
        self.edge_ids: set[int] = set()
        # rows built in batch: row -> (predecessor array
        # over the global node space, sorted crossed edge ordinals); their
        # EdgeAttr route lists materialize per pair on first access
        self.fast: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def ibw_row(self, i: int) -> np.ndarray:
        """Inverse-bandwidth row ``i``."""
        return self.ibw[i]

    def ibw_col(self, rows: np.ndarray, j: int) -> np.ndarray:
        """Inverse bandwidth of the pairs ``(rows, j)``."""
        return self.ibw[rows, j]


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
        topo = self._rt
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
        topo = self._rt
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
