"""State carried across: build the port's objects from plain descriptions.

A *spec* holds only Python scalars, strings, lists/dicts and numpy arrays,
so it can be written by anything — in particular by an exporter that reads
a graph, snapshot or ledger of the reference package (that exporter
imports the reference and therefore lives with the tests, not here).

* :func:`graph_from_spec` — an ``HWGraph`` from nodes (kind / attrs /
  parent / aliveness, PUs with tenancy and a model key), edges
  (bandwidth / latency / name) and per-key ``ProfiledModel`` tables.  ORC
  groups travel as the nodes' ``attrs["orc_level"]``.
* :func:`tasks_from_spec` — a ``TaskGraph`` from task records and
  dependency index pairs.
* :func:`snapshot_from_numpy` — a ``CompiledHWGraph`` whose PU-space and
  NCR tensors are loaded from arrays instead of being recomputed.
* :func:`ledger_from_numpy` — an ``ActiveLedger`` loaded from columns.
* :func:`params_from_numpy` — a model's parameter tree (the reference's
  layout, superblocks stacked) from numpy leaves.

Every function takes ``device=`` with the package's rule: CUDA unless
``"cpu"`` is asked for, and an exception when CUDA is absent.
"""
from __future__ import annotations

import threading
from typing import Any, Optional, Sequence

import numpy as np
import torch

from .core.compiled import CompiledHWGraph
from .core.hwgraph import HWGraph, Node, NodeKind, ProcessingUnit
from .core.orchestrator import ActiveLedger
from .core.predict import ProfiledModel
from .core.task import Task, TaskGraph
from .device import BOOL, FLOAT, INT, DeviceLike, resolve_device
from .models import transformer as tf


def graph_from_spec(spec: dict, device: DeviceLike = None) -> HWGraph:
    """Build an ``HWGraph`` from a plain description.

    ``spec["models"]``: ``{key: {"table": [(task_kind, pu_or_class,
    seconds), ...], "scaling": "linear"|"const"}}``.
    ``spec["nodes"]``: dicts with ``name``, ``kind`` (a ``NodeKind``
    value), optional ``parent``, ``attrs``, ``alive``; PUs add
    ``pu=True``, ``max_tenancy`` and ``model`` (a key of ``models`` or
    ``None``).  ``spec["edges"]``: dicts with ``u``, ``v``,
    ``bandwidth``, ``latency``, ``name``, optional ``attrs``.  Insertion
    order is kept: it defines the PU and device index spaces."""
    device = resolve_device(device)
    models: dict[str, ProfiledModel] = {}
    for key, m in spec.get("models", {}).items():
        table = {(str(k), str(c)): float(s) for k, c, s in m["table"]}
        models[key] = ProfiledModel(table=table,
                                    scaling=m.get("scaling", "linear"))
    g = HWGraph(device=device)
    for nd in spec["nodes"]:
        attrs = dict(nd.get("attrs") or {})
        if nd.get("pu"):
            mk = nd.get("model")
            node: Node = ProcessingUnit(
                nd["name"], model=models[mk] if mk is not None else None,
                max_tenancy=int(nd.get("max_tenancy", 8)), attrs=attrs,
                parent=nd.get("parent"))
        else:
            node = Node(nd["name"], NodeKind(nd["kind"]), attrs=attrs,
                        parent=nd.get("parent"))
        node.alive = bool(nd.get("alive", True))
        g.add_node(node)
    for e in spec.get("edges", ()):
        g.add_edge(e["u"], e["v"], bandwidth=float(e["bandwidth"]),
                   latency=float(e["latency"]), name=e.get("name", ""),
                   attrs=e.get("attrs"))
    for detailed, abstract in spec.get("abstraction", ()):
        g.add_abstraction_link(detailed, abstract)
    return g


def tasks_from_spec(spec: dict) -> TaskGraph:
    """Build a ``TaskGraph`` from ``{"name", "tasks": [...], "deps":
    [(producer_index, consumer_index), ...]}``; task records carry the
    ``Task`` fields (``uid`` optional: kept when given)."""
    cfg = TaskGraph(spec.get("name", "cfg"))
    made: list[Task] = []
    for rec in spec["tasks"]:
        kw: dict[str, Any] = dict(
            kind=rec["kind"], size=float(rec.get("size", 1.0)),
            deadline=rec.get("deadline"),
            input_bytes=float(rec.get("input_bytes", 0.0)),
            output_bytes=float(rec.get("output_bytes", 0.0)),
            origin=rec.get("origin"), usage=dict(rec.get("usage") or {}),
            attrs=dict(rec.get("attrs") or {}))
        if rec.get("uid") is not None:
            kw["uid"] = int(rec["uid"])
        t = Task(**kw)
        t.release_time = float(rec.get("release_time", 0.0))
        cfg.add(t)
        made.append(t)
    for p, c in spec.get("deps", ()):
        cfg.add_dep(made[p], made[c])
    return cfg


def snapshot_from_numpy(arrays: dict, device: DeviceLike = None,
                        graph: Optional[HWGraph] = None) -> CompiledHWGraph:
    """Load a snapshot's PU-space and NCR arrays into a ``CompiledHWGraph``.

    ``arrays`` holds ``pu_names``, ``pu_alive``, ``mem_cap``,
    ``max_tenancy``, ``pu_class_kind``, ``pu_device`` (device name per
    PU), ``dev_ord_names``, ``pu_dev_ord``, ``resource_names``,
    ``rclass_names``, ``resource_rclass``, ``path_mask``, ``ncr_res``,
    ``ncr_rclass`` (and optionally ``compute_paths``).  With ``graph``
    (a port ``HWGraph`` of the same topology) the route tables are set
    up against it and the snapshot is installed as its current one;
    without it the snapshot carries the tensors only."""
    dev = resolve_device(device if graph is None or device is not None
                         else graph.device)
    comp = object.__new__(CompiledHWGraph)
    comp.graph = graph
    comp.device = dev
    comp.version = 0
    comp.pu_names = [str(n) for n in arrays["pu_names"]]
    comp.pu_index = {n: i for i, n in enumerate(comp.pu_names)}
    comp.pu_class_kind = [str(k) for k in arrays["pu_class_kind"]]
    comp.pu_device = [str(d) for d in arrays["pu_device"]]
    comp._pu_device_name = dict(zip(comp.pu_names, comp.pu_device))
    comp.dev_ord_names = [str(d) for d in arrays["dev_ord_names"]]
    comp.dev_ord = {d: i for i, d in enumerate(comp.dev_ord_names)}
    ords = np.asarray(arrays["pu_dev_ord"], dtype=np.int64)
    comp.pu_dev_ord_l = ords.tolist()

    def put(name: str, dtype) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(arrays[name]),
                               device=dev).to(dtype)

    comp.pu_alive = put("pu_alive", BOOL)
    comp.mem_cap = put("mem_cap", FLOAT)
    comp.max_tenancy = put("max_tenancy", INT)
    comp.pu_dev_ord = torch.as_tensor(ords, device=dev)
    comp.resource_names = [str(r) for r in arrays["resource_names"]]
    comp.resource_index = {r: i for i, r in enumerate(comp.resource_names)}
    comp.rclass_names = [str(r) for r in arrays["rclass_names"]]
    comp.resource_rclass = put("resource_rclass", INT)
    comp.path_mask = put("path_mask", BOOL)
    comp.ncr_res = put("ncr_res", torch.int32)
    comp.ncr_rclass = put("ncr_rclass", torch.int16)
    comp.compute_paths = [list(p) for p in arrays.get("compute_paths", ())]
    comp._rt_lock = threading.RLock()
    if graph is not None:
        comp._build_routes()
        graph._compiled = comp
    return comp


def ledger_from_numpy(columns: dict, device: DeviceLike = None,
                      comp: Optional[CompiledHWGraph] = None) -> ActiveLedger:
    """Load live ledger rows into an ``ActiveLedger``.

    ``columns`` holds ``tasks`` (the port's ``Task`` objects, one per
    row), ``pus`` (PU names) and the numeric columns ``est``, ``fac``,
    ``dl``, ``upu``, ``umem``, ``uid``.  With ``comp`` the ledger learns
    every PU's device, so later commits bump per-device versions."""
    dev = resolve_device(device if comp is None or device is not None
                         else comp.device)
    led = ActiveLedger(dev)
    tasks: Sequence[Task] = list(columns["tasks"])
    pus = [str(p) for p in columns["pus"]]
    n = len(tasks)
    if len(pus) != n:
        raise ValueError("tasks and pus must have one length")
    cols = []
    for name, dtype in (("est", FLOAT), ("fac", FLOAT), ("dl", FLOAT),
                        ("upu", FLOAT), ("umem", FLOAT), ("uid", INT)):
        arr = np.ascontiguousarray(columns[name])
        if arr.shape != (n,):
            raise ValueError(f"column {name} must have shape ({n},)")
        cols.append(torch.as_tensor(arr, device=dev).to(dtype))
    led._set_columns(cols + [torch.full((n,), -1, dtype=INT, device=dev),
                             torch.ones(n, dtype=BOOL, device=dev)])
    led._live_l = [True] * n
    led._tasks = list(tasks)
    led._pus = pus
    led._n = n
    for p in pus:
        led._count[p] = led._count.get(p, 0) + 1
    led.version = n
    if comp is not None:
        led._pu_dev.update(comp._pu_device_name)
        led._fill_pu_idx(comp)
    return led


def params_from_numpy(cfg, tree: dict, device: DeviceLike = None) -> dict:
    """The port's parameters for ``cfg`` from the reference's parameter
    tree with numpy leaves (``jax.tree.map(np.asarray, params)``): the same
    dicts and tuples, ``{"blocks": tuple of P dicts with a leading n_super
    axis, "rem": tuple}`` under ``"stack"`` (and, for an encoder-decoder,
    under ``"encoder"``, beside ``"enc_norm"``), each leaf a float32
    tensor on ``device``.  Every layer's mixer (``attn`` / ``rglru`` /
    ``rwkv``), feed-forward (``mlp`` / ``moe``) and cross-attention
    (``cross`` / ``norm_x``) must be where ``cfg``'s stack puts them;
    raises ``ValueError`` where they are not."""
    dev = resolve_device(device)
    stacks = [("stack", tf.stack_meta(cfg))]
    if cfg.is_encdec:
        stacks.append(("encoder", tf.stack_meta(
            cfg, n_layers=cfg.encoder_layers, pattern_override=("enc",))))
        if "enc_norm" not in tree:
            raise ValueError(f"{cfg.name}: no 'enc_norm' beside the encoder")
    for key, sm in stacks:
        if key not in tree:
            raise ValueError(f"{cfg.name}: no {key!r} in the tree")
        _check_stack(cfg, key, sm, tree[key])

    def leaf(a) -> torch.Tensor:
        return torch.tensor(np.asarray(a, dtype=np.float32), device=dev)

    return tf.tree_map(leaf, tree)


def _check_stack(cfg, key: str, sm, stack: dict) -> None:
    blocks, rem = stack["blocks"], stack["rem"]
    n_blocks = sm.P if sm.n_super > 0 else 0
    if len(blocks) != n_blocks or len(rem) != sm.remainder:
        raise ValueError(f"{key} layout: {len(blocks)} stacked / {len(rem)} "
                         f"remainder layers, expected {n_blocks} / "
                         f"{sm.remainder} for {cfg.name}")
    for metas, layers, lead in ((sm.metas, blocks, sm.n_super),
                                (sm.rem_metas, rem, None)):
        for meta, layer in zip(metas, layers):
            missing = [k for k in tf.layer_groups(meta) if k not in layer]
            if missing:
                raise ValueError(f"a {meta['kind']} layer of {key} without "
                                 f"{missing} parameters")
            if lead is not None:
                tf.tree_map(lambda a: _check_lead(a, lead), layer)


def _check_lead(a, n_super: int) -> None:
    if np.shape(a)[:1] != (n_super,):
        raise ValueError(f"stacked leaf of shape {np.shape(a)}: expected a "
                         f"leading axis of {n_super} superblocks")
