"""Helpers shared by tests/test_torch_*.py: build the same fleet and the
same workload in the reference package (``repro``) and in the port
(``repro_torch``, on the CPU), and export a reference graph / snapshot /
ledger into the plain specs ``repro_torch.interop`` loads.

Only the tests import both packages; the port itself imports neither
``jax`` nor ``repro``."""
from __future__ import annotations

import numpy as np
import torch

import repro.core as R
import repro.core.workloads as Rwork
import repro_torch.core as T
import repro_torch.core.workloads as Twork

# the port's CPU tensors are a handful of elements: one intra-op thread, so
# several pytest workers do not oversubscribe the cores
torch.set_num_threads(1)

TOL = 1e-9      # finish times / factors / overheads, port vs reference


def mining_counts(mult: int) -> tuple[dict, dict]:
    """Fig. 13 mining fleet ratios per ``mult`` (12 sensors per mult)."""
    ec = {"orin_agx": 3 * mult, "xavier_agx": 3 * mult,
          "orin_nano": 2 * mult, "xavier_nx": 2 * mult}
    sc = {"server1": mult, "server2": mult, "server3": mult}
    return ec, sc


def make_testbeds(mult=None):
    """(reference testbed, port testbed on the CPU); ``mult=None`` is the
    default ``build_testbed()``."""
    if mult is None:
        return R.build_testbed(), T.build_testbed(device="cpu")
    ec, sc = mining_counts(mult)
    return (R.build_testbed(edge_counts=ec, server_counts=sc),
            T.build_testbed(edge_counts=ec, server_counts=sc, device="cpu"))


def workload(pkg_work, tb, kind: str, mult=None):
    if kind == "mining":
        return pkg_work.mining_workload(tb, n_sensors=12 * (mult or 1),
                                        n_readings=2)
    if kind == "vr":
        return pkg_work.vr_workload(tb, n_frames=2)
    raise ValueError(kind)


def session_pair(kind: str, mult=None, seed: int = 0):
    """Run ``SchedulerSession.run`` in both packages on equal inputs.
    Returns ((ref stats, ref cfg), (port stats, port cfg)); compare in
    cfg order, since task uids are process-global counters."""
    rtb, ttb = make_testbeds(mult)
    out = []
    for pkg, work, tb in ((R, Rwork, rtb), (T, Twork, ttb)):
        cfg = workload(work, tb, kind, mult)
        g = tb.graph
        root = pkg.build_orchestrators(g, pkg.heye_traverser(g))
        sess = pkg.SchedulerSession(
            g, root, truth=pkg.ground_truth_traverser(g, seed=seed))
        out.append((sess.run(cfg), cfg))
    return out[0], out[1]


def in_order(d: dict, cfg) -> list:
    return [d[t.uid] for t in cfg]


# ---------------------------------------------------------------------------
# exporters: reference objects -> plain specs (python scalars, strings, numpy)
# ---------------------------------------------------------------------------
def export_graph_spec(g) -> dict:
    """A reference ``HWGraph`` as the spec ``interop.graph_from_spec``
    takes.  Every PU of the testbeds shares one ``ProfiledModel``."""
    from repro.core.hwgraph import ProcessingUnit
    models: dict = {}
    model_key: dict = {}
    nodes = []
    for n in g.nodes.values():
        rec = dict(name=n.name, kind=n.kind.value, parent=n.parent,
                   attrs=dict(n.attrs), alive=bool(n.alive))
        if isinstance(n, ProcessingUnit):
            rec["pu"] = True
            rec["max_tenancy"] = int(n.max_tenancy)
            if n.model is None:
                rec["model"] = None
            else:
                key = model_key.get(id(n.model))
                if key is None:
                    key = model_key[id(n.model)] = f"m{len(model_key)}"
                    models[key] = dict(
                        table=[(k, c, float(s))
                               for (k, c), s in n.model.table.items()],
                        scaling=n.model.scaling)
                rec["model"] = key
        nodes.append(rec)
    edges = []
    seen = set()
    for u, adj in g._adj.items():
        for v, e in adj:
            if id(e) in seen:
                continue
            seen.add(id(e))
            edges.append(dict(u=u, v=v, bandwidth=float(e.bandwidth),
                              latency=float(e.latency), name=e.name,
                              attrs=dict(e.attrs)))
    return dict(nodes=nodes, edges=edges, models=models,
                abstraction=list(g.abstraction.items()))


def export_tasks_spec(cfg) -> dict:
    idx = {t.uid: i for i, t in enumerate(cfg.tasks)}
    tasks = [dict(kind=t.kind, size=t.size, deadline=t.deadline,
                  input_bytes=t.input_bytes, output_bytes=t.output_bytes,
                  origin=t.origin, usage=dict(t.usage), attrs=dict(t.attrs),
                  release_time=t.release_time) for t in cfg.tasks]
    deps = [(idx[p.uid], idx[t.uid]) for t in cfg.tasks for p in cfg.preds(t)]
    return dict(name=cfg.name, tasks=tasks, deps=deps)


SNAPSHOT_ARRAYS = ("pu_alive", "mem_cap", "max_tenancy", "pu_dev_ord",
                   "resource_rclass", "path_mask", "ncr_res", "ncr_rclass")


def export_snapshot_arrays(comp) -> dict:
    out = {k: np.asarray(getattr(comp, k)) for k in SNAPSHOT_ARRAYS}
    out.update(pu_names=list(comp.pu_names),
               pu_class_kind=list(comp.pu_class_kind),
               pu_device=[str(d) for d in comp.pu_device],
               dev_ord_names=list(comp.dev_ord_names),
               resource_names=list(comp.resource_names),
               rclass_names=list(comp.rclass_names),
               compute_paths=[list(p) for p in comp.compute_paths])
    return out


def export_ledger_columns(led, task_map: dict) -> dict:
    """Live rows of a reference ``ActiveLedger``; ``task_map`` maps a
    reference task uid to the port's counterpart ``Task``."""
    rows = [i for i in range(led._n) if led._live[i]]
    return dict(
        tasks=[task_map[led._tasks[i].uid] for i in rows],
        pus=[led._pus[i] for i in rows],
        est=led._est[rows].copy(), fac=led._fac[rows].copy(),
        dl=led._dl[rows].copy(), upu=led._upu[rows].copy(),
        umem=led._umem[rows].copy(),
        uid=np.asarray([task_map[led._tasks[i].uid].uid for i in rows],
                       dtype=np.int64))
