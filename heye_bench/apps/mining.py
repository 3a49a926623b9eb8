"""The mining application (the H-EYE paper, section 4): smart sensors
attached to the edges round-robin, weighted by each edge's computing
capability; each reading of a sensor spawns the configuration's tasks
(SVM, KNN and MLP), each with the reading's deadline.

Every number comes from the configuration's ``application`` group; the
program's tasks and the reference's are built from the same list.
"""
from __future__ import annotations

from heye_bench.reference.fleet import TaskMaker


def sensor_edges(cfg: dict) -> list:
    """The edge (its index among the deployment's edges, in build order)
    of each sensor: the weighted ring, one slot per sensor."""
    app = cfg["application"]
    ring = []
    i = 0
    for kind, count in cfg["deployment"]["edge_counts"].items():
        for _ in range(count):
            ring += [i] * app["ring_weights"].get(kind, 1)
            i += 1
    return [ring[s % len(ring)] for s in range(app["sensors"])]


def sources(cfg: dict) -> list:
    """(edge index, seconds between readings) per sensor."""
    period = 1.0 / cfg["application"]["hz"]
    return [(e, period) for e in sensor_edges(cfg)]


def _specs(cfg: dict, edge: int, release: float) -> list:
    app = cfg["application"]
    return [(kind, edge, app["deadline_s"], app["input_bytes"],
             app["output_bytes"], release) for kind in app["tasks"]]


def session_specs(cfg: dict, scale: float = 1.0) -> list:
    """Every task of ``readings`` readings of each sensor (``scale`` < 1
    keeps that share of the sensors), sensor by sensor."""
    app = cfg["application"]
    edges = sensor_edges(cfg)
    n = max(1, int(len(edges) * scale))
    return [s for e in edges[:n] for r in range(app["readings"])
            for s in _specs(cfg, e, r / app["hz"])]


# -- the program's side ----------------------------------------------------
def _graph(core, tb, name: str, specs: list):
    g = core.TaskGraph(name)
    for kind, edge, deadline, nin, nout, release in specs:
        g.add(core.make_task(kind, origin=tb.edges[edge], deadline=deadline,
                             input_bytes=nin, output_bytes=nout,
                             release_time=release))
    return g


def program_session(core, tb, cfg: dict, scale: float = 1.0):
    return _graph(core, tb, "mining", session_specs(cfg, scale))


def program_request(core, tb, cfg: dict, edge: int, t: float):
    """One reading, sent from ``edge`` at ``t``, as the program's graph."""
    return _graph(core, tb, "reading", _specs(cfg, edge, t))


# -- the reference's side --------------------------------------------------
def _tasks(fl, mk: TaskMaker, specs: list) -> list:
    return [mk.make(kind, fl.edges[edge], deadline, nin, nout, release)
            for kind, edge, deadline, nin, nout, release in specs]


def reference_session(fl, cfg: dict) -> list:
    return _tasks(fl, TaskMaker(), session_specs(cfg))


def reference_request(fl, mk: TaskMaker, cfg: dict, edge: int,
                      t: float) -> list:
    return _tasks(fl, mk, _specs(cfg, edge, t))
