"""Workload generators: the paper's two applications as TaskGraphs.

Cloud-rendered VR (§4.1, Fig. 7): per frame, the serial CFG
  capture -> pose_pred -> render -> encode -> decode -> reproject -> display
with capture/display pinned to the edge device (they touch the camera and
panel) and the middle tasks free to run on any capable PU in the continuum.
Frames are generated at the device's target FPS; every task in a frame
carries the frame deadline (proportionally divided, as §5.3.2 describes).

Mining (§4.2, Fig. 8): each smart-sensor reading (10 Hz) spawns three
parallel ML tasks (SVM, KNN, MLP) that must all finish within 100 ms.

Wireless churn (§5.4.1 dynamic network conditions): a seeded schedule of
``Churn`` batches that degrades and recovers the edge devices' wireless
uplinks, for exercising the bandwidth-overlay delta path.
"""
from __future__ import annotations

import itertools
import random
from dataclasses import dataclass
from typing import Optional

from .hwgraph import Churn
from .task import Task, TaskGraph
from .topology import EDGE_FPS, KB, MB, MS, Testbed, make_task

VR_TASKS = ("capture", "pose_pred", "render", "encode", "decode",
            "reproject", "display")
# data volumes between consecutive VR stages (producer -> consumer)
VR_BYTES = {"capture": 48 * KB,       # camera frame features -> pose_pred
            "pose_pred": 4 * KB,      # predicted pose -> render
            "render": 1.5 * MB,       # raw frame -> encode (server-local usually)
            "encode": 250 * KB,       # compressed frame -> decode (crosses WAN)
            "decode": 1.5 * MB,       # raw frame -> reproject
            "reproject": 1.5 * MB,    # final frame -> display
            "display": 0.0}
# tasks that must stay on the originating edge device (camera / pose / panel)
VR_PINNED = ("capture", "reproject", "display")
_COMM_EST = 2.6 * MS     # planner's estimate of one edge<->server round leg


def _vr_plan_shares(edge_kind: str) -> dict[str, float]:
    """Per-task deadline shares (paper §5.3.2: 'we set the deadline of each
    task by proportionally dividing the performance on the edge device over
    the QoS requirement').

    Shares come from the best end-to-end PLAN: a 2-state DP over stage
    placement (edge vs server) that charges every transfer leg between
    consecutive stages — so a stage whose optimal placement implies pulling
    data across the WAN gets that comm time inside its share, instead of
    silently forcing the Orchestrator into raw-frame round trips."""
    from .topology import _VR_EDGE, _VR_SERVER  # digitized Fig. 9 tables

    def stage_cost(kind: str, side: str) -> float:
        if side == "edge":
            return min(_VR_EDGE[kind][edge_kind].values()) * MS
        if kind in VR_PINNED or kind not in _VR_SERVER:
            return float("inf")
        return min(min(p.values()) for p in _VR_SERVER[kind].values()) * MS

    def trans(prev_kind: str, a: str, b: str) -> float:
        return 0.0 if a == b else _COMM_EST * max(
            0.5, VR_BYTES[prev_kind] / (250 * KB))

    # DP over (stage, side): cost and backpointer
    INF = float("inf")
    cost = {("edge",): stage_cost(VR_TASKS[0], "edge")}
    dp = [{"edge": (stage_cost(VR_TASKS[0], "edge"), None),
           "server": (stage_cost(VR_TASKS[0], "server"), None)}]
    for i in range(1, len(VR_TASKS)):
        row = {}
        for side in ("edge", "server"):
            sc = stage_cost(VR_TASKS[i], side)
            best, arg = INF, None
            for prev in ("edge", "server"):
                c = dp[i - 1][prev][0]
                if c == INF or sc == INF:
                    continue
                tot = c + trans(VR_TASKS[i - 1], prev, side) + sc
                if tot < best:
                    best, arg = tot, prev
            row[side] = (best, arg)
        dp.append(row)
    # backtrack the optimal placement
    side = min(("edge", "server"), key=lambda s: dp[-1][s][0])
    sides = [side]
    for i in range(len(VR_TASKS) - 1, 0, -1):
        side = dp[i][side][1]
        sides.append(side)
    sides.reverse()
    plan: dict[str, float] = {}
    for i, kind in enumerate(VR_TASKS):
        c = stage_cost(kind, sides[i])
        if i > 0:
            c += trans(VR_TASKS[i - 1], sides[i - 1], sides[i])
        plan[kind] = c
    total = sum(plan.values())
    return {k: v / total for k, v in plan.items()}


def vr_frame(cfg: TaskGraph, edge: str, edge_kind: str, frame_idx: int,
             fps: Optional[float] = None,
             shares: Optional[dict[str, float]] = None) -> list[Task]:
    fps = fps or EDGE_FPS[edge_kind]
    period = 1.0 / fps
    release = frame_idx * period
    shares = shares or _vr_plan_shares(edge_kind)
    tasks: list[Task] = []
    prev: Optional[Task] = None
    for kind in VR_TASKS:
        t = make_task(kind, origin=edge,
                      deadline=shares[kind] * period,
                      input_bytes=(VR_BYTES[VR_TASKS[VR_TASKS.index(kind) - 1]]
                                   if kind != "capture" else 8 * KB),
                      output_bytes=VR_BYTES[kind],
                      release_time=release)
        t.attrs["frame"] = frame_idx
        t.attrs["period"] = period
        t.attrs["pinned"] = kind in VR_PINNED
        cfg.add(t, deps=[prev] if prev is not None else [])
        tasks.append(t)
        prev = t
    # mark tasks whose immediate successor is pinned to the origin device:
    # their output must travel back, which the Orchestrator charges upfront
    for a, b in zip(tasks, tasks[1:]):
        if b.attrs.get("pinned"):
            a.attrs["succ_pinned_bytes"] = a.output_bytes
    return tasks


def vr_frame_latencies(cfg: TaskGraph, timeline) -> dict[tuple[str, int], float]:
    """(edge, frame) -> end-to-end frame latency (capture release -> display)."""
    out: dict[tuple[str, int], float] = {}
    for t in cfg:
        if t.kind != "display":
            continue
        key = (t.origin or "", t.attrs["frame"])
        out[key] = timeline.finish[t.uid] - t.release_time
    return out


def vr_frame_qos_failure(cfg: TaskGraph, timeline) -> float:
    """Fraction of frames finishing after their period (the paper's §5.5
    metric: 'how many frames are processed later than the latency
    requirement')."""
    total, late = 0, 0
    for t in cfg:
        if t.kind != "display":
            continue
        total += 1
        lat = timeline.finish[t.uid] - t.release_time
        late += lat > t.attrs["period"] * (1 + 1e-9)
    return late / total if total else 0.0


def vr_workload(tb: Testbed, n_frames: int = 30,
                fps_override: Optional[dict[str, float]] = None) -> TaskGraph:
    cfg = TaskGraph("vr")
    for edge in tb.edges:
        kind = tb.edge_kind[edge]
        fps = (fps_override or {}).get(edge, EDGE_FPS[kind])
        for f in range(n_frames):
            vr_frame(cfg, edge, kind, f, fps=fps)
    return cfg


MINING_TASKS = ("svm", "knn", "mlp")
MINING_DEADLINE = 100 * MS
MINING_HZ = 10.0
SENSOR_BYTES = 64 * KB


def mining_reading(cfg: TaskGraph, edge: str, sensor_id: int,
                   reading_idx: int, hz: float = MINING_HZ) -> list[Task]:
    release = reading_idx / hz
    out = []
    for kind in MINING_TASKS:
        t = make_task(kind, origin=edge, deadline=MINING_DEADLINE,
                      input_bytes=SENSOR_BYTES, output_bytes=1 * KB,
                      release_time=release)
        t.attrs["sensor"] = sensor_id
        cfg.add(t)
        out.append(t)
    return out


def mining_workload(tb: Testbed, n_sensors: int, n_readings: int = 10,
                    hz: float = MINING_HZ) -> TaskGraph:
    """Sensors are attached to edges round-robin weighted by capability
    (paper: 'we initially connect each smart sensor to the edges based on
    edge device's computing capability')."""
    cfg = TaskGraph("mining")
    weights = {"orin_agx": 4, "xavier_agx": 3, "orin_nano": 2, "xavier_nx": 1}
    ring = list(itertools.chain.from_iterable(
        [e] * weights.get(tb.edge_kind[e], 1) for e in tb.edges))
    if not ring:
        ring = list(tb.edges)
    for s in range(n_sensors):
        edge = ring[s % len(ring)]
        for r in range(n_readings):
            mining_reading(cfg, edge, s, r, hz=hz)
    return cfg


def wireless_churn_schedule(tb: Testbed, n_waves: int, seed: int = 0,
                            churn_frac: float = 0.25,
                            min_scale: float = 0.05,
                            max_scale: float = 0.5) -> list[Churn]:
    """Seeded bandwidth-volatility schedule over the edge uplinks.

    Each wave first **recovers** every currently degraded uplink to its
    nominal bandwidth, then **degrades** a fresh random ``churn_frac``
    sample of uplinks to ``uniform(min_scale, max_scale)`` of nominal.
    Each wave is one :class:`Churn` batch of bandwidth entries only, so
    applying it costs one overlay copy on the compiled snapshot and no
    topology-layer copy.  Deterministic in ``seed`` (a ``random.Random``
    of its own, drawn in the same order as the reference package's)."""
    rng = random.Random(seed)
    links = [f"link_{e}" for e in tb.edges]
    nominal: dict[str, float] = {}
    for adj in tb.graph._adj.values():
        for _, e in adj:
            if e.name in links and e.name not in nominal:
                nominal[e.name] = e.bandwidth
    k = max(1, int(len(links) * churn_frac))
    degraded: dict[str, float] = {}
    waves: list[Churn] = []
    for _ in range(n_waves):
        entries: list[tuple[str, float]] = []
        for name in sorted(degraded):
            entries.append((name, nominal[name]))
        degraded.clear()
        for name in rng.sample(links, k):
            bw = nominal[name] * rng.uniform(min_scale, max_scale)
            degraded[name] = bw
            entries.append((name, bw))
        waves.append(Churn(bandwidth=tuple(entries)))
    return waves
