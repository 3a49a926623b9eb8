"""The deployment in plain Python: the H-EYE paper's edge-cloud testbed
(Fig. 4 device structure, Table 2 fleet, the section 5.1 network), its
profiled standalone latencies (Fig. 9), and the VR application's tasks
(section 4).

Everything here is built from the configuration's counts alone; nothing
is read from the program under test.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Optional

MS = 1e-3
GB = 1e9
MB = 1e6
KB = 1e3
GBPS = 1e9 / 8

EDGE_KINDS = ("orin_agx", "xavier_agx", "orin_nano", "xavier_nx")
EDGE_FPS = {"orin_agx": 30.0, "xavier_agx": 24.0, "orin_nano": 20.0,
            "xavier_nx": 20.0}

# standalone milliseconds per (task kind, device kind, PU short name)
VR_EDGE = {
    "capture":   {"orin_agx": {"cpu": 1.0}, "xavier_agx": {"cpu": 1.2},
                  "orin_nano": {"cpu": 1.8}, "xavier_nx": {"cpu": 2.0}},
    "pose_pred": {"orin_agx": {"cpu": 6.0, "gpu": 3.5},
                  "xavier_agx": {"cpu": 8.0, "gpu": 5.0},
                  "orin_nano": {"cpu": 12.0, "gpu": 7.0},
                  "xavier_nx": {"cpu": 14.0, "gpu": 8.0}},
    "render":    {"orin_agx": {"gpu": 38.0}, "xavier_agx": {"gpu": 55.0},
                  "orin_nano": {"gpu": 90.0}, "xavier_nx": {"gpu": 100.0}},
    "encode":    {"orin_agx": {"gpu": 5.0, "vic": 6.0},
                  "xavier_agx": {"gpu": 7.0, "vic": 8.0},
                  "orin_nano": {"gpu": 10.0, "vic": 12.0},
                  "xavier_nx": {"gpu": 11.0, "vic": 13.0}},
    "decode":    {"orin_agx": {"gpu": 4.0, "vic": 5.0},
                  "xavier_agx": {"gpu": 5.0, "vic": 6.0},
                  "orin_nano": {"gpu": 8.0, "vic": 9.0},
                  "xavier_nx": {"gpu": 9.0, "vic": 10.0}},
    "reproject": {"orin_agx": {"cpu": 3.0, "vic": 4.0},
                  "xavier_agx": {"cpu": 4.0, "vic": 5.0},
                  "orin_nano": {"cpu": 6.0, "vic": 7.0},
                  "xavier_nx": {"cpu": 7.0, "vic": 8.0}},
    "display":   {"orin_agx": {"cpu": 1.5}, "xavier_agx": {"cpu": 2.0},
                  "orin_nano": {"cpu": 3.0}, "xavier_nx": {"cpu": 3.0}},
}
VR_SERVER = {
    "pose_pred": {"server1": {"cpu": 2.5, "gpu": 1.5},
                  "server2": {"cpu": 2.2, "gpu": 1.3},
                  "server3": {"cpu": 3.5, "gpu": 3.0}},
    "render":    {"server1": {"gpu": 7.0}, "server2": {"gpu": 6.5},
                  "server3": {"gpu": 18.0}},
    "encode":    {"server1": {"gpu": 2.5}, "server2": {"gpu": 2.2},
                  "server3": {"gpu": 6.0}},
    "decode":    {"server1": {"gpu": 2.0}, "server2": {"gpu": 1.8},
                  "server3": {"gpu": 4.0}},
}
ML_EDGE = {
    "svm": {"orin_agx": {"cpu": 18.0, "gpu": 8.0},
            "xavier_agx": {"cpu": 24.0, "gpu": 10.0},
            "orin_nano": {"cpu": 35.0, "gpu": 15.0},
            "xavier_nx": {"cpu": 38.0, "gpu": 16.0}},
    "knn": {"orin_agx": {"cpu": 30.0, "gpu": 14.0},
            "xavier_agx": {"cpu": 40.0, "gpu": 18.0},
            "orin_nano": {"cpu": 55.0, "gpu": 26.0},
            "xavier_nx": {"cpu": 70.0, "gpu": 30.0}},
    "mlp": {"orin_agx": {"cpu": 12.0, "gpu": 5.0},
            "xavier_agx": {"cpu": 16.0, "gpu": 6.0},
            "orin_nano": {"cpu": 24.0, "gpu": 9.0},
            "xavier_nx": {"cpu": 26.0, "gpu": 10.0}},
}
ML_SERVER = {
    "svm": {"server1": {"cpu": 3.0, "gpu": 1.5},
            "server2": {"cpu": 2.5, "gpu": 1.2},
            "server3": {"cpu": 6.0, "gpu": 4.0}},
    "knn": {"server1": {"cpu": 5.0, "gpu": 2.5},
            "server2": {"cpu": 4.5, "gpu": 2.0},
            "server3": {"cpu": 9.0, "gpu": 6.0}},
    "mlp": {"server1": {"cpu": 2.0, "gpu": 1.0},
            "server2": {"cpu": 1.8, "gpu": 0.8},
            "server3": {"cpu": 4.0, "gpu": 3.0}},
}
# generalized resource usage and irregular-access multiplier per task kind
TASK_USAGE = {
    "capture": (0.3, 0.2), "pose_pred": (1.0, 0.7), "render": (1.0, 0.9),
    "encode": (0.8, 0.5), "decode": (0.7, 0.4), "reproject": (0.8, 0.6),
    "display": (0.2, 0.1), "svm": (1.0, 0.6), "knn": (1.0, 0.9),
    "mlp": (1.0, 0.5),
}
TASK_IRREGULARITY = {"knn": 2.2, "svm": 1.4, "mlp": 1.0, "render": 1.2,
                     "pose_pred": 1.1}


def profile_ms(kind: str, devkind: str, short: str) -> Optional[float]:
    for book in (VR_EDGE, ML_EDGE, VR_SERVER, ML_SERVER):
        ms = book.get(kind, {}).get(devkind, {}).get(short)
        if ms is not None:
            return ms
    return None


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------
@dataclass
class PU:
    name: str
    device: int               # device ordinal
    short: str                # "cpu", "gpu", "dla", "pva", "vic"
    klass: str                # slowdown class: cpu / gpu / dla / pva / vic
    max_tenancy: int
    mem_cap: float            # cap on a task's memory pressure here
    path: tuple               # resource chain, PU outward: (node, rclass)


@dataclass
class Device:
    name: str
    kind: str
    pus: list                 # PU indices, in the order the device ORC scans
    link: int                 # index of its uplink


@dataclass
class Fleet:
    devices: list
    pus: list
    edges: list               # device ordinals of edge devices
    servers: list
    links: list               # [bandwidth, latency] per network link

    def route(self, a: int, b: int) -> list:
        """Link indices from device ``a`` to device ``b``, in path order:
        an edge reaches the router on its uplink, a server the WAN on its
        own, and the router reaches the WAN on the backbone link 0."""
        if a == b:
            return []
        da, db = self.devices[a], self.devices[b]
        if (da.kind in EDGE_KINDS) == (db.kind in EDGE_KINDS):
            return [da.link, db.link]
        return [da.link, 0, db.link]

    def transfer_time(self, a: int, b: int, nbytes: float) -> float:
        """Store-and-forward latency along the route plus the bytes over
        its narrowest link."""
        if a == b:
            return 0.0
        r = self.route(a, b)
        lat = 0.0
        for k in r:
            lat += self.links[k][1]
        bw = min(self.links[k][0] for k in r)
        return lat + (nbytes * (1.0 / bw) if nbytes > 0 else 0.0)


# per edge PU: short name, slowdown class, max tenancy, memory cap, chain
_EDGE_PUS = (
    ("cpu0", "cpu", 4, math.inf, (("l2_0", "l2"), ("l3", "l3"),
                                  ("llc", "llc"), ("dram", "dram"))),
    ("cpu1", "cpu", 4, math.inf, (("l2_1", "l2"), ("l3", "l3"),
                                  ("llc", "llc"), ("dram", "dram"))),
    ("gpu", "gpu", 4, math.inf, (("llc", "llc"), ("dram", "dram"))),
    ("dla", "dla", 2, math.inf, (("sram", "sram"), ("dram", "dram"))),
    ("pva", "pva", 2, math.inf, (("sram", "sram"), ("dram", "dram"))),
    ("vic", "vic", 2, 0.15, (("vic_sram", "sram"), ("dram", "dram"))),
)


def _server_pus(kind: str) -> tuple:
    gpu_path = ((("llc", "llc"), ("dram", "dram")) if kind == "server3"
                else (("vram", "hbm"),))
    return (("cpu", "cpu", 16, math.inf, (("llc", "llc"), ("dram", "dram"))),
            ("gpu", "gpu", 6, math.inf, gpu_path))


def build_fleet(edge_counts: dict, server_counts: dict,
                lan_bw: float = 1.0 * GBPS * 8, wan_bw: float = 10 * GBPS,
                lan_lat: float = 0.3 * MS, wan_lat: float = 1.0 * MS) -> Fleet:
    """Edges behind one router, the router and the servers on a WAN.  A
    device's ORC scans its PUs in the reverse of the order they were
    built (the depth-first walk of the device's subtree)."""
    fl = Fleet(devices=[], pus=[], edges=[], servers=[],
               links=[[wan_bw, wan_lat]])

    def add(name, kind, specs, bw, lat):
        d = len(fl.devices)
        fl.links.append([bw, lat])
        idx = []
        for short, klass, mt, cap, path in specs:
            idx.append(len(fl.pus))
            fl.pus.append(PU(f"{name}.{short}", d,
                             short.rstrip("0123456789"), klass, mt, cap,
                             path))
        fl.devices.append(Device(name, kind, idx[::-1], len(fl.links) - 1))
        return d

    n = 0
    for kind, count in edge_counts.items():
        for _ in range(count):
            fl.edges.append(add(f"{kind}_e{n}", kind, _EDGE_PUS, lan_bw,
                                lan_lat))
            n += 1
    n = 0
    for kind, count in server_counts.items():
        for _ in range(count):
            fl.servers.append(add(f"{kind}_s{n}", kind, _server_pus(kind),
                                  wan_bw, wan_lat))
            n += 1
    return fl


def nearest_shared(fl: Fleet, a: int, b: int) -> Optional[str]:
    """rclass of the first resource on PU ``a``'s chain that is also on
    PU ``b``'s, or None (other devices, or disjoint chains)."""
    pa, pb = fl.pus[a], fl.pus[b]
    if pa.device != pb.device:
        return None
    names = {n for n, _ in pb.path}
    for n, rc in pa.path:
        if n in names:
            return rc
    return None


# ---------------------------------------------------------------------------
# tasks
# ---------------------------------------------------------------------------
@dataclass
class Task:
    uid: int
    kind: str
    origin: int                  # device ordinal
    deadline: Optional[float]
    input_bytes: float
    output_bytes: float
    release: float
    u_pu: float
    u_mem: float
    irregularity: float
    pinned: bool = False
    succ_pinned_bytes: float = 0.0
    preds: list = field(default_factory=list)     # uids
    succs: list = field(default_factory=list)


class TaskMaker:
    """Mints tasks with increasing uids, in the order the program makes
    them."""

    def __init__(self) -> None:
        self._uid = itertools.count()

    def make(self, kind, origin, deadline, input_bytes=0.0, output_bytes=0.0,
             release=0.0) -> Task:
        u, m = TASK_USAGE.get(kind, (1.0, 0.5))
        return Task(next(self._uid), kind, origin, deadline, input_bytes,
                    output_bytes, release, u, m,
                    TASK_IRREGULARITY.get(kind, 1.0))


VR_TASKS = ("capture", "pose_pred", "render", "encode", "decode",
            "reproject", "display")
VR_BYTES = {"capture": 48 * KB, "pose_pred": 4 * KB, "render": 1.5 * MB,
            "encode": 250 * KB, "decode": 1.5 * MB, "reproject": 1.5 * MB,
            "display": 0.0}
VR_PINNED = ("capture", "reproject", "display")
_COMM_EST = 2.6 * MS


def vr_shares(edge_kind: str) -> dict:
    """Per-stage deadline shares from the best edge/server plan (a DP
    over stage sides charging each transfer leg)."""
    inf = float("inf")

    def stage_cost(kind, side):
        if side == "edge":
            return min(VR_EDGE[kind][edge_kind].values()) * MS
        if kind in VR_PINNED or kind not in VR_SERVER:
            return inf
        return min(min(p.values()) for p in VR_SERVER[kind].values()) * MS

    def trans(prev_kind, a, b):
        return 0.0 if a == b else _COMM_EST * max(
            0.5, VR_BYTES[prev_kind] / (250 * KB))

    dp = [{s: (stage_cost(VR_TASKS[0], s), None) for s in ("edge", "server")}]
    for i in range(1, len(VR_TASKS)):
        row = {}
        for side in ("edge", "server"):
            sc = stage_cost(VR_TASKS[i], side)
            best, arg = inf, None
            for prev in ("edge", "server"):
                c = dp[i - 1][prev][0]
                if c == inf or sc == inf:
                    continue
                tot = c + trans(VR_TASKS[i - 1], prev, side) + sc
                if tot < best:
                    best, arg = tot, prev
            row[side] = (best, arg)
        dp.append(row)
    side = min(("edge", "server"), key=lambda s: dp[-1][s][0])
    sides = [side]
    for i in range(len(VR_TASKS) - 1, 0, -1):
        side = dp[i][side][1]
        sides.append(side)
    sides.reverse()
    plan = {}
    for i, kind in enumerate(VR_TASKS):
        c = stage_cost(kind, sides[i])
        if i > 0:
            c += trans(VR_TASKS[i - 1], sides[i - 1], sides[i])
        plan[kind] = c
    total = sum(plan.values())
    return {k: v / total for k, v in plan.items()}


def vr_tasks(fl: Fleet, mk: TaskMaker, n_frames: int) -> list:
    """Per edge and frame the serial CFG capture -> ... -> display at the
    edge's FPS, every stage carrying its share of the frame period."""
    out = []
    for e in fl.edges:
        kind = fl.devices[e].kind
        period = 1.0 / EDGE_FPS[kind]
        shares = vr_shares(kind)
        for f in range(n_frames):
            release = f * period
            frame = []
            for i, k in enumerate(VR_TASKS):
                t = mk.make(k, e, shares[k] * period,
                            VR_BYTES[VR_TASKS[i - 1]] if i else 8 * KB,
                            VR_BYTES[k], release)
                t.pinned = k in VR_PINNED
                if frame:
                    t.preds.append(frame[-1].uid)
                    frame[-1].succs.append(t.uid)
                frame.append(t)
            for a, b in zip(frame, frame[1:]):
                if b.pinned:
                    a.succ_pinned_bytes = a.output_bytes
            out.extend(frame)
    return out
