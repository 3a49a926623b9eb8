"""A deployment and its tasks in plain Python: the fleet that Alg. 1 walks
(devices, their PUs and resource chains, network links, clusters) and
the tasks it places.

A topology (``heye_bench/topologies/<name>.py``) builds the fleet from
the configuration's data and gives what differs between topologies: the
shortest routes between two devices and each PU's standalone time for a
task kind.  Nothing here is read from the program under test.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional

MS = 1e-3
GB = 1e9
MB = 1e6
KB = 1e3
GBPS = 1e9 / 8

# generalized resource usage and irregular-access multiplier per task kind
TASK_USAGE = {
    "capture": (0.3, 0.2), "pose_pred": (1.0, 0.7), "render": (1.0, 0.9),
    "encode": (0.8, 0.5), "decode": (0.7, 0.4), "reproject": (0.8, 0.6),
    "display": (0.2, 0.1), "svm": (1.0, 0.6), "knn": (1.0, 0.9),
    "mlp": (1.0, 0.5),
}
TASK_IRREGULARITY = {"knn": 2.2, "svm": 1.4, "mlp": 1.0, "render": 1.2,
                     "pose_pred": 1.1}


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------
@dataclass
class PU:
    name: str
    device: int               # device ordinal
    short: str                # "cpu", "gpu", "dla", "pva", "vic", "chip"
    klass: str                # slowdown class (MT_BETA's key)
    max_tenancy: int
    mem_cap: float            # cap on a task's memory pressure here
    path: tuple               # resource chain, PU outward: (node, rclass)


@dataclass
class Device:
    name: str
    kind: str
    pus: list                 # PU indices, in the order the device ORC scans
    link: int                 # index of its uplink


class Fleet:
    """The devices, PUs and links of a deployment, and its clusters: the
    device ordinals under each child of the program's root, in the
    order of those children.  A topology subclasses it with ``routes``
    and ``standalone_s``."""

    def __init__(self) -> None:
        self.devices: list = []
        self.pus: list = []
        self.links: list = []         # [bandwidth, latency] per link
        self.link_names: list = []    # the program's name of each link
        self.clusters: list = []

    def add_link(self, name: str, bandwidth: float, latency: float) -> int:
        self.links.append([bandwidth, latency])
        self.link_names.append(name)
        return len(self.links) - 1

    def add_device(self, name: str, kind: str, specs, link: int) -> int:
        """A device with one PU per ``(short, klass, max_tenancy,
        mem_cap, path)`` of ``specs``, in build order; its ORC scans them
        in the reverse (the depth-first walk of the device's subtree)."""
        d = len(self.devices)
        idx = []
        for short, klass, mt, cap, path in specs:
            idx.append(len(self.pus))
            self.pus.append(PU(f"{name}.{short}", d,
                               short.rstrip("0123456789"), klass, mt, cap,
                               path))
        self.devices.append(Device(name, kind, idx[::-1], link))
        return d

    def routes(self, a: int, b: int) -> list:
        """Every route of least latency from device ``a`` to device
        ``b`` (``a != b``), each a list of link indices in path order;
        raises where the topology cannot route the pair."""
        raise NotImplementedError

    def standalone_s(self, kind: str, pu: int) -> Optional[float]:
        """Seconds of a task of ``kind`` alone on PU ``pu``, or None
        where the PU cannot run it."""
        raise NotImplementedError

    def route(self, a: int, b: int) -> list:
        """The links a transfer from ``a`` to ``b`` occupies; raises
        where routes of equal latency leave them open."""
        if a == b:
            return []
        rs = self.routes(a, b)
        if len(rs) != 1:
            raise ValueError(
                f"{len(rs)} routes of least latency from "
                f"{self.devices[a].name} to {self.devices[b].name}")
        return rs[0]

    def transfer_time(self, a: int, b: int, nbytes: float) -> float:
        """Store-and-forward latency along the route plus the bytes over
        its narrowest link (the same for every route of least latency,
        or this raises)."""
        if a == b:
            return 0.0
        costs = set()
        for r in self.routes(a, b):
            lat = 0.0
            for k in r:
                lat += self.links[k][1]
            costs.add((lat, min(self.links[k][0] for k in r)))
        if len(costs) != 1:
            raise ValueError(
                f"routes from {self.devices[a].name} to "
                f"{self.devices[b].name} differ in their narrowest link")
        lat, bw = costs.pop()
        return lat + (nbytes * (1.0 / bw) if nbytes > 0 else 0.0)


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
