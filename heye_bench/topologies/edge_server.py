"""The paper's edge-cloud testbed, the default topology: edges behind one
router, the router and the servers on a WAN (Fig. 4 device structure,
Table 2 fleet, the section 5.1 network), with the profiled standalone
latencies of Fig. 9.

The deployment gives ``edge_counts`` and ``server_counts`` (kind ->
count).  The program's side is ``core.build_testbed``; the reference's is
built here from the same counts: the root's two clusters, the edges' and
the servers', each edge's LAN uplink to the router, each server's WAN
link, and the router's backbone link to the WAN.
"""
from __future__ import annotations

import math
from typing import Optional

from heye_bench.reference.fleet import GBPS, MS, Fleet

EDGE_KINDS = ("orin_agx", "xavier_agx", "orin_nano", "xavier_nx")

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


def profile_ms(kind: str, devkind: str, short: str) -> Optional[float]:
    for book in (VR_EDGE, ML_EDGE, VR_SERVER, ML_SERVER):
        ms = book.get(kind, {}).get(devkind, {}).get(short)
        if ms is not None:
            return ms
    return None


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


def testbed(core, dep: dict, device):
    """The program's testbed for the deployment."""
    return core.build_testbed(edge_counts=dep["edge_counts"],
                              server_counts=dep["server_counts"],
                              device=device)


class EdgeServerFleet(Fleet):
    """The reference's testbed; ``edges`` and ``servers`` are its two
    clusters, in build order."""

    def __init__(self) -> None:
        super().__init__()
        self.edges: list = []
        self.servers: list = []
        self.clusters = [self.edges, self.servers]

    def routes(self, a: int, b: int) -> list:
        """An edge reaches the router on its uplink, a server the WAN on
        its own, and the router reaches the WAN on the backbone link 0."""
        da, db = self.devices[a], self.devices[b]
        if (da.kind in EDGE_KINDS) == (db.kind in EDGE_KINDS):
            return [[da.link, db.link]]
        return [[da.link, 0, db.link]]

    def standalone_s(self, kind: str, pu: int) -> Optional[float]:
        p = self.pus[pu]
        ms = profile_ms(kind, self.devices[p.device].kind, p.short)
        return None if ms is None else ms * MS * 1.0


def fleet(dep: dict, lan_bw: float = 1.0 * GBPS * 8,
          wan_bw: float = 10 * GBPS, lan_lat: float = 0.3 * MS,
          wan_lat: float = 1.0 * MS) -> EdgeServerFleet:
    """The reference's fleet for the deployment, in the program's build
    order: the edges kind by kind, then the servers."""
    fl = EdgeServerFleet()
    fl.add_link("router--wan", wan_bw, wan_lat)
    n = 0
    for kind, count in dep["edge_counts"].items():
        for _ in range(count):
            name = f"{kind}_e{n}"
            fl.edges.append(fl.add_device(
                name, kind, _EDGE_PUS,
                fl.add_link(f"link_{name}", lan_bw, lan_lat)))
            n += 1
    n = 0
    for kind, count in dep["server_counts"].items():
        for _ in range(count):
            name = f"{kind}_s{n}"
            fl.servers.append(fl.add_device(
                name, kind, _server_pus(kind),
                fl.add_link(f"link_{name}", wan_bw, wan_lat)))
            n += 1
    return fl
