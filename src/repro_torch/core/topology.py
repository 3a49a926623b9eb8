"""Topology constructors: HW-GRAPHs for the paper's edge/server testbed.

Edge devices follow Fig. 4's multi-layer structure (CPU clusters with private
L2s behind a shared L3, GPU sharing an LLC with the CPU, a vision cluster
whose DLA/PVA share SRAM, a VIC with private storage, all meeting at DRAM).
Servers have a CPU (LLC->DRAM) and a discrete GPU with private VRAM, so
cross-PU contention inside a server is mild while GPU *multi-tenancy* is the
dominant effect — matching the paper's §2.2 narrative.

Standalone task latencies are digitized estimates of the paper's Fig. 9
(the figure is not numerically annotated; values were chosen to preserve
every ordering and bottleneck the text calls out — e.g. rendering is
infeasible at QoS on every edge device, KNN on Xavier NX is the
strong-scaling limiter, VIC is slightly slower standalone than CPU for
reproject but contention-immune).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..device import DeviceLike, resolve_device
from .hwgraph import HWGraph, Node, NodeKind, ProcessingUnit
from .predict import ProfiledModel
from .task import Task

MS = 1e-3
GB = 1e9
MB = 1e6
KB = 1e3
Gbps = 1e9 / 8

EDGE_KINDS = ("orin_agx", "xavier_agx", "orin_nano", "xavier_nx")
SERVER_KINDS = ("server1", "server2", "server3")

# target FPS per edge kind (paper: slower headsets get lower FPS QoS)
EDGE_FPS = {"orin_agx": 30.0, "xavier_agx": 24.0, "orin_nano": 20.0,
            "xavier_nx": 20.0}


# ---------------------------------------------------------------------------
# Edge SoCs (Fig. 4 layer-2/3 structure)
# ---------------------------------------------------------------------------
def build_edge_device(g: HWGraph, name: str, kind: str,
                      parent: Optional[str] = None,
                      core_level: bool = False) -> Node:
    """Add one Jetson-class SoC to ``g``. Returns the device GROUP node.

    ``core_level=True`` additionally exposes individual CPU cores as PUs
    (used by the Fig. 2 contention-reproduction benchmark)."""
    assert kind in EDGE_KINDS, kind
    dev = g.add_node(Node(name, NodeKind.GROUP, parent=parent,
                          attrs={"orc_level": "device", "devkind": kind}))
    prof = vr_mining_profile()

    def pu(short: str, pu_kind: str, max_tenancy: int = 4) -> ProcessingUnit:
        p = ProcessingUnit(f"{name}.{short}", model=prof, max_tenancy=max_tenancy,
                           parent=name,
                           attrs={"pu_class": f"{kind}.{short.rstrip('0123456789')}",
                                  "pu_class_kind": pu_kind})
        g.add_node(p)
        return p

    def store(short: str, rclass: str) -> Node:
        return g.add_node(Node(f"{name}.{short}", NodeKind.STORAGE, parent=name,
                               attrs={"rclass": rclass}))

    dram = store("dram", "dram")
    llc = store("llc", "llc")
    l3 = store("l3", "l3")
    g.add_edge(llc.name, dram.name, bandwidth=102 * GB, latency=1e-7)
    g.add_edge(l3.name, llc.name, bandwidth=150 * GB, latency=5e-8)

    # two CPU clusters, each with a private L2 (Fig. 2: core0/1 share L2,
    # cross-cluster pairs meet at L3)
    for c in range(2):
        l2 = store(f"l2_{c}", "l2")
        g.add_edge(l2.name, l3.name, bandwidth=200 * GB, latency=2e-8)
        cl = pu(f"cpu{c}", "cpu", max_tenancy=4)
        g.add_edge(cl.name, l2.name, bandwidth=250 * GB, latency=1e-8)
        if core_level:
            for k in range(2):
                core = pu(f"cpu{c}_core{k}", "cpu", max_tenancy=1)
                g.add_edge(core.name, l2.name, bandwidth=250 * GB, latency=1e-8)

    gpu = pu("gpu", "gpu", max_tenancy=4)
    g.add_edge(gpu.name, llc.name, bandwidth=200 * GB, latency=2e-8)

    # vision cluster: DLA + PVA share SRAM (Fig. 4's example)
    sram = store("sram", "sram")
    g.add_edge(sram.name, dram.name, bandwidth=120 * GB, latency=8e-8)
    for short in ("dla", "pva"):
        v = pu(short, short, max_tenancy=2)
        g.add_edge(v.name, sram.name, bandwidth=150 * GB, latency=2e-8)

    # VIC has private storage (contention-immune per §5.3.1): its tasks'
    # effective shared-memory pressure is capped (consumed by DecoupledSlowdown)
    vic_sram = store("vic_sram", "sram")
    vic = pu("vic", "vic", max_tenancy=2)
    vic.attrs["mem_usage_cap"] = 0.15
    g.add_edge(vic.name, vic_sram.name, bandwidth=80 * GB, latency=2e-8)
    g.add_edge(vic_sram.name, dram.name, bandwidth=60 * GB, latency=1e-7)

    # NIC: the device's attachment point for network edges
    nic = g.add_node(Node(f"{name}.nic", NodeKind.CONTROLLER, parent=name,
                          attrs={"rclass": "nic"}))
    g.add_edge(nic.name, dram.name, bandwidth=10 * GB, latency=1e-6)
    return dev


def build_server(g: HWGraph, name: str, kind: str,
                 parent: Optional[str] = None) -> Node:
    assert kind in SERVER_KINDS, kind
    dev = g.add_node(Node(name, NodeKind.GROUP, parent=parent,
                          attrs={"orc_level": "device", "devkind": kind}))
    prof = vr_mining_profile()

    def store(short: str, rclass: str) -> Node:
        return g.add_node(Node(f"{name}.{short}", NodeKind.STORAGE, parent=name,
                               attrs={"rclass": rclass}))

    dram = store("dram", "dram")
    llc = store("llc", "llc")
    g.add_edge(llc.name, dram.name, bandwidth=200 * GB, latency=8e-8)
    cpu = g.add_node(ProcessingUnit(f"{name}.cpu", model=prof, max_tenancy=16,
                                    parent=name,
                                    attrs={"pu_class": f"{kind}.cpu",
                                           "pu_class_kind": "cpu"}))
    g.add_edge(cpu.name, llc.name, bandwidth=400 * GB, latency=1e-8)
    # discrete GPU with private VRAM (server3 is an APU: GPU shares DRAM)
    gpu = g.add_node(ProcessingUnit(f"{name}.gpu", model=prof, max_tenancy=6,
                                    parent=name,
                                    attrs={"pu_class": f"{kind}.gpu",
                                           "pu_class_kind": "gpu"}))
    if kind == "server3":
        g.add_edge(gpu.name, llc.name, bandwidth=100 * GB, latency=5e-8)
    else:
        vram = store("vram", "hbm")
        g.add_edge(gpu.name, vram.name, bandwidth=600 * GB, latency=2e-8)
        g.add_edge(vram.name, dram.name, bandwidth=16 * GB, latency=1e-6)  # PCIe
    nic = g.add_node(Node(f"{name}.nic", NodeKind.CONTROLLER, parent=name,
                          attrs={"rclass": "nic"}))
    g.add_edge(nic.name, dram.name, bandwidth=10 * GB, latency=1e-6)
    return dev


# ---------------------------------------------------------------------------
# Full DECS testbed (Table 2 + §5.1 network)
# ---------------------------------------------------------------------------
@dataclass
class Testbed:
    graph: HWGraph
    edges: list[str]          # edge device names
    servers: list[str]        # server device names
    edge_kind: dict[str, str]
    server_kind: dict[str, str]


def build_testbed(edge_counts: Optional[dict[str, int]] = None,
                  server_counts: Optional[dict[str, int]] = None,
                  lan_bw: float = 1.0 * Gbps * 8,       # edge<->router (WLAN-ish)
                  wan_bw: float = 10 * Gbps,            # router/servers on campus WAN
                  lan_lat: float = 0.3 * MS,
                  wan_lat: float = 1.0 * MS,
                  device: DeviceLike = None) -> Testbed:
    """Edge devices behind one router; router + servers on a 10 Gbps WAN.

    ``device``: where everything compiled from the graph lives — the
    CUDA device by default (raises when there is none), ``"cpu"`` on
    explicit request."""
    device = resolve_device(device)
    edge_counts = edge_counts or {"orin_agx": 1, "xavier_agx": 1,
                                  "orin_nano": 1, "xavier_nx": 2}
    server_counts = server_counts or {"server1": 1, "server2": 1, "server3": 1}
    g = HWGraph(device=device)
    root = g.add_node(Node("fleet", NodeKind.GROUP, attrs={"orc_level": "root"}))
    ecl = g.add_node(Node("edge_cluster", NodeKind.GROUP, parent="fleet",
                          attrs={"orc_level": "cluster"}))
    scl = g.add_node(Node("server_cluster", NodeKind.GROUP, parent="fleet",
                          attrs={"orc_level": "cluster"}))
    router = g.add_node(Node("router", NodeKind.CONTROLLER, parent="fleet"))
    wan = g.add_node(Node("wan", NodeKind.ABSTRACT, parent="fleet"))
    g.add_edge("router", "wan", bandwidth=wan_bw, latency=wan_lat)

    edges: list[str] = []
    ek: dict[str, str] = {}
    for kind, n in edge_counts.items():
        for i in range(n):
            name = f"{kind}_e{len(edges)}"
            build_edge_device(g, name, kind, parent="edge_cluster")
            g.add_edge(name, "router", bandwidth=lan_bw, latency=lan_lat,
                       name=f"link_{name}")
            edges.append(name)
            ek[name] = kind
    servers: list[str] = []
    sk: dict[str, str] = {}
    for kind, n in server_counts.items():
        for i in range(n):
            name = f"{kind}_s{len(servers)}"
            build_server(g, name, kind, parent="server_cluster")
            g.add_edge(name, "wan", bandwidth=wan_bw, latency=wan_lat,
                       name=f"link_{name}")
            servers.append(name)
            sk[name] = kind
    return Testbed(graph=g, edges=edges, servers=servers,
                   edge_kind=ek, server_kind=sk)


# ---------------------------------------------------------------------------
# Profiled standalone latencies (digitized from Fig. 9)
# ---------------------------------------------------------------------------
_VR_EDGE = {
    # task: {edge_kind: {pu_short: seconds}}
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
_VR_SERVER = {
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
_ML_EDGE = {
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
_ML_SERVER = {
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
# generic matrix-multiply microbenchmark used by the Fig. 2 reproduction
_MM = {k: {"cpu": 20.0, "cpu_core": 40.0, "gpu": 6.0, "dla": 12.0}
       for k in EDGE_KINDS}

_profile_singleton: Optional[ProfiledModel] = None


def vr_mining_profile() -> ProfiledModel:
    """One shared ProfiledModel keyed by (task kind, pu_class)."""
    global _profile_singleton
    if _profile_singleton is not None:
        return _profile_singleton
    table: dict[tuple[str, str], float] = {}
    for book in (_VR_EDGE, _ML_EDGE):
        for task, per_kind in book.items():
            for devkind, pus in per_kind.items():
                for pu, ms in pus.items():
                    table[(task, f"{devkind}.{pu}")] = ms * MS
    for book in (_VR_SERVER, _ML_SERVER):
        for task, per_kind in book.items():
            for devkind, pus in per_kind.items():
                for pu, ms in pus.items():
                    table[(task, f"{devkind}.{pu}")] = ms * MS
    for devkind, pus in _MM.items():
        table[("mm", f"{devkind}.cpu")] = pus["cpu"] * MS
        table[("mm", f"{devkind}.cpu_core")] = pus["cpu_core"] * MS
        table[("mm", f"{devkind}.gpu")] = pus["gpu"] * MS
        table[("mm", f"{devkind}.dla")] = pus["dla"] * MS
        table[("dnn", f"{devkind}.gpu")] = 15.0 * MS
        table[("dnn", f"{devkind}.dla")] = 25.0 * MS
    _profile_singleton = ProfiledModel(table=table)
    return _profile_singleton


# generalized resource usage per task kind (§3.4 slowdown calculation step 2)
TASK_USAGE = {
    "capture":   {"pu": 0.3, "mem": 0.2},
    "pose_pred": {"pu": 1.0, "mem": 0.7},
    "render":    {"pu": 1.0, "mem": 0.9},
    "encode":    {"pu": 0.8, "mem": 0.5},
    "decode":    {"pu": 0.7, "mem": 0.4},
    "reproject": {"pu": 0.8, "mem": 0.6},
    "display":   {"pu": 0.2, "mem": 0.1},
    "svm":       {"pu": 1.0, "mem": 0.6},
    "knn":       {"pu": 1.0, "mem": 0.9},
    "mlp":       {"pu": 1.0, "mem": 0.5},
    "mm":        {"pu": 1.0, "mem": 1.0},
    "dnn":       {"pu": 1.0, "mem": 1.0},
}
# irregular-access multiplier (ground-truth noise scale; §5.2: the ML tasks'
# "intricate and irregular data access patterns" dominate H-EYE's 3.2% error)
TASK_IRREGULARITY = {"knn": 2.2, "svm": 1.4, "mlp": 1.0, "render": 1.2,
                     "pose_pred": 1.1, "mm": 0.6, "dnn": 1.0}


def make_task(kind: str, origin: Optional[str] = None,
              deadline: Optional[float] = None,
              input_bytes: float = 0.0, output_bytes: float = 0.0,
              release_time: float = 0.0, size: float = 1.0) -> Task:
    t = Task(kind=kind, size=size, deadline=deadline, origin=origin,
             input_bytes=input_bytes, output_bytes=output_bytes,
             usage=dict(TASK_USAGE.get(kind, {"pu": 1.0, "mem": 0.5})))
    t.release_time = release_time
    t.attrs["irregularity"] = TASK_IRREGULARITY.get(kind, 1.0)
    return t


# ---------------------------------------------------------------------------
# TPU fleet (the hardware-adaptation target)
# ---------------------------------------------------------------------------
# Attributes of the *simulated* TPU v5e chips H-EYE places tenants on (the
# reference's fleet, copied unchanged).  They describe nodes of the modelled
# fleet only; they are not measurements of this port or of any device it
# runs on.
TPU_V5E = {"peak_flops": 197e12, "mem_bw": 819e9, "link_bw": 50e9,
           "hbm_bytes": 16e9}


def build_tpu_fleet(n_pods: int = 2, hosts_per_pod: int = 16,
                    chips_per_host: int = 16,
                    dcn_bw: float = 25 * GB, dcn_lat: float = 1e-4,
                    ici_bw: float = 50 * GB, ici_lat: float = 1e-6,
                    device: DeviceLike = None) -> Testbed:
    """pods -> hosts -> chips. ICI links chip<->chip in a ring per host plus
    host<->host rings in the pod (coarse torus abstraction); DCN fabric is an
    ABSTRACT node exactly like the paper's unknown WAN.

    ``device``: where everything compiled from the graph lives, as for
    :func:`build_testbed`."""
    g = HWGraph(device=resolve_device(device))
    g.add_node(Node("fleet", NodeKind.GROUP, attrs={"orc_level": "root"}))
    g.add_node(Node("dcn", NodeKind.ABSTRACT, parent="fleet"))
    pods: list[str] = []
    for p in range(n_pods):
        pod = f"pod{p}"
        g.add_node(Node(pod, NodeKind.GROUP, parent="fleet",
                        attrs={"orc_level": "cluster"}))
        pods.append(pod)
        host_names = []
        for h in range(hosts_per_pod):
            host = f"{pod}.host{h}"
            g.add_node(Node(host, NodeKind.GROUP, parent=pod,
                            attrs={"orc_level": "device"}))
            host_names.append(host)
            prev_chip = None
            for c in range(chips_per_host):
                chip = ProcessingUnit(f"{host}.chip{c}", model=None,
                                      max_tenancy=2, parent=host,
                                      attrs={"pu_class": "tpu_v5e",
                                             "pu_class_kind": "tpu",
                                             **TPU_V5E})
                g.add_node(chip)
                hbm = g.add_node(Node(f"{host}.chip{c}.hbm", NodeKind.STORAGE,
                                      parent=host, attrs={"rclass": "hbm"}))
                g.add_edge(chip.name, hbm.name, bandwidth=TPU_V5E["mem_bw"],
                           latency=1e-7)
                if prev_chip is not None:
                    g.add_edge(prev_chip, chip.name, bandwidth=ici_bw,
                               latency=ici_lat, name=f"ici_{chip.name}")
                prev_chip = chip.name
        for i, host in enumerate(host_names):     # host ring over ICI
            nxt = host_names[(i + 1) % len(host_names)]
            g.add_edge(host, nxt, bandwidth=ici_bw * chips_per_host / 4,
                       latency=ici_lat, name=f"ici_{host}")
            g.add_edge(host, "dcn", bandwidth=dcn_bw, latency=dcn_lat,
                       name=f"dcn_{host}")
    return Testbed(graph=g, edges=[], servers=pods, edge_kind={},
                   server_kind={p: "tpu_pod" for p in pods})
