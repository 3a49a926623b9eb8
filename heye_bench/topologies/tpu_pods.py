"""An accelerator fleet of pods -> hosts -> chips: the pods are the root's
clusters and each host is a device, its chips the PUs.

The deployment gives ``n_pods``, ``hosts_per_pod`` and ``chips_per_host``;
the links' ``ici_bw``, ``ici_lat``, ``dcn_bw`` and ``dcn_lat``; and the
chips' ``max_tenancy`` and ``est_s``, the standalone seconds of a task of
size 1 on any chip (the profiled model of ``launch/serve.py``'s
``place_tenants``, ``est_s x size``; every application here makes tasks
of size 1).

The program's side is ``core.build_tpu_fleet`` with that model and
tenancy on every chip.  The reference's is built here from the same
numbers: each chip has its own HBM, so chips share no resource and
slow each other only as tenants of one chip; the hosts of a pod sit on a
ring of ICI links (host ``h``'s link joins it to host ``h + 1``) of
``ici_bw x chips_per_host / 4``, and every host has a DCN link.  A
transfer takes the route of least summed latency, as the program's
shortest path does.  Where two routes tie (the two arcs between opposite
hosts of a pod with an even number of hosts), the reference names both
and the ground truth refuses the transfer: it does not guess the
program's pick.
"""
from __future__ import annotations

import math
from typing import Optional

from heye_bench.reference.fleet import Fleet


def testbed(core, dep: dict, device):
    """The program's testbed for the deployment."""
    tb = core.build_tpu_fleet(
        n_pods=dep["n_pods"], hosts_per_pod=dep["hosts_per_pod"],
        chips_per_host=dep["chips_per_host"], dcn_bw=dep["dcn_bw"],
        dcn_lat=dep["dcn_lat"], ici_bw=dep["ici_bw"],
        ici_lat=dep["ici_lat"], device=device)
    est_s = dep["est_s"]
    model = core.CallableModel(fn=lambda t, pu, unit: est_s * t.size)
    for chip in tb.graph.pus():
        chip.model = model
        chip.max_tenancy = dep["max_tenancy"]
    return tb


class PodsFleet(Fleet):
    """The reference's pods: ``ring[p][h]`` is the ICI link from host
    ``h`` of pod ``p`` to the next, ``place[d]`` a device's (pod, host)."""

    def __init__(self, est_s: float) -> None:
        super().__init__()
        self.est_s = est_s
        self.ring: list = []
        self.place: list = []

    def routes(self, a: int, b: int) -> list:
        (pa, ha), (pb, hb) = self.place[a], self.place[b]
        cands = [[self.devices[a].link, self.devices[b].link]]
        if pa == pb:
            ring, n = self.ring[pa], len(self.ring[pa])
            cands.append([ring[(ha + i) % n] for i in range((hb - ha) % n)])
            cands.append([ring[(ha - 1 - i) % n]
                          for i in range((ha - hb) % n)])
        lats = []
        for r in cands:
            lat = 0.0
            for k in r:
                lat += self.links[k][1]
            lats.append(lat)
        least = min(lats)
        return [r for r, lat in zip(cands, lats) if lat == least]

    def standalone_s(self, kind: str, pu: int) -> Optional[float]:
        return self.est_s * 1.0


def fleet(dep: dict) -> PodsFleet:
    """The reference's fleet, in the program's build order: pod by pod,
    host by host, chip by chip."""
    if not (dep["ici_lat"] > 0 and dep["dcn_lat"] > 0):
        raise ValueError("the program's shortest path weighs a link of "
                         "no latency as 1e-9 s; give every link a latency")
    fl = PodsFleet(dep["est_s"])
    chips = [(f"chip{c}", "tpu", dep["max_tenancy"], math.inf,
              ((f"chip{c}.hbm", "hbm"),))
             for c in range(dep["chips_per_host"])]
    ring_bw = dep["ici_bw"] * dep["chips_per_host"] / 4
    for p in range(dep["n_pods"]):
        hosts, ring = [], []
        for h in range(dep["hosts_per_pod"]):
            name = f"pod{p}.host{h}"
            ring.append(fl.add_link(f"ici_{name}", ring_bw, dep["ici_lat"]))
            hosts.append(fl.add_device(
                name, "host", chips,
                fl.add_link(f"dcn_{name}", dep["dcn_bw"], dep["dcn_lat"])))
            fl.place.append((p, h))
        fl.ring.append(ring)
        fl.clusters.append(hosts)
    return fl
