"""A test-side application for a fleet whose every device sends work:
each wave, every device of the deployment (every host of every pod) sends
``per_host[h % len(per_host)]`` request streams, stream ``j`` carrying
``input_bytes x (1 + j / 8)`` so that no two walks of a wave are alike.
Waves leave at ``w x period_s``; each stream has the wave's deadline and
the usage the configuration states (``place_tenants``'s streams by
default).

The tests register it as the application ``streams``; it is no kind of
the benchmark's own.
"""
from __future__ import annotations

from heye_bench.reference.fleet import TaskMaker

KIND = "serve_stream"


def specs(cfg: dict, n_devices: int, scale: float = 1.0) -> list:
    """(device index, deadline, input bytes, output bytes, release) per
    stream, wave by wave and device by device (``scale`` < 1 keeps that
    share of the waves)."""
    app = cfg["application"]
    waves = max(1, int(app["waves"] * scale))
    per = app["per_host"]
    return [(d, app["deadline_s"], app["input_bytes"] * (1 + j / 8),
             app["output_bytes"], w * app["period_s"])
            for w in range(waves) for d in range(n_devices)
            for j in range(per[d % len(per)])]


def program_session(core, tb, cfg: dict, scale: float = 1.0):
    hosts = [n.name for n in tb.graph.nodes.values()
             if n.attrs.get("orc_level") == "device"]
    g = core.TaskGraph("streams")
    for d, deadline, nin, nout, release in specs(cfg, len(hosts), scale):
        t = core.make_task(KIND, origin=hosts[d], deadline=deadline,
                           input_bytes=nin, output_bytes=nout,
                           release_time=release)
        t.usage = dict(cfg["application"]["usage"])
        g.add(t)
    return g


def reference_session(fl, cfg: dict) -> list:
    mk, usage = TaskMaker(), cfg["application"]["usage"]
    out = []
    for d, deadline, nin, nout, release in specs(cfg, len(fl.devices)):
        t = mk.make(KIND, d, deadline, nin, nout, release)
        t.u_pu, t.u_mem = usage["pu"], usage["mem"]
        out.append(t)
    return out
