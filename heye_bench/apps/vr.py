"""The cloud-rendered VR application (the H-EYE paper, section 4): per
headset and frame the serial chain capture -> pose_pred -> render ->
encode -> decode -> reproject -> display at the headset's FPS, its data
passed over the routes between stages.

The program's chains come from its own ``vr_workload``; the reference
builds its own (``reference_session``) and the check compares the two
task by task, so the inputs are the same or the run is not correct.
Each stage's deadline share comes from the Fig. 9 tables of the
``edge_server`` topology, the one this application runs on.
"""
from __future__ import annotations

from heye_bench import workload
from heye_bench.reference.fleet import KB, MB, MS, TaskMaker

EDGE_FPS = {"orin_agx": 30.0, "xavier_agx": 24.0, "orin_nano": 20.0,
            "xavier_nx": 20.0}
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
    fig9 = workload.load("topologies", "edge_server")

    def stage_cost(kind, side):
        if side == "edge":
            return min(fig9.VR_EDGE[kind][edge_kind].values()) * MS
        if kind in VR_PINNED or kind not in fig9.VR_SERVER:
            return inf
        return min(min(p.values())
                   for p in fig9.VR_SERVER[kind].values()) * MS

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


def vr_tasks(fl, mk: TaskMaker, n_frames: int) -> list:
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


def program_session(core, tb, cfg: dict, scale: float = 1.0):
    frames = max(1, int(cfg["application"]["frames"] * scale))
    return core.vr_workload(tb, n_frames=frames)


def reference_session(fl, cfg: dict) -> list:
    return vr_tasks(fl, TaskMaker(), cfg["application"]["frames"])
