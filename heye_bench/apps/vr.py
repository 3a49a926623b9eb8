"""The cloud-rendered VR application (the H-EYE paper, section 4): per
headset and frame the serial chain capture -> pose_pred -> render ->
encode -> decode -> reproject -> display at the headset's FPS, its data
passed over the routes between stages.

The program's chains come from its own ``vr_workload``; the reference
builds its own (``reference/fleet.py``) and the check compares the two
task by task, so the inputs are the same or the run is not correct.
"""
from __future__ import annotations

from heye_bench.reference import fleet as ref_fleet


def program_session(core, tb, cfg: dict, scale: float = 1.0):
    frames = max(1, int(cfg["application"]["frames"] * scale))
    return core.vr_workload(tb, n_frames=frames)


def reference_session(fl, cfg: dict) -> list:
    return ref_fleet.vr_tasks(fl, ref_fleet.TaskMaker(),
                              cfg["application"]["frames"])
