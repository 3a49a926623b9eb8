"""What a cell is made of, found by name, and the seeds of its iterations.

A cell is ``<config>.<traffic>``: the configuration
``configs/<config>.json`` (the deployment and its application) and the
traffic mix ``traffic/<traffic>.json`` (how the work arrives), both
data.  The code that turns them into work is found by the names the data
gives, one file each, so that a new kind is a new file:

* ``modes/<mode>.py`` — the traffic file's ``mode``: the program's side
  of an iteration, the rows its output is judged by, the reference's
  rows for the same inputs, and the end-to-end metrics;
* ``topologies/<name>.py`` — the configuration's ``deployment.topology``
  (``edge_server`` where the key is absent): the program's testbed
  (``testbed``) and the reference's fleet (``fleet``), built from the
  same data;
* ``apps/<kind>.py`` — the configuration's ``application.kind``: its
  tasks for the program and for the reference, built from the same data;
* ``arrivals/<kind>.py`` — a serving mix's ``arrivals.kind``: the
  instants at which each source sends;
* ``metrics/<stem>.py`` — a per-layer metric ``<stem>.<suffix>``: its
  reader.

Each configuration and traffic file also holds its CPU twin, a ``tiny``
object of overrides that only the tests apply; the runs never read it.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
_LOADED: dict = {}


def load(kind: str, name: str):
    """The module ``heye_bench/<kind>/<name>.py``, loaded once."""
    key = (kind, name)
    if key not in _LOADED:
        path = HERE / kind / f"{name}.py"
        if not path.is_file():
            raise ValueError(f"no {kind} named {name!r} ({path})")
        spec = importlib.util.spec_from_file_location(
            f"heye_bench.{kind}.{name.replace('-', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[key] = mod
    return _LOADED[key]


def cell_files(root: Path, bench: dict, cell: str) -> tuple:
    """The cell's entry in ``bench``, and its configuration and traffic
    mix as read from their files under the checkout ``root``."""
    w = {c["name"]: c for c in bench["workloads"]}[cell]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "heye_bench" / "traffic"
                          / f"{w['traffic']}.json").read_text())
    return w, cfg, traffic


def iteration_seeds(seed: int, index: int) -> list:
    """Two 32-bit seeds per iteration, from the run's seed and the
    iteration's index: the arrivals' draw, then the ground truth's
    noise."""
    return [int(s) for s in
            np.random.SeedSequence([int(seed), int(index)]).generate_state(2)]


def application(cfg: dict):
    return load("apps", cfg["application"]["kind"])


def topology(cfg: dict):
    return load("topologies", cfg["deployment"].get("topology",
                                                    "edge_server"))


def build_testbed(core, cfg: dict, device):
    """The program's testbed for the configuration's deployment."""
    return topology(cfg).testbed(core, cfg["deployment"], device)


def ref_fleet_of(cfg: dict):
    """The reference's fleet for the same deployment."""
    return topology(cfg).fleet(cfg["deployment"])


def sync(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the
    CPU)."""
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize()
