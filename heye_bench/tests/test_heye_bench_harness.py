"""The port's benchmark harness on the CPU, at each cell's tiny twin (the
``tiny`` overrides in its configuration and traffic files): every
traffic mix through the program and the reference, every per-layer
metric's arithmetic, the control and the planted faults that the check
must catch, the frozen kernel byte counts, the names in BENCHMARK.json,
a configuration added by files alone, and the run without a card."""
from __future__ import annotations

import ast
import copy
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "heye_bench"
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from heye_bench import (check, control, harness, roofline,  # noqa: E402
                        workload)
from heye_bench.reference import scheduler  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def twin(cfg: dict, traffic: dict) -> tuple:
    """A configuration and a traffic mix with their ``tiny`` overrides
    applied: the configuration's ``deployment`` replaced and its
    ``application`` updated, the traffic's keys updated."""
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    for key, v in cfg.pop("tiny").items():
        if key == "application":
            cfg[key].update(v)
        else:
            cfg[key] = v
    traffic.update(traffic.pop("tiny"))
    return cfg, traffic


def tiny(cell: str, bench: dict = BENCH, root: Path = ROOT) -> tuple:
    """The cell's CPU twin, from its files under ``root``."""
    _, cfg, traffic = workload.cell_files(root, bench, cell)
    return twin(cfg, traffic)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(cell: str, seed: int = 7, trace: bool = False,
        bench: dict = BENCH, root: Path = ROOT) -> dict:
    cfg, traffic = tiny(cell, bench, root)
    return harness.run_cell(bench, cell, cfg, traffic, seed, 0.0, trace,
                            "cpu", 0.0, log=lambda m: None)


CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_checks_on_the_cpu(cell):
    """Each traffic mix through the program, at a tiny fleet, traced:
    every per-layer metric of the cell that has something to read on the
    CPU, and a check the reference passes."""
    res = run(cell, trace=True)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    names = {m["name"] for m in harness.cell_metrics(BENCH, cell,
                                                     "per_layer")}
    cpu_silent = {n for n in names if n.startswith(("kernels_roofline",
                                                    "device_idle_pct"))}
    assert set(res["metrics"]) == names - cpu_silent
    for m in res["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] >= 0


@pytest.mark.parametrize("cell", CELLS)
def test_end_to_end_metrics(cell):
    res = run(cell, seed=2**31 + 5)
    want = {m["name"] for m in harness.cell_metrics(BENCH, cell,
                                                    "end_to_end")}
    assert set(res["metrics"]) == want and "setup_s" in want
    assert all(m["value"] > 0 for m in res["metrics"].values())


def test_device_metric_arithmetic():
    """The trace readers on a reading as the card gives it."""
    r = {"work": 10, "spans": {"map_pending": 0.5,
                                                  "execute": 0.25},
         "phase_wall": {"map": 1.0, "advance": 0.5, "sync": 0.25,
                        "admit": 0.1},
         "launches": 40, "syncs": 20, "window_s": 2.0, "busy_s": 0.5,
         "roofline": (1e-6, 1e-3)}
    want = {"map_ms_per_task.batch": 50.0, "execute_ms_per_task.batch": 25.0,
            "walk_ms_per_request.serve": 100.0,
            "des_ms_per_request.serve": 75.0, "launches_per_task.batch": 4.0,
            "syncs_per_request.serve": 2.0, "kernels_roofline.batch": 0.1,
            "device_idle_pct.serve": 75.0}
    for name, v in want.items():
        assert harness.load_metric(name).read(r) == pytest.approx(v)
    r["roofline"] = (1e-6, 0.0)
    assert harness.load_metric("kernels_roofline.serve").read(r) is None


def test_reference_alone_at_the_tiny_fleet():
    """The reference's own session and loop: every task placed and
    finished, the overhead charged, and its float32 twin apart from it
    by more than the limit (the control)."""
    cfg, traffic = tiny("mining-paper.batch")
    seeds = workload.iteration_seeds(3, 0)
    mode = workload.load("modes", "session")
    rows = mode.reference_rows(cfg, traffic, seeds)
    assert len(rows) == 72 and all(math.isfinite(r[4]) for r in rows)
    assert all(r[3] > 0 for r in rows)
    low = mode.reference_rows(cfg, traffic, seeds, scheduler.f32)
    numbers = check.compare(low, rows)
    assert not check.verdict(numbers)
    assert numbers["finish_gap"] > check.LIMITS["finish_gap"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_check(cell):
    """The reference computed in float32, put in the program's place, at
    the tiny fleet: the check must call it wrong."""
    cfg, traffic = tiny(cell)
    numbers = control.control_numbers(cfg, traffic,
                                      workload.iteration_seeds(11, 0))
    assert not check.verdict(numbers), numbers


def _break_commit(monkeypatch):
    """A step that returns its state unchanged: the orchestrator's
    commits never reach its ledger."""
    from repro_torch.core import orchestrator
    monkeypatch.setattr(orchestrator.ActiveLedger, "add",
                        lambda self, *a, **k: None)


def _drop_half(monkeypatch):
    """Half of the batch left out: the second half of each mapping wave is
    never walked (the session falls back to any supporting PU), and the
    serving loop admits only every other request."""
    from repro_torch.core import orchestrator, serving
    orig = orchestrator.Orchestrator.map_batch
    orig_admit = serving.ServeLoop._admit_wave

    def half(self, tasks, *a, **k):
        tasks = list(tasks)
        keep = max(1, len(tasks) // 2)
        out = orig(self, tasks[:keep], *a, **k)
        return out + [None] * (len(tasks) - keep)

    def every_other(self, now, wave, events):
        orig_admit(self, now, [r for r in wave if r.rid % 2 == 0], events)
    monkeypatch.setattr(orchestrator.Orchestrator, "map_batch", half)
    monkeypatch.setattr(serving.ServeLoop, "_admit_wave", every_other)


def _alter_placement(monkeypatch):
    """An answer altered where it is produced: the first placement of each
    mapping wave moved to another PU that can run its task."""
    from repro_torch.core import orchestrator
    orig = orchestrator.Orchestrator.map_batch

    def moved(self, tasks, *a, **k):
        tasks = list(tasks)
        out = orig(self, tasks, *a, **k)
        r = out[0] if out else None
        if r is not None:
            r.pu = next(p.name for p in self.graph.pus()
                        if p.name != r.pu
                        and p.model.supports(tasks[0], p))
        return out
    monkeypatch.setattr(orchestrator.Orchestrator, "map_batch", moved)


def _alter_finish(monkeypatch):
    """An answer altered where it is produced: the ground truth's first
    finish time of each run off by a part in a billion."""
    from repro_torch.core import session, timeline
    orig = timeline.TimelineEngine.finish_of
    orig_exec = session.SchedulerSession.execute
    orig_final = session.SchedulerSession.finalize_online

    def off(self, uid):
        v = orig(self, uid)
        return v * (1 + 1e-9) if uid == min(self.slot_of) else v

    def off_stats(stats):
        stats.timeline.finish[min(stats.timeline.finish)] *= 1 + 1e-9
        return stats
    monkeypatch.setattr(timeline.TimelineEngine, "finish_of", off)
    monkeypatch.setattr(session.SchedulerSession, "execute",
                        lambda self: off_stats(orig_exec(self)))
    monkeypatch.setattr(session.SchedulerSession, "finalize_online",
                        lambda self, *a, **k: off_stats(
                            orig_final(self, *a, **k)))


FAULTS = {"state_unchanged": _break_commit, "half_left_out": _drop_half,
          "placement_altered": _alter_placement,
          "finish_altered": _alter_finish}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_fails_the_check(cell, fault, monkeypatch):
    """The harness with its look for a card skipped, the timed path
    broken underneath: ``correct`` comes out false."""
    FAULTS[fault](monkeypatch)
    res = run(cell, seed=13)
    assert not res["correct"], res["checks"]


CHURN_CELLS = [c for c in CELLS
               if workload.cell_files(ROOT, BENCH, c)[2]["mode"] == "churn"]


@pytest.mark.parametrize("cell", CHURN_CELLS)
def test_churn_never_reaching_the_program_fails_the_check(cell, monkeypatch):
    """A churn batch that never reaches the program (``churn`` a no-op):
    the program maps and executes on nominal uplinks while the reference
    follows the schedule, and ``correct`` comes out false."""
    from repro_torch.core import session
    monkeypatch.setattr(session.SchedulerSession, "churn",
                        lambda self, *a, **k: None)
    res = run(cell, seed=13)
    assert not res["correct"], res["checks"]
    assert res["checks"]["inputs_differ"]["value"] > 0


def test_churn_schedule_recovers_then_degrades():
    """Each batch first returns the previous batch's degraded uplinks to
    nominal, then drops a fresh quarter of them to 5-50 % of nominal; the
    seed moves which uplinks and how far, never how many."""
    mode = workload.load("modes", "churn")
    cfg, traffic = tiny("mining-paper.bwchurn")
    full = json.loads((BENCH_DIR / "traffic" / "bwchurn.json").read_text())
    nom = mode.nominal(json.loads(
        (BENCH_DIR / "configs" / "mining-paper.json").read_text()))
    assert len(nom) == 80 and len(set(nom)) == 1
    draws = [mode.schedule(full, workload.iteration_seeds(s, 0), nom)
             for s in (3, 2**40 + 1)]
    assert draws[0] != draws[1]
    for sched in draws:
        assert len(sched) == 8
        prev: list = []
        for batch in sched:
            back = batch[:len(prev)]
            assert back == [(e, nom[e]) for e in prev]
            down = batch[len(prev):]
            assert len(down) == 20 and len({e for e, _ in down}) == 20
            assert all(0.05 * nom[e] <= bw <= 0.5 * nom[e] for e, bw in down)
            prev = [e for e, _ in down]
    assert len(mode.schedule(traffic, [1, 2], mode.nominal(cfg))) == 2


def test_every_cell_file_has_a_tiny_twin():
    """The tests run each cell on its configuration's and traffic mix's
    ``tiny`` overrides; a file without them is named here."""
    missing = set()
    for w in BENCH["workloads"]:
        conf = {c["name"]: c for c in BENCH["configs"]}[w["config"]]
        for path in (ROOT / conf["file"],
                     BENCH_DIR / "traffic" / f"{w['traffic']}.json"):
            if not isinstance(json.loads(path.read_text()).get("tiny"), dict):
                missing.add(str(path.relative_to(ROOT)))
    assert not missing, f"no tiny object in {sorted(missing)}"


def test_a_configuration_added_by_files_alone(tmp_path):
    """A configuration copied under a new name, with a BENCHMARK.json that
    lists it and a cell on it, runs through the program and the reference
    on its CPU twin, with no edit to this file."""
    (tmp_path / "heye_bench" / "configs").mkdir(parents=True)
    (tmp_path / "heye_bench" / "traffic").mkdir()
    cfg = json.loads((BENCH_DIR / "configs" / "mining-paper.json")
                     .read_text())
    cfg["name"] = "mining-copy"
    (tmp_path / "heye_bench" / "configs" / "mining-copy.json").write_text(
        json.dumps(cfg))
    (tmp_path / "heye_bench" / "traffic" / "batch.json").write_text(
        (BENCH_DIR / "traffic" / "batch.json").read_text())
    bench = copy.deepcopy(BENCH)
    bench["configs"] = [{"name": "mining-copy", "source": cfg["source"],
                         "file": "heye_bench/configs/mining-copy.json",
                         "reduced": [], "why": "a copy"}]
    bench["workloads"] = [{"name": "mining-copy.batch",
                           "config": "mining-copy", "traffic": "batch",
                           "chips": 1, "why": "a copy"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["mining-copy.batch"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    got, want = tiny("mining-copy.batch", bench, tmp_path), \
        tiny("mining-paper.batch")
    assert got == ({**want[0], "name": "mining-copy"}, want[1])
    res = run("mining-copy.batch", trace=True, bench=bench, root=tmp_path)
    assert res["correct"], res["checks"]
    assert res["attempted"] == 72 and "walk_syncs_per_task.batch" in \
        res["metrics"]


def _summary(walk_reads: int, des_reads: int, tasks: int,
             requests: int) -> dict:
    return {"spans": {"walk.map_batch": {"reads": walk_reads},
                      "des.flush": {"reads": 7}},
            "layers": {"des": {"reads": des_reads}},
            "counters": {"walk.tasks": tasks},
            "work": {"tasks": tasks, "requests": requests}}


def test_program_span_metric_arithmetic():
    """The readers of the program's spans on a hand-made reading: walk
    reads inside ``walk.map_batch``, DES reads inside the outermost
    ``des.*`` spans, per ``walk.tasks`` and per decided request; nothing
    where the tree records no spans or the work is nil.  The churn
    reader: the ``churn`` span per wave."""
    r = {"work": 10, "spans": {"churn": 0.04}, "phase_wall": {"waves": 8},
         "program": _summary(540, 1185, 300, 50)}
    want = {"walk_syncs_per_task.batch": 1.8,
            "des_syncs_per_task.bwchurn": 3.95,
            "walk_syncs_per_request.serve": 10.8,
            "des_syncs_per_request.serve": 23.7,
            "churn_ms_per_wave.bwchurn": 5.0}
    for name, v in want.items():
        assert harness.load_metric(name).read(r) == pytest.approx(v)
    for p in (None, _summary(5, 5, 0, 0)):
        r["program"] = p
        for name in want:
            if not name.startswith("churn"):
                assert harness.load_metric(name).read(r) is None, name
    r["phase_wall"] = {}
    assert harness.load_metric("churn_ms_per_wave.x").read(r) is None


def test_program_reading_counts_each_layers_reads_once():
    """A layer's reads are those of its outermost spans, their
    descendants' included: a ``des.flush`` inside ``des.advance`` is not
    counted again, one outside it is."""
    from repro_torch import spans
    with spans.record() as rec:
        top = spans.enter("session.execute")
        adv = spans.enter("des.advance")
        spans.count_read()
        fl = spans.enter("des.flush")
        la = spans.enter("launch.settle_reprice")
        spans.count_read()
        spans.count_launch()
        spans.leave(la)
        spans.leave(fl)
        spans.leave(adv)
        fl = spans.enter("des.flush")
        spans.count_read()
        spans.leave(fl)
        spans.count_read()
        spans.leave(top)
        spans.add("walk.tasks", 4)
    p = harness.program_reading(rec)
    assert p["layers"]["des"] == {"count": 2, "total_s": pytest.approx(
        p["spans"]["des.advance"]["total_s"] + rec.totals()[4]["seconds"]),
        "reads": 3, "launches": 1}
    assert p["layers"]["session"]["reads"] == 4
    assert p["layers"]["launch"]["reads"] == 1
    assert p["spans"]["des.flush"]["reads"] == 2
    assert harness.load_metric("des_syncs_per_task.x").read(
        {"program": p}) == pytest.approx(0.75)


def test_idle_gaps_go_to_the_innermost_span():
    from heye_bench.trace import Window
    w = Window.__new__(Window)
    w.host0, w.window_s = 0.0, 10.0
    w.events = [(1.0, 2.0, "k"), (4.0, 5.0, "k"), (8.0, 9.0, "k")]
    spans = [(7.5, 9.2, "map_pending"), (0.0, 7.0, "execute"),
             (0.4, 6.0, "des.advance"), (2.5, 3.5, "des.flush")]
    # gaps (0, 1), (2, 4), (5, 8), (9, 10), read at their middles
    assert dict(w.idle_by_span(spans, "between")) == pytest.approx(
        {"des.advance": 1.0, "des.flush": 2.0, "execute": 3.0,
         "between": 1.0})


def test_frozen_byte_counts():
    """The kernel table's bound_ms for B1's row form at N=4223 R=6 and for
    B4 at P=8448 (1408 plan nodes, one feasible scan)."""
    nb, ops = roofline.row_cost(torch.zeros(4223, 6))
    assert roofline.least_seconds(nb, ops) * 1e3 == pytest.approx(
        0.0000908, rel=5e-3)
    rows = torch.tensor([[0.0, 6, 1, 3e-5, 0.01, 1.0, 0.0]])
    nb, ops = roofline.scan_cost(8448, 1408, rows, False)
    assert roofline.least_seconds(nb, ops) * 1e3 == pytest.approx(
        0.0000429, rel=5e-3)


def test_frozen_rewalk_byte_count():
    """The kernel table's bound_ms for the fused re-walk at a mining
    re-walk's median segment: C=3 candidates against A=6 actives on a
    6-PU plan of 2 nodes, R=6: 1312 bytes."""
    from types import SimpleNamespace
    z = torch.zeros
    seg = SimpleNamespace(Pc=z(3), eff_cols=z(3), Pa=z(6), nseg=6, ok=z(6),
                          plan=SimpleNamespace(n=2))
    nb, ops = roofline.rewalk_cost(seg, 6)
    assert (nb, ops) == (1312, 714)
    assert roofline.least_seconds(nb, ops) * 1e3 == pytest.approx(
        0.000000392, rel=5e-3)
    assert roofline.is_port_kernel("void rewalk_entry_kernel<Acc>(RwArgs)")


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_names_units_and_files():
    names = [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(names[:len(BENCH["configs"]) + len(BENCH["workloads"])
                     + len(BENCH["end_to_end"]) + len(BENCH["per_layer"])]))\
        == len(BENCH["configs"]) + len(BENCH["workloads"]) \
        + len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert callable(harness.load_metric(m["name"]).read)
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert callable(workload.application(cfg).program_session)
    for w in BENCH["workloads"]:
        traffic = json.loads((BENCH_DIR / "traffic"
                              / f"{w['traffic']}.json").read_text())
        assert callable(workload.load("modes", traffic["mode"]).Program)
        if "arrivals" in traffic:
            assert callable(workload.load("arrivals",
                                          traffic["arrivals"]).times)
        assert w["name"] == f"{w['config']}.{w['traffic']}"


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_nothing_imports_jax_or_the_jax_package():
    """Top-level module names compared whole: ``repro_torch`` is the
    program, ``repro`` the JAX package."""
    for path in BENCH_DIR.rglob("*.py"):
        assert not _imports(path) & set(harness.BANNED), path
    for path in (BENCH_DIR / "reference").rglob("*.py"):
        assert "repro_torch" not in _imports(path), path


def test_run_without_a_card_fails():
    """Without a CUDA device the command exits non-zero and prints no
    result (on a machine with a card there is nothing to show)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, str(BENCH_DIR / "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_every_seed_offers_the_same_work():
    """The serving mix moves its arrivals with the seed, never their
    number: each sensor sends once per period of the horizon."""
    cfg, traffic = tiny("mining-paper.serve")
    serve = workload.load("modes", "serve")
    span = serve.horizon(cfg, traffic)
    draws = [serve.arrival_times(cfg, traffic,
                                 workload.iteration_seeds(s, 0), span)
             for s in (1, 2**40 + 9)]
    for a, b in zip(*draws):
        assert a[0] == b[0] and len(a[1]) == len(b[1]) == 2
        assert not (a[1] == b[1]).all()
        assert (0 <= a[1]).all() and (a[1] < span).all()


def test_iteration_seeds_take_large_seeds():
    a = workload.iteration_seeds(2**40 + 3, 0)
    assert a != workload.iteration_seeds(2**40 + 3, 1)
    assert all(0 <= s < 2**32 for s in a)


# -- topologies --------------------------------------------------------------
STREAMS = BENCH_DIR / "tests" / "tpu-streams.json"


@pytest.fixture
def streams(monkeypatch):
    """The test-side application ``streams`` (``tests/stream_app.py``),
    registered as ``apps/streams.py`` would be."""
    spec = importlib.util.spec_from_file_location(
        "heye_bench.apps.streams", BENCH_DIR / "tests" / "stream_app.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setitem(workload._LOADED, ("apps", "streams"), mod)
    return mod


def _tiny_config(name: str) -> dict:
    path = STREAMS if name == "tpu-streams" else \
        BENCH_DIR / "configs" / f"{name}.json"
    return twin(json.loads(path.read_text()), {"tiny": {}})[0]


def test_default_topology_is_edge_server():
    """Without ``deployment.topology`` a configuration is the paper's
    edge-server testbed: the program's testbed is ``core.build_testbed``
    of its counts, as before topologies were named."""
    import repro_torch.core as core
    for name in ("mining-paper", "vr-paper"):
        cfg = _tiny_config(name)
        assert "topology" not in cfg["deployment"]
        assert workload.topology(cfg) is workload.load("topologies",
                                                        "edge_server")
        dep = cfg["deployment"]
        want = core.build_testbed(edge_counts=dep["edge_counts"],
                                  server_counts=dep["server_counts"],
                                  device="cpu")
        got = workload.build_testbed(core, cfg, "cpu")
        assert (got.edges, got.servers) == (want.edges, want.servers)
        assert [p.name for p in got.graph.pus()] == \
            [p.name for p in want.graph.pus()]


@pytest.mark.parametrize("name", ["mining-paper", "vr-paper", "tpu-streams"])
def test_fleet_matches_the_program_testbed(name):
    """The reference's fleet and the program's testbed of one deployment:
    the same PUs, each device's PUs in the order its ORC scans them, the
    clusters in the order of the root's children, and between every two
    devices the same links, by name, bandwidth and latency."""
    import repro_torch.core as core
    cfg = _tiny_config(name)
    tb = workload.build_testbed(core, cfg, "cpu")
    fl = workload.ref_fleet_of(cfg)
    g = tb.graph
    assert [p.name for p in fl.pus] == g.compiled().pu_names
    root = core.build_orchestrators(g, core.heye_traverser(g))
    devices = {o.group: o for o in root.iter_tree() if o.is_device_orc()}
    assert [[fl.devices[d].name for d in c] for c in fl.clusters] == \
        [[o.group for o in c.iter_tree() if o.is_device_orc()]
         for c in root.children]
    for d in fl.devices:
        assert [fl.pus[p].name for p in d.pus] == devices[d.name].leaf_pus
    comp = g.compiled()
    n = len(fl.devices)
    for a in range(n):
        for b in range(n):
            if a == b:
                continue
            want = comp.route_edges(fl.devices[a].name, fl.devices[b].name)
            got = fl.route(a, b)
            assert [fl.link_names[k] for k in got] == [e.name for e in want]
            assert [tuple(fl.links[k]) for k in got] == \
                [(e.bandwidth, e.latency) for e in want]


def test_tied_routes_are_named_not_guessed():
    """Between opposite hosts of a pod with an even number of hosts the
    two arcs of the ring tie: the reference names both, prices the
    transfer (the same on either), and refuses to say which links it
    occupies."""
    cfg = _tiny_config("tpu-streams")
    cfg["deployment"]["hosts_per_pod"] = 4
    fl = workload.ref_fleet_of(cfg)
    assert len(fl.routes(0, 2)) == 2 and len(fl.routes(0, 1)) == 1
    with pytest.raises(ValueError):
        fl.route(0, 2)
    assert fl.transfer_time(0, 2, 1e6) == pytest.approx(
        2e-6 + 1e6 / 25e9, rel=1e-12)
    assert fl.route(0, 5) == [fl.devices[0].link, fl.devices[5].link]


def _streams_bench(tmp_path) -> dict:
    """A BENCHMARK.json under ``tmp_path`` with the two-pod configuration
    and one ``batch`` cell on it, every file copied as a PR would add
    it."""
    (tmp_path / "heye_bench" / "configs").mkdir(parents=True)
    (tmp_path / "heye_bench" / "traffic").mkdir()
    (tmp_path / "heye_bench" / "configs" / "tpu-streams.json").write_text(
        STREAMS.read_text())
    (tmp_path / "heye_bench" / "traffic" / "batch.json").write_text(
        (BENCH_DIR / "traffic" / "batch.json").read_text())
    bench = copy.deepcopy(BENCH)
    bench["configs"] = [{"name": "tpu-streams", "source": "a test",
                         "file": "heye_bench/configs/tpu-streams.json",
                         "reduced": [], "why": "a test"}]
    bench["workloads"] = [{"name": "tpu-streams.batch",
                           "config": "tpu-streams", "traffic": "batch",
                           "chips": 1, "why": "a test"}]
    for kind in ("end_to_end", "per_layer"):
        bench[kind] = [m for m in bench[kind] if "mining-paper.batch"
                       in m.get("workloads", ["mining-paper.batch"])]
        for m in bench[kind]:
            if "workloads" in m:
                m["workloads"] = ["tpu-streams.batch"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return json.loads((tmp_path / "BENCHMARK.json").read_text())


def test_a_topology_added_by_files_alone(tmp_path, streams, monkeypatch):
    """A configuration naming ``tpu_pods``, two pods of 11 hosts of 2
    chips, every host sending streams: correct on its CPU twin through
    the program and the reference, with transfers over the ring and
    across pods; every wave's walks driven per pod (the group-sharded
    walk's ``stop_root`` drive on both pods) and fanned out to host
    threads where the host has two or more cores."""
    from repro_torch.core import orchestrator
    drives, fans = [], []
    orig = orchestrator.Orchestrator._drive_wave

    def drive(self, walks, now, ctx, stop_root=False):
        if stop_root:
            drives.append({self._shard_root_of(w.orc).group for w in walks})
        return orig(self, walks, now, ctx, stop_root=stop_root)

    class Pool(orchestrator.ThreadPoolExecutor):
        def __init__(self, *a, **k):
            fans.append(k["max_workers"])
            super().__init__(*a, **k)
    monkeypatch.setattr(orchestrator.Orchestrator, "_drive_wave", drive)
    monkeypatch.setattr(orchestrator, "ThreadPoolExecutor", Pool)
    bench = _streams_bench(tmp_path)
    res = run("tpu-streams.batch", trace=True, bench=bench, root=tmp_path)
    assert res["correct"], res["checks"]
    assert res["attempted"] == 286 and res["failed"] == 0
    assert "walk_syncs_per_task.batch" in res["metrics"]
    assert {"pod0"} in drives and {"pod1"} in drives
    assert all(len(d) == 1 for d in drives)
    if (os.cpu_count() or 1) >= 2:
        assert fans and all(n == 2 for n in fans)
    cfg, traffic = tiny("tpu-streams.batch", bench, tmp_path)
    rows = workload.load("modes", "session").reference_rows(
        cfg, traffic, workload.iteration_seeds(7, 0))
    hosts = [(r[0][1], r[2].rsplit(".", 1)[0]) for r in rows]
    assert sum(a != b for a, b in hosts) > 0
    assert sum(a.split(".")[0] != b.split(".")[0] for a, b in hosts) > 0


@pytest.mark.parametrize("fault", ["control", "placement_altered"])
def test_topology_cell_fails_the_check(fault, tmp_path, streams,
                                       monkeypatch):
    """On the two-pod twin, the float32 reference in the program's place
    and a placement moved where it is produced: not correct."""
    bench = _streams_bench(tmp_path)
    if fault == "control":
        cfg, traffic = tiny("tpu-streams.batch", bench, tmp_path)
        numbers = control.control_numbers(cfg, traffic,
                                          workload.iteration_seeds(11, 0))
        assert not check.verdict(numbers), numbers
    else:
        FAULTS[fault](monkeypatch)
        res = run("tpu-streams.batch", seed=13, bench=bench, root=tmp_path)
        assert not res["correct"], res["checks"]


def test_unknown_topology_raises():
    import repro_torch.core as core
    cfg = _tiny_config("mining-paper")
    cfg["deployment"]["topology"] = "no-such-topology"
    with pytest.raises(ValueError):
        workload.build_testbed(core, cfg, "cpu")
    with pytest.raises(ValueError):
        workload.ref_fleet_of(cfg)
