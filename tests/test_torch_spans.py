"""The port's span recorder (``repro_torch.spans``): nesting, parents and
self time, per-thread stacks, the host-read and launch counters
attributed to the innermost open span, nothing recorded while no
recorder is open, the scheduler's answers bit-identical with the
recorder on and off, and the admission wave's verdict instants against
the benchmark harness's own admission timer.

The program runs on the CPU at the benchmark's tiny fleets (the mining
deployment at an eighth, the VR testbed at 4 frames); the CPU makes no
host reads and no launches, so the counters are driven directly."""
from __future__ import annotations

import copy
import json
import sys
import threading
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import repro_torch.core as core  # noqa: E402
import repro_torch.core.orchestrator as Torc  # noqa: E402
from repro_torch import device, spans  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

from heye_bench import harness, workload  # noqa: E402

TINY = {
    "mining-paper": {"deployment": {
        "edge_counts": {"orin_agx": 3, "xavier_agx": 3, "orin_nano": 2,
                        "xavier_nx": 2},
        "server_counts": {"server1": 1, "server2": 1, "server3": 1}},
        "application": {"sensors": 12, "readings": 2}},
    "vr-paper": {"application": {"frames": 4}},
}
CELLS = [("mining-paper", "batch"), ("vr-paper", "batch"),
         ("mining-paper", "serve")]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell(config: str, traffic: str):
    cfg = json.loads((ROOT / "heye_bench" / "configs"
                      / f"{config}.json").read_text())
    for key, v in copy.deepcopy(TINY[config]).items():
        if key == "application":
            cfg[key].update(v)
        else:
            cfg[key] = v
    tr = json.loads((ROOT / "heye_bench" / "traffic"
                     / f"{traffic}.json").read_text())
    if tr["mode"] == "serve":
        tr["horizon_periods"] = 2
    tb = workload.build_testbed(core, cfg, "cpu")
    mode = workload.load("modes", tr["mode"])
    return mode.Program(core, tb, cfg, tr)


def _iteration(config: str, traffic: str, seed: int = 7):
    """One benchmark iteration on the CPU: its rows and its program."""
    prog = _cell(config, traffic)
    out = prog.iteration(workload.iteration_seeds(seed, 0))
    return prog.rows(out), prog


# -- the recorder ------------------------------------------------------------
def test_nesting_parents_and_self_time():
    with spans.record() as rec:
        a = spans.enter("a", 0.0)
        b = spans.enter("b", 1.0)
        spans.leave(b, 3.0)
        c = spans.enter("c", 4.0)
        d = spans.enter("a", 4.5)          # a span inside one of its name
        spans.leave(d, 4.75)
        spans.leave(c, 5.0)
        spans.leave(a, 10.0)
        e = spans.enter("e", 11.0)
        spans.enter("orphan", 11.5)        # left open, as by an exception
        spans.leave(e, 12.0)
        late = spans.enter("late")
    assert [s.name for s in rec.spans] == ["a", "b", "c", "a", "e", "orphan",
                                           "late"]
    assert rec.parents() == [-1, 0, 0, 2, -1, 4, -1]
    tot = rec.totals()
    assert [t["self_s"] for t in tot[:6]] == [7.0, 2.0, 0.75, 0.25, 0.5, 0.5]
    assert rec.spans[5].end == 12.0
    assert late.end == rec.end            # ended by the recorder's close
    spans.leave(late, rec.end + 1.0)       # leaving it later does nothing
    assert late.end == rec.end
    s = rec.summary()["spans"]
    assert s["a"]["count"] == 2 and s["a"]["total_s"] == 10.0
    assert s["a"]["self_s"] == 7.25
    assert s["c"]["total_s"] == 1.0 and s["c"]["self_s"] == 0.75
    assert not spans.OPEN and spans.enter("x") is None


def test_one_recorder_at_a_time():
    with spans.record():
        with pytest.raises(RuntimeError):
            with spans.record():
                pass
    assert not spans.OPEN


def test_per_thread_stacks_and_spans_run_under_another_thread():
    go = threading.Barrier(2, timeout=10)
    with spans.record() as rec:
        main = spans.enter("main")

        def work(name):
            outer = spans.enter(name)
            go.wait()                      # both threads inside their span
            inner = spans.enter(name + ".inner")
            go.wait()
            spans.leave(inner)
            spans.leave(outer)
            spans.under(main, lambda: spans.leave(spans.enter(name + ".u")))

        ts = [threading.Thread(target=work, args=(n,)) for n in ("t1", "t2")]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in ts)
        spans.leave(main)
    names = [s.name for s in rec.spans]
    par = rec.parents()
    for n in ("t1", "t2"):
        assert par[names.index(n)] == -1
        assert par[names.index(n + ".inner")] == names.index(n)
        assert par[names.index(n + ".u")] == names.index("main")
        assert rec.spans[names.index(n)].thread != main.thread


def test_reads_and_launches_go_to_the_innermost_span():
    """The two counters, called directly, count in the innermost open
    span of the calling thread, in every ancestor's inclusive total, and
    outside any span where none is open; the global counters move as
    before."""
    counts = {"k": 0}
    s0 = device.sync_count()
    with spans.record() as rec:
        device._count_sync()               # outside any span
        a = spans.enter("a")
        b = spans.enter("b")
        device._count_sync()
        device._count_sync()
        build.count_launch(counts, "k")
        spans.leave(b)
        device._count_sync()
        t = threading.Thread(target=device._count_sync)  # its own stack
        t.start()
        t.join(timeout=10)
        spans.under(a, build.count_launch, counts, "k")
        spans.leave(a)
    assert device.sync_count() - s0 == 5 and counts["k"] == 2
    s = rec.summary()
    assert s["outside"] == {"reads": 2, "launches": 0}
    assert (s["spans"]["b"]["reads"], s["spans"]["b"]["launches"]) == (2, 1)
    a_ = s["spans"]["a"]
    assert (a_["self_reads"], a_["reads"]) == (1, 3)
    assert (a_["self_launches"], a_["launches"]) == (1, 2)


# -- the program's span sites --------------------------------------------------
@pytest.mark.parametrize("config,traffic", CELLS)
def test_no_recorder_records_nothing(config, traffic, monkeypatch):
    """With no recorder open no span site reaches the recorder: every one
    of its entry points raises if called."""
    def refuse(*a, **k):
        raise AssertionError("a span site ran with no recorder open")
    for name in ("enter", "leave", "add", "decided", "current",
                 "count_read", "count_launch"):
        monkeypatch.setattr(spans, name, refuse)
    rows, _ = _iteration(config, traffic)
    assert rows and not spans.OPEN


SESSION_SPANS = {"session.map_pending", "session.execute", "walk.map_batch",
                 "walk.checks", "walk.entry", "walk.escalate",
                 "walk.commit", "des.advance", "des.flush", "des.complete",
                 "launch.slowdown_same_device", "launch.scan_reduce_batch",
                 "launch.settle_reprice", "launch.settle_complete"}
SERVE_SPANS = {"serve.wave", "serve.sync", "serve.admit", "serve.step",
               "des.drain", "des.next"}


@pytest.mark.parametrize("config,traffic", CELLS)
def test_answers_equal_with_the_recorder_on(config, traffic):
    """Placements, verdicts, charged releases and finishes bit-identical
    with the recorder on and off; the spans of every layer recorded, the
    walk's counters within the tasks, the self times within the wall."""
    off, _ = _iteration(config, traffic)
    with spans.record() as rec:
        on, prog = _iteration(config, traffic)
    assert on == off
    s = rec.summary()
    names = set(s["spans"])
    assert SESSION_SPANS - {"session.execute"} <= names
    if traffic == "serve":
        assert SERVE_SPANS <= names
        assert s["work"]["requests"] == prog.work
    else:
        assert "session.execute" in names
        assert s["spans"]["session.map_pending"]["count"] == 1
        assert s["work"]["tasks"] == prog.work
    c = s["counters"]
    assert 0 < c["walk.walks"] <= c["walk.tasks"]
    assert 0 <= c["walk.rewalks"] <= c["walk.tasks"]
    assert s["outside"] == {"reads": 0, "launches": 0}
    tops = [t for t in rec.totals() if t["parent"] < 0]
    assert all(t["self_s"] >= 0 for t in rec.totals())
    assert sum(t["seconds"] for t in tops) <= s["window_s"]


@pytest.mark.parametrize("config,traffic", CELLS)
def test_recorder_opened_and_closed_mid_iteration(config, traffic):
    """The recorder as a part of the benchmark's tracer, which opens and
    closes over a whole session, or between two verdicts of a serving
    loop, inside an admission wave: span sites entered before it opened
    stay unrecorded, those open when it closes end there, and the
    answers do not move."""
    off, _ = _iteration(config, traffic, seed=11)
    prog = _cell(config, traffic)
    rec = spans.record()
    seeds = workload.iteration_seeds(11, 0)
    prog.traced(seeds, harness.Tracer([rec]))
    assert rec.end is not None and not spans.OPEN and rec.spans
    assert all(sp.end is not None and sp.end <= rec.end for sp in rec.spans)
    if traffic == "serve":
        mode = workload.load("modes", "serve")
        n = sum(len(t) for _, t in mode.arrival_times(
            prog.cfg, prog.traffic, seeds, mode.horizon(prog.cfg,
                                                        prog.traffic)))
        assert 0 < rec.summary()["work"]["requests"] < n
    on, _ = _iteration(config, traffic, seed=11)
    assert on == off


def test_wave_verdicts_cover_the_harness_admission_timer():
    """Every decided request in exactly one ``serve.wave`` span, and its
    interval there (the wave's start to its verdict instant) holds the
    interval the benchmark's ``AdmissionController`` subclass times."""
    prog = _cell("mining-paper", "serve")
    with spans.record() as rec:
        loop, st = prog.iteration(workload.iteration_seeds(5, 0))
    waves = rec.waves()
    rids = [rid for _, v in waves for rid, _ in v]
    assert sorted(rids) == sorted(r.rid for r in st.requests)
    assert len(set(rids)) == len(rids)
    wait = loop.admission.wait
    timed = [(a, b) for a, b, name in prog.spans if name == "admit"]
    assert len(timed) == len(waves)
    for (sp, verdicts), (h0, h1) in zip(waves, timed):
        assert sp.start <= h0 and h1 <= sp.end
        for rid, t in verdicts:
            assert h0 + wait[rid] <= t <= sp.end


def test_threaded_walk_nests_under_map_batch(monkeypatch):
    """The group-sharded walk's host threads: their spans hang under the
    ``walk.map_batch`` span of the thread that opened them, and a launch
    counted in a group thread lands in that thread's span."""
    monkeypatch.setattr("os.cpu_count", lambda: 4)
    made = []
    real_pool = Torc.ThreadPoolExecutor

    class Pool(real_pool):
        def __init__(self, *a, **k):
            made.append(k.get("max_workers"))
            super().__init__(*a, **k)

    counts = {"scan_reduce_batch": 0}
    real_batch = Torc.scan_reduce_batch

    def counted(*a):
        build.count_launch(counts, "scan_reduce_batch")
        return real_batch(*a)

    monkeypatch.setattr(Torc, "ThreadPoolExecutor", Pool)
    monkeypatch.setattr(Torc, "scan_reduce_batch", counted)
    tb = core.build_testbed(device="cpu")
    devs = list(tb.edges) + list(tb.servers)
    kinds = ["svm", "mlp", "knn", "dnn"]
    tasks = [core.make_task(kinds[i % 4], origin=devs[i % len(devs)],
                            deadline=0.2 + 1e-4 * i) for i in range(160)]
    g = tb.graph
    sess = core.SchedulerSession(g, core.build_orchestrators(
        g, core.heye_traverser(g)))
    sess.submit(tasks)
    with spans.record() as rec:
        sess.map_pending()
    assert made == [2]
    par = rec.parents()
    top = [i for i, s in enumerate(rec.spans) if s.name == "walk.map_batch"]
    assert len(top) == 1
    main = rec.spans[top[0]].thread
    away = [i for i, s in enumerate(rec.spans) if s.thread != main]
    assert away
    for i in away:
        while par[i] >= 0 and rec.spans[par[i]].thread != main:
            i = par[i]
        assert par[i] == top[0]
    s = rec.summary()
    assert s["spans"]["walk.map_batch"]["launches"] == counts[
        "scan_reduce_batch"] > 0
    assert s["outside"]["launches"] == 0


# -- the fused re-walk's counter ---------------------------------------------
def _count_on_the_cpu(monkeypatch) -> tuple:
    """Make the CPU count what the card counts: every host read through
    the ``device`` helpers, and one launch for every call of a kernel
    wrapper (counted as it returns), wherever the program calls them.
    Returns the wrappers' counter dicts."""
    from repro_torch.kernels import slowdown_kernel, timeline_kernel, walk_kernel
    mods = [m for n, m in list(sys.modules.items())
            if n.startswith("repro_torch") and m is not None]

    def everywhere(fn, new):
        for m in mods:
            for attr, v in list(vars(m).items()):
                if v is fn:
                    monkeypatch.setattr(m, attr, new)

    for name in ("host_list", "host_item", "host_numpy", "nonzero"):
        fn = getattr(device, name)

        def read(*a, _fn=fn, **k):
            device._count_sync()
            return _fn(*a, **k)
        everywhere(fn, read)
    counters = []
    for mod in (slowdown_kernel, timeline_kernel, walk_kernel):
        counters.append(mod.launches)
        for name in mod.launches:
            fn = getattr(mod, name)

            def launch(*a, _fn=fn, _c=mod.launches, _n=name, **k):
                out = _fn(*a, **k)
                build.count_launch(_c, _n)
                return out
            everywhere(fn, launch)
    return counters


@pytest.mark.parametrize("case", ["mining-paper.batch", "mining-paper.serve",
                                  "vr-paper.batch", "min_load",
                                  "route_false"])
def test_fused_rewalk_counter(case, monkeypatch):
    """``walk.rewalks_fused`` counts exactly the re-walks whose entry scan
    took the fused launch, at most ``walk.rewalks``; it is 0 where the
    route does not engage (the ``min_load`` objective, entries at the
    root with ``route=False``); ``launch.rewalk_entry`` opens once per
    engaged re-walk; and the read and launch closure holds with it (span
    sums equal the global counters' deltas)."""
    engaged = [0]
    real = Torc.Orchestrator._entry_fused

    def entry(self, *a):
        out = real(self, *a)
        engaged[0] += out[0]
        return out

    monkeypatch.setattr(Torc.Orchestrator, "_entry_fused", entry)
    if case == "min_load":
        build_orcs = core.build_orchestrators
        monkeypatch.setattr(core, "build_orchestrators", lambda g, tr: build_orcs(
            g, tr, config=core.OrcConfig(objective="min_load")))
    if case == "route_false":
        real_map = Torc.Orchestrator.map_batch
        monkeypatch.setattr(
            Torc.Orchestrator, "map_batch",
            lambda self, tasks, now=0.0, commit=True, route=False:
            real_map(self, tasks, now, commit, False))
    cell = ("mining-paper.batch" if case in ("min_load", "route_false")
            else case)
    counters = _count_on_the_cpu(monkeypatch)
    s0 = device.sync_count()
    l0 = sum(sum(c.values()) for c in counters)
    with spans.record() as rec:
        _iteration(*cell.split("."))
    syncs = device.sync_count() - s0
    launches = sum(sum(c.values()) for c in counters) - l0
    s = rec.summary()
    c = s["counters"]
    assert c.get("walk.rewalks_fused", 0) == engaged[0] <= c["walk.rewalks"]
    if case.startswith("mining"):
        assert engaged[0] > 0
    elif case in ("min_load", "route_false"):
        assert engaged[0] == 0 and c["walk.rewalks"] > 0
    assert s["spans"].get("launch.rewalk_entry", {}).get("count", 0) \
        == engaged[0]
    assert syncs > 0 and launches > 0
    assert sum(v["self_reads"] for v in s["spans"].values()) \
        + s["outside"]["reads"] == syncs
    assert sum(v["self_launches"] for v in s["spans"].values()) \
        + s["outside"]["launches"] == launches
