"""The port's walk against the reference package's three walk forms.

The reference picks its form by three switches: the group-sharded fused
walk (``REPRO_SHARDED_WALK``), the fused walk over one ledger
(``REPRO_FUSED_WALK``) and the object walk (its ``=0`` oracle), over a
session-resident walk context (``REPRO_SERVE_FASTPATH``).  The port has
none of them: it walks the fused walk over one ledger shared by every
ORC, driven per root group where a wave's walks enter below two or more
root children, and the object walk only for ``first_fit``, noisy
slowdown models and models without the same-device surface.

Contracts: the port at its defaults against every reference form —
placements, standalone, factor, comm, queries and hops identical,
overhead within 1e-9; the switches set to ``0`` change nothing in the
port.  Plus the one ledger at a split root, the resident context's reuse
rules, the threaded branch of the per-group drive, and exact counters
under concurrent increments."""
import itertools
import threading

import numpy as np
import pytest

import jax  # noqa: F401

import repro.core as R
import repro.core.task as Rtask
import repro.core.workloads as Rwl
import repro.serve.admission as RA
import repro_torch.core as T
import repro_torch.core.orchestrator as Torc
import repro_torch.core.task as Ttask
import repro_torch.core.workloads as Twl
import repro_torch.serve.admission as TA
from repro_torch import device as Tdevice
from repro_torch import spans
from repro_torch.kernels import build as Tbuild
from torch_port_util import TOL, mining_counts

# the reference suite's parity fleet (tests/test_orchestrator.py)
_PARITY_EDGES = {"orin_agx": 2, "xavier_agx": 1, "orin_nano": 2,
                 "xavier_nx": 1}
_PARITY_SERVERS = {"server1": 1, "server2": 1}
_MODES = ("sharded", "fused", "oracle")
_SWITCHES = ("REPRO_FUSED_WALK", "REPRO_SHARDED_WALK", "REPRO_SERVE_FASTPATH")


def _env(monkeypatch, mode: str, fastpath: str = "1") -> None:
    """The reference's walk form ``mode``; the port reads none of it."""
    monkeypatch.setenv("REPRO_FUSED_WALK", "0" if mode == "oracle" else "1")
    monkeypatch.setenv("REPRO_SHARDED_WALK",
                       "1" if mode == "sharded" else "0")
    monkeypatch.setenv("REPRO_SERVE_FASTPATH", fastpath)


def _defaults(monkeypatch) -> None:
    for name in _SWITCHES:
        monkeypatch.delenv(name, raising=False)


def _form(pkg, monkeypatch, mode, fastpath: str = "1") -> None:
    """The reference in form ``mode``; the port at its defaults."""
    if pkg is T:
        _defaults(monkeypatch)
    else:
        _env(monkeypatch, mode, fastpath)


def _tb(pkg, counts=None):
    ec, sc = counts or (_PARITY_EDGES, _PARITY_SERVERS)
    kw = {"device": "cpu"} if pkg is T else {}
    return pkg.build_testbed(edge_counts=dict(ec), server_counts=dict(sc),
                             **kw)


def _rows(res: dict) -> list:
    return [(res[u].pu, res[u].prediction.standalone,
             res[u].prediction.factor, res[u].prediction.comm,
             res[u].queries, res[u].hops, res[u].overhead)
            for u in sorted(res)]


def _run(pkg, monkeypatch, mode, workload, churn=None, counts=None,
         fastpath="1", config=None):
    """Map ``workload(pkg, tb)``'s batches through a fresh session of
    ``pkg`` (the reference in walk form ``mode``, the port at its
    defaults), with optional ``churn(tb, i)`` between batches.  Returns
    (result rows per batch in uid order, root)."""
    _form(pkg, monkeypatch, mode, fastpath)
    return _session(pkg, workload, churn, counts, config)


def _session(pkg, workload, churn=None, counts=None, config=None):
    tb = _tb(pkg, counts)
    g = tb.graph
    root = pkg.build_orchestrators(
        g, pkg.heye_traverser(g),
        config=pkg.OrcConfig(**config) if config else None)
    sess = pkg.SchedulerSession(g, root)
    batches = []
    for i, batch in enumerate(workload(pkg, tb)):
        sess.submit(batch)
        batches.append(_rows(sess.map_pending()))
        if churn is not None:
            churn(tb, i)
    return batches, root


def _assert_close(got, want):
    """Identical decisions, overhead within 1e-9."""
    assert len(got) == len(want)
    for gb, wb in zip(got, want):
        assert len(gb) == len(wb)
        for g_, w_ in zip(gb, wb):
            assert g_[:6] == w_[:6]
            assert g_[6] == pytest.approx(w_[6], rel=TOL, abs=1e-12)


def _assert_decisions(got, want):
    """Identical placements, queries and hops; standalone, factor, comm
    and overhead within 1e-9."""
    assert len(got) == len(want)
    for gb, wb in zip(got, want):
        assert len(gb) == len(wb)
        for g_, w_ in zip(gb, wb):
            assert (g_[0], g_[4], g_[5]) == (w_[0], w_[4], w_[5])
            for k in (1, 2, 3, 6):
                assert g_[k] == pytest.approx(w_[k], rel=TOL, abs=1e-12)


def _one_ledger(root) -> None:
    """Every ORC of the tree shares the one ``ActiveLedger``."""
    assert type(root.ledger) is T.ActiveLedger
    assert all(o.ledger is root.ledger for o in root.iter_tree())


def _all_forms(monkeypatch, workload, churn=None, counts=None, **kw):
    """The port once, at its defaults, against each of the reference's
    three forms; returns the port's (rows, root)."""
    got, root = _run(T, monkeypatch, None, workload, churn, counts, **kw)
    _one_ledger(root)
    for mode in _MODES:
        ref, _ = _run(R, monkeypatch, mode, workload, churn, counts, **kw)
        _assert_close(got, ref)
    return got, root


# ---------------------------------------------------------------------------
# the workloads of the reference's parity suite
# ---------------------------------------------------------------------------
def _mining(n, readings=1, batches=1):
    return lambda pkg, tb: [pkg.mining_workload(tb, n_sensors=n,
                                                n_readings=readings)
                            for _ in range(batches)]


def _vr(frames):
    return lambda pkg, tb: [pkg.vr_workload(tb, n_frames=frames)]


def _nano(tb):
    return next(x for x in tb.edges if tb.edge_kind[x] == "orin_nano")


def _render(n):
    return lambda pkg, tb: [[pkg.make_task("render", origin=_nano(tb),
                                           deadline=0.030, input_bytes=4e3)
                             for _ in range(n)]]


def _two_groups(pkg, tb, readings=2):
    """Mining readings from the edges and, in the same wave, svm and mlp
    tasks from every server: walks enter below both root children, so
    the wave is driven per group; repeated tasks re-walk in the commit."""
    cfg = pkg.mining_workload(tb, n_sensors=12, n_readings=readings)
    for i, srv in enumerate(tb.servers):
        for k in range(4):
            cfg.add(pkg.make_task(("svm", "mlp")[k % 2], origin=srv,
                                  deadline=0.5))
    return [cfg]


def _dead_and_slow(dead):
    def churn(tb, i):
        if i == 0:
            dead["pu"] = f"{tb.edges[0]}.gpu"
            tb.graph.mark_dead(dead["pu"])
            tb.graph.set_bandwidth(f"link_{tb.edges[1]}", 1e6)
    return churn


def _group_drives(monkeypatch) -> list:
    """Record the root groups of every per-group drive (``stop_root``)."""
    drives = []
    real = Torc.Orchestrator._drive_wave

    def drive(self, walks, now, ctx, stop_root=False):
        if stop_root:
            drives.append({self._shard_root_of(w.orc).group for w in walks})
        return real(self, walks, now, ctx, stop_root=stop_root)

    monkeypatch.setattr(Torc.Orchestrator, "_drive_wave", drive)
    return drives


@pytest.mark.parametrize("case", ["mining", "vr", "mining_x2", "vr_x2"])
def test_walk_forms_match_reference(monkeypatch, case):
    """Fig. 13 mining (deadline-driven escalation, two readings) and Fig.
    7 VR (pinned stages, src_devices provenance) against all three
    reference forms, on the parity fleet and on the mining fleet at
    mult=2 (the reference's mult=64 sharded cases, cut to size)."""
    wl, counts = {
        "mining": (_mining(18, readings=2), None),
        "vr": (_vr(3), None),
        "mining_x2": (_mining(24), mining_counts(2)),
        "vr_x2": (_vr(2), mining_counts(2)),
    }[case]
    _all_forms(monkeypatch, wl, counts=counts)


def test_walk_forms_parity_across_churn(monkeypatch):
    """mark_dead + set_bandwidth between batches: the delta'd snapshot
    bumps epochs, so every cache must refresh; the one ledger keeps
    routing by device name over the new clone."""
    dead: dict = {}
    got, _ = _all_forms(monkeypatch, _mining(12, batches=2),
                        churn=_dead_and_slow(dead))
    assert all(row[0] != dead["pu"] for row in got[1])


def test_set_bandwidth_invalidates_comm_in_every_form(monkeypatch):
    """An identical escalating task before and after a bandwidth collapse
    sees the new comm cost, in the port and in every reference form."""
    def wl(pkg, tb):
        mk = lambda: [pkg.make_task("render", origin=_nano(tb),
                                    deadline=0.030, input_bytes=4e3)]
        return [mk(), mk()]

    def churn(tb, i):
        if i == 0:
            tb.graph.set_bandwidth(f"link_{_nano(tb)}", 1e6)

    got, _ = _all_forms(monkeypatch, wl, churn=churn)
    before, after = got[0][0], got[1][0]
    assert after[3] != before[3]


def test_sharded_cross_group_escalation(monkeypatch):
    """A deadline only servers meet forces the walk out of the edge group
    through the root's cross-group scan, as in every reference form."""
    got, _ = _all_forms(monkeypatch, _render(3))
    rows = got[0]
    assert all(r[0].split(".")[0].startswith("server") for r in rows)
    assert all(r[5] > 0 for r in rows)


# ---------------------------------------------------------------------------
# the walk switches are the reference's alone
# ---------------------------------------------------------------------------
def _switch_workload(pkg, tb):
    """A wave driven per root group, then single-task waves at advancing
    instants through the resident context."""
    return _two_groups(pkg, tb) + [
        [pkg.make_task(k, origin=tb.edges[i % len(tb.edges)], deadline=0.5,
                       release_time=0.004 * i)]
        for i, k in enumerate(["svm", "mlp", "dnn", "render"])]


def _port_run():
    """The port's rows, ``walk.*`` counters and context counts over
    ``_switch_workload``."""
    with spans.record() as rec:
        got, root = _session(T, _switch_workload)
    _one_ledger(root)
    walk = {k: v for k, v in rec.summary()["counters"].items()
            if k.startswith("walk.")}
    return got, walk, (root.context_builds, root.context_rebases)


@pytest.mark.parametrize("name", _SWITCHES)
def test_walk_switches_do_not_reach_the_port(monkeypatch, name):
    """Each of the reference's walk switches set to ``0``: the port's
    MapResults, its ``walk.*`` counters, its per-group drives and its
    context builds and rebases equal its own at the defaults, and its
    MapResults equal the reference's under that same setting."""
    _defaults(monkeypatch)
    drives = _group_drives(monkeypatch)
    want = _port_run()
    n = len(drives)
    assert n and all(len(d) == 1 for d in drives)
    assert want[1]["walk.walks"] > 0 and want[2][0] == 1
    monkeypatch.setenv(name, "0")
    got = _port_run()
    assert got == want and drives[n:] == drives[:n]
    ref, _ = _session(R, _switch_workload)
    _assert_close(got[0], ref)


# ---------------------------------------------------------------------------
# the one ledger at a split root
# ---------------------------------------------------------------------------
def test_sharded_session_state(monkeypatch):
    """At a root with two children the session keeps the one ledger it
    was built with, on the graph's device, shared by every ORC; a wave
    driven per group leaves it whole (it equals a ledger fed the same
    commits, view for view); every ledger method the session, the
    serving loop and the DES call works on it."""
    _defaults(monkeypatch)
    drives = _group_drives(monkeypatch)
    tb = _tb(T)
    g = tb.graph
    root = T.build_orchestrators(g, T.heye_traverser(g))
    led = root.ledger
    sess = T.SchedulerSession(g, root)
    assert root.ledger is led and len(root.children) >= 2
    _one_ledger(root)
    assert led.device.type == "cpu"
    cfg = _two_groups(T, tb, readings=1)[0]
    sess.submit(cfg)
    res = sess.map_pending()
    assert {frozenset(d) for d in drives} == {
        frozenset({c.group}) for c in root.children}
    assert res and all(r is not None for r in res.values())
    assert root.ledger is led and len(led) == len(res)
    assert root.factor_cache_hits + root.factor_cache_misses > 0
    assert g.recompile_count <= 1
    comp = g.compiled()
    one = T.ActiveLedger("cpu")
    one._pu_dev.update(comp._pu_device_name)
    for t in cfg:
        r = res[t.uid]
        one.add(t, r.pu, r.prediction, 0.0)
    a, b = led.live_view(comp), one.live_view(comp)
    assert a.pu_names == b.pu_names and a.tasks == b.tasks
    cols = ("P", "est", "fac", "dl", "rel", "upu", "umem", "Ma", "uid",
            "Da", "na", "astart")
    for col in cols:
        assert getattr(a, col).tolist() == getattr(b, col).tolist(), col
    for dev in comp.dev_ord_names:
        x, y = led.device_view(comp, dev), one.device_view(comp, dev)
        assert x.tasks == y.tasks
        for col in cols:
            assert getattr(x, col).tolist() == getattr(y, col).tolist(), col
    pu = res[cfg.tasks[0].uid].pu
    servers = {r.pu.split(".")[0] for r in res.values()} & set(tb.servers)
    assert servers                       # rows in both groups
    assert led.count(pu) == one.count(pu)
    assert led.occupied_devices(comp) == one.occupied_devices(comp)
    assert {k: len(v) for k, v in led.by_pu.items()} == \
        {k: len(v) for k, v in one.by_pu.items()}
    assert [e.task for e in led.on_device(g, pu)] == \
        [e.task for e in one.on_device(g, pu)]
    assert led.pairs_on_device(g, pu) == one.pairs_on_device(g, pu)
    # retire / remove / touch / prune
    assert led.retire([t.uid for t in cfg.tasks[:3]]) == 3
    led.remove(cfg.tasks[3])
    assert len(led) == len(res) - 4
    v0 = led.version
    led.touch(comp.device_name(pu))
    assert led.version == v0 + 1
    led.prune(1e9)
    assert len(led) == 0
    stats = sess.execute()
    assert sess.engine_opens <= 1 and stats is not None


# ---------------------------------------------------------------------------
# the session-resident walk context
# ---------------------------------------------------------------------------
def _stream(pkg, tb):
    kinds = ["svm", "mlp", "svm", "dnn", "svm", "mlp", "render", "svm"]
    return [[pkg.make_task(k, origin=tb.edges[i % len(tb.edges)],
                           deadline=0.5, release_time=0.004 * i)]
            for i, k in enumerate(kinds)]


@pytest.mark.parametrize("mode", ["sharded", "fused"])
def test_resident_context_matches_cold_walk(monkeypatch, mode):
    """A stream of single-task waves at advancing instants through the
    port's one resident context matches the reference's cold walk (the
    object walk for single-task waves, ``REPRO_SERVE_FASTPATH=0``) and
    its resident one, in the reference's form ``mode``."""
    fast, root = _run(T, monkeypatch, mode, _stream)
    _assert_close(fast, _run(R, monkeypatch, mode, _stream,
                             fastpath="0")[0])
    _assert_close(fast, _run(R, monkeypatch, mode, _stream)[0])
    assert root.context_builds == 1 and root.context_rebases == 0


def test_resident_context_parity_across_bandwidth_churn(monkeypatch):
    """Bandwidth-only deltas between waves rebase the resident context
    (one build, then a rebase per delta); decisions match the
    reference's cold walk and its resident one in both fused forms."""
    def wl(pkg, tb):
        return [[pkg.make_task("svm", origin=tb.edges[0], deadline=0.5,
                               release_time=0.01 * i),
                 pkg.make_task("mlp", origin=tb.edges[1], deadline=0.5,
                               release_time=0.01 * i)]
                for i in range(4)]

    def churn(tb, i):
        tb.graph.set_bandwidth(f"link_{tb.edges[1]}", 3e6 + 1e6 * i)

    fast, root = _run(T, monkeypatch, None, wl, churn=churn)
    assert root.context_builds == 1 and root.context_rebases == 3
    for mode in ("sharded", "fused"):
        _assert_close(fast, _run(R, monkeypatch, mode, wl, churn=churn,
                                 fastpath="0")[0])
        _assert_close(fast, _run(R, monkeypatch, mode, wl, churn=churn)[0])


def test_resident_context_identity_and_oracle_off(monkeypatch):
    """The root keeps one context across map_batch calls, rebases it onto
    a bandwidth-only successor, drops it on a death and on add_child;
    with ``REPRO_SERVE_FASTPATH=0`` the port still keeps it, and places
    as the reference's cold walk does."""
    _defaults(monkeypatch)
    tb = T.build_testbed(edge_counts={"orin_agx": 1, "orin_nano": 1},
                         server_counts={"server1": 1}, device="cpu")
    g = tb.graph
    root = T.build_orchestrators(g, T.heye_traverser(g))
    svm = lambda e: T.make_task("svm", origin=e, deadline=0.5)
    root.map_batch([svm(tb.edges[0])], now=0.0, route=True)
    ctx = root._resident_ctx
    assert ctx is not None and root.context_builds == 1
    root.map_batch([T.make_task("mlp", origin=tb.edges[1], deadline=0.5)],
                   now=0.01, route=True)
    assert root._resident_ctx is ctx
    g.set_bandwidth(f"link_{tb.edges[0]}", 5e6)
    root.map_batch([svm(tb.edges[0])], now=0.02, route=True)
    assert root._resident_ctx is ctx and ctx.comp is g.compiled()
    assert (root.context_builds, root.context_rebases) == (1, 1)
    g.mark_dead(f"{tb.edges[1]}.gpu")            # not bandwidth-only
    root.map_batch([svm(tb.edges[0])], now=0.03, route=True)
    assert root._resident_ctx is not ctx and root.context_builds == 2
    root.add_child(T.Orchestrator(g, "extra", root.traverser, root.ledger))
    assert root._resident_ctx is None
    monkeypatch.setenv("REPRO_SERVE_FASTPATH", "0")
    got = {}
    for pkg in (R, T):
        tb = pkg.build_testbed(edge_counts={"orin_agx": 1, "orin_nano": 1},
                               server_counts={"server1": 1},
                               **({"device": "cpu"} if pkg is T else {}))
        g = tb.graph
        root2 = pkg.build_orchestrators(g, pkg.heye_traverser(g))
        got[pkg] = [_rows({0: r}) for r in root2.map_batch(
            [pkg.make_task("svm", origin=tb.edges[0], deadline=0.5)],
            now=0.0, route=True)]
        if pkg is T:
            assert root2._resident_ctx is not None
            assert root2.context_builds == 1
        else:
            assert root2._resident_ctx is None
    _assert_close(got[T], got[R])


def test_resident_context_drops_long_journal_and_memos(monkeypatch):
    """The journal past 50 000 entries drops the context and is reset in
    place; the id-keyed memos drop past 8192."""
    _defaults(monkeypatch)
    tb = _tb(T)
    g = tb.graph
    root = T.build_orchestrators(g, T.heye_traverser(g)).prepare()
    log = root.ledger.mut_log
    root.map_batch([T.make_task("svm", origin=tb.edges[0], deadline=0.5)],
                   0.0, route=True)
    ctx = root._resident_ctx
    ctx._sigs.update({k: None for k in range(9000)})
    root.map_batch([T.make_task("svm", origin=tb.edges[0], deadline=0.5)],
                   0.001, route=True)
    assert root._resident_ctx is ctx and len(ctx._sigs) < 10
    log.extend(["x"] * 50_001)
    root.map_batch([T.make_task("svm", origin=tb.edges[0], deadline=0.5)],
                   0.002, route=True)
    assert root._resident_ctx is not ctx and root.context_builds == 2
    assert root.ledger.mut_log is log and len(log) < 10
    assert ctx.commit_log is log


# ---------------------------------------------------------------------------
# the object walk: first_fit, noisy models, the tuple-surface model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("wl", ["mining", "vr"])
def test_first_fit_matches_reference(monkeypatch, wl):
    """first_fit takes the object walk in both packages (early-return
    accounting), whatever the switches say."""
    work = _mining(18, readings=2) if wl == "mining" else _vr(3)
    ref, _ = _run(R, monkeypatch, "sharded", work,
                  config=dict(objective="first_fit"))
    got, root = _run(T, monkeypatch, "sharded", work,
                     config=dict(objective="first_fit"))
    _assert_close(got, ref)
    assert root._resident_ctx is None       # the object walk ran
    # the early return asks no more PUs than best_fit does
    tb = _tb(T)
    g = tb.graph
    res = {}
    for obj in ("best_fit", "first_fit"):
        root = T.build_orchestrators(g, T.heye_traverser(g),
                                     config=T.OrcConfig(objective=obj))
        res[obj] = root.find_device_orc(tb.edges[0]).map_batch(
            [T.make_task("pose_pred", origin=tb.edges[0], deadline=0.5)])[0]
    assert res["first_fit"].queries <= res["best_fit"].queries


def _policy_map(pkg, seed, kind):
    """map_batch waves of the mining workload in release order, plus a
    single-task wave each (``ctx=None`` in the object walk), with the
    policy's traverser either the ground-truth traverser (``"truth"``:
    truth parameters, its noise belongs to the DES, so the walk is fused)
    or one over a noisy slowdown model (``"noisy"``: the object walk, its
    rng drawn per factor).  Returns (results per wave, the generator's
    next draw)."""
    Rtask._task_counter = itertools.count(910_000)
    Ttask._task_counter = itertools.count(910_000)
    tb = _tb(pkg)
    g = tb.graph
    if kind == "truth":
        trav = pkg.ground_truth_traverser(g, seed)
        rng = trav.rng
    else:
        rng = np.random.default_rng(seed)
        trav = pkg.Traverser(g, slowdown=pkg.DecoupledSlowdown(
            g, pkg.truth_params(), rng=rng))
    root = pkg.build_orchestrators(g, trav)
    cfg = pkg.mining_workload(tb, n_sensors=12, n_readings=2)
    out = []
    for now in sorted({t.release_time for t in cfg}):
        wave = [t for t in cfg if t.release_time == now]
        out.append(root.map_batch(wave, now, route=True))
        out.append(root.map_batch([pkg.make_task(
            "knn", origin=tb.edges[-1], deadline=0.05)], now, route=True))
    return out, rng.random()


@pytest.mark.parametrize("kind,fastpath", [("noisy", "1"), ("noisy", "0"),
                                           ("truth", "1")])
def test_noisy_and_truth_map_batch_match_reference(monkeypatch, kind,
                                                    fastpath):
    """A noisy slowdown model maps through the object walk, per task, its
    rng drawn in the scalar reference's order: same results, and the
    generator left in the same state.  The ground-truth traverser as the
    policy's traverser maps as the reference does too."""
    monkeypatch.setenv("REPRO_SERVE_FASTPATH", fastpath)
    ref, r_next = _policy_map(R, 5, kind)
    got, t_next = _policy_map(T, 5, kind)
    assert t_next == r_next
    assert len(got) == len(ref)
    for gw, rw in zip(got, ref):
        assert [(r.pu, r.prediction.standalone, r.prediction.factor,
                 r.prediction.comm, r.queries, r.hops) for r in gw] == \
            [(r.pu, r.prediction.standalone, r.prediction.factor,
              r.prediction.comm, r.queries, r.hops) for r in rw]
        for a, b in zip(gw, rw):
            assert a.overhead == pytest.approx(b.overhead, rel=TOL,
                                               abs=1e-15)


class _TupleSurface:
    """A noise-free slowdown model with only the tuple surface
    (``factor`` / ``factors_with_candidates``): no block-diagonal check,
    so ``map_batch`` takes the object walk and ``_score_grouped``."""

    def __init__(self, sd):
        self._sd = sd

    def factor(self, *a):
        return self._sd.factor(*a)

    def factors_with_candidates(self, *a):
        return self._sd.factors_with_candidates(*a)

    def factor_batch(self, *a):
        return self._sd.factor_batch(*a)

    def invalidate(self):
        self._sd.invalidate()


def test_tuple_surface_model_walks_grouped_like_reference(monkeypatch):
    """The grouped scoring of a noise-free tuple-surface model: the port
    against the reference, and the same decisions as the fused walk of
    the full model.  Its factors come from B1's row form, which
    multiplies the classes in class order (the reference's numpy
    aggregate in another order): floats within 1e-9."""
    _env(monkeypatch, "sharded")
    outs = {}
    for pkg in (R, T):
        Rtask._task_counter = itertools.count(920_000)
        Ttask._task_counter = itertools.count(920_000)
        tb = _tb(pkg)
        g = tb.graph
        full = pkg.heye_traverser(g)
        res = {}
        for name, sd in (("tuple", _TupleSurface(full.slowdown)),
                         ("full", full.slowdown)):
            root = pkg.build_orchestrators(
                g, pkg.Traverser(g, slowdown=sd))
            cfg = pkg.mining_workload(tb, n_sensors=12, n_readings=1)
            res[name] = [root.map_batch(cfg.tasks, 0.0, route=True)]
        outs[pkg] = {k: [[(r.pu, r.prediction.standalone,
                           r.prediction.factor, r.prediction.comm,
                           r.queries, r.hops, r.overhead) for r in b]
                         for b in v] for k, v in res.items()}
    _assert_decisions(outs[T]["tuple"], outs[R]["tuple"])
    _assert_decisions(outs[T]["tuple"], outs[T]["full"])


# ---------------------------------------------------------------------------
# the threaded branch and the counters
# ---------------------------------------------------------------------------
def _wide_wave(pkg, tb):
    """One wave of >= 64 x 2 distinct walk signatures, from edges and
    servers alike (deadlines make each task its own signature)."""
    devs = list(tb.edges) + list(tb.servers)
    kinds = ["svm", "mlp", "knn", "dnn"]
    return [[pkg.make_task(kinds[i % 4], origin=devs[i % len(devs)],
                           deadline=0.2 + 1e-4 * i) for i in range(160)]]


def test_threaded_sharded_walk_matches_serial_and_reference(monkeypatch):
    """A wave of 160 distinct signatures over two groups takes the
    threaded branch of the per-group drive over the one ledger
    (os.cpu_count patched where the host has one core): bit-identical to
    the serial drive, equal to the reference's sharded and fused forms,
    and the group threads' counter bumps stay exact."""
    monkeypatch.setattr("os.cpu_count", lambda: 4)
    made = []
    real_pool = Torc.ThreadPoolExecutor

    class Pool(real_pool):
        def __init__(self, *a, **k):
            made.append(k.get("max_workers"))
            super().__init__(*a, **k)

    monkeypatch.setattr(Torc, "ThreadPoolExecutor", Pool)
    counts = {"scan_reduce_batch": 0, "slowdown_same_device_multi": 0}
    real_batch = Torc.scan_reduce_batch
    real_multi = T.DecoupledSlowdown.factors_same_device_multi

    def counted_batch(*a):
        Tbuild.count_launch(counts, "scan_reduce_batch")
        return real_batch(*a)

    def counted_multi(self, *a):
        Tbuild.count_launch(counts, "slowdown_same_device_multi")
        return real_multi(self, *a)

    monkeypatch.setattr(Torc, "scan_reduce_batch", counted_batch)
    monkeypatch.setattr(T.DecoupledSlowdown, "factors_same_device_multi",
                        counted_multi)
    threaded, root = _run(T, monkeypatch, None, _wide_wave)
    assert made == [2]
    _one_ledger(root)
    n_threaded = dict(counts)
    for k in counts:
        counts[k] = 0
    monkeypatch.setattr("os.cpu_count", lambda: 1)
    serial, _ = _run(T, monkeypatch, None, _wide_wave)
    assert made == [2]                       # no pool on one core
    assert counts == n_threaded and counts["scan_reduce_batch"] >= 2
    assert threaded == serial
    monkeypatch.setattr("os.cpu_count", lambda: 4)
    for mode in ("sharded", "fused"):
        _assert_close(threaded, _run(R, monkeypatch, mode, _wide_wave)[0])


def test_counters_exact_under_concurrent_increments(monkeypatch):
    """The launch counters and the sync counter under many threads, and
    the kernel library loaded once however many threads ask at once."""
    import sys
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        counts = {"k": 0}
        Tdevice.reset_sync_count()
        n, per = 8, 5000

        def bump():
            for _ in range(per):
                Tbuild.count_launch(counts, "k")
                Tdevice._count_sync()

        ths = [threading.Thread(target=bump) for _ in range(n)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ths)
        assert counts["k"] == n * per
        assert Tdevice.sync_count() == n * per
        Tdevice.reset_sync_count()

        builds = []

        class Lib:
            def __getattr__(self, name):
                fn = type("Fn", (), {})()
                setattr(self, name, fn)
                return fn

        def slow_build():
            builds.append(1)
            threading.Event().wait(0.02)
            return "libheye.so"

        monkeypatch.setattr(Tbuild, "_LIB", None)
        monkeypatch.setattr(Tbuild, "build", slow_build)
        monkeypatch.setattr(Tbuild.ctypes, "CDLL", lambda path: Lib())
        got = []
        ths = [threading.Thread(target=lambda: got.append(Tbuild.load()))
               for _ in range(6)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ths)
        assert len(builds) == 1 and len({id(x) for x in got}) == 1
    finally:
        sys.setswitchinterval(old)


# ---------------------------------------------------------------------------
# the fused re-walk: a single-device entry scan in one launch
# ---------------------------------------------------------------------------
def _fused_route(monkeypatch, off: bool) -> dict:
    """Count the port's fused re-walk entries (and those that found no
    winner); with ``off`` the route is taken away, so every re-walk walks
    the two-step path."""
    seen = {"engaged": 0, "empty": 0}
    real = Torc.Orchestrator._entry_fused

    def entry(self, task, now, ctx):
        out = (False, None) if off else real(self, task, now, ctx)
        if out[0]:
            seen["engaged"] += 1
            seen["empty"] += out[1] is None
        return out

    monkeypatch.setattr(Torc.Orchestrator, "_entry_fused", entry)
    return seen


def _serving(pkg, monkeypatch, mode):
    """Mining readings (svm, knn, mlp from one edge) served on arrival by
    a ServeLoop: each request its own wave through the resident context,
    its second and third task re-walked, the clock moving between
    waves."""
    _form(pkg, monkeypatch, mode)
    wl = (Rwl if pkg is R else Twl)
    adm = (RA if pkg is R else TA)
    tb = _tb(pkg)
    g = tb.graph
    ten = []
    for i, edge in enumerate(tb.edges[:4]):
        def make(rid, t, edge=edge):
            cfg = pkg.TaskGraph(f"reading#{rid}")
            wl.mining_reading(cfg, edge, 0, 0)
            for task in cfg.tasks:
                task.release_time = t
            return cfg
        ten.append(pkg.TenantSpec(f"s{i}", _Instants(
            [0.004 * i + 0.1 * k for k in range(3)]), make))
    root = pkg.build_orchestrators(g, pkg.heye_traverser(g))
    loop = pkg.ServeLoop(g, root, ten, admission=adm.admit_all(),
                         horizon=0.4)
    st = loop.run()
    rows = [[(r.rid, r.verdict, t.assigned_pu) for t in r.tasks]
            for r in sorted(st.requests, key=lambda r: r.rid)]
    return rows, root


class _Instants:
    def __init__(self, t):
        self.t = np.asarray(t, dtype=np.float64)

    def times(self, horizon):
        return self.t[self.t < horizon]


def _crowd(n):
    """``n`` equal mlp tasks from one orin_nano: the first commits fill
    the nano until its entry scan finds no PU and the rest escalate."""
    return lambda pkg, tb: [[pkg.make_task("mlp", origin=_nano(tb),
                                           deadline=0.05)
                             for _ in range(n)]]


def _direct(pkg, monkeypatch, mode, at_cluster: bool):
    """Mining readings mapped by ``map_batch`` with ``route=False``: at
    the root, or at the first cluster ORC (its own tasks): the entry
    plan covers several devices."""
    _form(pkg, monkeypatch, mode)
    tb = _tb(pkg)
    g = tb.graph
    root = pkg.build_orchestrators(g, pkg.heye_traverser(g))
    orc = root.children[0] if at_cluster else root
    edges = [o.group for o in orc.iter_tree() if o.is_device_orc()
             and o.group in tb.edges] or list(tb.edges)
    out = []
    for w in range(3):
        cfg = pkg.TaskGraph("wave")
        for s, edge in enumerate(edges[:3]):
            (Rwl if pkg is R else Twl).mining_reading(cfg, edge, s, w)
        out.append(_rows(dict(zip([t.uid for t in cfg.tasks],
                                  orc.map_batch(cfg.tasks, now=0.1 * w)))))
    return out, orc


def _contention_blind(pkg, monkeypatch, mode):
    """Mining readings placed through a contention-blind traverser (no
    slowdown model), whose model offers no fused re-walk."""
    monkeypatch.setattr(pkg, "heye_traverser", lambda g: pkg.Traverser(
        g, slowdown=pkg.NoSlowdown(g)))
    return _run(pkg, monkeypatch, mode, _mining(18, readings=2))


def _two_groups_drive(pkg, monkeypatch, mode):
    """``_two_groups`` through a session; the port's wave is driven per
    root group."""
    if pkg is not T:
        return _run(pkg, monkeypatch, mode, _two_groups)
    real = Torc.Orchestrator._drive_wave
    drives = _group_drives(monkeypatch)
    try:
        out = _run(pkg, monkeypatch, mode, _two_groups)
    finally:
        monkeypatch.setattr(Torc.Orchestrator, "_drive_wave", real)
    assert len(drives) >= 2 and all(len(d) == 1 for d in drives)
    return out


FUSED_CASES = {
    # case: (how it runs (the reference in its form), the reference's
    # form, whether the fused route must engage, must one entry find no
    # winner)
    "mining_batch": (lambda pkg, mp, m: _run(pkg, mp, m,
                                             _mining(18, readings=2)),
                     "fused", True, False),
    "two_groups_batch": (_two_groups_drive, "sharded", True, False),
    "mining_serve": (_serving, "sharded", True, False),
    "vr": (lambda pkg, mp, m: _run(pkg, mp, m, _vr(3)), "sharded", None,
           False),
    "escalate": (lambda pkg, mp, m: _run(pkg, mp, m, _crowd(12)), "fused",
                 True, True),
    "min_load": (lambda pkg, mp, m: _run(pkg, mp, m,
                                         _mining(18, readings=2),
                                         config={"objective": "min_load"}),
                 "fused", False, False),
    "route_false": (lambda pkg, mp, m: _direct(pkg, mp, m, False), "fused",
                    False, False),
    "cluster_entry": (lambda pkg, mp, m: _direct(pkg, mp, m, True), "fused",
                      False, False),
    "no_slowdown": (_contention_blind, "fused", False, False),
}


def _walk_state(owner) -> tuple:
    """The resident walk context's scan states and effective-column
    entries, in insertion order, plans named by their ORC."""
    ctx = owner._resident_ctx
    root = owner
    while root.parent is not None:
        root = root.parent
    names = {}
    for o in root.iter_tree():
        if o._plan_cache is not None:
            names[id(o._plan_cache[1].pus)] = ("scan", o.group)
        if o._child_cache is not None:
            names[id(o._child_cache[1].pus)] = ("child", o.group)
    order = {id(st): i for i, st in enumerate(ctx.scan_states.values())}
    states = [(core, names[pid], st.ok.tolist(), st.sa.tolist(),
               st.f.tolist(), st.wait.tolist(), st.stamps, st.expiry,
               st.refresh_log, st.log_pos, st.now, st.epoch)
              for (core, pid), st in ctx.scan_states.items()]
    effs = [(sig, names[pid], order[id(e.st)], e.pos, e.rpos, e.ok.tolist(),
             e.cm.tolist(), e.key.tolist())
            for (sig, pid), e in ctx.eff_cache.items()]
    return states, effs


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_rewalk_matches_the_two_step_path(monkeypatch, case):
    """A re-walk whose entry plan covers one device, with a scan state
    current but for that device, runs its entry scan as one launch (on
    the CPU, its plain form): the same MapResults (pu, prediction,
    overhead, queries, hops) as the two-step path, bit for bit, the same
    scan-state columns, stamps, expiry, journal positions and
    effective-column entries left behind, and decisions equal to Alg. 1
    run task by task (the reference's object walk,
    ``REPRO_FUSED_WALK=0``) and to the reference's form of the case.  It
    engages on no other shape: the ``min_load``
    objective, entry plans over several devices (``route=False``, at the
    root or a cluster ORC), a slowdown model without the route."""
    drive, mode, engages, empty = FUSED_CASES[case]
    results = {}
    for off in (False, True):
        seen = _fused_route(monkeypatch, off)
        recorded = []
        real = Torc.Orchestrator.map_batch

        def map_batch(self, *a, **k):
            out = real(self, *a, **k)
            recorded.append([None if r is None else
                             (r.pu, r.prediction.standalone,
                              r.prediction.factor, r.prediction.comm,
                              r.overhead, r.queries, r.hops) for r in out])
            return out

        monkeypatch.setattr(Torc.Orchestrator, "map_batch", map_batch)
        rows, owner = drive(T, monkeypatch, mode)
        monkeypatch.setattr(Torc.Orchestrator, "map_batch", real)
        results[off] = (rows, recorded, _walk_state(owner), dict(seen))
    fused, two_step = results[False], results[True]
    assert fused[0] == two_step[0]
    assert fused[1] == two_step[1] and fused[1]
    assert fused[2] == two_step[2]
    assert two_step[3]["engaged"] == 0
    if engages is not None:
        assert (fused[3]["engaged"] > 0) == engages, fused[3]
    if empty:
        assert fused[3]["empty"] > 0
    ref, _ = drive(R, monkeypatch, mode)
    oracle, _ = drive(R, monkeypatch, "oracle")
    if case == "mining_serve":
        assert fused[0] == ref == oracle
    else:
        _assert_close(fused[0], ref)
        _assert_close(oracle, fused[0])
