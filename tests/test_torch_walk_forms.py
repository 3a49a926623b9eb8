"""The port's three walk forms against the reference package, driven by
the same switches: the group-sharded fused walk (``REPRO_SHARDED_WALK``),
the fused walk (``REPRO_FUSED_WALK``) and the object walk (its ``=0``
oracle, and the only walk of ``first_fit`` and of noisy slowdown models),
over a session-resident walk context (``REPRO_SERVE_FASTPATH``).  One
``monkeypatch.setenv`` drives both packages.

Contracts: port against reference in the same form — placements,
standalone, factor, comm, queries and hops identical, overhead within
1e-9; within the port, sharded against fused bit-identical, fused against
the object walk identical decisions with overhead within 1e-9.  Plus the
sharded snapshot and ledger surfaces, the resident context's reuse rules,
the threaded branch of the sharded driver, and exact counters under
concurrent increments."""
import itertools
import threading

import numpy as np
import pytest

import jax  # noqa: F401

import repro.core as R
import repro.core.task as Rtask
import repro_torch.core as T
import repro_torch.core.orchestrator as Torc
import repro_torch.core.task as Ttask
from repro_torch import device as Tdevice
from repro_torch.kernels import build as Tbuild
from torch_port_util import TOL, mining_counts

# the reference suite's parity fleet (tests/test_orchestrator.py)
_PARITY_EDGES = {"orin_agx": 2, "xavier_agx": 1, "orin_nano": 2,
                 "xavier_nx": 1}
_PARITY_SERVERS = {"server1": 1, "server2": 1}
_MODES = ("sharded", "fused", "oracle")


def _env(monkeypatch, mode: str, fastpath: str = "1") -> None:
    monkeypatch.setenv("REPRO_FUSED_WALK", "0" if mode == "oracle" else "1")
    monkeypatch.setenv("REPRO_SHARDED_WALK",
                       "1" if mode == "sharded" else "0")
    monkeypatch.setenv("REPRO_SERVE_FASTPATH", fastpath)


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
    ``pkg`` in one walk form, with optional ``churn(tb, i)`` between
    batches.  Returns (result rows per batch in uid order, root)."""
    _env(monkeypatch, mode, fastpath)
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


def _all_forms(monkeypatch, workload, churn=None, counts=None, **kw):
    """Every form in both packages: each port form against the same
    reference form, sharded == fused bit for bit within the port, and the
    object walk's decisions equal to the fused walk's."""
    out = {}
    for mode in _MODES:
        ref, _ = _run(R, monkeypatch, mode, workload, churn, counts, **kw)
        got, root = _run(T, monkeypatch, mode, workload, churn, counts, **kw)
        _assert_close(got, ref)
        out[mode] = (got, root)
    assert out["sharded"][0] == out["fused"][0]
    _assert_close(out["oracle"][0], out["fused"][0])
    assert isinstance(out["sharded"][1].ledger, T.ShardedLedger)
    assert type(out["fused"][1].ledger) is T.ActiveLedger
    return out


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


def _dead_and_slow(dead):
    def churn(tb, i):
        if i == 0:
            dead["pu"] = f"{tb.edges[0]}.gpu"
            tb.graph.mark_dead(dead["pu"])
            tb.graph.set_bandwidth(f"link_{tb.edges[1]}", 1e6)
    return churn


@pytest.mark.parametrize("case", ["mining", "vr", "mining_x2", "vr_x2"])
def test_walk_forms_match_reference(monkeypatch, case):
    """Fig. 13 mining (deadline-driven escalation, two readings) and Fig.
    7 VR (pinned stages, src_devices provenance) in all three forms, on
    the parity fleet and on the mining fleet at mult=2 (the reference's
    mult=64 sharded cases, cut to size)."""
    wl, counts = {
        "mining": (_mining(18, readings=2), None),
        "vr": (_vr(3), None),
        "mining_x2": (_mining(24), mining_counts(2)),
        "vr_x2": (_vr(2), mining_counts(2)),
    }[case]
    _all_forms(monkeypatch, wl, counts=counts)


def test_walk_forms_parity_across_churn(monkeypatch):
    """mark_dead + set_bandwidth between batches: the delta'd snapshot
    bumps epochs, so every cache of every form must refresh; the sharded
    ledger keeps routing by device name over the new clone."""
    dead: dict = {}
    out = _all_forms(monkeypatch, _mining(12, batches=2),
                     churn=_dead_and_slow(dead))
    assert all(row[0] != dead["pu"] for row in out["sharded"][0][1])


def test_set_bandwidth_invalidates_comm_in_every_form(monkeypatch):
    """An identical escalating task before and after a bandwidth collapse
    sees the new comm cost in every form."""
    def wl(pkg, tb):
        mk = lambda: [pkg.make_task("render", origin=_nano(tb),
                                    deadline=0.030, input_bytes=4e3)]
        return [mk(), mk()]

    def churn(tb, i):
        if i == 0:
            tb.graph.set_bandwidth(f"link_{_nano(tb)}", 1e6)

    out = _all_forms(monkeypatch, wl, churn=churn)
    before, after = out["fused"][0][0][0], out["fused"][0][1][0]
    assert after[3] != before[3]


def test_sharded_cross_group_escalation(monkeypatch):
    """A deadline only servers meet forces the walk out of the edge group
    through the root's cross-group scan (the serial boundary
    reconciliation), bit-identical to the fused walk."""
    out = _all_forms(monkeypatch, _render(3))
    rows = out["sharded"][0][0]
    assert all(r[0].split(".")[0].startswith("server") for r in rows)
    assert all(r[5] > 0 for r in rows)


# ---------------------------------------------------------------------------
# the sharded snapshot and session state
# ---------------------------------------------------------------------------
def test_sharded_session_state(monkeypatch):
    """The sharded session installs a ShardedLedger over the root-child
    groups on the ledger's device; totals and counters aggregate across
    shards; every ledger method the session, the serving loop and the DES
    call works through the facade."""
    _env(monkeypatch, "sharded")
    tb = _tb(T)
    g = tb.graph
    root = T.build_orchestrators(g, T.heye_traverser(g))
    sess = T.SchedulerSession(g, root)
    led = root.ledger
    assert isinstance(led, T.ShardedLedger)
    assert len(led.shards) == len(root.children) >= 2
    assert all(s.device.type == "cpu" for s in led.shards)
    assert all(o.ledger is led for o in root.iter_tree())
    assert all(s.mut_log is led.mut_log for s in led.shards)
    assert isinstance(root._sharded_hw, T.ShardedHWGraph)
    cfg = T.mining_workload(tb, n_sensors=8, n_readings=1)
    sess.submit(cfg)
    res = sess.map_pending()
    assert res and all(r is not None for r in res.values())
    assert len(led) == sum(len(s) for s in led.shards) == len(res)
    assert root.factor_cache_hits + root.factor_cache_misses > 0
    assert g.recompile_count <= 1
    # the merged view equals a monolithic ledger holding the same rows
    comp = g.compiled()
    mono = T.ActiveLedger("cpu")
    mono._pu_dev.update(comp._pu_device_name)
    for t in cfg:
        r = res[t.uid]
        mono.add(t, r.pu, r.prediction, 0.0)
    a, b = led.live_view(comp), mono.live_view(comp)
    assert a.pu_names == b.pu_names and a.tasks == b.tasks
    for col in ("P", "est", "fac", "dl", "rel", "upu", "umem", "Ma", "uid",
                "Da", "na", "astart"):
        assert getattr(a, col).tolist() == getattr(b, col).tolist(), col
    pu = res[cfg.tasks[0].uid].pu
    assert led.count(pu) == mono.count(pu)
    assert led.occupied_devices(comp) == mono.occupied_devices(comp)
    assert {k: len(v) for k, v in led.by_pu.items()} == \
        {k: len(v) for k, v in mono.by_pu.items()}
    assert [e.task for e in led.on_device(g, pu)] == \
        [e.task for e in mono.on_device(g, pu)]
    # retire / remove / prune through the facade
    assert led.retire([t.uid for t in cfg.tasks[:3]]) == 3
    led.remove(cfg.tasks[3])
    assert len(led) == len(res) - 4
    led.touch(comp.device_name(pu))
    led.prune(1e9)
    assert len(led) == 0
    stats = sess.execute()
    assert sess.engine_opens <= 1 and stats is not None


def test_sharded_hwgraph_slicing():
    """ShardedHWGraph: PU index remap, per-group NCR blocks, block-diagonal
    validation, device -> shard lookup, the per-snapshot cache dropped by
    a delta clone, and the rejected partitions."""
    tb = _tb(T)
    comp = tb.graph.compiled()
    groups = {"edge_cluster": list(tb.edges),
              "server_cluster": list(tb.servers)}
    sh = comp.sharded(groups)
    assert isinstance(sh, T.ShardedHWGraph)
    assert sh.n_shards == 2
    assert comp.sharded(groups) is sh          # cached per partition
    assert sh.routes is comp._rt
    names = set()
    for shard in sh.shards:
        assert shard.pu_idx.tolist() == shard.pu_idx_l
        assert [comp.pu_names[i] for i in shard.pu_idx_l] == shard.pu_names
        assert all(shard.local_index[n] == j
                   for j, n in enumerate(shard.pu_names))
        sel = shard.pu_idx
        assert shard.ncr_res.tolist() == comp.ncr_res[sel][:, sel].tolist()
        assert shard.ncr_rclass.tolist() == \
            comp.ncr_rclass[sel][:, sel].tolist()
        assert shard.pu_alive.tolist() == comp.pu_alive[sel].tolist()
        names.update(shard.pu_names)
        for d in shard.devices:
            assert sh.shard_of(d) == shard.name
    assert names == set(comp.pu_names)
    a, b = sh.shards
    assert (comp.ncr_res[a.pu_idx][:, b.pu_idx] == -1).all()
    # the reference slices the same partition the same way
    rtb = _tb(R)
    rcomp = rtb.graph.compiled()
    rsh = rcomp.sharded({"edge_cluster": list(rtb.edges),
                         "server_cluster": list(rtb.servers)})
    for x, y in zip(sh.shards, rsh.shards):
        assert x.pu_names == y.pu_names
        assert x.ncr_res.tolist() == y.ncr_res.tolist()
    # a delta clone drops the cache and re-slices lazily
    tb.graph.set_bandwidth(f"link_{tb.edges[0]}", 2e6)
    comp2 = tb.graph.compiled()
    assert comp2 is not comp and comp2.sharded(groups) is not sh
    # overlapping groups and a group split of one device are rejected
    e = tb.edges[0]
    with pytest.raises(ValueError):
        comp.sharded({"g1": [e], "g2": [e, *tb.servers]})
    pus = [comp.pu_index[p] for p in comp.pu_names if p.startswith(e + ".")]
    shared = [(i, j) for i in pus for j in pus
              if i != j and int(comp.ncr_res[i, j]) != -1]
    assert shared
    i0, j0 = shared[0]
    # a partition at PU granularity: device e's PUs on two sides of a
    # shared resource (the validator sees the cross-block entry)
    sh_bad = T.ShardedHWGraph.__new__(T.ShardedHWGraph)
    sh_bad.comp = comp
    sh_bad.shards = [type("S", (), dict(name="g1", pu_idx_l=[i0]))(),
                     type("S", (), dict(name="g2", pu_idx_l=[j0]))()]
    with pytest.raises(ValueError, match="block-diagonal"):
        sh_bad._validate_block_diagonal()


def test_prepare_installs_sharding_once_and_only_at_a_split_root(
        monkeypatch):
    """prepare() shards at a root with two or more children unless
    REPRO_SHARDED_WALK=0; an already-used ledger is left monolithic, and
    a delta never re-slices the installed partition."""
    _env(monkeypatch, "sharded")
    tb = _tb(T)
    g = tb.graph
    root = T.build_orchestrators(g, T.heye_traverser(g))
    root.prepare()
    led = root.ledger
    assert isinstance(led, T.ShardedLedger)
    root.prepare()                       # already sharded: untouched
    assert root.ledger is led
    g.set_bandwidth(f"link_{tb.edges[0]}", 2e6)
    root.map_batch([T.make_task("svm", origin=tb.edges[0], deadline=0.5)],
                   0.0, route=True)
    assert root.ledger is led and led.hw.comp is not g.compiled()
    monkeypatch.setenv("REPRO_SHARDED_WALK", "0")
    root2 = T.build_orchestrators(g, T.heye_traverser(g)).prepare()
    assert type(root2.ledger) is T.ActiveLedger
    monkeypatch.setenv("REPRO_SHARDED_WALK", "1")
    root3 = T.build_orchestrators(g, T.heye_traverser(g))
    root3.map_batch([T.make_task("svm", origin=tb.edges[0], deadline=0.5)],
                    0.0, route=True)
    root3.prepare()                      # a non-empty ledger stays whole
    assert type(root3.ledger) is T.ActiveLedger


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
    """A stream of single-task waves at advancing instants through one
    resident context matches the cold walk (the object walk for
    single-task waves) — in the port, and against the reference."""
    fast, root = _run(T, monkeypatch, mode, _stream)
    cold, root_c = _run(T, monkeypatch, mode, _stream, fastpath="0")
    _assert_close(fast, cold)
    _assert_close(fast, _run(R, monkeypatch, mode, _stream)[0])
    _assert_close(cold, _run(R, monkeypatch, mode, _stream,
                             fastpath="0")[0])
    assert root.context_builds == 1 and root.context_rebases == 0
    assert root_c.context_builds == 0 and root_c._resident_ctx is None


def test_resident_context_parity_across_bandwidth_churn(monkeypatch):
    """Bandwidth-only deltas between waves rebase the resident context
    (one build, then a rebase per delta); decisions match the cold walk
    and the reference."""
    def wl(pkg, tb):
        return [[pkg.make_task("svm", origin=tb.edges[0], deadline=0.5,
                               release_time=0.01 * i),
                 pkg.make_task("mlp", origin=tb.edges[1], deadline=0.5,
                               release_time=0.01 * i)]
                for i in range(4)]

    def churn(tb, i):
        tb.graph.set_bandwidth(f"link_{tb.edges[1]}", 3e6 + 1e6 * i)

    for mode in ("sharded", "fused"):
        fast, root = _run(T, monkeypatch, mode, wl, churn=churn)
        cold, _ = _run(T, monkeypatch, mode, wl, churn=churn, fastpath="0")
        _assert_close(fast, cold)
        _assert_close(fast, _run(R, monkeypatch, mode, wl, churn=churn)[0])
        assert root.context_builds == 1 and root.context_rebases == 3


def test_resident_context_identity_and_oracle_off(monkeypatch):
    """The root keeps one context across map_batch calls, rebases it onto
    a bandwidth-only successor, drops it on a death and on add_child;
    REPRO_SERVE_FASTPATH=0 keeps no resident state."""
    _env(monkeypatch, "fused")
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
    root2 = T.build_orchestrators(g, T.heye_traverser(g))
    root2.map_batch([svm(tb.edges[0])], now=0.0, route=True)
    assert root2._resident_ctx is None


def test_resident_context_drops_long_journal_and_memos(monkeypatch):
    """The journal past 50 000 entries drops the context and is reset in
    place (shards alias it); the id-keyed memos drop past 8192."""
    _env(monkeypatch, "sharded")
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
    assert all(s.mut_log is log for s in root.ledger.shards)


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
    threaded branch (os.cpu_count patched where the host has one core):
    bit-identical to the fused walk, equal to the reference, and the
    group threads' counter bumps stay exact."""
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
    threaded, _ = _run(T, monkeypatch, "sharded", _wide_wave)
    assert made == [2]
    n_threaded = dict(counts)
    for k in counts:
        counts[k] = 0
    monkeypatch.setattr("os.cpu_count", lambda: 1)
    serial, _ = _run(T, monkeypatch, "sharded", _wide_wave)
    assert made == [2]                       # no pool on one core
    assert counts == n_threaded and counts["scan_reduce_batch"] >= 2
    fused, _ = _run(T, monkeypatch, "fused", _wide_wave)
    assert threaded == serial == fused
    monkeypatch.setattr("os.cpu_count", lambda: 4)
    _assert_close(threaded, _run(R, monkeypatch, "sharded", _wide_wave)[0])


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
