"""Churn as snapshot deltas in the port: the layered route table, the
copy-on-write ``CompiledHWGraph.apply_delta``, the kin rebase of the
slowdown model's device tables, ``SchedulerSession.churn``, and mid-run
interventions on the array engine — each against the reference package on
equal fleets and equal churn, and against a fresh build of the port's own
snapshot.  Placements identical; times and factors within 1e-9."""
import gc
import itertools

import numpy as np
import pytest
import torch

import jax  # noqa: F401

import repro.core as R
import repro.core.task as Rtask
import repro_torch.core as T
import repro_torch.core.task as Ttask
from repro_torch.core.compiled import _OVERLAY_COMPACT_DIRTY, CompiledHWGraph
from torch_port_util import SNAPSHOT_ARRAYS, TOL, in_order


def small_counts(mult: int = 1) -> tuple[dict, dict]:
    """The reference suites' small testbed: 5 edges and 2 servers per
    ``mult`` (edges only scale)."""
    return ({"orin_agx": 2 * mult, "xavier_agx": mult, "orin_nano": mult,
             "xavier_nx": mult}, {"server1": 1, "server2": 1})


def seed_uids(n: int) -> None:
    """Start both packages' task-uid counters at ``n``, so equal
    workloads carry equal uids (tie orders and reprs line up)."""
    Rtask._task_counter = itertools.count(n)
    Ttask._task_counter = itertools.count(n)


def pair(ec=None, sc=None):
    """(reference testbed, port testbed on the CPU) on equal counts."""
    if ec is None:
        ec, sc = small_counts()
    return (R.build_testbed(edge_counts=ec, server_counts=sc),
            T.build_testbed(edge_counts=ec, server_counts=sc, device="cpu"))


def churn_both(rg, tg, **kw):
    rg.apply_churn(R.Churn(**kw))
    tg.apply_churn(T.Churn(**kw))


def assert_snapshot(rg, tg, devs, label):
    """The port's patched snapshot against the reference's patched
    snapshot (device columns exactly: a delta keeps the index spaces of
    the build it patches) and against a fresh build of the mutated port
    graph (aliveness exactly; prices within 1e-9, same routability)."""
    comp, fresh, ref = tg.compiled(), CompiledHWGraph(tg), rg.compiled()
    for name in SNAPSHOT_ARRAYS:
        assert np.array_equal(getattr(comp, name).numpy(),
                              np.asarray(getattr(ref, name))), (label, name)
    assert torch.equal(comp.pu_alive, fresh.pu_alive), label
    for s in devs:
        for d in devs:
            for nb in (0.0, 1e6):
                got = []
                for c in (comp, fresh, ref):
                    try:
                        got.append(c.transfer_time(s, d, nb))
                    except KeyError:
                        got.append(None)
                assert (got[0] is None) == (got[1] is None) \
                    == (got[2] is None), (label, s, d)
                if got[0] is not None:
                    assert got[0] == pytest.approx(got[1], abs=TOL, rel=TOL)
                    assert got[0] == pytest.approx(got[2], abs=TOL, rel=TOL)
    alive = [n for n, a in zip(comp.pu_names, comp.pu_alive.tolist()) if a]
    for a in alive[:24]:
        for b in alive[:24]:
            assert comp.nearest_common_resource(a, b) == \
                ref.nearest_common_resource(a, b), (label, a, b)


# ---------------------------------------------------------------------------
# the layered route table (reference tests/test_compiled.py overlay cases)
# ---------------------------------------------------------------------------
def test_bandwidth_overlay_shares_topology_layer():
    rtb, ttb = pair({"orin_agx": 2}, {"server1": 1})
    g = ttb.graph
    e0, e1, s = ttb.edges[0], ttb.edges[1], ttb.servers[0]
    old = g.compiled()
    t_before = old.transfer_time(e0, s, 10e6)     # lazy row build
    rtb.graph.compiled().transfer_time(e0, s, 10e6)
    h0, o0 = g.route_holder_copies, g.route_overlay_copies
    churn_both(rtb.graph, g, bandwidth=[(f"link_{e0}", 2e6)])
    new = g.compiled()
    assert new is not old and new._rt is not old._rt
    assert new._rt.topo is old._rt.topo           # topology layer shared
    assert g.route_holder_copies == h0
    assert g.route_overlay_copies == o0 + 1
    assert (g.route_holder_copies, g.route_overlay_copies) == (
        rtb.graph.route_holder_copies, rtb.graph.route_overlay_copies)
    # the stale sharer keeps its pre-churn pricing; the patched snapshot
    # prices the degraded uplink exactly as the reference does
    assert old.transfer_time(e0, s, 10e6) == pytest.approx(t_before, abs=TOL)
    assert new.transfer_time(e0, s, 10e6) == pytest.approx(
        rtb.graph.compiled().transfer_time(e0, s, 10e6), abs=TOL, rel=TOL)
    assert new.transfer_time(e0, s, 10e6) > t_before
    # a row built on the stale sharer writes through to the shared layer
    t_e1 = old.transfer_time(e1, s, 10e6)
    assert new.transfer_time(e1, s, 10e6) == pytest.approx(t_e1, abs=TOL)


def test_bandwidth_delta_on_unreferenced_links_shares_whole_table():
    rtb, ttb = pair({"orin_agx": 2}, {"server1": 1})
    g = ttb.graph
    comp = g.compiled()                           # no rows built yet
    o0, h0 = g.route_overlay_copies, g.route_holder_copies
    churn_both(rtb.graph, g, bandwidth=[(f"link_{ttb.edges[1]}", 5e6)])
    new = g.compiled()
    assert new is not comp and new._rt is comp._rt      # zero-copy share
    assert (g.route_overlay_copies, g.route_holder_copies) == (o0, h0)
    assert_snapshot(rtb.graph, g, ttb.edges + ttb.servers, "unreferenced")


def test_overlay_compaction_bounds_dirty_on_long_runs():
    rtb, ttb = pair({"orin_agx": 40, "xavier_agx": 30}, {"server1": 1})
    g = ttb.graph
    s = ttb.servers[0]
    links = [f"link_{e}" for e in ttb.edges]
    assert len(links) > _OVERLAY_COMPACT_DIRTY
    for e in ttb.edges:
        g.compiled().transfer_time(e, s, 5e6)
        rtb.graph.compiled().transfer_time(e, s, 5e6)
    c0 = g.route_overlay_compactions
    peak = 0
    for k, ln in enumerate(links):
        gc.collect()      # drop dead sharers so sole ownership is exact
        churn_both(rtb.graph, g, bandwidth=[(ln, 4e6 + 1e3 * k)])
        peak = max(peak, len(g.compiled()._rt.dirty))
    assert g.route_overlay_compactions > c0
    assert g.route_overlay_compactions == rtb.graph.route_overlay_compactions
    assert peak <= _OVERLAY_COMPACT_DIRTY
    devs = ttb.edges[:6] + [ttb.edges[-1], s]
    comp, fresh, ref = g.compiled(), CompiledHWGraph(g), rtb.graph.compiled()
    for a in devs:
        for b in devs:
            want = ref.transfer_time(a, b, 1e6)
            assert comp.transfer_time(a, b, 1e6) == pytest.approx(
                want, abs=TOL, rel=TOL)
            assert fresh.transfer_time(a, b, 1e6) == pytest.approx(
                want, abs=TOL, rel=TOL)


# ---------------------------------------------------------------------------
# apply_delta (reference tests/test_session.py apply-delta cases)
# ---------------------------------------------------------------------------
def test_apply_delta_parity_testbed_churn():
    rtb, ttb = pair({"orin_agx": 2, "orin_nano": 1},
                    {"server1": 1, "server2": 1})
    g = ttb.graph
    devs = ttb.edges + ttb.servers
    g.compiled()
    rtb.graph.compiled()
    for c in (g.compiled(), rtb.graph.compiled()):
        for s in devs:              # build rows so deltas have work to do
            c.transfer_time(s, devs[-1], 1e6)
    rebuilds0 = g.recompile_count
    e, lk = ttb.edges[0], f"link_{ttb.edges[1]}"
    for step, kw in (("dead pu", dict(dead=[f"{e}.gpu"])),
                     ("alive pu", dict(alive=[f"{e}.gpu"])),
                     ("dead device", dict(dead=[e])),
                     ("bandwidth", dict(bandwidth=[(lk, 1e6)])),
                     ("alive device", dict(alive=[e])),
                     ("bandwidth back", dict(bandwidth=[(lk, 1e9)]))):
        churn_both(rtb.graph, g, **kw)
        assert_snapshot(rtb.graph, g, devs, step)
    assert g.recompile_count == rebuilds0          # deltas only
    assert g.delta_count == rtb.graph.delta_count >= 6
    assert g.route_holder_copies == rtb.graph.route_holder_copies


def test_apply_delta_parity_tpu_ring_transit():
    """Host-ring routes transit other hosts: killing one re-routes pairs
    that never touch it as an endpoint."""
    rfl = R.build_tpu_fleet(n_pods=2, hosts_per_pod=4, chips_per_host=2)
    tfl = T.build_tpu_fleet(n_pods=2, hosts_per_pod=4, chips_per_host=2,
                            device="cpu")
    g = tfl.graph
    hosts = [n.name for n in g.nodes.values()
             if n.attrs.get("orc_level") == "device"]
    for c in (g.compiled(), rfl.graph.compiled()):
        for h in hosts:
            c.transfer_time(h, hosts[0], 1e6)
    rebuilds0 = g.recompile_count
    for label, kw in (("dead host", dict(dead=["pod0.host1"])),
                      ("dead host2", dict(dead=["pod0.host2"])),
                      ("alive host", dict(alive=["pod0.host1"])),
                      ("alive host2", dict(alive=["pod0.host2"]))):
        churn_both(rfl.graph, g, **kw)
        assert_snapshot(rfl.graph, g, hosts, label)
    assert g.recompile_count == rebuilds0


def test_apply_delta_slowdown_factors_match_fresh():
    rtb, ttb = pair({"orin_agx": 2}, {"server1": 1})
    for tb in (rtb, ttb):
        tb.graph.compiled()
    e = ttb.edges[1]
    churn_both(rtb.graph, ttb.graph, dead=[e])
    churn_both(rtb.graph, ttb.graph, alive=[e])
    seed_uids(80_000)
    rpool = [(R.make_task("dnn"), f"{e}.gpu"), (R.make_task("dnn"), f"{e}.dla"),
             (R.make_task("svm"), f"{e}.cpu0")]
    seed_uids(80_000)
    tpool = [(T.make_task("dnn"), f"{e}.gpu"), (T.make_task("dnn"), f"{e}.dla"),
             (T.make_task("svm"), f"{e}.cpu0")]
    got = T.DecoupledSlowdown(ttb.graph, T.heye_params()).factor_batch(tpool)
    want = R.DecoupledSlowdown(rtb.graph, R.heye_params()).factor_batch(rpool)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    ttb.graph._compiled = None                    # fresh recompile
    fresh = T.DecoupledSlowdown(ttb.graph, T.heye_params()).factor_batch(tpool)
    np.testing.assert_allclose(got.numpy(), fresh.numpy(), atol=TOL, rtol=TOL)


def test_mutation_before_first_compile_still_works():
    _, ttb = pair({"orin_agx": 1}, {"server1": 1})
    g = ttb.graph
    g.apply_churn(T.Churn(dead=[ttb.edges[0]]))   # no snapshot yet
    comp = g.compiled()
    assert not bool(comp.pu_alive[comp.pu_index[f"{ttb.edges[0]}.gpu"]])
    assert g.delta_count == 0 and g.recompile_count == 1


def test_delta_clones_device_columns_and_never_writes_in_place():
    """The port's own hazard: the snapshot columns are device tensors a
    walk's batch context or a timeline may still hold.  A delta clones
    what it changes and leaves the previous snapshot's columns as they
    were; a revival that refreshes compute paths clones those too."""
    _, ttb = pair({"orin_agx": 2}, {"server1": 1})
    g = ttb.graph
    e = ttb.edges[1]
    c0 = g.compiled()
    before = {k: getattr(c0, k).clone() for k in SNAPSHOT_ARRAYS}
    g.apply_churn(T.Churn(dead=[e]))
    c1 = g.compiled()
    assert c1.pu_alive is not c0.pu_alive
    assert c1.ncr_res is c0.ncr_res           # untouched columns shared
    g.apply_churn(T.Churn(alive=[e]))
    c2 = g.compiled()
    for k in ("pu_alive", "path_mask", "ncr_res", "ncr_rclass"):
        assert getattr(c2, k) is not getattr(c1, k), k
    for k, v in before.items():
        assert torch.equal(getattr(c0, k), v), k      # c0 never written
    assert not bool(c1.pu_alive[c1.pu_index[f"{e}.gpu"]])
    g.apply_churn(T.Churn(bandwidth=[(f"link_{e}", 3e6)]))
    c3 = g.compiled()
    for k in SNAPSHOT_ARRAYS:
        assert getattr(c3, k) is getattr(c2, k), k    # bandwidth: no copy


def test_bandwidth_delta_keeps_slowdown_device_tables():
    """Kin rebase: after a bandwidth-only delta the slowdown model's
    device tables and canonical factors carry over instead of being
    rebuilt; after a death they carry over too (the factor columns are
    shared), while a revival that refreshes compute paths rebuilds."""
    _, ttb = pair({"orin_agx": 2}, {"server1": 1})
    g = ttb.graph
    sd = T.DecoupledSlowdown(g, T.heye_params())
    tabs0 = sd._tables(g.compiled())
    sd._canon_cache_dict(g.compiled())["k"] = 1
    g.apply_churn(T.Churn(bandwidth=[(f"link_{ttb.edges[0]}", 3e6)]))
    assert sd._tables(g.compiled())[0] is tabs0[0]
    assert sd._canon_cache_dict(g.compiled()).get("k") == 1
    g.apply_churn(T.Churn(dead=[ttb.edges[0]]))
    g.apply_churn(T.Churn(alive=[ttb.edges[0]]))
    assert sd._tables(g.compiled())[0] is not tabs0[0]
    assert "k" not in sd._canon_cache_dict(g.compiled())


def test_wireless_churn_schedule_matches_reference():
    rtb, ttb = pair(*small_counts(2))
    for seed in (0, 1234):
        want = R.wireless_churn_schedule(rtb, 6, seed=seed)
        got = T.wireless_churn_schedule(ttb, 6, seed=seed)
        assert [w.bandwidth for w in got] == [w.bandwidth for w in want]
        assert all(not w.dead and not w.alive for w in got)


# ---------------------------------------------------------------------------
# SchedulerSession.churn and the consolidated Churn surface
# ---------------------------------------------------------------------------
def _session(pkg, tb, **kw):
    g = tb.graph
    return pkg.SchedulerSession(
        g, pkg.build_orchestrators(g, pkg.heye_traverser(g)), **kw)


def test_session_streaming_submit_and_churn():
    """Streaming batches across churn: mapping continues on
    delta-patched snapshots (never a rebuild) with the reference's
    placements, and nothing lands on the dead edge."""
    rtb, ttb = pair()
    out = []
    for pkg, tb in ((R, rtb), (T, ttb)):
        seed_uids(81_000)
        g = tb.graph
        s = _session(pkg, tb, truth=pkg.ground_truth_traverser(g, seed=0))
        s.submit([pkg.make_task("svm", origin=e, deadline=0.2)
                  for e in tb.edges])
        s.map_pending()
        rebuilds = g.recompile_count
        s.churn(pkg.Churn(dead=[tb.edges[0]]))
        late = [pkg.make_task("knn", origin=tb.edges[1], deadline=0.2,
                              release_time=0.5) for _ in range(4)]
        s.submit(late)
        s.map_pending()
        s.churn(pkg.Churn(alive=[tb.edges[0]]))
        assert g.recompile_count == rebuilds
        for t in late:
            assert not s.mapping[t.uid].startswith(tb.edges[0] + ".")
        out.append((s.execute(), list(s.cfg)))
    (rst, rcfg), (tst, tcfg) = out
    assert in_order(tst.mapping, tcfg) == in_order(rst.mapping, rcfg)
    assert max(abs(a - b) for a, b in zip(in_order(tst.timeline.finish, tcfg),
                                          in_order(rst.timeline.finish, rcfg))
               ) <= TOL


def test_churn_graph_direct_matches_old_entrypoints():
    _, t1 = pair()
    _, t2 = pair()
    e, lk = t1.edges[1], f"link_{t1.edges[0]}"
    s1 = _session(T, t1)
    t2.graph.compiled()
    n1, n2 = t1.graph.recompile_count, t2.graph.recompile_count
    with pytest.warns(DeprecationWarning):
        t2.graph.mark_dead(e)
    with pytest.warns(DeprecationWarning):
        t2.graph.set_bandwidth(lk, 1e6)
    s1.churn(T.Churn(dead=[e], bandwidth=[(lk, 1e6)]))
    assert not t1.graph.nodes[e].alive
    assert t1.graph.recompile_count == n1
    assert t2.graph.recompile_count == n2
    assert torch.equal(t1.graph.compiled().pu_alive,
                       t2.graph.compiled().pu_alive)
    s1.churn(T.Churn(alive=[e]))
    assert t1.graph.nodes[e].alive


def test_churn_scheduled_matches_callable_interventions_and_reference():
    """A ``Churn`` scheduled at t on the resident timeline reprices at the
    same instant as ``interventions=[(t, fn)]``, and both equal the
    reference package's resident run."""
    def drive(pkg, use_churn):
        seed_uids(82_000)
        tb = pkg.build_testbed(edge_counts=small_counts()[0],
                               server_counts=small_counts()[1],
                               **({"device": "cpu"} if pkg is T else {}))
        s = _session(pkg, tb)
        cfg = pkg.mining_workload(tb, n_sensors=12, n_readings=2)
        s.submit(cfg)
        s.map_pending()
        e = tb.edges[1]
        if use_churn:
            s.open_timeline()
            s.churn(pkg.Churn(dead=[e]), at=0.03)
            s.churn(pkg.Churn(alive=[e]), at=0.12)
        else:
            s.open_timeline(interventions=[
                (0.03, lambda: tb.graph._mark_dead(e)),
                (0.12, lambda: tb.graph._mark_alive(e))])
        return s.finalize_online(drain=True), cfg

    (rst, rcfg), (new, tcfg), (old, tcfg2) = (
        drive(R, True), drive(T, True), drive(T, False))
    want = in_order(rst.timeline.finish, rcfg)
    for st, cfg in ((new, tcfg), (old, tcfg2)):
        got = in_order(st.timeline.finish, cfg)
        assert max(abs(a - b) for a, b in zip(got, want)) <= TOL
        assert st.timeline.n_intervals == rst.timeline.n_intervals


def test_churn_engine_resident_one_flush():
    rtb, ttb = pair()
    out = []
    for pkg, tb in ((R, rtb), (T, ttb)):
        seed_uids(83_000)
        s = _session(pkg, tb)
        s.open_timeline()
        e = tb.edges[0]
        s.churn(pkg.Churn(dead=[e]))
        assert not tb.graph.nodes[e].alive
        t = pkg.make_task("render", origin=tb.edges[1], deadline=0.5)
        s.submit([t])
        s.map_pending()
        s.inject([t])
        st = s.finalize_online(drain=True)
        assert not s.mapping[t.uid].startswith(e)
        out.append((s.mapping[t.uid], st.timeline.finish[t.uid]))
    assert out[1][0] == out[0][0]
    assert out[1][1] == pytest.approx(out[0][1], abs=TOL)


def test_churn_at_requires_engine():
    _, ttb = pair()
    s = _session(T, ttb)
    with pytest.raises(RuntimeError, match="open_timeline"):
        s.churn(T.Churn(dead=[ttb.edges[0]]), at=0.1)


def test_churn_dataclass_surface():
    c = T.Churn(dead=["a"], alive=["b"], bandwidth=[("l", 1e6)])
    assert c.dead == ("a",) and c.bandwidth == (("l", 1e6),)
    assert bool(c) and len(c) == 3
    assert not T.Churn() and len(T.Churn()) == 0


# ---------------------------------------------------------------------------
# interventions on the array engine (reference tests/test_timeline.py)
# ---------------------------------------------------------------------------
def _mapped_pair(seed_uid, n_sensors=24):
    rtb, ttb = pair()
    out = []
    for pkg, tb in ((R, rtb), (T, ttb)):
        seed_uids(seed_uid)
        cfg = pkg.mining_workload(tb, n_sensors=n_sensors, n_readings=2)
        s = _session(pkg, tb)
        s.submit(cfg)
        s.map_pending()
        out.append((tb, cfg, dict(s.mapping)))
    assert in_order(out[1][2], out[1][1]) == in_order(out[0][2], out[0][1])
    return out


def _churn_run(seed_uid, fns):
    (rtb, rcfg, rmap), (ttb, tcfg, tmap) = _mapped_pair(seed_uid)
    ref_loop = R.ground_truth_traverser(rtb.graph, 2).traverse_reference(
        rcfg, rmap, interventions=fns(R, rtb))
    got = T.ground_truth_traverser(ttb.graph, 2).traverse(
        tcfg, tmap, interventions=fns(T, ttb))
    g = in_order(got.finish, tcfg)
    w = in_order(ref_loop.finish, rcfg)
    assert max(abs(a - b) for a, b in zip(g, w)) <= TOL
    for col in ("start", "queue_wait", "comm"):
        a = getattr(got, col)
        b = getattr(ref_loop, col)
        assert max(abs(a.get(t.uid, 0.0) - b.get(r.uid, 0.0))
                   for t, r in zip(tcfg, rcfg)) <= TOL, col
    return got


def test_churn_set_bandwidth_mid_run():
    """A link degrades 1000x mid-run: in-flight transfers reprice at the
    intervention instant, as in the reference package's seed loop."""
    _churn_run(84_000, lambda pkg, tb: [
        (0.02, pkg.Churn(bandwidth=[(f"link_{tb.edges[0]}", 1e6)])),
        (0.15, pkg.Churn(bandwidth=[(f"link_{tb.edges[0]}", 1e9)]))])


def test_churn_mark_dead_mid_run():
    _churn_run(85_000, lambda pkg, tb: [
        (0.03, lambda: tb.graph._mark_dead(tb.edges[1])),
        (0.12, lambda: tb.graph._mark_alive(tb.edges[1]))])


def test_churn_route_frozen_before_transit_death():
    """A transit node dies before a late task's first transfer: the route
    was frozen at traverse start in both packages."""
    rtb, ttb = pair()
    fins = []
    for pkg, tb in ((R, rtb), (T, ttb)):
        seed_uids(86_000)
        cfg = pkg.TaskGraph()
        t = pkg.make_task("render", origin=tb.edges[0], input_bytes=1e6,
                          release_time=0.05)
        cfg.add(t)
        tl = pkg.heye_traverser(tb.graph).traverse(
            cfg, {t.uid: f"{tb.servers[0]}.gpu"},
            interventions=[(0.01, pkg.Churn(dead=["edge_cluster"]))])
        fins.append(tl.finish[t.uid])
    assert fins[1] == pytest.approx(fins[0], abs=TOL)


def test_edge_column_refreshed_when_bandwidth_churns_mid_transfer():
    """The device edge column feeds the fused transfer reprice.  A
    bandwidth churn while transfers are in flight must reach it: the
    intervention refreshes the host bandwidths and drops the column, so
    the reprice divides by the post-churn bandwidth.  Finish times equal
    the reference's, and the throttled transfer really is slower."""
    rtb, ttb = pair()
    fins = {}
    for throttle in (False, True):
        out = []
        for pkg, tb in ((R, rtb), (T, ttb)):
            seed_uids(87_000)
            cfg = pkg.TaskGraph()
            ts = [pkg.make_task("render", origin=tb.edges[k % 2],
                                input_bytes=8e6, release_time=1e-3 * k)
                  for k in range(4)]
            for t in ts:
                cfg.add(t)
            mapping = {t.uid: f"{tb.servers[k % 2]}.gpu"
                       for k, t in enumerate(ts)}
            iv = [(2e-3, pkg.Churn(bandwidth=[(f"link_{tb.edges[0]}", 5e5),
                                              (f"link_{tb.edges[1]}", 2e6)])),
                  (4e-2, pkg.Churn(bandwidth=[(f"link_{tb.edges[1]}", 1e9)]))
                  ] if throttle else []
            tl = pkg.heye_traverser(tb.graph).traverse(cfg, mapping,
                                                       interventions=iv)
            out.append([tl.finish[t.uid] for t in ts])
        assert max(abs(a - b) for a, b in zip(out[1], out[0])) <= TOL
        fins[throttle] = out[1]
        rtb, ttb = pair()
    assert fins[True][0] > 2.0 * fins[False][0]
