"""The port's online serving continuum against the reference package:
the session-resident timeline (upfront, wave-injected and churned runs
to 1e-9 of the reference's seed loop), its observation API, the seeded
arrival streams (bit-identical), the admission verdicts, and whole
``ServeLoop`` runs — request for request: verdicts, reject reasons,
placements, finish times within 1e-9, and ``ServeStats.summary()`` equal
but for the wall-clock field."""
import itertools
from itertools import groupby

import numpy as np
import pytest

import jax  # noqa: F401

import repro.core as R
import repro.core.task as Rtask
import repro.serve.admission as RA
import repro_torch.core as T
import repro_torch.core.task as Ttask
import repro_torch.serve.admission as TA
from repro.core.timeline import TimelineEngine as RTE
from repro_torch.core.timeline import TimelineEngine as TTE
from torch_port_util import TOL, in_order


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


def make_tb(pkg, mult=1):
    ec, sc = small_counts(mult)
    kw = {"device": "cpu"} if pkg is T else {}
    return pkg.build_testbed(edge_counts=ec, server_counts=sc, **kw)


def mapped(pkg, workload_fn, seed_uid):
    seed_uids(seed_uid)
    tb = make_tb(pkg)
    cfg = workload_fn(pkg, tb)
    g = tb.graph
    s = pkg.SchedulerSession(g, pkg.build_orchestrators(
        g, pkg.heye_traverser(g)))
    s.submit(cfg)
    s.map_pending()
    return tb, cfg, dict(s.mapping)


def trav(pkg, g, noise_seed):
    return (pkg.heye_traverser(g) if noise_seed is None
            else pkg.ground_truth_traverser(g, noise_seed))


def assert_tl(ref, rcfg, got, tcfg):
    """Port timeline against a reference one, in cfg order."""
    assert in_order(got.mapping, tcfg) == in_order(ref.mapping, rcfg)
    for col in ("finish", "start", "queue_wait", "comm"):
        a, b = getattr(got, col), getattr(ref, col)
        assert [t.uid in a for t in tcfg] == [r.uid in b for r in rcfg], col
        d = [abs(a[t.uid] - b[r.uid]) for t, r in zip(tcfg, rcfg)
             if r.uid in b]
        assert max(d, default=0.0) <= TOL, col


def mining(n_sensors, n_readings):
    return lambda pkg, tb: pkg.mining_workload(tb, n_sensors=n_sensors,
                                               n_readings=n_readings)


# ---------------------------------------------------------------------------
# the resident timeline: online == offline, against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,noise_seed", [("mining", None), ("mining", 0),
                                             ("vr", None), ("vr", 3)])
def test_upfront_resident_parity(kind, noise_seed):
    wl = (mining(18, 2) if kind == "mining"
          else lambda pkg, tb: pkg.vr_workload(tb, n_frames=5))
    rtb, rcfg, rmap = mapped(R, wl, 600_000)
    ttb, tcfg, tmap = mapped(T, wl, 600_000)
    want = trav(R, rtb.graph, noise_seed).traverse_reference(rcfg, rmap)
    eng = TTE.open(trav(T, ttb.graph, noise_seed), cfg=tcfg,
                   mapping=dict(tmap))
    assert_tl(want, rcfg, eng.advance().timeline(), tcfg)


def _waves(eng, cfg):
    tasks = sorted(cfg, key=lambda t: (t.release_time, t.uid))
    for rel, grp in groupby(tasks, key=lambda t: t.release_time):
        eng.advance(np.nextafter(rel, -np.inf))
        eng.inject(list(grp))
    return eng.advance().timeline()


def test_wave_injection_parity():
    """Inject the workload wave by wave (advance to just before each
    release instant, then inject that cohort): event for event the
    reference's one-shot run."""
    rtb, rcfg, rmap = mapped(R, mining(18, 3), 620_000)
    ttb, tcfg, tmap = mapped(T, mining(18, 3), 620_000)
    want = R.ground_truth_traverser(rtb.graph, 1).traverse_reference(
        rcfg, rmap)
    eng = TTE.open(T.ground_truth_traverser(ttb.graph, 1), mapping=dict(tmap))
    eng.cfg = tcfg
    got = _waves(eng, tcfg)
    assert_tl(want, rcfg, got, tcfg)
    # the reference's own resident engine, injected the same way, drains
    # the same events
    rtb2, rcfg2, rmap2 = mapped(R, mining(18, 3), 620_000)
    reng = RTE.open(R.ground_truth_traverser(rtb2.graph, 1),
                    mapping=dict(rmap2))
    reng.cfg = rcfg2
    want2 = _waves(reng, rcfg2)
    assert (got.n_events, got.n_intervals) == (want2.n_events,
                                               want2.n_intervals)


@pytest.mark.parametrize("kind", ["bandwidth", "dead"])
def test_resident_churn_parity(kind):
    """Churn scheduled on a resident engine while work is injected wave
    by wave around it matches the reference's seed loop with the same
    interventions."""
    def fns(pkg, tb):
        if kind == "bandwidth":
            lk = f"link_{tb.edges[0]}"
            return [(0.02, pkg.Churn(bandwidth=[(lk, 1e6)])),
                    (0.15, pkg.Churn(bandwidth=[(lk, 1e9)]))]
        e = tb.edges[1]
        return [(0.03, lambda: tb.graph._mark_dead(e)),
                (0.12, lambda: tb.graph._mark_alive(e))]

    rtb, rcfg, rmap = mapped(R, mining(24, 2), 630_000)
    ttb, tcfg, tmap = mapped(T, mining(24, 2), 630_000)
    want = R.ground_truth_traverser(rtb.graph, 2).traverse_reference(
        rcfg, rmap, interventions=fns(R, rtb))
    eng = TTE.open(T.ground_truth_traverser(ttb.graph, 2), mapping=dict(tmap))
    eng.cfg = tcfg
    for t, fn in fns(T, ttb):
        eng.schedule(t, fn)
    assert_tl(want, rcfg, _waves(eng, tcfg), tcfg)
    if kind == "bandwidth":
        assert ttb.graph.recompile_count == 1


def test_session_finalize_online_matches_execute():
    """open_timeline after mapping, drain: RunStats equal the offline
    execute() (the port's and the reference's) to 1e-9, overhead
    columns included."""
    def drive(pkg, online):
        seed_uids(640_000)
        tb = make_tb(pkg)
        cfg = pkg.mining_workload(tb, n_sensors=12, n_readings=2)
        g = tb.graph
        s = pkg.SchedulerSession(
            g, pkg.build_orchestrators(g, pkg.heye_traverser(g)),
            truth=pkg.ground_truth_traverser(g, 0))
        s.submit(cfg)
        s.map_pending()
        if not online:
            return s, s.execute(), cfg
        s.open_timeline()
        return s, s.finalize_online(), cfg

    _, ref, rcfg = drive(R, False)
    _, off, ocfg = drive(T, False)
    s_on, on, tcfg = drive(T, True)
    assert s_on.engine_opens == 1
    assert_tl(ref.timeline, rcfg, on.timeline, tcfg)
    assert_tl(off.timeline, ocfg, on.timeline, tcfg)
    assert in_order(on.overhead, tcfg) == in_order(off.overhead, ocfg)
    assert max(abs(a - b) for a, b in zip(in_order(on.overhead, tcfg),
                                          in_order(ref.overhead, rcfg))) <= TOL


# ---------------------------------------------------------------------------
# resident-engine API contracts
# ---------------------------------------------------------------------------
def test_inject_into_past_raises():
    tb = make_tb(T)
    eng = TTE.open(T.heye_traverser(tb.graph))
    eng.advance(0.5)
    assert eng.time == 0.5
    late = T.make_task("dnn", origin=tb.edges[0], release_time=0.1)
    eng.cfg.add(late)
    with pytest.raises(ValueError):
        eng.inject([late], mapping={late.uid: f"{tb.edges[0]}.gpu"})
    with pytest.raises(RuntimeError):
        TTE(T.heye_traverser(tb.graph), T.TaskGraph(), {}).inject([late])


def _two_tasks(pkg, eng, tb):
    t1 = pkg.make_task("dnn", origin=tb.edges[0], release_time=0.0)
    t2 = pkg.make_task("dnn", origin=tb.edges[0], release_time=10.0)
    for t in (t1, t2):
        eng.cfg.add(t)
    eng.inject([t1, t2], mapping={t.uid: f"{tb.edges[0]}.gpu"
                                  for t in (t1, t2)})
    return t1, t2


def test_drain_finished_and_finish_of():
    out = []
    for pkg, TE in ((R, RTE), (T, TTE)):
        tb = make_tb(pkg)
        eng = TE.open(pkg.heye_traverser(tb.graph))
        t1, t2 = _two_tasks(pkg, eng, tb)
        assert np.isnan(eng.finish_of(t1.uid))
        assert eng.next_event_time() == 0.0
        eng.advance(5.0)
        assert [t.uid for t in eng.drain_finished()] == [t1.uid]
        assert eng.drain_finished() == []           # cursor moved
        assert np.isnan(eng.finish_of(t2.uid))      # not yet released
        assert eng.next_event_time() == 10.0
        assert eng.live_jobs == 0
        f1 = eng.finish_of(t1.uid)
        eng.advance()
        assert [t.uid for t in eng.drain_finished()] == [t2.uid]
        assert set(eng.timeline().finish) == {t1.uid, t2.uid}
        assert eng.next_event_time() == float("inf")
        out.append((f1, eng.finish_of(t2.uid)))
    assert out[1] == pytest.approx(out[0], abs=TOL)


def test_timeline_partial_mid_run():
    tb = make_tb(T)
    eng = TTE.open(T.heye_traverser(tb.graph))
    t1, t2 = _two_tasks(T, eng, tb)
    eng.advance(5.0)
    snap = eng.timeline(partial=True)
    assert t1.uid in snap.finish and t2.uid not in snap.finish
    with pytest.raises(RuntimeError):
        eng.timeline()                              # t2 still pending


def test_noisy_slowdown_model_rejected_for_resident():
    tb = make_tb(T)
    noisy = T.Traverser(tb.graph, T.DecoupledSlowdown(
        tb.graph, T.truth_params(), rng=np.random.default_rng(0)))
    with pytest.raises(ValueError):
        TTE.open(noisy)


def test_session_withdraw_restores_state_and_ledger_retire():
    seed_uids(710_000)
    tb = make_tb(T)
    root = T.build_orchestrators(tb.graph, T.heye_traverser(tb.graph))
    s = T.SchedulerSession(tb.graph, root)
    g = T.TaskGraph("req")
    t = T.make_task("svm", origin=tb.edges[0], release_time=0.05)
    g.add(t)
    s.submit(g)
    assert s.map_pending(fallback=False)[t.uid] is not None
    assert len(root.ledger) == 1
    s.withdraw(t)
    assert t.release_time == 0.05 and t.assigned_pu is None
    assert len(root.ledger) == 0 and len(s.cfg) == 0
    assert t.uid not in s.mapping
    g2 = T.TaskGraph("req2")
    g2.add(t)
    s.submit(g2)
    assert s.map_pending()[t.uid] is not None
    s.open_timeline()                # ingests the mapped session CFG
    with pytest.raises(ValueError):
        s.withdraw(t)                # settled history
    cfg = T.mining_workload(tb, n_sensors=4, n_readings=1)
    s.submit(cfg)
    s.map_pending()
    uids = [x.uid for x in cfg]
    n0 = len(root.ledger)
    assert root.ledger.retire(uids[:5]) == 5
    assert len(root.ledger) == n0 - 5
    assert root.ledger.retire([999_999_999]) == 0
    assert root.ledger.retire([]) == 0


# ---------------------------------------------------------------------------
# arrival streams: bit-identical to the reference's draws
# ---------------------------------------------------------------------------
def test_poisson_and_diurnal_streams_bit_identical():
    for rate, seed in ((500.0, 42), (75.0 * 64, 0), (300.0, 5)):
        want = R.PoissonArrivals(rate=rate, seed=seed).times(2.0)
        got = T.PoissonArrivals(rate=rate, seed=seed).times(2.0)
        assert got.tobytes() == want.tobytes()
    assert (np.diff(got) > 0).all() and got[-1] < 2.0
    for kw in (dict(base_rate=50.0, peak_rate=500.0, period=2.0, seed=3),
               dict(base_rate=20.0 * 64, peak_rate=60.0 * 64,
                    period=10 / 64, seed=1)):
        want = R.DiurnalArrivals(**kw).times(kw["period"])
        got = T.DiurnalArrivals(**kw).times(kw["period"])
        assert got.tobytes() == want.tobytes()
    d = T.DiurnalArrivals(base_rate=50.0, peak_rate=500.0, period=2.0)
    assert float(d.rate(0.0)) == pytest.approx(50.0)
    assert float(d.rate(1.0)) == pytest.approx(500.0)
    with pytest.raises(ValueError):
        T.PoissonArrivals(rate=0.0)


def test_closed_loop_streams_bit_identical():
    with pytest.raises(ValueError):
        T.ClosedLoopClients(clients=0, think_mean=0.1)
    with pytest.raises(ValueError):
        T.ClosedLoopClients(clients=2, think_mean=0.0)
    a = R.ClosedLoopClients(clients=8, think_mean=0.05, seed=3)
    b = T.ClosedLoopClients(clients=8, think_mean=0.05, seed=3)
    assert b.initial_arrivals(10.0) == a.initial_arrivals(10.0)
    assert [b.think(k % 8) for k in range(20)] == \
        [a.think(k % 8) for k in range(20)]
    assert b.initial_arrivals(0.01) == a.initial_arrivals(0.01)


# ---------------------------------------------------------------------------
# admission verdicts
# ---------------------------------------------------------------------------
class _FixedArrivals:
    def __init__(self, instants):
        self.instants = np.asarray(instants, dtype=np.float64)

    def times(self, horizon):
        return self.instants[self.instants < horizon]


def _loop(pkg, tb, tenants, admission, horizon, **kw):
    g = tb.graph
    return pkg.ServeLoop(g, pkg.build_orchestrators(g, pkg.heye_traverser(g)),
                         tenants, truth=pkg.ground_truth_traverser(g, 0),
                         admission=admission, horizon=horizon, **kw)


def _one_request(pkg, A, adm, sla, arrivals=(0.01,), max_inflight=None):
    tb = make_tb(pkg)
    tenants = [pkg.TenantSpec(
        "t0", _FixedArrivals(arrivals),
        pkg.single_task_request("svm", origin=tb.edges[0], sla=sla),
        sla=sla, max_inflight=max_inflight)]
    loop = _loop(pkg, tb, tenants, adm(A), 1.0)
    return loop, loop.run()


ADMISSION_CASES = {
    "projected_sla": (lambda A: A.AdmissionController(slack=1.0), 1e-7, {}),
    "defer_then_reject": (lambda A: A.AdmissionController(
        defer_delay=0.01, max_defers=2), 0.5, dict(max_inflight=0)),
    "defer_then_accept": (lambda A: A.AdmissionController(
        slack=float("inf"), defer_delay=0.2, max_defers=10), None,
        dict(arrivals=(0.01, 0.011), max_inflight=1)),
    "admit_all": (lambda A: A.admit_all(), 1e-7, {}),
}


@pytest.mark.parametrize("case", sorted(ADMISSION_CASES))
def test_admission_verdicts_match_reference(case):
    adm, sla, kw = ADMISSION_CASES[case]
    seed_uids(660_000)
    rloop, want = _one_request(R, RA, adm, sla, **kw)
    seed_uids(660_000)
    tloop, got = _one_request(T, TA, adm, sla, **kw)
    assert [(r.verdict, r.reject_reason, r.defers) for r in got.requests] \
        == [(r.verdict, r.reject_reason, r.defers) for r in want.requests]
    assert got.sla_attainment() == want.sla_attainment()
    assert got.deferrals == want.deferrals and got.engine_opens == 1
    for a, b in zip(got.requests, want.requests):
        assert (np.isnan(a.finish) and np.isnan(b.finish)) or \
            a.finish == pytest.approx(b.finish, abs=TOL)
    if case == "projected_sla":
        assert got.requests[0].verdict == "rejected"
        assert len(tloop.session.policy.ledger) == 0
        assert len(tloop.session.cfg) == 0       # withdrawn from the CFG


def test_decision_constructors_and_adaptive_window():
    assert TA.Decision.accept().verdict is TA.Verdict.ACCEPT
    d = TA.Decision.defer("quota", retry_at=1.5)
    assert d.verdict is TA.Verdict.DEFER and d.retry_at == 1.5
    assert TA.Decision.reject("x").reason == "x"
    w = TA.AdaptiveWindow(max_window=0.01, depth_hi=10, proj_hi=2.0)
    rw = RA.AdaptiveWindow(max_window=0.01, depth_hi=10, proj_hi=2.0)
    for depth, proj in ((0, 0.0), (0, 1.0), (5, 0.0), (10, 0.0), (40, 0.0),
                        (0, 1.5), (0, 3.0), (5, 1.5)):
        assert w.window(depth, proj) == rw.window(depth, proj)
    assert w.window(5, 1.5) == pytest.approx(0.005)
    assert TA.AdaptiveWindow(max_window=0.01,
                             min_window=0.002).window(0, 0.0) == 0.002


# ---------------------------------------------------------------------------
# whole ServeLoop runs, request for request
# ---------------------------------------------------------------------------
def _tenants(pkg, tb, horizon):
    return [
        pkg.TenantSpec("mining", pkg.PoissonArrivals(rate=250, seed=21),
                       pkg.single_task_request("svm", origin=tb.edges[0],
                                               sla=0.1), sla=0.1),
        pkg.TenantSpec("vision", pkg.DiurnalArrivals(
            base_rate=60, peak_rate=180, period=horizon, seed=22),
            pkg.single_task_request("mlp", origin=tb.edges[1], sla=0.15),
            sla=0.15)]


def serve_run(pkg, A, slack=4.0, horizon=0.3, iv=None, batch_window=0.0,
              tenants=None):
    seed_uids(730_000)
    tb = make_tb(pkg)
    ten = (tenants or _tenants)(pkg, tb, horizon)
    loop = _loop(pkg, tb, ten,
                 A.AdmissionController(slack=slack, defer_delay=0.005,
                                       max_defers=1), horizon,
                 batch_window=(A.AdaptiveWindow(**batch_window)
                               if isinstance(batch_window, dict)
                               else batch_window),
                 interventions=iv(pkg, tb) if iv else ())
    return loop, loop.run()


def assert_serve_equal(rl, want, tl, got):
    assert len(got.requests) == len(want.requests)
    for a, b in zip(got.requests, want.requests):
        assert (a.tenant, a.rid, a.verdict, a.reject_reason, a.defers) == \
            (b.tenant, b.rid, b.verdict, b.reject_reason, b.defers)
        assert a.arrival == b.arrival
        if a.verdict == "accepted":
            assert [tl.session.mapping[t.uid] for t in a.tasks] == \
                [rl.session.mapping[t.uid] for t in b.tasks]
        if np.isnan(a.finish) or np.isnan(b.finish):
            assert np.isnan(a.finish) and np.isnan(b.finish)
        else:
            assert a.finish == pytest.approx(b.finish, abs=TOL, rel=TOL)
    sg, sw = got.summary(), want.summary()
    sg.pop("wall_rps")
    sw.pop("wall_rps")
    for k in ("p50_ms", "p99_ms", "p999_ms"):
        assert sg.pop(k) == pytest.approx(sw.pop(k), abs=1e-6, rel=TOL), k
    assert sg == sw
    assert got.wave_sizes == want.wave_sizes
    assert got.engine_opens == 1


@pytest.mark.parametrize("fastpath", ["default", "off"])
@pytest.mark.parametrize("slack", [4.0, 0.35])
def test_serve_loop_summary_matches_reference(monkeypatch, slack, fastpath):
    """The port's one walk path, the session-resident context, gives the
    reference's run on both of its paths: its resident context (the
    default) and its cold per-wave walk (``REPRO_SERVE_FASTPATH=0``, the
    object walk for one-task waves), which the port does not read.  The
    port's root builds one resident context and reuses it."""
    if fastpath == "off":
        monkeypatch.setenv("REPRO_SERVE_FASTPATH", "0")
    rl, want = serve_run(R, RA, slack=slack)
    tl, got = serve_run(T, TA, slack=slack)
    assert_serve_equal(rl, want, tl, got)
    if slack == 0.35:
        assert any(r.verdict == "rejected" for r in got.requests)
    root = tl.session.policy
    assert root._resident_ctx is not None
    assert root.context_builds == 1 and len(got.wave_sizes) > 1
    if fastpath == "off":
        assert rl.session.policy._resident_ctx is None


def test_serve_loop_with_mid_run_churn_matches_reference():
    """Death + revival of an edge and a wireless bandwidth wave under live
    traffic: zero engine rebuilds, every churn a delta, and the run is
    the reference's request for request."""
    def iv(pkg, tb):
        e = tb.edges[1]
        wave = pkg.wireless_churn_schedule(tb, 1, seed=3)[0]
        return [(0.05, wave),
                (0.08, lambda: tb.graph._mark_dead(e)),
                (0.18, lambda: tb.graph._mark_alive(e))]
    rl, want = serve_run(R, RA, iv=iv)
    tl, got = serve_run(T, TA, iv=iv)
    assert_serve_equal(rl, want, tl, got)
    g = tl.session.graph
    assert g.recompile_count == 1 and g.delta_count == 3


def test_adaptive_window_and_closed_loop_match_reference():
    bw = dict(max_window=0.01, depth_hi=4)
    rl, want = serve_run(R, RA, slack=float("inf"), batch_window=bw)
    tl, got = serve_run(T, TA, slack=float("inf"), batch_window=bw)
    assert_serve_equal(rl, want, tl, got)
    assert max(got.wave_sizes) > 1
    assert sum(got.wave_sizes) == len(got.requests) + got.deferrals

    def closed(pkg, tb, horizon):
        return [pkg.TenantSpec(
            "cl", pkg.ClosedLoopClients(clients=6, think_mean=0.02, seed=7),
            pkg.single_task_request("svm", origin=tb.edges[0], sla=0.2),
            sla=0.2)]
    rl, want = serve_run(R, RA, horizon=0.4, tenants=closed)
    tl, got = serve_run(T, TA, horizon=0.4, tenants=closed)
    assert_serve_equal(rl, want, tl, got)
    assert len(got.requests) > 6
    assert [(r.client, r.arrival) for r in got.requests] == \
        [(r.client, r.arrival) for r in want.requests]
