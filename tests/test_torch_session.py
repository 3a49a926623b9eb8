"""The slice as a whole: ``SchedulerSession.run`` -> ``RunStats`` of the
port (on the CPU) against the reference at its defaults.  Mapping,
``queries``, ``hops`` and the unmapped list identical; finish times,
latencies and overheads within 1e-9."""
import numpy as np
import pytest

import jax  # noqa: F401

import repro.core as R
import repro.core.workloads as Rwork
import repro_torch.core as T
import repro_torch.core.workloads as Twork
from torch_port_util import (TOL, in_order, make_testbeds,
                             one_class_per_resource, session_pair, workload)

CASES = [("mining", 1), ("mining", 2), ("vr", None), ("vr", 1)]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def runs(request):
    return session_pair(*request.param)


def test_mapping_identical(runs):
    (rs, rcfg), (ts, tcfg) = runs
    assert in_order(ts.mapping, tcfg) == in_order(rs.mapping, rcfg)
    ridx = {t.uid: i for i, t in enumerate(rcfg)}
    tidx = {t.uid: i for i, t in enumerate(tcfg)}
    assert [tidx[u] for u in ts.unmapped] == [ridx[u] for u in rs.unmapped]


def test_queries_and_hops_identical(runs):
    (rs, rcfg), (ts, tcfg) = runs
    assert in_order(ts.queries, tcfg) == in_order(rs.queries, rcfg)
    assert in_order(ts.hops, tcfg) == in_order(rs.hops, rcfg)


def test_finish_times_latencies_overheads_within_tolerance(runs):
    (rs, rcfg), (ts, tcfg) = runs
    for got, want in (
            (in_order(ts.timeline.finish, tcfg),
             in_order(rs.timeline.finish, rcfg)),
            (ts.latencies(tcfg), rs.latencies(rcfg)),
            (in_order(ts.overhead, tcfg), in_order(rs.overhead, rcfg))):
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_run_stats_metrics_match(runs):
    (rs, rcfg), (ts, tcfg) = runs
    assert ts.qos_failures(tcfg) == rs.qos_failures(rcfg)
    assert ts.qos_failure_rate(tcfg) == pytest.approx(
        rs.qos_failure_rate(rcfg), abs=TOL)
    assert ts.mean_overhead_ratio(tcfg) == pytest.approx(
        rs.mean_overhead_ratio(rcfg), rel=TOL)
    want = rs.latency_percentiles(rcfg)
    got = ts.latency_percentiles(tcfg)
    for q in want:
        assert got[q] == pytest.approx(want[q], abs=TOL)
    assert ts.timeline.makespan == pytest.approx(rs.timeline.makespan, abs=TOL)


@pytest.mark.parametrize("policy", ["ace", "lats", "heye_seq"])
def test_runtime_and_baseline_policies_match(policy):
    rtb, ttb = make_testbeds(None)
    out = []
    for pkg, work, tb in ((R, Rwork, rtb), (T, Twork, ttb)):
        g = tb.graph
        cfg = workload(work, tb, "mining", 1)
        if policy == "ace":
            pol = pkg.AcePolicy(g, pkg.Traverser(g, slowdown=pkg.NoSlowdown(g)))
        elif policy == "lats":
            pol = pkg.LatsPolicy(g, pkg.Traverser(g, slowdown=pkg.NoSlowdown(g)))
        else:
            pol = pkg.OrchestratorPolicy(
                pkg.build_orchestrators(g, pkg.heye_traverser(g)))
        stats = pkg.Runtime(g, seed=4).run(cfg, pol)
        out.append((stats, cfg))
    (rs, rcfg), (ts, tcfg) = out
    assert in_order(ts.mapping, tcfg) == in_order(rs.mapping, rcfg)
    np.testing.assert_allclose(in_order(ts.timeline.finish, tcfg),
                               in_order(rs.timeline.finish, rcfg),
                               rtol=0, atol=TOL)


def _session_run(pkg, tb, cfg, seed=0):
    g = tb.graph
    root = pkg.build_orchestrators(g, pkg.heye_traverser(g))
    sess = pkg.SchedulerSession(
        g, root, truth=pkg.ground_truth_traverser(g, seed=seed))
    return sess.run(cfg)


def _assert_same_run(rs, rcfg, ts, tcfg):
    assert in_order(ts.mapping, tcfg) == in_order(rs.mapping, rcfg)
    assert not ts.unmapped and not rs.unmapped
    for got, want in ((in_order(ts.timeline.finish, tcfg),
                       in_order(rs.timeline.finish, rcfg)),
                      (in_order(ts.overhead, tcfg),
                       in_order(rs.overhead, rcfg))):
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_more_classes_than_registers_match_reference():
    """The paper's testbed with one resource class per resource node (44
    classes, past the kernels' 16 register-held ones): the mining session
    of the port against the reference, seeded."""
    rtb, ttb = make_testbeds(None)
    one_class_per_resource(rtb.graph)
    one_class_per_resource(ttb.graph)
    n_classes = len(ttb.graph.compiled().rclass_names)
    assert n_classes == len(rtb.graph.compiled().rclass_names) == 44
    rcfg = workload(Rwork, rtb, "mining", 1)
    tcfg = workload(Twork, ttb, "mining", 1)
    _assert_same_run(_session_run(R, rtb, rcfg, seed=3), rcfg,
                     _session_run(T, ttb, tcfg, seed=3), tcfg)


def test_vr_session_at_30_frames_matches_reference():
    """The paper's VR workload at its default length (5 edges x 30 frames,
    1050 tasks), transfer-heavy: the port's session against the
    reference's."""
    rtb, ttb = make_testbeds(None)
    rcfg = Rwork.vr_workload(rtb, n_frames=30)
    tcfg = Twork.vr_workload(ttb, n_frames=30)
    assert len(tcfg) == 1050
    _assert_same_run(_session_run(R, rtb, rcfg), rcfg,
                     _session_run(T, ttb, tcfg), tcfg)


def test_incremental_submit_and_percentiles():
    _, ttb = make_testbeds(1)
    g = ttb.graph
    cfg = workload(Twork, ttb, "mining", 1)
    root = T.build_orchestrators(g, T.heye_traverser(g))
    sess = T.SchedulerSession(g, root, truth=T.ground_truth_traverser(g))
    half = len(cfg.tasks) // 2
    sess.submit(cfg.tasks[:half])
    first = sess.map_pending()
    sess.submit(cfg.tasks[half:])
    second = sess.map_pending()
    assert len(first) == half and len(second) == len(cfg.tasks) - half
    stats = sess.execute()
    assert len(stats.timeline.finish) == len(cfg.tasks)
    assert T.percentiles([], (50.0,))[50.0] != T.percentiles([], (50.0,))[50.0]
    assert T.percentiles([1.0, 3.0], (50.0,))[50.0] == 2.0
