"""State carried across: a reference graph / task graph / snapshot /
ledger exported to plain specs (python scalars, strings, numpy) and loaded
by ``repro_torch.interop``.  Round trips are exact: equal snapshots, equal
sessions."""
import numpy as np
import pytest
import torch

import jax  # noqa: F401

import repro.core as R
import repro.core.workloads as Rwork
import repro_torch.core as T
from repro_torch import interop
from torch_port_util import (SNAPSHOT_ARRAYS, TOL, export_graph_spec,
                             export_ledger_columns, export_snapshot_arrays,
                             export_tasks_spec, in_order, make_testbeds,
                             workload)


@pytest.fixture(scope="module")
def carried():
    rtb, ttb = make_testbeds(1)
    g = interop.graph_from_spec(export_graph_spec(rtb.graph), device="cpu")
    return rtb, ttb, g


def test_graph_from_spec_equals_built_graph(carried):
    rtb, ttb, g = carried
    assert list(g.nodes) == list(ttb.graph.nodes)
    a, b = g.compiled(), ttb.graph.compiled()
    for name in SNAPSHOT_ARRAYS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert a.pu_names == b.pu_names and a.dev_ord_names == b.dev_ord_names
    src, dst = rtb.edges[0], rtb.servers[-1]
    assert a.transfer_time(src, dst, 1e5) == b.transfer_time(src, dst, 1e5)


def test_tasks_from_spec_keeps_fields_and_deps():
    rtb, _ = make_testbeds(None)
    rcfg = workload(Rwork, rtb, "vr", None)
    tcfg = interop.tasks_from_spec(export_tasks_spec(rcfg))
    assert len(tcfg) == len(rcfg)
    for r, t in zip(rcfg, tcfg):
        assert (t.kind, t.size, t.deadline, t.origin, t.input_bytes,
                t.output_bytes, t.release_time, t.usage, t.attrs) == \
            (r.kind, r.size, r.deadline, r.origin, r.input_bytes,
             r.output_bytes, r.release_time, r.usage, r.attrs)
        assert [rcfg.tasks.index(p) for p in rcfg.preds(r)] == \
            [tcfg.tasks.index(p) for p in tcfg.preds(t)]


def test_carried_graph_and_tasks_reproduce_the_reference_session(carried):
    rtb, _, g = carried
    rcfg = workload(Rwork, rtb, "mining", 1)
    tcfg = interop.tasks_from_spec(export_tasks_spec(rcfg))
    rroot = R.build_orchestrators(rtb.graph, R.heye_traverser(rtb.graph))
    rs = R.SchedulerSession(
        rtb.graph, rroot, truth=R.ground_truth_traverser(rtb.graph)).run(rcfg)
    troot = T.build_orchestrators(g, T.heye_traverser(g))
    ts = T.SchedulerSession(
        g, troot, truth=T.ground_truth_traverser(g)).run(tcfg)
    assert in_order(ts.mapping, tcfg) == in_order(rs.mapping, rcfg)
    np.testing.assert_allclose(in_order(ts.timeline.finish, tcfg),
                               in_order(rs.timeline.finish, rcfg),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("with_graph", [False, True])
def test_snapshot_from_numpy_round_trip(carried, with_graph):
    rtb, ttb, _ = carried
    arrays = export_snapshot_arrays(rtb.graph.compiled())
    g = interop.graph_from_spec(export_graph_spec(rtb.graph), device="cpu") \
        if with_graph else None
    comp = interop.snapshot_from_numpy(arrays, device="cpu", graph=g)
    want = ttb.graph.compiled()
    for name in SNAPSHOT_ARRAYS:
        got = getattr(comp, name)
        assert got.dtype == getattr(want, name).dtype
        assert torch.equal(got, getattr(want, name)), name
    assert comp.pu_index == want.pu_index
    assert comp.rclass_names == want.rclass_names
    if with_graph:
        assert g.compiled() is comp
        src, dst = rtb.edges[1], rtb.servers[0]
        assert comp.transfer_time(src, dst, 5e4) == pytest.approx(
            rtb.graph.compiled().transfer_time(src, dst, 5e4), rel=TOL)
        sd = T.DecoupledSlowdown(g)
        pool = [(T.make_task("knn"), comp.pu_names[0]),
                (T.make_task("svm"), comp.pu_names[1]),
                (T.make_task("mlp"), comp.pu_names[0])]
        rpool = [(R.make_task(t.kind), p) for t, p in pool]
        np.testing.assert_allclose(
            sd.factor_batch(pool).numpy(),
            R.DecoupledSlowdown(rtb.graph).factor_batch(rpool), rtol=TOL)


def test_ledger_from_numpy_round_trip(carried, monkeypatch):
    rtb, ttb, _ = carried
    rcfg = workload(Rwork, rtb, "mining", 1)
    tcfg = interop.tasks_from_spec(export_tasks_spec(rcfg))
    rroot = R.build_orchestrators(rtb.graph, R.heye_traverser(rtb.graph))
    # a monolithic reference ledger to export (its sharded form holds the
    # same rows; the reference pins the two identical)
    monkeypatch.setenv("REPRO_SHARDED_WALK", "0")
    rroot.map_batch(rcfg.tasks[:10], 0.0, route=True)
    task_map = {r.uid: t for r, t in zip(rcfg, tcfg)}
    cols = export_ledger_columns(rroot.ledger, task_map)
    comp = ttb.graph.compiled()
    led = interop.ledger_from_numpy(cols, device="cpu", comp=comp)
    assert len(led) == 10
    view = led.live_view(comp)
    rview = rroot.ledger.live_view(rtb.graph.compiled())
    np.testing.assert_array_equal(view.P.numpy(), rview.P)
    np.testing.assert_array_equal(view.est.numpy(), rview.est)
    np.testing.assert_array_equal(view.Ma.numpy(), rview.Ma)
    np.testing.assert_array_equal(view.na.numpy(), rview.na)
    # the loaded ledger keeps mapping like the reference's
    troot = T.build_orchestrators(ttb.graph, T.heye_traverser(ttb.graph),
                                  ledger=led)
    rres = rroot.map_batch(rcfg.tasks[10:16], 0.0, route=True)
    tres = troot.map_batch(tcfg.tasks[10:16], 0.0, route=True)
    assert [r.pu for r in tres] == [r.pu for r in rres]
