"""``Orchestrator.map_batch`` of the port against the reference at its
defaults: placements, ``queries`` and ``hops`` identical, ``overhead`` and
the prediction columns within 1e-9."""
import numpy as np
import pytest

import jax  # noqa: F401

import repro.core as R
import repro.core.workloads as Rwork
import repro_torch.core as T
import repro_torch.core.workloads as Twork
from torch_port_util import TOL, make_testbeds, workload


def roots(mult, config=None):
    rtb, ttb = make_testbeds(mult)
    rroot = R.build_orchestrators(
        rtb.graph, R.heye_traverser(rtb.graph),
        config=R.OrcConfig(**config) if config else None)
    troot = T.build_orchestrators(
        ttb.graph, T.heye_traverser(ttb.graph),
        config=T.OrcConfig(**config) if config else None)
    return rtb, rroot, ttb, troot


def assert_same(rres, tres):
    assert len(rres) == len(tres)
    for a, b in zip(rres, tres):
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert b.pu == a.pu
        assert b.queries == a.queries and b.hops == a.hops
        assert b.overhead == pytest.approx(a.overhead, rel=TOL, abs=1e-15)
        for f in ("standalone", "factor", "comm"):
            assert getattr(b.prediction, f) == pytest.approx(
                getattr(a.prediction, f), rel=TOL, abs=1e-15)


@pytest.mark.parametrize("kind,mult", [("mining", 1), ("mining", 2),
                                       ("vr", None)])
def test_map_batch_waves_match_reference(kind, mult):
    rtb, rroot, ttb, troot = roots(mult)
    rcfg = workload(Rwork, rtb, kind, mult)
    tcfg = workload(Twork, ttb, kind, mult)
    # independent release-time waves, mapped in order against one ledger
    times = sorted({t.release_time for t in rcfg})
    for now in times:
        rw = [t for t in rcfg if t.release_time == now and not rcfg.preds(t)]
        tw = [t for t in tcfg if t.release_time == now and not tcfg.preds(t)]
        assert_same(rroot.map_batch(rw, now, route=True),
                    troot.map_batch(tw, now, route=True))
    assert len(troot.ledger) == len(rroot.ledger)


def test_single_task_waves_and_sequential_equivalence():
    rtb, rroot, ttb, troot = roots(1)
    rcfg = workload(Rwork, rtb, "mining", 1)
    tcfg = workload(Twork, ttb, "mining", 1)
    rres = [rroot.map_batch([t], 0.0, route=True)[0] for t in rcfg.tasks[:12]]
    tres = [troot.map_batch([t], 0.0, route=True)[0] for t in tcfg.tasks[:12]]
    assert_same(rres, tres)
    # one 12-task batch gives what 12 one-task batches gave
    _, _, ttb2, troot2 = roots(1)
    tcfg2 = workload(Twork, ttb2, "mining", 1)
    batch = troot2.map_batch(tcfg2.tasks[:12], 0.0, route=True)
    assert [r.pu for r in batch] == [r.pu for r in tres]


def test_overload_escalates_and_matches_reference():
    """Many tasks from one weak edge: the walk escalates to siblings and
    the server cluster; hops and overhead are charged as in the
    reference."""
    rtb, rroot, ttb, troot = roots(None)
    edge = rtb.edges[-1]
    mk = lambda pkg: [pkg.make_task("knn", origin=edge, deadline=0.1,
                                    input_bytes=64e3) for _ in range(30)]
    rres = rroot.map_batch(mk(R), 0.0, route=True)
    tres = troot.map_batch(mk(T), 0.0, route=True)
    assert_same(rres, tres)
    assert any(r.hops > 0 for r in tres if r is not None)


def test_min_load_objective_and_commit_false_match():
    rtb, rroot, ttb, troot = roots(1, config=dict(objective="min_load"))
    rcfg = workload(Rwork, rtb, "mining", 1)
    tcfg = workload(Twork, ttb, "mining", 1)
    assert_same(rroot.map_batch(rcfg.tasks[:9], 0.0, route=True, commit=False),
                troot.map_batch(tcfg.tasks[:9], 0.0, route=True, commit=False))
    assert len(troot.ledger) == 0
    assert_same(rroot.map_batch(rcfg.tasks[:9], 0.0, route=True),
                troot.map_batch(tcfg.tasks[:9], 0.0, route=True))


def test_ledger_prune_remove_and_views():
    import torch
    _, _, ttb, troot = roots(1)
    tcfg = workload(Twork, ttb, "mining", 1)
    res = troot.map_batch(tcfg.tasks[:6], 0.0, route=True)
    led = troot.ledger
    assert len(led) == 6 and led._est.dtype == torch.float64
    comp = ttb.graph.compiled()
    view = led.live_view(comp)
    assert view.P.tolist() == [comp.pu_index[r.pu] for r in res] or \
        sorted(view.P.tolist()) == sorted(comp.pu_index[r.pu] for r in res)
    assert int(view.na.sum()) == 6
    led.remove(tcfg.tasks[0])
    assert len(led) == 5 and led.count(res[0].pu) == \
        sum(1 for r in res[1:] if r.pu == res[0].pu)
    assert led.retire([t.uid for t in tcfg.tasks[1:3]]) == 2
    led.prune(1e9)
    assert len(led) == 0
    for _ in range(40):      # growth by reallocation keeps rows intact
        led.add(tcfg.tasks[0], res[0].pu, res[0].prediction, 0.0)
    assert len(led) == 40 and led._est.shape[0] >= 40
    assert torch.isfinite(led._est[:40]).all()


def test_later_slices_are_refused_not_rerouted():
    _, _, ttb, _ = roots(None)
    g = ttb.graph
    t = T.make_task("svm", origin=ttb.edges[0])
    ff = T.build_orchestrators(g, T.heye_traverser(g),
                               config=T.OrcConfig(objective="first_fit"))
    with pytest.raises(NotImplementedError):
        ff.map_batch([t], 0.0, route=True)
    noisy = T.Traverser(g, slowdown=T.DecoupledSlowdown(
        g, T.truth_params(), rng=np.random.default_rng(0)))
    with pytest.raises(NotImplementedError):
        T.build_orchestrators(g, noisy).map_batch([t], 0.0, route=True)


@pytest.mark.parametrize("mult", [1, 2])
def test_entry_wave_is_one_batched_reduce_matching_reference(mult,
                                                            monkeypatch):
    """Each phase-1 wave's entry scans go to ONE ``scan_reduce_batch``
    call over every deduped walk (the reference's ``_entry_reduce_batch``);
    the batch gives the reference's placements, ``queries`` and ``hops``
    exactly and its overheads within 1e-9."""
    import repro_torch.core.orchestrator as Torc
    calls = []
    real = Torc.scan_reduce_batch

    def counted(*args):
        calls.append(len(args[6]))
        return real(*args)

    monkeypatch.setattr(Torc, "scan_reduce_batch", counted)
    rtb, rroot, ttb, troot = roots(mult)
    rcfg = workload(Rwork, rtb, "mining", mult)
    tcfg = workload(Twork, ttb, "mining", mult)
    times = sorted({t.release_time for t in rcfg})
    for now in times:
        rw = [t for t in rcfg if t.release_time == now and not rcfg.preds(t)]
        tw = [t for t in tcfg if t.release_time == now and not tcfg.preds(t)]
        if not tw:
            continue
        n_walks = len(troot._dedup_walks(tw, True)[1])
        before = len(calls)
        assert_same(rroot.map_batch(rw, now, route=True),
                    troot.map_batch(tw, now, route=True))
        assert calls[before:] == [n_walks]
    assert calls and max(calls) > 1


def test_entry_wave_concatenates_each_walks_plan_in_scan_order(
        monkeypatch):
    """The batched entry reduce concatenates the wave's plans on each
    call: every scan's node rows are its own plan's, at its offsets."""
    import repro_torch.core.orchestrator as Torc
    seen = []
    real = Torc.scan_reduce_batch

    def spy(ok, key, sa, f, cm, plan, scans, lqc):
        seen.append((plan, scans))
        return real(ok, key, sa, f, cm, plan, scans, lqc)

    monkeypatch.setattr(Torc, "scan_reduce_batch", spy)
    _, _, ttb, troot = roots(2)
    comp = ttb.graph.compiled()
    tcfg = workload(Twork, ttb, "mining", 2)
    now = min(t.release_time for t in tcfg)
    wave = [t for t in tcfg if t.release_time == now and not tcfg.preds(t)]
    _, order = troot._dedup_walks(wave, True)
    troot.map_batch(wave, now, route=True)
    plan, scans = seen[0]
    assert len(scans) == len(order)
    cols = [c.tolist() for c in plan.tensors()]
    pus = 0
    for w, (ok_off, P, node_off, Nn) in zip(order, scans):
        own = w.orc._scan_plan(comp)
        assert (ok_off, P, Nn) == (pus, len(own.pus), own.arrays.n)
        for col, row in zip(cols, own.rows):
            assert col[node_off:node_off + Nn] == list(row)
        pus += P
