"""The port's DES engine: mining and VR finish times against the
reference package's ``traverse`` and against the port's own
``traverse_reference`` event loop, with and without work noise drawn from
the same numpy generator.  Tolerance 1e-9 absolute (seconds)."""
import numpy as np
import pytest

import jax  # noqa: F401

import repro.core as R
import repro.core.workloads as Rwork
import repro_torch.core as T
import repro_torch.core.workloads as Twork
from torch_port_util import TOL, in_order, make_testbeds, workload

CASES = [("mining", 1), ("mining", 2), ("vr", None)]


def mapped_pair(kind, mult):
    """Equal workloads in both packages with one mapping (the reference
    session's), keyed per package by its own uids."""
    rtb, ttb = make_testbeds(mult)
    rcfg = workload(Rwork, rtb, kind, mult)
    tcfg = workload(Twork, ttb, kind, mult)
    root = R.build_orchestrators(rtb.graph, R.heye_traverser(rtb.graph))
    sess = R.SchedulerSession(rtb.graph, root, charge_overhead=False)
    sess.submit(rcfg)
    sess.map_pending()
    rmap = dict(sess.mapping)
    tmap = {t.uid: rmap[r.uid] for r, t in zip(rcfg, tcfg)}
    return rtb, rcfg, rmap, ttb, tcfg, tmap


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def case(request):
    return mapped_pair(*request.param)


def travs(rtb, ttb, noise, seed=11):
    if not noise:
        return R.heye_traverser(rtb.graph), T.heye_traverser(ttb.graph)
    return (R.ground_truth_traverser(rtb.graph, seed=seed),
            T.ground_truth_traverser(ttb.graph,
                                     rng=np.random.default_rng(seed)))


def diff(a, b):
    return max(abs(x - y) for x, y in zip(a, b))


@pytest.mark.parametrize("noise", [False, True], ids=["quiet", "noisy"])
def test_fused_engine_matches_reference_package(case, noise):
    rtb, rcfg, rmap, ttb, tcfg, tmap = case
    rt, tt = travs(rtb, ttb, noise)
    want = rt.traverse(rcfg, rmap)
    got = tt.traverse(tcfg, tmap)
    for col in ("finish", "start", "ready", "comm", "queue_wait",
                "standalone"):
        assert diff(in_order(getattr(got, col), tcfg),
                    in_order(getattr(want, col), rcfg)) <= TOL, col
    assert got.n_intervals == want.n_intervals
    assert got.n_events == want.n_events


@pytest.mark.parametrize("noise", [False, True], ids=["quiet", "noisy"])
def test_fused_engine_matches_own_reference_loop(case, noise):
    _, _, _, ttb, tcfg, tmap = case
    _, fused = travs(make_testbeds(None)[0], ttb, noise)
    _, seed_loop = travs(make_testbeds(None)[0], ttb, noise)
    got = fused.traverse(tcfg, tmap)
    want = seed_loop.traverse_reference(tcfg, tmap)
    assert diff(in_order(got.finish, tcfg), in_order(want.finish, tcfg)) <= TOL
    assert got.makespan == pytest.approx(want.makespan, abs=TOL)


def test_reference_loop_matches_reference_package(case):
    rtb, rcfg, rmap, ttb, tcfg, tmap = case
    rt, tt = travs(rtb, ttb, True)
    want = rt.traverse_reference(rcfg, rmap)
    got = tt.traverse_reference(tcfg, tmap)
    assert diff(in_order(got.finish, tcfg), in_order(want.finish, rcfg)) <= TOL


def test_background_jobs_match(case):
    rtb, rcfg, rmap, ttb, tcfg, tmap = case
    pu = rtb.graph.pus(under=rtb.edges[0])[0].name
    rbg = [(R.make_task("knn"), pu, 0.05)]
    tbg = [(T.make_task("knn"), pu, 0.05)]
    want = R.heye_traverser(rtb.graph).traverse(rcfg, rmap, background=rbg)
    got = T.heye_traverser(ttb.graph).traverse(tcfg, tmap, background=tbg)
    assert diff(in_order(got.finish, tcfg), in_order(want.finish, rcfg)) <= TOL
    assert got.finish[tbg[0][0].uid] == pytest.approx(
        want.finish[rbg[0][0].uid], abs=TOL)


def test_engine_columns_live_on_the_traverser_device(case):
    import torch
    from repro_torch.core.timeline import TimelineEngine
    _, _, _, ttb, tcfg, tmap = case
    eng = TimelineEngine(T.heye_traverser(ttb.graph), tcfg, tmap)
    tl = eng.run()
    for col in ("W", "rate", "t_last", "eta", "xW", "xeta"):
        c = getattr(eng, col)
        assert c.dtype == torch.float64 and c.device == ttb.graph.device
    assert eng.xe_flat.dtype == torch.int64
    assert len(tl.finish) == len(tcfg)
    assert bool(torch.isinf(eng.eta).all())      # every slot retired


def test_interventions_wait_for_a_later_slice(case):
    _, _, _, ttb, tcfg, tmap = case
    with pytest.raises(NotImplementedError):
        T.heye_traverser(ttb.graph).traverse(
            tcfg, tmap, interventions=[(0.01, lambda: None)])
    with pytest.raises(ValueError):
        T.heye_traverser(ttb.graph).traverse(tcfg, tmap, engine="nope")


def test_fused_settle_sites_take_distinct_slots_and_match_reference(
        case, monkeypatch):
    """The DES's two compute settle sites go through the fused in-place
    forms; every call hands them distinct slots (on the card one thread
    writes each slot), and the finish times are the reference's."""
    from repro_torch.kernels import timeline_kernel as tk
    seen = {"settle_reprice": 0, "settle_complete": 0}

    def distinct(name, pos):
        real = getattr(tk, name)

        def wrapped(*args):
            idx = args[pos].tolist()
            assert len(set(idx)) == len(idx), f"{name}: repeated slot"
            seen[name] += 1
            return real(*args)
        monkeypatch.setattr(tk, name, wrapped)

    distinct("settle_reprice", 5)
    distinct("settle_complete", 4)
    rtb, rcfg, rmap, ttb, tcfg, tmap = case
    rt, tt = travs(rtb, ttb, True)
    want = rt.traverse(rcfg, rmap)
    got = tt.traverse(tcfg, tmap)
    assert diff(in_order(got.finish, tcfg), in_order(want.finish, rcfg)) \
        <= TOL
    assert seen["settle_reprice"] > 0 and seen["settle_complete"] > 0
