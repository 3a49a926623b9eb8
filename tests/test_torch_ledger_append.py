"""The ordered commit's in-place appends on the CPU: the ledger row that
``ActiveLedger.add`` writes through ``walk_kernel.ledger_append``, and the
device views that the walk context extends through
``walk_kernel.view_append`` into column buffers that double as they fill.

An extended view equals ``ActiveLedger.device_view`` column for column,
to the bit, across the buffers' moves; a view handed out never changes;
a kill, a prune or a touch makes the context gather the view again, and
the counters ``walk.view_appends`` / ``walk.view_gathers`` say which
happened.  The reference's ledger and ``_BatchContext._extend_view``
(``repro.core.orchestrator``), fed the same commits, give the same views
to the bit.  The card holds the kernels to these plain versions
(``tests/test_torch_kernels_card.py``)."""
import itertools
import math

import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.orchestrator as Rorc
import repro.core.task as Rtask
import repro.core.traverser as Rtrav
import repro_torch.core as T
import repro_torch.core.orchestrator as Torc
import repro_torch.core.task as Ttask
from repro_torch import spans
from repro_torch.core.task import Task
from repro_torch.core.traverser import TaskPrediction
from repro_torch.kernels import walk_kernel as wk

torch.set_num_threads(1)

VIEW = [c for c, _ in wk.VIEW_COLS] + ["na", "astart"]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape \
        and torch.equal(_bits(a), _bits(b))


FLEET = dict(edge_counts={"orin_agx": 2, "xavier_nx": 1},
             server_counts={"server1": 1})


def _wave(pkg, tb) -> list:
    """One task from the first edge and one from the server: walks that
    enter below both root children, so the wave is driven per group."""
    Rtask._task_counter = itertools.count(930_000)
    Ttask._task_counter = itertools.count(930_000)
    return [pkg.make_task("svm", origin=o, deadline=0.5)
            for o in (tb.edges[0], tb.servers[0])]


def _setup(split: bool = False, pkg=T, orc=Torc, **kw):
    """A small fleet's snapshot, a ledger and a walk context over it,
    built by the port (``T``) or the reference (``R``, with
    ``orc=Rorc``).  With ``split`` the ledger is the root's after a wave
    driven per root group (the port's one ledger, the reference's
    default sharded one) and the device is the first the wave left
    empty; else a fresh ledger and the first PU's device."""
    tb = pkg.build_testbed(**FLEET, **kw)
    g = tb.graph
    comp = g.compiled()
    if split:
        root = pkg.build_orchestrators(g, pkg.heye_traverser(g)).prepare(
            comp)
        assert len(root.children) == 2
        root.map_batch(_wave(pkg, tb), 0.0, route=True)
        led = root.ledger
        assert type(led) is (orc.ActiveLedger if pkg is T
                             else orc.ShardedLedger)
        assert all(o.ledger is led for o in root.iter_tree())
        full = led.occupied_devices(comp)
        assert len(full) == 2
        dev = next(d for d in comp.dev_ord_names if d not in full)
    else:
        led = orc.ActiveLedger(**kw)
        dev = comp.device_name(comp.pu_names[0])
    ctx = orc._BatchContext(g, comp, pkg.heye_traverser(g), led)
    pus = [p for p in comp.pu_names if comp.device_name(p) == dev]
    return comp, led, ctx, dev, pus


def _draw(rng) -> tuple[dict, tuple]:
    """One commit's task fields and prediction, drawn from ``rng``."""
    task = dict(kind="svm", deadline=(None if rng.random() < 0.3
                                      else float(rng.uniform(0.01, 0.2))),
                usage=({} if rng.random() < 0.2
                       else {"pu": float(rng.uniform(0.1, 1.0)),
                             "mem": float(rng.uniform(0.05, 2.0))}),
                release_time=float(rng.uniform(0.0, 0.1)))
    pred = (float(rng.uniform(1e-3, 0.05)), float(rng.uniform(1.0, 3.0)),
            float(rng.uniform(0.0, 1e-3)))
    return task, pred


def _commit(led, rng, pu: str, now: float = 0.0) -> tuple:
    task, pred = _draw(rng)
    t, pred = Task(**task), TaskPrediction(*pred)
    led.add(t, pu, pred, now)
    return t, pred


def _assert_view(v, want) -> None:
    for c in VIEW:
        assert _same(getattr(v, c), getattr(want, c)), c
    assert v.rows == want.rows and v.pu_names == want.pu_names
    assert v.tasks == want.tasks


def _assert_reference_view(v, rv, led, rled) -> None:
    """The port's view ``v`` equals the reference's ``rv`` to the bit;
    their rows are the same tasks' rows of ``led`` and ``rled`` (the
    reference's ledger, or the shard of it that holds the device)."""
    for c in VIEW:
        want = np.asarray(getattr(rv, c))
        got = getattr(v, c).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, c
        if want.dtype == np.float64:
            got, want = got.view(np.int64), want.view(np.int64)
        assert np.array_equal(got, want), c
    assert [led._tasks[i].uid for i in v.rows] == \
        [rled._tasks[i].uid for i in rv.rows]
    assert v.pu_names == rv.pu_names
    assert [t.uid for t in v.tasks] == [t.uid for t in rv.tasks]


@pytest.mark.parametrize("sharded", [False, True])
def test_appended_views_equal_the_gathered_view(sharded):
    """Forty commits on one device, each followed by the next re-walk's
    view: every view is an append (the buffers move at 16 and 34 rows),
    equal to the ledger's gathered view and to the view the reference's
    ``_extend_view`` builds from the same commits, to the bit, and none
    of the views handed out changes afterwards.  ``sharded``: the
    ledgers are a split root's after a wave driven per group, the port's
    one ledger against the reference's default sharded one."""
    comp, led, ctx, dev, pus = _setup(sharded, device="cpu")
    _, rled, rctx, rdev, rpus = _setup(sharded, R, Rorc)
    assert (rdev, rpus) == (dev, pus)
    rshard = rled.shard_for(dev) if sharded else rled
    rng = np.random.default_rng(5)
    kept = []
    with spans.record() as rec:
        ctx.view(dev)
        rctx.view(dev)
        for k in range(40):
            task, pred = _draw(rng)
            uid = 10_000 + k
            pu = pus[k % len(pus)]
            led.add(Task(**task, uid=uid), pu, TaskPrediction(*pred), 0.0)
            rled.add(Rtask.Task(**task, uid=uid), pu,
                     Rtrav.TaskPrediction(*pred), 0.0)
            v = ctx.view(dev)
            assert ctx.view(dev) is v            # unchanged version: a hit
            _assert_view(v, led.device_view(comp, dev))
            _assert_reference_view(v, rctx.view(dev), led, rshard)
            if not sharded:                  # one ledger each: one numbering
                assert v.rows == list(rctx.view(dev).rows)
            kept.append((v, {c: getattr(v, c).clone() for c in VIEW}))
    counters = rec.summary()["counters"]
    assert counters["walk.view_appends"] == 40
    assert counters["walk.view_gathers"] == 1
    assert ctx._vbufs[dev].cols.n == 70
    first, last = kept[0][0].est, kept[-1][0].est
    assert first.untyped_storage().data_ptr() \
        != last.untyped_storage().data_ptr()
    for v, cols in kept:
        for c, want in cols.items():
            assert _same(getattr(v, c), want), c


@pytest.mark.parametrize("how", ["prune", "remove", "touch"])
def test_a_kill_or_touch_gathers_the_view_again(how):
    """After a prune, a removal or a touch of the device the context
    gathers the view (``walk.view_gathers`` rises, ``walk.view_appends``
    does not); the commit after it is an append again, out of the
    gathered view, into new buffers."""
    comp, led, ctx, dev, pus = _setup(device="cpu")
    rng = np.random.default_rng(11)
    tasks = [_commit(led, rng, pus[k % len(pus)])[0] for k in range(6)]
    ctx.view(dev)
    for k in range(3):
        tasks.append(_commit(led, rng, pus[k % len(pus)])[0])
        ctx.view(dev)
    before = ctx.view(dev)
    buf = ctx._vbufs[dev]
    with spans.record() as rec:
        if how == "prune":
            # the first row's estimated finish is its prediction's total
            led.prune(float(led._est[0]))
        elif how == "remove":
            led.remove(tasks[4])
        else:
            led.touch(dev)
        v = ctx.view(dev)
    counters = rec.summary()["counters"]
    assert counters["walk.view_gathers"] == 1
    assert counters.get("walk.view_appends", 0) == 0
    assert v is not before and ctx._vbufs[dev] is buf
    want = led.device_view(comp, dev)
    _assert_view(v, want)
    if how != "touch":
        assert len(v) < len(before)
    with spans.record() as rec:
        _commit(led, rng, pus[0])
        w = ctx.view(dev)
    assert rec.summary()["counters"]["walk.view_appends"] == 1
    assert ctx._vbufs[dev] is not buf and ctx._vbufs[dev].head is w
    _assert_view(w, led.device_view(comp, dev))


def test_the_ledger_row_is_the_eight_scalar_writes():
    """``add`` writes through ``ledger_append``: the columns equal what
    eight scalar writes of the row's host values give, row for row and to
    the bit, across the columns' growth; a PU the compiled index has not
    met yet gets -1; the host mirrors follow."""
    comp, led, _, dev, pus = _setup(device="cpu")
    rng = np.random.default_rng(3)
    n = 40
    want = {c: torch.zeros(n, dtype=t) for c, t in wk.LEDGER_COLS}
    for i in range(n):
        if i == 5:
            # rows added before the index was filled carry -1 until the
            # fill rewrites them
            assert _same(led._pu_idx[:5], want["pu_idx"][:5])
            led._fill_pu_idx(comp)
            want["pu_idx"][:5] = torch.tensor(
                [comp.pu_index[pus[k % len(pus)]] for k in range(5)])
        now = float(rng.uniform(0.0, 0.1))
        pu = pus[i % len(pus)]
        t, pred = _commit(led, rng, pu, now)
        want["est"][i] = now + pred.total
        want["fac"][i] = pred.factor
        want["dl"][i] = t.deadline if t.deadline is not None else math.inf
        want["upu"][i] = t.usage.get("pu", 1.0)
        want["umem"][i] = t.usage.get("mem", 1.0)
        want["uid"][i] = t.uid
        want["pu_idx"][i] = comp.pu_index[pu] if i >= 5 else -1
        want["live"][i] = True
    for c, _ in wk.LEDGER_COLS:
        assert _same(getattr(led, "_" + c)[:n], want[c]), c
    assert led._live_l == [True] * n and len(led) == n
    assert sum(led._count.values()) == n
    assert led.dev_version[dev] == n and led.mut_log == [dev] * n


def _ledger_cols_are_its_columns(led) -> None:
    for (name, _), col in zip(wk.LEDGER_COLS, led._cols.cols):
        assert col is getattr(led, "_" + name), name


@pytest.mark.parametrize("how", ["grow", "compact", "from_numpy"])
def test_every_column_swap_rebuilds_the_kernels_column_set(how):
    """The set the append kernels write through (``_cols``) holds the
    ledger's own columns after every swap of them: a growth, a
    compaction, a ledger loaded from host arrays; the next add lands in
    the columns the ledger reads."""
    comp, led, _, dev, pus = _setup(device="cpu")
    rng = np.random.default_rng(7)
    tasks = [_commit(led, rng, pus[k % len(pus)])[0] for k in range(40)]
    if how == "compact":
        for t in tasks[:36]:
            led.remove(t)
        assert led._n < 40              # compacted
    elif how == "from_numpy":
        from repro_torch.interop import ledger_from_numpy
        n = led._n
        led = ledger_from_numpy(dict(
            tasks=led._tasks, pus=led._pus,
            **{c: getattr(led, "_" + c)[:n].numpy().copy()
               for c in ("est", "fac", "dl", "upu", "umem", "uid")}),
            "cpu", comp)
    _ledger_cols_are_its_columns(led)
    led._fill_pu_idx(comp)
    t, _ = _commit(led, rng, pus[0])
    _ledger_cols_are_its_columns(led)
    i = led._n - 1
    assert int(led._uid[i]) == t.uid and bool(led._live[i])
    assert int(led._pu_idx[i]) == comp.pu_index[pus[0]]


def test_the_wrappers_refuse_what_the_kernels_do_not_take():
    cols = [torch.zeros(4, dtype=t) for _, t in wk.LEDGER_COLS]
    with pytest.raises(TypeError):         # a column of another type
        wk.Columns(wk.LEDGER_COLS, cols[:7] + [torch.zeros(4)])
    with pytest.raises(ValueError):        # columns of two lengths
        wk.Columns(wk.LEDGER_COLS, cols[:7] + [torch.zeros(5, dtype=bool)])
    led = wk.Columns(wk.LEDGER_COLS, cols)
    row = (1.0, 1.0, 1.0, 1.0, 1.0, 7, 2)
    with pytest.raises(IndexError):
        wk.ledger_append(led, 4, row)
    wk.ledger_append(led, 3, row)
    assert cols[7].tolist() == [False, False, False, True]
    dst = wk.Columns(wk.VIEW_COLS,
                     [torch.zeros(4, dtype=t) for _, t in wk.VIEW_COLS])
    with pytest.raises(ValueError):        # the columns swapped
        wk.ledger_append(dst, 0, row)
    na = torch.zeros(3, dtype=torch.int64)
    mem_cap = torch.ones(2, dtype=torch.float64)
    args = (led, 0, mem_cap, 1)
    with pytest.raises(ValueError):        # a copy past the written slot
        wk.view_append(dst, dst.cols, 3, *args, 2, 0.0, 0, na, na.clone(),
                       0)
    with pytest.raises(IndexError):        # the slot past the buffers
        wk.view_append(dst, None, 0, *args, 4, 0.0, 0, na, na.clone(), 0)
    with pytest.raises(IndexError):        # mem_cap has no entry pidx
        wk.view_append(dst, None, 0, led, 0, mem_cap, 2, 1, 0.0, 0, na,
                       na.clone(), 0)
    with pytest.raises(ValueError):        # an ordinal outside na
        wk.view_append(dst, None, 0, *args, 1, 0.0, 0, na, na.clone(), 3)
    out = torch.empty_like(na)
    wk.view_append(dst, None, 0, *args, 3, 0.5, 2, na, out, -1)
    assert out.tolist() == [0, 0, 0] and dst.cols[9][3].item() == 2
    assert dst.cols[8][3].item() == 0.5
    assert dst.cols[6][3].item() == 0.0    # min(umem[0], mem_cap[1])
