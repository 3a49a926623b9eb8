"""DecoupledSlowdown of the port against the reference's on equal pools
(built from a numpy seed): ``factor``, ``factor_batch``,
``factor_batch_idx`` across the 2 / <=7 / >7 pool boundaries,
``slowdown_matrix``, ``factors_with_candidates`` and the block-diagonal
``factors_same_device(_multi)``.  Tolerance 1e-9 relative."""
import numpy as np
import pytest
import torch

import jax  # noqa: F401

import repro.core as R
import repro_torch.core as T
from torch_port_util import TOL, make_testbeds

KINDS = ("svm", "knn", "mlp", "render", "encode", "pose_pred")


@pytest.fixture(scope="module")
def pair():
    rtb, ttb = make_testbeds(None)
    return (rtb, R.DecoupledSlowdown(rtb.graph, R.heye_params()),
            ttb, T.DecoupledSlowdown(ttb.graph, T.heye_params()))


def pools(rtb, ttb, n, seed, one_device=False):
    """The same pool of (task, pu) pairs in both packages."""
    rng = np.random.default_rng(seed)
    pus = [p.name for p in rtb.graph.pus()]
    if one_device:
        dev = rtb.edges[int(rng.integers(len(rtb.edges)))]
        pus = [p.name for p in rtb.graph.pus(under=dev)]
    rp, tp = [], []
    for _ in range(n):
        kind = KINDS[int(rng.integers(len(KINDS)))]
        pu = pus[int(rng.integers(len(pus)))]
        rp.append((R.make_task(kind), pu))
        tp.append((T.make_task(kind), pu))
    return rp, tp


def close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=0)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 20])
@pytest.mark.parametrize("one_device", [False, True])
def test_factor_batch_matches_reference(pair, n, one_device):
    rtb, rsd, ttb, tsd = pair
    rp, tp = pools(rtb, ttb, n, 10 * n + one_device, one_device)
    want = rsd.factor_batch(rp)
    got = tsd.factor_batch(tp)
    assert got.dtype == torch.float64
    close(got, want)
    # the scalar model agrees per entry as well
    for (t, p), w in zip(tp, want):
        assert tsd.factor(t, p, tp) == pytest.approx(w, rel=TOL)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 20])
def test_factor_batch_idx_across_pool_boundaries(pair, n):
    rtb, rsd, ttb, tsd = pair
    rp, tp = pools(rtb, ttb, n, 77 + n, one_device=True)
    rc, tc = rtb.graph.compiled(), ttb.graph.compiled()
    P = np.array([rc.pu_index[p] for _, p in rp], dtype=np.int64)
    U = np.array([t.usage.get("pu", 1.0) for t, _ in rp])
    mem = np.array([t.usage.get("mem", 1.0) for t, _ in rp])
    uid = np.arange(n, dtype=np.int64)
    want = rsd.factor_batch_idx(P, U, mem, uid)
    args = [torch.as_tensor(a) for a in (P, U, mem, uid)]
    got = tsd.factor_batch_idx(*args)
    close(got, want)
    if n >= 2:
        # the array path + kernel (what tensors on the card always take)
        # agrees with the scalar path the CPU takes for small pools
        M = torch.minimum(args[2], tc.mem_cap[args[0]])
        arr = tsd._factor_batch_arrays(tc, args[0], args[1], M, args[3],
                                       distinct=True)
        close(arr, want)
        close(tsd._factor_small(tc, args[0], args[1], M), want)


@pytest.mark.parametrize("n", [2, 9])
def test_slowdown_matrix_matches_reference(pair, n):
    rtb, rsd, ttb, tsd = pair
    rp, tp = pools(rtb, ttb, n, 5 + n, one_device=True)
    close(tsd.slowdown_matrix(tp), rsd.slowdown_matrix(rp))


@pytest.mark.parametrize("n_active", [0, 1, 5, 12])
def test_factors_with_candidates_matches_reference(pair, n_active):
    rtb, rsd, ttb, tsd = pair
    rp, tp = pools(rtb, ttb, n_active, 300 + n_active, one_device=True)
    dev = rtb.edges[0] if not rp else rtb.graph.device_of(rp[0][1]).name
    cands = [p.name for p in rtb.graph.pus(under=dev)]
    want_n, want_a = rsd.factors_with_candidates(R.make_task("knn"), cands, rp)
    got_n, got_a = tsd.factors_with_candidates(T.make_task("knn"), cands, tp)
    close(got_n, want_n)
    close(got_a, want_a)


def _same_device_args(pkg, tb, sd, pool, task, xp):
    comp = tb.graph.compiled()
    led = pkg.ActiveLedger() if pkg is R else pkg.ActiveLedger(device="cpu")
    for i, (t, p) in enumerate(pool):
        led.add(t, p, pkg.TaskPrediction(0.01 * (i + 1), 1.0, 0.0), 0.0)
    view = led.live_view(comp)
    cands = [p.name for p in tb.graph.pus()
             if tb.graph.device_of(p.name).name in tb.edges[:3]]
    Pc = xp([comp.pu_index[c] for c in cands])
    Dc = comp.pu_dev_ord[Pc]
    return comp, (task, Pc, Dc, view.P, view.upu, view.Ma, view.uid, view.Da,
                  view.astart, view.na)


@pytest.mark.parametrize("n_active", [0, 3, 15])
def test_factors_same_device_multi_matches_reference(pair, n_active):
    rtb, rsd, ttb, tsd = pair
    rng = np.random.default_rng(n_active)
    pus = [p.name for p in rtb.graph.pus()
           if rtb.graph.device_of(p.name).name in rtb.edges[:3]]
    rp, tp = [], []
    for _ in range(n_active):
        kind = KINDS[int(rng.integers(len(KINDS)))]
        pu = pus[int(rng.integers(len(pus)))]
        rp.append((R.make_task(kind), pu))
        tp.append((T.make_task(kind), pu))
    rcomp, ritem = _same_device_args(
        R, rtb, rsd, rp, R.make_task("svm"),
        lambda a: np.asarray(a, dtype=np.int64))
    tcomp, titem = _same_device_args(
        T, ttb, tsd, tp, T.make_task("svm"),
        lambda a: torch.as_tensor(a, dtype=torch.int64))
    want = rsd.factors_same_device_multi(rcomp, [ritem, ritem])
    got = tsd.factors_same_device_multi(tcomp, [titem, titem])
    for (wn, wci, wai, wpf), (gn, gci, gai, gpf) in zip(want, got):
        close(gn, wn)
        assert gci.tolist() == list(wci) and gai.tolist() == list(wai)
        close(gpf, wpf)
    one = tsd.factors_same_device(tcomp, *titem)
    close(one[0], want[0][0])
    close(one[3], want[0][3])


def test_noisy_model_draws_the_reference_stream(pair):
    rtb, _, ttb, _ = pair
    rp, tp = pools(rtb, ttb, 6, 9, one_device=True)
    rsd = R.DecoupledSlowdown(rtb.graph, R.truth_params(),
                              rng=np.random.default_rng(3))
    tsd = T.DecoupledSlowdown(ttb.graph, T.truth_params(),
                              rng=np.random.default_rng(3))
    close(tsd.factor_batch(tp), rsd.factor_batch(rp))


def test_no_slowdown_is_all_ones(pair):
    _, _, ttb, _ = pair
    ns = T.NoSlowdown(ttb.graph)
    assert ns.factor_batch([1, 2, 3]).tolist() == [1.0, 1.0, 1.0]
    assert ns.slowdown_matrix([1, 2]).shape == (2, 2)
