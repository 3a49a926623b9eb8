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
from repro_torch.kernels.slowdown_kernel import pressure_term
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


# ---------------------------------------------------------------------------
# the fused factor forms: the pool (DES repricing) and the same-device check
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pair_inactive():
    """Both models with the l2 class switched off (beta 0)."""
    rtb, ttb = make_testbeds(None)
    rp, tp = R.heye_params(), T.heye_params()
    rp.beta["l2"] = tp.beta["l2"] = 0.0
    return (rtb, R.DecoupledSlowdown(rtb.graph, rp),
            ttb, T.DecoupledSlowdown(ttb.graph, tp))


def _pool_columns(rtb, n, seed, distinct):
    """A pool on a few PUs of the testbed (ties), uids distinct or with
    repeats."""
    rng = np.random.default_rng(seed)
    rc = rtb.graph.compiled()
    pus = rng.choice(len(rc.pu_names), min(len(rc.pu_names), n // 3 + 2),
                     replace=False)
    P = rng.choice(pus, n).astype(np.int64)
    U = rng.uniform(0.2, 1.5, n)
    mem = rng.uniform(0.05, 1.5, n)
    uid = (np.arange(n) if distinct else rng.integers(0, n // 2 + 1, n)
           ).astype(np.int64)
    return P, U, np.minimum(mem, rc.mem_cap[P]), uid


def _previous_pool_path(tsd, comp, P, U, M, uid, distinct):
    """The pool's pressures as the port built them before the pool form:
    masked mat-vecs per class around the row kernel's former plain
    version (a product over the class axis)."""
    n = P.shape[0]
    beta_vec, mt_vec = tsd._tables(comp)
    kappa = tsd.params.superlinear
    same_pu = P[:, None] == P[None, :]
    r = comp.ncr_rclass[P[:, None], P[None, :]]
    valid = ~same_pu & (r >= 0)
    if distinct:
        same_pu = same_pu & ~torch.eye(n, dtype=torch.bool)
    else:
        diff_uid = uid[:, None] != uid[None, :]
        same_pu = same_pu & diff_uid
        valid = valid & diff_uid
    mtp = same_pu.double() @ U
    X = torch.stack([(valid & (r == k)).double() @ M
                     for k in range(len(comp.rclass_names))], dim=1)
    mt_term = pressure_term(mt_vec[P], mtp, kappa) * U
    term = pressure_term(beta_vec[None, :], X, kappa)
    prod = torch.prod(1.0 + term * M[:, None], dim=-1)
    return torch.maximum((1.0 + mt_term) * prod, torch.ones_like(mt_term))


@pytest.mark.parametrize("distinct", [True, False])
@pytest.mark.parametrize("n", [2, 7, 8, 64])
def test_pool_form_matches_reference(pair_inactive, n, distinct):
    rtb, rsd, ttb, tsd = pair_inactive
    P, U, M, uid = _pool_columns(rtb, n, 500 + n, distinct)
    rc, tc = rtb.graph.compiled(), ttb.graph.compiled()
    want = rsd._factor_batch_arrays(rc, P, U, M, uid, distinct=distinct)
    args = [torch.as_tensor(a) for a in (P, U, M, uid)]
    got = tsd._factor_batch_arrays(tc, *args, distinct=distinct)
    close(got, want)
    assert len(set(P.tolist())) < n or n == 2       # PU ties
    if distinct:
        # the reference's scalar loop sums in the same order: to the bit
        assert got.tolist() == rsd._factor_small(rc, P, U, M).tolist()
    # against the port's previous path (masked mat-vecs; another order of
    # the tenancy sums and of the class product: a few ulps)
    prev = _previous_pool_path(tsd, tc, *args, distinct)
    np.testing.assert_allclose(got.numpy(), prev.numpy(), rtol=1e-14, atol=0)


@pytest.mark.parametrize("n", [2, 8, 64])
def test_factor_batch_idx_gathers_its_members(pair, n):
    """The DES's call: the whole job columns and the pool's rows give the
    factors of the gathered pool, on both sides of the small-pool path."""
    rtb, rsd, ttb, tsd = pair
    P, U, mem, _ = _pool_columns(rtb, 3 * n, 70 + n, True)
    uid = np.arange(3 * n, dtype=np.int64)
    m = np.random.default_rng(n).permutation(3 * n)[:n]
    cols = [torch.as_tensor(a) for a in (P, U, mem, uid)]
    got = tsd.factor_batch_idx(*cols, members=torch.as_tensor(m))
    assert torch.equal(got, tsd.factor_batch_idx(*(c[m] for c in cols)))
    close(got, rsd.factor_batch_idx(P[m], U[m], mem[m], uid[m]))


def _ledger_item(pkg, tb, pool, task, cand_devs, xp, device_view=None):
    """A same-device check's arguments over the live view of ``pool`` (or
    one device's view), candidates every PU of ``cand_devs``."""
    comp = tb.graph.compiled()
    led = pkg.ActiveLedger() if pkg is R else pkg.ActiveLedger(device="cpu")
    for i, (t, p) in enumerate(pool):
        led.add(t, p, pkg.TaskPrediction(0.01 * (i + 1), 1.0, 0.0), 0.0)
    view = (led.live_view(comp) if device_view is None
            else led.device_view(comp, device_view))
    cands = [p.name for d in cand_devs for p in tb.graph.pus(under=d)]
    Pc = xp([comp.pu_index[c] for c in cands])
    return comp, (task, Pc, comp.pu_dev_ord[Pc], view.P, view.upu, view.Ma,
                  view.uid, view.Da, view.astart, view.na)


SD_CASES = {
    # candidates on one device with actives, in the live view
    "single": (lambda e: [e[1]], None),
    # one device's own view
    "device_view": (lambda e: [e[1]], 1),
    # a device without actives: factors of 1, no pairs
    "empty": (lambda e: [e[4]], None),
    # several devices, one without actives (candidates with no pair)
    "multi": (lambda e: [e[0], e[4], e[2]], None),
}


@pytest.mark.parametrize("case", sorted(SD_CASES))
def test_same_device_form_matches_reference(pair_inactive, case):
    rtb, rsd, ttb, tsd = pair_inactive
    rng = np.random.default_rng(len(case))
    on = [rtb.edges[i] for i in (0, 1, 2)]
    pus = [p.name for d in on for p in rtb.graph.pus(under=d)]
    rp, tp = [], []
    for _ in range(14):
        kind = KINDS[int(rng.integers(len(KINDS)))]
        pu = pus[int(rng.integers(len(pus)))]
        rp.append((R.make_task(kind), pu))
        tp.append((T.make_task(kind), pu))
    # the newcomer shares a uid with no active, so pick one that does for
    # a dead pair: the port's tasks are numbered apart from the reference's
    devs, dv = SD_CASES[case]
    cand = devs(rtb.edges)
    dv = None if dv is None else rtb.edges[dv]
    rcomp, ritem = _ledger_item(R, rtb, rp, R.make_task("svm"), cand,
                                lambda a: np.asarray(a, dtype=np.int64), dv)
    tcomp, titem = _ledger_item(
        T, ttb, tp, T.make_task("svm"), cand,
        lambda a: torch.as_tensor(a, dtype=torch.int64), dv)
    want = rsd.factors_same_device_multi(rcomp, [ritem])[0]
    got = tsd.factors_same_device_multi(tcomp, [titem])[0]
    assert got[1].tolist() == list(want[1])
    assert got[2].tolist() == list(want[2])
    close(got[0], want[0])
    close(got[3], want[3])
    if case == "empty":
        assert got[0].tolist() == [1.0] * len(got[0]) and not len(got[1])
    if case == "multi":
        assert 0 < len(set(got[1].tolist())) < len(got[0])
    # against the port's previous path: the same sequential sums (the
    # pairs bit-equal), the class product in another order (a few ulps)
    prev = _previous_same_device(tsd, tcomp, titem)
    if prev is None:
        assert not len(got[1])
    else:
        assert got[1].tolist() == prev[1].tolist()
        np.testing.assert_allclose(got[0].numpy(), prev[0].numpy(),
                                   rtol=1e-14, atol=0)
        np.testing.assert_allclose(got[3].numpy(), prev[3].numpy(),
                                   rtol=1e-14, atol=0)
    # a second call of a single-device check is a cache hit, unchanged
    hits = tsd.factor_cache_hits
    again = tsd.factors_same_device_multi(tcomp, [titem])[0]
    if case in ("single", "device_view", "empty"):
        assert tsd.factor_cache_hits == hits + 1
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def _previous_same_device(tsd, comp, item):
    """The port's same-device path before the fused form: the pair rows
    built around the row kernel (``_same_device_rows`` then), summed by
    ``ordered_sums``, aggregated by the row kernel's former plain version
    (a product over the class axis).  None when there is no pair."""
    from repro_torch.kernels.slowdown_kernel import ordered_sums
    task, Pc, Dc, Pa, Ua, Ma, uid_a, Da, astart, na = item
    beta_vec, mt_vec = tsd._tables(comp)
    kappa = tsd.params.superlinear
    C, A, R = Pc.shape[0], Pa.shape[0], len(comp.rclass_names)
    u_new = task.usage.get("pu", 1.0)
    Mc = torch.clamp_max(comp.mem_cap[Pc], task.usage.get("mem", 1.0))
    _, single, s0, n0 = tsd._dev_summary(Dc, astart, na)

    def segment_pairs(left_ids, left_dev):
        rep = na[left_dev]
        K, width = int(rep.sum()), int(rep.max())
        if K == 0:
            return None
        li = torch.repeat_interleave(left_ids, rep, output_size=K)
        offs = torch.cumsum(rep, 0) - rep
        within = torch.arange(K) - torch.repeat_interleave(offs, rep,
                                                           output_size=K)
        ri = torch.repeat_interleave(astart[left_dev], rep,
                                     output_size=K) + within
        return li, ri, within, width

    def aggregate(x, mem, mt_term):
        term = pressure_term(beta_vec[None, :], x, kappa)
        prod = torch.prod(1.0 + term * mem[:, None], dim=-1)
        return torch.maximum((1.0 + mt_term) * prod, torch.ones_like(mt_term))

    pairs = segment_pairs(torch.arange(C), Dc)
    if pairs is None:
        return None
    ci, ai, within_c, width_c = pairs
    live = uid_a[ai] != task.uid
    Pci, Pai = Pc[ci], Pa[ai]
    same = (Pci == Pai) & live
    r_ca = comp.ncr_rclass[Pci, Pai].long()
    validc = live & (Pci != Pai) & (r_ca >= 0)
    zero_k = torch.zeros(ci.shape[0], dtype=torch.float64)
    col_c = torch.where(same, torch.full_like(r_ca, R), r_ca.clamp(min=0))
    val_c = torch.where(same, Ua[ai], torch.where(validc, Ma[ai], zero_k))
    acc_c = ordered_sums(ci, col_c, within_c, val_c, C, R + 1, width_c)
    mt_term_c = pressure_term(mt_vec[Pc], acc_c[:, R], kappa) * u_new
    if single:
        act_sel = torch.arange(s0, s0 + n0)
    else:
        act_sel = torch.nonzero(torch.isin(Da, Dc))[:, 0]
    a1, a2, within_a, width_a = segment_pairs(act_sel, Da[act_sel])
    diff = uid_a[a1] != uid_a[a2]
    sameP = (Pa[a1] == Pa[a2]) & diff
    r_aa = comp.ncr_rclass[Pa[a1], Pa[a2]].long()
    valida = diff & (Pa[a1] != Pa[a2]) & (r_aa >= 0)
    zero_a = torch.zeros(a1.shape[0], dtype=torch.float64)
    col_a = torch.where(sameP, torch.full_like(r_aa, R), r_aa.clamp(min=0))
    val_a = torch.where(sameP, Ua[a2], torch.where(valida, Ma[a2], zero_a))
    acc_a = ordered_sums(a1, col_a, within_a, val_a, A, R + 1, width_a)
    Xp = acc_a[:, :R][ai]
    r_ac = comp.ncr_rclass[Pai, Pci].long()
    jc = live & (Pai != Pci) & (r_ac >= 0)
    Xp.scatter_add_(1, r_ac.clamp(min=0)[:, None],
                    torch.where(jc, Mc[ci], zero_k)[:, None])
    mt_p = acc_a[:, R][ai] + same.double() * u_new
    mt_term_p = pressure_term(mt_vec[Pai], mt_p, kappa) * Ua[ai]
    return (aggregate(acc_c[:, :R], Mc, mt_term_c), ci, ai,
            aggregate(Xp, Ma[ai], mt_term_p))
