"""The port's scheduler kernels: each plain PyTorch version (what a
wrapper runs for a CPU tensor) against the reference's numpy oracle on the
same seeded inputs, and against the reference's Pallas kernel in
interpret mode at float32 tolerance; the fused settle forms against the
unfused op sequence they replace, bit for bit.  Tolerances: decisions
(winner / queries / hops, gathered columns, inf and zero patterns) exact;
floats 1e-12 relative against the float64 oracles; 2e-5 against the
float32 Pallas kernels.  The CUDA kernels themselves are held against
these plain versions on the card by ``chip_smoke.py``."""
import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the reference's kernels need it; CPU backend)

from repro.kernels import ref
from repro.kernels import slowdown_kernel as ref_sk
from repro.kernels import timeline_kernel as ref_tk
from repro.kernels import walk_kernel as ref_wk
from repro.kernels.walk_kernel import scan_reduce_ref
from repro_torch.kernels import slowdown_kernel as sk
from repro_torch.kernels import timeline_kernel as tk
from repro_torch.kernels import walk_kernel as wk

import rewalk_cases

F64_RTOL = 1e-12

torch.set_num_threads(1)   # tiny tensors; keep pytest workers off each other


def t(a, dtype=None):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)


# ---------------------------------------------------------------------------
# B1 slowdown factors
# ---------------------------------------------------------------------------
def _factor_inputs(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 3.0, (n, 6))
    x[rng.random((n, 6)) < 0.5] = 0.0
    beta = np.array([0.0884, 0.1330, 0.1107, 0.1786, 0.4196, 0.0])
    mem = rng.uniform(0.05, 1.0, n)
    mt = rng.uniform(0.0, 2.0, n)
    mt[rng.random(n) < 0.5] = 0.0
    return x, beta, mem, mt


@pytest.mark.parametrize("n", [1, 3, 16, 300])
def test_slowdown_factors_matches_oracle(n):
    x, beta, mem, mt = _factor_inputs(n, n)
    want = ref.slowdown_factors_ref(x, beta, mem, mt, 0.12)
    got = sk.slowdown_factors(t(x), t(beta), t(mem), t(mt), 0.12).numpy()
    np.testing.assert_allclose(got, want, rtol=F64_RTOL, atol=0)
    assert (got >= 1.0).all()


@pytest.mark.parametrize("n", [7, 300])
def test_slowdown_factors_matches_pallas_interpret(n):
    x, beta, mem, mt = _factor_inputs(n, 100 + n)
    got = sk.slowdown_factors_plain(t(x), t(beta), t(mem), t(mt), 0.12)
    pal = np.asarray(ref_sk.slowdown_factors_pallas(x, beta, mem, mt, 0.12,
                                                    interpret=True))
    np.testing.assert_allclose(got.numpy(), pal, rtol=2e-5)


def test_slowdown_factors_inactive_rows_are_one():
    x = np.zeros((4, 6))
    out = sk.slowdown_factors(t(x), t(np.full(6, 0.3)), t(np.ones(4)),
                              t(np.zeros(4)), 0.12)
    assert out.tolist() == [1.0] * 4


# ---------------------------------------------------------------------------
# B1's fused forms: the pool (DES repricing) and the same-device checks
# ---------------------------------------------------------------------------
KAPPA = 0.12
BETA6 = np.array([0.0884, 0.1330, 0.1107, 0.0, 0.4196, 0.2679])  # one off


def _beta(R):
    """BETA6, or for another class count R betas drawn from R, a few of
    them inactive."""
    if R == 6:
        return BETA6
    b = np.random.default_rng(R).uniform(0.05, 0.45, R)
    b[::7] = 0.0
    return b


def _tables(rng, n_pus=24, R=6):
    """Snapshot tables: ncr_rclass (-1..R-1, int16), mem_cap (inf or a
    cap), mt_vec, beta (class 3 inactive at R=6)."""
    ncr = rng.integers(-1, R, (n_pus, n_pus)).astype(np.int16)
    cap = np.where(rng.random(n_pus) < 0.3, 0.3, np.inf)
    return (t(ncr), t(cap), t(rng.uniform(0.2, 0.5, n_pus)), t(_beta(R)))


def _scalar_factor(x: dict, mt: float, m: float, u: float, b_mt: float,
                   beta=BETA6):
    """One factor as the reference's scalar loop rounds it (classes in
    ascending order, inactive ones skipped)."""
    mt_term = 0.0
    if mt > 0.0 and b_mt > 0.0:
        mt_term = b_mt * mt * (1.0 + KAPPA * mt) * u
    prod = 1.0
    for r in sorted(x):
        b = beta[r]
        if x[r] > 0.0 and b > 0.0:
            prod *= 1.0 + b * x[r] * (1.0 + KAPPA * x[r]) * m
    f = (1.0 + mt_term) * prod
    return f if f > 1.0 or f != f else 1.0


def _pool_inputs(n, seed, distinct, R=6):
    rng = np.random.default_rng(seed)
    ncr, cap, mt_vec, beta = _tables(rng, R=R)
    rows = 3 * n + 4
    pu_i = rng.integers(0, 24, rows) if n > 8 else rng.integers(0, 4, rows)
    U = rng.uniform(0.2, 1.5, rows)
    memraw = rng.uniform(0.05, 1.5, rows)
    uid = np.arange(rows) if distinct else rng.integers(0, n // 2 + 1, rows)
    members = rng.permutation(rows)[:n]
    return (t(members), t(pu_i), t(U), t(memraw), t(uid), cap, ncr, mt_vec,
            beta, KAPPA, distinct)


def _scalar_pool(args, n, distinct):
    """The pool's factors as the reference's scalar loop sums them."""
    members, pu_i, U, memraw, uid, cap, ncr, mt_vec, beta = (
        a.numpy() for a in args[:9])
    P = pu_i[members]
    M = np.minimum(memraw[members], cap[P])
    want = []
    for i in range(n):
        x: dict = {}
        mt = 0.0
        for j in range(n):
            if (j == i) if distinct else (uid[members[j]] == uid[members[i]]):
                continue
            if P[j] == P[i]:
                mt += U[members[j]]
            elif ncr[P[i], P[j]] >= 0:
                r = int(ncr[P[i], P[j]])
                x[r] = x.get(r, 0.0) + M[j]
        want.append(_scalar_factor(x, mt, M[i], U[members[i]], mt_vec[P[i]],
                                   beta))
    return want


@pytest.mark.parametrize("distinct", [True, False])
@pytest.mark.parametrize("n", [1, 2, 7, 8, 64])
def test_slowdown_pool_is_the_sequential_scalar_loop(n, distinct):
    args = _pool_inputs(n, 40 + n, distinct)
    got = sk.slowdown_pool(*args)
    assert got.dtype == torch.float64 and got.tolist() == _scalar_pool(
        args, n, distinct)
    P = args[1].numpy()[args[0].numpy()]
    assert n < 8 or len(set(P.tolist())) < n        # PU ties exercised


def _view(rng, A, nd, per_dev=4, empty=(1,)):
    """A device-sorted ledger view of A actives over nd devices of per_dev
    PUs (the ``empty`` devices hold none)."""
    devs = np.delete(np.arange(nd), list(empty))
    Da = np.sort(rng.choice(devs, A))
    Pa = Da * per_dev + rng.integers(0, per_dev, A)
    na = np.bincount(Da, minlength=nd)
    return [t(Pa), t(rng.uniform(0.2, 1.5, A)), t(rng.uniform(0.05, 1.0, A)),
            t(np.arange(10, 10 + A)), t(Da), t(np.cumsum(na) - na), t(na)]


def _sd_item(view, devs, uid_new, per_dev=4):
    """The newcomer whose candidates are every PU of ``devs``."""
    Pc = np.concatenate([d * per_dev + np.arange(per_dev) for d in devs])
    na, st = view[6].numpy(), view[5].numpy()
    single = len(set(devs)) == 1
    return sk.SameDeviceItem(t(Pc), t(Pc // per_dev), 1.0, 0.6, uid_new,
                             *view, (int(devs[0]), single, int(st[devs[0]]),
                                     int(na[devs[0]])))


def _sd_items(seed, A=12, nd=6):
    """A ragged stack over one view: a single-device item (a dead pair:
    the newcomer's uid is an active's), an empty device, several devices
    with an empty one among them, every device; and one over a view of
    its own."""
    rng = np.random.default_rng(seed)
    view = _view(rng, A, nd)
    busy = int(view[4][A // 2])
    items = [_sd_item(view, [busy], 10 + A // 2),
             _sd_item(view, [1], 99),
             _sd_item(view, [0, 1, busy], 99),
             _sd_item(view, list(range(nd)), 10)]
    items.append(_sd_item(_view(rng, 5, 2), [0], 99))
    return items


def _scalar_same_device(it, tables):
    """Per item, the reference's loops written out: candidates in order,
    each against its device segment in ledger order."""
    ncr, cap, mt_vec, beta = (a.numpy() for a in tables)
    Pc, Dc, Pa, Ua, Ma, uid_a, Da, astart, na = (
        getattr(it, k).numpy() for k in ("Pc", "Dc", "Pa", "Ua", "Ma",
                                         "uid_a", "Da", "astart", "na"))

    def seg(d):
        return range(astart[d], astart[d] + na[d])

    def base(a):
        x: dict = {}
        mt = 0.0
        for a2 in seg(Da[a]):
            if uid_a[a2] == uid_a[a]:
                continue
            if Pa[a2] == Pa[a]:
                mt += Ua[a2]
            elif ncr[Pa[a], Pa[a2]] >= 0:
                r = int(ncr[Pa[a], Pa[a2]])
                x[r] = x.get(r, 0.0) + Ma[a2]
        return x, mt
    new_f, ci, ai, act = [], [], [], []
    for c in range(len(Pc)):
        mc = min(cap[Pc[c]], it.mem_new)
        x: dict = {}
        mt = 0.0
        for a in seg(Dc[c]):
            if uid_a[a] == it.uid_new:
                continue
            if Pa[a] == Pc[c]:
                mt += Ua[a]
            elif ncr[Pc[c], Pa[a]] >= 0:
                r = int(ncr[Pc[c], Pa[a]])
                x[r] = x.get(r, 0.0) + Ma[a]
        new_f.append(_scalar_factor(x, mt, mc, it.u_new, mt_vec[Pc[c]],
                                    beta))
        for a in seg(Dc[c]):
            x, mt = base(a)
            x = {r: x.get(r, 0.0) for r in range(len(beta))}
            live = uid_a[a] != it.uid_new
            r = int(ncr[Pa[a], Pc[c]])
            if live and Pa[a] != Pc[c] and r >= 0:
                x[r] += mc
            mt += (1.0 if live and Pa[a] == Pc[c] else 0.0) * it.u_new
            ci.append(c)
            ai.append(a)
            act.append(_scalar_factor(x, mt, Ma[a], Ua[a], mt_vec[Pa[a]],
                                      beta))
    if not ci:
        new_f = [1.0] * len(Pc)
    return new_f, ci, ai, act


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slowdown_same_device_is_the_sequential_scalar_loop(seed):
    items = _sd_items(seed)
    tables = _tables(np.random.default_rng(100 + seed))
    got = sk.slowdown_same_device(items, tables[2], tables[3], tables[1],
                                  tables[0], KAPPA)
    for it, (nf, ci, ai, pf) in zip(items, got):
        w_nf, w_ci, w_ai, w_pf = _scalar_same_device(it, tables)
        assert nf.tolist() == w_nf
        assert ci.tolist() == w_ci and ai.tolist() == w_ai
        assert pf.tolist() == w_pf
    assert got[1][1].numel() == 0 and got[1][0].tolist() == [1.0] * 4
    assert 0 < got[2][1].numel() < 12 * 4       # device 1's candidates: none


@pytest.mark.parametrize("R", [17, 44])
@pytest.mark.parametrize("form", ["row", "pool", "same_device"])
def test_b1_plain_forms_take_any_number_of_classes(form, R):
    """Past the kernels' register path (16 classes) the wrappers take the
    snapshot as the reference does: each form bit for bit against the
    scalar loop written out, at 17 and 44 classes (the paper's testbed
    with one class per resource node)."""
    rng = np.random.default_rng(R)
    if form == "row":
        n = 40
        x = rng.uniform(0.0, 3.0, (n, R))
        x[rng.random((n, R)) < 0.5] = 0.0
        beta = _beta(R)
        mem = rng.uniform(0.05, 1.0, n)
        mt = rng.uniform(0.0, 2.0, n)
        got = sk.slowdown_factors(t(x), t(beta), t(mem), t(mt), KAPPA)
        want = []
        for i in range(n):
            prod = 1.0
            for r in range(R):
                if x[i, r] > 0.0 and beta[r] > 0.0:
                    prod *= 1.0 + beta[r] * x[i, r] * (1.0 + KAPPA * x[i, r]) \
                        * mem[i]
            f = (1.0 + mt[i]) * prod
            want.append(f if f > 1.0 else 1.0)
        assert got.tolist() == want
        np.testing.assert_allclose(
            got.numpy(), ref.slowdown_factors_ref(x, beta, mem, mt, KAPPA),
            rtol=F64_RTOL, atol=0)
    elif form == "pool":
        for distinct in (True, False):
            args = _pool_inputs(64, R, distinct, R=R)
            assert sk.slowdown_pool(*args).tolist() == _scalar_pool(
                args, 64, distinct)
    else:
        items = _sd_items(R)
        tables = _tables(np.random.default_rng(200 + R), R=R)
        got = sk.slowdown_same_device(items, tables[2], tables[3],
                                      tables[1], tables[0], KAPPA)
        for it, (nf, ci, ai, pf) in zip(items, got):
            w_nf, w_ci, w_ai, w_pf = _scalar_same_device(it, tables)
            assert nf.tolist() == w_nf
            assert ci.tolist() == w_ci and ai.tolist() == w_ai
            assert pf.tolist() == w_pf


def test_same_device_stack_offsets_split_results_back_exactly():
    items = _sd_items(7) + _sd_items(8)[2:]
    tables = _tables(np.random.default_rng(9))
    R = 6
    per = sk.slowdown_same_device_plain(items, tables[2], tables[3],
                                        tables[1], tables[0], KAPPA)
    run = [i for i, r in enumerate(per) if r[1].numel()]
    cs = [None if it.summ[1] else torch.cumsum(it.na[it.Dc], 0)
          for it in items]
    rows, (nf, pairs, base, flags) = sk.same_device_layout(
        [items[i] for i in run], [per[i][1].numel() for i in run], R,
        [cs[i] for i in run])
    f = {name: k for k, name in enumerate(sk.SD_FIELDS)}
    assert nf == sum(items[i].Pc.numel() for i in run)
    assert pairs == sum(per[i][1].numel() for i in run)
    # each item's regions follow the previous item's, without a gap
    end = {"newf_off": 0, "pair_off": 0, "base_off": 0, "flag_off": 0}
    for row, i in zip(rows, run):
        it = items[i]
        single = bool(row[f["single"]])
        assert single == it.summ[1] and row[f["K"]] == per[i][1].numel()
        sizes = {"newf_off": it.Pc.numel(), "pair_off": row[f["K"]],
                 "base_off": (R + 1) * (it.summ[3] if single
                                        else it.Pa.numel()),
                 "flag_off": 0 if single else it.na.numel()}
        for k, size in sizes.items():
            assert row[f[k]] == end[k]
            end[k] += size
        assert row[f["base_lo"]] == (it.summ[2] if single else 0)
        assert row[f["Pa"]] == it.Pa.data_ptr()
        assert row[f["cs"]] == (0 if single else cs[i].data_ptr())
        assert np.int64(row[f["u_new"]]).view(np.float64) == it.u_new
        assert np.int64(row[f["mem_new"]]).view(np.float64) == it.mem_new
    assert (end["base_off"], end["flag_off"]) == (base, flags)
    # the buffers as the kernel fills them, split back per item
    new_f = torch.full((nf,), float("nan"), dtype=torch.float64)
    ci = torch.full((pairs,), -1)
    ai = torch.full((pairs,), -1)
    pf = torch.full((pairs,), float("nan"), dtype=torch.float64)
    for row, i in zip(rows, run):
        o, p, k = row[f["newf_off"]], row[f["pair_off"]], row[f["K"]]
        new_f[o:o + row[f["C"]]] = per[i][0]
        ci[p:p + k], ai[p:p + k], pf[p:p + k] = per[i][1:]
    assert not new_f.isnan().any() and (ci >= 0).all()
    for i, res in zip(run, sk.split_stack(rows, new_f, ci, ai, pf)):
        assert all(torch.equal(a, b) for a, b in zip(res, per[i]))


@pytest.mark.parametrize("case", ["dtype", "classes", "tables", "length"])
def test_fused_factor_wrappers_raise_on_what_they_do_not_take(case):
    args = list(_pool_inputs(8, 3, True))
    items = _sd_items(3)
    ncr, cap, mt_vec, beta = _tables(np.random.default_rng(3))
    if case == "dtype":
        args[0] = args[0].int()
        with pytest.raises(TypeError):
            sk.slowdown_pool(*args)
        bad = items[0]._replace(Ua=items[0].Ua.float())
        with pytest.raises(TypeError):
            sk.slowdown_same_device([bad], mt_vec, beta, cap, ncr, KAPPA)
    elif case == "classes":
        # any number of classes is taken (17: one past the kernels'
        # registers); a class axis of the wrong shape is not
        args[8] = torch.zeros((2, 17), dtype=torch.float64)
        with pytest.raises(ValueError, match="dims"):
            sk.slowdown_pool(*args)
        x = torch.zeros((2, 17), dtype=torch.float64)
        v = torch.zeros(2, dtype=torch.float64)
        with pytest.raises(ValueError, match="shape mismatch"):
            sk.slowdown_factors(x, v, v, v, KAPPA)
    elif case == "tables":
        args[6] = args[6][:, :-1].contiguous()
        with pytest.raises(ValueError, match="disagree"):
            sk.slowdown_pool(*args)
        with pytest.raises(ValueError):
            sk.slowdown_same_device(items, mt_vec, beta, cap,
                                    ncr[:, ::2], KAPPA)
    else:
        args[2] = args[2][:-1].clone()
        with pytest.raises(ValueError, match="one length"):
            sk.slowdown_pool(*args)
        bad = items[0]._replace(Ma=items[0].Ma[:-1].clone())
        with pytest.raises(ValueError, match="disagree"):
            sk.slowdown_same_device([bad], mt_vec, beta, cap, ncr, KAPPA)


# ---------------------------------------------------------------------------
# B2 rate-advance (both forms)
# ---------------------------------------------------------------------------
def _ra_inputs(n, seed):
    rng = np.random.default_rng(seed)
    W = rng.uniform(0, 100, n)
    rate = rng.uniform(0.01, 5.0, n)
    rate[:: max(1, n // 3)] = 0.0                # rate <= 0 -> eta = +inf
    t_last = rng.uniform(0, 2, n)
    return W, rate, t_last


@pytest.mark.parametrize("n", [1, 7, 128, 300])
def test_rate_advance_matches_oracle(n):
    W, rate, t_last = _ra_inputs(n, n)
    if n > 4:
        rate[1] = -1.0
        rate[2] = np.inf                          # inf * 0 -> NaN residue
        t_last[2] = 2.5
    w_ref, e_ref = ref.rate_advance_ref(W, rate, t_last, 2.5)
    w, e = tk.rate_advance(t(W), t(rate), t(t_last), 2.5)
    np.testing.assert_array_equal(w.numpy(), w_ref)
    np.testing.assert_array_equal(e.numpy(), e_ref)
    # the fused settle of the compute sites: the same W' in place
    cols = [t(W), t(rate), t(t_last), t(np.zeros(n))]
    tk.settle_complete(*cols, torch.arange(n), 2.5, 0.0)
    np.testing.assert_array_equal(cols[0].numpy(), w_ref)
    if n > 4:
        assert w[2].item() == 0.0 and np.isinf(e[0].item())


def test_rate_advance_matches_pallas_interpret():
    W, rate, t_last = _ra_inputs(300, 5)
    w, e = tk.rate_advance_plain(t(W), t(rate), t(t_last), 2.5)
    w_k, e_k = ref_tk.rate_advance_pallas(W, rate, t_last, 2.5)
    np.testing.assert_allclose(w.numpy(), w_k, rtol=2e-5, atol=1e-5)
    fin = np.isfinite(e.numpy())
    assert (np.isfinite(e_k) == fin).all()
    np.testing.assert_allclose(e.numpy()[fin], e_k[fin], rtol=2e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# B3 segment-min (CSR in, no densification)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S", [1, 9, 257])
def test_segment_min_matches_oracle(S):
    rng = np.random.default_rng(S)
    counts = rng.integers(0, 5, S)
    counts[0] = 0                                 # empty segment -> +inf
    vals = rng.uniform(1, 50, int(counts.sum()))
    want = ref.segment_min_ref(vals, counts)
    starts = np.cumsum(counts) - counts
    got = tk.segment_min(t(vals), t(starts), t(counts)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got[0])
    if int(counts.sum()):
        pal = ref_tk.segment_min_pallas(vals, counts)
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], pal[fin], rtol=1e-6)


def test_segment_min_takes_offset_starts():
    vals = t(np.array([9.0, 9.0, 5.0, 2.0, 7.0, 1.0, 9.0]))
    out = tk.segment_min(vals, t(np.array([2, 4, 4])), t(np.array([2, 0, 3])))
    assert out.tolist() == [2.0, float("inf"), 1.0]


# ---------------------------------------------------------------------------
# B4 scan-reduce
# ---------------------------------------------------------------------------
def _plan(n_dev, per_dev, rng):
    P = n_dev * per_dev
    if n_dev == 1:
        return (np.array([0]), np.array([P]), np.array([P]), np.array([0]),
                np.array([0.0]), np.array([0.0]))
    lo = np.array([0] + [d * per_dev for d in range(n_dev)])
    hi = np.array([P] + [(d + 1) * per_dev for d in range(n_dev)])
    leaf = np.array([0] + [per_dev] * n_dev)
    nch = np.array([n_dev] + [0] * n_dev)
    hop = np.concatenate([[rng.uniform(1e-4, 1e-3)], np.zeros(n_dev)])
    dep = np.array([0.0] + [1.0] * n_dev)
    return lo, hi, leaf, nch, hop, dep


def _scan(shape, mode, seed):
    """One scan's columns and plan: ``ok``/``key`` in the given mode, the
    prediction columns ``sa``/``f``/``cm`` the kernel gathers."""
    n_dev, per_dev = shape
    rng = np.random.default_rng(seed)
    P = n_dev * per_dev
    ok = rng.random(P) < 0.4
    key = rng.uniform(0.01, 0.2, P)
    if mode == "ties":
        key = np.round(key, 1)
    elif mode == "allinf":
        key[:] = np.inf
    elif mode in ("infeasible", "single_ok"):
        ok[:] = False
    if mode != "infeasible":
        ok[rng.integers(0, P)] = True
    cols = (rng.uniform(0.01, 0.1, P), rng.uniform(1.0, 2.0, P),
            rng.uniform(0.0, 0.01, P))
    return ok, key, cols, _plan(n_dev, per_dev, rng)


def _assert_row(got, want, ok, cols, rel):
    """A kernel row against ``scan_reduce_ref``'s 4-tuple: decisions and
    the gathered prediction columns exact, ``overhead`` within ``rel``."""
    assert [int(v) for v in got[:3]] == [int(v) for v in want[:3]]
    assert got[3] == pytest.approx(float(want[3]), rel=rel, abs=0)
    w = int(want[0])
    if w < 0:
        assert list(got) == [-1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]
    else:
        assert ok[w]
        assert list(got[4:]) == [float(c[w]) for c in cols]


@pytest.mark.parametrize("mode", ["plain", "ties", "allinf", "infeasible",
                                  "single_ok"])
@pytest.mark.parametrize("shape", [(1, 6), (8, 6), (40, 6)])
def test_scan_reduce_matches_oracle(shape, mode):
    ok, key, cols, plan = _scan(shape, mode, shape[0] * 10 + len(mode))
    want = scan_reduce_ref(ok, key, *plan, 5e-6)
    got = wk.scan_reduce(t(ok), t(key), *(t(c) for c in cols),
                         wk.ScanPlanArrays.from_lists(*plan, "cpu"),
                         5e-6).tolist()
    _assert_row(got, want, ok, cols, 1e-9)
    if mode == "allinf":
        assert ok[int(got[0])] and not ok[:int(got[0])].any()


# ragged stacks mix warp-sized (<= 32 PUs) and block-sized scans; "shared"
# stacks reuse one plan's nodes for every scan, as the walk's pool does
STACKS = {"ragged": [(1, 6), (8, 6), (1, 1), (40, 6), (1, 6), (3, 2)],
          "same": [(1, 6)] * 5,
          "shared": [(8, 6)] * 4}
MODES = ["plain", "ties", "allinf", "infeasible"]


def _stack(name, mode):
    """Concatenated columns, the plan pool and per-scan offsets."""
    shapes = STACKS[name]
    scans = [_scan(sh, MODES[i % 4] if mode == "mixed" else mode, 100 + i)
             for i, sh in enumerate(shapes)]
    if name == "shared":
        scans = [sc[:3] + (scans[0][3],) for sc in scans]
    plans = [scans[0][3]] if name == "shared" else [sc[3] for sc in scans]
    pool = [np.concatenate(col) for col in zip(*plans)]
    offs, ok_off, node_off = [], 0, 0
    for ok, _, _, plan in scans:
        offs.append((ok_off, len(ok), node_off, len(plan[0])))
        ok_off += len(ok)
        if name != "shared":
            node_off += len(plan[0])
    cat = [np.concatenate(c) for c in zip(*[(sc[0], sc[1]) + sc[2]
                                            for sc in scans])]
    return scans, cat, pool, offs


@pytest.mark.parametrize("mode", MODES + ["mixed"])
@pytest.mark.parametrize("stack", sorted(STACKS))
def test_scan_reduce_batch_plain_matches_reference(stack, mode, monkeypatch):
    """B4b's plain version (the CPU wrapper) row by row against
    ``scan_reduce_ref`` and against the single-scan path; same-shape stacks
    also against the reference's ``scan_reduce_batch`` on its numpy path
    (its jitted path runs int32/float32 and is no oracle)."""
    monkeypatch.delenv("REPRO_WALK_KERNEL", raising=False)
    assert not ref_wk._use_jax()
    scans, cat, pool, offs = _stack(stack, mode)
    got = wk.scan_reduce_batch(
        *(t(c) for c in cat), wk.ScanPlanArrays.from_lists(*pool, "cpu"),
        offs, 5e-6).tolist()
    assert len(got) == len(scans)
    for row, (ok, key, cols, plan) in zip(got, scans):
        _assert_row(row, scan_reduce_ref(ok, key, *plan, 5e-6), ok, cols,
                    1e-12)
        one = wk.scan_reduce(t(ok), t(key), *(t(c) for c in cols),
                             wk.ScanPlanArrays.from_lists(*plan, "cpu"),
                             5e-6).tolist()
        assert row[:3] + row[4:] == one[:3] + one[4:]
        assert row[3] == pytest.approx(one[3], rel=1e-12, abs=0)
    if stack != "ragged":
        stacked = [np.stack(c) for c in zip(*[(sc[0], sc[1]) + sc[3]
                                              for sc in scans])]
        wv, qv, hv, ov = ref_wk.scan_reduce_batch(*stacked, 5e-6)
        assert [int(r[0]) for r in got] == wv.tolist()
        assert [int(r[1]) for r in got] == qv.tolist()
        assert [int(r[2]) for r in got] == hv.tolist()
        np.testing.assert_allclose([r[3] for r in got], ov, rtol=1e-12,
                                   atol=0)


def test_scan_reduce_batch_of_nothing_and_bad_offsets():
    ok, key, cols, plan = _scan((8, 6), "plain", 3)
    arr = wk.ScanPlanArrays.from_lists(*plan, "cpu")
    args = (t(ok), t(key), *(t(c) for c in cols), arr)
    assert wk.scan_reduce_batch(*args, [], 5e-6).shape == (0, 7)
    n, nn = len(ok), len(plan[0])
    # a scan with no PU (after the last column) gives the infeasible row
    pool = wk.ScanPlanArrays.from_lists(
        *(list(c) + [z] for c, z in zip(plan, (0, 0, 0, 0, 0.0, 0.0))),
        "cpu")
    rows = wk.scan_reduce_batch(*args[:5], pool,
                                [(0, n, 0, nn), (n, 0, nn, 1)], 5e-6).tolist()
    assert rows[0] == wk.scan_reduce(*args, 5e-6).tolist()
    assert rows[1] == [-1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]
    for bad in [(1, n, 0, nn), (0, n, 0, 0), (0, n, 1, nn), (-1, 2, 0, 1),
                (0, n + 1, 0, nn)]:
        with pytest.raises(ValueError):
            wk.scan_reduce_batch(*args, [bad], 5e-6)
    with pytest.raises(ValueError):           # the plan reaches past the scan
        wk.scan_reduce(*(a[:n - 1] for a in args[:5]), arr, 5e-6)
    with pytest.raises(ValueError):
        wk.ScanPlanArrays.from_lists([0, 3], [6, 2], [0, 1], [1, 0],
                                     [0.0, 0.0], [0.0, 1.0], "cpu")


@pytest.mark.parametrize("mode", ["plain", "ties", "allinf", "infeasible"])
def test_scan_reduce_takes_scans_past_the_block_cap(mode):
    """A root scan of more PUs than one block holds (the mining fleet past
    mult ~1985) is taken, as the reference takes it: one scan of
    BLOCK_MAX_P + 8643 PUs and a stack mixing it with small scans, row by
    row against ``scan_reduce_ref``."""
    per_dev = 6
    n_dev = (wk.BLOCK_MAX_P + 8643) // per_dev
    ok, key, cols, plan = _scan((n_dev, per_dev), mode, 31)
    P = len(ok)
    assert P > wk.BLOCK_MAX_P
    arr = wk.ScanPlanArrays.from_lists(*plan, "cpu")
    got = wk.scan_reduce(t(ok), t(key), *(t(c) for c in cols), arr,
                         5e-6).tolist()
    want = scan_reduce_ref(ok, key, *plan, 5e-6)
    _assert_row(got, want, ok, cols, 1e-12)
    sok, skey, scols, splan = _scan((1, 6), mode, 32)
    pool = wk.ScanPlanArrays.from_lists(
        *(np.concatenate([a, b]) for a, b in zip(plan, splan)), "cpu")
    cat = [t(np.concatenate([a, b])) for a, b in
           zip((ok, key) + cols, (sok, skey) + scols)]
    nn = len(plan[0])
    rows = wk.scan_reduce_batch(*cat, pool, [(0, P, 0, nn), (P, 6, nn, 1),
                                             (0, P, 0, nn)], 5e-6).tolist()
    _assert_row(rows[0], want, ok, cols, 1e-12)
    _assert_row(rows[1], scan_reduce_ref(sok, skey, *splan, 5e-6), sok,
                scols, 1e-12)
    assert rows[2] == rows[0]


def test_scan_reduce_batch_refuses_nodes_past_their_scan():
    """Each scan's plan nodes must end within its own PUs: a node reaching
    into the next scan's PUs is refused on the host, before any launch."""
    ok, key, cols, plan = _scan((8, 6), "plain", 4)
    n, nn = len(ok), len(plan[0])
    args = (t(np.concatenate([ok, ok])), t(np.concatenate([key, key])),
            *(t(np.concatenate([c, c])) for c in cols))
    arr = wk.ScanPlanArrays.from_lists(*plan, "cpu")
    assert arr.hi.tolist() == list(plan[1]) and arr.span == n
    rows = wk.scan_reduce_batch(*args, arr, [(0, n, 0, nn), (n, n, 0, nn)],
                                5e-6)
    assert rows[0].tolist() == rows[1].tolist()
    for scans in ([(0, n - 1, 0, nn)], [(0, n, 0, nn), (n, n - 1, 0, nn)],
                  [(n, 1, 0, nn)]):
        with pytest.raises(ValueError, match="reach past"):
            wk.scan_reduce_batch(*args, arr, scans, 5e-6)
    # the last device node alone ends at the scan's end
    rows = wk.scan_reduce_batch(*args, arr, [(0, n, nn - 1, 1)], 5e-6)
    assert rows.shape == (1, 7)


# ---------------------------------------------------------------------------
# B2's fused settle forms against the unfused op sequence they replace
# ---------------------------------------------------------------------------
def _job_columns(n_cols, rng):
    W = rng.uniform(0.0, 5.0, n_cols)
    W[:: 3] = 0.0                               # settled already
    rate = rng.uniform(0.1, 2.0, n_cols)
    t_last = rng.uniform(0.0, 1.0, n_cols)
    eta = rng.uniform(0.0, 9.0, n_cols)
    cstamp = rng.integers(0, 100, n_cols)
    return [t(W), t(rate), t(t_last), t(eta), t(cstamp)]


def _settled(W, rate, t_last, now):
    """The reference's settle (its float64 oracle), as a tensor."""
    return t(ref.rate_advance_ref(W.numpy(), rate.numpy(), t_last.numpy(),
                                  now)[0])


@pytest.mark.parametrize("n", [1, 4, 384])
def test_settle_reprice_plain_is_the_unfused_sequence(n):
    rng = np.random.default_rng(n)
    fused = _job_columns(2 * n + 5, rng)
    unfused = [c.clone() for c in fused]
    members = t(rng.permutation(2 * n + 5)[:n])
    assert len(set(members.tolist())) == n       # distinct slots only
    factors = t(rng.uniform(1.0, 3.0, n))
    factors[0] = 1.0
    tk.settle_reprice(*fused, members, factors, 1.5, 77)
    # the flush's sequence before it was fused
    W, rate, t_last, eta, cstamp = unfused
    cstamp[members] = torch.arange(77, 77 + n)
    W2 = _settled(W[members], rate[members], t_last[members], 1.5)
    r = 1.0 / factors
    W[members] = W2
    t_last[members] = 1.5
    rate[members] = r
    eta[members] = 1.5 + W2 / r
    for a, b in zip(fused, unfused):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [1, 4, 384])
def test_settle_complete_plain_is_the_unfused_sequence(n):
    rng = np.random.default_rng(n + 1)
    fused = _job_columns(2 * n + 5, rng)[:4]
    unfused = [c.clone() for c in fused]
    done = t(rng.permutation(2 * n + 5)[:n])
    assert len(set(done.tolist())) == n          # distinct slots only
    tol = 1e-15
    pairs = tk.settle_complete(*fused, done, 1.5, tol)
    # the completion's sequence before it was fused
    W, rate, t_last, eta = unfused
    W2 = _settled(W[done], rate[done], t_last[done], 1.5)
    W[done] = W2
    t_last[done] = 1.5
    fin = W2 <= tol
    resid = done[~fin]
    eta[resid] = 1.5 + W[resid] / rate[resid]
    eta[done[fin]] = float("inf")
    assert pairs.dtype == torch.int64
    assert pairs.tolist() == [done.tolist(), fin.to(torch.int64).tolist()]
    assert 0 < int(fin.sum()) or n < 4
    for a, b in zip(fused, unfused):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# B3 with B2's transfer form: the fused transfer sites against the unfused
# op sequence the engine ran before them
# ---------------------------------------------------------------------------
XTOL = 1e-6


def _bits(a: torch.Tensor) -> torch.Tensor:
    """A column's bits, so a NaN equals the same NaN."""
    return a.view(torch.int64) if a.dtype == torch.float64 else a


def _transfers(n_x, n_edges, seed):
    """Transfer columns for ``n_x`` slots (xW, xrate, xt_last, xeta,
    xstamp, then the CSR rows: xe_flat, xe_start, xe_cnt, starts offset
    into a larger buffer), routes of 0-6 edges (slot 0 empty, slot 1 an
    infinite old rate), edge bandwidths with zeros and a NaN, and old /
    new per-edge member counts (some changed)."""
    rng = np.random.default_rng(seed)
    cnt = rng.integers(0, 7, n_x)
    cnt[0] = 0
    cnt[2:4] = np.maximum(cnt[2:4], 1)
    start = np.cumsum(cnt) - cnt + 3
    flat = rng.integers(1, n_edges, int(cnt.sum()) + 3)
    bw = rng.uniform(1e6, 1e9, n_edges)
    bw[::5] = 0.0
    bw[3] = np.nan
    flat[flat == 3] = 1
    flat[start[2]] = 3                        # slot 2 crosses the NaN edge,
    flat[start[3]] = 0                        # slot 3 a zero-bandwidth one
    old = rng.integers(0, 5, n_edges)
    new = old.copy()
    changed = rng.random(n_edges) < 0.4
    new[changed] = rng.integers(0, 5, int(changed.sum()))
    W = rng.uniform(0.0, 5e6, n_x)
    W[::4] = 0.0
    rate = rng.uniform(1e5, 1e8, n_x)
    rate[::7] = 0.0                           # not yet priced: eta +inf
    t_last = rng.uniform(0.0, 1.0, n_x)
    rate[1], t_last[1] = np.inf, 1.5          # inf * 0: NaN residue -> 0
    cols = [t(W), t(rate), t(t_last), t(rng.uniform(0.0, 9.0, n_x)),
            t(rng.integers(0, 100, n_x))]
    return cols, [t(flat), t(start), t(cnt)], t(bw), old, new


def _unfused_reprice(cols, csr, bw_arr, members, ks_l, now, stamp):
    """The engine's link reprice before it was fused (its CSR rows and
    member counts as host lists then)."""
    xW, xrate, xt_last, xeta, xstamp = cols
    xe_flat, xe_start, xe_cnt = csr
    ks = t(ks_l)
    n_k = len(ks_l)
    xstamp[ks] = torch.arange(stamp, stamp + n_k)
    starts = xe_start[ks]
    counts = xe_cnt[ks]
    K = sum(int(xe_cnt[k]) for k in ks_l)
    seg_starts = torch.cumsum(counts, 0) - counts
    if K:
        within = torch.arange(K) - torch.repeat_interleave(
            seg_starts, counts, output_size=K)
        flat = xe_flat[torch.repeat_interleave(starts, counts,
                                               output_size=K) + within]
    else:
        flat = torch.zeros(0, dtype=torch.int64)
    edge_mem = t(list(members))
    shares = bw_arr[flat] / torch.clamp_min(edge_mem[flat], 1).to(
        torch.float64)
    bw = tk.segment_min(shares, seg_starts, counts)
    W2, _ = tk.rate_advance(xW[ks], xrate[ks], xt_last[ks], now)
    xW[ks] = W2
    xt_last[ks] = now
    xrate[ks] = bw
    xeta[ks] = now + torch.where(bw > 0.0, W2 / bw,
                                 torch.full_like(W2, float("inf")))


@pytest.mark.parametrize("n", [1, 16, 384])
def test_transfer_reprice_plain_is_the_unfused_sequence(n):
    """Empty routes, zero-bandwidth and NaN edges, zero and infinite old
    rates; the changed member counts land in the edge column."""
    cols, csr, bw, old, new = _transfers(2 * n + 5, 12, n)
    ks_l = sorted(np.random.default_rng(n).permutation(2 * n + 5)[:n]
                  .tolist())
    ks_l = sorted(set(ks_l) | {0, 1, 2, 3})
    upd = np.flatnonzero(old != new)
    fused = [c.clone() for c in cols]
    mem = t(old)
    tk.transfer_reprice(*fused, *csr, bw, mem, t(ks_l), t(upd),
                        t(new[upd]), 1.5, 77)
    _unfused_reprice(cols, csr, bw, new, ks_l, 1.5, 77)
    for a, b in zip(fused, cols):
        assert torch.equal(_bits(a), _bits(b))
    assert mem.tolist() == new.tolist()
    xrate, xeta = fused[1], fused[3]
    assert xrate[0] == float("inf") and xeta[0] == 1.5   # no edge: +inf
    routes = [csr[0][int(csr[1][k]):int(csr[1][k]) + int(csr[2][k])]
              .tolist() for k in ks_l]
    nan = [i for i, r in enumerate(routes) if any(bw[e].isnan() for e in r)]
    zero = [i for i, r in enumerate(routes)
            if i not in nan and any(bw[e] == 0.0 for e in r)]
    assert 2 in nan and 3 in zero            # positions = slots here
    assert all(xrate[ks_l[i]].isnan() and xeta[ks_l[i]] == float("inf")
               for i in nan)
    assert all(xrate[ks_l[i]] == 0.0 and xeta[ks_l[i]] == float("inf")
               for i in zero)


@pytest.mark.parametrize("n", [1, 16, 384])
def test_transfer_complete_plain_is_the_unfused_sequence(n):
    """Simultaneous completions in reprice-stamp order (ties kept in slot
    order), finished and residual transfers, zero, NaN and infinite
    rates."""
    cols, _, _, _, _ = _transfers(2 * n + 5, 12, n + 50)
    xW, xrate, xt_last, xeta, xstamp = cols
    xrate[2] = float("nan")
    xstamp[:] = xstamp // 10                    # stamp ties
    rng = np.random.default_rng(n)
    done = t(rng.permutation(2 * n + 5)[:n])
    done = done[torch.argsort(xstamp[done], stable=True)]
    fused = [c.clone() for c in cols[:4]]
    pairs = tk.transfer_complete(*fused, done, 1.5, XTOL)
    # the completion's sequence before it was fused
    W2, eta = tk.rate_advance(xW[done], xrate[done], xt_last[done], 1.5)
    xW[done] = W2
    xt_last[done] = 1.5
    fin = W2 <= XTOL
    done_l, fin_l = torch.stack([done, fin.to(torch.int64)]).tolist()
    if not all(fin_l):
        pos = t([i for i, ok in enumerate(fin_l) if not ok])
        xeta[done[pos]] = eta[pos]
    xeta[t([k for k, ok in zip(done_l, fin_l) if ok],
           dtype=torch.int64)] = float("inf")
    assert pairs.dtype == torch.int64
    assert pairs.tolist() == [done_l, fin_l]
    for a, b in zip(fused, cols[:4]):
        assert torch.equal(_bits(a), _bits(b))
    assert n < 16 or 0 < sum(fin_l) < n


@pytest.mark.parametrize("case", ["dtype", "length", "edges"])
def test_fused_transfer_wrappers_raise_on_what_they_do_not_take(case):
    cols, csr, bw, old, _ = _transfers(8, 6, 0)
    mem = t(old)
    ks, none = t([1, 3]), torch.zeros(0, dtype=torch.int64)
    if case == "dtype":
        with pytest.raises(TypeError):
            tk.transfer_reprice(*cols, *csr, bw.float(), mem, ks, none,
                                none, 0.0, 0)
        with pytest.raises(TypeError):
            tk.transfer_complete(*cols[:4], ks.int(), 0.0, XTOL)
    elif case == "length":
        with pytest.raises(ValueError):
            tk.transfer_reprice(*cols, csr[0], csr[1][:7].clone(), csr[2],
                                bw, mem, ks, none, none, 0.0, 0)
        with pytest.raises(ValueError):
            tk.transfer_complete(cols[0], cols[1][:7].clone(), *cols[2:4],
                                 ks, 0.0, XTOL)
    else:
        with pytest.raises(ValueError):
            tk.transfer_reprice(*cols, *csr, bw, mem[:5].clone(), ks, none,
                                none, 0.0, 0)
        with pytest.raises(ValueError):
            tk.transfer_reprice(*cols, *csr, bw, mem, ks, t([1, 2]), t([0]),
                                0.0, 0)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def test_wrappers_take_the_plain_version_on_cpu_and_count_no_launch():
    before = (dict(sk.launches), dict(tk.launches), dict(wk.launches))
    test_slowdown_factors_inactive_rows_are_one()
    test_slowdown_pool_is_the_sequential_scalar_loop(8, True)
    test_slowdown_same_device_is_the_sequential_scalar_loop(0)
    test_segment_min_takes_offset_starts()
    test_settle_reprice_plain_is_the_unfused_sequence(4)
    test_settle_complete_plain_is_the_unfused_sequence(4)
    test_transfer_reprice_plain_is_the_unfused_sequence(16)
    test_transfer_complete_plain_is_the_unfused_sequence(16)
    test_scan_reduce_matches_oracle((8, 6), "plain")
    assert (dict(sk.launches), dict(tk.launches), dict(wk.launches)) == before


@pytest.mark.parametrize("case", ["dtype", "contiguous", "shape", "ndim"])
def test_wrappers_raise_on_what_they_do_not_take(case):
    x = torch.zeros((4, 6), dtype=torch.float64)
    beta = torch.zeros(6, dtype=torch.float64)
    v = torch.zeros(4, dtype=torch.float64)
    if case == "dtype":
        with pytest.raises(TypeError):
            sk.slowdown_factors(x.float(), beta, v, v, 0.1)
        with pytest.raises(TypeError):
            tk.segment_min(v, torch.zeros(2, dtype=torch.int32),
                           torch.zeros(2, dtype=torch.int64))
    elif case == "contiguous":
        with pytest.raises(ValueError):
            tk.rate_advance(torch.zeros(8, dtype=torch.float64)[::2], v, v, 0.0)
    elif case == "shape":
        with pytest.raises(ValueError):
            sk.slowdown_factors(x, beta, v[:3].clone(), v, 0.1)
    else:
        with pytest.raises(ValueError):
            sk.slowdown_factors(v, beta, v, v, 0.1)


@pytest.mark.parametrize("case", ["dtype", "length", "index"])
def test_fused_settle_wrappers_raise_on_what_they_do_not_take(case):
    W, rate, t_last, eta, cstamp = _job_columns(8, np.random.default_rng(0))
    idx = torch.arange(3)
    fac = torch.ones(3, dtype=torch.float64)
    if case == "dtype":
        with pytest.raises(TypeError):
            tk.settle_reprice(W, rate, t_last, eta, cstamp.double(), idx,
                              fac, 0.0, 0)
        with pytest.raises(TypeError):
            tk.settle_complete(W.float(), rate, t_last, eta, idx, 0.0, 0.0)
    elif case == "length":
        with pytest.raises(ValueError):
            tk.settle_reprice(W, rate, t_last, eta, cstamp, idx, fac[:2],
                              0.0, 0)
        with pytest.raises(ValueError):
            tk.settle_complete(W, rate[:7].clone(), t_last, eta, idx, 0.0,
                               0.0)
    else:
        with pytest.raises(TypeError):
            tk.settle_complete(W, rate, t_last, eta, idx.int(), 0.0, 0.0)
        with pytest.raises(ValueError):
            tk.settle_reprice(W, rate, t_last, eta, cstamp,
                              torch.arange(6)[::2], fac, 0.0, 0)


# ---------------------------------------------------------------------------
# the fused re-walk entry scan (its kernel against this plain version on the
# card: tests/test_torch_kernels_card.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", rewalk_cases.CASES)
def test_rewalk_entry_on_the_cpu_is_its_plain_version(case):
    """The wrapper takes the plain version on the CPU and counts no
    launch; it rewrites the scan state's segment and the effective
    columns over it and nothing else: the eligible positions' columns
    from the check, the infeasible defaults elsewhere, the effective
    columns from them; an empty device checks to factors of 1 and no
    expiry, a scan without a feasible PU to no winner."""
    seg, tables = rewalk_cases.segment(torch.device("cpu"), case)
    old = rewalk_cases.copy_of(seg)
    ref = rewalk_cases.copy_of(seg)
    before = dict(wk.launches)
    got = wk.rewalk_entry(seg, *tables)
    assert wk.launches == before
    want = wk.rewalk_entry_plain(ref, *tables).tolist()
    assert (rewalk_cases.bits(got) == rewalk_cases.bits(want)).all()
    lo, hi = seg.lo, seg.lo + seg.nseg
    for name in rewalk_cases.MUTABLE:
        a, b = getattr(seg, name), getattr(old, name)
        assert torch.equal(a[:lo], b[:lo]) and torch.equal(a[hi:], b[hi:])
    off = torch.ones(seg.nseg, dtype=torch.bool)
    off[seg.cols] = False
    assert not seg.st_ok[lo:hi][off].any()
    assert (seg.st_sa[lo:hi][off] == float("inf")).all()
    assert (seg.st_f[lo:hi][off] == 1.0).all()
    assert (seg.st_wait[lo:hi][off] == 0.0).all()
    assert torch.equal(seg.st_sa[lo:hi][seg.cols], seg.sa)
    cm = torch.zeros(seg.nseg, dtype=torch.float64)
    cm[seg.eff_cols - lo] = seg.comm + seg.st_wait[seg.eff_cols]
    assert torch.equal(seg.cm[lo:hi], cm)
    assert torch.equal(seg.key[lo:hi],
                       cm + seg.st_sa[lo:hi] * seg.st_f[lo:hi])
    if seg.deadline is None:
        assert torch.equal(seg.ok[lo:hi], seg.st_ok[lo:hi])
    if case == "empty_device":
        assert got[7:] == [0.0, float("inf")]
        assert (seg.st_f[lo:hi] == 1.0).all()
        assert seg.st_ok[lo:hi][seg.cols].all()
    if case == "infeasible":
        assert got[:7] == [-1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]
    if case == "capped":
        assert (seg.st_wait[lo:hi] > 0).any() and got[7] == 1.0
    if case != "infeasible" and seg.ok.any():
        assert got[0] >= 0 and seg.ok[int(got[0])]


@pytest.mark.parametrize("case", ["dtype", "length", "segment", "plan",
                                  "tables"])
def test_rewalk_entry_raises_on_what_it_does_not_take(case):
    seg, tables = rewalk_cases.segment(torch.device("cpu"), "plain")
    if case == "dtype":
        bad, err = seg._replace(maxten=seg.maxten.double()), TypeError
    elif case == "length":
        bad, err = seg._replace(comm=seg.comm[:-1].clone()), ValueError
    elif case == "segment":
        bad, err = seg._replace(nseg=seg.ok.shape[0] + 1), ValueError
    elif case == "plan":
        n = wk.BLOCK_MAX_P + 1
        big = dict(ok=torch.zeros(n, dtype=torch.bool),
                   **{k: torch.zeros(n, dtype=torch.float64)
                      for k in ("cm", "key", "st_sa", "st_f", "st_wait")},
                   st_ok=torch.zeros(n, dtype=torch.bool))
        bad, err = seg._replace(**big), ValueError
    else:
        bad, err = seg, ValueError
        tables = (tables[0][:-1].clone(),) + tables[1:]
    with pytest.raises(err):
        wk.rewalk_entry(bad, *tables)
