"""The port's four kernels: each plain PyTorch version (what a wrapper
runs for a CPU tensor) against the reference's numpy oracle on the same
seeded inputs, and against the reference's Pallas kernel in interpret mode
at float32 tolerance.  Tolerances: decisions (winner / queries / hops,
inf and zero patterns) exact; floats 1e-12 relative against the float64
oracles; 2e-5 against the float32 Pallas kernels.  The CUDA kernels
themselves are held against these plain versions on the card by
``chip_smoke.py``."""
import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the reference's kernels need it; CPU backend)

from repro.kernels import ref
from repro.kernels import slowdown_kernel as ref_sk
from repro.kernels import timeline_kernel as ref_tk
from repro.kernels.walk_kernel import scan_reduce_ref
from repro_torch.kernels import slowdown_kernel as sk
from repro_torch.kernels import timeline_kernel as tk
from repro_torch.kernels import walk_kernel as wk

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
    s = tk.settle(t(W), t(rate), t(t_last), 2.5)
    np.testing.assert_array_equal(s.numpy(), w_ref)
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


@pytest.mark.parametrize("mode", ["plain", "ties", "allinf", "infeasible",
                                  "single_ok"])
@pytest.mark.parametrize("shape", [(1, 6), (8, 6), (40, 6)])
def test_scan_reduce_matches_oracle(shape, mode):
    n_dev, per_dev = shape
    rng = np.random.default_rng(n_dev * 10 + len(mode))
    P = n_dev * per_dev
    ok = rng.random(P) < 0.4
    key = rng.uniform(0.01, 0.2, P)
    if mode == "ties":
        key = np.round(key, 1)
    elif mode == "allinf":
        key[:] = np.inf
    elif mode == "infeasible":
        ok[:] = False
    elif mode == "single_ok":
        ok[:] = False
    if mode != "infeasible":
        ok[rng.integers(0, P)] = True
    lo, hi, leaf, nch, hop, dep = _plan(n_dev, per_dev, rng)
    want = scan_reduce_ref(ok, key, lo, hi, leaf, nch, hop, dep, 5e-6)
    got = wk.scan_reduce(t(ok), t(key), t(lo), t(hi), t(leaf), t(nch),
                         t(hop, torch.float64), t(dep, torch.float64),
                         5e-6).tolist()
    assert [int(got[0]), int(got[1]), int(got[2])] == list(want[:3])
    assert got[3] == pytest.approx(want[3], rel=1e-9, abs=0)
    if mode == "infeasible":
        assert got == [-1.0, 0.0, 0.0, 0.0]
    elif mode == "allinf":
        assert ok[int(got[0])]


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def test_wrappers_take_the_plain_version_on_cpu_and_count_no_launch():
    before = (sk.launches, dict(tk.launches), wk.launches)
    test_slowdown_factors_inactive_rows_are_one()
    test_segment_min_takes_offset_starts()
    assert (sk.launches, dict(tk.launches), wk.launches) == before


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
