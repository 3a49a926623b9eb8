"""Seeded single-device re-walk segments for the fused re-walk kernel's
tests (``walk_kernel.rewalk_entry``): the CPU tests and the card's
comparison with its plain version build them here.  Imports no JAX."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import walk_kernel as wk

# the shapes a re-walk's segment takes: a device with no active, tenancy
# caps reached, no deadline anywhere, a scan with no feasible PU, no
# eligible candidate, an active of the newcomer's own uid, a segment inside
# a larger plan, a device of more PUs than a warp's scan, and a snapshot of
# more classes than the kernel keeps in registers
CASES = ("plain", "empty_device", "capped", "inf_deadlines", "infeasible",
         "no_candidates", "self", "offset", "block", "wide")
KAPPA = 0.12


def _t(a, dev, dtype=None):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)


def segment(dev, case: str, seed: int = 0, n: Optional[int] = None,
            C: Optional[int] = None, A: Optional[int] = None) -> tuple:
    """``(seg, tables)``: a :class:`~walk_kernel.RewalkSegment` on ``dev``
    and the snapshot tables ``(mt_vec, beta, mem_cap, ncr_rclass,
    kappa)`` that :func:`~walk_kernel.rewalk_entry` takes after it.
    ``n``, ``C`` and ``A`` fix the device's PUs, its eligible candidates
    and its actives, which the case draws otherwise."""
    rng = np.random.default_rng(1000 * CASES.index(case) + seed)
    R = 44 if case == "wide" else 6
    nP, nd, d0, p0 = 64, 8, 3, 10
    if n is None:                                   # the device's PUs
        n = 40 if case == "block" else 6
    lo = 3 if case == "offset" else 0
    P = lo + n + (5 if case == "offset" else 0)
    ncr = rng.integers(-1, R, (nP, nP)).astype(np.int16)
    mem_cap = rng.uniform(0.3, 1.0, nP)
    mt_vec = rng.uniform(0.0, 0.6, nP)
    beta = rng.uniform(0.0, 0.5, R)
    beta[rng.random(R) < 0.2] = 0.0
    elig = rng.random(n) < 0.8
    elig[0] = case != "no_candidates"
    if case == "no_candidates":
        elig[:] = False
    elif C is not None:
        elig[:] = False
        elig[rng.choice(n, C, replace=False)] = True
    cols = np.flatnonzero(elig)
    C = len(cols)
    now = 0.5
    if case == "empty_device":
        A = 0
    elif A is None:
        A = int(rng.integers(4, 30))
    uid_new = 7
    uid_a = np.arange(100, 100 + A)
    if case == "self":
        uid_a[1] = uid_new
    dl_a = rng.uniform(0.05, 0.4, A)
    if case == "inf_deadlines":
        dl_a[:] = np.inf
    else:
        dl_a[rng.random(A) < 0.3] = np.inf
    deadline = {"inf_deadlines": None, "infeasible": 1e-5}.get(case, 0.03)
    na = np.zeros(nd, dtype=np.int64)
    na[d0] = A
    # the plan: the root over every PU, a node over the device's segment
    pu_lo, pu_hi = [0, lo], [P, lo + n]
    plan = wk.ScanPlanArrays.from_lists(
        pu_lo, pu_hi, [P - n, n], [1, 0], [rng.uniform(0, 1e-3), 0.0],
        [0.0, 1.0], dev)
    seg = wk.RewalkSegment(
        u_new=0.8, mem_new=0.6, uid_new=uid_new, deadline=deadline, now=now,
        Pc=_t(p0 + cols, dev, torch.int64),
        Dc=_t(np.full(C, d0), dev, torch.int64),
        cols=_t(cols, dev, torch.int64),
        sa=_t(rng.uniform(0.002, 0.03, C), dev),
        maxten=_t(rng.integers(1, 3, C) if case == "capped"
                  else np.full(C, 8), dev, torch.int64),
        eff_cols=_t(lo + cols, dev, torch.int64),
        comm=_t(rng.uniform(0.0, 0.005, C), dev),
        Pa=_t(p0 + rng.integers(0, n, A), dev, torch.int64),
        Ua=_t(rng.uniform(0.2, 1.0, A), dev),
        Ma=_t(rng.uniform(0.1, 0.9, A), dev),
        uid_a=_t(uid_a, dev, torch.int64),
        est=_t(now + rng.uniform(-0.01, 0.05, A), dev),
        fac=_t(rng.uniform(1.0, 2.0, A), dev),
        dl=_t(dl_a, dev),
        rel=_t(now - rng.uniform(0.0, 0.04, A), dev),
        Da=_t(np.full(A, d0), dev, torch.int64),
        astart=_t(np.zeros(nd), dev, torch.int64),
        na=_t(na, dev, torch.int64),
        st_ok=_t(rng.random(P) < 0.5, dev),
        st_sa=_t(rng.uniform(0.0, 0.1, P), dev),
        st_f=_t(rng.uniform(1.0, 3.0, P), dev),
        st_wait=_t(rng.uniform(0.0, 0.01, P), dev),
        lo=lo, nseg=n,
        ok=_t(rng.random(P) < 0.5, dev),
        cm=_t(rng.uniform(0.0, 0.01, P), dev),
        key=_t(rng.uniform(0.0, 0.1, P), dev),
        plan=plan, lqc=5e-6)
    tables = (_t(mt_vec, dev), _t(beta, dev), _t(mem_cap, dev),
              _t(ncr, dev), KAPPA)
    return seg, tables


MUTABLE = ("st_ok", "st_sa", "st_f", "st_wait", "ok", "cm", "key")


def copy_of(seg) -> "wk.RewalkSegment":
    """``seg`` with fresh copies of the columns a re-walk rewrites."""
    return seg._replace(**{k: getattr(seg, k).clone() for k in MUTABLE})


def bits(x) -> np.ndarray:
    """A float64 tensor or list as its bit patterns, NaNs made one."""
    a = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x,
                   dtype=np.float64).copy()
    a[np.isnan(a)] = np.nan
    return a.view(np.int64)
