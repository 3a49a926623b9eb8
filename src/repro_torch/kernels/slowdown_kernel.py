"""Slowdown factor aggregation (H-EYE section 3.4), in three forms.

    factor[i] = max(1, (1 + mt_term[i])
                       * prod_r(1 + beta[r]*x[i,r]*(1+kappa*x[i,r]) * mem[i]))

Replaces the TPU kernel ``repro/kernels/slowdown_kernel.py``
(``slowdown_factors_pallas`` / ``_factors_kernel``), which computes in
float32 over 256-row tiles with the class axis padded to the lane width,
from pressure rows the host built around it.  Here the kernels are CUDA
C++ in float64 (``csrc/slowdown_factors.cu``), every product and sum
rounded on its own and the product taken in ascending class order, so
each agrees with its plain version to the bit:

* **row** (:func:`slowdown_factors`): the formula over given ``(N, R)``
  pressure rows, one thread per row.  ``factors_with_candidates_idx``
  (the traverser's dense what-if check) calls it.
* **pool** (:func:`slowdown_pool`): the joint factor of every member of a
  co-running pool, the pressures built in the kernel from the ledger
  columns and the member indices: member ``i`` walks ``j = 0..n-1`` in
  ascending order, adds ``U[j]`` to its tenancy pressure where the PUs are
  equal and ``min(memraw[j], mem_cap[P[j]])`` to class
  ``ncr_rclass[P[i], P[j]]`` elsewhere (where that class is >= 0).  The
  DES repricing (``factor_batch_idx``) calls it with the engine's job
  columns and the pool's rows.
* **same-device** (:func:`slowdown_same_device`): the walk's
  block-diagonal constraint check over a ragged stack of newcomers (one
  block each): per candidate the newcomer's factor against the actives of
  the candidate's device segment, per active its base pressures over its
  own segment, and per (candidate, active) pair the active's factor if
  the newcomer joins.  ``factors_same_device_multi`` calls it once per
  wave depth.

Pressures are summed sequentially in ledger order (the order of the
reference's ``np.bincount`` / ``np.add.at``); no atomics.  Any number of
resource classes is taken, as the reference takes it: up to 16 the
kernels keep a row's pressures in registers, above it in a strided
scratch the wrapper allocates at the size the C side asks for (same sums,
same order).
All three are bound by launch latency at the scheduler's sizes (bytes
beyond that).

The wrappers take the plain version for CPU tensors and launch the kernel
for CUDA tensors (or raise: there is no fallback).
"""
from __future__ import annotations

import functools
import struct
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..device import host_list, nonzero
from .. import spans
from ..spans import OPEN as _SPANS
from . import build

# launches per form: the row kernel, the pool form, the same-device form
launches = {"slowdown_factors": 0, "slowdown_pool": 0,
            "slowdown_same_device": 0}

_F64 = torch.float64
_I64 = torch.int64


# ---------------------------------------------------------------------------
# plain PyTorch versions (float64)
# ---------------------------------------------------------------------------
def pressure_term(beta: torch.Tensor, x: torch.Tensor,
                  kappa: float) -> torch.Tensor:
    """beta*x*(1+kappa*x), 0 where inactive (broadcasts beta against x)."""
    return torch.where((x > 0.0) & (beta > 0.0),
                       beta * x * (1.0 + kappa * x), torch.zeros_like(x))


def slowdown_factors_plain(x: torch.Tensor, beta: torch.Tensor,
                           mem: torch.Tensor, mt_term: torch.Tensor,
                           kappa: float) -> torch.Tensor:
    """Plain PyTorch version (float64) of the factor aggregation; the
    product runs over the classes in ascending order, one op at a time."""
    prod = torch.ones_like(mem)
    for r in range(x.shape[1]):
        prod = prod * (1.0 + pressure_term(beta[r], x[:, r], kappa) * mem)
    return torch.maximum((1.0 + mt_term) * prod, torch.ones_like(mt_term))


def ordered_sums(rows: torch.Tensor, cols: torch.Tensor,
                 within: torch.Tensor, vals: torch.Tensor,
                 n_rows: int, n_cols: int, width: int) -> torch.Tensor:
    """``out[rows[k], cols[k]] += vals[k]`` accumulated in ascending ``k``
    per row, where ``within[k]`` is pair ``k``'s position inside its
    row's run (rows arrive in contiguous runs of at most ``width``).

    The pairs are laid out densely as ``(n_rows, n_cols, width)`` (unique
    slots, so the scatter is a plain store) and summed column by column:
    a sequential sum in input order, without atomics — exact zeros in
    unused slots leave every partial sum untouched."""
    dense = torch.zeros((n_rows, n_cols, width), dtype=_F64,
                        device=vals.device)
    dense[rows, cols, within] = vals
    acc = torch.zeros((n_rows, n_cols), dtype=_F64, device=vals.device)
    for k in range(width):
        acc = acc + dense[:, :, k]
    return acc


def slowdown_pool_plain(members, pu_i, U, memraw, uid, mem_cap, ncr_rclass,
                        mt_vec, beta, kappa: float,
                        distinct: bool) -> torch.Tensor:
    """Plain version of :func:`slowdown_pool`: the pool's (n, n) pair
    table, summed over ``j`` in ascending order per member."""
    dev = members.device
    P = pu_i[members]
    Up = U[members]
    M = torch.minimum(memraw[members], mem_cap[P])
    n = P.shape[0]
    R = beta.shape[0]
    same = P[:, None] == P[None, :]
    r = ncr_rclass[P[:, None], P[None, :]].to(_I64)
    if distinct:
        other = ~torch.eye(n, dtype=torch.bool, device=dev)
    else:
        u = uid[members]
        other = u[:, None] != u[None, :]
    # class columns 0..R-1 carry memory pressure, column R the same-PU
    # tenancy pressure
    col = torch.where(same, torch.full_like(r, R), r.clamp(min=0))
    val = torch.where(other & same, Up[None, :].expand(n, n),
                      torch.where(other & (r >= 0), M[None, :].expand(n, n),
                                  torch.zeros((), dtype=_F64, device=dev)))
    ar = torch.arange(n, device=dev)
    acc = ordered_sums(ar.repeat_interleave(n), col.reshape(-1),
                       ar.repeat(n), val.reshape(-1), n, R + 1, n)
    mt_term = pressure_term(mt_vec[P], acc[:, R], kappa) * Up
    return slowdown_factors_plain(acc[:, :R], beta, M, mt_term, kappa)


def device_summary(Dc: torch.Tensor, astart: torch.Tensor,
                   na: torch.Tensor) -> tuple[int, bool, int, int]:
    """(first candidate device ordinal, whether every candidate sits on
    it, that device's ledger segment start, its length) — the host facts
    the single-device paths branch on, in one copy."""
    d0 = Dc[0]
    d0v, single, s, n_dev = host_list(torch.stack(
        [d0, (Dc == d0).all().to(_I64), astart[d0], na[d0]]))
    return d0v, bool(single), s, n_dev


class SameDeviceItem(NamedTuple):
    """One newcomer of a same-device check: its candidates' PU indices
    and device ordinals, its usages and uid, the device-sorted ledger
    view (``Da`` ascending, ``astart`` / ``na`` the per-device-ordinal
    segments) and ``summ``, :func:`device_summary` of them."""
    Pc: torch.Tensor
    Dc: torch.Tensor
    u_new: float
    mem_new: float
    uid_new: int
    Pa: torch.Tensor
    Ua: torch.Tensor
    Ma: torch.Tensor
    uid_a: torch.Tensor
    Da: torch.Tensor
    astart: torch.Tensor
    na: torch.Tensor
    summ: tuple


def _trivial(C: int, dev) -> tuple:
    empty = torch.zeros(0, dtype=_I64, device=dev)
    return (torch.ones(C, dtype=_F64, device=dev), empty, empty,
            torch.ones(0, dtype=_F64, device=dev))


def _same_device_item_plain(it: SameDeviceItem, mt_vec, beta, mem_cap,
                            ncr_rclass, kappa: float) -> tuple:
    """One item of :func:`slowdown_same_device_plain`: the pairs laid out
    candidate by candidate, each over its device segment in ledger order,
    and every pressure summed in that order."""
    dev = it.Pc.device
    C = it.Pc.shape[0]
    A = it.Pa.shape[0]
    R = beta.shape[0]
    Pc, Pa, Ua, Ma, uid_a, na, astart = (it.Pc, it.Pa, it.Ua, it.Ma,
                                         it.uid_a, it.na, it.astart)
    Mc = torch.clamp_max(mem_cap[Pc], it.mem_new)

    def segment_pairs(left_ids, left_dev):
        """(li, ri, within, width): cross product of each left element
        with the active rows of its device; ``within`` numbers a left
        element's pairs."""
        rep = na[left_dev]
        K, width = host_list(torch.stack([rep.sum(), rep.max()]))
        if K == 0:
            return None
        li = torch.repeat_interleave(left_ids, rep, output_size=K)
        offs = torch.cumsum(rep, 0) - rep
        within = torch.arange(K, device=dev) - torch.repeat_interleave(
            offs, rep, output_size=K)
        ri = torch.repeat_interleave(astart[left_dev], rep,
                                     output_size=K) + within
        return li, ri, within, width

    pairs = segment_pairs(torch.arange(C, device=dev), it.Dc)
    if pairs is None:
        return _trivial(C, dev)
    ci, ai, within_c, width_c = pairs
    # --- the new task's factor per candidate ------------------------------
    live = uid_a[ai] != it.uid_new
    Pci, Pai = Pc[ci], Pa[ai]
    same = (Pci == Pai) & live
    r_ca = ncr_rclass[Pci, Pai].to(_I64)
    validc = live & (Pci != Pai) & (r_ca >= 0)
    zero_k = torch.zeros(ci.shape[0], dtype=_F64, device=dev)
    col_c = torch.where(same, torch.full_like(r_ca, R), r_ca.clamp(min=0))
    val_c = torch.where(same, Ua[ai], torch.where(validc, Ma[ai], zero_k))
    acc_c = ordered_sums(ci, col_c, within_c, val_c, C, R + 1, width_c)
    mt_term_c = pressure_term(mt_vec[Pc], acc_c[:, R], kappa) * it.u_new
    new_f = slowdown_factors_plain(acc_c[:, :R], beta, Mc, mt_term_c, kappa)

    # --- each same-device active's factor if the task joins ---------------
    # base pressures only for actives on candidate devices: the rest never
    # appear in a (candidate, active) pair
    _, single, s0, n0 = it.summ
    if single:
        act_sel = torch.arange(s0, s0 + n0, device=dev)
    else:
        act_sel = nonzero(torch.isin(it.Da, it.Dc))
    a1, a2, within_a, width_a = segment_pairs(act_sel, it.Da[act_sel])
    diff = uid_a[a1] != uid_a[a2]
    sameP = (Pa[a1] == Pa[a2]) & diff
    r_aa = ncr_rclass[Pa[a1], Pa[a2]].to(_I64)
    valida = diff & (Pa[a1] != Pa[a2]) & (r_aa >= 0)
    zero_a = torch.zeros(a1.shape[0], dtype=_F64, device=dev)
    col_a = torch.where(sameP, torch.full_like(r_aa, R), r_aa.clamp(min=0))
    val_a = torch.where(sameP, Ua[a2], torch.where(valida, Ma[a2], zero_a))
    acc_a = ordered_sums(a1, col_a, within_a, val_a, A, R + 1, width_a)
    Xp = acc_a[ai, :R]                     # (K, R): base + join term
    r_ac = ncr_rclass[Pai, Pci].to(_I64)
    jc = live & (Pai != Pci) & (r_ac >= 0)
    # one slot per pair row: a plain indexed add, no collisions
    Xp.scatter_add_(1, r_ac.clamp(min=0)[:, None],
                    torch.where(jc, Mc[ci], zero_k)[:, None])
    mt_p = acc_a[ai, R] + same.to(_F64) * it.u_new
    mt_term_p = pressure_term(mt_vec[Pai], mt_p, kappa) * Ua[ai]
    act_pf = slowdown_factors_plain(Xp, beta, Ma[ai], mt_term_p, kappa)
    return new_f, ci, ai, act_pf


def slowdown_same_device_plain(items: Sequence[SameDeviceItem], mt_vec,
                               beta, mem_cap, ncr_rclass,
                               kappa: float) -> list:
    """Plain version of :func:`slowdown_same_device`, item by item."""
    return [_same_device_item_plain(it, mt_vec, beta, mem_cap, ncr_rclass,
                                    kappa) for it in items]


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def slowdown_factors(x: torch.Tensor, beta: torch.Tensor, mem: torch.Tensor,
                     mt_term: torch.Tensor, kappa: float) -> torch.Tensor:
    """(N, R) pressures -> (N,) factors."""
    sp = spans.enter("launch.slowdown_factors") if _SPANS else None
    try:
        dev = x.device
        build.check_tensor("x", x, _F64, 2, dev)
        build.check_tensor("beta", beta, _F64, 1, dev)
        build.check_tensor("mem", mem, _F64, 1, dev)
        build.check_tensor("mt_term", mt_term, _F64, 1, dev)
        n, r = x.shape
        if beta.shape[0] != r or mem.shape[0] != n or mt_term.shape[0] != n:
            raise ValueError(
                "shape mismatch: x %s beta %s mem %s mt_term %s" % (
                tuple(x.shape), tuple(beta.shape), tuple(mem.shape),
                tuple(mt_term.shape)))
        if dev.type == "cpu":
            return slowdown_factors_plain(x, beta, mem, mt_term, kappa)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        out = torch.empty(n, dtype=_F64, device=dev)
        if n == 0:
            return out
        lib = build.load()
        with torch.cuda.device(dev):
            err = lib.heye_slowdown_factors(
                x.data_ptr(), beta.data_ptr(), mem.data_ptr(),
                mt_term.data_ptr(), out.data_ptr(), n, r, float(kappa),
                torch.cuda.current_stream().cuda_stream)
        build.check_launch(err, "slowdown_factors")
        build.count_launch(launches, "slowdown_factors")
        return out
    finally:
        if sp:
            spans.leave(sp)


def _check_tables(mem_cap, ncr_rclass, mt_vec, beta, dev) -> tuple[int, int]:
    """(PUs, classes) of the snapshot tables, or raise."""
    build.check_tensors(dev, ("mem_cap", mem_cap, _F64, 1),
                        ("ncr_rclass", ncr_rclass, torch.int16, 2),
                        ("mt_vec", mt_vec, _F64, 1), ("beta", beta, _F64, 1))
    nP = mem_cap.shape[0]
    R = beta.shape[0]
    if tuple(ncr_rclass.shape) != (nP, nP) or mt_vec.shape[0] != nP:
        raise ValueError(f"snapshot tables disagree: mem_cap {nP}, "
                         f"ncr_rclass {tuple(ncr_rclass.shape)}, mt_vec "
                         f"{mt_vec.shape[0]}")
    return nP, R


def _wide_scratch(length: int, dev) -> tuple:
    """(tensor, pointer) of a launch's class scratch of ``length`` doubles,
    the size the C side's query gives (0 where the pressures fit in
    registers: no scratch).  The caller holds the tensor until the launch
    is queued."""
    if length == 0:
        return None, None
    buf = torch.empty(length, dtype=_F64, device=dev)
    return buf, buf.data_ptr()


def slowdown_pool(members: torch.Tensor, pu_i: torch.Tensor, U: torch.Tensor,
                  memraw: torch.Tensor, uid: torch.Tensor,
                  mem_cap: torch.Tensor, ncr_rclass: torch.Tensor,
                  mt_vec: torch.Tensor, beta: torch.Tensor, kappa: float,
                  distinct: bool) -> torch.Tensor:
    """Joint factors of the pool ``members`` (rows of the ledger-style
    columns ``pu_i`` / ``U`` / ``memraw`` / ``uid``), each against all the
    others: ``distinct`` pools skip only the member itself, the others
    every member of equal uid.  Returns (n,) float64."""
    sp = spans.enter("launch.slowdown_pool") if _SPANS else None
    try:
        dev = members.device
        build.check_tensors(dev, ("members", members, _I64, 1),
                            ("pu_i", pu_i, _I64, 1), ("U", U, _F64, 1),
                            ("memraw", memraw, _F64, 1), ("uid", uid, _I64, 1))
        _check_tables(mem_cap, ncr_rclass, mt_vec, beta, dev)
        rows = pu_i.shape[0]
        if (U.shape[0] != rows or memraw.shape[0] != rows
                or uid.shape[0] != rows):
            raise ValueError("pu_i, U, memraw and uid must have one length")
        kappa = float(kappa)
        if dev.type == "cpu":
            return slowdown_pool_plain(members, pu_i, U, memraw, uid, mem_cap,
                                       ncr_rclass, mt_vec, beta, kappa,
                                       bool(distinct))
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        n = members.shape[0]
        out = torch.empty(n, dtype=_F64, device=dev)
        if n == 0:
            return out
        R = beta.shape[0]
        lib = build.load()
        wide_len = lib.heye_slowdown_pool_wide_len(n, R)
        _keep, wide = _wide_scratch(wide_len, dev)
        with torch.cuda.device(dev):
            err = lib.heye_slowdown_pool(
                members.data_ptr(), n, pu_i.data_ptr(), U.data_ptr(),
                memraw.data_ptr(), uid.data_ptr(), mem_cap.data_ptr(),
                ncr_rclass.data_ptr(), mem_cap.shape[0], mt_vec.data_ptr(),
                beta.data_ptr(), R, kappa, int(bool(distinct)),
                out.data_ptr(), wide, wide_len,
                torch.cuda.current_stream().cuda_stream)
        build.check_launch(err, "slowdown_pool")
        build.count_launch(launches, "slowdown_pool")
        return out
    finally:
        if sp:
            spans.leave(sp)


# one int64 row per launched item (csrc/slowdown_factors.cu, SD_* fields)
SD_FIELDS = ("Pc", "Dc", "Pa", "Ua", "Ma", "uid_a", "Da", "astart", "na",
             "cs", "C", "A", "nd", "single", "s0", "n0", "u_new", "mem_new",
             "uid_new", "newf_off", "pair_off", "K", "base_off", "base_lo",
             "flag_off")
_SD_TENSORS = (("Pc", _I64), ("Dc", _I64), ("Pa", _I64), ("Ua", _F64),
               ("Ma", _F64), ("uid_a", _I64), ("Da", _I64),
               ("astart", _I64), ("na", _I64))


@functools.lru_cache(maxsize=256)
def _f64_bits(v: float) -> int:
    return struct.unpack("<q", struct.pack("<d", v))[0]


def _check_item(it: SameDeviceItem, dev) -> None:
    build.check_tensors(dev, *((name, getattr(it, name), dtype, 1)
                               for name, dtype in _SD_TENSORS))
    C, A = it.Pc.shape[0], it.Pa.shape[0]
    if (it.Dc.shape[0] != C or it.astart.shape[0] != it.na.shape[0]
            or it.Ua.shape[0] != A or it.Ma.shape[0] != A
            or it.uid_a.shape[0] != A or it.Da.shape[0] != A):
        raise ValueError("a same-device item's columns disagree in length")


def same_device_layout(items: Sequence[SameDeviceItem], K: Sequence[int],
                       R: int, cs: Sequence) -> tuple[list, tuple]:
    """The kernel's item rows (``SD_FIELDS``, pointers as integers) for the
    items with pairs, and the totals ``(factors, pairs, base doubles,
    flags)`` of the buffers they index: each item's factors, pair rows,
    base pressures (``R + 1`` per active of its device segment, or per
    active of its view when its candidates span devices) and device flags
    (several-device items) follow the previous item's."""
    rows = []
    nf = pairs = base = flags = 0
    for it, k, c in zip(items, K, cs):
        C, A = it.Pc.shape[0], it.Pa.shape[0]
        _, single, s0, n0 = it.summ
        nd = it.na.shape[0]
        rows.append([*(getattr(it, name).data_ptr()
                       for name, _ in _SD_TENSORS),
                     0 if single else c.data_ptr(), C, A, nd, int(single),
                     s0, n0, _f64_bits(it.u_new), _f64_bits(it.mem_new),
                     it.uid_new, nf, pairs, k, base, s0 if single else 0,
                     flags])
        nf += C
        pairs += k
        base += (R + 1) * (n0 if single else A)
        flags += 0 if single else nd
    return rows, (nf, pairs, base, flags)


def split_stack(rows: list, new_f, ci, ai, act_pf) -> list:
    """Each item's ``(new_f, ci, ai, act_pf)``: views of the stacked
    buffers at the offsets of its row."""
    iC, iN, iP, iK = (SD_FIELDS.index(f) for f in ("C", "newf_off",
                                                     "pair_off", "K"))
    out = []
    for r in rows:
        o, p = r[iN], r[iP]
        out.append((new_f[o:o + r[iC]], ci[p:p + r[iK]], ai[p:p + r[iK]],
                    act_pf[p:p + r[iK]]))
    return out


def slowdown_same_device(items: Sequence[SameDeviceItem], mt_vec, beta,
                         mem_cap, ncr_rclass, kappa: float) -> list:
    """The same-device constraint check of every item in one launch.
    Returns per item ``(new_f, ci, ai, act_pf)``: the newcomer's factor per
    candidate, and the flat (candidate, active) pairs — candidates in
    order, each with the actives of its device segment in ledger order —
    where ``act_pf[k]`` is the factor of active ``ai[k]`` if the newcomer
    joins candidate ``ci[k]``.  An item with no such pair gets factors of
    1 and no pairs.  On the card, one host read for all the items whose
    candidates span devices (their pair counts) and one launch."""
    sp = spans.enter("launch.slowdown_same_device") if _SPANS else None
    try:
        dev = mem_cap.device
        _, R = _check_tables(mem_cap, ncr_rclass, mt_vec, beta, dev)
        for it in items:
            _check_item(it, dev)
        kappa = float(kappa)
        if dev.type == "cpu":
            return slowdown_same_device_plain(items, mt_vec, beta, mem_cap,
                                              ncr_rclass, kappa)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        out: list = [None] * len(items)
        K = [0] * len(items)
        cs: list = [None] * len(items)
        multi = []
        for i, it in enumerate(items):
            C, A = it.Pc.shape[0], it.Pa.shape[0]
            if C == 0 or A == 0:
                continue
            if it.summ[1]:
                K[i] = C * it.summ[3]
            else:
                # pairs end per candidate at cs (inclusive)
                cs[i] = torch.cumsum(it.na[it.Dc], 0)
                multi.append(i)
        if multi:
            for i, k in zip(multi, host_list(
                    torch.stack([cs[i][-1] for i in multi]))):
                K[i] = k
        run = [i for i in range(len(items)) if K[i]]
        for i in range(len(items)):
            if not K[i]:
                out[i] = _trivial(items[i].Pc.shape[0], dev)
        if not run:
            return out
        rows, (nf, pairs, base, flags) = same_device_layout(
            [items[i] for i in run], [K[i] for i in run], R,
            [cs[i] for i in run])
        tab = torch.tensor(rows, dtype=_I64).to(dev)
        new_f = torch.empty(nf, dtype=_F64, device=dev)
        ci = torch.empty(pairs, dtype=_I64, device=dev)
        ai = torch.empty(pairs, dtype=_I64, device=dev)
        act_pf = torch.empty(pairs, dtype=_F64, device=dev)
        scratch = torch.empty(max(base, 1), dtype=_F64, device=dev)
        iscratch = torch.empty(max(flags, 1), dtype=torch.int32, device=dev)
        lib = build.load()
        wide_len = lib.heye_slowdown_same_device_wide_len(len(run), R)
        _keep, wide = _wide_scratch(wide_len, dev)
        with torch.cuda.device(dev):
            err = lib.heye_slowdown_same_device(
                tab.data_ptr(), len(run), len(SD_FIELDS),
                ncr_rclass.data_ptr(), mem_cap.shape[0], mt_vec.data_ptr(),
                mem_cap.data_ptr(), beta.data_ptr(), R, kappa,
                new_f.data_ptr(), ci.data_ptr(), ai.data_ptr(),
                act_pf.data_ptr(), scratch.data_ptr(), iscratch.data_ptr(),
                wide, wide_len,
                torch.cuda.current_stream().cuda_stream)
        build.check_launch(err, "slowdown_same_device")
        build.count_launch(launches, "slowdown_same_device")
        for i, res in zip(run, split_stack(rows, new_f, ci, ai, act_pf)):
            out[i] = res
        return out
    finally:
        if sp:
            spans.leave(sp)
