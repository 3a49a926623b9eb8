"""Decoupled shared-resource slowdown models (paper §3.4).

The paper's accuracy insight: *decouple* standalone performance from the
slowdown caused by shared-resource use.  Once per system, each shareable
resource is characterized for the slowdown it induces per amount of
concurrent use; each task is characterized by its generalized usage of each
resource; at runtime ``slowdown()`` combines the two.

Two contention mechanisms (paper §2.2, Fig. 2):

* **Shared-memory contention across PUs** — discovered via the HW-GRAPH:
  the *nearest common resource* on the two PUs' compute paths is the
  contention point (two cores in one cluster meet at L2; cores in
  different clusters meet at L3; GPU and DLA meet at DRAM).

* **Multi-tenancy on one PU** — co-tenant tasks on the same PU slow each
  other down by a PU-class-specific factor.

Calibration reproduces the paper's Orin AGX measurements:
  same-cluster CPU MMs (L2)          -> 0.91x   => beta_l2  = 0.099
  cross-cluster CPU MMs (L3)         -> 0.87x   => beta_l3  = 0.149
  2 DNNs on one GPU (multi-tenancy)  -> 0.66x   => mt_gpu   = 0.515
  GPU + DLA via shared DRAM          -> 0.68x   => beta_dram= 0.47
  CPU + GPU via shared 4MB LLC       -> 0.89x   => beta_llc = 0.124

Batched evaluation: the vectorized entry points evaluate whole pools at
once over the ``CompiledHWGraph`` tensors — ``factor_batch`` /
``factor_batch_idx`` (joint factors of a co-running pool, the DES
repricing call), ``slowdown_matrix`` (all pairwise co-run factors),
``factors_with_candidates`` and the block-diagonal
``factors_same_device(_multi)`` (the Orchestrator's constraint checks).
Each ends in a form of the factor kernel
(``kernels.slowdown_kernel``: float64 CUDA kernels for tensors on the
card, their plain versions for tensors on the CPU): the pool form and
the same-device form build their pressures in the kernel from the
ledger columns, the row form aggregates the dense check's rows.

Reproducibility: pressure sums are built in a **fixed order** — a
sequential sum in ascending co-runner (ledger) order, the order of the
reference's ``np.bincount`` / ``np.add.at``.  No atomics are involved,
so results do not change from run to run, and the decisions that read
them (placements) are the same on the card and on the CPU.

Randomness: the only draw is ``_apply_noise`` — one host scalar per
noisy ``factor()`` call from the ``numpy.random.Generator`` the caller
passed in, in call order.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import FLOAT, INT, bytes_key, f64, host_list, i64
from ..kernels.slowdown_kernel import (SameDeviceItem, pressure_term,
                                       slowdown_factors, slowdown_pool,
                                       slowdown_same_device)
from .hwgraph import HWGraph
from .task import Task

# resource classes a STORAGE/CONTROLLER node may declare in attrs["rclass"]
RCLASSES = ("l2", "l3", "llc", "sram", "dram", "hbm", "vmem", "nic")

# beta for rclasses absent from SlowdownParams.beta
_DEFAULT_BETA = 0.3

# host-resident pools at or below this size take the exact scalar loop in
# ``factor_batch_idx`` (element reads are free on the host and the scalar
# sums replicate the array path's order); pools on the card always take
# the array path + kernel, where every element read would be a copy
_SMALL_POOL_MAX = 7


@dataclass
class SlowdownParams:
    # sensitivity of each resource class to one unit of co-runner pressure,
    # normalized so that beta * 1.12 reproduces Fig. 2 at x=1 co-runner
    beta: dict[str, float] = field(default_factory=lambda: {
        "l2": 0.0884, "l3": 0.1330, "llc": 0.1107, "sram": 0.1786,
        "dram": 0.4196, "hbm": 0.2679, "vmem": 0.0, "nic": 0.0893,
    })
    # multi-tenancy sensitivity per PU class
    mt_beta: dict[str, float] = field(default_factory=lambda: {
        "cpu": 0.3125, "gpu": 0.4598, "dla": 0.3571, "vic": 0.2232,
        "pva": 0.2679, "tpu": 0.4018, "default": 0.3571,
    })
    superlinear: float = 0.12   # kappa: factor term beta*x*(1+kappa*x)
    noise: float = 0.0          # rel. sigma of task-irregularity noise (truth only)

    def mt(self, pu_class: str) -> float:
        return self.mt_beta.get(pu_class, self.mt_beta["default"])


def heye_params() -> SlowdownParams:
    """The calibrated model H-EYE's Traverser uses for prediction (same
    superlinear shape as the profiled system, no irregular-access noise)."""
    return SlowdownParams(superlinear=0.12)


def truth_params(noise: float = 0.035, superlinear: float = 0.12) -> SlowdownParams:
    """Ground-truth behaviour: profiled contention + irregular-access noise."""
    return SlowdownParams(superlinear=superlinear, noise=noise)


# ---------------------------------------------------------------------------
# batched factor aggregation
# ---------------------------------------------------------------------------
def _aggregate(x, beta, mem, mt_term, kappa):
    """Factor aggregation over dense pressure rows: the row form of the
    factor kernel (CUDA for tensors on the card, its plain version on the
    CPU)."""
    return slowdown_factors(x.contiguous(), beta.contiguous(),
                            mem.contiguous(), mt_term.contiguous(), kappa)


class DecoupledSlowdown:
    """slowdown(task on pu | co-running tasks) -> multiplicative factor >= 1."""

    def __init__(self, graph: HWGraph, params: Optional[SlowdownParams] = None,
                 rng: Optional[np.random.Generator] = None) -> None:
        self.graph = graph
        self.device = graph.device      # raises without CUDA unless "cpu"
        self.params = params or heye_params()
        self.rng = rng
        # (snapshot, (beta_vec, mt_vec)) — rebuilt when the graph compiles
        # a new snapshot
        self._tables_cache: Optional[tuple] = None
        # canonical-pattern result cache for single-device constraint
        # checks (see _canon_key), keyed per snapshot identity (kin delta
        # clones are rebased, see _factor_kin)
        self._canon_cache: Optional[tuple] = None
        self.factor_cache_hits = 0
        self.factor_cache_misses = 0
        self._counter_lock = threading.Lock()

    # -- helpers -----------------------------------------------------------
    def nearest_shared(self, pu_a: str, pu_b: str) -> Optional[str]:
        """Nearest common resource on the compute paths of two PUs (or None
        if the PUs share nothing, e.g. they sit in different devices)."""
        return self.graph.compiled().nearest_common_resource(pu_a, pu_b)

    def invalidate(self) -> None:
        self._tables_cache = None
        self._canon_cache = None

    def _pressure_term(self, beta: float, x: float) -> float:
        if x <= 0.0 or beta <= 0.0:
            return 0.0
        return beta * x * (1.0 + self.params.superlinear * x)

    def _mem_usage(self, task: Task, pu_name: str) -> float:
        """Effective shared-memory pressure of ``task`` when run on ``pu``.
        PUs with private data storage (e.g. VIC, §5.3.1) cap it."""
        u = task.usage.get("mem", 1.0)
        cap = self.graph.nodes[pu_name].attrs.get("mem_usage_cap")
        return min(u, cap) if cap is not None else u

    # -- per-snapshot model tables ----------------------------------------
    @staticmethod
    def _factor_state(comp) -> tuple:
        """The snapshot columns the factor model reads.  Two snapshots
        whose columns are the *same objects* (a bandwidth-only delta clone
        shares everything but the route table) are kin: cached device
        tables and canonical factors carry over verbatim."""
        return (comp.rclass_names, comp.pu_class_kind,
                getattr(comp, "ncr_rclass", None),
                getattr(comp, "mem_cap", None),
                getattr(comp, "pu_index", None))

    @classmethod
    def _factor_kin(cls, a, b) -> bool:
        return all(x is y for x, y in
                   zip(cls._factor_state(a), cls._factor_state(b)))

    def _tables(self, comp) -> tuple[torch.Tensor, torch.Tensor]:
        """(beta per compiled rclass, mt-beta per compiled PU) on the
        snapshot's device; cached per snapshot identity, so a topology
        mutation (new snapshot) rebuilds them.  A kin delta clone is
        rebased onto the cached tables, not rebuilt."""
        cached = self._tables_cache
        if cached is not None and cached[0] is not comp \
                and self._factor_kin(cached[0], comp):
            cached = (comp, cached[1])
            self._tables_cache = cached
        if cached is None or cached[0] is not comp:
            p = self.params
            beta_vec = f64([p.beta.get(rc, _DEFAULT_BETA)
                            for rc in comp.rclass_names], comp.device)
            mt_vec = f64([p.mt_beta.get(cls, p.mt_beta["default"])
                          for cls in comp.pu_class_kind], comp.device)
            cached = (comp, (beta_vec, mt_vec))
            self._tables_cache = cached
        return cached[1]

    def _pool_arrays(self, comp, pool: Sequence[tuple[Task, str]]):
        dev = comp.device
        P = i64([comp.pu_index[p] for _, p in pool], dev)
        U = f64([t.usage.get("pu", 1.0) for t, _ in pool], dev)
        mem = f64([t.usage.get("mem", 1.0) for t, _ in pool], dev)
        M = torch.minimum(mem, comp.mem_cap[P])
        uid = i64([t.uid for t, _ in pool], dev)
        return P, U, M, uid

    def _noisy(self) -> bool:
        return self.params.noise > 0.0 and self.rng is not None

    def _apply_noise(self, task: Task, f: float) -> float:
        irregularity = task.attrs.get("irregularity", 1.0)
        return f * float(np.exp(self.rng.normal(
            0.0, self.params.noise * irregularity)))

    # -- the model (scalar reference path, host Python) ---------------------
    def factor(self, task: Task, pu_name: str,
               coruns: list[tuple[Task, str]]) -> float:
        """Multiplicative slowdown of ``task`` running on ``pu_name`` while
        each (other_task, other_pu) in ``coruns`` runs concurrently."""
        p = self.params
        f = 1.0
        pu = self.graph.nodes[pu_name]
        pu_class = pu.attrs.get("pu_class_kind", pu.attrs.get("pu_class", "default"))
        mt_pressure = 0.0
        res_pressure: dict[str, float] = {}
        for other, other_pu in coruns:
            if other.uid == task.uid:
                continue
            if other_pu == pu_name:
                mt_pressure += other.usage.get("pu", 1.0)
            else:
                shared = self.nearest_shared(pu_name, other_pu)
                if shared is None:
                    continue
                rclass = self.graph.nodes[shared].attrs.get("rclass", "dram")
                res_pressure[rclass] = (res_pressure.get(rclass, 0.0)
                                        + self._mem_usage(other, other_pu))
        if mt_pressure > 0.0:
            f *= 1.0 + self._pressure_term(p.mt(pu_class), mt_pressure
                                           ) * task.usage.get("pu", 1.0)
        for rclass, x in res_pressure.items():
            f *= 1.0 + self._pressure_term(p.beta.get(rclass, _DEFAULT_BETA), x
                                           ) * self._mem_usage(task, pu_name)
        if p.noise > 0.0 and self.rng is not None and f > 1.0:
            f = self._apply_noise(task, f)
        return max(1.0, f)

    # -- vectorized entry points -------------------------------------------
    def factor_batch(self, pool: Sequence[tuple[Task, str]]) -> torch.Tensor:
        """Joint slowdown factor of every (task, pu) in ``pool`` given all
        the others.  Matches ``factor(t, p, pool)`` per entry to 1e-9."""
        n = len(pool)
        if n == 0:
            return torch.ones(0, dtype=FLOAT, device=self.device)
        if self._noisy():
            # the scalar path draws rng noise per factor call in pool
            # order; preserve the exact stream
            return f64([self.factor(t, p, list(pool)) for t, p in pool],
                       self.device)
        comp = self.graph.compiled()
        P, U, M, uid = self._pool_arrays(comp, pool)
        return self._factor_batch_arrays(comp, P, U, M, uid)

    def factor_batch_idx(self, P: torch.Tensor, U: torch.Tensor,
                         mem: torch.Tensor, uid: torch.Tensor,
                         members: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """Array-native :meth:`factor_batch` over ledger-style columns
        (compiled PU index, pu-usage, raw mem-usage, uid) — the DES
        timeline engine reprices every dirty device pool in one call
        through this entry, passing its whole job columns and the pool's
        rows as ``members`` (the pool form of the factor kernel gathers
        them itself); without ``members`` the pool is every row.  Compute
        paths never cross device boundaries, so a pool spanning several
        devices factors exactly as the per-device pools would.  Noise-free
        path only."""
        dev = P.device
        n = P.shape[0] if members is None else members.shape[0]
        if n <= 1:
            return torch.ones(n, dtype=FLOAT, device=dev)
        comp = self.graph.compiled()
        if not P.is_cuda and n <= _SMALL_POOL_MAX:
            if members is not None:
                P, U, mem = P[members], U[members], mem[members]
            return self._factor_small(comp, P, U,
                                      torch.minimum(mem, comp.mem_cap[P]))
        if members is None:
            members = torch.arange(n, device=dev)
        # DES pools hold one job per task, so uids are pairwise distinct:
        # self-interaction reduces to the member itself
        return self._pool(comp, members, P, U, mem, uid, distinct=True)

    def _factor_small(self, comp, P, U, M) -> torch.Tensor:
        """Exact scalar path for distinct-uid pools of a few members.

        Pressure accumulation runs in ascending co-runner order and the
        per-rclass product in ascending rclass order — the orders the
        array path's reductions use (inactive rclasses multiply exact
        1.0s there and are simply skipped here)."""
        beta_vec, mt_vec = self._tables(comp)
        kappa = self.params.superlinear
        n = P.shape[0]
        Pi = host_list(P)
        Uf = host_list(U)
        Mf = host_list(M)
        rmat = host_list(comp.ncr_rclass[P[:, None], P[None, :]])
        mtb_l = host_list(mt_vec[P])
        beta_l = host_list(beta_vec)
        out = [1.0] * n
        for i in range(n):
            pi = Pi[i]
            mt_p = 0.0
            res: dict[int, float] = {}
            for j in range(n):
                if j == i:
                    continue
                if Pi[j] == pi:
                    mt_p += Uf[j]
                else:
                    r = rmat[i][j]
                    if r >= 0:
                        res[r] = res.get(r, 0.0) + Mf[j]
            mt_term = 0.0
            mtb = mtb_l[i]
            if mt_p > 0.0 and mtb > 0.0:
                mt_term = mtb * mt_p * (1.0 + kappa * mt_p) * Uf[i]
            prod = 1.0
            for r in sorted(res):
                x = res[r]
                b = beta_l[r]
                if x > 0.0 and b > 0.0:
                    prod *= 1.0 + b * x * (1.0 + kappa * x) * Mf[i]
            f = (1.0 + mt_term) * prod
            out[i] = f if f > 1.0 else 1.0
        return f64(out, P.device)

    def _factor_batch_arrays(self, comp, P, U, M, uid,
                             distinct: bool = False) -> torch.Tensor:
        """Joint factors of the pool of rows ``P`` / ``U`` / ``M`` / ``uid``
        (``M`` capped already: the kernel's cap leaves it as it is)."""
        return self._pool(comp, torch.arange(P.shape[0], device=P.device),
                          P, U, M, uid, distinct)

    def _pool(self, comp, members, P, U, mem, uid,
              distinct: bool) -> torch.Tensor:
        beta_vec, mt_vec = self._tables(comp)
        return slowdown_pool(members, P, U, mem, uid, comp.mem_cap,
                             comp.ncr_rclass, mt_vec, beta_vec,
                             self.params.superlinear, distinct)

    def slowdown_matrix(self, pool: Sequence[tuple[Task, str]]) -> torch.Tensor:
        """All pairwise co-run factors in one shot: entry [i, j] is the
        factor of pool[i] when co-running with pool[j] alone (1.0 on the
        diagonal / for non-interfering pairs)."""
        n = len(pool)
        if n == 0:
            return torch.ones((0, 0), dtype=FLOAT, device=self.device)
        if self._noisy():
            return f64([[self.factor(ti, pi, [(tj, pj)])
                         for tj, pj in pool] for ti, pi in pool], self.device)
        comp = self.graph.compiled()
        beta_vec, mt_vec = self._tables(comp)
        kappa = self.params.superlinear
        P, U, M, uid = self._pool_arrays(comp, pool)
        diff_uid = uid[:, None] != uid[None, :]
        same_pu = (P[:, None] == P[None, :]) & diff_uid
        r = comp.ncr_rclass[P[:, None], P[None, :]].to(INT)
        cross = diff_uid & (P[:, None] != P[None, :]) & (r >= 0)
        zero = torch.zeros((n, n), dtype=FLOAT, device=P.device)
        mt_f = 1.0 + pressure_term(mt_vec[P][:, None].expand(n, n),
                            torch.where(same_pu, U[None, :].expand(n, n), zero),
                            kappa) * U[:, None]
        res_term = torch.where(cross,
                               pressure_term(beta_vec[r.clamp(min=0)],
                                      M[None, :].expand(n, n), kappa),
                               zero)
        return torch.clamp_min(mt_f * (1.0 + res_term * M[:, None]), 1.0)

    def factors_with_candidates(
            self, task: Task, candidate_pus: Sequence[str],
            active: Sequence[tuple[Task, str]],
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One-shot Orchestrator constraint check over candidate PUs.

        Returns ``(new_f, act_f)`` where ``new_f[c]`` is the factor of
        ``task`` placed on ``candidate_pus[c]`` amid ``active``, and
        ``act_f[c, a]`` is the updated factor of ``active[a]`` if the task
        joins on candidate ``c`` (Alg. 1 line 15's re-check, for every
        candidate at once)."""
        C = len(candidate_pus)
        A = len(active)
        comp = self.graph.compiled()
        if self._noisy() or C == 0:
            new_f = f64([self.factor(task, p, list(active))
                         for p in candidate_pus], self.device)
            act = np.empty((C, A))
            for c, p in enumerate(candidate_pus):
                pool = list(active) + [(task, p)]
                for a, (t, q) in enumerate(active):
                    act[c, a] = self.factor(t, q, pool)
            return new_f, f64(act, self.device)
        Pc = i64([comp.pu_index[p] for p in candidate_pus], comp.device)
        Pa, Ua, Ma, uid_a = self._pool_arrays(comp, active)
        return self.factors_with_candidates_idx(comp, task, Pc,
                                                Pa, Ua, Ma, uid_a)

    def factors_with_candidates_idx(
            self, comp, task: Task, Pc: torch.Tensor, Pa: torch.Tensor,
            Ua: torch.Tensor, Ma: torch.Tensor, uid_a: torch.Tensor,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Array-native core of :meth:`factors_with_candidates` (dense
        C x A form).  Noise-free path only."""
        C = Pc.shape[0]
        A = Pa.shape[0]
        dev = Pc.device
        beta_vec, mt_vec = self._tables(comp)
        kappa = self.params.superlinear
        R = len(comp.rclass_names)
        u_new = task.usage.get("pu", 1.0)
        mem_new = task.usage.get("mem", 1.0)
        Mc = torch.clamp_max(comp.mem_cap[Pc], mem_new)
        if A == 0:
            return (torch.ones(C, dtype=FLOAT, device=dev),
                    torch.ones((C, 0), dtype=FLOAT, device=dev))
        live = uid_a != task.uid

        # --- the new task's factor under each candidate -------------------
        same_ca = (Pc[:, None] == Pa[None, :]) & live[None, :]     # (C, A)
        mt_c = same_ca.to(FLOAT) @ Ua
        r_ca = comp.ncr_rclass[Pc[:, None], Pa[None, :]]
        valid_ca = live[None, :] & (Pc[:, None] != Pa[None, :]) & (r_ca >= 0)
        Xc = torch.stack([(valid_ca & (r_ca == k)).to(FLOAT) @ Ma
                          for k in range(R)], dim=1)
        mt_term_c = pressure_term(mt_vec[Pc], mt_c, kappa) * u_new
        new_f = _aggregate(Xc, beta_vec, Mc, mt_term_c, kappa)

        # --- each active's factor if the task joins on candidate c --------
        diff_aa = uid_a[:, None] != uid_a[None, :]
        same_aa = (Pa[:, None] == Pa[None, :]) & diff_aa
        mt_base = same_aa.to(FLOAT) @ Ua                           # (A,)
        r_aa = comp.ncr_rclass[Pa[:, None], Pa[None, :]]
        valid_aa = diff_aa & (Pa[:, None] != Pa[None, :]) & (r_aa >= 0)
        Xa = torch.stack([(valid_aa & (r_aa == k)).to(FLOAT) @ Ma
                          for k in range(R)], dim=1)               # (A, R)
        join_same = (Pa[None, :] == Pc[:, None]) & live[None, :]   # (C, A)
        mt_ca = mt_base[None, :] + join_same.to(FLOAT) * u_new
        r_ac = comp.ncr_rclass[Pa[None, :], Pc[:, None]].to(INT)   # (C, A)
        join_cross = live[None, :] & (Pa[None, :] != Pc[:, None]) & (r_ac >= 0)
        X_full = Xa[None, :, :].repeat(C, 1, 1)                    # (C, A, R)
        add = join_cross.to(FLOAT) * Mc[:, None]
        # one slot per (c, a): a plain indexed add, no collisions
        X_full.scatter_add_(2, r_ac.clamp(min=0)[:, :, None], add[:, :, None])
        mt_term_a = pressure_term(mt_vec[Pa][None, :].expand(C, A), mt_ca,
                           kappa) * Ua[None, :]
        act_f = _aggregate(X_full.reshape(C * A, R), beta_vec,
                           Ma.repeat(C), mt_term_a.reshape(C * A),
                           kappa).reshape(C, A)
        return new_f, act_f

    # -- block-diagonal constraint checks -----------------------------------
    @staticmethod
    def _dev_summary(Dc, astart, na) -> tuple[int, bool, int, int]:
        """(first candidate device ordinal, whether every candidate sits
        on it, that device's ledger segment start, its length) — the host
        facts the single-device paths branch on, in one copy."""
        d0 = Dc[0]
        d0v, single, s, n_dev = host_list(torch.stack(
            [d0, (Dc == d0).all().to(INT), astart[d0], na[d0]]))
        return d0v, bool(single), s, n_dev

    def factors_same_device(
            self, comp, task: Task, Pc, Dc, Pa, Ua, Ma, uid_a, Da, astart, na,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Block-diagonal constraint-check kernel over *many devices* at once.

        Compute paths never cross device boundaries, so a candidate only
        interacts with the actives of its own device.  One call scores
        every candidate of an arbitrary mixed-device set against a
        device-sorted active ledger (``Da`` ascending, ``astart``/``na``
        the per-device-ordinal segment offsets/lengths), materializing
        only the same-device (candidate, active) pairs.

        Returns ``(new_f, ci, ai, act_pf)``: the newcomer's factor per
        candidate, and flat same-device pair arrays where ``act_pf[k]`` is
        the updated factor of active ``ai[k]`` if the task joins candidate
        ``ci[k]`` (the Alg. 1 l.15 inputs).  Noise-free path only."""
        return self.factors_same_device_multi(
            comp, [(task, Pc, Dc, Pa, Ua, Ma, uid_a, Da, astart, na)])[0]

    def factors_same_device_multi(self, comp, items: Sequence[tuple]):
        """Score many newcomers (one per distinct wave signature) in one
        call of the same-device form of the factor kernel.  ``items``
        holds the positional argument tuples of
        :meth:`factors_same_device`; the result list holds that method's
        return tuple per item, identical to calling it per item (each item
        is a block of its own in the kernel)."""
        beta_vec, mt_vec = self._tables(comp)
        out: list = [None] * len(items)
        todo: list = []
        stores: list = []
        for i, (task, Pc, Dc, Pa, Ua, Ma, uid_a, Da, astart,
                na) in enumerate(items):
            summ = (0, True, 0, 0)          # no candidate or no active
            if Pc.shape[0] and Pa.shape[0]:
                summ = self._dev_summary(Dc, astart, na)
                key, base = self._canon_key(comp, task, Pc, Dc, Pa, Ua, Ma,
                                            uid_a, astart, na, summ=summ)
                if key is not None:
                    out[i] = self._canon_lookup(comp, key, base)
                    if out[i] is not None:
                        continue
                    stores.append((i, key, base))
            todo.append((i, SameDeviceItem(
                Pc, Dc, task.usage.get("pu", 1.0), task.usage.get("mem", 1.0),
                task.uid, Pa, Ua, Ma, uid_a, Da, astart, na, summ)))
        res = slowdown_same_device([it for _, it in todo], mt_vec, beta_vec,
                                   comp.mem_cap, comp.ncr_rclass,
                                   self.params.superlinear)
        for (i, _), r in zip(todo, res):
            out[i] = r
        for i, key, base in stores:
            self._canon_store(key, base, out[i])
        return out

    # -- canonical-pattern cache (single-device constraint checks) ---------
    def _canon_key(self, comp, task: Task, Pc, Dc, Pa, Ua, Ma, uid_a,
                   astart, na, summ: Optional[tuple] = None):
        """Structural cache key of one single-device constraint check.

        Two checks share a key iff every input the kernel math reads is
        identical *up to PU identity*: the candidate/active PU-equality
        pattern, the nearest-common-resource classes over all pairs, the
        per-PU model coefficients and caps, the active usage columns (in
        ledger order), the alive-pair mask against the newcomer's uid,
        and the newcomer's own usages.  Replicated fleets then share one
        kernel evaluation per structural pattern instead of one per
        device.  Returns ``(key, active_base)`` — pair indices are cached
        relative to the device's ledger segment and rebased on hit — or
        ``(None, 0)`` when the candidates span devices."""
        if summ is None:
            summ = self._dev_summary(Dc, astart, na)
        _, single, s, n_dev = summ
        if not single:
            return None, 0
        L = torch.cat([Pc, Pa[s:s + n_dev]])
        # equality pattern of L: position of each value's first occurrence
        # in sorted order (equal PUs share it, different PUs do not)
        inv = torch.searchsorted(torch.sort(L)[0], L)
        live = uid_a[s:s + n_dev] != task.uid
        _, mt_vec = self._tables(comp)
        key = (Pc.shape[0], n_dev,
               task.usage.get("pu", 1.0), task.usage.get("mem", 1.0),
               bytes_key(inv, comp.ncr_rclass[L[:, None], L[None, :]],
                         mt_vec[L], comp.mem_cap[L], Ua[s:s + n_dev],
                         Ma[s:s + n_dev], live))
        return key, s

    def _canon_cache_dict(self, comp) -> dict:
        cached = self._canon_cache
        if cached is not None and cached[0] is not comp \
                and self._factor_kin(cached[0], comp):
            # kin delta clone: the canonical keys hash every value the
            # kernel math reads, none of which changed — keep the factors
            cached = (comp, cached[1])
            self._canon_cache = cached
        if cached is None or cached[0] is not comp:
            cached = (comp, {})
            self._canon_cache = cached
        return cached[1]

    def _canon_lookup(self, comp, key, base):
        hit = self._canon_cache_dict(comp).get(key)
        if hit is None:
            return None
        with self._counter_lock:
            self.factor_cache_hits += 1
        new_f, ci, rel_ai, act_pf = hit
        return new_f, ci, rel_ai + base, act_pf

    def _canon_store(self, key, base, result) -> None:
        # _canon_lookup always ran first, so the per-snapshot dict exists
        cache = self._canon_cache[1]
        with self._counter_lock:
            self.factor_cache_misses += 1
        if len(cache) > 100_000:            # runaway-key backstop
            cache.clear()
        new_f, ci, ai, act_pf = result
        cache[key] = (new_f, ci, ai - base, act_pf)


class NoSlowdown:
    """Contention-blind model (what ACE-like baselines assume)."""

    factor_cache_hits = 0
    factor_cache_misses = 0

    def __init__(self, graph: HWGraph, *a, **k) -> None:
        self.graph = graph
        self.device = graph.device

    def _ones(self, *shape) -> torch.Tensor:
        return torch.ones(shape, dtype=FLOAT, device=self.device)

    def factor(self, task: Task, pu_name: str,
               coruns: list[tuple[Task, str]]) -> float:
        return 1.0

    def factor_batch(self, pool) -> torch.Tensor:
        return self._ones(len(pool))

    def factor_batch_idx(self, P, U, mem, uid, members=None) -> torch.Tensor:
        return self._ones(P.shape[0] if members is None else members.shape[0])

    def slowdown_matrix(self, pool) -> torch.Tensor:
        return self._ones(len(pool), len(pool))

    def factors_with_candidates(self, task, candidate_pus, active):
        return (self._ones(len(candidate_pus)),
                self._ones(len(candidate_pus), len(active)))

    def factors_with_candidates_idx(self, comp, task, Pc, Pa, Ua, Ma, uid_a):
        return self._ones(Pc.shape[0]), self._ones(Pc.shape[0], Pa.shape[0])

    def factors_same_device(self, comp, task, Pc, Dc, Pa, Ua, Ma, uid_a,
                            Da, astart, na):
        e = torch.zeros(0, dtype=INT, device=self.device)
        return self._ones(Pc.shape[0]), e, e, self._ones(0)

    def factors_same_device_multi(self, comp, items):
        return [self.factors_same_device(comp, *it) for it in items]

    def invalidate(self) -> None:
        pass
