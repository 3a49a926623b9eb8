"""The scheduler kernels' least time: bytes and operations each launch
needs, counted from the arguments it was handed, against one H100's
published peaks (NVIDIA data sheet, SXM part).

Each count reads every input byte once and writes every output byte
once; where the work depends on the data (distinct PUs of a pool, route
entries of the affected transfers, feasible scans) it counts what these
inputs need.  The counts are those the kernels' bring-up used for their
``bound_ms`` (the byte helpers of ``chip_smoke.py``), frozen here so a
later change to a kernel cannot change its yardstick.
"""
from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12


def least_seconds(nbytes: float, ops: float) -> float:
    """The larger of the bytes at the memory rate and the float64
    operations at the CUDA-core rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP64_FLOPS)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def pool_cost(members, pu_i, R: int) -> tuple:
    """Pool form: 56 bytes of gathered columns and tables per member, 2
    per distinct off-diagonal class entry read, the beta row, 8 per
    factor written; an add per pair and ~40 operations per factor."""
    P = _np(pu_i)[_np(members)]
    n = len(P)
    u = len(np.unique(P))
    return 56 * n + 2 * (u * u - u) + 8 * R + 8 * n, n * n + 40 * n


def same_device_cost(items) -> tuple:
    """Same-device form: per candidate its PU, device, cap, mt and factor
    (40); per active of a candidate device its five columns (40) and 16
    per device segment; 2 per class entry read (each candidate-active
    pair both ways, each active pair once); 24 per pair row written; 200
    per item row.  An add per pair read, ~40 operations per factor."""
    nbytes = ops = 0
    for it in items:
        Pc = _np(it.Pc)
        Dc = _np(it.Dc)
        na = _np(it.na)
        devs = np.unique(Dc)
        K = int(na[Dc].sum())
        seg = int(na[devs].sum())
        sq = int((na[devs] ** 2).sum())
        nbytes += 40 * len(Pc) + 40 * seg + 16 * len(devs) \
            + 2 * (2 * K + sq) + 24 * K + 200
        ops += K + sq + 40 * (len(Pc) + K)
    return nbytes, ops


def row_cost(x) -> tuple:
    """Row form: the (N, R) pressures, beta, mem, mt and the factors."""
    n, r = x.shape
    return 8 * (n * r + r + 3 * n), n * (r * 6 + 2)


def settle_reprice_cost(members) -> tuple:
    """Per slot its index, factor, the four settle columns read and the
    rate, eta, t_last and stamp written."""
    n = members.shape[0]
    return 80 * n, 6 * n


def settle_complete_cost(done) -> tuple:
    n = done.shape[0]
    return 72 * n, 5 * n


def transfer_reprice_cost(xe_flat, xe_start, xe_cnt, ks, upd_e) -> tuple:
    """Per transfer its slot, CSR row, the settle columns read and
    written, rate, eta and stamp (88); 8 per route entry, 16 per distinct
    edge read, 24 per changed count; a division and a compare per entry."""
    k = _np(ks)
    st, cnt, flat = _np(xe_start)[k], _np(xe_cnt)[k], _np(xe_flat)
    entries = (np.concatenate([flat[s:s + c] for s, c in zip(st, cnt)])
               if len(k) else np.zeros(0, dtype=np.int64))
    n = len(k)
    return (88 * n + 8 * len(entries) + 16 * len(np.unique(entries))
            + 24 * upd_e.shape[0], 3 * len(entries) + 8 * n)


def transfer_complete_cost(done) -> tuple:
    n = done.shape[0]
    return 72 * n, 5 * n


def scan_cost(P: int, Nn: int, rows, meta: bool) -> tuple:
    """A stack of scans: ``ok`` and ``key`` per PU (9), 48 per plan node,
    ``sa``/``f``/``cm`` at each feasible scan's winner (24), the offsets
    and launch order where passed (40 per scan), the 7-double rows once;
    two operations per PU and six per node."""
    r = _np(rows).reshape(-1, 7)
    S = r.shape[0]
    won = int((r[:, 0] >= 0).sum())
    return (9 * P + 48 * Nn + 24 * won + (40 * S if meta else 0) + 56 * S,
            2 * P + 6 * Nn)


def rewalk_cost(seg, R: int) -> tuple:
    """The fused re-walk over one device's segment: each input read once
    (the candidates' five columns, the signature's two, the device's
    eight ledger columns and its segment's start and length, the class
    table over every (candidate or active, active) pair, mt-beta and the
    memory cap of each candidate's and active's PU, beta, the plan's six
    node columns, ``ok`` and ``key`` off the segment, the winner's three
    columns) and each output written once (the scan state's four columns
    and the effective three over the segment, the nine values); per
    candidate and per candidate-active pair ``5 R + 4`` operations."""
    C, C2, A = seg.Pc.shape[0], seg.eff_cols.shape[0], seg.Pa.shape[0]
    n, P = seg.nseg, seg.ok.shape[0]
    nbytes = (40 * C + 16 * C2 + 64 * A + 16 + 2 * (C * A + A * A)
              + 16 * (C + A) + 8 * R + 48 * seg.plan.n + 9 * (P - n) + 24
              + 42 * n + 72)
    return nbytes, (C + C * A) * (5 * R + 4)


# kernel wrapper name -> (the traced kernel names' common part, a function
# of (positional arguments, result) giving (bytes, operations))
KERNELS = {
    "slowdown_pool": ("slowdown_pool_kernel",
                      lambda a, r: pool_cost(a[0], a[1], a[8].shape[0])),
    "slowdown_same_device": ("slowdown_same_device_kernel",
                             lambda a, r: same_device_cost(a[0])),
    "slowdown_factors": ("slowdown_factors_kernel",
                         lambda a, r: row_cost(a[0])),
    "settle_reprice": ("settle_reprice_kernel",
                       lambda a, r: settle_reprice_cost(a[5])),
    "settle_complete": ("settle_complete_kernel",
                        lambda a, r: settle_complete_cost(a[4])),
    "transfer_reprice": ("transfer_reprice_kernel",
                         lambda a, r: transfer_reprice_cost(a[5], a[6], a[7],
                                                            a[10], a[11])),
    "transfer_complete": ("transfer_complete_kernel",
                          lambda a, r: transfer_complete_cost(a[4])),
    "scan_reduce": ("scan_reduce_batch_kernel",
                    lambda a, r: scan_cost(a[0].shape[0], a[5].n, r, False)),
    "scan_reduce_batch": (
        "scan_reduce_batch_kernel",
        lambda a, r: scan_cost(int(np.asarray(a[6]).reshape(-1, 4)[:, 1].sum()),
                               int(np.asarray(a[6]).reshape(-1, 4)[:, 3].sum()),
                               r, True)),
    "rewalk_entry": ("rewalk_entry_kernel",
                     lambda a, r: rewalk_cost(a[0], a[2].shape[0])),
}
# the grid form of a scan runs under names of its own
GRID_KERNELS = ("big_words_kernel", "big_nodes_kernel", "big_blocks_kernel",
                "big_final_kernel")


class LaunchRecorder:
    """Wraps the port's kernel wrappers where the program calls them and
    keeps each call's arguments and result; the costs are counted after
    the traced window, so the window runs no extra device work."""

    def __init__(self, modules: list) -> None:
        self.modules = modules
        self.calls: list = []
        self._saved: list = []

    def __enter__(self) -> "LaunchRecorder":
        for mod in self.modules:
            for name in KERNELS:
                fn = getattr(mod, name, None)
                if fn is None or not callable(fn):
                    continue
                self._saved.append((mod, name, fn))
                setattr(mod, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc) -> None:
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved.clear()

    def _wrap(self, name, fn):
        calls = self.calls

        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls.append((name, args, out))
            return out
        wrapper.__wrapped__ = fn
        return wrapper

    def least_seconds(self) -> float:
        """Summed least time of every recorded launch."""
        total = 0.0
        for name, args, out in self.calls:
            nbytes, ops = KERNELS[name][1](args, out)
            total += least_seconds(nbytes, ops)
        return total


def is_port_kernel(event_name: str) -> bool:
    return (any(k[0] in event_name for k in KERNELS.values())
            or any(g in event_name for g in GRID_KERNELS))
