"""Per-device counts of a sharded step, for the roofline report -- the
reference package's ``launch/hlo_analysis.py`` on PyTorch.

The reference parses the SPMD-partitioned HLO text XLA compiles
(``analyze_hlo``, loop-aware).  Torch produces no such text, so the
parser is not ported.  Here the step runs eagerly on DTensors under fake
tensors, and :class:`LocalCounter` -- the fake-tensor mode itself --
sees every op that DTensor runs on one rank's local shards:

* ``dot_flops``: the matmul family's FLOPs (``torch.utils.flop_counter``'s
  table: ``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions and fused
  attention), on the local shapes.  A ``FlopCounterMode`` entered around
  the step would see DTensor's global ops and count the global product;
* ``collective_bytes`` / ``collective_count``: every functional collective
  DTensor issues, by the reference's type names, charged the bytes of its
  input tensor (the operand, as the reference charges);
* ``hbm_bytes``: input plus output bytes of every local op that is not a
  view.  This over-counts reads (once per consumer) and ignores caching
  and fusion -- an upper bound, as the reference's is.

All counts are per device: what rank 0 runs.  DTensor's sharding
propagation also runs ops, on global shapes, to learn output shapes; those
run under a fake mode of their own and are not counted
(:func:`counting`).

``roofline_terms`` and its constants are the reference's (TPU v5e's
peak rate, HBM and link bandwidth: the planner's model of the fleet H-EYE
places work on, not the device this port runs on).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# functional collectives -> the reference's HLO op names
_COLLECTIVE_NAMES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


@dataclass
class HloReport:
    """Per-device totals (what one rank runs)."""

    dot_flops: float = 0.0
    hbm_bytes: float = 0.0                    # per-op upper bound
    collective_bytes: dict[str, float] = field(default_factory=dict)
    collective_count: dict[str, int] = field(default_factory=dict)
    n_while: int = 0
    unknown_trip_whiles: int = 0
    top_traffic: list = field(default_factory=list)   # (bytes, op, shape)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _nbytes(x) -> int:
    return x.numel() * x.element_size()


class LocalCounter(FakeTensorMode):
    """A fake-tensor mode that fills an :class:`HloReport` with what it
    runs on plain (local) fake tensors.  Ops on DTensors are handed to
    DTensor (which then runs local ops here); ops this mode runs inside
    its own handling of an op are not counted twice."""

    def __init__(self, **kwargs) -> None:
        super().__init__(**kwargs)
        self.report = HloReport()
        self._depth = 0
        self._traffic: dict = {}

    def reset(self) -> None:
        self.report = HloReport()
        self._traffic = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        self._depth += 1
        try:
            out = super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self._depth -= 1
        if self._depth == 0:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        rep = self.report
        flops = flop_registry.get(func._overloadpacket)
        if flops is not None:
            rep.dot_flops += flops(*args, **kwargs, out_val=out)
        if func.namespace == "_c10d_functional":
            kind = _COLLECTIVE_NAMES.get(func._overloadpacket.__name__)
            if kind is not None:
                nbytes = sum(_nbytes(t) for t in tree_leaves(args[0])
                             if hasattr(t, "element_size"))
                rep.collective_bytes[kind] = (
                    rep.collective_bytes.get(kind, 0.0) + nbytes)
                rep.collective_count[kind] = (
                    rep.collective_count.get(kind, 0) + 1)
            return
        if func.is_view or func._schema.name.startswith("prim::"):
            return
        ins = [t for t in tree_leaves((args, kwargs))
               if hasattr(t, "element_size")]
        outs = [t for t in tree_leaves(out) if hasattr(t, "element_size")]
        total = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        rep.hbm_bytes += total
        key = (str(func), tuple(outs[0].shape) if outs else ())
        self._traffic[key] = self._traffic.get(key, 0) + total

    def finish(self) -> HloReport:
        """The report, with its 20 largest (bytes, op, shape) entries."""
        self.report.top_traffic = sorted(
            ((b, op, str(shape)) for (op, shape), b in self._traffic.items()),
            reverse=True)[:20]
        return self.report


@contextlib.contextmanager
def counting(mode: LocalCounter):
    """Run under ``mode``, with three settings of DTensor's internals for
    an eager program on fake tensors:

    * its sharding propagation runs under a fake mode of its own, so that
      neither ``mode`` nor a ``MemTracker`` counts the global-shape ops it
      runs to learn output shapes;
    * its sharding propagation is cached per op schema, as DTensor caches
      it outside a fake mode (under one it takes the program for a
      compiler's trace and plans every op anew; here every shape is
      static, and planning an op on a 3-D mesh takes seconds);
    * ``_StridedShard`` computes its shard offsets from real index
      tensors (they depend on sizes only; a fake tensor has no values).
    """
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _sharding_prop, placement_types
    from torch.utils._python_dispatch import _disable_current_modes
    saved: list = []

    def patch(obj, name, value) -> None:
        saved.append((obj, name, vars(obj)[name]))
        setattr(obj, name, value)

    propagator = _sharding_prop.ShardingPropagator
    tensor_meta = vars(propagator)["_propagate_tensor_meta_non_cached"]
    uncached = vars(propagator)["propagate_op_sharding_non_cached"]
    memo: dict = {}

    def tensor_meta_alone(self, op_schema):
        # no mode of ours sees the global-shape ops it runs: it finds no
        # fake mode active and makes one of its own
        with _disable_current_modes():
            return tensor_meta(self, op_schema)

    def propagate(self, op_schema):
        key = (id(self), op_schema)
        if key not in memo:
            memo[key] = uncached(self, op_schema)
        return memo[key]
    patch(propagator, "_propagate_tensor_meta_non_cached", tensor_meta_alone)
    patch(propagator, "propagate_op_sharding_non_cached", propagate)
    strided = placement_types._StridedShard
    raw = vars(strided).get("local_shard_size_and_offset")
    if raw is not None:
        fn = raw.__func__ if isinstance(raw, staticmethod) else raw

        def real_offsets(*a, **k):
            with unset_fake_temporarily():
                return fn(*a, **k)
        patch(strided, "local_shard_size_and_offset",
              staticmethod(real_offsets) if isinstance(raw, staticmethod)
              else real_offsets)
    try:
        with mode:
            yield mode
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)


# ---------------------------------------------------------------------------
# roofline terms (assignment-prescribed hardware constants: TPU v5e)
# ---------------------------------------------------------------------------
PEAK_FLOPS = 197e12          # bf16 FLOP/s per chip
HBM_BW = 819e9               # B/s per chip
LINK_BW = 50e9               # B/s per ICI link


def roofline_terms(rep: HloReport, *, n_chips: int,
                   model_flops_total: float = 0.0) -> dict:
    """Terms in seconds (per-step).  ``rep`` totals are per-device already,
    so the per-chip roofline divides by nothing further; total-FLOP ratios
    multiply back by n_chips."""
    t_compute = rep.dot_flops / PEAK_FLOPS
    t_memory = rep.hbm_bytes / HBM_BW
    t_coll = rep.total_collective_bytes / LINK_BW
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    hlo_total_flops = rep.dot_flops * n_chips
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "bottleneck": dominant,
        "hlo_flops_total": hlo_total_flops,
        "model_flops_total": model_flops_total,
        "useful_flops_ratio": (model_flops_total / hlo_total_flops
                               if hlo_total_flops else 0.0),
        "collective_bytes_per_chip": rep.total_collective_bytes,
        "collective_breakdown": dict(rep.collective_bytes),
        "roofline_bound_s": max(t_compute, t_memory, t_coll),
        "roofline_fraction": (t_compute /
                              max(t_compute, t_memory, t_coll)
                              if max(t_compute, t_memory, t_coll) > 0 else 0.0),
    }
