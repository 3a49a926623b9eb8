"""Sharding policies: param-tree path -> partition spec -> DTensor
placements.  The reference package's ``launch/sharding.py``: the rule
tables and the rule functions are copies, over the port's own
:class:`PartitionSpec` and a ``DeviceMesh``.

Logical roles per weight (Megatron/GSPMD conventions):
    col  (d_in, d_out*)  : in->fsdp, out->tp      (wq wk wv wg wu w_x ...)
    row  (d_in*, d_out)  : in->tp,  out->fsdp     (wo wd w_out w_o ...)
    embed (V, d)         : V->tp,  d->fsdp
    expert (E, ., .)     : E->tp (expert parallelism), then col/row inside
    vectors / norms / small tensors: replicated

Policies map logical axes onto mesh axes:
    tp_fsdp (default) : tp->model, fsdp->data   (2D: Megatron TP + ZeRO-3)
    tp_only           : tp->model, fsdp->None   (params replicated over data)
    fsdp_only         : tp->None,  fsdp->data
Params are replicated across the 'pod' axis (DCN carries only gradient
all-reduce) — the multi-pod baseline.  Dims that do not divide the mesh axis
fall back to replication (e.g. 8 q-heads on a 16-way model axis).

Stacked layers (leading n_super dim from scan) get a leading None.

From spec to placements (:meth:`Sharding.placements`): each mesh dim gets
``Shard(d)`` for the tensor dim ``d`` whose entry names it, else
``Replicate()``.  A tensor dim named by two mesh axes (``fsdp_pod``'s
``("data", "pod")``, the batch over ``("pod", "data")``) is split in the
**mesh's order**, DTensor's own: on ``("pod", "data", "model")`` the pod
index is the major one.  JAX splits in the order the entry lists,
``data``-major for ``fsdp_pod``.  Each rank's local size is the same
either way; which block a rank holds differs.
"""
from __future__ import annotations

import contextlib
import logging
import math
import os
import re
from dataclasses import dataclass
from typing import Any, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

from .. import tree as tr

COL = ("fsdp", "tp")
ROW = ("tp", "fsdp")
_RULES: list[tuple[str, tuple]] = [
    (r"(^|/)(embed|lm_head)$", ("tp", "fsdp")),
    (r"/moe/(wg|wu)$", ("tp", "fsdp", None)),       # (E, d, ff)
    (r"/moe/wd$", ("tp", None, "fsdp")),            # (E, ff, d)
    (r"/moe/router$", ("fsdp", None)),
    (r"/(wq|wk|wv|wg|wu|w_x|w_gate|w_r|w_k|w_v|w_g|w_lora_a)$", COL),
    (r"/(wo|wd|w_out|w_o|w_lora_b)$", ROW),
    # caches: (B, C, Hkv, hd) -> batch over data axes; recurrent states
    (r"/attn/(k|v)$", ("batch", None, None, None)),
    (r"/cross_kv/(k|v)$", ("batch", None, None, None)),
    (r"/rec/(h|state)$", ("batch", None)),           # padded per-ndim below
]
# cache_mode overrides for KV caches (flash-decode style seq sharding, or
# kv-head TP when the head count divides the model axis).  "ctp" resolves to
# the model axis under EVERY policy — the cache must shard even when params
# are fsdp-only, else a 32k x batch cache replicates 16x.
_CACHE_MODES = {
    "batch": ("batch", None, None, None),
    "seq": ("batch", "ctp", None, None),
    "heads": ("batch", None, "ctp", None),
}


# weight-stationary MoE overrides (policy tp_fsdp_moeff): the ff dim shards
# over data, so the (huge) expert weights stay put; forward/backward instead
# all-reduce the (small) activation partial sums over data.
_MOEFF_RULES = {
    "wg": ("tp", None, "fsdp"), "wu": ("tp", None, "fsdp"),
    "wd": ("tp", "fsdp", None),
}


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None``, a mesh axis name, or a tuple of
    names (the reference's ``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _mesh_sizes(mesh: DeviceMesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def spec_placements(mesh: DeviceMesh, spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` for the tensor dim ``d`` whose entry names that axis,
    else ``Replicate()``."""
    dim_of: dict[str, int] = {}
    for d, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                dim_of[axis] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in mesh.mesh_dim_names)


@dataclass(frozen=True)
class Sharding:
    """``(mesh, spec)`` of one leaf, the reference's ``NamedSharding``."""

    mesh: DeviceMesh
    spec: PartitionSpec

    def placements(self) -> tuple:
        return spec_placements(self.mesh, self.spec)


def _logical_for(path: str, ndim: int, cache_mode: str = "batch",
                 policy: str = "tp_fsdp") -> tuple:
    if policy == "tp_fsdp_moeff":
        m = re.search(r"/moe/(wg|wu|wd)$", path)
        if m:
            ax = list(_MOEFF_RULES[m.group(1)])
            if ndim > 3:
                ax = [None] * (ndim - 3) + ax
            return tuple(ax)
    for pat, axes in _RULES:
        if re.search(pat, path):
            ax = list(axes)
            if re.search(r"/attn/(k|v)$", path):
                ax = list(_CACHE_MODES[cache_mode])
            if len(ax) < ndim:                    # stacked: leading scan dims
                ax = [None] * (ndim - len(ax)) + ax
            elif len(ax) > ndim:
                ax = ax[-ndim:] if ndim > 0 else []
            return tuple(ax)
    return (None,) * ndim


def _resolve(logical: tuple, shape: tuple, mesh: DeviceMesh, policy: str,
             batch_axes: tuple[str, ...]) -> PartitionSpec:
    mapping = {"tp_fsdp": {"tp": "model", "fsdp": "data"},
               "tp_only": {"tp": "model", "fsdp": None},
               "fsdp_only": {"tp": None, "fsdp": "data"},
               "fsdp_pod": {"tp": "model", "fsdp": ("data", "pod")
                            if "pod" in mesh.mesh_dim_names else "data"},
               # weight-stationary MoE: like tp_fsdp, but expert FFNs keep
               # the ff dim sharded over data (see _MOEFF_RULES) so expert
               # weights are never all-gathered per microbatch
               "tp_fsdp_moeff": {"tp": "model", "fsdp": "data"},
               }[policy]
    sizes = _mesh_sizes(mesh)
    out = []
    for dim, role in enumerate(logical):
        if role == "batch":
            ax: Any = tuple(a for a in batch_axes if a in sizes)
            n = math.prod(sizes[a] for a in ax) if ax else 1
            if not ax or shape[dim] % n:
                ax = None
            elif len(ax) == 1:
                ax = ax[0]
        elif role == "ctp":
            ax = "model" if "model" in sizes else None
            if ax is not None and shape[dim] % sizes[ax]:
                ax = None
        elif role in ("tp", "fsdp"):
            ax = mapping[role]
            if ax is not None:
                axes = ax if isinstance(ax, tuple) else (ax,)
                n = math.prod(sizes[a] for a in axes)
                if shape[dim] % n:
                    ax = None
        else:
            ax = None
        out.append(ax)
    return P(*out)


def tree_paths_and_leaves(tree):
    """(``[(path, leaf)]``, the structure): paths join dict keys and
    sequence indexes with ``/`` in JAX's flattening order; the tree itself
    stands for the structure (``repro_torch.tree.unflatten`` takes it)."""
    return tr.flatten_with_paths(tree), tree


def make_shardings(tree, mesh: DeviceMesh, policy: str = "tp_fsdp",
                   batch_axes: tuple[str, ...] = ("data",),
                   cache_mode: str = "batch"):
    """A :class:`Sharding` tree matching ``tree`` (of tensors, fake
    tensors or anything with a ``shape``)."""
    flat, structure = tree_paths_and_leaves(tree)
    shardings = []
    for path, leaf in flat:
        logical = _logical_for(path, len(leaf.shape), cache_mode, policy)
        spec = _resolve(logical, tuple(leaf.shape), mesh, policy, batch_axes)
        shardings.append(Sharding(mesh, spec))
    return tr.unflatten(structure, shardings)


def batch_sharding(specs, mesh: DeviceMesh, batch_axes: tuple[str, ...]):
    """Shard dim-0 (global batch) over the batch axes; replicate the rest."""
    sizes = _mesh_sizes(mesh)
    n = math.prod(sizes[a] for a in batch_axes)

    def one(leaf):
        if leaf.shape and leaf.shape[0] % n == 0:
            ax = batch_axes[0] if len(batch_axes) == 1 else batch_axes
            return Sharding(mesh, P(ax, *([None] * (len(leaf.shape) - 1))))
        return Sharding(mesh, P())
    return tr.tree_map(one, specs)


def replicated(mesh: DeviceMesh) -> Sharding:
    return Sharding(mesh, P())


def place(tree, shardings):
    """Each leaf of ``tree`` as a DTensor with its :class:`Sharding`'s
    placements (every rank slices its block of the full tensor it holds;
    nothing is sent)."""
    def one(x, sh: Sharding):
        return distribute_tensor(x, sh.mesh, sh.placements(),
                                 src_data_rank=None)
    return tr.tree_map(one, tree, shardings)


def _split(x) -> bool:
    """``x`` is a DTensor sharded or partial on some mesh dim."""
    return isinstance(x, DTensor) and not all(p.is_replicate()
                                              for p in x.placements)


def _outer_only(x):
    """``x`` keeping only the sharding of its outermost sharded tensor dim
    (a view may merge that dim with the ones after it), replicated on every
    other mesh dim."""
    if not _split(x):
        return x
    dims = [p.dim for p in x.placements if p.is_shard()]
    outer = min(dims) if dims else None
    keep = [p if p.is_shard() and p.dim == outer else Replicate()
            for p in x.placements]
    return x if keep == list(x.placements) else x.redistribute(
        x.device_mesh, keep)


def _gather(x):
    """``x`` replicated on every mesh dim."""
    if _split(x):
        return x.redistribute(x.device_mesh,
                              [Replicate()] * x.device_mesh.ndim)
    return x


_REFUSED = (RuntimeError, NotImplementedError, IndexError, ValueError)


class _GatherMode(TorchDispatchMode):
    """Sees each op before DTensor's dispatch.  An op whose sharding
    DTensor refuses runs again with each argument keeping only the sharding
    of its outermost sharded dim; refused again, on arguments gathered
    whole; and with no rule at all, on each rank's whole copies."""

    def __init__(self, gathered: dict, sites: dict) -> None:
        super().__init__()
        self.gathered = gathered
        self.sites = sites

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        try:
            return func(*args, **kwargs)
        except _REFUSED:
            # an in-place op must write its own shards: never gathered
            if func._schema.is_mutable:
                raise
        for level, how in (("outer", _outer_only), ("whole", _gather)):
            a, k = tree_map(how, (args, kwargs))
            try:
                out = func(*a, **k)
            except NotImplementedError:
                if how is not _gather:
                    continue
                # no sharding rule at all: on arguments replicated whole,
                # every rank runs the op on its own copies
                level, out = "local", _replicated_call(func, a, k)
            except _REFUSED:
                if how is _gather:
                    raise
                continue
            key = f"{func} ({level})"
            self.gathered[key] = self.gathered.get(key, 0) + 1
            here = self.sites.setdefault(key, [])
            site = _model_site()
            if site not in here and len(here) < 4:
                here.append(site)
            return out


def _model_site() -> str:
    """``file:line`` of the innermost frame of the port outside the
    launch layer (the model or step line that issued an op), or ``""``;
    ``backward`` for an op autograd's engine runs."""
    import traceback
    sep = os.sep
    frames = [f for f in traceback.extract_stack()
              if f"{sep}repro_torch{sep}" in f.filename
              and f"{sep}launch{sep}" not in f.filename]
    if not frames:
        return ""
    f = frames[-1]
    where = f"{f.filename.split(sep + 'repro_torch' + sep)[-1]}:{f.lineno}"
    node = torch._C._current_autograd_node()
    return f"{where} (backward of {node.name()})" if node is not None \
        else where


def _replicated_call(func, args, kwargs):
    """``func`` on the local tensors of replicated DTensor arguments, its
    tensor outputs replicated DTensors on the same mesh."""
    mesh = next(x.device_mesh for x in tree_leaves((args, kwargs))
                if isinstance(x, DTensor))
    a, k = tree_map(lambda x: x.to_local() if isinstance(x, DTensor) else x,
                    (args, kwargs))
    out = func(*a, **k)
    rep = [Replicate()] * mesh.ndim
    return tree_map(lambda o: DTensor.from_local(o, mesh, rep,
                                                 run_check=False)
                    if isinstance(o, torch.Tensor) else o, out)


class GatherOnRefusal:
    """Runs a DTensor program written for GSPMD.  DTensor's sharding
    propagation refuses some ops that XLA's partitioner reshards on its
    own (a view that merges a sharded dim, an op with no sharding rule).
    For such an op each sharded or partial DTensor argument first keeps
    only the sharding of its outermost sharded dim (usually the batch), and
    if DTensor still refuses, is gathered whole (``redistribute`` to
    ``Replicate()``: all-gathers and all-reduces on the mesh); an op
    DTensor has no rule for at all (``roll``, ``flip``) then runs on each
    rank's whole copies.  ``gathered`` counts those ops by name and
    level, ``sites`` lists the model lines that issued them (up to four
    an op).  Plain tensors beside DTensors count as replicated (DTensor's
    ``implicit_replication``).  A context manager around a step."""

    def __init__(self) -> None:
        self.gathered: dict[str, int] = {}
        self.sites: dict[str, list] = {}
        self._stack: Optional[contextlib.ExitStack] = None

    def __enter__(self) -> "GatherOnRefusal":
        self._stack = contextlib.ExitStack()
        # DTensor warns at every redistribution over two mesh dims
        log = logging.getLogger("torch.distributed.tensor._redistribute")
        level = log.level
        self._stack.callback(log.setLevel, level)
        log.setLevel(logging.ERROR)
        self._stack.enter_context(implicit_replication())
        self._stack.enter_context(_GatherMode(self.gathered, self.sites))
        return self

    def __exit__(self, *exc) -> bool:
        self._stack.close()
        return False
