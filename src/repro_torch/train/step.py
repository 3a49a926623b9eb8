"""Training step: loss, gradient accumulation (microbatching), AdamW —
the reference package's ``train/step.py`` on PyTorch.

``make_train_step`` builds a function over a train state of plain dicts,
``{"params", "opt": {"step", "m", "v"}}``, as the reference's pytree.
Gradients come from ``torch.autograd.grad`` over the parameter leaves
(detached aliases that require grad, so the state's own tensors never
carry autograd history); the step then updates the state **in place**
(:func:`repro_torch.optim.adamw_update`) and returns it.  Microbatching
splits the batch along axis 0 and accumulates the gradients in
``accum_dtype``, one microbatch's activations alive at a time, as the
reference's ``lax.scan``.

The model must take the plain route, ``ParallelCtx(use_kernels=False)``,
as the reference trains: the kernels are forward only and their wrappers
refuse a call that autograd would record.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from .. import tree as tr
from ..models.model import Model
from ..optim import OptConfig, adamw_update, init_opt_state

Tree = Any
AUX_WEIGHT = 0.01      # MoE load-balance loss weight
IGNORE = -1            # masked label id


def cross_entropy(logits: torch.Tensor, labels) -> torch.Tensor:
    """Mean token NLL with IGNORE masking.  logits (B,S,V) float32; an
    all-masked batch gives 0."""
    labels = torch.as_tensor(labels, device=logits.device).long()
    mask = labels != IGNORE
    safe = torch.where(mask, labels, torch.zeros_like(labels))
    if not isinstance(logits, DTensor):
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, safe[..., None], dim=-1)[..., 0]
        nll = logz - gold
    else:
        if any(p.is_partial() for p in logits.placements):
            # partial sums (an unembedding whose table stayed sharded over
            # the data axis, for a few rows) are summed first
            logits = logits.redistribute(logits.device_mesh, [
                Replicate() if p.is_partial() else p
                for p in logits.placements])
        nll = _ShardedNLL.apply(logits, safe)
    nll = nll * mask
    return nll.sum() / torch.clamp_min(mask.sum(), 1)


def _row_placements(logits: DTensor) -> list:
    """Placements of a (B, S) result of ``logits``: its row sharding kept,
    every mesh dim that splits the vocabulary replicated."""
    last = logits.ndim - 1
    return [Replicate() if p.is_shard(last) else p for p in logits.placements]


def _local_rows(x, logits: DTensor) -> torch.Tensor:
    """This rank's block of a (B, S) tensor laid out as ``logits``' rows."""
    mesh, rows = logits.device_mesh, _row_placements(logits)
    if isinstance(x, DTensor):
        return x.redistribute(mesh, rows).to_local()
    return distribute_tensor(x, mesh, rows, src_data_rank=None).to_local()


class _ShardedNLL(torch.autograd.Function):
    """Per-token ``logsumexp(logits) - logits[label]`` of DTensor logits
    sharded over the batch and the vocabulary, each rank on its own block,
    as XLA's partitioner runs the reference's loss: a local max and a max
    all-reduce over the vocabulary's mesh dims, a local ``sum(exp(x - m))``
    and a sum all-reduce, the gold logit as a compare-and-sum against the
    vocabulary ids of the rank's block and a sum all-reduce.  Only (B, S)
    rows cross ranks; the rows stay split as the logits' are.  The
    backward writes the logits' gradient, ``g * (softmax - onehot)``, on
    the same blocks, with the logits' placements.  The local ops are those
    of ``torch.logsumexp`` and its autograd formula, so a mesh of one gives
    the plain loss bit for bit."""

    @staticmethod
    def forward(ctx, logits: DTensor, safe):
        mesh, placements = logits.device_mesh, tuple(logits.placements)
        last = logits.ndim - 1
        rows = _row_placements(logits)
        vocab_dims = [i for i, p in enumerate(placements)
                      if p.is_shard(last) and mesh.size(i) > 1]

        def reduce(t: torch.Tensor, op: str) -> torch.Tensor:
            if not vocab_dims:
                return t
            part = [Partial(op) if i in vocab_dims else p
                    for i, p in enumerate(rows)]
            return DTensor.from_local(t, mesh, part, run_check=False
                                      ).redistribute(mesh, rows).to_local()
        x = logits.to_local()
        ids = distribute_tensor(
            torch.arange(logits.shape[-1], device=x.device), mesh,
            [Shard(0) if p.is_shard(last) else Replicate()
             for p in placements], src_data_rank=None).to_local()
        hit = ids == _local_rows(safe, logits)[..., None]
        m = reduce(x.amax(dim=-1), "max")
        m = m.masked_fill(m.abs() == float("inf"), 0.0)
        logz = torch.log(reduce(torch.exp(x - m[..., None]).sum(-1), "sum"))
        logz = logz + m
        gold = reduce(torch.where(hit, x, 0.0).sum(-1), "sum")
        ctx.save_for_backward(x, logz, hit)
        ctx.layout = (mesh, placements, rows, logits.shape, logits.stride())
        return DTensor.from_local(logz - gold, mesh, rows, run_check=False)

    @staticmethod
    def backward(ctx, grad):
        x, logz, hit = ctx.saved_tensors
        mesh, placements, rows, shape, stride = ctx.layout
        g = grad.redistribute(mesh, rows).to_local()[..., None]
        dx = g * torch.exp(x - logz[..., None])
        dx = dx + torch.where(hit, -g, 0.0)
        return DTensor.from_local(dx, mesh, placements, run_check=False,
                                  shape=shape, stride=stride), None


def make_loss_fn(model: Model):
    def loss_fn(params, batch):
        logits, aux = model.forward(params, batch)
        loss = cross_entropy(logits, batch["labels"])
        return loss + AUX_WEIGHT * aux, {"loss": loss, "aux": aux}
    return loss_fn


def init_train_state(model: Model, generator: torch.Generator,
                     opt_cfg: Optional[OptConfig] = None,
                     param_dtype: Optional[torch.dtype] = None) -> dict:
    """``param_dtype=torch.bfloat16`` selects pure-bf16 training (master
    weights in bf16)."""
    opt_cfg = opt_cfg or OptConfig()
    params = model.init(generator)
    if param_dtype is not None:
        params = tr.tree_map(lambda p: p.to(param_dtype), params)
    return {"params": params, "opt": init_opt_state(params, opt_cfg)}


def _grads(loss_fn, params, batch):
    """(metrics, grads of the total loss over every leaf of ``params``,
    zeros where a leaf does not reach the loss)."""
    leaves = [p.detach().requires_grad_(True) for p in tr.leaves(params)]
    with torch.enable_grad():
        total, metrics = loss_fn(tr.unflatten(params, leaves), batch)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else _placed_as(g, p)
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return metrics, tr.unflatten(params, grads)


def _placed_as(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Gradient ``g`` in the placements of its parameter ``p`` (FSDP's
    reduce-scatter of a partial sum), so that the optimizer's update is
    local to each shard."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _split(batch: dict, microbatches: int) -> list[dict]:
    """The batch split along axis 0 into ``microbatches`` parts.  A DTensor
    batch splits each rank's own rows, so microbatch i holds the i-th
    block of every rank's rows (the rows of a one-rank mesh in order); the
    mean over microbatches is the same.  Where a rank holds fewer rows
    than ``microbatches`` (a microbatch has fewer rows than the batch has
    ranks), it splits into as many parts as each rank's rows allow
    (their gcd with ``microbatches``), every rank keeping its share of
    each: the mean over the rows is the same, where ``microbatches`` parts
    would spread a microbatch's rows unevenly and leave ranks idle."""
    first = next(iter(batch.values()))
    if isinstance(first, DTensor):
        rows = first.to_local().shape[0]
        if rows and rows % microbatches:
            microbatches = math.gcd(rows, microbatches)

    def parts(x):
        if not isinstance(x, DTensor):
            x = torch.as_tensor(x)
        if x.shape[0] % microbatches:
            raise ValueError(f"batch axis {x.shape[0]} is not a multiple of "
                             f"{microbatches} microbatches")
        if isinstance(x, DTensor) and x.to_local().shape[0] % microbatches:
            # no rows on this rank: each microbatch's rows spread over the
            # ranks anew
            return [distribute_tensor(c, x.device_mesh, x.placements,
                                      src_data_rank=None)
                    for c in torch.chunk(x.full_tensor(), microbatches)]
        if isinstance(x, DTensor):
            return [DTensor.from_local(c, x.device_mesh, x.placements,
                                       run_check=False)
                    for c in torch.chunk(x.to_local(), microbatches, dim=0)]
        return torch.chunk(x, microbatches, dim=0)
    cols = {k: parts(v) for k, v in batch.items()}
    return [{k: c[i] for k, c in cols.items()} for i in range(microbatches)]


def make_train_step(model: Model, opt_cfg: Optional[OptConfig] = None,
                    microbatches: int = 1,
                    accum_dtype: torch.dtype = torch.float32):
    """Returns ``train_step(state, batch) -> (state, metrics)``; the state
    is updated in place."""
    if model.ctx.use_kernels:
        raise ValueError("training takes the plain route: build the model "
                         "with ParallelCtx(use_kernels=False) (the kernels "
                         "have no backward)")
    opt_cfg = opt_cfg or OptConfig()
    loss_fn = make_loss_fn(model)

    def train_step(state: dict, batch: dict):
        params = state["params"]
        if microbatches <= 1:
            metrics, grads = _grads(loss_fn, params, batch)
        else:
            g_acc = tr.tree_map(lambda p: torch.zeros_like(
                p, dtype=accum_dtype), params)
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=tr.leaves(params)[0].device)
            parts = _split(batch, microbatches)
            for mb in parts:
                m, g = _grads(loss_fn, params, mb)
                for a, b in zip(tr.leaves(g_acc), tr.leaves(g)):
                    a.add_(b.to(accum_dtype))
                loss_sum = loss_sum + m["loss"]
                del g
            grads = g_acc
            for a in tr.leaves(grads):
                a.div_(len(parts))
            metrics = {"loss": loss_sum / len(parts),
                       "aux": torch.zeros_like(loss_sum)}
        new_params, new_opt, opt_metrics = adamw_update(
            params, grads, state["opt"], opt_cfg)
        metrics.update(opt_metrics)
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def make_eval_step(model: Model):
    loss_fn = make_loss_fn(model)

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = loss_fn(params, batch)
        return metrics

    return eval_step
