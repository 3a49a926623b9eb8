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

from typing import Any, Optional

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
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
    else:
        logz, gold = _sharded_logz_and_gold(logits, safe)
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp_min(mask.sum(), 1)


def _sharded_logz_and_gold(logits: DTensor, safe) -> tuple:
    """``logsumexp`` and the gold logit of DTensor logits.  DTensor's
    gather of the gold column from vocab-sharded logits fails; a
    compare-and-sum against vocabulary ids laid out as the logits' last
    dim picks the same value exactly (one nonzero term per row), each rank
    on its own block of the vocabulary."""
    last = logits.ndim - 1
    ids = distribute_tensor(
        torch.arange(logits.shape[-1], device=logits.device),
        logits.device_mesh,
        [Shard(0) if p.is_shard(last) else Replicate()
         for p in logits.placements], src_data_rank=None)
    gold = torch.where(ids == safe[..., None], logits, 0.0).sum(-1)
    return torch.logsumexp(logits, dim=-1), gold


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
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return metrics, tr.unflatten(params, grads)


def _split(batch: dict, microbatches: int) -> list[dict]:
    def parts(x):
        if not isinstance(x, DTensor):
            x = torch.as_tensor(x)
        if x.shape[0] % microbatches:
            raise ValueError(f"batch axis {x.shape[0]} is not a multiple of "
                             f"{microbatches} microbatches")
        if isinstance(x, DTensor) and x.to_local().shape[0] % microbatches:
            # fewer rows per rank than microbatches: each microbatch's rows
            # spread over the ranks anew (some ranks hold none)
            return [distribute_tensor(c, x.device_mesh, x.placements,
                                      src_data_rank=None)
                    for c in torch.chunk(x.full_tensor(), microbatches)]
        if isinstance(x, DTensor):
            # each rank splits its own rows, so microbatch i holds the i-th
            # block of every rank's rows (the rows of a one-rank mesh in
            # order); the mean over microbatches is the same
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
            for mb in _split(batch, microbatches):
                m, g = _grads(loss_fn, params, mb)
                for a, b in zip(tr.leaves(g_acc), tr.leaves(g)):
                    a.add_(b.to(accum_dtype))
                loss_sum = loss_sum + m["loss"]
                del g
            grads = g_acc
            for a in tr.leaves(grads):
                a.div_(microbatches)
            metrics = {"loss": loss_sum / microbatches,
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
