"""AdamW with dtype-configurable state (fp32 / bf16), warmup-cosine
schedule and global-norm clipping over trees of tensors — the reference
package's ``optim/adamw.py`` on PyTorch.

State layout, as in the reference:
    state = {"step": int32 scalar, "m": tree, "v": tree}
The math is the reference's, in float32: bias corrections from ``step``
as float32, every leaf upcast with ``.float()`` and cast back to its own
dtype (``state_dtype`` for m and v).  Leaves are walked in the order of
``jax.tree_util.tree_flatten`` (:mod:`repro_torch.tree`), which fixes the
float32 sum of :func:`global_norm`.

:func:`adamw_update` writes the new parameters and moments **into the
tensors it is given**, one leaf at a time under ``torch.no_grad``, so the
update holds one leaf's temporaries beyond the state: the reference
donates its state to the jitted step (``donate_argnums``) for the same
peak.  The caller's old state is consumed, as a donated one is.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from .. import tree as tr

Tree = Any


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    state_dtype: torch.dtype = torch.float32   # bf16 halves optimizer memory


def schedule(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """Warmup then cosine decay to ``min_lr_frac``; float32, elementwise."""
    step = step.to(torch.float32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init_opt_state(params: Tree, cfg: OptConfig) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)
    dev = tr.leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": tr.tree_map(zeros, params),
            "v": tr.tree_map(zeros, params)}


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the float32 sum of the leaves' float32 squared sums."""
    sums = [torch.sum(torch.square(x.float())) for x in tr.leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp_max(max_norm / torch.clamp_min(gnorm, 1e-12), 1.0)


def clip_by_global_norm(grads: Tree, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before scaling); each leaf keeps its dtype."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, max_norm)
    return tr.tree_map(lambda g: (g.float() * scale).to(g.dtype),
                       grads), gnorm


@torch.no_grad()
def adamw_update(params: Tree, grads: Tree, state: dict,
                 cfg: OptConfig) -> tuple[Tree, dict, dict]:
    """One AdamW step over ``grads`` (clipped to ``cfg.grad_clip``).

    Returns ``(params, state, {"lr", "grad_norm"})``; the parameter and
    moment tensors returned are the ones passed in, updated in place."""
    step = state["step"] + 1
    lr = schedule(step, cfg)
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)

    p_leaves = tr.leaves(params)
    g_leaves, m_leaves, v_leaves = (tr.leaves(t) for t in
                                    (grads, state["m"], state["v"]))
    if not len(p_leaves) == len(g_leaves) == len(m_leaves) == len(v_leaves):
        raise ValueError("params, grads and moments differ in structure")
    for p, g, m, v in zip(p_leaves, g_leaves, m_leaves, v_leaves):
        # the clipped gradient keeps its dtype, as in clip_by_global_norm
        gf = (g.float() * scale).to(g.dtype).float()
        m_new = b1 * m.float() + (1 - b1) * gf
        v_new = b2 * v.float() + (1 - b2) * torch.square(gf)
        mh = m_new / bc1
        vh = v_new / bc2
        pf = p.float()
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * pf
        p.copy_(pf - lr * delta)
        m.copy_(m_new)
        v.copy_(v_new)
    new_state = {"step": step, "m": state["m"], "v": state["v"]}
    return params, new_state, {"lr": lr, "grad_norm": gnorm}
