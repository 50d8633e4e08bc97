"""AdamW + schedules over dicts of tensors, in torch.

The port of ``repro.training.optimizer``.  The optimizer state has the
parameters' tree structure (``{"m": tree, "v": tree}``), and the update
follows the reference op for op in float32: global-norm clipping, bias
correction, weight decay on tensors of two or more dims only, and, with
``skip_nonfinite``, no change at all when the gradient norm is not
finite.

Unlike the reference, whose arrays are immutable, :func:`adamw_update`
writes the new parameters and moments into the given tensors in place
(under ``torch.no_grad()``) and returns the same trees: a step needs no
second copy of the 3 × parameter-sized state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from .tree import leaves_with_paths, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # distributed-optimization tricks
    grad_dtype: str = "float32"       # "bfloat16" = compressed grad accum
    skip_nonfinite: bool = True       # drop the update on inf/nan grads


def lr_schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio, as a float32 scalar
    on ``step``'s device (``step`` an int or an integer tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) \
        * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def init_opt_state(params) -> Dict[str, Any]:
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params)}


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for _, x in leaves_with_paths(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params, grads, opt_state, step):
    """Returns (params, opt_state, metrics); ``params`` and the moments are
    updated in place and returned.  ``step`` is the step count before
    this update (an int or an integer tensor)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    finite = torch.isfinite(gnorm)
    step = torch.as_tensor(step, device=gnorm.device)
    lr = lr_schedule(cfg, step)
    t = (step + 1).to(torch.float32)
    bc1 = 1 - torch.pow(cfg.b1, t)
    bc2 = 1 - torch.pow(cfg.b2, t)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        pf = p.to(torch.float32)
        if p.dim() >= 2:   # no weight decay on norms/biases/scalars
            delta = delta + cfg.weight_decay * pf
        p_new = pf - lr * delta
        if cfg.skip_nonfinite:
            p_new = torch.where(finite, p_new, pf)
            m_new = torch.where(finite, m_new, m)
            v_new = torch.where(finite, v_new, v)
        p.copy_(p_new)
        m.copy_(m_new)
        v.copy_(v_new)

    tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    metrics = {"grad_norm": gnorm, "lr": lr,
               "nonfinite": (~finite).to(torch.float32)}
    return params, opt_state, metrics


__all__ = ["OptimizerConfig", "adamw_update", "global_norm",
           "init_opt_state", "lr_schedule"]
