"""AdamW + schedules (port of ``repro/train/optimizer.py``).

Optimizer state mirrors the param tree (m, v in float32).  Unlike the
JAX package, ``apply_updates`` updates the parameters, the moments and
the step counter IN PLACE under ``torch.no_grad()`` and returns the same
tensors: a full-width update then needs a few leaf-sized temporaries,
not a second copy of every tree, and a captured step
(``train/graphs.py``) reads and advances the same buffers at every
replay.  The arithmetic is the reference's, in float32.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.train.pytree import (Path, flatten_with_path, leaves,
                                      tree_map)

Pytree = Any


class AdamWState(NamedTuple):
    step: torch.Tensor         # int32 scalar
    m: Pytree                  # first moment  (f32, like params)
    v: Pytree                  # second moment (f32, like params)


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    min_lr_frac: float = 0.1


def cosine_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup → cosine decay to ``min_lr_frac·lr`` (float32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5
                    * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_state(params: Pytree) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    first = leaves(params)
    device = first[0].device if first else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree: Pytree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Pytree, max_norm: float
                        ) -> Tuple[Pytree, torch.Tensor]:
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def _decay_mask(path: Path, leaf) -> bool:
    """Weight decay applies to matrices only (no norms/biases/scalars);
    the reference's rule by key name, verbatim."""
    name = str(path[-1]) if path else ""
    if leaf.dim() <= 1:
        return False
    return not any(s in name for s in ("norm", "ln", "bias", "a_log",
                                       "dt_bias", "d_skip"))


@torch.no_grad()
def apply_updates(params: Pytree, grads: Pytree, state: AdamWState,
                  cfg: AdamWConfig) -> Tuple[Pytree, AdamWState, dict]:
    """One AdamW step: clip the gradients by their global norm, then
    update every parameter, both moments and the step counter in place.
    Returns (params, state, {"lr", "grad_norm"}): the same tensors, the
    step advanced."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state.step.add_(1)
    lr = cosine_lr(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)
    for (path, p), g, m, v in zip(flatten_with_path(params), leaves(grads),
                                  leaves(state.m), leaves(state.v)):
        g32 = (g * scale.to(g.dtype)).float()
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * g32 * g32)
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        if _decay_mask(path, p):
            delta.add_(cfg.weight_decay * p.float())
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, state, {"lr": lr, "grad_norm": gnorm}
