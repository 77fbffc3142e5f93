"""Training step: CE loss → grad → AdamW update (port of
``repro/train/train_step.py``).

``make_train_step`` returns the eager step; the trainer
(``launch/train.py``) runs it through ``train/graphs.compile_train_step``,
the reference's ``jax.jit``: on the card one CUDA graph holds the whole
step.  Autograd differentiates ``loss_fn`` with respect to detached
aliases of the parameters (the caller's tensors do not become autograd
leaves); ``apply_updates`` then writes the update, the moments and the
step counter in place.  On CUDA tensors the forward runs kernels 3 and
4, whose backward is the VJP of their plain versions
(``kernels/flash_prefill``, ``kernels/ssd_scan``).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import transformer
from repro_torch.train.optimizer import AdamWConfig, AdamWState, apply_updates
from repro_torch.train.pytree import leaves, tree_map, unflatten


def _value_and_grad(loss_of, params, *args):
    alias = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = loss_of(alias, *args)
    grads = torch.autograd.grad(loss, leaves(alias))
    return loss.detach(), unflatten(params, grads)


def make_train_step(cfg: ModelConfig, opt: AdamWConfig,
                    remat: bool = True, microbatches: int = 1) -> Callable:
    """``microbatches > 1`` splits the global batch and accumulates
    gradients in f32 — one optimizer update per step, as the reference's
    ``lax.scan`` over microbatches."""

    def loss_of(p, tokens, labels, prefix_emb):
        return transformer.loss_fn(p, cfg, tokens, labels,
                                   prefix_emb=prefix_emb, remat=remat)

    def train_step(params, opt_state: AdamWState, tokens, labels,
                   prefix_emb=None):
        if microbatches == 1:
            loss, grads = _value_and_grad(loss_of, params, tokens, labels,
                                          prefix_emb)
        else:
            M = microbatches
            B = tokens.shape[0]
            if B % M:
                raise ValueError(f"batch {B} is not a multiple of "
                                 f"{M} microbatches")
            n = B // M
            loss = torch.zeros((), dtype=torch.float32,
                               device=tokens.device)
            g_acc = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            for i in range(M):
                rows = slice(i * n, (i + 1) * n)
                pe = None if prefix_emb is None else prefix_emb[rows]
                li, g = _value_and_grad(loss_of, params, tokens[rows],
                                        labels[rows], pe)
                for a, gi in zip(leaves(g_acc), leaves(g)):
                    a.add_(gi.float() / M)
                loss = loss + li / M
            grads = tree_map(lambda g, p: g.to(p.dtype), g_acc, params)
        params2, opt_state2, info = apply_updates(params, grads, opt_state,
                                                  opt)
        return params2, opt_state2, {"loss": loss, **info}

    return train_step


def make_eval_step(cfg: ModelConfig) -> Callable:
    @torch.no_grad()
    def eval_step(params, tokens, labels, prefix_emb=None):
        loss = transformer.loss_fn(params, cfg, tokens, labels,
                                   prefix_emb=prefix_emb, remat=False)
        return {"loss": loss}

    return eval_step
