"""The compiled train step: one CUDA graph per (step, batch shapes,
parameter and state storage) — the port's counterpart of the JAX
package's ``jax.jit(make_train_step(...))`` (``repro/launch/train.py``).

``compile_train_step(step_fn)`` wraps a step of ``make_train_step`` and
keeps its signature.  The graph holds the whole step: the forward
(kernels 3 and 4), ``torch.autograd.grad`` (their plain-VJP backward and
the remat recompute), the microbatch accumulation and the AdamW update,
which writes the parameters, the moments and the step counter in place
(``train/optimizer.py``).  It goes through the serving steps' registry,
capture and pool (``serving/graphs.py``), as the kind ``train``:

* key: the batch tensors' shapes and dtypes (so whether ``prefix_emb``
  is given), the compiled step itself (its ``cfg``, ``remat`` and
  microbatches), and the storage of every parameter leaf, every moment
  leaf and the step counter.  A graph holds raw pointers: a call on
  another tree (one restored from a checkpoint) captures anew, and a
  graph goes when a tensor of its tree dies.  A new batch shape is a
  new key, as ``jax.jit`` traces anew.
* first sight: the step runs once eagerly on a side stream (kernel
  builds, ctypes binding, cuBLAS workspaces and the autograd engine's
  device thread start there, outside the capture) and its result is
  the call's; then it is captured, which runs nothing, so the
  parameters are stepped once.
* later calls: the batch is copied into the graph's static inputs (from
  the host through a pinned buffer), the graph replays, and the call
  returns ``params`` and ``opt_state`` — the same tensors, updated in
  place — with the metrics cloned out of the static output.

Operands on the CPU run the step eagerly, and so does every call inside
``serving.graphs.disable_graphs()`` (the reference's
``jax.disable_jit()``).  A failed capture or replay raises: there is no
quiet retreat to the eager step.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.serving import graphs
from repro_torch.train.optimizer import AdamWState
from repro_torch.train.pytree import leaves

METRICS = ("loss", "lr", "grad_norm")


class _Step:
    """One compiled step's place in the registry's keys; its graphs go
    when it dies."""


def compile_train_step(step_fn: Callable) -> Callable:
    """``step_fn`` (``make_train_step``'s) as one CUDA graph per key on
    the card; the same signature, ``(params, opt_state, tokens, labels,
    prefix_emb=None) -> (params, opt_state, metrics)``.  The batch may
    lie on the host or on the parameters' card."""
    ident = _Step()

    def body(params, opt_state, *batch):
        m = step_fn(params, opt_state, *batch)[2]
        return torch.stack([m[k] for k in METRICS])

    def compiled(params, opt_state: AdamWState, tokens, labels,
                 prefix_emb=None):
        batch = (tokens, labels) + (() if prefix_emb is None
                                    else (prefix_emb,))
        dev = opt_state.step.device
        if not graphs.REGISTRY.enabled(dev):
            return step_fn(params, opt_state, *(t.to(dev) for t in batch))
        p_leaves, s_leaves = leaves(params), leaves(opt_state)
        layout = tuple((tuple(t.shape), t.dtype) for t in batch)
        slot = ("train", None, layout, id(ident),
                tuple(t.data_ptr() for t in p_leaves))
        key = (slot, tuple(t.data_ptr() for t in s_leaves))
        out = graphs.REGISTRY.step(
            "train", key, p_leaves + s_leaves + [ident], dev, batch,
            lambda *b: body(params, opt_state, *b))
        return params, opt_state, {k: out[i] for i, k in enumerate(METRICS)}

    return compiled
