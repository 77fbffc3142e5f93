"""Parameter trees of the dense family (port of the init half of
``repro/models/transformer.py``) and the bridge that carries the JAX
package's weights across.

Trees have the JAX package's shapes and keys leaf for leaf:
``{"tok": {embed, out_norm, lm_head}, "layers": {wq, wk, wv, wo, [bq,
bk, bv], [q_norm, k_norm], w_gate, w_up, w_down, ln1, ln2}}`` with
per-layer leaves stacked ``[L, ...]`` and matrices ``[d_in, d_out]``.
The serving engine runs its own forward (``serving/engine.py``); the
training forward waits for the training slice.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig, pad_vocab
from repro_torch.models.layers import init_attn, init_embed, init_mlp

Params = Dict


def init_params(cfg: ModelConfig, gen: torch.Generator,
                dtype=torch.bfloat16, device="cuda") -> Params:
    """Random weights for a dense model, drawn from ``gen`` (its device
    must be ``device``).  Same tree shapes as the JAX package's
    ``init_params``; the numbers differ (another generator)."""
    if cfg.family not in ("dense", "vlm", "audio"):
        raise ValueError(f"the port serves the dense family so far, not "
                         f"{cfg.family!r} ({cfg.name})")
    device = resolve_device(device)
    v_pad = pad_vocab(cfg.vocab_size)
    L = cfg.n_layers
    return {
        "tok": init_embed(cfg, v_pad, gen, dtype, device),
        "layers": {
            **init_attn(cfg, L, gen, dtype, device),
            **init_mlp(cfg.d_model, cfg.d_ff, L, gen, dtype, device),
            "ln1": torch.ones((L, cfg.d_model), dtype=dtype, device=device),
            "ln2": torch.ones((L, cfg.d_model), dtype=dtype, device=device),
        },
    }


def params_to_torch(tree, device="cuda", dtype=torch.float32) -> Params:
    """Turn a parameter tree of numpy arrays (the JAX package's tree
    mapped through ``np.asarray``) into the port's tree: same nesting,
    same layout — ``[L, d_in, d_out]`` applied as ``x @ w``, a leading
    ``[M, ...]`` axis where stacked — no transposes."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_to_torch(v, device, dtype) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32)).to(
        device=device, dtype=dtype)
