"""Parameter trees of every family (port of the init half of
``repro/models/transformer.py``) and the bridge that carries the JAX
package's weights across.

Trees have the JAX package's shapes and keys leaf for leaf, per-layer
leaves stacked ``[L, ...]`` and matrices ``[d_in, d_out]``:

  dense  ``{"tok": {embed, out_norm, [lm_head]}, "layers": {wq, wk, wv,
         wo, [bq, bk, bv], [q_norm, k_norm], w_gate, w_up, w_down, ln1,
         ln2}}`` (also vlm and audio, whose frontends are stubs)
  moe    the dense tree with the MLP replaced by ``models/moe.init_moe``'s
         ``router`` [L, d, E] (float32) and experts ``w_gate``, ``w_up``
         [L, E, d, f_e], ``w_down`` [L, E, f_e, d]
  ssm    ``{"tok", "layers": {<mamba2 leaves>, ln1}}``
  hybrid the ssm tree plus ``"shared_attn"``: one attention + MLP block
         (Zamba2-style tied weights) with its own ``ln1``/``ln2``, every
         leaf ``[1, ...]``.
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
from repro_torch.models.mamba2 import FLOAT32_LEAVES, init_mamba2
from repro_torch.models.moe import init_moe

Params = Dict

# leaves the JAX package keeps in float32 whatever the tree's dtype
_F32_LEAVES = set(FLOAT32_LEAVES) | {"router"}


def init_params(cfg: ModelConfig, gen: torch.Generator,
                dtype=torch.bfloat16, device="cuda") -> Params:
    """Random weights for a model of any family, drawn from ``gen`` (its
    device must be ``device``).  Same tree shapes as the JAX package's
    ``init_params``; the numbers differ (another generator)."""
    if cfg.family not in ("dense", "vlm", "audio", "moe", "ssm", "hybrid"):
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.name})")
    device = resolve_device(device)
    v_pad = pad_vocab(cfg.vocab_size)
    L, d = cfg.n_layers, cfg.d_model

    def ones(n):
        return torch.ones((n, d), dtype=dtype, device=device)
    p: Params = {"tok": init_embed(cfg, v_pad, gen, dtype, device)}
    if cfg.family in ("ssm", "hybrid"):
        p["layers"] = {**init_mamba2(cfg, L, gen, dtype, device),
                       "ln1": ones(L)}
        if cfg.family == "hybrid":
            p["shared_attn"] = {
                **init_attn(cfg, 1, gen, dtype, device),
                **init_mlp(d, cfg.d_ff, 1, gen, dtype, device),
                "ln1": ones(1), "ln2": ones(1)}
        return p
    # attention first, then the FFN: the generator's draws in tree order
    layers = init_attn(cfg, L, gen, dtype, device)
    layers.update(init_moe(cfg, L, gen, dtype, device) if cfg.family == "moe"
                  else init_mlp(d, cfg.d_ff, L, gen, dtype, device))
    p["layers"] = {**layers, "ln1": ones(L), "ln2": ones(L)}
    return p


def params_to_torch(tree, device="cuda", dtype=torch.float32,
                    _key: str = "") -> Params:
    """Turn a parameter tree of numpy arrays (the JAX package's tree
    mapped through ``np.asarray``) into the port's tree: same nesting,
    same layout — ``[L, d_in, d_out]`` applied as ``x @ w``, a leading
    ``[M, ...]`` axis where stacked — no transposes.  Leaves go to
    ``dtype``, except the leaves the JAX package keeps in float32 (the
    Mamba2 ``FLOAT32_LEAVES`` and the MoE ``router``), which stay
    float32, and the leaves of
    a quantized tree (``serving.quantize.quantize_params``): int8
    values ``*_q`` stay int8 and their scales ``*_s`` float32."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_to_torch(v, device, dtype, k)
                for k, v in tree.items()}
    if _key.endswith("_q"):
        return torch.from_numpy(np.array(tree, np.int8)).to(device)
    to = torch.float32 if (_key in _F32_LEAVES
                           or _key.endswith("_s")) else dtype
    return torch.from_numpy(np.array(tree, np.float32)).to(
        device=device, dtype=to)
