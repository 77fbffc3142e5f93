"""Architecture registry: arch-id → (config, init, forward) (port of
``repro/models/registry.py``)."""
from __future__ import annotations

import torch

from repro_torch import configs
from repro_torch.config import ModelConfig
from repro_torch.models import transformer


def get_config(arch: str) -> ModelConfig:
    return configs.get(arch)


def get_reduced_config(arch: str) -> ModelConfig:
    return configs.get_reduced(arch)


def init(cfg: ModelConfig, gen: torch.Generator, dtype=torch.bfloat16,
         device="cuda"):
    """Random weights drawn from ``gen`` (the port's ``init_params``;
    the JAX package's takes a PRNG key instead)."""
    return transformer.init_params(cfg, gen, dtype, device)


def forward(params, cfg: ModelConfig, tokens, **kw):
    return transformer.forward(params, cfg, tokens, **kw)


def list_archs():
    return list(configs.ARCH_IDS)
