"""Architecture configs (copy of ``repro.configs``): one module per
architecture, each with its published ``CONFIG`` and a ``REDUCED``
variant of the same family for CPU tests.

The port serves every family the reference's engine serves: dense
(``qwen2-7b``, ``qwen3-14b``, ``deepseek-coder-33b``,
``command-r-plus-104b``), vlm and audio as token decoders
(``phi-3-vision-4.2b``, ``musicgen-medium``), MoE
(``granite-moe-3b-a800m``, ``qwen3-moe-235b-a22b``), SSM
(``mamba2-2.7b``) and hybrid (``zamba2-1.2b``).
``get(name)`` / ``get_reduced(name)`` resolve the dashed id or the
module name; an unknown name raises ``ValueError``.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.config import ModelConfig

ARCH_IDS: List[str] = [
    "musicgen_medium",
    "qwen2_7b",
    "granite_moe_3b_a800m",
    "zamba2_1p2b",
    "qwen3_14b",
    "phi_3_vision_4p2b",
    "command_r_plus_104b",
    "mamba2_2p7b",
    "qwen3_moe_235b_a22b",
    "deepseek_coder_33b",
]

# canonical dashed ids → module names
ALIASES = {
    "musicgen-medium": "musicgen_medium",
    "qwen2-7b": "qwen2_7b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "zamba2-1.2b": "zamba2_1p2b",
    "qwen3-14b": "qwen3_14b",
    "phi-3-vision-4.2b": "phi_3_vision_4p2b",
    "command-r-plus-104b": "command_r_plus_104b",
    "mamba2-2.7b": "mamba2_2p7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "deepseek-coder-33b": "deepseek_coder_33b",
}


def _module(name: str):
    mod_name = ALIASES.get(name, name if name in ARCH_IDS else None)
    if mod_name is None:
        raise ValueError(
            f"unknown architecture {name!r}: the port serves "
            f"{sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    """Reduced variant of the same family for CPU smoke tests."""
    return _module(name).REDUCED


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get(a) for a in ARCH_IDS}
