"""Architecture configs the port serves (copy of ``repro.configs``).

The port serves the dense ``qwen2-7b``, the SSM ``mamba2-2.7b`` and the
hybrid ``zamba2-1.2b``; the dense ``qwen3-14b`` (QK-norm) runs the
serve steps of ``launch/steps.py``.  The other architectures of
``repro.configs`` arrive with their model families.
``get(name)`` / ``get_reduced(name)`` resolve the dashed id.
"""
from __future__ import annotations

import importlib

from repro_torch.config import ModelConfig

# canonical dashed ids → module names (only families the port serves)
ALIASES = {
    "qwen2-7b": "qwen2_7b",
    "qwen3-14b": "qwen3_14b",
    "mamba2-2.7b": "mamba2_2p7b",
    "zamba2-1.2b": "zamba2_1p2b",
}


def _module(name: str):
    mod_name = ALIASES.get(name)
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
