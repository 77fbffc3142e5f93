"""Dispatch between a kernel's plain PyTorch version and its CUDA
kernel, and the registry of the kernels on the serving path.

The rule (one place, every wrapper follows it): operands that all lie
on the CPU take the plain version; operands that all lie on a CUDA
device launch the hand-written kernel, which either runs or raises —
there is no fallback from a CUDA tensor to the plain version.
Anything else (mixed devices, another device type) raises.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def runs_kernel(name: str, *tensors: torch.Tensor) -> bool:
    """True when ``name`` must launch its CUDA kernel on ``tensors``,
    False when it must run its plain version."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"{name}: operands on {sorted(str(t.device) for t in tensors)};"
                     f" expected all on the CPU (plain version) or all on "
                     f"one CUDA device (the kernel)")


def path_kernels() -> Tuple:
    """The CUDA kernels of the serving path, each with its launch
    count."""
    from repro_torch.kernels import (flash_prefill, paged_attention,
                                     paged_attention_int8, ssd_scan)
    return (paged_attention.DECODE_KERNEL, flash_prefill.PAGED_KERNEL,
            flash_prefill.FLASH_KERNEL, ssd_scan.SSD_KERNEL,
            paged_attention_int8.DECODE_INT8_KERNEL)


def reset_launch_counts() -> None:
    for k in path_kernels():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {k.symbol: k.launches for k in path_kernels()}
