"""Dispatch between a kernel's plain PyTorch version and its CUDA
kernel, and the registry of the kernels on the serving path.

The rule (one place, every wrapper follows it): operands that all lie
on the CPU take the plain version; operands that all lie on a CUDA
device launch the hand-written kernel, which either runs or raises —
there is no fallback from a CUDA tensor to the plain version.
Operands that all lie on ``meta`` (the dry-run's shapes without data,
``launch/dryrun.py``) take the plain version: no data exists to hide
from the kernel.  Anything else (mixed devices, another device type,
a ``DTensor``) raises.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def runs_kernel(name: str, *tensors: torch.Tensor) -> bool:
    """True when ``name`` must launch its CUDA kernel on ``tensors``,
    False when it must run its plain version.  A ``DTensor`` operand
    raises: on a mesh a kernel runs on local shards
    (``models/layers.local_region``), never on a distributed tensor."""
    for t in tensors:
        if type(t) is not torch.Tensor and _is_dtensor(t):
            raise TypeError(f"{name}: a DTensor operand; run the kernel "
                            f"on its local shards")
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"} or kinds == {"meta"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"{name}: operands on {sorted(str(t.device) for t in tensors)};"
                     f" expected all on the CPU or all on meta (plain version) "
                     f"or all on one CUDA device (the kernel)")


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def path_kernels() -> Tuple:
    """The CUDA kernels of the serving path, each with its launch
    count."""
    from repro_torch.kernels import (flash_prefill, moe_grouped,
                                     paged_attention, paged_attention_int8,
                                     ssd_scan)
    return (paged_attention.DECODE_KERNEL, flash_prefill.PAGED_KERNEL,
            flash_prefill.FLASH_KERNEL, ssd_scan.SSD_KERNEL,
            paged_attention_int8.DECODE_INT8_KERNEL, moe_grouped.MOE_KERNEL)


def reset_launch_counts() -> None:
    for k in path_kernels():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {k.symbol: k.launches for k in path_kernels()}
