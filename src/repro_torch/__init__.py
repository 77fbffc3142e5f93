"""PyTorch/CUDA port of the MuxServe reproduction (``repro``).

Same layout and names as ``src/repro/``; the JAX package stays the
reference and this package imports nothing of it.  Every TPU kernel on
the serving path has a hand-written Hopper counterpart under
``kernels/csrc/`` with a plain PyTorch version beside it: a wrapper
runs the plain version for CPU tensors and launches the CUDA kernel for
CUDA tensors (it never falls back).  Entry points take a ``device``
argument that defaults to ``"cuda"``.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (the default of
    every entry point) raises when no GPU is present; pass
    ``device="cpu"`` to run on the CPU explicitly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on an NVIDIA GPU by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev
