"""Attention and SSD-scan kernels: hand-written CUDA for Hopper with a
plain PyTorch version beside each (see ``ops.runs_kernel`` for the
dispatch rule)."""
