"""Attention, SSD-scan and grouped-expert MoE kernels: hand-written CUDA
for Hopper with a plain PyTorch version beside each (see
``ops.runs_kernel`` for the dispatch rule)."""
