"""Kernel 1 (``paged_decode.cu`` with ``decode_splitkv.cuh``): its
calls' bound time over its device time in the profiled span (the union
of its split and combine kernels' intervals), in %."""
from muxbench.metrics import kernel_share


def read(run):
    return kernel_share(run, "k1")
