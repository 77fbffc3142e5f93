"""Kernel 4 (``ssd_scan.cu``): its calls' bound time over its device
time in the profiled span, in %."""
from muxbench.metrics import kernel_share


def read(run):
    return kernel_share(run, "k4")
