"""The decode steps' share of the chip's peak: over the decode steps of
the profiled span (the window's last seconds), the sum of each step's
bound time (weights once, the rows' cache or state, bytes at 3.35 TB/s
against model FLOPs at 989 TFLOP/s, the longer) over the sum of its
device time, the union of the device operations the step launched, read
from the CUPTI trace (the host's plan and launch are not in it), in %."""
from muxbench.metrics import step_share


def read(run):
    return step_share(run, "decode")
