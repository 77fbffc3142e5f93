"""Host time a tick in the read-back's tokens (``readback.tokens``: the
argmax, its copy to the host and ``.numpy()``), in us."""
from muxbench.program import spans_per_tick_us


def read(run):
    return spans_per_tick_us(run, "readback.tokens")
