"""The chunked-prefill steps' share of the chip's peak, as
``mfu.decode`` for the chunk steps of the profiled span, in %."""
from muxbench.metrics import step_share


def read(run):
    return step_share(run, "chunk")
