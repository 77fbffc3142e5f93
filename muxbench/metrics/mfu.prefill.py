"""The prefill steps' share of the chip's peak, as ``mfu.decode`` for
the chunked-prefill steps and the whole-prompt prefill steps of the
profiled span together, in %."""
from muxbench.metrics import step_share


def read(run):
    return step_share(run, "chunk", "prefill")
