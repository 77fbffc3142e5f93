"""Host time a tick in the read-back's finite check
(``readback.finite``: ``torch.isfinite(logits).all()``, where the host
waits for the step to finish on the card), in us."""
from muxbench.program import spans_per_tick_us


def read(run):
    return spans_per_tick_us(run, "readback.finite")
