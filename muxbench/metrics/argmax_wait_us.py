"""Host time a tick in ``greedy_tokens``: the finite check and argmax
read back, where the host waits for the card to finish the step."""
from muxbench.metrics import per_tick_us


def read(run):
    if run.probe is None:
        return None
    return per_tick_us(run, run.probe.host["argmax"])
