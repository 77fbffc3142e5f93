"""Host time a tick in the engine steps (``serving/engine.py``,
``serving/graphs.py``): the host plan, the inputs' copy and the graph
replay's launch."""
from muxbench.metrics import per_tick_us


def read(run):
    if run.probe is None:
        return None
    return per_tick_us(run, run.probe.host["steps"])
