"""Host time a tick in the scheduler (``serving/mux.py``: ADBS,
``FusedGroup``): ``MuxScheduler.tick`` minus the step calls and the
argmax read-backs."""
from muxbench.metrics import per_tick_us


def read(run):
    if run.probe is None:
        return None
    h = run.probe.host
    return per_tick_us(run, h["tick"] - h["steps"] - h["argmax"])
