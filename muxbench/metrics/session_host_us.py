"""Host time a tick in the driver (``serving/driver.py``):
``ServeSession.step`` minus ``MuxScheduler.tick``."""
from muxbench.metrics import per_tick_us


def read(run):
    if run.probe is None:
        return None
    h = run.probe.host
    return per_tick_us(run, h["session"] - h["tick"])
