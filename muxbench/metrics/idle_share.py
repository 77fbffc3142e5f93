"""The share of the profiled span in which no operation ran on the
device, in %."""


def read(run):
    t = run.probe.trace if run.probe is not None else None
    if not t or t["window_s"] <= 0 or t["kernels"] == 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
