"""Metric readers, one file a metric, found by the metric's name:
``metrics/<name>.py`` holds ``read(run)``, which returns the metric's
value from a run's record, or None where the run holds nothing to read
(the harness then leaves the metric out of the result line).

``run`` has ``window`` (``harness.Window``: the requests' times on the
session clock, the tokens committed in the window, the ticks),
``setup_s``, and in a traced run ``probe`` (``probe.Probe``: host
seconds by span, the profiled steps with their bound seconds, the
profiled span's trace).
"""
from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

HERE = Path(__file__).resolve().parent


def module(name: str):
    """The metric's file as a module: ``read(run)``, and for the tails
    ``per_request(run)``, each window request's value in seconds."""
    path = HERE / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"muxbench.metrics._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    return module(name).read


def read(name: str, run) -> Optional[float]:
    return reader(name)(run)


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q``-th percentile over every value (linear between order
    statistics), None on no values."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


def window_requests(run):
    """The requests due inside the window: those ``attempted``."""
    return [s for s in run.window.requests if s.window]


def per_tick_us(run, seconds: float) -> Optional[float]:
    ticks = run.probe.ticks if run.probe is not None else 0
    return seconds / ticks * 1e6 if ticks else None


def step_share(run, *kinds: str) -> Optional[float]:
    """Bound seconds of the profiled steps of ``kinds`` over their device
    seconds in the trace (the union of the device operations each step
    launched; ``probe.step_reads``), in percent."""
    if run.probe is None or run.probe.trace is None:
        return None
    reads = [run.probe.trace["steps"][k] for k in kinds
             if k in run.probe.trace["steps"]]
    bound = sum(r["bound_s"] for r in reads)
    device = sum(r["device_s"] for r in reads)
    if device <= 0 or bound <= 0:
        return None
    return 100.0 * bound / device


def kernel_share(run, key: str) -> Optional[float]:
    """Bound seconds of the profiled steps' calls of kernel ``key`` over
    that kernel's device time in the profiled span, in percent."""
    if run.probe is None or run.probe.trace is None:
        return None
    dev = run.probe.trace["groups"].get(key)
    bound = sum(s.kernel_bound_s.get(key, 0.0) for s in run.probe.steps)
    if not dev or not bound:
        return None
    return 100.0 * bound / dev
