"""Rehearse one cell on the CPU from the checkout this runs in, and print
what its runs show as one JSON line.

    python rehearse.py <cell> <seed>

Run from the root of a checkout holding ``BENCHMARK.json`` and
``muxbench/``, with the program on ``PYTHONPATH``.  The cell runs at
reduced width (``tests/cells.limited``), untraced and then traced.  Its
steps go through the port's graph registry with a capture for CPU
operands, which records a key as a card's capture would, so a bucket
the warm-up missed shows as a capture in the fill or the window.  The
traced run's probe records every window step's shapes and bounds (no
CUPTI on the CPU, so no device metric)."""
from __future__ import annotations

import json
import os
import sys
import time

sys.path[0] = os.getcwd()      # the checkout's muxbench, not this folder's

import torch  # noqa: E402

from muxbench import harness, run  # noqa: E402
from muxbench import probe as probe_mod  # noqa: E402
from muxbench.tests.cells import limited  # noqa: E402


class CpuCapture:
    """A capture on CPU operands: the eager run's output is the call's,
    recording runs nothing (a step that writes state in place must not
    run twice), a replay runs the body into the static output."""

    device_types = ("cpu",)

    def __init__(self):
        self._last = None

    def eager(self, fn, device):
        self._last = fn()
        return self._last

    def record(self, key, fn, device):
        out, self._last = torch.empty_like(self._last), None
        return (lambda body: out.copy_(body())), out


class Kept(probe_mod.Probe):
    """The probe, recording every window step as if profiled."""
    made: list = []

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        Kept.made.append(self)

    def at(self, now, t0, t1):
        super().at(now, t0, t1)
        self.profiling = self.in_window

    def finish(self):
        self.profiling = False
        super().finish()


def main() -> int:
    name, seed = sys.argv[1], int(sys.argv[2])
    harness.port()
    from repro_torch.serving import graphs
    graphs.REGISTRY.clear()
    graphs.REGISTRY.capture = CpuCapture()
    probe_mod.Probe = Kept
    cell = limited(name)
    out = {}
    for trace in (False, True):
        r = run.run_cell(cell, seed, 2.0, trace, device="cpu",
                         t_start=time.perf_counter())
        log = r["_log"]
        out["traced" if trace else "untraced"] = dict(
            correct=r["correct"], checks=r["checks"],
            metrics=sorted(r["metrics"]),
            warm_captures=log["graphs captured in warm-up"],
            whole_prompt_probes=log["whole-prompt probes in warm-up"],
            window_captures=log["graphs captured in fill and window"])
        graphs.REGISTRY.clear()
    (probe,) = Kept.made
    out["host_steps_s"] = probe.host["steps"]
    out["steps"] = [dict(kind=s.kind, parts=s.parts, bound_s=s.bound_s,
                         kernels=s.kernel_bound_s, host_s=s.host_s)
                    for s in probe.steps]
    out["models"] = harness.engine_models(cell.config)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
