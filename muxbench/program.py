"""The program's own spans and counters in a traced run: what the
readers of ``plan_host_us``, ``launch_host_us``, ``finite_wait_us``,
``token_copy_us``, ``alloc_host_us``, ``decode_row_fill``,
``chunk_token_fill`` and ``queue_wait_ms`` (``muxbench/metrics/``)
share.

Each reads ``probe.program``, the record of the port's span recorder
(``repro_torch.serving.metrics.RECORDER``) over the window, and returns
None without one.  ``ProgramProbe`` keeps that record: it arms the
recorder while installed, empties it when the window opens and disarms
it when the window closes.  ``muxbench.run`` makes a plain
``probe.Probe``, which keeps none, so these metrics are not yet listed
in ``BENCHMARK.json``.
"""
from __future__ import annotations

from typing import Optional

from muxbench import metrics
from muxbench import probe as probe_mod

PROGRAM_METRICS = ("plan_host_us", "launch_host_us", "finite_wait_us",
                   "token_copy_us", "alloc_host_us", "decode_row_fill",
                   "chunk_token_fill", "queue_wait_ms")


def recorder():
    """The port's span recorder, or None where the port has none."""
    from repro_torch.serving import metrics as program_metrics
    return getattr(program_metrics, "RECORDER", None)


class ProgramProbe(probe_mod.Probe):
    """``probe.Probe`` that keeps the program's record of the window as
    ``program`` (see the module's header)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.recorder = recorder()
        self.program = None
        self._opened = False

    def install(self) -> None:
        super().install()
        if self.recorder is not None:
            self.recorder.arm()

    def uninstall(self) -> None:
        if self.recorder is not None:
            self.recorder.disarm()
        super().uninstall()

    def at(self, now: float, t0: float, t1: float) -> None:
        rec = self.recorder
        if rec is not None and not self._opened and now >= t0:
            rec.reset()              # what the fill period recorded goes
            self._opened = True
        super().at(now, t0, t1)
        if rec is not None and now >= t1:
            rec.disarm()

    def finish(self) -> None:
        if self.recorder is not None:
            self.recorder.disarm()
            self.program = self.recorder.record()
        super().finish()


def program(run):
    """The run's program record (``ProgramProbe``), or None."""
    return getattr(getattr(run, "probe", None), "program", None)


def spans_per_tick_us(run, *names: str) -> Optional[float]:
    """The summed host time of the spans named ``names`` a window tick,
    in us; None where the record holds none of them."""
    rec = program(run)
    if rec is None or not any(rec.count(n) for n in names):
        return None
    return metrics.per_tick_us(run, rec.total_ns(*names) / 1e9)


def fill_percent(run, kind: str) -> Optional[float]:
    """100 x the counter ``<kind>.real`` over ``<kind>.computed``."""
    rec = program(run)
    if rec is None:
        return None
    computed = rec.counters.get(kind + ".computed", 0)
    if not computed:
        return None
    return 100.0 * rec.counters.get(kind + ".real", 0) / computed
