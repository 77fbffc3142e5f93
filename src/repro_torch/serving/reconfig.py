"""Live-reconfiguration control plane (port of ``repro/serving/reconfig.py``).

This slice ports the drift monitor only: the serving driver feeds it
every arrival and reports its final per-LLM EWMA rate estimates next to
the planned rates, in every run.  The online re-planner and the
migration executor arrive with the reconfiguration slice.
"""
from __future__ import annotations

from typing import Dict


class WorkloadMonitor:
    """EWMA per-LLM arrival-rate estimator.

    Observation is push-based: the serving loop reports every arrival
    (``observe``) and closes windows against its own clock
    (``advance(now)``) — the monitor never reads time itself, so
    deterministic runs stay bit-reproducible.  Each closed
    ``interval``-second window folds the windowed rates into EWMAs:

        r̂ ← (1−α)·r̂ + α·(count / interval)

    The JAX package's drift trigger (thresholds, hysteresis, rebase)
    arrives with the re-planner that consumes it.
    """

    def __init__(self, planned_rates: Dict[str, float],
                 interval: float = 1.0, alpha: float = 0.5):
        if not (interval > 0 and 0 < alpha <= 1):
            raise ValueError(f"bad monitor window {interval} / alpha {alpha}")
        self.planned = dict(planned_rates)
        self.interval = float(interval)
        self.alpha = float(alpha)
        # EWMAs start AT the plan: an undisturbed workload shows zero
        # drift from the first window instead of a cold-start spike
        self.rate_ewma: Dict[str, float] = dict(planned_rates)
        self._counts: Dict[str, int] = {m: 0 for m in planned_rates}
        self._window_end = self.interval

    def observe(self, model: str) -> None:
        """Record one arrival in the current window."""
        if model not in self._counts:
            self._counts[model] = 0
            self.rate_ewma.setdefault(model, 0.0)
            self.planned.setdefault(model, 0.0)
        self._counts[model] += 1

    def advance(self, now: float) -> int:
        """Close every window that ends at or before ``now``; returns
        the number closed.  A window with NO arrivals at all (a trace
        gap, the end-of-trace drain) is closed but frozen: no EWMA
        fold, as in the JAX package."""
        closed = 0
        while now >= self._window_end:
            if any(self._counts.values()):
                a = self.alpha
                for m in self._counts:
                    self.rate_ewma[m] = ((1 - a) * self.rate_ewma[m]
                                         + a * self._counts[m] / self.interval)
                    self._counts[m] = 0
            self._window_end += self.interval
            closed += 1
        return closed
