"""Workload generation (copy of ``repro/core/workload.py``).

Synthetic workloads: per-LLM request rates from a power-law with
exponent α, arrival times from Poisson processes, request lengths from
a ShareGPT-like distribution (mean prompt 161 tokens, mean output 338 —
paper §2.1).  The same generator, seed for seed, as the JAX package's,
so both packages serve identical traces.  The port keeps the part the
serving path uses; the simulator-side helpers stay in ``repro``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# request-level workload
# ---------------------------------------------------------------------------
@dataclass
class RequestSpec:
    model: str
    arrival: float
    prompt_len: int
    output_len: int
    # explicit prompt token content (len == prompt_len), for traces
    # with cross-request structure the consumer must preserve — e.g.
    # shared prefixes (``shared_prefix_trace``).  None → the driver
    # draws tokens itself, exactly as before.
    prompt_tokens: Optional[List[int]] = None
    # which prefix-pool entry this request reuses (−1 = unique prompt)
    prefix_id: int = -1


@dataclass
class Workload:
    """A trace: per-model rates + a flat arrival-ordered request list."""
    rates: Dict[str, float]                     # req/s per model
    requests: List[RequestSpec] = field(default_factory=list)
    horizon: float = 0.0

    @property
    def total_rate(self) -> float:
        return sum(self.rates.values())

    def per_model(self) -> Dict[str, List[RequestSpec]]:
        out: Dict[str, List[RequestSpec]] = {m: [] for m in self.rates}
        for r in self.requests:
            out[r.model].append(r)
        return out


def power_law_rates(models: Sequence[str], alpha: float, max_rate: float,
                    scale_to_avg: Optional[float] = None) -> Dict[str, float]:
    """Rate_i ∝ (i+1)^(−α), scaled so max = max_rate (paper §4.2) or so
    the mean equals ``scale_to_avg`` when given."""
    n = len(models)
    raw = np.array([(i + 1.0) ** (-alpha) for i in range(n)])
    rates = raw / raw.max() * max_rate
    if scale_to_avg is not None:
        rates = rates / rates.mean() * scale_to_avg
    return {m: float(r) for m, r in zip(models, rates)}


def sharegpt_lengths(rng: np.random.Generator, n: int,
                     mean_prompt: int = 161, mean_output: int = 338,
                     max_len: int = 2048
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Lognormal lengths matched to ShareGPT means (σ chosen to mimic
    its heavy tail), clipped to [4, max_len].  The paper-scale defaults
    (161/338, §2.1) feed the simulator; the runtime driver
    (serving/driver.py) passes reduced means so the same distribution
    shape serves CPU-scale engines."""
    def ln(mean, sigma):
        mu = math.log(mean) - sigma ** 2 / 2
        return np.clip(rng.lognormal(mu, sigma, n).astype(int), 4, max_len)
    return ln(mean_prompt, 0.9), ln(mean_output, 0.8)


def poisson_trace(rates: Dict[str, float], horizon: float, seed: int = 0,
                  mean_prompt: int = 161, mean_output: int = 338,
                  max_len: int = 2048) -> Workload:
    """Poisson arrivals per model at EXPLICIT per-model rates.

    The arrival-process core shared by ``synthesize`` (power-law rates)
    and by placement-driven serving, where the rates come from a plan's
    ``LLMSpec``s instead (``serving/driver.units_from_placement`` +
    ``launch/serve.py --placement``)."""
    rng = np.random.default_rng(seed)
    reqs: List[RequestSpec] = []
    for m, rate in rates.items():
        if rate <= 0:
            continue
        n_exp = rng.poisson(rate * horizon)
        times = np.sort(rng.uniform(0, horizon, n_exp))
        pl, ol = sharegpt_lengths(rng, n_exp, mean_prompt, mean_output,
                                  max_len)
        reqs.extend(RequestSpec(m, float(t), int(p), int(o))
                    for t, p, o in zip(times, pl, ol))
    reqs.sort(key=lambda r: r.arrival)
    return Workload(rates=dict(rates), requests=reqs, horizon=horizon)


def synthesize(models: Sequence[str], alpha: float, max_rate: float,
               horizon: float, seed: int = 0,
               scale_to_avg: Optional[float] = None,
               mean_prompt: int = 161, mean_output: int = 338,
               max_len: int = 2048) -> Workload:
    """Poisson arrivals per model at power-law rates over ``horizon`` s.

    One generator for BOTH consumers: the discrete-event simulator
    (``core/simulator.simulate``) and the real-engine serving driver
    (``serving/driver.serve_workload``) replay the same ``Workload``,
    so runtime SLO numbers are directly comparable to the simulator's
    predictions for the same trace.  ``mean_prompt`` / ``mean_output``
    rescale the ShareGPT-shaped length distribution (the runtime's
    reduced models use shorter sequences; the distribution shape and
    the Poisson/power-law arrival process are unchanged).
    """
    rates = power_law_rates(models, alpha, max_rate, scale_to_avg)
    return poisson_trace(rates, horizon, seed, mean_prompt, mean_output,
                         max_len)
