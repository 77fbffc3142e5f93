"""Workload generation (copy of ``repro/core/workload.py``, paper
§4.1–4.2).

Synthetic workloads: per-LLM request rates from a power-law with
exponent α (larger α → fewer LLMs take more traffic; α=0.9 ≈ 20% of
LLMs get 50% of traffic, α=2.1 ≈ 20% get 90%), arrival times from
Poisson processes, request lengths from a ShareGPT-like distribution
(mean prompt 161 tokens, mean output 338 — paper §2.1).  The same
generators, seed for seed, as the JAX package's, so both packages
serve and simulate identical traces.

The model mix follows Table 1: {4–8B: 12, 8–21B: 4, 21–41B: 2,
41–70B: 1} LLaMA-family models.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.config import BLOCK_TOKENS, ModelConfig

# ---------------------------------------------------------------------------
# LLaMA-family size buckets (paper Table 1)
# ---------------------------------------------------------------------------
_LLAMA_SHAPES = {
    # name: (layers, d_model, heads, kv_heads, d_ff)
    "llama-7b": (32, 4096, 32, 32, 11008),
    "llama-13b": (40, 5120, 40, 40, 13824),
    "llama-30b": (60, 6656, 52, 52, 17920),
    "llama-65b": (80, 8192, 64, 64, 22016),
}

TABLE1_MIX: List[Tuple[str, int]] = [
    ("llama-7b", 12), ("llama-13b", 4), ("llama-30b", 2), ("llama-65b", 1),
]


def llama_config(name: str, tag: str = "") -> ModelConfig:
    l, d, h, kv, f = _LLAMA_SHAPES[name]
    return ModelConfig(
        name=f"{name}{tag}", family="dense", n_layers=l, d_model=d,
        n_heads=h, n_kv_heads=kv, d_ff=f, vocab_size=32000,
        source="arXiv:2302.13971 (LLaMA)")


def table1_models() -> List[ModelConfig]:
    out = []
    for name, count in TABLE1_MIX:
        for i in range(count):
            out.append(llama_config(name, tag=f"-{i}"))
    return out


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


def piecewise_poisson_trace(segments: Sequence[Tuple[float, Dict[str, float]]],
                            horizon: float, seed: int = 0,
                            mean_prompt: int = 161, mean_output: int = 338,
                            max_len: int = 2048) -> Workload:
    """Regime-shift traces: piecewise-constant per-LLM rate schedules.

    ``segments`` is ``[(t_start, rates), ...]`` sorted ascending with
    ``t_start == 0`` first; segment k spans ``[t_k, t_{k+1})`` (the
    last runs to ``horizon``) and draws Poisson arrivals per LLM at
    that segment's rates.  This is the workload the live
    reconfiguration subsystem exists for (serving/reconfig.py;
    OServe/AlpaServe-style popularity drift — e.g. a popularity flip
    at t=H/2): a static placement solved for segment 0 strands quota
    and mesh capacity once the rates shift.  ``Workload.rates``
    carries the TIME-AVERAGED per-LLM rates, so quota splits and drift
    baselines start from the honest long-run mix.  Deterministic for
    a fixed seed, like every generator here.
    """
    assert segments and segments[0][0] == 0.0, \
        "segments must start at t=0"
    starts = [t for t, _ in segments]
    assert starts == sorted(starts), "segments must be time-sorted"
    assert horizon > starts[-1], "horizon must extend past the last segment"
    rng = np.random.default_rng(seed)
    names = sorted({m for _, rates in segments for m in rates})
    avg = {m: 0.0 for m in names}
    reqs: List[RequestSpec] = []
    for k, (t0, seg_rates) in enumerate(segments):
        t1 = segments[k + 1][0] if k + 1 < len(segments) else horizon
        span = t1 - t0
        for m in names:
            rate = seg_rates.get(m, 0.0)
            avg[m] += rate * span / horizon
            if rate <= 0:
                continue
            n = rng.poisson(rate * span)
            times = np.sort(rng.uniform(t0, t1, n))
            pl, ol = sharegpt_lengths(rng, n, mean_prompt, mean_output,
                                      max_len)
            reqs.extend(RequestSpec(m, float(t), int(p), int(o))
                        for t, p, o in zip(times, pl, ol))
    reqs.sort(key=lambda r: r.arrival)
    return Workload(rates=avg, requests=reqs, horizon=horizon)


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


def shared_prefix_trace(rates: Dict[str, float], horizon: float,
                        seed: int = 0, mean_prompt: int = 161,
                        mean_output: int = 338, max_len: int = 2048,
                        n_prefixes: int = 8, prefix_len: int = 48,
                        zipf_a: float = 1.5, reuse: float = 0.9
                        ) -> Workload:
    """Chat/agent-style trace with shared prompt prefixes (DESIGN.md
    §13): each LLM owns a pool of ``n_prefixes`` fixed token prefixes
    (system prompts / few-shot headers); with probability ``reuse`` a
    request opens with a Zipf-popular pool prefix (rank ``zipf_a``)
    followed by unique tokens, otherwise its prompt is entirely
    unique.

    Built on ``poisson_trace``'s arrival/length process with the SAME
    rng consumption at every ``reuse`` level: the reuse coin, Zipf
    rank and a full-length unique draw are consumed for every request
    and the coin merely selects between them.  Two traces differing
    only in ``reuse`` therefore share arrivals, lengths, Zipf ranks
    and suffixes exactly, and raising ``reuse`` only flips unique
    prompts into shared ones — a NESTED sweep, which is what makes the
    monotone-attainment CI gate (benchmarks/prefix_cache.py)
    meaningful rather than noise.

    Tokens are drawn in ``[1, 2^20)``; the driver maps them into each
    model's vocab with a fixed modular map, preserving cross-request
    prefix equality (``serving/driver.requests_from_workload``).
    """
    wl = poisson_trace(rates, horizon, seed, mean_prompt, mean_output,
                       max_len)
    rng = np.random.default_rng(seed + 0x5EED)
    pools = {m: [rng.integers(1, 1 << 20, prefix_len).tolist()
                 for _ in range(n_prefixes)]
             for m in sorted(wl.rates)}
    for spec in wl.requests:
        u = float(rng.uniform())
        j = int(min(rng.zipf(zipf_a), n_prefixes) - 1)
        unique = rng.integers(1, 1 << 20, spec.prompt_len).tolist()
        if u < reuse:
            pl = min(prefix_len, spec.prompt_len)
            spec.prompt_tokens = (pools[spec.model][j][:pl]
                                  + unique[pl:])
            spec.prefix_id = j
        else:
            spec.prompt_tokens = unique
            spec.prefix_id = -1
    return wl


def prefix_repeat_fraction(wl: Workload,
                           block_tokens: int = BLOCK_TOKENS) -> float:
    """Analytic ceiling on the prefix-cache request hit rate of a
    ``shared_prefix_trace``: the fraction of requests that repeat an
    EARLIER request's prefix with at least one adoptable full block.

    Request r (prefix j) is counted iff some earlier request q shares
    prefix j and the common token run ``s = min(prefix coverage of q,
    of r)`` spans ≥ 1 full block the cache could actually hand over —
    the adoption clamp keeps the prompt's last token computed, so r
    also needs ``prompt_len > block_tokens``.  A run that admits every
    request AFTER its prefix donor finished prefill hits exactly this
    fraction; concurrent admissions (donor still prefilling, nothing
    indexed yet) can only lower it, which is why the CI gate checks
    ``measured ≥ factor × bound`` with a documented slack factor, not
    equality."""
    if not wl.requests:
        return 0.0
    # best-coverage donor seen so far per (model, prefix): prefix
    # coverage grows with prompt length (capped at the pool prefix),
    # so the longest prompt is the best donor; the common run with it
    # is measured directly on tokens — no generator parameters needed
    reps: Dict[Tuple[str, int], List[int]] = {}
    hits = 0
    for spec in wl.requests:
        if spec.prefix_id < 0 or spec.prompt_tokens is None:
            continue
        toks = spec.prompt_tokens
        key = (spec.model, spec.prefix_id)
        rep = reps.get(key)
        if rep is not None:
            s = 0
            for a, b in zip(rep, toks):
                if a != b:
                    break
                s += 1
            if (s // block_tokens >= 1
                    and (spec.prompt_len - 1) // block_tokens >= 1):
                hits += 1
        if rep is None or len(toks) > len(rep):
            reps[key] = toks
    return hits / len(wl.requests)


def cumulative_rate_distribution(rates: Dict[str, float]) -> np.ndarray:
    """Fig. 6: cumulative share of traffic of the top-k LLMs."""
    vals = np.sort(np.array(list(rates.values())))[::-1]
    return np.cumsum(vals) / vals.sum()


def chatlmsys_like(n_models: int = 16, horizon: float = 600.0,
                   avg_rate: float = 4.8, seed: int = 0) -> Workload:
    """Real-workload stand-in (§4.3): 16 LLMs where ~20% of the models
    receive ~50% of the traffic (α≈0.9), rates rescaled to ``avg_rate``,
    with mild sinusoidal non-stationarity like the ChatLMSYS trace."""
    rng = np.random.default_rng(seed)
    models = [f"llm-{i}" for i in range(n_models)]
    wl = synthesize(models, alpha=0.9, max_rate=avg_rate * 3,
                    horizon=horizon, seed=seed, scale_to_avg=avg_rate)
    # modulate arrivals with a slow daily-ish wave (thinning)
    kept = []
    for r in wl.requests:
        p = 0.75 + 0.25 * math.sin(2 * math.pi * r.arrival / horizon)
        if rng.uniform() < p:
            kept.append(r)
    wl.requests = kept
    return wl
