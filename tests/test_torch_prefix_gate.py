"""The JAX package's ``prefix_cache`` serving CI gate
(``benchmarks/prefix_cache.py``) held on the port on the CPU, at the
gate's ``--quick`` setup: three reduced qwen2-7b engines fused on one
pool of 20,000 head-blocks, 16-token chunks, 4 slots, ADBS, α 2.1 at a
12 req/s peak over 3 s of ``shared_prefix_trace`` (48-token prompts and
prefixes, 4 prefixes an LLM, 10-token outputs) at reuse 0, 0.5 and 0.9,
served under the deterministic tick-cost clock.  The port's engines
carry the JAX package's weights (``_torch_twins``).

1. Parity: at reuse 0 the cache-on run equals the cache-off run bit for
   bit (attainment, ticks, horizon, TTFT p50) with 0 hits.
2. Monotone gain: mean SLO attainment never falls as reuse grows.
3. Strict win: at reuse 0.9 the cache strictly improves TTFT p50 and
   the attainment at some scale, and worsens it at none.
4. Hit-rate floor: the measured hit rate is at least 0.5 × the trace's
   analytic ceiling (``prefix_repeat_fraction``).

And the port's reuse-0.9 cache-on report, its ``prefix`` section
included, equals the JAX package's gate run (``wall_s`` apart).
"""
import pytest
import torch

from _torch_twins import CPU, reference_trees, report_text
from repro.core import workload as jworkload
from repro.serving import driver as JD
from repro_torch.core.workload import (power_law_rates, prefix_repeat_fraction,
                                       shared_prefix_trace)
from repro_torch.serving.driver import (TickCostModel, build_unit_from_specs,
                                        serve_workload)

torch.set_num_threads(2)

# benchmarks/prefix_cache.py's constants and its --quick run
ARCH = "qwen2-7b"
N_MODELS = 3
ALPHA = 2.1
CHUNK_TOKENS = 16
MAX_SLOTS = 4
MEAN_PROMPT, MEAN_OUTPUT = 48, 10
PREFIX_LEN, N_PREFIXES = 48, 4
SLO_SCALES = (1.5, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0)
REUSE_LEVELS = (0.0, 0.5, 0.9)
HIT_FLOOR_FACTOR = 0.5
MAX_RATE, HORIZON, POOL_BLOCKS = 12.0, 3.0, 20_000
NAMES = [f"llm{i}" for i in range(N_MODELS)]
TRACE = dict(seed=0, mean_prompt=MEAN_PROMPT, mean_output=MEAN_OUTPUT,
             max_len=256, n_prefixes=N_PREFIXES, prefix_len=PREFIX_LEN)
UNIT = dict(pool_blocks=POOL_BLOCKS, max_slots=MAX_SLOTS,
            chunk_tokens=CHUNK_TOKENS, seed=0, policy="adbs", fused=True)


def _specs(rates):
    return [(n, ARCH, rates[n]) for n in NAMES]


def _attainment(rep) -> dict:
    return {s: rep.aggregate.attainment[s] for s in SLO_SCALES}


def _hits_lookups(rep) -> tuple:
    return (sum(p["hits"] for p in rep.prefix.values()),
            sum(p["lookups"] for p in rep.prefix.values()))


@pytest.fixture(scope="module")
def gate():
    """The gate's five port runs: (reuse, cache) → report."""
    rates = power_law_rates(NAMES, ALPHA, MAX_RATE)
    trees = reference_trees(_specs(rates), seed=0)
    traces = {r: shared_prefix_trace(rates, HORIZON, reuse=r, **TRACE)
              for r in REUSE_LEVELS}
    wl0 = traces[0.0]
    for r, wl in traces.items():                  # the sweep is nested
        assert [(q.model, q.arrival, q.prompt_len, q.output_len)
                for q in wl.requests] == \
               [(q.model, q.arrival, q.prompt_len, q.output_len)
                for q in wl0.requests], r

    def serve(reuse, cache):
        unit = build_unit_from_specs(_specs(rates), params=trees,
                                     prefix_cache=cache, **UNIT, **CPU)
        return serve_workload([unit], traces[reuse], seed=1,
                              slo_scales=SLO_SCALES, cost=TickCostModel())
    runs = {(r, True): serve(r, True) for r in REUSE_LEVELS}
    runs[(0.0, False)] = serve(0.0, False)
    runs[(0.9, False)] = serve(0.9, False)
    return rates, traces, runs


def test_gate_parity_at_reuse_zero(gate):
    _, traces, runs = gate
    base0, on0 = runs[(0.0, False)], runs[(0.0, True)]
    assert len(traces[0.0].requests) == 51
    assert _attainment(base0) == _attainment(on0), \
        "a never-hitting cache must reproduce the uncached run bit for bit"
    assert base0.ticks == on0.ticks and base0.horizon == on0.horizon
    assert base0.aggregate.ttft.p50 == on0.aggregate.ttft.p50
    assert _hits_lookups(on0)[0] == 0, on0.prefix


def test_gate_attainment_monotone_in_reuse(gate):
    _, _, runs = gate
    means = []
    for r in REUSE_LEVELS:
        att = _attainment(runs[(r, True)])
        means.append(sum(att.values()) / len(att))
    for lo, hi in zip(means[:-1], means[1:]):
        assert hi >= lo - 1e-9, means


def test_gate_strict_win_at_high_reuse(gate):
    _, _, runs = gate
    on, off = runs[(0.9, True)], runs[(0.9, False)]
    assert on.aggregate.ttft.p50 < off.aggregate.ttft.p50
    att_on, att_off = _attainment(on), _attainment(off)
    assert any(att_on[s] > att_off[s] for s in SLO_SCALES), (att_on, att_off)
    assert all(att_on[s] >= att_off[s] - 1e-9 for s in SLO_SCALES), \
        (att_on, att_off)


def test_gate_hit_rate_floor(gate):
    _, traces, runs = gate
    bound = prefix_repeat_fraction(traces[0.9])
    hits, lookups = _hits_lookups(runs[(0.9, True)])
    assert hits > 0 and hits / lookups >= HIT_FLOOR_FACTOR * bound, \
        (hits, lookups, bound)


def test_gate_high_reuse_report_equals_reference(gate):
    """The reference gate's reuse-0.9 cache-on run (JAX package, its own
    trace generator and weights) gives the port's report and prefix
    counters."""
    rates, _, runs = gate
    wl = jworkload.shared_prefix_trace(rates, HORIZON, reuse=0.9, **TRACE)
    unit = JD.build_unit_from_specs(_specs(rates), prefix_cache=True, **UNIT)
    rep = JD.serve_workload([unit], wl, seed=1, slo_scales=SLO_SCALES,
                            cost=JD.TickCostModel())
    port = runs[(0.9, True)]
    assert port.prefix == rep.prefix
    assert report_text(port) == report_text(rep)
