"""The port's workload generators and discrete-event simulator against
the JAX package's, on the CPU.

* Every test of ``tests/test_workload.py`` and ``tests/test_simulator.py``,
  run on ``repro_torch.core``.
* Parity, exact: ``piecewise_poisson_trace``, ``shared_prefix_trace`` and
  ``chatlmsys_like`` traces equal request by request (with the prefix
  trace's tokens and ``prefix_repeat_fraction``), and every ``SimReport``
  field equal for ``simulate`` in the modes ``spatial-temporal``,
  ``temporal`` and ``spatial`` under the policies ``adbs`` and
  ``fcfs``.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import costmodel as jcm
from repro.core import placement as JP
from repro.core import simulator as JS
from repro.core import workload as JW
from repro_torch.core import costmodel as tcm
from repro_torch.core.estimator import LLMSpec
from repro_torch.core.placement import place, place_spatial
from repro_torch.core.simulator import UnitSim, simulate
from repro_torch.core.workload import (chatlmsys_like,
                                       cumulative_rate_distribution,
                                       llama_config, piecewise_poisson_trace,
                                       power_law_rates, prefix_repeat_fraction,
                                       sharegpt_lengths, shared_prefix_trace,
                                       synthesize, table1_models)


# ---------------------------------------------------------------------------
# workload generation (paper §4.1–4.2, Table 1, Fig. 6)
# ---------------------------------------------------------------------------
def test_table1_mix():
    models = table1_models()
    assert len(models) == 19                     # 12 + 4 + 2 + 1
    sizes = [m.param_count() for m in models]
    assert sum(1 for s in sizes if s < 8e9) == 12
    assert sum(1 for s in sizes if s > 41e9) == 1


def test_power_law_skew():
    names = [f"m{i}" for i in range(20)]
    r_low = power_law_rates(names, alpha=0.9, max_rate=20)
    r_high = power_law_rates(names, alpha=2.1, max_rate=20)
    cdf_low = cumulative_rate_distribution(r_low)
    cdf_high = cumulative_rate_distribution(r_high)
    top20 = max(1, len(names) // 5)
    # paper: α=0.9 → top 20% take ~50%; α=2.1 → ~90%
    assert 0.35 <= cdf_low[top20 - 1] <= 0.65
    assert cdf_high[top20 - 1] >= 0.8
    assert cdf_high[top20 - 1] > cdf_low[top20 - 1]


def test_max_rate_respected():
    r = power_law_rates([f"m{i}" for i in range(10)], 1.3, max_rate=20)
    assert np.isclose(max(r.values()), 20)


def test_poisson_arrival_counts():
    wl = synthesize([f"m{i}" for i in range(4)], alpha=1.0, max_rate=8.0,
                    horizon=200.0, seed=0)
    for m, rate in wl.rates.items():
        n = sum(1 for r in wl.requests if r.model == m)
        expect = rate * wl.horizon
        assert abs(n - expect) < 5 * np.sqrt(expect) + 5, (m, n, expect)
    arr = [r.arrival for r in wl.requests]
    assert arr == sorted(arr)


def test_sharegpt_lengths():
    rng = np.random.default_rng(0)
    p, o = sharegpt_lengths(rng, 20000)
    assert 100 <= p.mean() <= 240            # mean prompt ≈ 161
    assert 230 <= o.mean() <= 470            # mean output ≈ 338
    assert p.min() >= 4 and p.max() <= 2048


def test_piecewise_segment_rates():
    """Per-segment arrival counts follow that segment's rates (a
    popularity flip at t=H/2), and the trace's ``rates`` field is the
    time-averaged mix."""
    H = 400.0
    wl = piecewise_poisson_trace(
        [(0.0, {"a": 6.0, "b": 1.0}), (H / 2, {"a": 1.0, "b": 6.0})],
        horizon=H, seed=0)
    assert wl.rates == {"a": 3.5, "b": 3.5}
    for model, pre_rate, post_rate in (("a", 6.0, 1.0), ("b", 1.0, 6.0)):
        pre = sum(1 for r in wl.requests
                  if r.model == model and r.arrival < H / 2)
        post = sum(1 for r in wl.requests
                   if r.model == model and r.arrival >= H / 2)
        for n, rate in ((pre, pre_rate), (post, post_rate)):
            expect = rate * H / 2
            assert abs(n - expect) < 5 * np.sqrt(expect) + 5, \
                (model, n, expect)
    arr = [r.arrival for r in wl.requests]
    assert arr == sorted(arr)
    assert max(arr) < H


def _as_tuples(wl):
    return [(r.model, r.arrival, r.prompt_len, r.output_len)
            for r in wl.requests]


def test_piecewise_deterministic():
    seg = [(0.0, {"a": 4.0}), (2.0, {"a": 0.5, "b": 8.0})]
    w1 = piecewise_poisson_trace(seg, horizon=6.0, seed=3)
    w2 = piecewise_poisson_trace(seg, horizon=6.0, seed=3)
    w3 = piecewise_poisson_trace(seg, horizon=6.0, seed=4)
    assert _as_tuples(w1) == _as_tuples(w2)
    assert _as_tuples(w1) != _as_tuples(w3)


def test_piecewise_rejects_bad_segments():
    with pytest.raises(AssertionError):
        piecewise_poisson_trace([(1.0, {"a": 1.0})], horizon=2.0)
    with pytest.raises(AssertionError):
        piecewise_poisson_trace([(0.0, {"a": 1.0}), (3.0, {"a": 2.0})],
                                horizon=2.0)


def test_chatlmsys_like():
    wl = chatlmsys_like(n_models=16, horizon=100.0, avg_rate=2.0, seed=1)
    assert len(wl.rates) == 16
    cdf = cumulative_rate_distribution(wl.rates)
    assert 0.3 <= cdf[2] <= 0.75              # ~20% models ≈ 50% traffic
    assert len(wl.requests) > 0


# ---------------------------------------------------------------------------
# trace parity: request by request
# ---------------------------------------------------------------------------
def _requests(wl):
    return [dataclasses.asdict(r) for r in wl.requests]


@pytest.mark.parametrize("seed", [0, 7])
def test_piecewise_trace_equals_reference(seed):
    seg = [(0.0, {"a": 6.0, "b": 1.0}), (3.0, {"a": 1.0, "c": 4.0}),
           (5.0, {"b": 2.5})]
    kw = dict(horizon=8.0, seed=seed, mean_prompt=256, mean_output=40,
              max_len=512)
    t = piecewise_poisson_trace(seg, **kw)
    j = JW.piecewise_poisson_trace(seg, **kw)
    assert _requests(t) == _requests(j) and len(t.requests) > 20
    assert (t.rates, t.horizon) == (j.rates, j.horizon)


@pytest.mark.parametrize("reuse", [0.0, 0.5, 0.9])
def test_shared_prefix_trace_equals_reference(reuse):
    rates = {"x": 6.0, "y": 2.0}
    t = shared_prefix_trace(rates, 4.0, seed=3, mean_prompt=96,
                            mean_output=8, reuse=reuse)
    j = JW.shared_prefix_trace(rates, 4.0, seed=3, mean_prompt=96,
                               mean_output=8, reuse=reuse)
    assert _requests(t) == _requests(j) and len(t.requests) > 20
    assert all(r.prompt_tokens is not None for r in t.requests)
    assert prefix_repeat_fraction(t) == JW.prefix_repeat_fraction(j)
    assert prefix_repeat_fraction(t, block_tokens=4) \
        == JW.prefix_repeat_fraction(j, block_tokens=4)
    if reuse:
        assert prefix_repeat_fraction(t) > 0


def test_chatlmsys_like_equals_reference():
    t = chatlmsys_like(n_models=16, horizon=100.0, avg_rate=2.0, seed=1)
    j = JW.chatlmsys_like(n_models=16, horizon=100.0, avg_rate=2.0, seed=1)
    assert _requests(t) == _requests(j)
    assert t.rates == j.rates
    assert cumulative_rate_distribution(t.rates).tolist() \
        == JW.cumulative_rate_distribution(j.rates).tolist()


# ---------------------------------------------------------------------------
# discrete-event simulator: conservation, baselines ordering, SLO
# monotonicity — the substrate of the paper's end-to-end claims
# ---------------------------------------------------------------------------
def _models(n=4, alpha=1.3, max_rate=6.0, lc=llama_config):
    names = ["llama-7b", "llama-7b", "llama-13b", "llama-30b"][:n]
    cfgs = [lc(nm, f"-{i}") for i, nm in enumerate(names)]
    rates = [max_rate * (i + 1) ** -alpha for i in range(n)]
    return list(zip(cfgs, rates))


def _workload(models, horizon=60.0, seed=0, syn=synthesize):
    names = [cfg.name for cfg, _ in models]
    wl = syn(names, alpha=1.3, max_rate=max(r for _, r in models),
             horizon=horizon, seed=seed)
    wl.rates = {cfg.name: r for cfg, r in models}
    return wl


@pytest.fixture(scope="module")
def setting():
    models = _models()
    wl = _workload(models)
    mux_pl = place(models, n_devices=8, group_limit=32)
    sp_pl = place_spatial(models, n_devices=8)
    return models, wl, mux_pl, sp_pl


def test_conservation(setting):
    _, wl, mux_pl, _ = setting
    rep = simulate(mux_pl, wl, mode="spatial-temporal", policy="adbs")
    assert rep.finished <= rep.submitted
    assert rep.finished > 0
    assert rep.throughput > 0


def test_slo_attainment_monotone(setting):
    _, wl, mux_pl, _ = setting
    rep = simulate(mux_pl, wl, mode="spatial-temporal", policy="adbs",
                   slo_scales=(2, 4, 8, 16, 64))
    vals = [rep.slo_attainment[s] for s in (2, 4, 8, 16, 64)]
    assert all(b >= a - 1e-9 for a, b in zip(vals, vals[1:]))
    assert all(0 <= v <= 1 for v in vals)


def test_muxserve_beats_temporal(setting):
    """Headline claim: spatial-temporal ≥ temporal multiplexing."""
    _, wl, mux_pl, _ = setting
    mux = simulate(mux_pl, wl, mode="spatial-temporal", policy="adbs")
    tmp = simulate(mux_pl, wl, mode="temporal", policy="fcfs")
    assert mux.throughput >= tmp.throughput * 0.98, \
        (mux.throughput, tmp.throughput)


def test_muxserve_beats_spatial_under_skew():
    models = _models(max_rate=14.0)
    wl = _workload(models, horizon=40.0)
    mux_pl = place(models, n_devices=8, group_limit=32)
    sp_pl = place_spatial(models, n_devices=8)
    mux = simulate(mux_pl, wl, mode="spatial-temporal", policy="adbs")
    sp = simulate(sp_pl, wl, mode="spatial", policy="adbs")
    assert mux.throughput >= sp.throughput * 0.95, \
        (mux.throughput, sp.throughput)


def test_adbs_beats_fcfs_within_unit():
    """Fig. 9: ADBS > FCFS on colocated LLMs."""
    models = _models(max_rate=10.0)
    wl = _workload(models, horizon=40.0, seed=3)
    pl = place(models, n_devices=8, group_limit=32)
    adbs = simulate(pl, wl, mode="spatial-temporal", policy="adbs")
    fcfs = simulate(pl, wl, mode="spatial-temporal", policy="fcfs")
    assert adbs.throughput >= fcfs.throughput * 0.98, \
        (adbs.throughput, fcfs.throughput)


def test_quota_adaptation_tracks_rates():
    """ADBS quota shares should end up correlated with arrival rates
    (Fig. 9: block usage aligns with rate distribution)."""
    models = _models(max_rate=12.0)
    wl = _workload(models, horizon=40.0, seed=5)
    pl = place(models, n_devices=8, group_limit=32)
    rep = simulate(pl, wl, mode="spatial-temporal", policy="adbs")
    # hottest model should not hold the smallest quota share in its unit
    rates = {cfg.name: r for cfg, r in models}
    hot = max(rates, key=rates.get)
    if hot in rep.kv_util_by_llm and len(rep.kv_util_by_llm) > 1:
        assert rep.kv_util_by_llm[hot] >= min(rep.kv_util_by_llm.values())


def test_unit_sim_drains():
    spec = LLMSpec(llama_config("llama-7b"), 2.0)
    u = UnitSim([spec], 2, mode="spatial-temporal", policy="adbs")
    wl = _workload([(spec.cfg, 2.0)], horizon=20.0)
    u.load(wl.requests)
    u.run(horizon=20.0)
    done = u.results()
    assert len(done) == len(wl.requests), "single-LLM unit must drain"
    for r in done:
        assert r.finish >= r.spec.arrival
        assert r.prefill_end >= r.spec.arrival
        assert r.tokens_done == r.spec.output_len


def test_kv_accounting_returns_to_zero():
    spec = LLMSpec(llama_config("llama-7b"), 2.0)
    u = UnitSim([spec], 2, mode="spatial-temporal", policy="adbs")
    wl = _workload([(spec.cfg, 2.0)], horizon=10.0)
    u.load(wl.requests)
    u.run(horizon=10.0)
    assert abs(u.kv_used) < 1e-6
    for st in u.llms.values():
        assert abs(st.kv_bytes) < 1e-6


# ---------------------------------------------------------------------------
# simulator parity: every SimReport field equal
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def both():
    """One skewed 4-LLM setting (max rate 12, 40 s) planned by each
    package: the colocating Alg. 1 plan and the dedicated-mesh plan."""
    out = {}
    for key, lc, syn, pl_mod in (("port", llama_config, synthesize, None),
                                 ("ref", JW.llama_config, JW.synthesize,
                                  JP)):
        models = _models(max_rate=12.0, lc=lc)
        wl = _workload(models, horizon=40.0, seed=5, syn=syn)
        if pl_mod is None:
            mux, sp = (place(models, 8, group_limit=32),
                       place_spatial(models, 8))
        else:
            mux, sp = (pl_mod.place(models, 8, group_limit=32),
                       pl_mod.place_spatial(models, 8))
        out[key] = (wl, mux, sp)
    return out


@pytest.mark.parametrize("mode,policy,plan", [
    ("spatial-temporal", "adbs", "mux"), ("spatial-temporal", "fcfs", "mux"),
    ("temporal", "adbs", "mux"), ("temporal", "fcfs", "mux"),
    ("spatial", "adbs", "spatial"), ("spatial", "fcfs", "spatial")])
def test_simulate_equals_reference(both, mode, policy, plan):
    wl_t, mux_t, sp_t = both["port"]
    wl_j, mux_j, sp_j = both["ref"]
    assert _requests(wl_t) == _requests(wl_j)
    pl_t, pl_j = (mux_t, mux_j) if plan == "mux" else (sp_t, sp_j)
    t = simulate(pl_t, wl_t, mode=mode, policy=policy)
    j = JS.simulate(pl_j, wl_j, mode=mode, policy=policy)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.summary() == j.summary()
    assert 0 < t.finished <= t.submitted


def test_simulate_equals_reference_at_h100_with_equal_quota(both):
    """The H100 constants and the static equal-quota arm (Fig. 10's
    ablation), through the same Hardware on both sides."""
    wl_t, mux_t, _ = both["port"]
    wl_j, mux_j, _ = both["ref"]
    jhw = jcm.Hardware(**dataclasses.asdict(tcm.H100))
    t = simulate(mux_t, wl_t, mode="spatial-temporal", hw=tcm.H100,
                 equal_quota=True, slo_scales=(1.5, 3))
    j = JS.simulate(mux_j, wl_j, mode="spatial-temporal", hw=jhw,
                    equal_quota=True, slo_scales=(1.5, 3))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
