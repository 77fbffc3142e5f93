"""The JAX package's four serving CI gates, held on the port on the CPU
(``benchmarks/`` stays the JAX package's): each gate's property at its
``--quick`` setup, or a smaller one with the same property, plus one
equality with the reference gate's own setup where that is cheap.

* ``fused_tick`` (``benchmarks/fused_tick.py``): fused and serial ticks
  give equal tokens, a ≥ 50-tick measured drain records no new step
  shape after warm-up (the port's ``TRACE_COUNTS`` buckets), and the
  fused unit holds no more weight bytes than the serial one; the fused
  drain's tokens equal the JAX package's on the same weights.
* ``slo_attainment`` (``benchmarks/slo_attainment.py``): ADBS strictly
  beats fcfs and round_robin at some SLO scale; the three arms' reports
  equal the JAX package's.
* ``frontend_stream`` (``benchmarks/frontend_stream.py``): streaming
  equals the closed loop; ``least_loaded`` routing attains at least as
  much as ``round_robin`` at every scale and more at some; the metrics
  are live and consistent with the report (the JAX package's equality
  for a family-named ``least_loaded`` trace is in
  ``tests/test_torch_frontend.py``).
* ``chaos_degradation`` (``benchmarks/chaos_degradation.py``): severity
  0 with the degradation ladder armed equals the plain baseline bit for
  bit, sanitized too; attainment is monotone over the nested severity
  sweep with ``submitted = finished + shed``; a 2× overload burst with
  a crash terminates and sheds; the severity-1 report equals the JAX
  package's.

These runs also show that the default-off degradation machinery changes
no fault-free report: every fault-free arm equals the JAX package's or
the plain baseline.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_twins import CPU, report_text, twin_units
from repro import configs as jconfigs
from repro.config import replace as jreplace
from repro.core.workload import synthesize as jsynthesize
from repro.models.transformer import init_params as jinit
from repro.serving import driver as JD
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.faults import FaultPlan as JFaultPlan
from repro.serving.kvcache import UnifiedKVPool as JPool
from repro.serving.mux import MuxScheduler as JMux
from repro_torch import configs
from repro_torch.config import replace
from repro_torch.core.workload import power_law_rates, synthesize
from repro_torch.models.transformer import params_to_torch
from repro_torch.serving import engine as TE
from repro_torch.serving.driver import (TickCostModel, build_unit_from_specs,
                                        requests_from_workload,
                                        serve_requests, serve_workload)
from repro_torch.serving.engine import Engine, Request, unique_tree_bytes
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.frontend import ServingFrontend, serve_and_collect
from repro_torch.serving.kvcache import UnifiedKVPool
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.mux import MuxScheduler

torch.set_num_threads(2)

COST = TickCostModel()
ARCH = "qwen2-7b"


# ---------------------------------------------------------------------------
# fused_tick: fused == serial tokens, no new step shape after warm-up,
# weight de-duplication
# ---------------------------------------------------------------------------
PROMPT_LENS = (24, 40, 56)
MAX_BLOCKS = 16


def _tick_unit(fused, trees, pkg="port", pool_blocks=200_000):
    """The gate's ``_build``: three reduced qwen2-7b engines, 16-token
    chunks, 16-block tables, one pool; ``trees`` are the JAX package's
    weights (``PRNGKey(i)``)."""
    if pkg == "jax":
        base = jconfigs.get_reduced(ARCH)
        pool = JPool(pool_blocks, base.hd, dtype=jnp.float32)
        engines = {}
        for i in range(3):
            cfg = jreplace(base, name=f"llm{i}")
            view = pool.register_model(cfg, pool_blocks // 3)
            engines[cfg.name] = JEngine(cfg, trees[i], view, max_slots=4,
                                        chunk_tokens=16,
                                        max_blocks_per_seq=MAX_BLOCKS)
        return JMux(engines, pool, policy="adbs", fused=fused)
    base = configs.get_reduced(ARCH)
    pool = UnifiedKVPool(pool_blocks, base.hd, **CPU)
    engines = {}
    for i in range(3):
        cfg = replace(base, name=f"llm{i}")
        view = pool.register_model(cfg, pool_blocks // 3)
        engines[cfg.name] = Engine(cfg, params_to_torch(trees[i], "cpu"),
                                   view, max_slots=4, chunk_tokens=16,
                                   max_blocks_per_seq=MAX_BLOCKS)
    return MuxScheduler(engines, pool, policy="adbs", fused=fused)


def _tick_wave(mux, cls, n_per_model, max_new, seed, rid_base):
    rng = np.random.default_rng(seed)
    rid = rid_base
    for name, eng in mux.engines.items():
        for j in range(n_per_model):
            plen = PROMPT_LENS[j % len(PROMPT_LENS)]
            mux.submit(cls(rid, name, list(rng.integers(
                1, eng.cfg.vocab_size, plen)), max_new))
            rid += 1
    return rid - rid_base


@pytest.fixture(scope="module")
def tick_trees():
    base = jconfigs.get_reduced(ARCH)
    return [jax.tree_util.tree_map(np.asarray, jinit(
        jax.random.PRNGKey(i), jreplace(base, name=f"llm{i}"), jnp.float32))
        for i in range(3)]


def test_fused_tick_gate(tick_trees):
    """The gate's ``--quick`` setup (6 requests an engine, 20 new
    tokens): a warm-up wave, then two measured waves."""
    outputs, weights = {}, {}
    for fused in (False, True):
        mux = _tick_unit(fused, tick_trees)
        _tick_wave(mux, Request, 6, 20, seed=1, rid_base=0)
        mux.run(max_ticks=5_000)
        base_ticks, base_fin = mux.stats.ticks, len(mux.stats.finished)
        shapes_warm = sum(TE.TRACE_COUNTS.values())
        n = 0
        for wave in range(2):
            n += _tick_wave(mux, Request, 6, 20, seed=2 + wave, rid_base=n)
            mux.run(max_ticks=5_000)
        finished = mux.stats.finished[base_fin:]
        assert len(finished) == n == 36
        assert mux.stats.ticks - base_ticks >= 50
        assert sum(TE.TRACE_COUNTS.values()) == shapes_warm, \
            "a shape-stable drain must record no new step shape"
        outputs[fused] = {r.req_id: r.output for r in finished}
        weights[fused] = unique_tree_bytes(
            [e.params for e in mux.engines.values()])
        assert len(mux.fused_groups) == (1 if fused else 0)
    assert outputs[True] == outputs[False]
    assert weights[True] <= weights[False]


def test_fused_tick_gate_matches_reference(tick_trees):
    """One fused wave of the gate's setup served by both packages on the
    same weights: equal tokens."""
    outs = {}
    for pkg, cls in (("jax", JRequest), ("port", Request)):
        mux = _tick_unit(True, tick_trees, pkg)
        _tick_wave(mux, cls, 3, 8, seed=2, rid_base=0)
        mux.run(max_ticks=5_000)
        outs[pkg] = {r.req_id: r.output for r in mux.stats.finished}
    assert len(outs["port"]) == 9 and outs["port"] == outs["jax"]


# ---------------------------------------------------------------------------
# slo_attainment: ADBS strictly beats fcfs and round_robin somewhere
# ---------------------------------------------------------------------------
SLO_SCALES = (1.5, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0)
NAMES = ["llm0", "llm1", "llm2"]


def test_slo_attainment_gate():
    """A shorter window of the gate's ``--quick`` trace (α 2.1, max
    rate 20, prompts ~24, outputs ~10, pool 20,000); all three arms equal
    the JAX package's reports on the same weights."""
    trace = dict(alpha=2.1, max_rate=20.0, horizon=1.5, seed=0,
                 mean_prompt=24, mean_output=10, max_len=256)
    wl_j, wl_t = jsynthesize(NAMES, **trace), synthesize(NAMES, **trace)
    specs = [(n, ARCH, wl_j.rates[n]) for n in NAMES]
    att = {}
    for policy in ("adbs", "fcfs", "round_robin"):
        uj, ut = twin_units(specs, pool_blocks=20_000, max_slots=4,
                            chunk_tokens=16, policy=policy, fused=True)
        rt = serve_workload([ut], wl_t, seed=1, slo_scales=SLO_SCALES,
                            cost=COST)
        rj = JD.serve_workload([uj], wl_j, seed=1, slo_scales=SLO_SCALES,
                               cost=JD.TickCostModel())
        assert report_text(rt) == report_text(rj), policy
        att[policy] = rt.aggregate.attainment
    best = [s for s in SLO_SCALES if att["adbs"][s] > att["fcfs"][s]
            and att["adbs"][s] > att["round_robin"][s]]
    assert best, att


# ---------------------------------------------------------------------------
# frontend_stream: stream == closed loop, least_loaded ≥ round_robin,
# live metrics
# ---------------------------------------------------------------------------
STREAM_SCALES = (1.25, 1.5, 2.0, 3.0, 4.0, 6.0)
FAMILIES = ("llm0", "llm1", "llm2")


def _stream_units(rates):
    units = []
    for mesh_id, devices in ((0, 4), (1, 1)):
        u = build_unit_from_specs(
            [(f"{fam}@{mesh_id}", ARCH, rates[fam]) for fam in FAMILIES],
            pool_blocks=max(20_000 * devices // 5, 4096), max_slots=4,
            chunk_tokens=16, seed=0, policy="adbs", fused=True, **CPU)
        u.mesh_id, u.n_devices = mesh_id, devices
        units.append(u)
    return units


def _family_requests(wl, units):
    proxy = {fam: units[0].engines[f"{fam}@0"] for fam in FAMILIES}
    return requests_from_workload(wl, proxy, seed=1)


def test_frontend_stream_gate():
    """The gate's topology (a 4-device and a 1-device mesh, one replica
    of each family on each) at its ``--quick`` rate over a 1 s window."""
    rates = power_law_rates(list(FAMILIES), 2.1, 48.0)
    wl = synthesize(list(FAMILIES), alpha=2.1, max_rate=48.0, horizon=1.0,
                    seed=0, mean_prompt=16, mean_output=6, max_len=128)

    def pinned():
        units = _stream_units(rates)
        reqs = _family_requests(wl, units)
        for r in reqs:
            r.model = f"{r.model}@0"
        return units, reqs

    units_a, reqs_a = pinned()
    rep_closed = serve_requests([units_a[0]], reqs_a,
                                slo_scales=STREAM_SCALES, cost=COST)
    units_b, reqs_b = pinned()
    rep_stream, outs = serve_and_collect(ServingFrontend(
        [units_b[0]], reqs_b, slo_scales=STREAM_SCALES, cost=COST))
    by_id = {r.req_id: r for r in reqs_a}
    for r in reqs_b:
        assert outs[r.req_id] == by_id[r.req_id].output == r.output
    assert report_text(rep_stream) == report_text(rep_closed)

    runs = {}
    for strategy in ("round_robin", "least_loaded"):
        units = _stream_units(rates)
        reqs = _family_requests(wl, units)
        metrics = ServingMetrics()
        rep, _ = serve_and_collect(ServingFrontend(
            units, reqs, strategy=strategy, metrics=metrics,
            planned_rates=dict(rates), slo_scales=STREAM_SCALES, cost=COST))
        runs[strategy] = (rep, metrics)
    att_rr = runs["round_robin"][0].aggregate.attainment
    rep_ll, m_ll = runs["least_loaded"]
    att_ll = rep_ll.aggregate.attainment
    assert all(att_ll[s] >= att_rr[s] for s in STREAM_SCALES), (att_ll,
                                                               att_rr)
    assert any(att_ll[s] > att_rr[s] for s in STREAM_SCALES), (att_ll,
                                                              att_rr)

    fams = {f["name"]: f for f in m_ll.snapshot()["families"]}
    sub = sum(s["value"]
              for s in fams["mux_requests_submitted_total"]["series"])
    fin = sum(s["value"]
              for s in fams["mux_requests_finished_total"]["series"])
    assert sub == rep_ll.aggregate.submitted
    assert fin == rep_ll.aggregate.finished
    served = {s["labels"]["llm"]: s["value"]
              for s in fams["mux_requests_finished_total"]["series"]
              if s["value"] > 0}
    ttft_obs = {s["labels"]["llm"]: s["count"]
                for s in fams["mux_ttft_seconds"]["series"]}
    assert served and all(ttft_obs.get(n, 0) == c
                          for n, c in served.items())
    decisions = sum(s["value"]
                    for s in fams["mux_router_decisions_total"]["series"]
                    if s["labels"]["strategy"] == "least_loaded")
    assert decisions == rep_ll.aggregate.submitted
    qps = {s["labels"]["llm"]: s["value"]
           for s in fams["mux_llm_qps"]["series"]}
    assert qps and all(v >= 0 for v in qps.values())


# ---------------------------------------------------------------------------
# chaos_degradation: parity at severity 0, monotone degradation,
# overload + crash survival
# ---------------------------------------------------------------------------
CHAOS_SCALES = (1.5, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0)
SEVERITIES = (0.0, 1 / 3, 2 / 3, 1.0)
CHAOS_POOL = 20_000


def _chaos_unit(rates, chaos, **kw):
    return build_unit_from_specs(
        [(n, ARCH, rates[n]) for n in NAMES], pool_blocks=CHAOS_POOL,
        max_slots=4, chunk_tokens=16, seed=0, policy="adbs", fused=True,
        **CPU, max_queue=(256 if chaos else None),
        shed_policy=("deadline" if chaos else "none"), **kw)


def _exactly_once(rep, n):
    agg = rep.aggregate
    assert agg.submitted == n
    assert agg.submitted == agg.finished + agg.shed + agg.cancelled
    assert agg.cancelled == 0
    assert sum(p.finished + p.shed for p in rep.per_llm.values()) == n


def test_chaos_degradation_gate():
    """The gate's ``--quick`` trace (α 2.1, max rate 10, 3 s, prompts
    ~24, outputs ~10, pool 20,000)."""
    horizon = 3.0
    trace = dict(alpha=2.1, max_rate=10.0, horizon=horizon, seed=0,
                 mean_prompt=24, mean_output=10, max_len=256)
    wl = synthesize(NAMES, **trace)

    def plan(sev):
        return FaultPlan.random(NAMES, horizon, sev, seed=11,
                                pool_blocks=CHAOS_POOL)

    base = serve_workload([_chaos_unit(wl.rates, False)], wl, seed=1,
                          slo_scales=CHAOS_SCALES, cost=COST)
    sev0 = serve_workload([_chaos_unit(wl.rates, True)], wl, seed=1,
                          slo_scales=CHAOS_SCALES, cost=COST,
                          faults=plan(0.0))
    sev0_san = serve_workload([_chaos_unit(wl.rates, True)], wl, seed=1,
                              slo_scales=CHAOS_SCALES, cost=COST,
                              faults=plan(0.0), sanitize=True)
    assert base.aggregate.attainment == sev0.aggregate.attainment
    assert (base.horizon, base.ticks) == (sev0.horizon, sev0.ticks)
    # the whole report, apart from the armed run's (empty) fault section
    assert report_text(sev0, ("wall_s", "faults")) \
        == report_text(base, ("wall_s", "faults"))
    assert sev0.faults is not None and sev0.faults.injected == 0 \
        and not sev0.faults.log
    assert report_text(sev0_san) == report_text(sev0)

    means = []
    for sev in SEVERITIES:
        rep = serve_workload([_chaos_unit(wl.rates, True)], wl, seed=1,
                             slo_scales=CHAOS_SCALES, cost=COST,
                             faults=plan(sev))
        _exactly_once(rep, len(wl.requests))
        att = rep.aggregate.attainment
        means.append(sum(att[s] for s in CHAOS_SCALES) / len(CHAOS_SCALES))
    assert all(lo <= hi + 1e-9 for lo, hi in zip(means[1:], means[:-1])), \
        means
    assert means[-1] < means[0]

    wl2 = synthesize(NAMES, alpha=2.1, max_rate=20.0, horizon=horizon,
                     seed=2, mean_prompt=24, mean_output=10, max_len=256)
    unit = build_unit_from_specs(
        [(n, ARCH, wl2.rates[n]) for n in NAMES], pool_blocks=CHAOS_POOL,
        max_slots=4, chunk_tokens=16, seed=0, policy="adbs", fused=True,
        max_queue=8, shed_policy="deadline", **CPU)
    rep = serve_workload([unit], wl2, seed=1, slo_scales=CHAOS_SCALES,
                         cost=COST,
                         faults=FaultPlan.parse(f"crash:llm0@{horizon / 2}"),
                         shed_scale=2.0)
    _exactly_once(rep, len(wl2.requests))
    assert rep.faults.recoveries == 1
    assert rep.aggregate.shed > 0
    assert unit.pool.allocator.used == 0


def test_chaos_severity_one_matches_reference():
    """The gate's severity-1 plan (every fault class the port consumes:
    a crash, a block loss of 1/8 of the pool and a 2-tick transient
    window per LLM; the migration abort stays unfired) over a 1 s
    window of its trace: equal tokens and reports."""
    horizon = 1.0
    trace = dict(alpha=2.1, max_rate=10.0, horizon=horizon, seed=0,
                 mean_prompt=24, mean_output=10, max_len=256)
    wl_j, wl_t = jsynthesize(NAMES, **trace), synthesize(NAMES, **trace)
    specs = [(n, ARCH, wl_j.rates[n]) for n in NAMES]
    uj, ut = twin_units(specs, pool_blocks=CHAOS_POOL, max_slots=4,
                        chunk_tokens=16, policy="adbs", fused=True,
                        max_queue=256, shed_policy="deadline")
    rj = JD.serve_workload(
        [uj], wl_j, seed=1, slo_scales=CHAOS_SCALES, cost=JD.TickCostModel(),
        faults=JFaultPlan.random(NAMES, horizon, 1.0, seed=11,
                                 pool_blocks=CHAOS_POOL))
    rt = serve_workload(
        [ut], wl_t, seed=1, slo_scales=CHAOS_SCALES, cost=COST,
        faults=FaultPlan.random(NAMES, horizon, 1.0, seed=11,
                                pool_blocks=CHAOS_POOL))
    assert {r.req_id: r.output for r in ut.stats.finished} \
        == {r.req_id: r.output for r in uj.stats.finished}
    assert report_text(rt) == report_text(rj)
    assert rt.faults.injected == 3 * len(NAMES)
    assert rt.faults.unfired == 1               # the migration abort
    _exactly_once(rt, len(wl_t.requests))
