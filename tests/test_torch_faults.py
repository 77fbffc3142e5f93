"""Fault injection and graceful degradation on the port
(``repro_torch/serving/faults.py``, the mux's fault paths), on the CPU.

The JAX package's ``tests/test_faults.py`` on ``repro_torch`` — plan
parsing and nesting, one consistency test per fault class (crash
recovery, block loss, transient escalation; the migration abort waits
for live reconfiguration), the degradation ladder (backpressure,
deadline shedding, requeue order, the watchdog) and the driver's
counters — plus parity with the JAX package:

* ``FaultPlan.parse`` and ``FaultPlan.random`` give equal event lists
  for the same spec and seed;
* a faulted run (a crash, a block loss that tears down live sequences,
  a transient window inside the retry budget and one past it, bounded
  queues, deadline shedding) gives equal tokens and equal
  ``ServeReport.to_json()`` apart from ``wall_s``, ``FaultSummary``
  included; the arena shrinks by exactly the lost blocks, and
  ``submitted = finished + shed + cancelled`` after every run.
"""
import numpy as np
import pytest
import torch

from _torch_twins import CPU, report_text, twin_units
from repro.core.workload import synthesize as jsynthesize
from repro.serving import driver as JD
from repro.serving.faults import FaultPlan as JFaultPlan
from repro_torch.core.workload import synthesize
from repro_torch.serving.driver import (LogicalClock, TickCostModel,
                                        build_unit_from_specs, serve_requests,
                                        serve_workload)
from repro_torch.serving.engine import Request
from repro_torch.serving.faults import (FaultEvent, FaultInjector, FaultPlan,
                                        RecoveryCostModel)
from repro_torch.serving.mux import MuxScheduler

torch.set_num_threads(2)

COST = TickCostModel()


def _unit(policy="adbs", clock=None, **kw):
    """Two fused qwen2-7b engines on one small pool."""
    u = build_unit_from_specs(
        [("a", "qwen2-7b", 3.0), ("b", "qwen2-7b", 1.0)],
        pool_blocks=4_000, max_slots=4, chunk_tokens=16, seed=0,
        policy=policy, fused=True, **CPU, **kw)
    clock = clock or LogicalClock()
    u.clock = clock
    for e in u.engines.values():
        e.clock = clock
    return u, clock


def _requests(n_a=4, n_b=2, plen=24, out=6):
    rng = np.random.default_rng(5)
    reqs = [Request(i, "a", list(rng.integers(1, 500, plen)), out,
                    arrival=0.0) for i in range(n_a)]
    reqs += [Request(100 + i, "b", list(rng.integers(1, 500, plen)), out,
                     arrival=0.0) for i in range(n_b)]
    return reqs


def _accounting_exact(u):
    """The allocator's global usage equals the per-view sum, every
    engine's view is registered, and no grant debt is outstanding."""
    pool = u.pool
    assert pool.allocator.used == sum(v.used for v in pool.views.values())
    assert set(pool.views) == set(u.engines)
    for name, eng in u.engines.items():
        assert eng.view is pool.views[name], name
    assert u._grant_debt == 0, "no outstanding fused-grant debt"


def _drain(u, max_ticks=800):
    for _ in range(max_ticks):
        if not u.pending():
            return
        u.tick()
        u.clock.advance(0.005)
    raise AssertionError("unit did not drain")


# ---------------------------------------------------------------------------
# plan parsing / severity nesting
# ---------------------------------------------------------------------------
def test_fault_plan_parse_all_kinds_and_sorting():
    plan = FaultPlan.parse("block_loss:b:256@1.5, crash:a@0.5,"
                           "transient:a:3@2.0,migration_abort@0.1")
    assert [e.kind for e in plan.events] == [
        "migration_abort", "engine_crash", "block_loss", "transient_step"]
    assert plan.targets() == ["a", "b"]
    ev = plan.events[2]
    assert (ev.target, ev.magnitude, ev.at) == ("b", 256, 1.5)
    back = FaultPlan([FaultEvent(**d) for d in plan.to_json()])
    assert back.to_json() == plan.to_json()


@pytest.mark.parametrize("bad", [
    "crash:a",                  # missing @time
    "crash:a@soon",             # bad time
    "explode:a@1",              # unknown kind
    "crash@1",                  # crash needs a target
    "block_loss:a@1",           # block_loss needs :blocks
    "transient:a:x@1",          # non-integer magnitude
    "migration_abort:a@1",      # abort takes no target
])
def test_fault_plan_parse_rejects_malformed(bad):
    with pytest.raises(ValueError):
        FaultPlan.parse(bad)


def test_fault_plan_random_severity_nested():
    """Severity-s plans are prefixes of the severity-1 master list, and
    severity 0 is the empty plan."""
    names = ["a", "b", "c"]
    full = FaultPlan.random(names, 8.0, 1.0, seed=3).to_json()
    assert len(full) == 3 * len(names) + 1
    prev: set = set()
    for sev in (0.0, 0.25, 0.5, 0.75, 1.0):
        sub = {str(e) for e in
               FaultPlan.random(names, 8.0, sev, seed=3).to_json()}
        assert prev <= sub <= {str(e) for e in full}, sev
        prev = sub
    assert FaultPlan.random(names, 8.0, 0.0, seed=3).events == []


@pytest.mark.parametrize("severity", [0.0, 1 / 3, 0.5, 2 / 3, 1.0])
def test_fault_plan_random_equals_reference(severity):
    names = ["llm0", "llm1", "llm2"]
    for seed in (0, 11):
        assert FaultPlan.random(names, 3.0, severity, seed=seed,
                                pool_blocks=20_000).to_json() \
            == JFaultPlan.random(names, 3.0, severity, seed=seed,
                                 pool_blocks=20_000).to_json()


def test_fault_plan_parse_equals_reference():
    spec = ("transient:b:5@0.75,crash:a@0.45,block_loss:b:1662@0.55,"
            "migration_abort@0.2,transient:a:2@0.65")
    assert FaultPlan.parse(spec).to_json() \
        == JFaultPlan.parse(spec).to_json()


# ---------------------------------------------------------------------------
# fault class 1: engine crash
# ---------------------------------------------------------------------------
def test_crash_recovery_consistent_state():
    """A crash with live in-flight work tears the engine down and
    rebuilds it fused: every request still finishes exactly once, the
    evicted ones carry a requeue mark, pool accounting stays exact and
    the fused group re-forms around the fresh engine."""
    u, clock = _unit()
    u.injector = FaultInjector(FaultPlan.parse("crash:a@0.02"))
    reqs = _requests()
    for r in reqs:
        u.submit(r)
    for _ in range(6):                     # get work in flight, then fire
        u.tick()
        clock.advance(0.005)
    rec = next(rec for rec in u.fault_events
               if rec["kind"] == "engine_crash")
    assert rec["target"] == "a" and rec["requeued"] >= 1
    _accounting_exact(u)
    assert len(u.fused_groups) == 1, "crash must re-fuse the rebuilt engine"
    assert sorted(u.fused_groups[0].names) == ["a", "b"]
    # the rebuilt pair holds one stacked weight copy again
    assert u.engines["a"].params is u.engines["b"].params
    _drain(u)
    fin = {r.req_id for r in u.stats.finished}
    assert fin == {r.req_id for r in reqs}, "zero drops, zero dups"
    assert len(u.stats.finished) == len(reqs)
    assert any(r.requeues >= 1 for r in u.stats.finished)
    assert not u.injector.unfired()
    _accounting_exact(u)
    assert u.pool.allocator.used == 0


def test_dissolve_copies_each_member_out_of_the_stack():
    """Dissolving a fused group gives every member a private ``[1, ...]``
    copy equal to its slice of the stack (not a view that would keep
    the stack alive), and a rebuild stacks them back."""
    u, _ = _unit()
    grp = u.fused_groups[0]
    before = {n: {k: t.clone() for k, t in
                  e.params["layers"].items()} for n, e in u.engines.items()}
    idx = {n: e.model_index for n, e in u.engines.items()}
    stacked = grp.params["layers"]["wq"]
    u.dissolve_fused_groups()
    for n, e in u.engines.items():
        assert e.model_index == 0
        wq = e.params["layers"]["wq"]
        assert wq.shape[0] == 1
        assert wq.untyped_storage().data_ptr() \
            != stacked.untyped_storage().data_ptr()
        for k, t in e.params["layers"].items():
            assert torch.equal(t[0], before[n][k][idx[n]]), (n, k)
    assert grp.params is None
    u.rebuild_fused_groups()
    assert len(u.fused_groups) == 1
    assert u._grant_debt == 0


# ---------------------------------------------------------------------------
# fault class 2: block loss
# ---------------------------------------------------------------------------
def test_block_loss_exact_shrink_and_requeue():
    """Losing the arena tail evicts exactly the sequences with pages
    there, requeues them at the queue head in arrival order, and
    shrinks the pool by exactly the lost blocks."""
    u, clock = _unit()
    reqs = _requests(n_a=4, n_b=2)
    for r in reqs:
        u.submit(r)
    for _ in range(4):
        u.tick()
        clock.advance(0.005)
    pool = u.pool
    assert pool.allocator.used > 0, "need live KV to victimize"
    occ = max(b for v in pool.views.values()
              for sc in v.seqs.values() for b in sc.bases)
    n_before = pool.n_head_blocks
    n_lose = n_before - occ
    rec = u._lose_blocks(n_lose)
    assert rec["blocks"] == n_lose, "shrink must remove exactly the loss"
    assert pool.n_head_blocks == n_before - n_lose
    assert pool.k.shape[0] == pool.v.shape[0] == pool.n_head_blocks
    assert rec["requeued"] >= 1
    _accounting_exact(u)
    for v in pool.views.values():
        for sc in v.seqs.values():
            assert all(b + v.group_size <= pool.n_head_blocks
                       for b in sc.bases)
    _drain(u)
    assert {r.req_id for r in u.stats.finished} == {r.req_id for r in reqs}
    assert len(u.stats.finished) == len(reqs)
    assert u.pool.allocator.used == 0


# ---------------------------------------------------------------------------
# fault class 3: transient step failures
# ---------------------------------------------------------------------------
def test_transient_marks_down_then_escalates():
    """A transient window freezes its engine (work retried, nothing
    dropped); a window longer than the retry budget escalates to a
    full crash recovery and clears the wedged window."""
    u, clock = _unit()
    u.retry_budget = 2
    u.injector = FaultInjector(FaultPlan.parse("transient:a:10@0.0"))
    reqs = _requests()
    for r in reqs:
        u.submit(r)
    u.tick()
    assert "a" in u._down
    assert not any(r["kind"] == "engine_crash" for r in u.fault_events)
    u.tick()
    u.tick()
    esc = [r for r in u.fault_events if r["kind"] == "engine_crash"]
    assert esc and esc[0]["reason"] == "transient"
    assert u.injector._transient_left.get("a", 0) == 0, \
        "escalation must clear the remaining window"
    _accounting_exact(u)
    _drain(u)
    assert {r.req_id for r in u.stats.finished} == {r.req_id for r in reqs}


def test_transient_within_budget_is_pure_delay():
    """A short hiccup (window ≤ budget) never tears anything down."""
    u, clock = _unit()
    u.retry_budget = 5
    u.injector = FaultInjector(FaultPlan.parse("transient:a:2@0.0"))
    reqs = _requests()
    for r in reqs:
        u.submit(r)
    _drain(u)
    assert not [r for r in u.fault_events if r["kind"] == "engine_crash"]
    assert {r.req_id for r in u.stats.finished} == {r.req_id for r in reqs}
    assert all(r.requeues == 0 for r in u.stats.finished)


# ---------------------------------------------------------------------------
# degradation ladder: backpressure / deadline / requeue order / watchdog
# ---------------------------------------------------------------------------
def test_backpressure_sheds_new_arrivals_only():
    u, _ = _unit(max_queue=2, shed_policy="reject")
    reqs = _requests(n_a=5, n_b=0)
    for r in reqs:
        u.submit(r)
    assert len(u.queues["a"]) == 2
    assert len(u.stats.shed) == 3
    assert all(r.shed and r.shed_reason == "queue_full"
               for r in u.stats.shed)
    u.queues["a"].appendleft(reqs[4])
    assert len(u.queues["a"]) == 3


def test_deadline_shed_pops_expired_heads():
    u, clock = _unit(shed_policy="deadline")
    reqs = _requests(n_a=3, n_b=1)
    reqs[0].deadline = 0.01                # expires before service
    reqs[1].deadline = 1e9
    for r in reqs:
        u.submit(r)
    clock.advance(0.05)
    u.tick()
    assert [r.req_id for r in u.stats.shed] == [reqs[0].req_id]
    assert u.stats.shed[0].shed_reason == "deadline"
    _drain(u)
    fin = {r.req_id for r in u.stats.finished}
    assert fin == {r.req_id for r in reqs} - {reqs[0].req_id}
    assert len(fin) + len(u.stats.shed) == len(reqs)


def test_shed_policy_none_never_drops():
    u, _ = _unit(shed_policy="none")
    reqs = _requests(n_a=6, n_b=0)
    for r in reqs:
        r.deadline = 0.0                   # long expired
        u.submit(r)
    _drain(u)
    assert not u.stats.shed
    assert len(u.stats.finished) == len(reqs)


def test_scheduler_rejects_bad_degradation_knobs():
    u, _ = _unit()
    with pytest.raises(ValueError, match="shed_policy"):
        MuxScheduler(u.engines, u.pool, shed_policy="drop")
    with pytest.raises(ValueError, match="max_queue"):
        MuxScheduler(u.engines, u.pool, max_queue=0)


def test_harvest_requeues_in_arrival_order():
    """Stall-escape preemptions re-enter the queue in (arrival, req_id)
    order, not eviction order."""
    u, _ = _unit()
    eng = u.engines["a"]
    later = Request(9, "a", [1] * 8, 4, arrival=3.0)
    u.queues["a"].append(later)
    r1 = Request(1, "a", [1] * 8, 4, arrival=1.0)
    r2 = Request(2, "a", [1] * 8, 4, arrival=2.0)
    r0 = Request(0, "a", [1] * 8, 4, arrival=0.5)
    eng.preempted.extend([r2, r0, r1])     # scrambled eviction order
    u._harvest()
    assert [r.req_id for r in u.queues["a"]] == [0, 1, 2, 9]


def test_watchdog_terminates_hard_stall():
    """A unit that makes zero progress forever must not hang the serving
    loop: after ``watchdog_ticks`` busy ticks the watchdog sheds
    everything pending and the run ends with submitted = finished +
    shed."""
    class WedgedScheduler(MuxScheduler):
        def tick(self):
            self.stats.ticks += 1          # burns a tick, moves nothing

    base, _ = _unit()
    u = WedgedScheduler(base.engines, base.pool, policy="adbs", fused=False)
    reqs = _requests(n_a=3, n_b=1)
    rep = serve_requests([u], reqs, slo_scales=(2.0,), cost=COST,
                         watchdog_ticks=5)
    assert rep.aggregate.finished == 0
    assert rep.aggregate.shed == len(reqs)
    assert rep.aggregate.submitted == rep.aggregate.finished \
        + rep.aggregate.shed
    assert rep.faults is not None and rep.faults.watchdog_trips >= 1
    assert any(ev["kind"] == "watchdog" for ev in rep.faults.log)
    assert all(r.shed_reason == "watchdog" for r in reqs)


# ---------------------------------------------------------------------------
# driver integration: counters, clock charging, determinism
# ---------------------------------------------------------------------------
def test_driver_charges_recovery_and_reports_counters():
    u, _ = _unit()
    reqs = _requests()
    rc = RecoveryCostModel()
    rep = serve_requests([u], reqs, slo_scales=(2.0, 8.0), cost=COST,
                         faults=FaultPlan.parse("crash:a@0.02"),
                         recovery_cost=rc)
    fs = rep.faults
    assert fs is not None and fs.recoveries == 1 and fs.unfired == 0
    assert fs.dt_charged >= rc.base, "recovery stall must hit the clock"
    agg = rep.aggregate
    assert agg.submitted == agg.finished + agg.shed == len(reqs)
    assert agg.retried >= 1 and agg.recovered >= 1
    assert "shed=" in rep.summary() and "faults:" in rep.summary()
    j = rep.to_json()
    assert j["faults"]["recoveries"] == 1
    assert j["per_llm"]["a"]["retried"] >= 1


def test_faulted_run_deterministic():
    """Same plan + fresh unit ⇒ bit-identical faulted report."""
    def run():
        u, _ = _unit()
        return serve_requests(
            [u], _requests(), slo_scales=(2.0, 8.0), cost=COST,
            faults=FaultPlan.parse("crash:a@0.02,block_loss:b:128@0.04"))
    a, b = run(), run()
    assert a.horizon == b.horizon and a.ticks == b.ticks
    assert a.aggregate.attainment == b.aggregate.attainment
    assert a.faults.dt_charged == b.faults.dt_charged
    assert a.faults.to_json()["log"] == b.faults.to_json()["log"]


# ---------------------------------------------------------------------------
# parity with the JAX package: one faulted run, every fault class
# ---------------------------------------------------------------------------
FAULT_TRACE = dict(alpha=2.1, max_rate=32.0, horizon=1.0, seed=0,
                   mean_prompt=24, mean_output=8, max_len=128)


def test_faulted_run_matches_reference():
    """A crash with live work, a block loss that keeps 48 head-blocks of
    the arena (tearing down sequences there), a transient window inside
    the retry budget and one past it, ``max_queue`` 2 and deadline
    shedding: equal tokens, equal reports (``FaultSummary`` included)
    and an arena shrunk by exactly the lost blocks."""
    names = ["a", "b"]
    wl_j = jsynthesize(names, **FAULT_TRACE)
    wl_t = synthesize(names, **FAULT_TRACE)
    specs = [(n, "qwen2-7b", wl_j.rates[n]) for n in names]
    uj, ut = twin_units(specs, pool_blocks=300, max_slots=4, chunk_tokens=16,
                        policy="adbs", fused=True, max_queue=2,
                        shed_policy="deadline")
    n0 = ut.pool.n_head_blocks
    assert n0 == uj.pool.n_head_blocks
    lost = n0 - 48
    spec = (f"crash:a@0.45,block_loss:b:{lost}@0.55,transient:a:2@0.65,"
            f"transient:b:5@0.75")
    rj = JD.serve_workload([uj], wl_j, seed=1, cost=JD.TickCostModel(),
                           faults=JFaultPlan.parse(spec), shed_scale=3.0)
    rt = serve_workload([ut], wl_t, seed=1, cost=COST,
                        faults=FaultPlan.parse(spec), shed_scale=3.0)
    assert {r.req_id: r.output for r in ut.stats.finished} \
        == {r.req_id: r.output for r in uj.stats.finished}
    assert report_text(rt) == report_text(rj)
    fs, agg = rt.faults, rt.aggregate
    kinds = [(ev["kind"], ev.get("reason"), ev["requeued"] > 0)
             for ev in fs.log]
    assert kinds == [("engine_crash", "crash", True),
                     ("block_loss", None, True),
                     ("engine_crash", "transient", True)]
    assert fs.injected == 4 and fs.unfired == 0 and fs.recoveries == 2
    assert set(agg.shed_reasons) == {"queue_full", "deadline"}
    assert fs.blocks_lost == lost
    assert ut.pool.n_head_blocks == n0 - lost
    assert ut.pool.k.shape[0] == n0 - lost
    assert ut.pool.allocator.used == uj.pool.allocator.used == 0
    assert agg.submitted == agg.finished + agg.shed + agg.cancelled \
        == len(wl_t.requests)
