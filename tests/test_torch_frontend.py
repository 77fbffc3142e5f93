"""The port's live serving front end (``repro_torch/serving/frontend.py``,
``router.py``, ``metrics.py``), on the CPU: the JAX package's
``tests/test_frontend.py`` on ``repro_torch`` — streams bit-identical to
the closed loop (fused and serial), the router strategies, cancellation
queued, before arrival and in flight (KV freed at once), a shed surfacing
as ``StreamShed``, the metrics exposition and its HTTP endpoint on
localhost, the report embedding the snapshot — plus parity with the JAX
package: one family-named trace over two replica units under
``least_loaded`` gives equal streamed tokens, router decisions, metrics
snapshots and reports (``wall_s`` apart), and so does the serve CLI
through the front end with faults, shedding, the sanitizer and metrics;
the CLI's new flags fail with the reference CLI's argument errors.
"""
import asyncio
import json
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from _torch_twins import CPU, report_text, reference_trees
from repro.core.workload import synthesize as jsynthesize
from repro.launch import serve as jserve
from repro.serving import driver as JD
from repro.serving.frontend import ServingFrontend as JFrontend
from repro.serving.frontend import serve_and_collect as jcollect
from repro.serving.metrics import ServingMetrics as JMetrics
from repro_torch.core.workload import synthesize
from repro_torch.launch import serve
from repro_torch.serving import driver as TD
from repro_torch.serving.driver import (ServeSession, TickCostModel,
                                        build_unit_from_specs,
                                        requests_from_workload, serve_requests)
from repro_torch.serving.engine import Request
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.frontend import (ServingFrontend, StreamCancelled,
                                          StreamShed, serve_and_collect)
from repro_torch.serving.metrics import (MetricsServer, ServingMetrics,
                                         percentile_from_histogram)
from repro_torch.serving.router import (ExplicitTarget, LeastLoaded,
                                        RoundRobin, Router, WeightedByRate,
                                        family_of, make_strategy)

torch.set_num_threads(2)

COST = TickCostModel()
NAMES = ["llm0", "llm1", "llm2"]


def _workload(max_rate=10.0, horizon=1.5):
    return synthesize(NAMES, alpha=2.1, max_rate=max_rate, horizon=horizon,
                      seed=0, mean_prompt=16, mean_output=6, max_len=128)


def _unit(wl, fused=True, **kw):
    return build_unit_from_specs(
        [(n, "qwen2-7b", wl.rates[n]) for n in NAMES],
        pool_blocks=8_000, max_slots=4, chunk_tokens=16, seed=0,
        policy="adbs", fused=fused, **CPU, **kw)


def _build(wl, fused=True, **kw):
    u = _unit(wl, fused=fused, **kw)
    return u, requests_from_workload(wl, u.engines, seed=1)


def _ab_unit(**kw):
    return build_unit_from_specs(
        [("a", "qwen2-7b", 3.0), ("b", "qwen2-7b", 1.0)],
        pool_blocks=4_000, max_slots=4, chunk_tokens=16, seed=0,
        policy="adbs", fused=True, **CPU, **kw)


def _reqs(n, model="a", plen=24, out=6, arrival=0.0):
    rng = np.random.default_rng(7)
    return [Request(i, model, list(rng.integers(1, 500, plen)), out,
                    arrival=arrival) for i in range(n)]


# ---------------------------------------------------------------------------
# streaming determinism: open-loop == closed-loop, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "serial"])
def test_streams_bit_identical_to_closed_loop(fused):
    """The front end drives the SAME ServeSession stepper as the
    closed-loop driver, so under the logical clock every streamed token
    sequence equals the driver's Request.output exactly."""
    wl = _workload()
    u1, r1 = _build(wl, fused=fused)
    rep1 = serve_requests([u1], r1, cost=COST)
    u2, r2 = _build(wl, fused=fused)
    fe = ServingFrontend([u2], r2, cost=COST)
    rep2, outs = serve_and_collect(fe)
    by_id = {r.req_id: r for r in r1}
    for r in r2:
        assert outs[r.req_id] == by_id[r.req_id].output == r.output
    assert report_text(rep1) == report_text(rep2)


def test_frontend_rerun_reproducible():
    wl = _workload(max_rate=6.0, horizon=1.0)
    runs = []
    for _ in range(2):
        u, reqs = _build(wl)
        rep, outs = serve_and_collect(ServingFrontend([u], reqs, cost=COST))
        runs.append((rep.ticks, rep.horizon,
                     {i: tuple(o) for i, o in outs.items()}))
    assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------
def test_family_convention():
    assert family_of("llm-a@1") == "llm-a"
    assert family_of("solo") == "solo"


def _two_replica_units():
    return tuple(build_unit_from_specs([(f"m@{k}", "qwen2-7b", 2.0)],
                                       pool_blocks=4_000, max_slots=2,
                                       chunk_tokens=16, seed=0,
                                       policy="adbs", **CPU)
                 for k in (0, 1))


def test_router_strategies():
    ua, ub = _two_replica_units()
    r = Router([ua, ub], strategy=RoundRobin())
    assert r.resolve("m@0") == "m@0"
    assert [r.resolve("m") for _ in range(4)] == ["m@0", "m@1"] * 2
    with pytest.raises(KeyError):
        r.resolve("nope")
    r2 = Router([ua, ub], strategy=ExplicitTarget())
    with pytest.raises(KeyError):
        r2.resolve("m")
    r3 = Router([ua, ub], strategy=WeightedByRate({"m@0": 3.0, "m@1": 1.0}))
    picks = [r3.resolve("m") for _ in range(8)]
    assert picks.count("m@0") == 6 and picks.count("m@1") == 2
    r4 = Router([ua, ub], strategy=LeastLoaded())
    ua.submit(_reqs(1, model="m@0")[0])
    assert r4.resolve("m") == "m@1"
    for name in ("explicit", "round_robin", "weighted", "least_loaded"):
        assert make_strategy(name, {"m@0": 1.0}).name == name
    with pytest.raises(ValueError):
        make_strategy("bogus")


def test_router_refresh_follows_topology():
    ua, ub = _two_replica_units()
    r = Router([ua, ub], strategy=RoundRobin())
    assert sorted(r.families["m"]) == ["m@0", "m@1"]
    ub.remove_engine("m@1")
    r.refresh()
    assert r.families["m"] == ["m@0"]
    assert all(r.resolve("m") == "m@0" for _ in range(3))


# ---------------------------------------------------------------------------
# cancellation: the third disposition
# ---------------------------------------------------------------------------
def test_cancel_queued_and_prearrival():
    u = _ab_unit()
    reqs = _reqs(6, model="a") + _reqs(1, model="b", arrival=5.0)
    late = reqs[-1]
    session = ServeSession([u], reqs, cost=COST)
    assert session.cancel(late)          # pre-arrival: never submitted
    assert not session.cancel(late)      # idempotent
    session.step()                       # t=0 arrivals submitted
    queued = next(iter(u.queues["a"]), None)
    assert queued is not None
    assert session.cancel(queued)
    assert queued not in u.queues["a"] and queued.cancelled
    while session.step()[0] != "done":
        pass
    rep = session.report()
    agg = rep.aggregate
    assert agg.cancelled == 2
    assert agg.submitted == agg.finished + agg.shed + agg.cancelled
    assert rep.per_llm["a"].cancelled == 1
    assert rep.per_llm["b"].cancelled == 1
    assert "cancelled=2" in rep.summary()
    assert rep.to_json()["aggregate"]["cancelled"] == 2
    assert agg.shed == 0


def test_cancel_inflight_frees_kv_now():
    """Cancelling a RUNNING request evicts its sequence: slot and KV
    blocks return to the pool at once."""
    u = _ab_unit()
    (victim,), rest = _reqs(1, model="a", out=64), _reqs(3, model="b")
    session = ServeSession([u], [victim] + rest, cost=COST)
    for _ in range(200):
        session.step()
        if victim.first_token >= 0:
            break
    assert victim.first_token >= 0 and victim.finish < 0
    used_before = u.engines["a"].view.used
    assert used_before > 0
    assert session.cancel(victim)
    assert victim.cancelled and not victim.shed
    assert u.engines["a"].view.used == 0 < used_before
    while session.step()[0] != "done":
        pass
    assert all(v.used == 0 for v in u.pool.views.values())
    rep = session.report()
    assert rep.aggregate.cancelled == 1
    assert rep.aggregate.submitted == \
        rep.aggregate.finished + rep.aggregate.shed + rep.aggregate.cancelled


def test_cancel_terminates_stream():
    u = _ab_unit()
    victim = _reqs(1, model="a", out=64)[0]
    fe = ServingFrontend([u], [victim], cost=COST)

    async def _main():
        stream = fe.stream(victim)
        serve_task = asyncio.ensure_future(fe.serve())

        async def consume():
            got = 0
            with pytest.raises(StreamCancelled):
                async for _tok in stream:
                    got += 1
                    if got == 2:
                        assert fe.cancel(victim)
            return got

        got = await consume()
        await serve_task
        return got

    assert asyncio.run(_main()) >= 2
    assert victim.cancelled
    assert fe.report().aggregate.cancelled == 1


# ---------------------------------------------------------------------------
# backpressure surfaces as stream errors
# ---------------------------------------------------------------------------
def test_shed_surfaces_as_stream_error():
    u = _ab_unit(max_queue=1, shed_policy="reject")
    reqs = _reqs(6, model="a")
    metrics = ServingMetrics()
    fe = ServingFrontend([u], reqs, metrics=metrics, cost=COST)
    rep, outs = serve_and_collect(fe)
    sheds = {i: o for i, o in outs.items() if isinstance(o, StreamShed)}
    fins = {i: o for i, o in outs.items() if isinstance(o, list)}
    assert sheds and fins
    assert len(sheds) + len(fins) == len(reqs)
    assert all(o.reason == "queue_full" for o in sheds.values())
    assert rep.aggregate.shed == len(sheds)
    assert rep.aggregate.submitted == \
        rep.aggregate.finished + rep.aggregate.shed
    snap = {f["name"]: f for f in metrics.snapshot()["families"]}
    errs = sum(s["value"]
               for s in snap["mux_stream_errors_total"]["series"])
    assert errs == len(sheds)


# ---------------------------------------------------------------------------
# metrics layer
# ---------------------------------------------------------------------------
def test_metrics_registry_and_exposition():
    m = ServingMetrics()
    m.requests_submitted.inc(llm="a")
    m.requests_submitted.inc(2, llm="b")
    m.llm_qps.set(3.25, llm="a")
    for v in (0.004, 0.04, 0.4):
        m.ttft_seconds.observe(v, llm="a")
    m.reconfig_events.inc(kind="move")
    m.fault_events.inc(kind="engine_crash")
    text = m.registry.render()
    assert "# TYPE mux_requests_submitted_total counter" in text
    assert 'mux_requests_submitted_total{llm="b"} 2' in text
    assert 'mux_llm_qps{llm="a"} 3.25' in text
    assert 'mux_ttft_seconds_bucket{llm="a",le="+Inf"} 3' in text
    assert 'mux_ttft_seconds_count{llm="a"} 3' in text
    assert 'mux_reconfig_events_total{kind="move"} 1' in text
    assert 'mux_fault_events_total{kind="engine_crash"} 1' in text
    p50 = percentile_from_histogram(m.ttft_seconds, 0.5, llm="a")
    assert p50 is not None and 0.004 <= p50 <= 0.4
    with pytest.raises(ValueError):
        m.requests_submitted.inc(-1, llm="a")


def test_metrics_http_endpoint():
    m = ServingMetrics()
    m.requests_submitted.inc(llm="a")
    m.log.emit(0.0, "submit", 1, llm="a")
    srv = MetricsServer(m, port=0).start()
    try:
        with urllib.request.urlopen(f"{srv.url}/metrics") as resp:
            body = resp.read().decode()
            assert resp.status == 200
            assert 'mux_requests_submitted_total{llm="a"} 1' in body
        with urllib.request.urlopen(f"{srv.url}/metrics.json") as resp:
            snap = json.loads(resp.read())
            assert any(f["name"] == "mux_requests_submitted_total"
                       for f in snap["families"])
        with urllib.request.urlopen(f"{srv.url}/events") as resp:
            assert "data: " in resp.read().decode()
        with urllib.request.urlopen(f"{srv.url}/nope"):
            pytest.fail("404 expected")
    except urllib.error.HTTPError as e:
        assert e.code == 404
    finally:
        srv.close()
    srv.close()                          # idempotent (thread already down)


def test_serving_records_metrics_and_report_embeds_snapshot():
    u = _ab_unit()
    reqs = _reqs(4, model="a") + _reqs(2, model="b")
    metrics = ServingMetrics()
    rep = serve_requests([u], reqs, cost=COST, metrics=metrics,
                         faults=FaultPlan.parse("crash:a@0.02"))
    assert rep.to_json()["schema_version"] == 2
    assert rep.metrics is not None
    fams = {f["name"]: f for f in rep.metrics["families"]}
    fin = sum(s["value"]
              for s in fams["mux_requests_finished_total"]["series"])
    assert fin == rep.aggregate.finished
    ttft_n = sum(s["count"] for s in fams["mux_ttft_seconds"]["series"])
    assert ttft_n == rep.aggregate.finished
    tok = sum(s["value"] for s in fams["mux_tokens_total"]["series"])
    assert tok > 0
    faults = {s["labels"]["kind"]: s["value"]
              for s in fams["mux_fault_events_total"]["series"]}
    assert faults.get("engine_crash", 0) >= 1
    recov = {s["labels"]["llm"]: s["value"]
             for s in fams["mux_recoveries_total"]["series"]}
    assert recov.get("a", 0) >= 1
    for r in reqs:
        events = [rec.event for rec in metrics.log.for_request(r.req_id)]
        assert "submit" in events
        if r.finish >= 0:
            assert "finish" in events
    assert "mux_llm_qps" in metrics.registry.render()


# ---------------------------------------------------------------------------
# parity with the JAX package: family-named trace, least_loaded
# ---------------------------------------------------------------------------
FAMILIES = ("llm0", "llm1", "llm2")
STREAM_SCALES = (1.25, 1.5, 2.0, 3.0, 4.0, 6.0)


def _replica_units(pkg_driver, rates, port=False):
    """One replica of every family on each of two meshes (4 devices and
    1), as the JAX package's ``frontend_stream`` gate builds them; the
    port's engines carry the JAX package's weights."""
    units = []
    for mesh_id, devices in ((0, 4), (1, 1)):
        specs = [(f"{fam}@{mesh_id}", "qwen2-7b", rates[fam])
                 for fam in FAMILIES]
        kw = dict(pool_blocks=max(8_000 * devices // 5, 4096), max_slots=4,
                  chunk_tokens=16, seed=0, policy="adbs", fused=True)
        if port:
            kw.update(CPU, params=reference_trees(specs))
        u = pkg_driver.build_unit_from_specs(specs, **kw)
        u.mesh_id, u.n_devices = mesh_id, devices
        units.append(u)
    return units


def test_least_loaded_family_trace_matches_reference():
    trace = dict(alpha=2.1, max_rate=24.0, horizon=1.0, seed=0,
                 mean_prompt=16, mean_output=6, max_len=128)
    wl_j = jsynthesize(list(FAMILIES), **trace)
    wl_t = synthesize(list(FAMILIES), **trace)
    units_j = _replica_units(JD, wl_j.rates)
    units_t = _replica_units(TD, wl_t.rates, port=True)
    reqs_j = JD.requests_from_workload(
        wl_j, {f: units_j[0].engines[f"{f}@0"] for f in FAMILIES}, seed=1)
    reqs_t = requests_from_workload(
        wl_t, {f: units_t[0].engines[f"{f}@0"] for f in FAMILIES}, seed=1)
    mj, mt = JMetrics(), ServingMetrics()
    rep_j, outs_j = jcollect(JFrontend(
        units_j, reqs_j, strategy="least_loaded", metrics=mj,
        planned_rates=dict(wl_j.rates), slo_scales=STREAM_SCALES,
        cost=JD.TickCostModel()))
    rep_t, outs_t = serve_and_collect(ServingFrontend(
        units_t, reqs_t, strategy="least_loaded", metrics=mt,
        planned_rates=dict(wl_t.rates), slo_scales=STREAM_SCALES,
        cost=COST))
    assert len(reqs_t) > 10
    assert outs_t == outs_j
    assert all(isinstance(o, list) for o in outs_t.values())
    # routing decisions: every request landed on the same replica
    assert [r.model for r in reqs_t] == [r.model for r in reqs_j]
    assert {r.model for r in reqs_t} >= {"llm0@0", "llm0@1"}
    assert mt.snapshot() == mj.snapshot()
    assert report_text(rep_t) == report_text(rep_j)
    fams = {f["name"]: f for f in rep_t.metrics["families"]}
    decisions = sum(s["value"] for s in
                    fams["mux_router_decisions_total"]["series"])
    assert decisions == rep_t.aggregate.submitted == len(reqs_t)


# ---------------------------------------------------------------------------
# the CLI's front-end and degradation flags
# ---------------------------------------------------------------------------
CLI_FLAGS = ["--deterministic", "--horizon", "2", "--chunk-tokens", "16",
             "--frontend", "--router", "least_loaded",
             "--faults", "crash:qwen2-7b@1.0", "--shed-policy", "deadline",
             "--max-queue", "8", "--sanitize"]


def test_cli_frontend_with_faults_matches_reference(tmp_path, capsys,
                                                    monkeypatch):
    """The serve CLI through the front end with routing, a crash,
    deadline shedding, bounded queues, the sanitizer and the metrics
    layer: the port's report (wall_s apart) and metrics snapshot equal
    the JAX CLI's (under the logical clock they depend on lengths and
    arrivals, not on the weights' values)."""
    out = {}
    for pkg, run in (("jax", jserve.main), ("port", serve.main)):
        rep, snap = tmp_path / f"{pkg}.json", tmp_path / f"{pkg}_m.json"
        args = [*CLI_FLAGS, "--report", str(rep), "--metrics-json", str(snap)]
        if pkg == "jax":
            monkeypatch.setattr(sys, "argv", ["serve", *args])
            assert run() == 0
        else:
            assert run([*args, "--device", "cpu"]) == 0
        text = capsys.readouterr().out
        assert "frontend streamed" in text and "fault @" in text
        report = json.loads(rep.read_text())
        report.pop("wall_s")
        out[pkg] = (json.dumps(report, sort_keys=True),
                    json.loads(snap.read_text()))
    assert out["port"] == out["jax"]
    report = json.loads(out["port"][0])
    assert report["faults"]["recoveries"] == 1
    assert report["metrics"] == out["port"][1]


@pytest.mark.parametrize("args", [
    ["--max-queue", "0", "--shed-policy", "reject"],
    ["--max-queue", "4"],
    ["--shed-scale", "0"],
    ["--watchdog-ticks", "-1"],
    ["--router", "least_loaded"],
    ["--frontend", "--port", "-1"],
    ["--faults", "crash:qwen2-7b"],
    ["--faults", "crash:nope@1"],
], ids=["max-queue", "queue-without-policy", "shed-scale", "watchdog",
        "router-without-frontend", "port", "fault-syntax", "fault-target"])
def test_cli_degradation_errors_equal_reference(args, capsys, monkeypatch):
    def error_of(run):
        with pytest.raises(SystemExit) as exc:
            run()
        assert exc.value.code == 2
        err = capsys.readouterr().err.strip().splitlines()[-1]
        return err.split("error: ", 1)[1]

    monkeypatch.setattr(sys, "argv", ["serve", *args])
    want = error_of(jserve.main)
    assert error_of(lambda: serve.main([*args, "--device", "cpu"])) == want
