"""The port's placement → runtime bridge and the serve CLI's placement
flags against the JAX package's, on the CPU.

* ``units_from_placement`` threads each spec's planned ``sm_frac`` into
  its unit, the report surfaces the shares, and the runtime's per-LLM
  throughput ordering matches the simulator's (the tests of
  ``tests/test_sm_frac.py`` that cover the bridge, run on the port).
* Two-mesh parity: one optimizer plan served by both packages in one
  session (two units) under the deterministic clock, with the JAX
  package's weights carried across (``PRNGKey(seed + mesh_id + i)``,
  the seeds of both bridges): equal greedy tokens and equal
  ``ServeReport.to_json()`` apart from ``wall_s``.
* The CLI's ``--save-placement`` → ``--placement`` round trip, and its
  argument errors equal to the reference CLI's.
* The ``spatial_mux`` gate's property on the port, at that benchmark's
  ``--quick`` setup: planned shares strictly beat pure temporal
  multiplexing at every SLO scale, and the drain stays within 1.05×.
"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import placement as JP
from repro.core.workload import poisson_trace as jpoisson
from repro.launch import serve as jserve
from repro.models.transformer import init_params as jinit
from repro.serving import driver as JD
from repro_torch import configs
from repro_torch.config import replace
from repro_torch.core import placement as TP
from repro_torch.core.estimator import LLMSpec
from repro_torch.core.placement import Mesh, Placement, place_onto_meshes
from repro_torch.core.simulator import simulate
from repro_torch.core.workload import poisson_trace, synthesize
from repro_torch.launch import serve
from repro_torch.models.transformer import params_to_torch
from repro_torch.serving import driver as TD
from repro_torch.serving.driver import (TickCostModel, serve_workload,
                                        units_from_placement)

torch.set_num_threads(2)

COST = TickCostModel()
CPU = dict(dtype=torch.float32, device="cpu")
CARD_ARCHS = "qwen2-7b,qwen2-7b,mamba2-2.7b"
# the α 1 / max rate 8 / 256-40 plan on two devices: at the A100
# default, qwen2-7b#0 alone on mesh 0, qwen2-7b#1 + mamba2-2.7b on mesh 1
PLAN_FLAGS = ["--archs", CARD_ARCHS, "--devices", "2", "--alpha", "1",
              "--rate", "8", "--mean-prompt", "256", "--mean-output", "40"]


# ---------------------------------------------------------------------------
# placement → runtime share threading
# ---------------------------------------------------------------------------
def _shared_plan():
    cfg = configs.get("qwen2-7b")

    def spec(name, rate, f):
        return LLMSpec(replace(cfg, name=name), rate, mean_prompt=16,
                       mean_output=6, tp=1, sm_frac=f, arch="qwen2-7b")

    return Placement(
        meshes=[Mesh(0, 4, [spec("hot", 12.0, 0.5), spec("mid", 6.0, 0.3),
                            spec("cold", 3.0, 0.2)])],
        total_tpt=21.0)


def test_units_consume_plan_shares():
    """units_from_placement must thread each spec's sm_frac into its
    unit and tag it with its mesh; the temporal baseline arm builds the
    same unit without shares."""
    pl = _shared_plan()
    (u,) = units_from_placement(pl, pool_blocks=12_000, max_slots=2,
                                chunk_tokens=16, fused=True, **CPU)
    assert u.enforce_shares
    assert u.sm_frac == {"hot": 0.5, "mid": 0.3, "cold": 0.2}
    assert (u.mesh_id, u.n_devices) == (0, 4)
    (t,) = units_from_placement(pl, pool_blocks=12_000, max_slots=2,
                                chunk_tokens=16, fused=True,
                                enforce_shares=False, **CPU)
    assert not t.enforce_shares
    assert t.sm_frac == {"hot": 1.0, "mid": 1.0, "cold": 1.0}


def test_hand_built_unit_has_no_mesh():
    unit = TD.build_unit_from_specs([("a", "qwen2-7b", 1.0)], pool_blocks=64,
                                    **CPU)
    assert (unit.mesh_id, unit.n_devices) == (-1, 1)
    with pytest.raises(ValueError, match="no populated mesh"):
        units_from_placement(Placement([Mesh(0, 1)], 0.0), **CPU)


def test_report_surfaces_shares():
    pl = _shared_plan()
    wl = synthesize(["hot", "mid", "cold"], alpha=2.1, max_rate=6.0,
                    horizon=1.0, seed=0, mean_prompt=16, mean_output=6,
                    max_len=64)
    units = units_from_placement(pl, pool_blocks=12_000, max_slots=4,
                                 chunk_tokens=16, fused=True, **CPU)
    rep = serve_workload(units, wl, seed=1, slo_scales=(2.0,), cost=COST)
    assert rep.sm_frac == {"hot": 0.5, "mid": 0.3, "cold": 0.2}
    assert "sm_frac" in rep.summary()
    assert rep.to_json()["sm_frac"]["hot"] == 0.5


def test_runtime_throughput_ordering_matches_simulator():
    """For one shared placement (same shares, rates and trace), the
    runtime's per-LLM throughput ordering must match the discrete-event
    simulator's — the deterministic clock's share accounting and the
    sim's Eq.-3 rounds are two views of one model, not two models."""
    pl = _shared_plan()
    names = ["hot", "mid", "cold"]
    wl = synthesize(names, alpha=2.1, max_rate=16.0, horizon=2.0, seed=0,
                    mean_prompt=16, mean_output=6, max_len=128)
    sim = simulate(pl, wl, mode="spatial-temporal", policy="adbs")
    assert set(sim.per_llm_tpt) == set(names)
    units = units_from_placement(pl, pool_blocks=20_000, max_slots=4,
                                 chunk_tokens=16, fused=True, **CPU)
    rep = serve_workload(units, wl, seed=1, slo_scales=(2.0, 4.0),
                         cost=COST)
    run_tpt = {n: rep.per_llm[n].throughput for n in names}
    sim_order = sorted(names, key=lambda n: -sim.per_llm_tpt[n])
    run_order = sorted(names, key=lambda n: -run_tpt[n])
    assert sim_order == run_order, (sim.per_llm_tpt, run_tpt)


# ---------------------------------------------------------------------------
# two-mesh parity with the JAX package
# ---------------------------------------------------------------------------
def _two_mesh_plan():
    """The port's optimizer plan for qwen2-7b ×2 + mamba2-2.7b on two
    devices (full-width configs, A100), as plan JSON."""
    rates = {"qwen2-7b#0": 8.0, "qwen2-7b#1": 4.0, "mamba2-2.7b": 8 / 3}
    models = [(replace(configs.get(n.split("#")[0]), name=n), r)
              for n, r in rates.items()]
    data = TP.placement_to_json(TP.place(models, 2, mean_prompt=256,
                                         mean_output=40))
    assert [[s["name"] for s in m["specs"]] for m in data["meshes"]] \
        == [["qwen2-7b#0"], ["qwen2-7b#1", "mamba2-2.7b"]]
    return data


@pytest.mark.parametrize("enforce", [True, False])
def test_two_mesh_plan_serves_like_reference(enforce):
    data = _two_mesh_plan()
    jpl = JP.placement_from_json(data, jconfigs.get_reduced)
    tpl = TP.placement_from_json(data, configs.get_reduced)
    rates = {s.name: s.rate for m in tpl.meshes for s in m.specs}
    trace = dict(horizon=1.0, seed=0, mean_prompt=24, mean_output=8,
                 max_len=128)
    wl_j, wl_t = jpoisson(rates, **trace), poisson_trace(rates, **trace)
    common = dict(pool_blocks=8000, max_slots=4, chunk_tokens=16, seed=3,
                  fused=True, enforce_shares=enforce)
    uj = JD.units_from_placement(jpl, **common)
    rj = JD.serve_workload(uj, wl_j, seed=0, cost=JD.TickCostModel())

    trees = {}
    for m in jpl.meshes:
        for i, s in enumerate(m.specs):
            tree = jinit(jax.random.PRNGKey(3 + m.mesh_id + i), s.cfg,
                         jnp.float32)
            trees[s.name] = params_to_torch(
                jax.tree_util.tree_map(np.asarray, tree), "cpu")
    ut = units_from_placement(tpl, params=trees, **common, **CPU)
    rt = serve_workload(ut, wl_t, seed=0, cost=TickCostModel())

    assert len(ut) == len(uj) == 2
    for a, b in zip(ut, uj):
        assert (a.mesh_id, a.n_devices, a.enforce_shares, a.sm_frac) \
            == (b.mesh_id, b.n_devices, b.enforce_shares, b.sm_frac)
        assert a.pool.n_head_blocks == b.pool.n_head_blocks
        assert a.pool.allocator.used == b.pool.allocator.used == 0
    per_model = {n: sum(r.model == n for r in wl_t.requests) for n in rates}
    assert min(per_model.values()) >= 2, per_model
    tok_j = {r.req_id: r.output for u in uj for r in u.stats.finished}
    tok_t = {r.req_id: r.output for u in ut for r in u.stats.finished}
    assert len(tok_t) == len(wl_t.requests)
    assert tok_t == tok_j
    a, b = rj.to_json(), rt.to_json()
    a.pop("wall_s")
    b.pop("wall_s")
    assert b == a
    assert b["sm_frac"] == ({n: 0.1 for n in rates} if enforce else {})


# ---------------------------------------------------------------------------
# the CLI: placement round trip and argument errors
# ---------------------------------------------------------------------------
def test_cli_save_then_serve_plan(tmp_path, capsys):
    plan, rep1, rep2 = (str(tmp_path / f) for f in
                        ("plan.json", "save.json", "serve.json"))
    serve_flags = ["--device", "cpu", "--fused", "--chunk-tokens", "16",
                   "--deterministic", "--pool-blocks", "8000"]
    assert serve.main(["--save-placement", plan, *PLAN_FLAGS, *serve_flags,
                       "--horizon", "0.3", "--max-new", "4",
                       "--report", rep1]) == 0
    # the saved plan is the reference optimizer's at full width (A100)
    names = ["qwen2-7b#0", "qwen2-7b#1", "mamba2-2.7b"]
    from repro.config import replace as jreplace
    from repro.core.workload import power_law_rates as jrates
    r = jrates(names, 1.0, 8.0)
    ref = JP.place([(jreplace(jconfigs.get(n.split("#")[0]), name=n), r[n])
                    for n in names], 2, mean_prompt=256, mean_output=40)
    with open(plan) as f:
        saved = json.load(f)
    assert saved == JP.placement_to_json(ref)
    assert len(saved["meshes"]) == 2

    assert serve.main(["--placement", plan, *serve_flags, "--horizon", "1",
                       "--max-new", "6", "--report", rep2]) == 0
    out = capsys.readouterr().out
    assert "unit mesh[0] enforces compute shares" in out
    assert "unit mesh[1] enforces compute shares" in out
    assert "plan rates" in out
    for path in (rep1, rep2):
        with open(path) as f:
            rep = json.load(f)
        agg = rep["aggregate"]
        assert agg["finished"] == agg["submitted"] > 0
        assert rep["sm_frac"] == {n: 0.1 for n in names}
    with open(rep2) as f:
        assert set(json.load(f)["per_llm"]) == set(names)


def _error_of(run, capsys):
    with pytest.raises(SystemExit) as exc:
        run()
    assert exc.value.code == 2
    err = capsys.readouterr().err.strip().splitlines()[-1]
    return err.split("error: ", 1)[1]


@pytest.mark.parametrize("args", [
    ["--placement", "{plan}", "--save-placement", "{plan}"],
    ["--devices", "0"],
    ["--sm-frac", "0.5"],
    ["--sm-frac", "qwen2-7b=0.5,0.3"],
    ["--sm-frac", "0,1"],
    ["--sm-frac", "0.5,1.5"],
    ["--sm-frac", "nope=0.5"],
    ["--placement", "{plan}", "--sm-frac", "nope=0.5"],
], ids=["exclusive", "devices", "count", "mix", "zero", "above-one",
        "unknown-arch-name", "unknown-plan-name"])
def test_cli_errors_equal_reference(args, tmp_path, capsys, monkeypatch):
    plan = str(tmp_path / "plan.json")
    TP.save_placement(TP.placement_from_json(_two_mesh_plan(), configs.get),
                      plan)
    args = [a.format(plan=plan) for a in args]
    monkeypatch.setattr(sys, "argv", ["serve", *args])
    want = _error_of(jserve.main, capsys)
    got = _error_of(lambda: serve.main([*args, "--device", "cpu"]), capsys)
    assert got == want


# ---------------------------------------------------------------------------
# the spatial_mux gate's property on the port
# ---------------------------------------------------------------------------
def test_planned_shares_beat_temporal_at_every_scale():
    """``benchmarks/spatial_mux.py --quick`` on the port: one colocated
    3-LLM unit (reduced qwen2-7b, α 2.1, max rate 60 over 2.5 s) planned
    by Alg. 1's inner loop on a 4-device mesh, decode shares scaled ∝
    popularity; the same trace served with the shares enforced must
    strictly beat the temporal arm at every SLO scale, and drain within
    1.05× of it."""
    slo_scales = (1.5, 2.0, 3.0, 4.0, 6.0, 8.0)
    names = [f"llm{i}" for i in range(3)]
    wl = synthesize(names, alpha=2.1, max_rate=60.0, horizon=2.5, seed=0,
                    mean_prompt=24, mean_output=12, max_len=256)
    cfg = configs.get("qwen2-7b")
    pl = place_onto_meshes([(replace(cfg, name=n), r)
                            for n, r in wl.rates.items()], [(0, 4)],
                           mean_prompt=24, mean_output=12,
                           archs={n: "qwen2-7b" for n in names})
    rate_sum = sum(wl.rates.values())
    for s in pl.meshes[0].specs:
        s.sm_frac = max(round(s.rate / rate_sum, 2), 0.05)
    reps = {}
    for enforce in (False, True):
        units = units_from_placement(pl, pool_blocks=20_000, max_slots=4,
                                     chunk_tokens=16, seed=0, policy="adbs",
                                     fused=True, enforce_shares=enforce,
                                     **CPU)
        reps[enforce] = serve_workload(units, wl, seed=1,
                                       slo_scales=slo_scales, cost=COST)
    att_t = reps[False].aggregate.attainment
    att_s = reps[True].aggregate.attainment
    assert all(att_s[s] > att_t[s] for s in slo_scales), (att_s, att_t)
    assert reps[True].horizon <= reps[False].horizon * 1.05
    assert reps[True].aggregate.finished == len(wl.requests) > 100
