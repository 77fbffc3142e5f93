"""The JAX package's ``reconfig_shift`` serving CI gate
(``benchmarks/reconfig_shift.py``) held on the port on the CPU, at the
gate's ``--quick`` setup: three reduced qwen2-7b LLMs placed by
popularity — llm0 (25 req/s) and llm1 (2) on a 4-device mesh, llm2
(0.5) alone on 1 device — with llm0 and llm2 swapping rates at half of a
4 s ``piecewise_poisson_trace`` (24-token prompts, 10-token outputs on
average).  16-token chunks, 4 slots, 16,000 pool blocks split by mesh
size, fused ADBS, ``TickCostModel``; the trace is served twice, static
and with ``ReconfigController(interval=0.25, drift_threshold=2.0,
sustain=2)``.  The port's engines carry the JAX package's weights
(``_torch_twins``).

1. Zero drops: both runs finish every request.
2. At least one executed event with at least one move.
3. Reconfiguration strictly beats the static placement at some scale.

And the port's static and reconfig reports equal the reference gate's
as canonical JSON apart from ``wall_s``, with the reconfig run under the
sanitizer on every tick.  A ``migration_abort`` at the move's time makes
both packages skip the move and return the spec, with every request
finished and equal reports.  The serve CLI's ``--reconfig`` flags give
the JAX CLI's report, and its argument errors.
"""
import json
import sys

import pytest
import torch

from _torch_twins import placement_trees, report_text
from repro import configs as jconfigs
from repro.config import replace as jreplace
from repro.core.estimator import LLMSpec as JSpec
from repro.core.placement import Mesh as JMesh
from repro.core.placement import Placement as JPlacement
from repro.core.workload import piecewise_poisson_trace as jtrace
from repro.launch import serve as jserve
from repro.serving import driver as JD
from repro.serving import reconfig as JR
from repro.serving.faults import FaultPlan as JFaultPlan
from repro_torch import configs
from repro_torch.config import replace
from repro_torch.core.estimator import LLMSpec
from repro_torch.core.placement import Mesh, Placement
from repro_torch.core.workload import piecewise_poisson_trace
from repro_torch.launch import serve
from repro_torch.serving import driver as TD
from repro_torch.serving import reconfig as TR
from repro_torch.serving.faults import FaultPlan

torch.set_num_threads(2)

# benchmarks/reconfig_shift.py's constants and its --quick run
ARCH = "qwen2-7b"
HOT, WARM, COLD = 25.0, 2.0, 0.5
CHUNK_TOKENS, MAX_SLOTS, POOL_BLOCKS = 16, 4, 16_000
MEAN_PROMPT, MEAN_OUTPUT = 24, 10
SLO_SCALES = (1.5, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0)
HORIZON = 4.0
UNITS = dict(pool_blocks=POOL_BLOCKS, max_slots=MAX_SLOTS,
             chunk_tokens=CHUNK_TOKENS, seed=0, policy="adbs", fused=True)
CTRL = dict(interval=0.25, drift_threshold=2.0, sustain=2)


def _phases(horizon):
    pre = {"llm0": HOT, "llm1": WARM, "llm2": COLD}
    post = {"llm0": COLD, "llm1": WARM, "llm2": HOT}
    return [(0.0, pre), (horizon / 2, post)]


def _placement(jax: bool):
    cfgs, Spec, M, P, rep = ((jconfigs, JSpec, JMesh, JPlacement, jreplace)
                             if jax else
                             (configs, LLMSpec, Mesh, Placement, replace))
    cfg = cfgs.get(ARCH)

    def spec(name, rate):
        return Spec(rep(cfg, name=name), rate, mean_prompt=MEAN_PROMPT,
                    mean_output=MEAN_OUTPUT, tp=1, sm_frac=1.0, arch=ARCH)
    return P(meshes=[M(0, 4, [spec("llm0", HOT), spec("llm1", WARM)]),
                     M(1, 1, [spec("llm2", COLD)])],
             total_tpt=HOT + WARM + COLD)


def _serve(jax: bool, reconfig: bool, faults=None, sanitize=False):
    trace = dict(seed=0, mean_prompt=MEAN_PROMPT, mean_output=MEAN_OUTPUT,
                 max_len=256)
    pl = _placement(jax)
    if jax:
        wl = jtrace(_phases(HORIZON), HORIZON, **trace)
        units = JD.units_from_placement(pl, **UNITS)
        ctrl = (JR.ReconfigController(pl, units, **CTRL,
                                      migration_cost=JR.MigrationCostModel())
                if reconfig else None)
        rep = JD.serve_workload(units, wl, seed=1, slo_scales=SLO_SCALES,
                                cost=JD.TickCostModel(), reconfig=ctrl,
                                faults=faults)
    else:
        wl = piecewise_poisson_trace(_phases(HORIZON), HORIZON, **trace)
        units = TD.units_from_placement(pl, params=placement_trees(pl, 0),
                                        dtype=torch.float32, device="cpu",
                                        **UNITS)
        ctrl = (TR.ReconfigController(pl, units, **CTRL,
                                      migration_cost=TR.MigrationCostModel())
                if reconfig else None)
        rep = TD.serve_workload(units, wl, seed=1, slo_scales=SLO_SCALES,
                                cost=TD.TickCostModel(), reconfig=ctrl,
                                faults=faults, sanitize=sanitize)
    outputs = {r.req_id: list(map(int, r.output))
               for u in units for r in u.stats.finished}
    return dict(wl=wl, rep=rep, ctrl=ctrl, units=units, outputs=outputs)


@pytest.fixture(scope="module")
def gate():
    return {(pkg, r): _serve(pkg == "jax", r, sanitize=(pkg == "port" and r))
            for pkg in ("jax", "port") for r in (False, True)}


def test_gate_zero_drops(gate):
    for run in gate.values():
        agg = run["rep"].aggregate
        assert agg.finished == agg.submitted == len(run["wl"].requests)
    assert len(gate[("port", True)]["wl"].requests) == 128


def test_gate_executes_a_move(gate):
    rc = gate[("port", True)]["rep"].reconfig
    assert rc.events >= 1 and rc.moves >= 1, rc.to_json()
    moves = [tuple(m) for ev in rc.log for m in ev["moves"]]
    assert ("llm2", 1, 0) in moves
    ctrl = gate[("port", True)]["ctrl"]
    assert {n: u.mesh_id for n, u in ctrl.owner_map().items()}["llm2"] == 0
    assert gate[("port", True)]["units"][1].engines == {}


def test_gate_reconfig_strictly_better(gate):
    s_att = gate[("port", False)]["rep"].aggregate.attainment
    r_att = gate[("port", True)]["rep"].aggregate.attainment
    assert any(r_att[s] > s_att[s] for s in SLO_SCALES), (s_att, r_att)


def test_gate_reports_equal_reference(gate):
    for r in (False, True):
        assert report_text(gate[("port", r)]["rep"]) \
            == report_text(gate[("jax", r)]["rep"]), r
    # the token estimates ride in every event (the monitor counts each
    # request's prompt + max_new tokens)
    for ev in gate[("port", True)]["rep"].reconfig.log:
        assert ev["token_estimates"]["llm2"] > 0


def test_gate_tokens_equal_reference(gate):
    for r in (False, True):
        assert gate[("port", r)]["outputs"] == gate[("jax", r)]["outputs"]
    # reconfiguration changes timing only: greedy tokens are the static
    # run's
    assert gate[("port", True)]["outputs"] == gate[("port", False)]["outputs"]


def test_migration_abort_at_the_move_returns_the_spec(gate):
    """``migration_abort@t`` at the time of the gate's move: the move is
    skipped and llm2's spec returns to mesh 1, no request is lost, and
    the faulted report equals the reference's."""
    t = next(ev["t"] for ev in gate[("jax", True)]["rep"].reconfig.log
             if ev["moves"])
    runs = {pkg: _serve(pkg == "jax", True,
                        faults=(JFaultPlan if pkg == "jax" else FaultPlan
                                ).parse(f"migration_abort@{t}"))
            for pkg in ("jax", "port")}
    run = runs["port"]
    rep, ctrl = run["rep"], run["ctrl"]
    agg = rep.aggregate
    assert agg.finished == agg.submitted == len(run["wl"].requests)
    assert rep.faults.migration_aborts == 1 and rep.faults.unfired == 0
    first, *later = rep.reconfig.log
    assert first["t"] == t and first["moves"] == [] \
        and first["migrated_blocks"] == 0
    # the spec went back to mesh 1, so a later window diffs the same move
    # again and executes it
    retry = next(ev for ev in later if ev["moves"])
    assert retry["moves"] == [["llm2", 1, 0]] and retry["t"] > t
    assert TR.assignment_of(ctrl.placement)["llm2"] == 0
    assert report_text(rep) == report_text(runs["jax"]["rep"])
    assert run["outputs"] == runs["jax"]["outputs"]


# ---------------------------------------------------------------------------
# the CLI's reconfiguration flags
# ---------------------------------------------------------------------------
CLI_FLAGS = ["--archs", "qwen2-7b,qwen2-7b", "--fused", "--chunk-tokens",
             "16", "--deterministic", "--horizon", "2", "--rate", "16",
             "--alpha", "1", "--pool-blocks", "16000", "--max-new", "4",
             "--reconfig", "--reconfig-interval", "0.25",
             "--drift-threshold", "1.1", "--faults", "migration_abort@1.0"]


def test_cli_reconfig_matches_reference(tmp_path, capsys, monkeypatch):
    """The serve CLI with ``--reconfig`` on one unit (wrapped in a
    one-mesh plan: quota rebalances only) gives the JAX CLI's report,
    events included, and metrics snapshot (the reconfiguration counters
    among them), and prints its event lines; a ``migration_abort`` is
    not called inert under ``--reconfig``."""
    out = {}
    for pkg, run in (("jax", jserve.main), ("port", serve.main)):
        rep, snap = tmp_path / f"{pkg}.json", tmp_path / f"{pkg}_m.json"
        args = [*CLI_FLAGS, "--report", str(rep), "--metrics-json",
                str(snap)]
        if pkg == "jax":
            monkeypatch.setattr(sys, "argv", ["serve", *args])
            assert run() == 0
        else:
            assert run([*args, "--device", "cpu"]) == 0
        text = capsys.readouterr().out
        assert "reconfig on: window=0.25s" in text
        assert "[serve] reconfig @" in text
        assert "inert without --reconfig" not in text
        report = json.loads(rep.read_text())
        report.pop("wall_s")
        out[pkg] = (json.dumps(report, sort_keys=True),
                    json.loads(snap.read_text()))
    assert out["port"] == out["jax"]
    report = json.loads(out["port"][0])
    assert report["reconfig"]["events"] >= 1
    fams = {f["name"]: f for f in out["port"][1]["families"]}
    events = {s["labels"]["kind"]: s["value"]
              for s in fams["mux_reconfig_events_total"]["series"]}
    assert events["event"] == report["reconfig"]["events"]


@pytest.mark.parametrize("args", [
    ["--reconfig", "--policy", "fcfs"],
    ["--reconfig", "--reconfig-interval", "0"],
    ["--reconfig", "--drift-threshold", "-1"],
], ids=["fcfs", "interval", "threshold"])
def test_cli_reconfig_errors_equal_reference(args, capsys, monkeypatch):
    def error_of(run):
        with pytest.raises(SystemExit) as exc:
            run()
        assert exc.value.code == 2
        err = capsys.readouterr().err.strip().splitlines()[-1]
        return err.split("error: ", 1)[1]

    monkeypatch.setattr(sys, "argv", ["serve", *args])
    want = error_of(jserve.main)
    assert error_of(lambda: serve.main([*args, "--device", "cpu"])) == want


def test_cli_notes_equal_reference(capsys, monkeypatch):
    """The wall-clock note under ``--reconfig`` and the inert-fault note
    without it: the JAX CLI's lines."""
    flags = ["--archs", "qwen2-7b", "--horizon", "0.3", "--max-new", "2",
             "--pool-blocks", "4000"]
    notes = {}
    for extra in (["--reconfig"], ["--faults", "migration_abort@1"]):
        got = {}
        for pkg, run in (("jax", jserve.main), ("port", serve.main)):
            if pkg == "jax":
                monkeypatch.setattr(sys, "argv", ["serve", *flags, *extra])
                assert run() == 0
            else:
                assert run([*flags, *extra, "--device", "cpu"]) == 0
            got[pkg] = [ln for ln in capsys.readouterr().out.splitlines()
                        if "note:" in ln]
        assert got["port"] == got["jax"] and got["port"], extra
        notes[extra[0]] = got["port"]
    assert any("analytic SLO references" in n for n in notes["--reconfig"])
    assert any("inert without --reconfig" in n for n in notes["--faults"])
