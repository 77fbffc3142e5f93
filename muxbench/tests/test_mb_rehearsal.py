"""A CPU rehearsal of each cell of ``BENCHMARK.json`` at reduced width
through the same loop: the unit, the warm-up, the window, the sample and
the reference check.  It reports no device metric, and the measuring
entry point refuses to run without a card."""
from __future__ import annotations

import json

import pytest
import torch

from muxbench import run
from muxbench.harness import ROOT
from muxbench.tests.cells import limited, reduced_cell

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2 ** 31 + 77            # a run's seed may pass 32 signed bits


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "traced"])
def test_cell_rehearses_on_the_cpu(name, trace):
    cell = limited(name)
    out = run.run_cell(cell, SEED, 2.0, trace, device="cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] == round(cell.traffic["rate"] * 2.0)
    assert out["failed"] == 0
    names = set(out["metrics"])
    if trace:
        # host spans only: no device metric from a CPU run
        assert names == {m["name"] for m in cell.per_layer
                         if m["source"] == "program_span"}
        assert "busy_s" not in out["device"]
    else:
        assert names == {m["name"] for m in cell.end_to_end}
        assert {"out_tok_s", "tpot_p90_ms", "setup_s"} <= names
    assert list(out)[-2] == "checks"
    assert out["_log"]["graphs captured in fill and window"] == 0
    for r in out["_log"]["checked"].values():
        assert r["sequences"] >= 1


def test_same_seed_same_traffic_other_seed_same_work():
    from muxbench.traffic.generator import make_arrivals
    t = reduced_cell("pair-chat").traffic
    args = (t, ["a", "b"], {"a": 512, "b": 512}, 256)
    one = make_arrivals(*args, 5, 10.0)
    again = make_arrivals(*args, 5, 10.0)
    other = make_arrivals(*args, 2 ** 31 + 6, 10.0)
    assert [(a.due, a.prompt, a.max_new) for a in one] == \
        [(a.due, a.prompt, a.max_new) for a in again]
    win = [a for a in one if a.window]
    win2 = [a for a in other if a.window]
    assert len(win) == len(win2)
    assert sorted((len(a.prompt), a.max_new) for a in win) == \
        sorted((len(a.prompt), a.max_new) for a in win2)
    assert sorted(a.engine for a in win) == sorted(a.engine for a in win2)
    assert [a.due for a in win] == [a.due for a in win2]
    assert [(len(a.prompt), a.engine) for a in win] != \
        [(len(a.prompt), a.engine) for a in win2]
    # each block of consecutive arrivals brings the same work
    from muxbench.traffic.generator import BLOCK
    for a in range(0, len(win), BLOCK):
        assert sorted((len(x.prompt), x.max_new, x.engine)
                      for x in win[a:a + BLOCK]) == \
            sorted((len(x.prompt), x.max_new, x.engine)
                   for x in win2[a:a + BLOCK])
    assert max(a.due for a in win) < t["fill_s"] + 10.0


def test_entry_point_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "pair-chat", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    out = capsys.readouterr().out.strip().splitlines()
    assert not any(line.startswith("{") for line in out)
    with pytest.raises(SystemExit):
        run.main(["--workload", "nope", "--seed", "1", "--seconds", "1"])


def test_benchmark_file_names_existing_files():
    from muxbench.harness import HERE, ROOT
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()


def test_nothing_but_the_benchmark_finds_no_program(tmp_path):
    """In a directory holding only BENCHMARK.json and ``muxbench/`` a
    run stops before it prints anything: the program is not there."""
    import shutil
    import subprocess
    import sys
    from muxbench.harness import HERE, ROOT
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "muxbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = "from muxbench import harness; harness.port()"
    done = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode != 0
    assert "repro_torch" in done.stderr
    assert not done.stdout.strip()
