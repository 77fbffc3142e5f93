"""A model family enters the benchmark as new files only.

A copy of ``muxbench/`` and ``BENCHMARK.json`` gets the files of
``fixtures/hybrid/``, none of which it had: a family module and a plain
float32 reference for the port's hybrid family (Zamba2's layout of one
shared attention block, at the port's reduced Zamba2 sizes, without
its sliding window), a configuration that pairs it with the reduced
dense model, and a traffic file; and ``BENCHMARK.json`` gets the cell's
entries (``fixtures/hybrid/benchmark.json``).  From the copy, in
subprocesses, the copy's own CPU rehearsal takes the new cell, and
``fixtures/hybrid/rehearse.py`` serves it untraced and traced: correct,
whole-prompt prefill steps timed and bounded, kernel 1 bounded over
the layers that attend, no graph captured in the fill or the window.
Every file the copy had still hashes as it did."""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from muxbench import bounds
from muxbench.harness import HERE, ROOT

FIXTURE = HERE / "tests" / "fixtures" / "hybrid"
CELL = "hybrid-chat"
SEED = 2 ** 31 + 203


def digest(root) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """The copy with the new family's files added, and the digest of
    ``muxbench/`` as copied."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(HERE, root / "muxbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(root / "muxbench")
    new = FIXTURE / "muxbench"
    for src in sorted(new.rglob("*")):
        if src.is_file():
            dst = root / "muxbench" / src.relative_to(new)
            assert not dst.exists(), f"{dst} is not a new file"
            shutil.copy(src, dst)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    add = json.loads((FIXTURE / "benchmark.json").read_text())
    bench["configs"] += add["configs"]
    bench["workloads"] += add["workloads"]
    for m in bench["per_layer"]:
        if m["name"] in add["per_layer"]:
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root, before


def run_in(root, *args) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PYTHONDONTWRITEBYTECODE="1")
    return subprocess.run([sys.executable, *args], cwd=root, env=env,
                          capture_output=True, text=True, timeout=900)


def unchanged(root, before) -> None:
    after = digest(root / "muxbench")
    assert {k: after.get(k) for k in before} == before


def test_the_copys_rehearsal_takes_the_new_cell(checkout):
    root, before = checkout
    done = run_in(root, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                  "muxbench/tests/test_mb_rehearsal.py", "-k", CELL)
    assert done.returncode == 0, done.stdout[-4000:] + done.stderr[-2000:]
    assert "2 passed" in done.stdout
    unchanged(root, before)


def test_the_new_family_is_served_timed_bounded_and_checked(checkout):
    root, before = checkout
    done = run_in(root, str(FIXTURE / "rehearse.py"), CELL, str(SEED))
    assert done.returncode == 0, done.stderr[-4000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    for name in ("untraced", "traced"):
        r = out[name]
        assert r["correct"], r["checks"]
        assert r["window_captures"] == 0, r
        assert r["warm_captures"] > 0 and r["whole_prompt_probes"] > 0, r
    assert out["traced"]["metrics"] == sorted(
        ["session_host_us", "sched_host_us", "step_host_us",
         "argmax_wait_us"])
    hybrid = out["models"]["zamba2-1.2b"]
    steps = out["steps"]
    assert out["host_steps_s"] == pytest.approx(
        sum(s["host_s"] for s in steps))
    # whole-prompt prefills: timed on the host clock, bounded with the
    # scan in every layer and kernel 3 in the attending ones
    prefill = [s for s in steps if s["kind"] == "prefill"]
    assert prefill
    attending = hybrid["n_layers"] // hybrid["attn_every"]
    for s in prefill:
        (name, shp), = s["parts"]
        assert name == "zamba2-1.2b" and s["host_s"] > 0
        assert s["bound_s"] > 0
        assert s["kernels"]["k3"] == attending * bounds.bound_s(
            *bounds.k3_prefill_call(hybrid, shp["lens"]))
        assert s["kernels"]["k4"] == hybrid["n_layers"] * bounds.bound_s(
            *bounds.k4_ssd_call(hybrid, shp["lens"],
                                [True] * len(shp["lens"])))
    # the hybrid's decodes: kernel 1 over the layers that attend only
    decodes = [s for s in steps if s["kind"] == "decode"
               and s["parts"][0][0] == "zamba2-1.2b"]
    assert decodes
    for s in decodes:
        lens = s["parts"][0][1]["lens"]
        call = bounds.bound_s(*bounds.k1_decode_call(hybrid, lens))
        assert s["kernels"]["k1"] == attending * call
        assert attending < hybrid["n_layers"]
    # the dense engine beside it still chunks its prompts
    assert any(s["kind"] == "chunk" and "k2" in s["kernels"]
               for s in steps)
    unchanged(root, before)
