"""The control, judged by the harness's own rule: the reference computed
with weight-only fp8 in the program's place, on the sequences the
program served, has to come out not correct at the cell's own limits
(``max_logit_gap``, ``harness.verdict``), while the program comes out
correct.  On the CPU at reduced width in float32, against limits a
float32 program meets; on the card at the cells' published widths,
bfloat16 as served, at a depth and a unit a test run holds (skips
without a card; on the card: ``python -m pytest --noconftest -m cuda
muxbench/tests``)."""
from __future__ import annotations

import pytest
import torch

from muxbench import harness, run
from muxbench.tests.cells import card_cell, limited

CARD_SEEDS = (11, 12, 13)


@pytest.mark.parametrize("name", ["pair-chat", "dense-ssm-chat"])
def test_control_is_judged_by_the_same_rule_on_the_cpu(name):
    out = run.run_cell(limited(name), 23, 2.0, False, device="cpu",
                       control=True)
    checked = out["_log"]["checked"]
    assert out["correct"], checked
    assert out["_log"]["control correct"] is False, checked
    assert all(r["control_gap"] > r["gap"] for r in checked.values())


def test_verdict_reads_the_gap_it_is_given():
    checks = {"a": dict(limit=0.2, sequences=3, gap=0.05, control_gap=0.3),
              "b": dict(limit=0.75, sequences=3, gap=0.3, control_gap=0.5)}
    assert harness.verdict(checks)
    assert not harness.verdict(checks, "control_gap")
    checks["a"]["control_gap"] = 0.2           # at the limit: within it
    assert harness.verdict(checks, "control_gap")
    checks["b"]["sequences"] = 0
    assert not harness.verdict(checks)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pair-chat", "dense-ssm-chat"])
def test_control_is_not_correct_at_the_cells_limits(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cell = card_cell(name)
    for seed in CARD_SEEDS:
        out = run.run_cell(cell, seed, 4.0, False, device="cuda",
                           control=True)
        checked = out["_log"]["checked"]
        assert out["correct"], checked
        assert out["_log"]["control correct"] is False, checked
        torch.cuda.reset_peak_memory_stats()
