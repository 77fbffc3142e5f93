"""``chip_smoke.py``'s live-reconfiguration phase rehearsed on the CPU at
reduced width (``serve_reconfig(torch, device="cpu", reduced=True)``):
its host logic — the gate's three properties, the sanitizer on every
tick, the page check at the migration copy, the carried decodes' first
logits after the move against the static run's, the side-copy probe and
its planted fault — runs here as it runs on the card, apart from the
launch counts and the memory counters (the wrappers launch nothing on
CPU tensors).  And the depth cut's reckoning: ``weight_bytes`` counts
the weight tree ``init_params`` builds, and the budget picks the depth
the phase serves on the card."""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.config import replace  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.serving.engine import tree_bytes  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("layers", [1, 2, 3])
def test_weight_bytes_counts_the_tree(layers):
    cfg = replace(configs.get_reduced("qwen2-7b"), n_layers=layers)
    tree = init_params(cfg, torch.Generator().manual_seed(0), torch.float32,
                       "cpu")
    b = chip_smoke.weight_bytes(cfg, 4)
    assert b["tok"] + layers * b["layer"] == tree_bytes(tree)
    biggest = max(t.numel() for t in tree["layers"].values()) * 4
    assert layers * b["layer_leaf"] == biggest


def test_reconfig_depth_fits_the_budget():
    d = chip_smoke.reconfig_depth(configs.get("qwen2-7b"))
    assert d["layers"] == 12
    assert d["move_gb"] <= d["budget_gb"] < chip_smoke.reconfig_depth(
        configs.get("qwen2-7b"), budget_gb=1e9)["move_gb"]
    assert abs(d["weights_gb"] - 7.773) < 1e-3
    assert abs(d["full"]["weights_gb"] - 15.231) < 1e-3
    assert d["full"]["move_gb"] > 80       # full depth cannot fit the card


def test_reconfig_phase_rehearses_on_cpu():
    res = chip_smoke.serve_reconfig(torch, device="cpu", reduced=True)
    runs = res["runs"]
    n = res["trace"]["requests"]
    assert n == 128
    for run in runs.values():
        assert run["finished"] == run["requests"] == n
    assert runs["reconfig"]["sanitizer_checks"] == runs["reconfig"][
        "ticks"] + 1
    assert res["better_scales"]
    moved = [ev for ev in res["events"] if ev["moves"]]
    assert moved and moved[0]["moves"] == [["llm2", 1, 0]]
    ev = moved[0]
    assert ev["migrated_blocks"] > 0 and ev["groups_equal"] == [
        ev["migrated_blocks"] // 4]             # reduced group: 2 x 2
    assert ev["carried_prefix_equal"] == len(res["carried"]) > 0
    lc, fault = res["logit_check"], res["planted_fault"]
    assert lc["rows"] == len(res["carried"])
    assert lc["max_rel_err"] < lc["tolerance"]
    assert lc["beyond_near_tie_flips"] == 0
    assert res["side_copy"]["max_rel_err"] < lc["tolerance"]
    assert fault["max_rel_err"] >= fault["floor"]
    # the gate's reference numbers at its --quick setup
    assert runs["static"]["attainment"]["1.5"] == pytest.approx(0.5390625)
    assert runs["reconfig"]["attainment"]["1.5"] == pytest.approx(0.890625)
