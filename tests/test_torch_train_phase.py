"""``chip_smoke.py``'s training and serve-step phases rehearsed on the
CPU at reduced width: (b) ``train_reduced_match(device="cpu")``, (c)
``train_full_width(reduced=True)`` with its step-1 gradient check of
every leaf behind kernels 3 and 4 and its one-step time breakdown, (d)
``serve_steps_full_width(reduced=True)`` — the ring-buffer decode held
to the windowed forward and away from the unwindowed one, the SSM and
hybrid decodes held to the forward — and (e) ``train_graphs(...,
reduced=True)`` on (c)'s rehearsal, through the capture stub of
``tests/test_torch_step_graphs.py``.  Their host logic runs here as it
runs on the card, apart from the launch counts (the wrappers launch
nothing on CPU tensors) and the kernels' own spans in the breakdown."""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from test_torch_step_graphs import stub  # noqa: E402,F401

torch.set_num_threads(2)


def test_reduced_training_phase_rehearses_on_cpu():
    res = chip_smoke.train_reduced_match(torch, device="cpu")
    assert set(res["archs"]) == set(chip_smoke.TRAIN_ARCHS)
    for r in res["archs"].values():
        assert len(r["losses_card"]) == 3 and r["checkpoint_equal"]
        assert r["max_loss_rel"] == r["max_grad_rel"] == 0.0


def test_full_width_training_phase_rehearses_on_cpu():
    res = chip_smoke.train_full_width(torch, device="cpu", reduced=True)
    assert res["config"] == "zamba2-reduced" and len(res["losses"]) == 8
    assert sum(res["losses"][-5:]) / 5 < res["losses"][0]
    leaves = {f"{g}/{n}" for g, ns in chip_smoke.KERNEL_LEAVES.items()
              for n in ns}
    assert set(res["kernel_leaf_grads"]) == leaves
    assert all(v > 0 for v in res["kernel_leaf_grads"].values())
    parts = res["breakdown_ms"]
    assert parts["step"] == pytest.approx(
        parts["forward"] + parts["backward"] + parts["optimizer"])


def test_train_graphs_phase_rehearses_on_cpu(stub):
    """(c) then (e): one capture and 7 replays bit-equal to (c)'s eager
    steps, each reduced case bit-equal to its eager twin (the CPU runs
    under ``torch.use_deterministic_algorithms``: its embedding
    gradient otherwise sums in a varying order), the trainer stopped and
    resumed to the uninterrupted run's losses."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        kept = {}
        full = chip_smoke.train_full_width(torch, device="cpu", reduced=True,
                                           keep=kept)
        res = chip_smoke.train_graphs(torch, full, kept, device="cpu",
                                      reduced=True)
    finally:
        torch.use_deterministic_algorithms(was)
    f = res["full"]
    assert f["bit_equal"] and f["max_diff"] == 0.0 and not kept
    assert (f["graphs"]["captures"], f["graphs"]["replays"]) == (1, 7)
    assert set(res["reduced"]) == {f"{a} {v}" for a in chip_smoke.TRAIN_ARCHS
                                   for v in chip_smoke.TRAIN_GRAPH_CASES}
    for r in res["reduced"].values():
        assert r["bit_equal"] and r["spread"] == 0.0
        assert (r["graphs"]["captures"], r["graphs"]["replays"]) == (1, 2)
        assert r["eager"]["captures"] == r["eager again"]["captures"] == 0
    cli = res["cli"]
    assert cli["equal"] and cli["runs"]["resumed"]["first_line"] == \
        "[train] resumed from step 4"
    assert [(r["captures"], r["replays"]) for r in cli["runs"].values()] \
        == [(1, 7), (1, 3), (1, 3)]
    chip_smoke.print_train_graphs(res, "cpu")


def test_graph_runs_are_held_to_the_eager_spread():
    within = chip_smoke._within_spread
    assert within(True, 0.0, 0.0)
    assert not within(False, 1e-9, 0.0)       # eager reproducible: exact
    assert within(False, 1e-7, 2e-9)
    assert not within(False, 1e-5, 2e-9)


def test_full_width_training_leaf_check_catches_a_dead_leaf():
    """A layer whose kernel-side gradient is all zero (what a kernel
    output without a gradient would leave) fails the phase."""
    cfg = chip_smoke_config()
    grads = {g: {n: torch.ones((cfg.n_layers, 3)) for n in ns}
             for g, ns in chip_smoke.KERNEL_LEAVES.items()}
    chip_smoke._kernel_leaf_check(torch, grads, cfg)
    grads["layers"]["conv_b"][2] = 0.0
    with pytest.raises(AssertionError, match="layers/conv_b"):
        chip_smoke._kernel_leaf_check(torch, grads, cfg)
    grads["layers"]["conv_b"][2] = float("nan")
    with pytest.raises(AssertionError, match="non-finite"):
        chip_smoke._kernel_leaf_check(torch, grads, cfg)


def chip_smoke_config():
    from repro_torch import configs
    return configs.get_reduced(chip_smoke.TRAIN_FULL["arch"])


def test_serve_steps_phase_rehearses_on_cpu():
    res = chip_smoke.serve_steps_full_width(torch, device="cpu",
                                            reduced=True)
    models = res["models"]
    assert set(models) == {"qwen2-7b", "zamba2-1.2b", "mamba2-2.7b"}
    for r in models.values():
        assert r["rel_err"] < chip_smoke.SERVE_STEPS_TOL
        assert r["decode_steps"] == chip_smoke.SERVE_NEW
    w = models["qwen2-7b"]
    assert w["window"] == 64 and w["prompt"] > w["window"]
    assert w["rel_diff_unwindowed"] > chip_smoke.SERVE_STEPS_TOL


def test_ring_keeps_the_last_window_of_positions():
    L, B, S, KV, hd, W = 2, 1, 10, 1, 1, 4
    cache = torch.arange(S, dtype=torch.float32).reshape(1, 1, S, 1, 1) \
        .expand(L, B, S, KV, hd)
    ring = chip_smoke._ring(torch, cache, W, S)
    # positions 6..9 at slots 6 % 4 = 2, 3, 0, 1
    assert ring[0, 0, 0, :, 0].tolist() == [8.0, 9.0, 6.0, 7.0]
    short = chip_smoke._ring(torch, cache, W, 3)
    assert short[1, 0, 0, :, 0].tolist() == [0.0, 1.0, 2.0, 0.0]


def test_attention_work_counts_causal_pairs_in_the_window():
    assert chip_smoke._attn_work(1, 4, 1, 1, None) == 1 + 2 + 3 + 4
    assert chip_smoke._attn_work(2, 4, 3, 5, 2) == 2 * 3 * 5 * (1 + 2 + 2 + 2)
