"""The port's cost model, estimator and placement (paper Alg. 1 + Alg. 2)
against the JAX package's, on the CPU.

* Every test of ``tests/test_placement.py``, run on
  ``repro_torch.core``.
* Parity: ``placement_to_json`` of the port's plan equals the JAX
  package's with ``==`` (no tolerance: the modules are plain Python and
  numpy, operation for operation) for ``place`` on the Table 1 mix, for
  ``place_onto_meshes``, ``place_spatial`` and ``place_memory_greedy``,
  and for the qwen2-7b ×2 + mamba2-2.7b plan ``chip_smoke.py`` serves,
  at A100 and at the port's H100.
* A plan saved by one package loads in the other.
"""
import dataclasses
import math

import pytest

from repro import configs as jconfigs
from repro.config import replace as jreplace
from repro.core import costmodel as jcm
from repro.core import placement as JP
from repro.core import workload as JW
from repro_torch import configs as tconfigs
from repro_torch.config import replace as treplace
from repro_torch.core import costmodel as cm
from repro_torch.core import placement as TP
from repro_torch.core import workload as TW
from repro_torch.core.costmodel import A100, H100, Hardware
from repro_torch.core.estimator import (LLMSpec, request_throughput,
                                        solve_batch, token_block_usage,
                                        unit_throughput)
from repro_torch.core.placement import (mesh_groups, parallel_candidates,
                                        place, place_memory_greedy,
                                        place_spatial)
from repro_torch.core.workload import llama_config

# the JAX package's TPU entry, rebuilt as a port Hardware: the port
# states no TPU number of its own
TPU_V5E = Hardware(**dataclasses.asdict(jcm.TPU_V5E))
# the port's H100 as a JAX-package Hardware, for the reference's side
J_H100 = jcm.Hardware(**dataclasses.asdict(H100))


# ---------------------------------------------------------------------------
# cost model (Fig. 3 reproduction properties)
# ---------------------------------------------------------------------------
def test_decode_latency_flat_in_f():
    """Decode is memory-bound: halving compute fraction changes latency
    far less than prefill (paper Fig. 3)."""
    cfg = llama_config("llama-7b")
    d_full = cm.decode_latency(cfg, 16, 400, f=1.0)
    d_half = cm.decode_latency(cfg, 16, 400, f=0.5)
    p_full = cm.prefill_latency(cfg, 1, 512, f=1.0)
    p_half = cm.prefill_latency(cfg, 1, 512, f=0.5)
    decode_blowup = d_half / d_full
    prefill_blowup = p_half / p_full
    assert decode_blowup < 1.2, "decode should be ~flat in f"
    assert prefill_blowup > 1.8, "prefill should scale ~1/f"


def test_tp_reduces_prefill_latency():
    cfg = llama_config("llama-30b")
    t1 = cm.prefill_latency(cfg, 1, 1024, tp=1)
    t4 = cm.prefill_latency(cfg, 1, 1024, tp=4)
    assert t4 < t1


def test_weight_devices_needed():
    big = llama_config("llama-65b")
    assert cm.weight_devices_needed(big, A100) >= 3
    small = llama_config("llama-7b")
    assert cm.weight_devices_needed(small, A100) == 1
    # v5e has 16GB → 7B bf16 needs 2
    assert cm.weight_devices_needed(small, TPU_V5E) >= 2


def test_h100_entry_is_the_data_sheet():
    """H100 SXM5: 989 TFLOP/s dense bf16, 3.35 TB/s, 80 GB, NVLink over 8
    as A100's link, and the reference's efficiency defaults."""
    assert (H100.peak_flops, H100.hbm_bw, H100.hbm_bytes, H100.link_bw) \
        == (989e12, 3.35e12, 80e9, 900e9 / 8)
    assert (H100.mfu, H100.mbu) == (A100.mfu, A100.mbu)
    assert A100 == Hardware(**dataclasses.asdict(jcm.A100))
    cfg = llama_config("llama-13b")
    assert cm.prefill_latency(cfg, 1, 512, hw=H100) \
        < cm.prefill_latency(cfg, 1, 512, hw=A100)


@pytest.mark.parametrize("name", ["llama-7b", "llama-30b", "qwen2-7b",
                                  "mamba2-2.7b", "zamba2-1.2b"])
def test_cost_model_equals_reference(name):
    """Every ported formula, at A100 and H100, tp 1–4 and fractions down
    to 0.1: equal floats to the JAX package's."""
    if name.startswith("llama"):
        tc, jc = llama_config(name), JW.llama_config(name)
    else:
        tc, jc = tconfigs.get(name), jconfigs.get(name)
    for thw, jhw in ((A100, jcm.A100), (H100, J_H100)):
        for tp in (1, 2, 4):
            for f in (0.1, 0.5, 1.0):
                for b, s in ((1, 256), (8, 1024)):
                    assert cm.prefill_latency(tc, b, s, tp=tp, f=f, hw=thw) \
                        == jcm.prefill_latency(jc, b, s, tp=tp, f=f, hw=jhw)
                    assert cm.decode_latency(tc, b, s, tp=tp, f=f, hw=thw) \
                        == jcm.decode_latency(jc, b, s, tp=tp, f=f, hw=jhw)
        assert cm.weight_devices_needed(tc, thw) \
            == jcm.weight_devices_needed(jc, jhw)
        for tp in (1, 2, 8):
            assert cm.max_kv_tokens(tc, tp, thw) \
                == jcm.max_kv_tokens(jc, tp, jhw)
    assert cm.step_flops(tc, 64, 300.5) == jcm.step_flops(jc, 64, 300.5)
    assert cm.decode_bytes(tc, 4, 300.5) == jcm.decode_bytes(jc, 4, 300.5)
    assert cm.prefill_bytes(tc, 2, 2048) == jcm.prefill_bytes(jc, 2, 2048)


# ---------------------------------------------------------------------------
# estimator (Eq. 3)
# ---------------------------------------------------------------------------
def _spec(name="llama-7b", rate=4.0, **kw):
    return LLMSpec(llama_config(name), rate, **kw)


def test_throughput_capped_by_rate():
    s = _spec(rate=0.5)
    t = request_throughput(s, 64, [s])
    assert t <= 0.5 + 1e-9


def test_throughput_monotone_in_batch():
    s = _spec(rate=1e9)  # uncapped
    ts = [request_throughput(s, b, [s]) for b in (1, 4, 16, 64)]
    assert all(b >= a for a, b in zip(ts, ts[1:]))


def test_solve_batch_meets_rate():
    s = _spec(rate=2.0)
    b, t = solve_batch(s, [s])
    assert t >= 2.0 - 1e-9
    if b > 1:
        assert request_throughput(s, b - 1, [s]) < 2.0


def test_colocation_lowers_single_llm_throughput():
    """Eq. 3: other LLMs' prefills serialize into the denominator."""
    a = _spec(rate=1e9)
    b = LLMSpec(llama_config("llama-13b"), 1e9)
    alone = request_throughput(a, 32, [a])
    shared = request_throughput(a, 32, [a, b])
    assert shared < alone


def test_token_block_usage_normalized_by_rate():
    lo = _spec(rate=1.0)
    hi = _spec(rate=10.0)
    assert token_block_usage(lo, 16) > token_block_usage(hi, 16)


def test_unit_throughput_memory_infeasible():
    specs = [LLMSpec(llama_config("llama-65b", tag=f"-{i}"), 1.0)
             for i in range(8)]
    assert unit_throughput(specs, 1, A100) == float("-inf")


# ---------------------------------------------------------------------------
# Alg. 2 candidates
# ---------------------------------------------------------------------------
def test_parallel_candidates_minimal_sm():
    cfg = llama_config("llama-7b")
    cands = parallel_candidates(cfg, rate=1.0, max_tp=8)
    assert cands, "must produce candidates"
    for c in cands:
        assert c.tp in (1, 2, 4, 8)
    tps = [c.tp for c in cands]
    assert len(set(tps)) == len(tps), "one candidate per TP degree"


def test_candidates_fraction_decreases_with_tp():
    """More TP → each device needs a smaller compute fraction."""
    cfg = llama_config("llama-13b")
    cands = parallel_candidates(cfg, rate=2.0, max_tp=8)
    by_tp = {c.tp: c.sm_frac for c in cands}
    if 1 in by_tp and 8 in by_tp:
        assert by_tp[8] <= by_tp[1]


# ---------------------------------------------------------------------------
# mesh-group enumeration
# ---------------------------------------------------------------------------
def test_mesh_groups_partition():
    groups = mesh_groups(16, node_size=8)
    assert groups
    for g in groups:
        assert sum(g) == 16
        assert all(s in (1, 2, 4, 8) for s in g)


def test_mesh_groups_equal_reference():
    for n, node, lim in ((16, 8, 512), (12, 4, 64), (32, 8, 128)):
        assert mesh_groups(n, node, limit=lim) \
            == JP.mesh_groups(n, node, limit=lim)


# ---------------------------------------------------------------------------
# Alg. 1 end-to-end placement
# ---------------------------------------------------------------------------
def _skewed_models(n_small=3, rate_hot=12.0, rate_cold=0.4, lc=llama_config):
    ms = [(lc("llama-7b", f"-{i}"),
           rate_hot if i == 0 else rate_cold) for i in range(n_small)]
    ms.append((lc("llama-30b", "-x"), rate_cold))
    return ms


def test_place_covers_all_models():
    models = _skewed_models()
    pl = place(models, n_devices=8, group_limit=64)
    placed = [s.name for m in pl.meshes for s in m.specs]
    assert sorted(placed) == sorted(cfg.name for cfg, _ in models)
    assert sum(m.n_devices for m in pl.meshes) == 8
    assert math.isfinite(pl.total_tpt) and pl.total_tpt > 0


def test_place_beats_memory_greedy_on_skewed():
    """Fig. 8: computation-first placement ≥ memory-greedy."""
    models = _skewed_models()
    a = place(models, n_devices=8, group_limit=64).total_tpt
    b = place_memory_greedy(models, n_devices=8).total_tpt
    assert a >= b * 0.999, (a, b)


def test_place_beats_spatial_on_skewed():
    """Colocation must not lose to dedicated GPUs under skew."""
    models = _skewed_models()
    a = place(models, n_devices=8, group_limit=64).total_tpt
    c = place_spatial(models, n_devices=8).total_tpt
    assert a >= c * 0.95, (a, c)


def test_spatial_gives_every_model_own_mesh():
    models = _skewed_models()
    pl = place_spatial(models, n_devices=16)
    assert len(pl.meshes) == len(models)
    for m in pl.meshes:
        assert len(m.specs) == 1


# ---------------------------------------------------------------------------
# parity with the JAX package: equal plan JSON
# ---------------------------------------------------------------------------
def _table1(alpha, pkg):
    ms = pkg.table1_models()
    rates = pkg.power_law_rates([m.name for m in ms], alpha, 20.0)
    return [(m, rates[m.name]) for m in ms]


def test_table1_models_equal_reference():
    assert [dataclasses.asdict(m) for m in TW.table1_models()] \
        == [dataclasses.asdict(m) for m in JW.table1_models()]


@pytest.mark.parametrize("alpha,n_devices", [(0.9, 8), (0.9, 16),
                                             (2.1, 8), (2.1, 16)])
def test_place_table1_equals_reference(alpha, n_devices):
    """Alg. 1 over the paper's Table 1 mix at its two skews."""
    t = place(_table1(alpha, TW), n_devices)
    j = JP.place(_table1(alpha, JW), n_devices)
    assert TP.placement_to_json(t) == JP.placement_to_json(j)
    assert len(t.meshes) > 1


@pytest.mark.parametrize("alpha", [0.9, 2.1])
def test_baselines_table1_equal_reference(alpha):
    """The Fig.-8 memory-greedy baseline at 8 and 16 devices, and the
    dedicated-mesh baseline at 32 (the smallest power of two that holds
    every Table 1 model on meshes of its own)."""
    for n in (8, 16):
        assert TP.placement_to_json(
            place_memory_greedy(_table1(alpha, TW), n)) \
            == JP.placement_to_json(
                JP.place_memory_greedy(_table1(alpha, JW), n))
    t = place_spatial(_table1(alpha, TW), 32)
    assert TP.placement_to_json(t) == JP.placement_to_json(
        JP.place_spatial(_table1(alpha, JW), 32))
    assert len(t.meshes) == 19


def test_place_onto_meshes_equals_reference():
    """Alg. 1's inner loop over a fixed mesh structure, with base
    architecture ids carried onto the specs."""
    meshes = [(0, 4), (3, 2), (5, 2)]
    archs = {"llama-7b-0": "llama-7b"}
    t = TP.place_onto_meshes(_skewed_models(), meshes, archs=archs,
                             mean_prompt=256, mean_output=40)
    j = JP.place_onto_meshes(_skewed_models(lc=JW.llama_config), meshes,
                             archs=archs, mean_prompt=256, mean_output=40)
    assert TP.placement_to_json(t) == JP.placement_to_json(j)
    assert [m.mesh_id for m in t.meshes] == [0, 3, 5]
    with pytest.raises(AssertionError):
        TP.place_onto_meshes([(llama_config("llama-65b"), 1.0)], [(0, 1)])


def _card_models(pkg_configs, rep, pkg):
    names = ["qwen2-7b#0", "qwen2-7b#1", "mamba2-2.7b"]
    rates = pkg.power_law_rates(names, alpha=1.0, max_rate=8.0)
    return [(rep(pkg_configs.get(n.split("#")[0]), name=n), rates[n])
            for n in names]


@pytest.mark.parametrize("hw", ["a100", "h100"])
@pytest.mark.parametrize("n_devices", [1, 2])
def test_card_plan_equals_reference(hw, n_devices):
    """The plan ``chip_smoke.py`` serves (qwen2-7b ×2 + mamba2-2.7b, α 1,
    max rate 8, full width, mean prompt 256 / output 40): one device
    holds all three at tp 1; two devices give mamba2-2.7b a mesh of its
    own at H100."""
    thw, jhw = {"a100": (A100, jcm.A100), "h100": (H100, J_H100)}[hw]
    kw = dict(mean_prompt=256, mean_output=40)
    t = place(_card_models(tconfigs, treplace, TW), n_devices, hw=thw, **kw)
    j = JP.place(_card_models(jconfigs, jreplace, JW), n_devices, hw=jhw,
                 **kw)
    assert TP.placement_to_json(t) == JP.placement_to_json(j)
    populated = [m for m in t.meshes if m.specs]
    if n_devices == 1:
        (m,) = populated
        assert [s.tp for s in m.specs] == [1, 1, 1]
        assert all(0.0 < s.sm_frac <= 1.0 for s in m.specs)
    if (hw, n_devices) == ("h100", 2):
        assert [[s.name for s in m.specs] for m in populated] \
            == [["qwen2-7b#0", "qwen2-7b#1"], ["mamba2-2.7b"]]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_plan_file_loads_in_the_other_package(writer, tmp_path):
    """The plan JSON is one wire format: a file ``save_placement`` of
    one package writes, the other's ``load_placement`` reads back to the
    same plan (configs resolved by the reader's own registry)."""
    path = str(tmp_path / "plan.json")
    kw = dict(mean_prompt=256, mean_output=40)
    if writer == "port":
        pl = place(_card_models(tconfigs, treplace, TW), 2, **kw)
        TP.save_placement(pl, path)
        back = JP.load_placement(path, jconfigs.get)
        want = TP.placement_to_json(pl)
    else:
        pl = JP.place(_card_models(jconfigs, jreplace, JW), 2, **kw)
        JP.save_placement(pl, path)
        back = TP.load_placement(path, tconfigs.get)
        want = JP.placement_to_json(pl)
    assert (JP if writer == "port" else TP).placement_to_json(back) == want
    for m in back.meshes:
        for s in m.specs:
            assert s.cfg.name == s.name
            assert s.cfg.n_layers == tconfigs.get(s.arch_id).n_layers


def test_hand_written_plan_defaults():
    """A plan without lengths takes the ShareGPT defaults, as the
    reference's loader does."""
    data = {"total_tpt": 1.0, "meshes": [{"mesh_id": 2, "n_devices": 1,
            "specs": [{"name": "a", "arch": "qwen2-7b", "rate": 1.5,
                       "tp": 1, "sm_frac": 0.4}]}]}
    t = TP.placement_from_json(data, tconfigs.get_reduced)
    j = JP.placement_from_json(data, jconfigs.get_reduced)
    assert TP.placement_to_json(t) == JP.placement_to_json(j)
    (s,) = t.meshes[0].specs
    assert (s.mean_prompt, s.mean_output, s.arch_id) == (161, 338,
                                                         "qwen2-7b")


def _mixed_models(pkg_configs, rep, pkg):
    names = ["granite-moe-3b-a800m", "phi-3-vision-4.2b", "qwen2-7b"]
    rates = pkg.power_law_rates(names, alpha=1.0, max_rate=8.0)
    return [(rep(pkg_configs.get(n), name=n), rates[n]) for n in names]


@pytest.mark.parametrize("hw", ["a100", "h100"])
@pytest.mark.parametrize("n_devices", [1, 2, 4])
def test_moe_and_vlm_mix_plan_equals_reference(hw, n_devices):
    """Placement over the MoE, vlm and dense families: the MoE model's
    parameter counts (all experts for memory, the routed ones for
    compute) reach the estimator, and the plan JSON equals the
    reference's."""
    thw, jhw = {"a100": (A100, jcm.A100), "h100": (H100, J_H100)}[hw]
    kw = dict(mean_prompt=256, mean_output=40)
    tm = _mixed_models(tconfigs, treplace, TW)
    t = place(tm, n_devices, hw=thw, **kw)
    j = JP.place(_mixed_models(jconfigs, jreplace, JW), n_devices, hw=jhw,
                 **kw)
    assert TP.placement_to_json(t) == JP.placement_to_json(j)
    # compute follows the routed experts, memory all of them
    moe = tm[0][0]
    wide = treplace(moe, moe=treplace(moe.moe, top_k=16))
    assert moe.active_param_count() < wide.active_param_count() \
        < moe.param_count() == wide.param_count()
    assert cm.decode_latency(moe, 8, 512, hw=thw) < \
        cm.decode_latency(wide, 8, 512, hw=thw)
    assert cm.max_kv_tokens(moe, 1, thw) == cm.max_kv_tokens(wide, 1, thw)
    placed = [s.name for m in t.meshes for s in m.specs]
    assert sorted(placed) == sorted(n for n, _ in
                                    ((c.name, r) for c, r in tm))
