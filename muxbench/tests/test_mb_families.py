"""The family modules (``muxbench/families/``) hold what the harness
computed before they existed, to the bit: the leaf lists of the
benchmark's model entries, the trees drawn from a seed, the step and
kernel-call bounds and each profiled step's bound.  The frozen values
(``fixtures/frozen_21c230d.json``) were computed by the harness at
commit 21c230d.  And the generic config builder: every group of keys
becomes the dataclass its ``ModelConfig`` field names, unknown keys are
refused."""
from __future__ import annotations

import copy
import hashlib
import json

import pytest
import torch

from muxbench import bounds, families, harness, probe, weights
from muxbench.harness import HERE
from muxbench.tests.cells import reduce

FROZEN = json.loads((HERE / "tests" / "fixtures" / "frozen_21c230d.json")
                    .read_text())
ENTRIES = {
    "qwen2-7b": json.loads((HERE / "configs" / "qwen2-7b-pair.json")
                           .read_text())["models"]["qwen2-7b"],
    "mamba2-2.7b": json.loads((HERE / "configs" / "qwen2-7b-mamba2.json")
                              .read_text())["models"]["mamba2-2.7b"],
}
QWEN, MAMBA = ENTRIES["qwen2-7b"], ENTRIES["mamba2-2.7b"]


def tree_hash(tree) -> str:
    h = hashlib.sha256()
    for group, leaves in tree.items():
        for leaf, t in leaves.items():
            h.update(f"{group}.{leaf}:{tuple(t.shape)}:{t.dtype}".encode())
            h.update(t.contiguous().view(-1).view(torch.uint8).numpy()
                     .tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("key", sorted(ENTRIES))
def test_leaf_lists_are_the_frozen_ones(key):
    m = ENTRIES[key]
    got = [[g, leaf, list(shape), kind, scale]
           for g, leaf, shape, kind, scale in families.of(m).leaves(m)]
    assert got == FROZEN["leaves"][key]
    assert weights.specs(m) == families.of(m).leaves(m)


@pytest.mark.parametrize("case", sorted(FROZEN["tree_sha256"]))
def test_reduced_trees_hash_as_the_frozen_ones(case):
    key, seed, engine, dtype = case.split(":")
    m = reduce(copy.deepcopy(ENTRIES[key]))
    tree = weights.make_tree(m, int(seed), int(engine),
                             getattr(torch, dtype), "cpu")
    assert tree_hash(tree) == FROZEN["tree_sha256"][case]


def test_dense_steps_are_the_frozen_ones():
    fam, L = families.of(QWEN), QWEN["n_layers"]
    for lens, step, call in FROZEN["qwen_decode"]:
        assert list(bounds.k1_decode_call(QWEN, lens)) == call
        b, f, k = fam.decode(QWEN, [dict(lens=lens)])
        assert [b, f] == step
        assert k == {"k1": L * bounds.bound_s(*call)}
    for offs, clens, step, call in FROZEN["qwen_chunk"]:
        assert list(bounds.k2_chunk_call(QWEN, offs, clens)) == call
        b, f, k = fam.chunk(QWEN, [dict(offs=offs, clens=clens)])
        assert [b, f] == step
        assert k == {"k2": L * bounds.bound_s(*call)}


def test_mamba2_steps_are_the_frozen_ones():
    fam, L = families.of(MAMBA), MAMBA["n_layers"]
    for rows, step in FROZEN["mamba_decode"]:
        b, f, k = fam.decode(MAMBA, [dict(rows=rows, lens=[7] * rows)])
        assert [b, f] == step and k == {}
    for clens, fresh, step, call in FROZEN["mamba_chunk"]:
        assert list(bounds.k4_ssd_call(MAMBA, clens, fresh)) == call
        b, f, k = fam.chunk(MAMBA, [dict(clens=clens, fresh=fresh)])
        assert [b, f] == step
        assert k == {"k4": L * bounds.bound_s(*call)}


def test_profiled_step_bounds_are_the_frozen_ones():
    """``probe.step_bound`` on planted steps (serial and fused, every
    kind the cells run) gives each step's bound and kernel bounds as the
    probe did, float for float."""
    models = {"qwen2-7b.a": QWEN, "qwen2-7b.b": QWEN, "qwen2-7b": QWEN,
              "mamba2-2.7b": MAMBA}
    for kind, parts, bound, kernels in FROZEN["probe_steps"]:
        got = probe.step_bound(kind, [tuple(p) for p in parts], models)
        assert got == (bound, kernels), (kind, parts)


def test_whole_prompt_prefill_is_a_chunk_from_zero_through_its_kernel():
    lens = [300, 17, 64]
    b, f, k = families.of(QWEN).prefill(QWEN, [dict(lens=lens)])
    cb, cf, _ = families.of(QWEN).chunk(
        QWEN, [dict(offs=[0, 0, 0], clens=lens)])
    assert (b, f) == (cb, cf)
    assert k == {"k3": QWEN["n_layers"] * bounds.bound_s(
        *bounds.k3_prefill_call(QWEN, lens))}
    b, f, k = families.of(MAMBA).prefill(MAMBA, [dict(lens=lens)])
    assert (b, f, k) == families.of(MAMBA).chunk(
        MAMBA, [dict(clens=lens, fresh=[True] * 3)])


def test_kernel_groups_join_every_familys():
    assert {k: probe.KERNELS[k] for k in ("k1", "k2", "k4")} == {
        "k1": "splitkv_", "k2": "PagedAddr", "k4": "ssd_scan"}
    for name in families.names():
        for key, pat in getattr(families.family(name), "KERNELS",
                                {}).items():
            assert probe.KERNELS[key] == pat
    with pytest.raises(ValueError, match="k3"):
        families.kernel_groups({"k3": "another_kernel"})


def test_model_config_builds_a_moe_entry_as_the_port_does():
    harness.port()
    from repro_torch.configs import granite_moe_3b_a800m as granite
    entry = dict(source="reduced smoke variant", reference="granite_moe",
                 max_logit_gap=0.5, family="moe", n_layers=2, d_model=256,
                 n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512,
                 moe=dict(n_experts=4, top_k=2, d_expert=128))
    got = harness.model_config(entry, "granite-moe-reduced")
    assert got == granite.REDUCED
    assert type(got.moe) is type(granite.REDUCED.moe)


@pytest.mark.parametrize("key", sorted(ENTRIES))
def test_model_config_of_the_entries_is_unchanged(key):
    """The builder gives the benchmark's entries the config the harness
    built before it took every group generically."""
    harness.port()
    from repro_torch.config import ModelConfig, SSMConfig
    m = ENTRIES[key]
    keys = set(ModelConfig.__dataclass_fields__) - {"name", "ssm", "source"}
    want = ModelConfig(name=key, source=m["source"],
                       ssm=SSMConfig(**m["ssm"]) if "ssm" in m else None,
                       **{k: v for k, v in m.items() if k in keys})
    assert harness.model_config(m, key) == want


@pytest.mark.parametrize("bad", [
    dict(attn_window=4096),                      # no such field
    dict(name="other"),                          # the engine names it
    dict(ssm=dict(d_state=16, state_width=3)),   # no such SSMConfig field
    dict(vocab_size=dict(size=3)),               # not a group
], ids=["unknown", "name", "unknown-in-group", "group-of-a-number"])
def test_model_config_refuses_what_the_port_has_no_field_for(bad):
    harness.port()
    m = dict(MAMBA, **bad)
    with pytest.raises(ValueError):
        harness.model_config(m, "m")
