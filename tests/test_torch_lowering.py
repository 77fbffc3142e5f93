"""``repro_torch.launch.specs`` against ``repro.launch.specs`` for every
(arch × shape) pair on both production meshes (the reference's builders
on ``AbstractMesh``es, with no devices): kind, skip reason, donated
arguments, every argument's shape and dtype, and every argument's
partition spec; the W8/KV8 decode variant on its pairs; and the
per-device argument bytes of the port's DTensor placements against the
arithmetic on the reference's shapes and specs."""
import pytest
import torch

from repro.launch import specs as RSP
from repro_torch.launch import sharding as TS
from repro_torch.launch import specs as TSP
from tests._torch_specs import (meshes, port_args, port_specs,  # noqa: F401
                                ref_args, ref_local_bytes, ref_specs)

PAIRS = list(TSP.all_pairs())
W8_PAIRS = [(a, s) for a, s in PAIRS if s == "decode_32k"
            and a not in ("mamba2-2.7b", "zamba2-1.2b")]


def test_pairs_are_the_references():
    assert PAIRS == list(RSP.all_pairs()) and len(PAIRS) == 40
    assert TSP.LONG_CTX_MODE == RSP.LONG_CTX_MODE
    assert TSP.SKIP_LONG == RSP.SKIP_LONG


def _both(meshes, arch, shape, multi_pod, variant):
    port, ref = meshes
    if variant == "w8kv8":
        return (TSP.build_quantized_decode(arch, shape, port[multi_pod]),
                RSP.build_quantized_decode(arch, shape, ref[multi_pod]))
    return (TSP.build_lowering(arch, shape, port[multi_pod]),
            RSP.build_lowering(arch, shape, ref[multi_pod]))


CASES = [(a, s, mp, "baseline") for a, s in PAIRS for mp in (False, True)] \
    + [(a, s, mp, "w8kv8") for a, s in W8_PAIRS for mp in (False, True)]


@pytest.mark.parametrize("arch,shape,multi_pod,variant", CASES)
def test_lowering_matches_reference(meshes, arch, shape, multi_pod,
                                    variant):
    t, r = _both(meshes, arch, shape, multi_pod, variant)
    assert (t.arch, t.shape, t.kind, t.skip, t.donate) == \
        (r.arch, r.shape, r.kind, r.skip, r.donate)
    assert (t.step_fn is None) == (r.step_fn is None)
    assert port_args(t.args) == ref_args(r.args)
    assert port_specs(t.in_specs) == ref_specs(r.in_specs)


@pytest.mark.parametrize("arch,shape,multi_pod,variant", CASES)
def test_per_device_argument_bytes_match_reference(meshes, arch, shape,
                                                   multi_pod, variant):
    t, r = _both(meshes, arch, shape, multi_pod, variant)
    if t.skip:
        assert r.skip == t.skip and t.args == ()
        return
    mesh = meshes[0][multi_pod]
    local = TS.distribute(mesh, t.args, t.in_specs)
    got = sum(x.to_local().numel() * x.element_size()
              for _, x in _leaves(local))
    assert got == ref_local_bytes(r.args, r.in_specs, meshes[1][multi_pod])


def _leaves(tree, path=""):
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, path + k)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v, path)]
    return []


def test_cut_batch_and_depth_keep_the_rules(meshes):
    mesh = meshes[0][False]
    full = TSP.build_lowering("qwen2-7b", "train_4k", mesh)
    cut = TSP.build_lowering("qwen2-7b", "train_4k", mesh, batch=32,
                             n_layers=2)
    assert cut.args[2].shape == (32, 4096)
    assert cut.args[0]["layers"]["wq"].shape[0] == 2
    assert port_specs(cut.in_specs) == port_specs(full.in_specs)
