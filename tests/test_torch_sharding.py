"""The port's mesh helpers and sharding rules against the reference's
(``repro.launch.sharding`` on ``AbstractMesh``es of the production
shapes): padded head geometry, every parameter leaf's spec (plain and
quantized trees), the batch / cache / state specs, the copied shape and
mesh dataclasses; ``constrain`` outside a mesh, and the kernels'
dispatch rule on ``meta``."""
import dataclasses
from types import SimpleNamespace

import jax
import pytest
import torch

import repro.config as RC
import repro.configs as RCF
from repro.launch import sharding as RS
from repro.launch.specs import param_shapes as ref_param_shapes
from repro.serving.quantize import quantize_params as ref_quantize
from repro_torch import config as TC
from repro_torch import configs as TCF
from repro_torch.kernels.ops import runs_kernel
from repro_torch.launch import sharding as TS
from repro_torch.launch.mesh import batch_axes, dp_ways, tp_ways
from repro_torch.launch.specs import param_shapes as port_param_shapes
from repro_torch.models.layers import (constrain, model_axis_size,
                                       shard_activation, use_mesh)
from repro_torch.serving.quantize import quantize_params as port_quantize
from tests._torch_specs import meshes, port_specs, ref_specs  # noqa: F401

ARCHS = list(RCF.ALIASES)
FAMILY_ARCH = {"dense": "qwen2-7b", "moe": "granite-moe-3b-a800m",
               "vlm": "phi-3-vision-4.2b", "audio": "musicgen-medium"}


@pytest.mark.parametrize("tp", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_physical_config_matches_reference(arch, tp):
    port = TS.physical_config(TCF.get(arch), tp)
    ref = RS.physical_config(RCF.get(arch), tp)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_shapes_mesh_config_and_geometry_are_the_references():
    assert {k: dataclasses.asdict(v) for k, v in TC.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in RC.SHAPES.items()}
    for mp in (False, True):
        t, r = TC.MeshConfig(mp), RC.MeshConfig(mp)
        assert (t.shape, t.axes, t.n_devices, t.dp, t.tp) == \
            (r.shape, r.axes, r.n_devices, r.dp, r.tp)
    for h, kv in ((28, 4), (64, 4), (24, 8), (40, 40), (32, 8)):
        for tp in (1, 2, 4, 8, 16):
            assert dataclasses.asdict(TC.tp_geometry(h, kv, tp)) == \
                dataclasses.asdict(RC.tp_geometry(h, kv, tp))


def _pair_trees(arch):
    cfg_t = TS.physical_config(TCF.get(arch), 16)
    cfg_r = RS.physical_config(RCF.get(arch), 16)
    return port_param_shapes(cfg_t), ref_param_shapes(cfg_r)


@pytest.mark.parametrize("attn_tp", [True, False])
@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference_leaf_by_leaf(arch, fsdp, attn_tp):
    port, ref = _pair_trees(arch)
    got = port_specs(TS.param_specs(port, fsdp=fsdp, attn_tp=attn_tp))
    want = ref_specs(RS.param_specs(ref, fsdp=fsdp, attn_tp=attn_tp))
    assert got == want


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("family", sorted(FAMILY_ARCH))
def test_quantized_param_specs_match_reference(family, fsdp):
    port, ref = _pair_trees(FAMILY_ARCH[family])
    qp = port_quantize(port)
    qr = jax.eval_shape(ref_quantize, ref)
    got = port_specs(TS.param_specs(qp, fsdp=fsdp))
    want = ref_specs(RS.param_specs(qr, fsdp=fsdp))
    assert got == want
    assert any(p.endswith("_s") for p, _ in got)


SPEC_FNS = ("batch_spec", "kv_cache_spec", "ssm_state_spec",
            "conv_tail_spec")


@pytest.mark.parametrize("fn", SPEC_FNS)
@pytest.mark.parametrize("batch", [1, 32, 128, 256])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_activation_specs_match_reference(meshes, multi_pod, batch, fn):
    port, ref = meshes
    got = getattr(TS, fn)(port[multi_pod], batch)
    want = getattr(RS, fn)(ref[multi_pod], batch)
    assert tuple(got) == tuple(want)
    tok = TS.token_specs(port[multi_pod], batch)
    assert tuple(tok[0]) == tuple(RS.token_specs(ref[multi_pod], batch)[0])


def test_mesh_helpers(meshes):
    port, ref = meshes
    for mp in (False, True):
        m, r = port[mp], ref[mp]
        assert batch_axes(m) == tuple(a for a in ("pod", "data")
                                      if a in r.axis_names)
        assert (dp_ways(m), tp_ways(m), m.size()) == \
            (r.size // 16, 16, r.size)
        with use_mesh(m):
            assert model_axis_size() == 16
        geom = TC.MeshConfig(mp)
        assert (tuple(m.mesh.shape), m.mesh_dim_names) == \
            (geom.shape, geom.axes)
    assert model_axis_size() == 1


def test_named_turns_specs_into_placements(meshes):
    from torch.distributed.tensor import Replicate, Shard
    m = meshes[0][True]
    tree = {"a": TS.P(None, ("pod", "data"), "model"), "b": TS.P()}
    pl = TS.named(m, tree)
    assert pl["a"] == [Shard(1), Shard(1), Shard(2)]
    assert pl["b"] == [Replicate()] * 3


def test_constrain_is_the_identity_outside_a_mesh(meshes):
    x = torch.randn(4, 8)
    assert constrain(x, ("pod", "data"), "model") is x
    assert shard_activation(x, seq="model", last="model") is x
    with use_mesh(meshes[0][False]):      # a plain tensor in a mesh
        assert constrain(x, "data", "model") is x


def test_runs_kernel_takes_the_plain_version_on_meta():
    on = SimpleNamespace
    cpu, meta = torch.zeros(1), torch.zeros(1, device="meta")
    cuda0 = on(device=torch.device("cuda", 0))
    cuda1 = on(device=torch.device("cuda", 1))
    assert runs_kernel("k", meta, meta) is False
    assert runs_kernel("k", cpu, cpu) is False
    assert runs_kernel("k", cuda0, cuda0) is True
    for mixed in ((meta, cpu), (cuda0, meta), (cuda0, cuda1), (cuda0, cpu)):
        with pytest.raises(ValueError, match="operands on"):
            runs_kernel("k", *mixed)


def test_runs_kernel_refuses_a_dtensor(meshes):
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.kernels.flash_prefill import flash_prefill
    local = torch.zeros(1, 4, 2, 8, device="meta")
    d = DTensor.from_local(local, meshes[0][False], [Replicate()] * 2,
                           run_check=False)
    for operands in ((d, d), (local, d)):
        with pytest.raises(TypeError, match="DTensor operand"):
            runs_kernel("k", *operands)
    with pytest.raises(TypeError, match="DTensor operand"):
        flash_prefill(d, d, d)
