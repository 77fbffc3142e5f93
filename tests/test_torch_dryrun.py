"""The dry-run's model paths and its counting.

* ``blocked_causal_attention``, ``causal_conv_slabbed`` and
  ``ssd_seq_parallel`` against the reference's on the same inputs;
* the counter (``launch/op_analysis``) on the placeholder 16×16 mesh:
  one matmul's per-device FLOPs, an all-gather's ring bytes, a known
  allocate/free sequence's peak, and the depth extrapolation against a
  direct run;
* the dry-run of one pair per path at reduced depth: its output shapes
  equal ``jax.eval_shape`` of the reference's step;
* ``chip_smoke.py``'s lowering phase rehearsed on the CPU at reduced
  width."""
import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RCF
from repro.launch import specs as RSP
from repro.models import layers as RL
from repro.models import mamba2 as RM
from repro_torch.launch import dryrun
from repro_torch.launch import sharding as TS
from repro_torch.launch.op_analysis import analyze, ring_traffic
from repro_torch.models import layers as TL
from repro_torch.models import mamba2 as TM
from tests._torch_specs import meshes, ref_args  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)


def _qkv(S, h=4, kv=2, hd=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, S, h, hd)).astype(np.float32),
            rng.standard_normal((2, S, kv, hd)).astype(np.float32),
            rng.standard_normal((2, S, kv, hd)).astype(np.float32))


@pytest.mark.parametrize("S,window", [(64, None), (64, 20), (128, 40),
                                      (40, None), (40, 12)])
def test_blocked_attention_matches_reference(S, window):
    q, k, v = _qkv(S)
    ref = RL.blocked_causal_attention(*map(jnp.asarray, (q, k, v)),
                                      block_q=8, block_k=16, window=window)
    got = TL.blocked_causal_attention(*map(torch.from_numpy, (q, k, v)),
                                      block_q=8, block_k=16, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_blocked_attention_gradient_is_causal_attentions():
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(64, seed=1))
    out = TL.blocked_causal_attention(q, k, v, block_q=8, block_k=16,
                                      window=24)
    g = torch.autograd.grad(out.square().sum(), (q, k, v))
    ref = TL.causal_attention(q, k, v, window=24)
    g_ref = torch.autograd.grad(ref.square().sum(), (q, k, v))
    for a, b in zip(g, g_ref):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("slabs", [2, 8])
def test_causal_conv_slabbed_matches_reference(slabs):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 64, 12)).astype(np.float32)
    w = (rng.standard_normal((4, 12)) * 0.3).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    ref = RM.causal_conv_slabbed(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b), slabs)
    got = TM.causal_conv_slabbed(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(b), slabs)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    whole = TM.causal_conv(*map(torch.from_numpy, (x, w, b)))
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("slabs", [2, 4, 8])
def test_ssd_seq_parallel_matches_reference(slabs):
    rng = np.random.default_rng(3)
    b, s, h, p, n = 2, 128, 4, 16, 16
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.1
          ).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 4.0, h)).astype(np.float32)
    B = rng.standard_normal((b, s, 1, n)).astype(np.float32)
    C = rng.standard_normal((b, s, 1, n)).astype(np.float32)
    d = np.ones(h, np.float32)
    y_r, f_r = RM.ssd_seq_parallel(*map(jnp.asarray, (x, dt, a_log, B, C,
                                                      d)), 16, slabs=slabs)
    y_t, f_t = TM.ssd_seq_parallel(*map(torch.from_numpy, (x, dt, a_log, B,
                                                           C, d)), 16,
                                   slabs=slabs)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_r), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_r), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# the counter on the placeholder mesh
# ---------------------------------------------------------------------------
def _dt(mesh, shape, places):
    from torch.distributed.tensor import DTensor
    local = torch.empty(TS.local_shape(shape, mesh, places), device="meta")
    return DTensor.from_local(local, mesh, places, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def test_matmul_flops_per_device(meshes):
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = meshes[0][False]
    R = Replicate()
    glob = 2 * 256 * 512 * 1024
    x = _dt(mesh, (256, 512), [Shard(0), R])
    w = _dt(mesh, (512, 1024), [R, Shard(1)])
    an = analyze(lambda a, b: a @ b, (x, w), mesh)
    assert an.costs.flops == glob // 256 and an.costs.coll_bytes == 0
    assert an.outputs == [("", (256, 1024), "float32")]
    xr, wr = _dt(mesh, (256, 512), [R, R]), _dt(mesh, (512, 1024), [R, R])
    assert analyze(lambda a, b: a @ b, (xr, wr), mesh).costs.flops == glob
    # a contraction over a sharded dim: each device a partial sum of its
    # share; a partial operand: each device a whole-shape addend
    xk, wk = (_dt(mesh, (256, 512), [R, Shard(1)]),
              _dt(mesh, (512, 1024), [R, Shard(0)]))
    an = analyze(lambda a, b: a @ b, (xk, wk), mesh)
    assert an.costs.flops == glob // 16 and an.costs.coll_bytes == 0
    xp = _dt(mesh, (256, 512), [R, Partial()])
    an = analyze(lambda a, b: a @ b, (xp, wr), mesh)
    assert an.costs.flops == glob and an.costs.coll_bytes == 0


def test_all_gather_bytes_follow_the_ring(meshes):
    from torch.distributed.tensor import Replicate, Shard
    mesh = meshes[0][False]
    x = _dt(mesh, (256, 512), [Shard(0), Replicate()])
    an = analyze(lambda a: a.redistribute(mesh, [Replicate(), Replicate()]),
                 (x,), mesh)
    full = 256 * 512 * 4
    assert an.costs.coll_counts == {"all-gather": 1}
    assert an.costs.coll_by_kind["all-gather"] == full * 15 // 16 == \
        ring_traffic("all-gather", full, 16)
    assert an.argument_bytes == full // 16


def test_peak_counts_each_storage_while_it_lives(meshes):
    mib = 2 ** 20

    def seq():
        a = torch.empty(mib, dtype=torch.uint8, device="meta")
        b = torch.empty(2 * mib, dtype=torch.uint8, device="meta")
        a_view = a[: mib // 2]                 # the same storage
        del a, a_view
        c = torch.empty(4 * mib, dtype=torch.uint8, device="meta")
        del b
        return c[:10]
    an = analyze(seq, (), meshes[0][False])
    assert an.peak_bytes == 6 * mib
    assert an.output_bytes == 4 * mib and an.argument_bytes == 0


@pytest.mark.parametrize("arch,shape,depth", [
    ("qwen2-7b", "decode_32k", 4),
    ("mamba2-2.7b", "prefill_32k", 4),
    ("zamba2-1.2b", "long_500k", 3 * 6 + 2)])
def test_depth_extrapolation_equals_a_direct_run(meshes, arch, shape,
                                                 depth):
    mesh = meshes[0][False]
    pred = dryrun.predict(arch, shape, mesh, n_layers=depth)
    assert pred.depths[1] < depth
    direct = dryrun.run_lowering(
        dryrun._build(arch, shape, mesh, "baseline", None, depth), mesh)
    got, want = pred.analysis, direct
    assert dataclasses.asdict(got.costs) == dataclasses.asdict(want.costs)
    assert (got.argument_bytes, got.output_bytes, got.outputs) == \
        (want.argument_bytes, want.output_bytes, want.outputs)
    assert got.peak_bytes == pytest.approx(want.peak_bytes, rel=1e-2)


REDUCED_DEPTH = [("qwen2-7b", "train_4k"), ("qwen2-7b", "prefill_32k"),
                 ("qwen2-7b", "decode_32k"), ("mamba2-2.7b", "prefill_32k"),
                 ("zamba2-1.2b", "long_500k"),
                 ("phi-3-vision-4.2b", "prefill_32k"),
                 ("musicgen-medium", "train_4k"),
                 ("granite-moe-3b-a800m", "train_4k")]


@pytest.mark.parametrize("arch,shape", REDUCED_DEPTH)
def test_dry_run_outputs_match_reference_step(meshes, monkeypatch, arch,
                                              shape):
    cfg = RCF.get(arch)
    depth = cfg.attn_every if cfg.family == "hybrid" else 1
    pred = dryrun.predict(arch, shape, meshes[0][False], n_layers=depth)
    an = pred.analysis
    assert an.costs.flops > 0 and an.peak_bytes >= an.argument_bytes > 0
    get = RCF.get
    monkeypatch.setattr(RCF, "get", lambda a: dataclasses.replace(
        get(a), n_layers=depth))
    ref = RSP.build_lowering(arch, shape, meshes[1][False])
    out = jax.eval_shape(ref.step_fn, *ref.args)
    assert [(p, s, d) for p, s, d in an.outputs] == ref_args(out)


def test_cli_rejects_a_missing_pair():
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "qwen2-7b"])


def test_cli_record_keeps_the_reference_keys(meshes, tmp_path):
    assert dryrun.main(["--arch", "mamba2-2.7b", "--shape", "long_500k",
                        "--out", str(tmp_path)]) == 0
    rec = json.loads(
        (tmp_path / "mamba2-2.7b__long_500k__16x16.json").read_text())
    assert {"flops_per_device", "bytes_accessed_per_device", "collective",
            "peak_bytes"} <= set(rec)
    assert {"argument_bytes", "output_bytes", "temp_bytes"} <= \
        set(rec["memory"])
    # blocked attention's counts are of the blocks the mask meets
    assert rec["counted_blocks"] == "mask-visited"


def test_lowering_phase_rehearses_on_cpu():
    res = chip_smoke.check_lowering(torch, device="cpu", reduced=True)
    assert [k.split(" (")[0] for k in res["pairs"]] == \
        [f"{a} x {s}" for a, s, _ in chip_smoke.LOWERING_PAIRS]
    for r in res["pairs"].values():
        assert r["argument_bytes"] == r["argument_bytes_predicted"]
        assert r["outputs_equal"] and r["finite"]
        assert r["flops_predicted"] > 0
