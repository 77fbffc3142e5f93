"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where no NVIDIA GPU is present (the decision
is made inside the fixture, never at import).  On a machine with the
card, run ``python -m pytest -m cuda tests/test_torch_cuda.py``.

Tolerances: float32 runs with TF32 off, so kernel and plain differ only
in summation order and in the plain version's softmax rounding (1e-4);
bfloat16: 2e-2.  The bf16 prefill kernels keep their scores in f32 and
round P to bf16 before P·V; the plain version, like the JAX reference,
rounds its scores to bf16 (the einsum's output type), which puts it
farther from the f32 result than the kernels' schedule is
(tests/test_torch_prefill_tiles.py, S 1024); at S 1024 kernel and bf16
plain version have differed by more than 2e-2 on the card.  So the
bf16 prefill kernels are held to their plain version run in float32 on
the same bf16 inputs.
The grouped-expert SwiGLU (kernel 6) is held to its plain version in
the kernel's dtype, relative to the plain output's largest magnitude:
2e-5 in float32, 2e-2 in bfloat16.
The SSD scan's output sums up to a chunk's worth of terms, and the int8
decode kernel's output scales with the cache's scales, so their
tolerance is relative to the plain output's largest magnitude (the same
1e-4 and 2e-2).  So is the decode kernels' on rows of thousands of
tokens, whose outputs are ~sqrt(e / n_tokens) in size, as large as an
absolute 2e-2.
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import decode_splits as dsp
from repro_torch.kernels import flash_prefill as fp
from repro_torch.kernels import moe_grouped as mg
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import paged_attention_int8 as pi8
from repro_torch.kernels import ssd_scan as ss
from repro_torch.paging import resolve_physical_blocks

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are CUDA only)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _pool(n, hd, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((n, 16, hd), generator=g, device=dev).to(dtype),
            torch.randn((n, 16, hd), generator=g, device=dev).to(dtype))


def _tables(rng, rows, max_blocks, n_blocks, group_size):
    """Disjoint random group bases per row, −1 padded."""
    t = np.full((rows, max_blocks), -1, np.int32)
    bases = rng.permutation(n_blocks // group_size)[:rows * max_blocks]
    used = 0
    for r in range(rows):
        k = int(rng.integers(1, max_blocks + 1))
        t[r, :k] = bases[used:used + k] * group_size
        used += k
    return t


# ... and the shapes of the configs beyond qwen2-7b: head_dim 96
# (phi-3-vision-4.2b, 32 heads, group 1), group 12 (command-r-plus-104b,
# 96/8) and group 16 (qwen3-moe-235b-a22b, 64/4), whose heads 8-15 fill
# rows 8-15 of the bf16 body's m16 tile, each in bf16 and float32
@pytest.mark.parametrize("dtype,hd,H,n_kv", [
    (torch.float32, 64, 4, 2),        # reduced qwen2-7b pool
    (torch.bfloat16, 128, 28, 4),     # full-width qwen2-7b
    (torch.bfloat16, 64, 8, 1),
    (torch.bfloat16, 96, 32, 32),
    (torch.float32, 96, 8, 4),
    (torch.bfloat16, 128, 96, 8),
    (torch.float32, 128, 24, 2),
    (torch.bfloat16, 128, 64, 4),
    (torch.float32, 64, 16, 1),
    (torch.bfloat16, 96, 32, 2),      # hd 96 at group 16
])
def test_decode_kernel_matches_plain(dev, dtype, hd, H, n_kv):
    rng = np.random.default_rng(0)
    B, max_blocks, layers = 8, 12, 3
    n_blocks = max(4096, B * max_blocks * layers * n_kv)
    pool_k, pool_v = _pool(n_blocks, hd, dtype, dev, 1)
    table = _tables(rng, B, max_blocks, n_blocks, layers * n_kv)
    lens = np.array([int(rng.integers(1, 16 * max(1, (t >= 0).sum()) + 1))
                     for t in table], np.int32)
    lens[-1] = 1                                   # a padded row
    table[-1] = -1
    phys = resolve_physical_blocks(torch.from_numpy(table).to(dev), 2, n_kv)
    seq = torch.from_numpy(lens).to(dev)
    q = torch.randn((B, H, hd), device=dev).to(dtype)
    n0 = pa.DECODE_KERNEL.launches
    out = pa.fused_paged_decode_attention(q, pool_k, pool_v, phys, seq)
    ref = pa.decode_plain(q, pool_k, pool_v, phys, seq)
    torch.cuda.synchronize()
    assert pa.DECODE_KERNEL.launches == n0 + 1
    assert torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], err


# bf16 runs the tensor-core tile (64 query rows, 64-token key tiles of
# four head-blocks): full-width qwen2-7b (group 7, 448 rows = 7 tiles),
# zamba2-1.2b's geometry (group 1, hd 64), and a 64-block table with
# offsets up to 896 so the three-stage K/V ring wraps many times; row 1's
# offset is never a multiple of 64
@pytest.mark.parametrize("dtype,hd,H,n_kv,C,max_blocks,max_off", [
    (torch.float32, 64, 4, 2, 16, 10, None),
    (torch.bfloat16, 128, 28, 4, 64, 10, None),
    (torch.bfloat16, 64, 32, 32, 64, 10, None),
    (torch.bfloat16, 128, 28, 4, 64, 64, 896),
    (torch.bfloat16, 96, 32, 32, 64, 10, None),   # phi-3-vision-4.2b
    (torch.bfloat16, 96, 8, 2, 64, 64, 896),
    (torch.float32, 96, 4, 4, 16, 10, None),
    (torch.bfloat16, 128, 64, 4, 64, 10, None),   # qwen3-moe: group 16
])
def test_chunk_kernel_matches_plain(dev, dtype, hd, H, n_kv, C, max_blocks,
                                    max_off):
    rng = np.random.default_rng(1)
    B, layers = 6, 2
    pool_k, pool_v = _pool(4096, hd, dtype, dev, 2)
    table = _tables(rng, B, max_blocks, 4096, layers * n_kv)
    table[-1] = -1                                 # a padded row
    offs = np.array([int(rng.integers(0, 16 * max_blocks - C)) for _ in
                     range(B)], np.int32)
    offs[0], offs[-1] = 0, 0
    offs[1] = 37
    if max_off is not None:
        offs[2] = max_off
    phys = resolve_physical_blocks(torch.from_numpy(table).to(dev), 1, n_kv)
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((B, C, H, hd), generator=g, device=dev).to(dtype)
    qo = torch.from_numpy(offs).to(dev)
    out = fp.fused_paged_flash_prefill(q, pool_k, pool_v, phys, qo)
    ref = fp.paged_prefill_plain(q.float(), pool_k.float(), pool_v.float(),
                                 phys, qo)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], err


# bf16 runs the tensor-core tile: zamba2-1.2b's whole-prompt buckets
# (hd 64, 32 heads, S 272 and 416: a ragged last key tile), full-width
# qwen2-7b at 512 and 1024 tokens, and windows of 32, 48 and 100 (none a
# multiple of the 64-token key tile).  At hd 64 with window 48 the last
# rows of a query tile find their first key tile wholly masked: their
# probabilities there must stay finite (see exp_score in attn_common.cuh)
@pytest.mark.parametrize("dtype,hd,S,H,KV,window", [
    (torch.float32, 64, 48, 4, 2, None),
    (torch.bfloat16, 128, 512, 28, 4, None),
    (torch.bfloat16, 128, 100, 8, 2, 32),          # ragged S, window
    (torch.bfloat16, 64, 272, 32, 32, None),
    (torch.bfloat16, 64, 416, 32, 32, None),
    (torch.bfloat16, 128, 1024, 28, 4, None),
    (torch.bfloat16, 128, 300, 8, 2, 100),
    (torch.bfloat16, 64, 272, 32, 32, 48),
    (torch.bfloat16, 96, 512, 32, 32, None),      # phi-3-vision-4.2b
    (torch.bfloat16, 96, 300, 8, 2, 100),
    (torch.float32, 96, 48, 4, 4, None),
    (torch.bfloat16, 128, 272, 96, 8, None),      # command-r-plus: group 12
])
def test_flash_kernel_matches_plain(dev, dtype, hd, S, H, KV, window):
    B = 2
    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (torch.randn((B, S, n, hd), generator=g, device=dev).to(dtype)
               for n in (H, KV, KV))
    out = fp.flash_prefill(q, k, v, window=window)
    ref = fp.flash_prefill_plain(q.float(), k.float(), v.float(),
                                 window=window)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], err


def test_kernels_refuse_bad_operands(dev):
    q = torch.randn((2, 4, 64), device=dev)
    pool = torch.randn((8, 16, 64), device=dev)
    phys = torch.zeros((2, 2, 1), dtype=torch.int64, device=dev)
    lens = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        pa.fused_paged_decode_attention(q, pool, pool, phys, lens)
    with pytest.raises(ValueError):
        pa.fused_paged_decode_attention(q, pool.cpu(), pool, phys.int(),
                                        lens)
    counts = ops.launch_counts()
    with pytest.raises(ValueError):
        fp.flash_prefill(q[:, None], q[:, None, :2], q[:, None, :2],
                         window=0)
    # the bf16 tensor-core path: another head_dim, another dtype, a
    # non-contiguous or misaligned operand
    x = torch.randn((1, 64, 4, 128), device=dev).bfloat16()
    with pytest.raises(ValueError, match="head_dim"):
        fp.flash_prefill(x[..., :80].contiguous(), x[..., :80].contiguous(),
                         x[..., :80].contiguous())
    with pytest.raises(TypeError):
        fp.flash_prefill(x.half(), x.half(), x.half())
    with pytest.raises(ValueError, match="contiguous"):
        fp.flash_prefill(x, x.transpose(1, 2).contiguous().transpose(1, 2), x)
    with pytest.raises(ValueError, match="aligned"):
        y = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:]
        fp.flash_prefill(x, y.view(x.shape), x)
    xq = torch.randn((1, 4, 8, 128), device=dev).bfloat16()
    pool = torch.randn((8, 16, 128), device=dev).bfloat16()
    phys = torch.zeros((1, 2, 1), dtype=torch.int32, device=dev)
    qo = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        fp.fused_paged_flash_prefill(xq, pool.float(), pool.float(), phys,
                                     qo)
    with pytest.raises(ValueError, match="contiguous"):
        fp.fused_paged_flash_prefill(xq, pool.transpose(0, 1).contiguous()
                                     .transpose(0, 1), pool, phys, qo)
    assert ops.launch_counts() == counts


# The port's attention kernels take head_dim 64, 96 and 128 and the
# decode kernels at most 16 query heads per kv head; anything else
# raises ValueError before a launch (the Pallas kernels take any).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_refuse_hd_80_and_group_17(dev, dtype):
    counts = ops.launch_counts()
    lens = torch.full((2,), 5, dtype=torch.int32, device=dev)
    for hd, H, n_kv in ((80, 4, 2), (64, 34, 2), (128, 17, 1)):
        q = torch.randn((2, H, hd), device=dev).to(dtype)
        pool = torch.randn((8, 16, hd), device=dev).to(dtype)
        phys = torch.zeros((2, n_kv, 1), dtype=torch.int32, device=dev)
        with pytest.raises(ValueError, match="head_dim"):
            pa.fused_paged_decode_attention(q, pool, pool, phys, lens)
        ck, sk = _int8_cache(dev, (2, 8, n_kv, hd), 6)
        with pytest.raises(ValueError, match="head_dim"):
            pi8.dense_decode_attention_int8(q, ck, ck, sk, sk, lens)
    x = torch.randn((1, 32, 4, 80), device=dev).to(dtype)
    with pytest.raises(ValueError, match="head_dim"):
        fp.flash_prefill(x, x, x)
    pool = torch.randn((8, 16, 80), device=dev).to(dtype)
    phys = torch.zeros((1, 4, 2), dtype=torch.int32, device=dev)
    qo = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        fp.fused_paged_flash_prefill(x, pool, pool, phys, qo)
    assert ops.launch_counts() == counts


# The bf16 body's shared memory (decode_splitkv.cuh's SkSmem, mirrored
# in tests/test_torch_decode_splits.py) as the built kernels report it,
# and its launch bound of 3 CTAs an SM met at every head dim and group.
@pytest.mark.parametrize("group", [8, 16])
def test_decode_kernels_hold_three_ctas_an_sm(dev, group):
    smem = {("paged_decode.cu", 64): 72208, ("paged_decode.cu", 96): 57872,
            ("paged_decode.cu", 128): 76304}
    for src in ("paged_decode.cu", "paged_decode_int8.cu"):
        for hd in (64, 96, 128):
            occ = dsp.occupancy(src, hd, torch.bfloat16, group)
            assert occ["ctas_per_sm"] >= 3, (src, hd, occ)
            assert occ["smem_bytes"] == smem.get((src, hd),
                                                 occ["smem_bytes"])


def _ssd_inputs(dev, dtype, b, S, H, G, N, init, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    x = rn(b, S, H, 64).to(dtype)
    dt = torch.nn.functional.softplus(rn(b, S, H) - 2.0)
    a_log = torch.log(torch.linspace(1.0, 16.0, H, device=dev))
    B, C = rn(b, S, G, N).to(dtype), rn(b, S, G, N).to(dtype)
    d_skip = torch.ones(H, device=dev)
    st = rn(b, H, 64, N) * 0.1 if init else None
    return x, dt, a_log, B, C, d_skip, st


# the chip smoke's shapes: mamba2-2.7b chunk step (4 slots, 64-token
# chunk, carried state), a zamba2-1.2b whole-prompt bucket, and a
# reduced float32 case with two groups and a ragged last chunk; then the
# tensor-core body's cases: the chunk step at one slot, a ragged chunk
# step, zamba2 buckets whose last chunk holds 16 and 160 rows, two
# groups, d_state 16, a state carried over eight chunks, and chunk 256 at
# d_state 128 (a whole head does not fit in shared memory)
@pytest.mark.parametrize("dtype,b,S,H,G,N,chunk,init", [
    (torch.bfloat16, 4, 64, 80, 1, 128, 64, True),
    (torch.bfloat16, 2, 512, 64, 1, 64, 256, False),
    (torch.float32, 2, 72, 8, 2, 16, 32, True),
    (torch.bfloat16, 1, 64, 80, 1, 128, 64, True),
    (torch.bfloat16, 2, 17, 80, 1, 128, 64, True),
    (torch.bfloat16, 2, 272, 64, 1, 64, 256, False),
    (torch.bfloat16, 1, 416, 64, 1, 64, 256, True),
    (torch.bfloat16, 2, 72, 8, 2, 32, 32, True),
    (torch.bfloat16, 2, 100, 16, 1, 16, 64, False),
    (torch.bfloat16, 1, 512, 16, 1, 64, 64, True),
    (torch.bfloat16, 1, 300, 4, 1, 128, 256, True),   # two slices a head
])
def test_ssd_kernel_matches_plain(dev, dtype, b, S, H, G, N, chunk, init):
    x, dt, a_log, B, C, d_skip, st = _ssd_inputs(dev, dtype, b, S, H, G, N,
                                                 init)
    n0 = ss.SSD_KERNEL.launches
    y, fs = ss.ssd_scan(x, dt, a_log, B, C, d_skip, chunk, st)
    y_ref, fs_ref = ss.ssd_plain(x, dt, a_log, B, C, d_skip, chunk, st)
    torch.cuda.synchronize()
    assert ss.SSD_KERNEL.launches == n0 + 1
    assert y.dtype == dtype and fs.dtype == torch.float32
    for out, ref in ((y, y_ref), (fs, fs_ref)):
        out, ref = out.float(), ref.float()
        assert torch.isfinite(out).all()
        scale = ref.abs().max().item()
        err = (out - ref).abs().max().item()
        assert err <= TOL[dtype] * scale, (err, scale)


@pytest.mark.parametrize("plan", [(64, 8), (32, 8), (64, 4)])
def test_ssd_kernel_every_plan_matches_plain(dev, plan):
    """Each (P-slice, warps) the plan may choose, at a shape none of the
    served ones gives it: two groups, d_state 48, a carried state and
    five chunks, the last of 8 rows, so every launch walks chunks whole
    and ragged."""
    x, dt, a_log, B, C, d_skip, st = _ssd_inputs(dev, torch.bfloat16, 2, 264,
                                                 8, 2, 48, True)
    y, fs = ss.launch(x, dt, a_log, B, C, d_skip, 64, st, *plan)
    y_ref, fs_ref = ss.ssd_plain(x, dt, a_log, B, C, d_skip, 64, st)
    torch.cuda.synchronize()
    for out, ref in ((y, y_ref), (fs, fs_ref)):
        out, ref = out.float(), ref.float()
        assert torch.isfinite(out).all()
        err = (out - ref).abs().max().item()
        assert err <= TOL[torch.bfloat16] * ref.abs().max().item()


def test_ssd_smem_layout_matches_source(dev):
    """The host plans from its copy of the bf16 body's shared-memory
    layout: it must equal the built source's at every chunk, d_state and
    slice the kernel takes, or a plan could be refused at launch."""
    assert ss.source_smem(0, 0, 0) == ss.MAX_SMEM
    for chunk in range(1, ss.MAX_CHUNK + 1):
        for n in range(16, ss.MAX_STATE + 1, 16):
            for ps in (32, ss.HEAD_DIM):
                assert (ss.source_smem(chunk, n, ps)
                        == ss.tc_smem_bytes(chunk, n, ps)), (chunk, n, ps)


def test_ssd_kernel_refuses_bad_operands(dev):
    x, dt, a_log, B, C, d_skip, st = _ssd_inputs(dev, torch.float32, 1, 32,
                                                 4, 1, 16, True)
    n0 = ss.SSD_KERNEL.launches
    with pytest.raises(TypeError):                 # x and B dtypes differ
        ss.ssd_scan(x, dt, a_log, B.bfloat16(), C, d_skip, 32)
    with pytest.raises(TypeError):                 # a bf16 state
        ss.ssd_scan(x, dt, a_log, B, C, d_skip, 32, st.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        ss.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt,
                    a_log, B, C, d_skip, 32)
    with pytest.raises(ValueError):                # chunk past the kernel's
        ss.ssd_scan(x, dt, a_log, B, C, d_skip, 512)
    # x 8 bytes off 16-byte alignment (the kernel copies 16-byte units)
    xb = torch.empty(x.numel() + 2, dtype=x.dtype, device=x.device)
    x_off = xb[2:].view(x.shape)
    x_off.copy_(x)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ss.ssd_scan(x_off, dt, a_log, B, C, d_skip, 32)
    assert ss.SSD_KERNEL.launches == n0
    with pytest.raises(RuntimeError, match="launch failed"):   # no such plan
        ss.launch(x.bfloat16(), dt, a_log, B.bfloat16(), C.bfloat16(),
                  d_skip, 32, st, 16, 8)


def _int8_cache(dev, shape, seed):
    """An int8 cache with per-token scales (the last axis quantized)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randint(-127, 128, shape, generator=g, device=dev,
                      dtype=torch.int8)
    s = torch.rand(shape[:-1], generator=g, device=dev) * 0.05 + 1e-3
    return q, s


# the chip smoke's shapes: full-width qwen2-7b (bf16, 28/4 heads, hd 128)
# and the reduced model (f32, 4/2 heads, hd 64); a padded paged row and
# a row with no cached token
@pytest.mark.parametrize("dtype,hd,H,n_kv", [
    (torch.float32, 64, 4, 2),
    (torch.bfloat16, 128, 28, 4),
    (torch.bfloat16, 64, 14, 2),
    (torch.bfloat16, 96, 32, 32),
    (torch.float32, 96, 8, 4),
    (torch.bfloat16, 128, 96, 8),
    (torch.bfloat16, 128, 64, 4),
    (torch.float32, 64, 32, 2),
])
def test_int8_decode_kernel_matches_plain_paged(dev, dtype, hd, H, n_kv):
    rng = np.random.default_rng(3)
    B, max_blocks, layers = 8, 12, 3
    n_blocks = max(4096, B * max_blocks * layers * n_kv)
    k8, sk = _int8_cache(dev, (n_blocks, 16, hd), 1)
    v8, sv = _int8_cache(dev, (n_blocks, 16, hd), 2)
    table = _tables(rng, B, max_blocks, n_blocks, layers * n_kv)
    lens = np.array([int(rng.integers(1, 16 * max(1, (t >= 0).sum()) + 1))
                     for t in table], np.int32)
    lens[-1] = 1                                   # a padded row
    table[-1] = -1
    lens[-2] = 0                                   # a row with no token
    q = torch.randn((B, H, hd), device=dev).to(dtype)
    args = (q, k8, v8, sk, sv, torch.from_numpy(table).to(dev),
            torch.from_numpy(lens).to(dev), 2)
    n0 = pi8.DECODE_INT8_KERNEL.launches
    out = pi8.paged_decode_attention_int8(*args, n_kv=n_kv)
    phys = resolve_physical_blocks(args[5], 2, n_kv)
    ref = pi8.paged_int8_plain(q, k8, v8, sk, sv, phys, args[6])
    torch.cuda.synchronize()
    assert pi8.DECODE_INT8_KERNEL.launches == n0 + 1
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
    assert not out[-2].any() and not ref[-2].any()
    scale = ref.float().abs().max().item()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype] * scale, (err, scale)


@pytest.mark.parametrize("dtype,hd,H,KV,S", [
    (torch.float32, 64, 4, 2, 37),                 # S not a multiple of 16
    (torch.bfloat16, 128, 28, 4, 544),             # the W8/KV8 smoke phase
    (torch.bfloat16, 96, 32, 32, 300),
    (torch.float32, 96, 4, 2, 37),
    (torch.bfloat16, 128, 96, 8, 544),
    (torch.float32, 128, 48, 4, 100),
])
def test_int8_decode_kernel_matches_plain_dense(dev, dtype, hd, H, KV, S):
    """One layer of a stacked [L, B, S, KV, hd] cache, read in place."""
    B, L = 8, 3
    ck, sk = _int8_cache(dev, (L, B, S, KV, hd), 4)
    cv, sv = _int8_cache(dev, (L, B, S, KV, hd), 5)
    lens = torch.from_numpy(np.random.default_rng(4).integers(
        1, S + 1, B).astype(np.int32)).to(dev)
    lens[0] = S
    lens[1] = 0                                    # a row with no token
    q = torch.randn((B, H, hd), device=dev).to(dtype)
    n0 = pi8.DECODE_INT8_KERNEL.launches
    out = pi8.dense_decode_attention_int8(q, ck[1], cv[1], sk[1], sv[1], lens)
    ref = pi8.dense_int8_plain(q, ck[1], cv[1], sk[1], sv[1], lens)
    torch.cuda.synchronize()
    assert pi8.DECODE_INT8_KERNEL.launches == n0 + 1
    assert torch.isfinite(out.float()).all() and not out[1].any()
    scale = ref.float().abs().max().item()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype] * scale, (err, scale)


def test_int8_decode_kernel_refuses_bad_operands(dev):
    q = torch.randn((2, 4, 64), device=dev)
    ck, sk = _int8_cache(dev, (2, 8, 2, 64), 6)
    lens = torch.ones(2, dtype=torch.int32, device=dev)
    n0 = pi8.DECODE_INT8_KERNEL.launches
    with pytest.raises(TypeError):                 # a float cache
        pi8.dense_decode_attention_int8(q, ck.float(), ck, sk, sk, lens)
    with pytest.raises(TypeError):                 # int64 lengths
        pi8.dense_decode_attention_int8(q, ck, ck, sk, sk, lens.long())
    with pytest.raises(ValueError):                # head_dim 32
        pi8.dense_decode_attention_int8(q[..., :32].contiguous(),
                                        ck[..., :32].contiguous(),
                                        ck[..., :32].contiguous(), sk, sk,
                                        lens)
    with pytest.raises(ValueError):                # a group of 17
        pi8.dense_decode_attention_int8(torch.randn((2, 34, 64), device=dev),
                                        ck, ck, sk, sk, lens)
    with pytest.raises(ValueError):                # mixed devices
        pi8.dense_decode_attention_int8(q, ck.cpu(), ck, sk, sk, lens)
    assert pi8.DECODE_INT8_KERNEL.launches == n0


# Split-KV cases: rows of 1, 17 and ~4096 cached tokens in one launch,
# so most of a long row's splits run while the short rows' later splits
# are empty (they exit at once); a row of no token, a padded row (table
# -1, length 1), group 1 at hd 64 and group 7 at hd 128.
SPLIT_LENS = [1, 17, 4096, 0, 1, 700, 2049, 4000]
SPLIT_PADDED, SPLIT_EMPTY = 4, 3
SPLIT_LONG = [i for i, n in enumerate(SPLIT_LENS) if n > 2048]


def _long_rows_close(out, ref, dtype):
    """The long rows held relative to their plain outputs' largest
    magnitude."""
    o, r = out[SPLIT_LONG].float(), ref[SPLIT_LONG].float()
    scale = r.abs().max().item()
    err = (o - r).abs().max().item()
    assert err <= TOL[dtype] * scale, (err, scale)


def _split_tables(rng, lens, max_blocks, group_size):
    """Disjoint random group bases for each row's blocks, −1 past them;
    the padded row's table is all −1.  Returns (table, pool blocks)."""
    need = [0 if i == SPLIT_PADDED else -(-n // 16)
            for i, n in enumerate(lens)]
    bases = rng.permutation(sum(need))
    t = np.full((len(lens), max_blocks), -1, np.int32)
    used = 0
    for r, k in enumerate(need):
        t[r, :k] = bases[used:used + k] * group_size
        used += k
    return t, max(1, sum(need)) * group_size


@pytest.mark.parametrize("dtype,hd,H,n_kv", [
    (torch.float32, 64, 4, 2),        # reduced qwen2-7b pool
    (torch.bfloat16, 128, 28, 4),     # full-width qwen2-7b: group 7
    (torch.bfloat16, 64, 32, 32),     # zamba2-1.2b's shared attention: group 1
    (torch.bfloat16, 96, 32, 32),     # phi-3-vision-4.2b
    (torch.bfloat16, 128, 96, 8),     # command-r-plus-104b: group 12
    (torch.bfloat16, 128, 64, 4),     # qwen3-moe-235b-a22b: group 16
    (torch.float32, 96, 32, 2),
])
def test_decode_kernel_splits_match_plain(dev, dtype, hd, H, n_kv):
    rng = np.random.default_rng(5)
    max_blocks, layers = 256, 2
    table, n_blocks = _split_tables(rng, SPLIT_LENS, max_blocks,
                                    layers * n_kv)
    pool_k, pool_v = _pool(n_blocks, hd, dtype, dev, 6)
    phys = resolve_physical_blocks(torch.from_numpy(table).to(dev), 1, n_kv)
    seq = torch.tensor(SPLIT_LENS, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn((len(SPLIT_LENS), H, hd), generator=g,
                    device=dev).to(dtype)
    n0 = pa.DECODE_KERNEL.launches
    out = pa.fused_paged_decode_attention(q, pool_k, pool_v, phys, seq)
    ref = pa.decode_plain(q, pool_k, pool_v, phys, seq)
    torch.cuda.synchronize()
    assert pa.DECODE_KERNEL.launches == n0 + 1
    assert torch.isfinite(out.float()).all()
    # a row of no token is 0, as the Pallas kernel's acc / max(l, 1e-30);
    # the plain version (the reference's XLA oracle) averages instead
    assert not out[SPLIT_EMPTY].any()
    keep = [i for i in range(len(SPLIT_LENS)) if i != SPLIT_EMPTY]
    err = (out[keep].float() - ref[keep].float()).abs().max().item()
    assert err <= TOL[dtype], err
    _long_rows_close(out, ref, dtype)


@pytest.mark.parametrize("dtype,hd,H,n_kv", [
    (torch.float32, 64, 4, 2),
    (torch.bfloat16, 128, 28, 4),
    (torch.bfloat16, 64, 32, 32),
    (torch.bfloat16, 96, 32, 32),
    (torch.bfloat16, 128, 96, 8),
    (torch.bfloat16, 128, 64, 4),
    (torch.float32, 96, 24, 2),
])
def test_int8_decode_kernel_splits_match_plain_paged(dev, dtype, hd, H, n_kv):
    rng = np.random.default_rng(8)
    max_blocks, layers = 256, 2
    table, n_blocks = _split_tables(rng, SPLIT_LENS, max_blocks,
                                    layers * n_kv)
    k8, sk = _int8_cache(dev, (n_blocks, 16, hd), 9)
    v8, sv = _int8_cache(dev, (n_blocks, 16, hd), 10)
    g = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn((len(SPLIT_LENS), H, hd), generator=g,
                    device=dev).to(dtype)
    tab = torch.from_numpy(table).to(dev)
    seq = torch.tensor(SPLIT_LENS, dtype=torch.int32, device=dev)
    n0 = pi8.DECODE_INT8_KERNEL.launches
    out = pi8.paged_decode_attention_int8(q, k8, v8, sk, sv, tab, seq, 1,
                                          n_kv=n_kv)
    phys = resolve_physical_blocks(tab, 1, n_kv)
    ref = pi8.paged_int8_plain(q, k8, v8, sk, sv, phys, seq)
    torch.cuda.synchronize()
    assert pi8.DECODE_INT8_KERNEL.launches == n0 + 1
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
    assert not out[SPLIT_EMPTY].any() and not ref[SPLIT_EMPTY].any()
    scale = ref.float().abs().max().item()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype] * scale, (err, scale)
    _long_rows_close(out, ref, dtype)


# the W8/KV8 step's S 544 (8.5 splits of 64) and S that no split size
# divides, with a row at the cache's end, one of no token and short rows
@pytest.mark.parametrize("dtype,hd,H,KV,S", [
    (torch.bfloat16, 128, 28, 4, 544),
    (torch.bfloat16, 128, 28, 4, 4133),
    (torch.float32, 64, 4, 2, 1000),
    (torch.bfloat16, 64, 32, 32, 1000),
])
def test_int8_decode_kernel_splits_match_plain_dense(dev, dtype, hd, H, KV,
                                                     S):
    lens_np = np.array([1, 17, S, 0, 1, min(700, S), S - 37, S // 2],
                       np.int32)
    B, L = len(lens_np), 2
    ck, sk = _int8_cache(dev, (L, B, S, KV, hd), 12)
    cv, sv = _int8_cache(dev, (L, B, S, KV, hd), 13)
    lens = torch.from_numpy(lens_np).to(dev)
    g = torch.Generator(device=dev).manual_seed(14)
    q = torch.randn((B, H, hd), generator=g, device=dev).to(dtype)
    n0 = pi8.DECODE_INT8_KERNEL.launches
    out = pi8.dense_decode_attention_int8(q, ck[1], cv[1], sk[1], sv[1], lens)
    ref = pi8.dense_int8_plain(q, ck[1], cv[1], sk[1], sv[1], lens)
    torch.cuda.synchronize()
    assert pi8.DECODE_INT8_KERNEL.launches == n0 + 1
    assert torch.isfinite(out.float()).all() and not out[3].any()
    scale = ref.float().abs().max().item()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype] * scale, (err, scale)


# Every row within one split while the plan has several: the merge
# kernel's CTAs all find their row written by its split, and its grid
# must still not complete before the split grid has (it is launched as a
# programmatic dependent).  Its output feeds the next op on the stream
# (a projection, as o_proj takes it) with no synchronize between.
@pytest.mark.parametrize("kernel", ["paged", "int8_dense"])
def test_decode_kernels_one_live_split_feed_next_op(dev, kernel):
    B, H, n_kv, hd, max_tok = 8, 28, 4, 128, 4096
    plan = dsp.plan_splits(B, n_kv, max_tok, 16 if kernel == "paged"
                           else None, build.sm_count(dev))
    assert plan.n_splits > 1
    rng = np.random.default_rng(15)
    lens_np = rng.integers(1, plan.split + 1, B).astype(np.int32)
    lens_np[0] = plan.split
    lens = torch.from_numpy(lens_np).to(dev)
    g = torch.Generator(device=dev).manual_seed(16)
    q = torch.randn((B, H, hd), generator=g, device=dev).bfloat16()
    w = torch.randn((H * hd, 512), generator=g, device=dev).bfloat16()
    if kernel == "paged":
        mb = max_tok // 16
        table = (rng.permutation(B * mb) * n_kv).astype(np.int32)
        phys = resolve_physical_blocks(
            torch.from_numpy(table.reshape(B, mb)).to(dev), 0, n_kv)
        pool_k, pool_v = _pool(B * mb * n_kv, hd, torch.bfloat16, dev, 17)
        args = (q, pool_k, pool_v, phys, lens)
        counter, kern, plain = (pa.DECODE_KERNEL,
                                pa.fused_paged_decode_attention,
                                pa.decode_plain)
    else:
        ck, sk = _int8_cache(dev, (B, max_tok, n_kv, hd), 18)
        cv, sv = _int8_cache(dev, (B, max_tok, n_kv, hd), 19)
        args = (q, ck, cv, sk, sv, lens)
        counter, kern, plain = (pi8.DECODE_INT8_KERNEL,
                                pi8.dense_decode_attention_int8,
                                pi8.dense_int8_plain)
    torch.cuda.synchronize()
    n0 = counter.launches
    y = kern(*args).reshape(B, H * hd) @ w
    torch.cuda.synchronize()
    assert counter.launches == n0 + 1
    y_ref = plain(*args).reshape(B, H * hd) @ w
    scale = y_ref.float().abs().max().item()
    err = (y.float() - y_ref.float()).abs().max().item()
    assert torch.isfinite(y.float()).all()
    assert err <= TOL[torch.bfloat16] * scale, (err, scale)


# A reduced two-mesh optimizer plan served on the card: one unit per
# mesh in one session, the plan's shares enforced, every request done.
def test_two_mesh_plan_serves_on_the_card(dev):
    from repro_torch import configs
    from repro_torch.config import replace
    from repro_torch.core.placement import place, placement_from_json, \
        placement_to_json
    from repro_torch.core.workload import poisson_trace
    from repro_torch.serving.driver import (TickCostModel, serve_workload,
                                            units_from_placement)

    rates = {"qwen2-7b#0": 8.0, "qwen2-7b#1": 4.0, "mamba2-2.7b": 8 / 3}
    plan = place([(replace(configs.get(n.split("#")[0]), name=n), r)
                  for n, r in rates.items()], 2, mean_prompt=256,
                 mean_output=40)
    pl = placement_from_json(placement_to_json(plan), configs.get_reduced)
    units = units_from_placement(pl, pool_blocks=8000, chunk_tokens=16,
                                 fused=True, dtype=torch.bfloat16,
                                 device=dev)
    assert [u.mesh_id for u in units] == [0, 1]
    wl = poisson_trace(rates, 1.0, seed=0, mean_prompt=24, mean_output=8,
                       max_len=128)
    ops.reset_launch_counts()
    rep = serve_workload(units, wl, cost=TickCostModel(), max_new_cap=8)
    launches = ops.launch_counts()
    assert rep.aggregate.finished == rep.aggregate.submitted \
        == len(wl.requests) > 5
    assert rep.sm_frac == {s.name: s.sm_frac for m in pl.meshes
                           for s in m.specs}
    assert all(u.enforce_shares and u.pool.allocator.used == 0
               for u in units)
    for symbol in ("repro_paged_decode", "repro_paged_prefill",
                   "repro_ssd_scan"):
        assert launches[symbol] > 0, launches


# kernels 3 and 4 on the training path: inputs that require grad give an
# output whose grad_fn is the kernel's autograd node, the forward launches
# the kernel once and the backward none, and the gradients (the plain
# version's VJP from the saved inputs) equal autograd through the plain
# version on the same inputs, relative to the largest plain gradient
def _grads_close(got, ref, tol):
    for a, b in zip(got, ref):
        scale = b.float().abs().max().item()
        err = (a.float() - b.float()).abs().max().item()
        assert torch.isfinite(a.float()).all() and err <= tol * scale, \
            (err, scale)


@pytest.mark.parametrize("dtype,S,H,KV,hd,window", [
    (torch.float32, 256, 32, 32, 64, None),      # zamba2 shared attention
    (torch.bfloat16, 256, 32, 32, 64, None),
    (torch.bfloat16, 300, 28, 4, 128, 128),       # qwen2-7b, windowed
])
def test_flash_kernel_gradients_match_plain(dev, dtype, S, H, KV, hd,
                                            window):
    g = torch.Generator(device=dev).manual_seed(6)
    q, k, v, go = (torch.randn((2, S, n, hd), generator=g,
                               device=dev).to(dtype)
                   for n in (H, KV, KV, H))
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    n0 = fp.FLASH_KERNEL.launches
    out = fp.flash_prefill(*ins, window=window)
    assert type(out.grad_fn).__name__ == "_FlashPrefillBackward"
    assert fp.FLASH_KERNEL.launches == n0 + 1
    got = torch.autograd.grad(out, ins, go)
    assert fp.FLASH_KERNEL.launches == n0 + 1     # the backward is plain
    ref_ins = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(fp.flash_prefill_plain(*ref_ins,
                                                     window=window),
                              ref_ins, go)
    torch.cuda.synchronize()
    _grads_close(got, ref, TOL[dtype])


@pytest.mark.parametrize("dtype,b,S,H,N,chunk,init", [
    (torch.float32, 2, 512, 64, 64, 256, False),   # zamba2 scan
    (torch.float32, 2, 128, 8, 16, 32, True),
    (torch.bfloat16, 2, 512, 64, 64, 256, True),
])
def test_ssd_kernel_gradients_match_plain(dev, dtype, b, S, H, N, chunk,
                                          init):
    arrs = _ssd_inputs(dev, dtype, b, S, H, 1, N, init, seed=3)
    ins = [None if t is None else t.clone().requires_grad_() for t in arrs]
    n0 = ss.SSD_KERNEL.launches
    y, fs = ss.ssd_scan(*ins[:6], chunk, ins[6])
    assert type(y.grad_fn).__name__ == "_SsdScanBackward"
    assert ss.SSD_KERNEL.launches == n0 + 1
    g = torch.Generator(device=dev).manual_seed(7)
    gy = torch.randn(y.shape, generator=g, device=dev).to(dtype)
    gs = torch.randn(fs.shape, generator=g, device=dev)
    wrt = [t for t in ins if t is not None]
    got = torch.autograd.grad((y, fs), wrt, (gy, gs))
    assert ss.SSD_KERNEL.launches == n0 + 1
    ref_ins = [None if t is None else t.detach().clone().requires_grad_()
               for t in arrs]
    ry, rfs = ss.ssd_plain(*ref_ins[:6], chunk, ref_ins[6])
    ref = torch.autograd.grad((ry, rfs), [t for t in ref_ins
                                          if t is not None], (gy, gs))
    torch.cuda.synchronize()
    _grads_close(got, ref, TOL[dtype])


# without a gradient to take (inputs that want none, or no_grad, as on
# the serving path) kernels 3 and 4 launch with no autograd node
@pytest.mark.parametrize("wants_grad", [False, True])
def test_kernels_3_4_launch_bare_without_a_gradient(dev, wants_grad):
    g = torch.Generator(device=dev).manual_seed(8)
    q, k, v = (torch.randn((2, 80, n, 64), generator=g, device=dev)
               .to(torch.bfloat16) for n in (8, 2, 2))
    arrs = _ssd_inputs(dev, torch.bfloat16, 2, 128, 8, 1, 16, True, seed=4)
    if wants_grad:
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        arrs = [None if t is None else t.requires_grad_() for t in arrs]
    n3, n4 = fp.FLASH_KERNEL.launches, ss.SSD_KERNEL.launches
    with torch.no_grad():
        out = fp.flash_prefill(q, k, v)
        y, fs = ss.ssd_scan(*arrs[:6], 32, arrs[6])
    assert out.grad_fn is None and y.grad_fn is None and fs.grad_fn is None
    assert fp.FLASH_KERNEL.launches == n3 + 1
    assert ss.SSD_KERNEL.launches == n4 + 1
    ref = fp.flash_prefill_plain(q.detach().float(), k.detach().float(),
                                 v.detach().float())
    ry, rfs = ss.ssd_plain(*(None if t is None else t.detach()
                             for t in arrs[:6]), 32,
                           None if arrs[6] is None else arrs[6].detach())
    torch.cuda.synchronize()
    assert (out.float() - ref).abs().max().item() <= TOL[torch.bfloat16]
    for a, b in ((y, ry), (fs, rfs)):
        assert (a.float() - b.float()).abs().max().item() <= \
            TOL[torch.bfloat16] * b.float().abs().max().item()


# the compiled steps (serving/graphs.py): a captured fused decode and
# fused chunk step, replayed on other tokens, lengths and tables, equal
# the eager step bit for bit (logits and arena), and every replay adds
# its kernels' launches to the counts
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_captured_fused_steps_equal_eager(dev, dtype):
    from repro_torch import configs
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import engine as E
    from repro_torch.serving import graphs
    from repro_torch.serving.kvcache import UnifiedKVPool

    cfg = configs.get_reduced("qwen2-7b")
    trees = [init_params(cfg, torch.Generator().manual_seed(i), dtype, "cpu")
             for i in range(2)]
    params = {g: {k: torch.stack([t[g][k] for t in trees]).to(dev)
                  for k in trees[0][g]} for g in trees[0]}
    n, M, R, C, Wd = 512, 2, 4, 16, 8
    gs = cfg.n_layers * cfg.n_kv_heads
    pools = {}
    for mode in ("graph", "eager"):
        pools[mode] = UnifiedKVPool(n, cfg.hd, dtype, device=dev)
        g = torch.Generator(device=dev).manual_seed(3)
        for t in pools[mode].arena():
            t.copy_(torch.randn(t.shape, generator=g, device=dev).to(dtype))
    rng = np.random.default_rng(0)
    graphs.REGISTRY.clear()
    captures = dict(graphs.GRAPH_CAPTURES)
    for step in range(4):
        tables = (rng.permutation(n // gs)[:M * R * Wd] * gs).reshape(
            M, R, Wd).astype(np.int32)
        tables[-1, -1] = -1                      # a padded row
        toks = rng.integers(1, cfg.vocab_size, (M, R, C)).astype(np.int32)
        offs = (rng.integers(0, Wd - 1, (M, R)) * 16).astype(np.int32)
        clens = rng.integers(1, C + 1, (M, R)).astype(np.int32)
        lens = rng.integers(1, 16 * Wd, (M, R)).astype(np.int32)
        out = {}
        for mode, pool in pools.items():
            ctx = graphs.disable_graphs() if mode == "eager" else \
                contextlib.nullcontext()
            ops.reset_launch_counts()
            with ctx:
                lc = E._fused_prefill_chunk_step(params, toks, offs, clens,
                                                 pool, tables, cfg=cfg)
                ld = E._fused_decode_step(params, toks[:, :, 0], lens, pool,
                                          tables, cfg=cfg)
            torch.cuda.synchronize()
            out[mode] = (lc, ld, ops.launch_counts())
        assert torch.equal(out["graph"][0], out["eager"][0])
        assert torch.equal(out["graph"][1], out["eager"][1])
        for a, b in zip(pools["graph"].arena(), pools["eager"].arena()):
            assert torch.equal(a, b)
        # the same launches on the card, captured or not
        assert out["graph"][2] == out["eager"][2]
        assert out["graph"][2]["repro_paged_decode"] == cfg.n_layers
        assert out["graph"][2]["repro_paged_prefill"] == cfg.n_layers
    got = {k: v - captures.get(k, 0)
           for k, v in graphs.GRAPH_CAPTURES.items()}
    assert got.get("fused_decode") == 1 == got.get("fused_prefill_chunk")
    assert len(graphs.REGISTRY.graphs) == 2


# the fused chunk sweep sized to its rows (``FusedGroup.prefill``): with
# 1, 3, 5 and 9 rows in flight in one member (and 1 in the other) the
# sweep runs its row bucket, and the real rows' logits and the arena's
# KV equal those of the same sweeps run at all 16 rows, to bf16
# tolerance of the largest magnitude (cuBLAS may tile a smaller M
# otherwise); the KV lands on the same entries, and every bucket is
# captured at the group's first sweep
@pytest.mark.parametrize("busiest", [1, 3, 5, 9])
def test_bucketed_chunk_sweep_equals_full_rows(dev, busiest):
    from repro_torch.serving import driver, graphs
    from repro_torch.serving.engine import Request

    units, logits, shapes = {}, {}, {}
    for mode in ("bucketed", "16 rows"):
        unit = driver.build_unit_from_specs(
            [("a", "qwen2-7b", 0.5), ("b", "qwen2-7b", 0.5)],
            pool_blocks=4096, max_slots=16, chunk_tokens=64, seed=5,
            fused=True, reduced=True, dtype=torch.bfloat16, device=dev)
        (grp,) = unit.fused_groups
        if mode == "16 rows":
            grp.chunk_buckets = (grp.rows,)
        logits[mode], shapes[mode] = [], []

        def kept(params, toks, *rest, sweep=grp._prefill_fn, mode=mode):
            shapes[mode].append(toks.shape)
            out = sweep(params, toks, *rest)
            logits[mode].append(out.float().clone())
            return out
        grp._prefill_fn = kept
        rng = np.random.default_rng(busiest)
        for eng, n in zip(grp.engines, (busiest, 1)):
            eng.admit_chunked([Request(i, eng.cfg.name, rng.integers(
                1, eng.cfg.vocab_size, 72 + 4 * i).tolist(), 2)
                for i in range(n)])
        captures = graphs.GRAPH_CAPTURES["fused_prefill_chunk"]
        jobs = [eng.export_prefill_job() for eng in grp.engines]
        while any(j is not None for j in jobs):
            grp.prefill(jobs)
            jobs = [eng.export_prefill_job() for eng in grp.engines]
        torch.cuda.synchronize()
        assert graphs.GRAPH_CAPTURES["fused_prefill_chunk"] - captures == \
            len(grp.chunk_buckets)
        units[mode] = unit
    R = 1 << (busiest - 1).bit_length()
    assert shapes["bucketed"] == [(2, R, 64)] * 2
    assert shapes["16 rows"] == [(2, 16, 64)] * 2
    for got, want in zip(logits["bucketed"], logits["16 rows"]):
        for m, n in enumerate((busiest, 1)):
            a, b = got[m, :n], want[m, :n]
            assert (a - b).abs().max().item() <= \
                TOL[torch.bfloat16] * b.abs().max().item()
    for a, b in zip(units["bucketed"].pool.arena(),
                    units["16 rows"].pool.arena()):
        a, b = a.float(), b.float()
        assert torch.equal((a != 0).any(-1), (b != 0).any(-1))
        assert (a - b).abs().max().item() <= \
            TOL[torch.bfloat16] * b.abs().max().item()


# ---------------------------------------------------------------------------
# kernel 6: the grouped-expert SwiGLU of the dropless MoE FFN
# ---------------------------------------------------------------------------
MOE_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
GRANITE = (32, 8, 1536, 512)          # experts, top-k, d, f_e
QWEN3 = (128, 8, 4096, 1536)
REDUCED = (4, 2, 256, 128)


def _moe_inputs(dev, dtype, T, E, k, d, f, route="topk", seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*s, scale=1.0):
        return (torch.randn(s, generator=g, device=dev) * scale).to(dtype)
    x = randn(T, d)
    ws = (randn(E, d, f, scale=d ** -0.5), randn(E, d, f, scale=d ** -0.5),
          randn(E, f, d, scale=f ** -0.5))
    if route == "one":                      # every slot on the last expert
        idx = torch.full((T, k), E - 1, dtype=torch.int64, device=dev)
    elif route == "skew":                   # hot experts at the end
        bias = 4.0 * torch.arange(E, device=dev) / E
        idx = (torch.randn(T, E, generator=g, device=dev) + bias).topk(
            k).indices
    else:
        idx = torch.randn(T, E, generator=g, device=dev).topk(k).indices
    return x, ws, idx


def _moe_close(y, ref, dtype):
    scale = ref.float().abs().max().item()
    err = (y.float() - ref.float()).abs().max().item()
    assert torch.isfinite(y.float()).all() and err <= MOE_TOL[dtype] * scale, \
        (err, scale)


# full-width granite-moe and qwen3-moe at a 4-row decode (32 slots), a
# 64-token chunk (512 slots), the serving phases' largest buckets (4 ×
# 64 chunk rows, 4 × 512 whole prompts) and qwen3-moe's largest served
# whole prompt (1 × 512) in bf16, the reduced experts in float32, the
# edge routings (every slot on one expert, a single token), d and f not
# multiples of 64 (the tiles' zero-filled edges), and granite-moe on
# both sides of the 64 / 128-row plan threshold (192 and 193 tokens)
# with a skewed routing (empty experts beside ones of several M tiles)
@pytest.mark.parametrize("dtype,T,shape,route", [
    (torch.bfloat16, 4, GRANITE, "topk"),
    (torch.bfloat16, 64, GRANITE, "topk"),
    (torch.bfloat16, 4, QWEN3, "topk"),
    (torch.bfloat16, 64, QWEN3, "topk"),
    (torch.bfloat16, 256, GRANITE, "topk"),
    (torch.bfloat16, 2048, QWEN3, "topk"),
    (torch.float32, 4, REDUCED, "topk"),
    (torch.float32, 64, REDUCED, "topk"),
    (torch.float32, 64, (128, 8, 256, 128), "topk"),
    (torch.bfloat16, 64, GRANITE, "one"),
    (torch.bfloat16, 1, GRANITE, "topk"),
    (torch.float32, 64, REDUCED, "one"),
    (torch.float32, 1, REDUCED, "topk"),
    (torch.float32, 7, (8, 3, 72, 40), "topk"),     # d, f not of 64
    (torch.bfloat16, 512, QWEN3, "topk"),
    (torch.bfloat16, 7, (8, 3, 72, 40), "topk"),
    (torch.bfloat16, 33, (8, 3, 200, 136), "skew"),
    (torch.bfloat16, 192, GRANITE, "skew"),
    (torch.bfloat16, 193, GRANITE, "skew"),
])
def test_moe_grouped_kernel_matches_plain(dev, dtype, T, shape, route):
    E, k, d, f = shape
    x, (wg, wu, wd), idx = _moe_inputs(dev, dtype, T, E, k, d, f, route)
    order, offsets = mg.sort_slots(idx, E)
    n0 = mg.MOE_KERNEL.launches
    y = mg.grouped_swiglu(x, order, offsets, wg, wu, wd, k)
    assert mg.MOE_KERNEL.launches == n0 + 1
    ref = mg.grouped_swiglu_plain(x, order, offsets, wg, wu, wd, k)
    torch.cuda.synchronize()
    assert y.shape == (T * k, d) and y.dtype == dtype
    _moe_close(y, ref, dtype)
    pl = mg.plan(T * k, E, d, f, dtype)
    assert mg.source_plan(T * k, E, d, f, dtype) == pl
    assert mg.source_m_tiles(T * k, E, pl[0]) == mg.m_tiles(T * k, E, pl[0])


# kernel 6 captured in a CUDA graph: a replay equals the eager call bit
# for bit, on the captured routing and on another one copied into the
# graph's inputs (the grid is fixed by shapes, the tiles found on the
# device), at a 64- and a 128-row plan; its scratch (act, allocated
# inside the captured call) stays in the graph's pool: tensors of act's
# size allocated after the capture are untouched by a replay
@pytest.mark.parametrize("T,shape", [(64, GRANITE), (256, GRANITE)])
def test_moe_grouped_graph_replay_equals_eager(dev, T, shape):
    E, k, d, f = shape
    dtype = torch.bfloat16
    x, (wg, wu, wd), idx = _moe_inputs(dev, dtype, T, E, k, d, f, "skew")
    order, offsets = mg.sort_slots(idx, E)
    eager = mg.grouped_swiglu(x, order, offsets, wg, wu, wd, k)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):      # warm the launch path off the capture
        mg.grouped_swiglu(x, order, offsets, wg, wu, wd, k)
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = mg.grouped_swiglu(x, order, offsets, wg, wu, wd, k)
    junk = [torch.full((T * k, f), 7.0, dtype=dtype, device=dev)
            for _ in range(4)]
    n0 = mg.MOE_KERNEL.launches
    graph.replay()
    torch.cuda.synchronize()
    assert mg.MOE_KERNEL.launches == n0      # a replay launches no wrapper
    assert torch.equal(static, eager)
    assert all((j == 7.0).all() for j in junk)
    x2, _, idx2 = _moe_inputs(dev, dtype, T, E, k, d, f, "topk", seed=4)
    o2, off2 = mg.sort_slots(idx2, E)
    x.copy_(x2)
    order.copy_(o2)
    offsets.copy_(off2)
    graph.replay()
    eager2 = mg.grouped_swiglu(x, order, offsets, wg, wu, wd, k)
    torch.cuda.synchronize()
    assert torch.equal(static, eager2)


def test_moe_grouped_kernel_refuses_bad_operands(dev):
    E, k, d, f = REDUCED
    x, (wg, wu, wd), idx = _moe_inputs(dev, torch.bfloat16, 8, E, k, d, f)
    order, offsets = mg.sort_slots(idx, E)
    n0 = mg.MOE_KERNEL.launches
    bad = [
        dict(x=x.half(), w_gate=wg.half(), w_up=wu.half(),
             w_down=wd.half()),                         # another dtype
        dict(x=x.float()),                              # mixed dtypes
        dict(order=order.long()),                       # int64 routing
        dict(w_gate=wg.transpose(1, 2).contiguous().transpose(1, 2)),
        dict(x=torch.empty(x.numel() + 1, dtype=x.dtype,
                           device=dev)[1:].view(x.shape)),   # misaligned
        dict(w_up=wu[:, :, :120].contiguous(),
             w_gate=wg[:, :, :120].contiguous(),
             w_down=wd[:, :120].contiguous()),          # f % 8 == 0: fine
    ]
    args = dict(x=x, order=order, offsets=offsets, w_gate=wg, w_up=wu,
                w_down=wd)
    for i, change in enumerate(bad):
        kw = {**args, **change}
        if i == len(bad) - 1:
            mg.grouped_swiglu(**kw, top_k=k)            # runs
            continue
        with pytest.raises(ValueError):
            mg.grouped_swiglu(**kw, top_k=k)
    # more experts than the lookup scans, d not a multiple of 8
    x2, ws2, idx2 = _moe_inputs(dev, torch.float32, 4, 129, 2, 64, 64)
    with pytest.raises(ValueError, match="experts"):
        mg.grouped_swiglu(x2, *mg.sort_slots(idx2, 129), *ws2, 2)
    x3, ws3, idx3 = _moe_inputs(dev, torch.float32, 4, 4, 2, 60, 64)
    with pytest.raises(ValueError, match="multiples of 8"):
        mg.grouped_swiglu(x3, *mg.sort_slots(idx3, 4), *ws3, 2)
    assert mg.MOE_KERNEL.launches == n0 + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_grouped_kernel_gradients_match_plain(dev, dtype):
    E, k, d, f = REDUCED
    x, ws, idx = _moe_inputs(dev, dtype, 24, E, k, d, f, seed=5)
    order, offsets = mg.sort_slots(idx, E)
    ins = [t.clone().requires_grad_() for t in (x, *ws)]
    n0 = mg.MOE_KERNEL.launches
    y = mg.grouped_swiglu(ins[0], order, offsets, *ins[1:], k)
    assert type(y.grad_fn).__name__ == "_GroupedSwiGLUBackward"
    assert mg.MOE_KERNEL.launches == n0 + 1
    gy = torch.randn(y.shape, generator=torch.Generator(
        device=dev).manual_seed(9), device=dev).to(dtype)
    got = torch.autograd.grad(y, ins, gy)
    assert mg.MOE_KERNEL.launches == n0 + 1      # the backward is plain
    ref_ins = [t.clone().requires_grad_() for t in (x, *ws)]
    ref = torch.autograd.grad(mg.grouped_swiglu_plain(
        ref_ins[0], order, offsets, *ref_ins[1:], k), ref_ins, gy)
    torch.cuda.synchronize()
    _grads_close(got, ref, TOL[dtype])
    with torch.no_grad():
        assert mg.grouped_swiglu(ins[0], order, offsets, *ins[1:],
                                 k).grad_fn is None


# the MoE steps as CUDA graphs: reduced granite-moe's chunk and decode
# steps, captured through the registry and replayed on other tokens,
# lengths and tables, equal the eager steps bit for bit (logits, arena,
# launches); and their bodies make no host read (a sync raises under
# the sync-debug mode "error")
def test_captured_moe_steps_equal_eager(dev):
    from functools import partial

    from repro_torch import configs
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import engine as E
    from repro_torch.serving import graphs
    from repro_torch.serving.kvcache import UnifiedKVPool

    dtype = torch.bfloat16
    cfg = configs.get_reduced("granite-moe-3b-a800m")
    tree = init_params(cfg, torch.Generator().manual_seed(0), dtype, "cpu")
    params = {g: {k: v[None].to(dev) for k, v in tree[g].items()}
              for g in tree}
    n, R, C, Wd = 512, 4, 16, 8
    gs = cfg.n_layers * cfg.n_kv_heads
    pools = {}
    for mode in ("graph", "eager"):
        pools[mode] = UnifiedKVPool(n, cfg.hd, dtype, device=dev)
        g = torch.Generator(device=dev).manual_seed(3)
        for t in pools[mode].arena():
            t.copy_(torch.randn(t.shape, generator=g, device=dev).to(dtype))
    rng = np.random.default_rng(0)
    graphs.REGISTRY.clear()
    captures = dict(graphs.GRAPH_CAPTURES)
    for step in range(4):
        table = (rng.permutation(n // gs)[:R * Wd] * gs).reshape(
            R, Wd).astype(np.int32)
        table[-1] = -1                               # a padded row
        toks = rng.integers(1, cfg.vocab_size, (R, C)).astype(np.int32)
        offs = (rng.integers(0, Wd - 1, R) * 16).astype(np.int32)
        clens = rng.integers(1, C + 1, R).astype(np.int32)
        lens = rng.integers(1, 16 * Wd, R).astype(np.int32)
        out = {}
        for mode, pool in pools.items():
            ctx = graphs.disable_graphs() if mode == "eager" else \
                contextlib.nullcontext()
            ops.reset_launch_counts()
            with ctx:
                lc = E._prefill_chunk_step(params, 0, toks, offs, clens,
                                           pool, table, cfg=cfg)
                ld = E._decode_step(params, 0, toks[:, 0], lens, pool,
                                    table, cfg=cfg)
            torch.cuda.synchronize()
            out[mode] = (lc, ld, ops.launch_counts())
        assert torch.equal(out["graph"][0], out["eager"][0])
        assert torch.equal(out["graph"][1], out["eager"][1])
        for a, b in zip(pools["graph"].arena(), pools["eager"].arena()):
            assert torch.equal(a, b)
        assert out["graph"][2] == out["eager"][2]
        assert out["graph"][2]["repro_moe_grouped"] == 2 * cfg.n_layers
    got = {k: v - captures.get(k, 0)
           for k, v in graphs.GRAPH_CAPTURES.items()}
    assert got.get("chunk") == 1 == got.get("decode")
    # the device bodies under the sync check, then captured and replayed
    pool = pools["graph"]
    hosts = {
        "chunk": (E._chunk_inputs(toks[None], offs[None], clens[None],
                                  table[None], pool.block_tokens),
                  E._chunk_body),
        "decode": (E._decode_inputs(toks[None, :, 0], lens[None],
                                    table[None], pool.block_tokens),
                   E._decode_body)}
    for kind, (host, fn) in hosts.items():
        packed, layout = graphs.pack(host)
        a = graphs.unpack(torch.from_numpy(packed).to(dev), layout)
        body = E._on_model(partial(fn, cfg=cfg), 0)
        torch.cuda.synchronize()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eager = body(params, pool.arena(), a)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static = body(params, pool.arena(), a)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(static, eager), kind


# ---------------------------------------------------------------------------
# the train step as one CUDA graph (train/graphs.py)
# ---------------------------------------------------------------------------
TRAIN_GRAPH_ARCHS = ("qwen2-7b", "granite-moe-3b-a800m", "mamba2-2.7b",
                     "zamba2-1.2b", "musicgen-medium")
TRAIN_GRAPH_VARIANTS = {"plain": dict(remat=False, microbatches=1),
                        "remat": dict(remat=True, microbatches=1),
                        "microbatches 2": dict(remat=False, microbatches=2)}


def _train_steps(dev, arch, kw, graphed, steps=3):
    """``steps`` steps of the reduced ``arch`` at the trainer's defaults
    (batch 8 x 64, host batches), compiled or inside ``disable_graphs``:
    the losses, every parameter and state leaf after them, and each
    step's kernel launches."""
    from repro_torch import configs
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import graphs
    from repro_torch.train.data import DataConfig, synth_batch
    from repro_torch.train.graphs import compile_train_step
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.pytree import leaves
    from repro_torch.train.train_step import make_train_step

    cfg = configs.get_reduced(arch)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         torch.float32, dev)
    state = init_state(params)
    step = compile_train_step(make_train_step(
        cfg, AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=60), **kw))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8,
                      seed=0, frontend_dim=cfg.frontend_dim,
                      n_prefix_tokens=cfg.n_prefix_tokens)
    losses, launches = [], []
    with (contextlib.nullcontext() if graphed else graphs.disable_graphs()):
        for i in range(steps):
            toks, labels, prefix = synth_batch(dcfg, i)
            b = [torch.from_numpy(toks).long(), torch.from_numpy(labels)]
            if prefix is not None:
                b.append(torch.from_numpy(prefix))
            ops.reset_launch_counts()
            params, state, m = step(params, state, *b)
            losses.append(m["loss"].item())
            launches.append(ops.launch_counts())
    return losses, [t.clone() for t in leaves((params, state))], launches


def _spread(a, b):
    """The largest difference of two runs: a loss's relative, or a
    leaf's over that leaf's largest magnitude."""
    d = [abs(x - y) / abs(y) for x, y in zip(a[0], b[0])]
    d += [((x.double() - y.double()).abs().max()
           / y.double().abs().max().clamp(min=1e-30)).item()
          for x, y in zip(a[1], b[1])]
    return max(d)


@pytest.mark.parametrize("variant", list(TRAIN_GRAPH_VARIANTS))
@pytest.mark.parametrize("arch", TRAIN_GRAPH_ARCHS)
def test_compiled_train_step_equals_eager(dev, arch, variant):
    """Three steps of the compiled step (one capture, two replays) give
    the losses, parameters, moments and step counter of three eager
    steps bit for bit, and launch kernels 3 and 4 as often.  Where two
    eager runs are not bit-equal themselves (an accumulation whose order
    varies between runs: the capacity MoE FFN's
    ``index_put_(accumulate=True)`` dispatch and the embedding's
    backward), the graph must stay within 100 times their spread.  A
    failed capture raises out of the step and fails the test."""
    from repro_torch.serving import graphs

    kw = TRAIN_GRAPH_VARIANTS[variant]
    caps, reps = (graphs.GRAPH_CAPTURES["train"],
                  graphs.GRAPH_REPLAYS["train"])
    eager = _train_steps(dev, arch, kw, graphed=False)
    graph = _train_steps(dev, arch, kw, graphed=True)
    assert graphs.GRAPH_CAPTURES["train"] - caps == 1
    assert graphs.GRAPH_REPLAYS["train"] - reps == 2
    assert graph[2] == eager[2]
    if arch != "mamba2-2.7b":
        assert all(n["repro_flash_prefill"] > 0 for n in graph[2])
    if arch in ("mamba2-2.7b", "zamba2-1.2b"):
        assert all(n["repro_ssd_scan"] > 0 for n in graph[2])
    if graph[0] == eager[0] and all(torch.equal(a, b)
                                    for a, b in zip(graph[1], eager[1])):
        return
    spread = _spread(_train_steps(dev, arch, kw, graphed=False), eager)
    assert spread > 0, (arch, variant, _spread(graph, eager))
    assert _spread(graph, eager) <= 100 * spread
