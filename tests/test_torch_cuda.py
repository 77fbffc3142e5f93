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
The SSD scan's output sums up to a chunk's worth of terms, and the int8
decode kernel's output scales with the cache's scales, so their
tolerance is relative to the plain output's largest magnitude (the same
1e-4 and 2e-2).  So is the decode kernels' on rows of thousands of
tokens, whose outputs are ~sqrt(e / n_tokens) in size, as large as an
absolute 2e-2.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import decode_splits as dsp
from repro_torch.kernels import flash_prefill as fp
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


@pytest.mark.parametrize("dtype,hd,H,n_kv", [
    (torch.float32, 64, 4, 2),        # reduced qwen2-7b pool
    (torch.bfloat16, 128, 28, 4),     # full-width qwen2-7b
    (torch.bfloat16, 64, 8, 1),
])
def test_decode_kernel_matches_plain(dev, dtype, hd, H, n_kv):
    rng = np.random.default_rng(0)
    B, max_blocks, layers = 8, 12, 3
    pool_k, pool_v = _pool(4096, hd, dtype, dev, 1)
    table = _tables(rng, B, max_blocks, 4096, layers * n_kv)
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
        fp.flash_prefill(x[..., :96].contiguous(), x[..., :96].contiguous(),
                         x[..., :96].contiguous())
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
])
def test_int8_decode_kernel_matches_plain_paged(dev, dtype, hd, H, n_kv):
    rng = np.random.default_rng(3)
    B, max_blocks, layers = 8, 12, 3
    k8, sk = _int8_cache(dev, (4096, 16, hd), 1)
    v8, sv = _int8_cache(dev, (4096, 16, hd), 2)
    table = _tables(rng, B, max_blocks, 4096, layers * n_kv)
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
    with pytest.raises(ValueError):                # a group of 16
        pi8.dense_decode_attention_int8(torch.randn((2, 32, 64), device=dev),
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
