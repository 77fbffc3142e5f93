"""The port's int8 decode attention (``repro_torch.kernels
.paged_attention_int8``) against the JAX package's, on the CPU.

On CPU tensors the port runs its plain versions; the paged one is held
to the Pallas kernel ``paged_decode_attention_int8`` run with
``interpret=True`` (the JAX package's own test shapes plus GQA groups
of 7, the full-width qwen2-7b ratio), the dense-cache one to the W8/KV8
step's ``_decode_attend_dense_q``.  Tolerance: float32, rtol/atol 1e-4
(summation order and the place the scale is applied).  The CUDA kernel
reads both layouts through one addressing rule; its arguments are
replayed here in numpy to show they pick the cache rows the plain
versions read.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention_int8 import \
    paged_decode_attention_int8 as pallas_int8
from repro.launch.steps import _decode_attend_dense_q
from repro.serving.cache_ops import paged_decode_attention as jax_paged
from repro_torch.kernels import paged_attention_int8 as K
from repro_torch.paging import resolve_physical_blocks

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


def _quantize(x):
    """Per-(block, token) int8 of a float pool [..., hd] (numpy, the
    JAX test's rule)."""
    s = np.maximum(np.abs(x).max(-1), 1e-8) / np.float32(127.0)
    q = np.clip(np.round(x / s[..., None]), -127, 127).astype(np.int8)
    return q, s.astype(np.float32)


def _pool(b, h, kv, hd, bt, nb, layers=2, seed=0):
    rng = np.random.default_rng(seed)
    group = layers * kv
    N = 4 + b * nb * group
    k8, sk = _quantize(rng.standard_normal((N, bt, hd)).astype(np.float32) * 2)
    v8, sv = _quantize(rng.standard_normal((N, bt, hd)).astype(np.float32) * 2)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    table = (4 + np.arange(b * nb, dtype=np.int32) * group).reshape(b, nb)
    lens = rng.integers(1, nb * bt + 1, b).astype(np.int32)
    lens[0] = nb * bt                                # one full row
    return q, k8, v8, sk, sv, table, lens


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("b,h,kv,hd,bt,nb", [
    (2, 8, 2, 64, 16, 4),                # tests/test_kernels.py's shapes
    (1, 4, 4, 128, 16, 3),
    (3, 28, 4, 128, 16, 3),              # qwen2-7b's 28/4 heads: group 7
    (2, 14, 2, 64, 16, 5),               # group 7 at head_dim 64
    (2, 4, 4, 96, 16, 3),                # phi-3-vision-4.2b's head_dim 96
    (2, 24, 2, 64, 16, 3),               # group 12 (command-r-plus-104b)
    (2, 32, 2, 128, 16, 3),              # group 16 (qwen3-moe-235b-a22b)
])
def test_paged_int8_matches_pallas(b, h, kv, hd, bt, nb):
    q, k8, v8, sk, sv, table, lens = _pool(b, h, kv, hd, bt, nb)
    layer = 1
    expect = pallas_int8(*map(jnp.asarray, (q, k8, v8, sk, sv, table, lens)),
                         layer, n_kv=kv, interpret=True)
    out = K.paged_decode_attention_int8(*_t(q, k8, v8, sk, sv, table, lens),
                                        layer, n_kv=kv)
    assert out.dtype == torch.float32 and out.shape == (b, h, hd)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), **TOL)


def test_paged_int8_bf16_query():
    """A bf16 query: both compute in f32 and round the output to bf16
    once (tolerance one bf16 rounding of the largest output)."""
    q, k8, v8, sk, sv, table, lens = _pool(2, 28, 4, 128, 16, 3, seed=3)
    jq = jnp.asarray(q, jnp.bfloat16)
    expect = np.asarray(pallas_int8(jq, *map(jnp.asarray, (k8, v8, sk, sv,
                                                           table, lens)),
                                    0, n_kv=4, interpret=True), np.float32)
    tq = torch.from_numpy(np.asarray(jq, np.float32)).bfloat16()
    out = K.paged_decode_attention_int8(tq, *_t(k8, v8, sk, sv, table, lens),
                                        0, n_kv=4)
    assert out.dtype == torch.bfloat16
    err = np.abs(out.float().numpy() - expect).max()
    assert err <= 2 ** -8 * np.abs(expect).max(), err


def test_paged_int8_near_float_truth():
    """The int8 attention's quantization error against exact f32
    attention over the same (pre-quantization) KV (the JAX package's
    bound, 5 %)."""
    rng = np.random.default_rng(5)
    b, h, kv, hd, bt, nb = 1, 4, 2, 64, 16, 3
    kf = rng.standard_normal((b * nb * kv, bt, hd)).astype(np.float32)
    vf = rng.standard_normal((b * nb * kv, bt, hd)).astype(np.float32)
    (k8, sk), (v8, sv) = _quantize(kf), _quantize(vf)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    table = (np.arange(nb, dtype=np.int32) * kv)[None]
    lens = np.array([nb * bt], np.int32)
    out = K.paged_decode_attention_int8(*_t(q, k8, v8, sk, sv, table, lens),
                                        0, n_kv=kv).numpy()
    exact = np.asarray(jax_paged(*map(jnp.asarray, (q, kf, vf, table, lens)),
                                 0, kv))
    rel = np.abs(out - exact).max() / np.abs(exact).max()
    assert rel < 0.05, rel


def test_empty_row_is_zero():
    """A row with no cached token (seq_len 0) comes out 0 in the Pallas
    kernel (``acc / max(l, 1e-30)`` with nothing accumulated); both plain
    versions give the same, the other rows unchanged."""
    q, k8, v8, sk, sv, table, lens = _pool(3, 8, 2, 64, 16, 3, seed=4)
    lens[1] = 0
    expect = np.asarray(pallas_int8(*map(jnp.asarray, (q, k8, v8, sk, sv,
                                                       table, lens)),
                                    1, n_kv=2, interpret=True))
    assert not expect[1].any()
    out = K.paged_decode_attention_int8(*_t(q, k8, v8, sk, sv, table, lens),
                                        1, n_kv=2)
    np.testing.assert_allclose(out.numpy(), expect, **TOL)
    q, ck, cv, sk, sv, lens = _dense(3, 19, 2, 8, 64, seed=4)
    lens[1] = 0
    out = K.dense_decode_attention_int8(*_t(q, ck, cv, sk, sv, lens)).numpy()
    assert not out[1].any()
    expect = _decode_attend_dense_q(*map(jnp.asarray, (q, ck, cv, sk, sv,
                                                       lens)))
    np.testing.assert_allclose(out[[0, 2]], np.asarray(expect)[[0, 2]], **TOL)


def _dense(B, S, KV, H, hd, seed=0):
    rng = np.random.default_rng(seed)
    ck, sk = _quantize(rng.standard_normal((B, S, KV, hd)).astype(np.float32))
    cv, sv = _quantize(rng.standard_normal((B, S, KV, hd)).astype(np.float32))
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    lens = rng.integers(1, S + 1, B).astype(np.int32)
    lens[0] = S
    return q, ck, cv, sk, sv, lens


@pytest.mark.parametrize("B,S,KV,H,hd", [
    (2, 19, 2, 4, 64),          # reduced qwen2-7b, S not a multiple of 16
    (3, 48, 4, 28, 128),        # qwen2-7b heads
    (2, 33, 2, 14, 64),
])
def test_dense_int8_matches_step_reference(B, S, KV, H, hd):
    q, ck, cv, sk, sv, lens = _dense(B, S, KV, H, hd)
    expect = _decode_attend_dense_q(*map(jnp.asarray, (q, ck, cv, sk, sv,
                                                       lens)))
    out = K.dense_decode_attention_int8(*_t(q, ck, cv, sk, sv, lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), **TOL)


def _kernel_rows(layout, table, B, n_kv, lens):
    """Replay the CUDA kernel's addressing (csrc/paged_decode_int8.cu) in
    numpy: the cache row of every token the kernel reads, per (b, h)."""
    max_blocks, bt, max_tok, blk_rows, row_rows, head_rows, tok_rows = layout
    rows = {}
    for b in range(B):
        for h in range(n_kv):
            t = np.arange(min(int(lens[b]), max_tok))
            blk = t // bt if table is None else table[b, h, t // bt]
            rows[b, h] = (blk * blk_rows + b * row_rows + h * head_rows
                          + (t % bt) * tok_rows)
    return rows


def test_kernel_addressing_reads_the_plain_versions_rows():
    """The layouts the wrappers pass the kernel address exactly the
    rows the plain versions attend over: the paged pool through the
    resolved table, the dense layer in place (``S`` not a multiple of
    the kernel's token run, so the last run is partial)."""
    B, S, KV, hd, nb = 3, 37, 2, 64, 4
    q, ck, cv, sk, sv, lens = _dense(B, S, KV, 4, hd, seed=1)
    rows = _kernel_rows(K.dense_layout(S, KV), None, B, KV, lens)
    flat = ck.reshape(-1, hd)
    for (b, h), r in rows.items():
        np.testing.assert_array_equal(flat[r], ck[b, :lens[b], h])
        np.testing.assert_array_equal(sk.reshape(-1)[r], sk[b, :lens[b], h])
        assert r.max() < flat.shape[0]

    q, k8, v8, psk, psv, table, lens = _pool(B, 4, KV, hd, 16, nb)
    phys = resolve_physical_blocks(torch.from_numpy(table), 1, KV).numpy()
    rows = _kernel_rows(K.paged_layout(16, nb), phys, B, KV, lens)
    for (b, h), r in rows.items():
        expect = k8[phys[b, h]].reshape(nb * 16, hd)[:lens[b]]
        np.testing.assert_array_equal(k8.reshape(-1, hd)[r], expect)


def test_dense_and_paged_layouts_agree():
    """The same cache laid out densely and as head-blocks gives the same
    attention through the two wrappers (plain versions)."""
    B, KV, H, hd, nb = 2, 2, 8, 64, 3
    S = nb * 16
    q, ck, cv, sk, sv, lens = _dense(B, S, KV, H, hd, seed=2)
    # head-block (b, j, h) holds tokens 16j..16j+15 of row b, kv head h
    to_pool = [lambda a: a.reshape(B, nb, 16, KV, hd).transpose(0, 1, 3, 2, 4)
               .reshape(-1, 16, hd),
               lambda a: a.reshape(B, nb, 16, KV).transpose(0, 1, 3, 2)
               .reshape(-1, 16)]
    pk, pv = to_pool[0](ck), to_pool[0](cv)
    psk, psv = to_pool[1](sk), to_pool[1](sv)
    table = (np.arange(B * nb, dtype=np.int32) * KV).reshape(B, nb)
    paged = K.paged_decode_attention_int8(*_t(q, pk, pv, psk, psv, table,
                                             lens), 0, n_kv=KV)
    dense = K.dense_decode_attention_int8(*_t(q, ck, cv, sk, sv, lens))
    torch.testing.assert_close(paged, dense, **TOL)
