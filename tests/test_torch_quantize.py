"""The port's int8 quantization (``repro_torch.serving.quantize``)
against the JAX package's (``repro.serving.quantize``), on the CPU.

The same numpy-seeded arrays go through both.  The quantizers must give
EQUAL int8 values and float32 scales (both round half to even and divide
in float32).  ``qmatmul`` and the ``QLayerView`` slices run bf16
products, which XLA and PyTorch round at different places: they agree
within 2e-2 of the reference's largest magnitude.  The tests of
``tests/test_quantize.py`` that hold no serve step run here against the
port with their own bounds.
"""
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st

from repro import configs as jconfigs
from repro.models.transformer import init_params as jinit
from repro.serving import quantize as JQ
from repro_torch import configs as tconfigs
from repro_torch.models.transformer import params_to_torch
from repro_torch.serving import quantize as TQ

torch.set_num_threads(2)
BF16_TOL = 2e-2


def _np(a):
    """A JAX array as numpy, bf16 widened to float32 (exact)."""
    a = np.asarray(a)
    return a if a.dtype == np.int8 else a.astype(np.float32)


def _equal(jq, tq):
    assert tq.dtype == (torch.int8 if np.asarray(jq).dtype == np.int8
                        else torch.float32)
    np.testing.assert_array_equal(_np(jq), tq.float().numpy()
                                  if tq.dtype != torch.int8 else tq.numpy())


def _jax_tree(arch, dtype, seed=0):
    return jinit(jax.random.PRNGKey(seed), jconfigs.get_reduced(arch), dtype)


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _at(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


@pytest.mark.parametrize("shape,axis,dtype", [
    ((64, 32), -1, np.float32),
    ((64, 32), 0, np.float32),
    ((5, 7, 48), -1, np.float32),
    ((512, 96), -1, "bfloat16"),
])
def test_quantize_tensor_equal(shape, axis, dtype):
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32) * 3
    jw = jnp.asarray(w, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tw = torch.from_numpy(_np(jw)).to(torch.bfloat16 if dtype == "bfloat16"
                                      else torch.float32)
    jq, js = JQ.quantize_tensor(jw, axis=axis)
    tq, ts = TQ.quantize_tensor(tw, axis=axis)
    _equal(jq, tq)
    _equal(js, ts)


def test_quantize_ties_round_half_to_even():
    """Values exactly halfway between two int8 steps round to the even
    one in both (scale 1: the column's largest magnitude is 127)."""
    w = np.array([[0.5, 1.5, 2.5, -0.5, -3.5, 126.5, 127.0]],
                 np.float32).T
    jq, js = JQ.quantize_tensor(jnp.asarray(w), axis=-1)
    tq, ts = TQ.quantize_tensor(torch.from_numpy(w), axis=-1)
    _equal(jq, tq)
    _equal(js, ts)
    assert tq[:, 0].tolist() == [0, 2, 2, 0, -4, 126, 127]


@pytest.mark.parametrize("shape", [(3, 64, 32), (2, 4, 8, 48)])
def test_quantize_leaf_equal(shape):
    w = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    jq, js = JQ.quantize_leaf("wq", jnp.asarray(w))
    tq, ts = TQ.quantize_leaf("wq", torch.from_numpy(w))
    assert ts.shape == (shape[0],) + (1,) * (len(shape) - 2) + (shape[-1],)
    _equal(jq, tq)
    _equal(js, ts)


@pytest.mark.parametrize("arch,dtype", [
    ("qwen2-7b", jnp.float32), ("qwen2-7b", jnp.bfloat16),
    ("qwen3-14b", jnp.float32), ("mamba2-2.7b", jnp.float32)])
def test_quantize_params_equal(arch, dtype):
    jp = _jax_tree(arch, dtype)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tp = params_to_torch(jax.tree_util.tree_map(_np, jp), "cpu", tdt)
    jq = JQ.quantize_params(jp)
    tq = TQ.quantize_params(tp)
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda a: 0, jq)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0, tq))
    for path, leaf in _leaves(jq):
        t = _at(tq, path)
        if path[-1].key[-2:] in ("_q", "_s"):
            _equal(leaf, t)
        else:                                   # untouched leaves
            np.testing.assert_array_equal(_np(leaf), t.float().numpy())


def test_params_to_torch_carries_a_quantized_tree():
    """A quantized JAX tree crosses with its int8 values and float32
    scales unchanged (dtype and value), the other leaves as before."""
    jq = JQ.quantize_params(_jax_tree("qwen2-7b", jnp.float32))
    tq = params_to_torch(jax.tree_util.tree_map(np.asarray, jq), "cpu",
                         torch.bfloat16)
    n_q = 0
    for path, leaf in _leaves(jq):
        t = _at(tq, path)
        key = path[-1].key
        if key.endswith("_q"):
            n_q += 1
            assert t.dtype == torch.int8
            np.testing.assert_array_equal(np.asarray(leaf), t.numpy())
        elif key.endswith("_s"):
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(np.asarray(leaf), t.numpy())
        else:
            assert t.dtype == torch.bfloat16
    assert n_q == 9                    # 7 layer matrices, embed, lm_head


@pytest.mark.parametrize("shape,dtype", [((2, 3, 16), jnp.float32),
                                         ((8, 4, 128), jnp.float32),
                                         ((8, 4, 128), jnp.bfloat16)])
def test_quantize_kv_and_dequantize_equal(shape, dtype):
    k = np.random.default_rng(2).standard_normal(shape).astype(np.float32) * 5
    jk = jnp.asarray(k, dtype)
    tk = torch.from_numpy(_np(jk)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    jq, js = JQ.quantize_kv(jk)
    tq, ts = TQ.quantize_kv(tk)
    _equal(jq, tq)
    _equal(js, ts)
    _equal(JQ.dequantize_kv(jq, js), TQ.dequantize_kv(tq, ts))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_qmatmul_matches_reference(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    w = rng.standard_normal((64, 96)).astype(np.float32) * 2
    jq, js = JQ.quantize_tensor(jnp.asarray(w), axis=-1)
    tq, ts = TQ.quantize_tensor(torch.from_numpy(w), axis=-1)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(_np(jx)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    jy, ty = _np(JQ.qmatmul(jx, jq, js)), TQ.qmatmul(tx, tq, ts)
    assert ty.dtype == tx.dtype
    err = np.abs(jy - ty.float().numpy()).max()
    assert err <= BF16_TOL * np.abs(jy).max(), err


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen3-14b"])
def test_qlayerview_slices_match(arch):
    jq = JQ.quantize_params(_jax_tree(arch, jnp.float32, seed=1))
    tq = params_to_torch(jax.tree_util.tree_map(np.asarray, jq), "cpu")
    names = [k for k in jq["layers"] if not k.endswith("_s")]
    for li in range(jconfigs.get_reduced(arch).n_layers):
        jv = JQ.QLayerView(jq["layers"], li)
        tv = TQ.QLayerView(tq["layers"], li)
        for k in names:
            k = k[:-2] if k.endswith("_q") else k
            assert k in tv
            a, b = _np(jv[k]), tv[k]
            assert b.shape == a.shape and b.shape[0] == 1
            if k in JQ._QUANT_LEAVES:
                assert b.dtype == torch.bfloat16
                assert tv[k] is b              # dequantized once per view
                err = np.abs(a - b.float().numpy()).max()
                assert err <= BF16_TOL * np.abs(a).max(), (k, err)
            else:
                np.testing.assert_array_equal(a, b.numpy())


def test_configs_copy_matches_reference():
    for name in ("qwen2-7b", "qwen3-14b"):
        assert asdict(tconfigs.get(name)) == asdict(jconfigs.get(name))
        assert asdict(tconfigs.get_reduced(name)) == \
            asdict(jconfigs.get_reduced(name))


# ---------------------------------------------------------------------------
# the tests of tests/test_quantize.py that hold no serve step, on the port
# ---------------------------------------------------------------------------
def test_quantize_tensor_roundtrip():
    w = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 32)).astype(np.float32)) * 3.0
    q, s = TQ.quantize_tensor(w, axis=-1)
    assert q.dtype == torch.int8
    back = q.float() * s
    rel = float((back - w).abs().max() / w.abs().max())
    assert rel < 0.01, rel


def test_qmatmul_matches_dequant():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32)) * 2
    q, s = TQ.quantize_tensor(w, axis=-1)
    y1 = TQ.qmatmul(x, q, s)
    y2 = x @ (q.float() * s)
    # the GEMM runs in bf16: bound the error relative to the output
    rel = float((y1 - y2).abs().max() / y2.abs().max())
    assert rel < 0.05, rel


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 1000))
def test_kv_quant_roundtrip(seed):
    k = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (2, 3, 16)).astype(np.float32)) * 5
    q, s = TQ.quantize_kv(k)
    back = TQ.dequantize_kv(q, s)
    assert float((back - k).abs().max()) < float(k.abs().max()) * 0.02


def test_quantize_params_structure():
    cfg = tconfigs.get_reduced("qwen2-7b")
    from repro_torch.models.transformer import init_params
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    qp = TQ.quantize_params(params)
    assert "wq_q" in qp["layers"] and "wq_s" in qp["layers"]
    assert qp["layers"]["wq_q"].dtype == torch.int8
    assert qp["layers"]["ln1"] is params["layers"]["ln1"]   # norms untouched
    assert "embed_q" in qp["tok"]
    # QLayerView dequantizes per layer
    w = TQ.QLayerView(qp["layers"], 0)["wq"]
    assert w.shape == (1,) + params["layers"]["wq"].shape[1:]
    err = float((w[0].float() - params["layers"]["wq"][0]).abs().max())
    assert err < float(params["layers"]["wq"][0].abs().max()) * 0.02
