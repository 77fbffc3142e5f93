"""Gradients of the two kernels on the training path — kernel 3
``flash_prefill`` and kernel 4 ``ssd_scan`` — against ``jax.grad`` of
the JAX package's oracles (``repro.kernels.ref``: ``causal_attention``
and ``ssd_chunked``), on the CPU.

On CPU tensors the wrappers run their plain versions and autograd
differentiates them.  On CUDA tensors each wrapper is a
``torch.autograd.Function`` whose forward launches the kernel and whose
backward is the VJP of the plain version recomputed from the saved
inputs (``flash_prefill_vjp``, ``ssd_vjp``).  Those backward functions,
and the Functions' ``backward`` wiring (driven here with a stand-in for
the autograd context), run on the CPU too; the forward and the whole
node are held on the card (``tests/test_torch_cuda.py``).

Inputs are drawn with numpy from a seed.  Tolerance: every gradient
within 1e-4 of its largest reference element (float32; XLA and PyTorch
sum in other orders).
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_prefill as fp
from repro_torch.kernels import ssd_scan as ss

torch.set_num_threads(2)
REL = 1e-4


def _close(got, ref, what):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got.detach().numpy() - ref).max())
    assert err <= REL * scale, (what, err, scale)


def _attn_inputs(seed, b, s, h, kv, hd):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal(sh).astype(np.float32)
                  for sh in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd),
                             (b, s, h, hd)))
    return q, k, v, g


def _attn_jax_grads(q, k, v, g, window):
    def f(q, k, v):
        return jnp.sum(jref.flash_prefill_ref(q, k, v, window=window) * g)
    return jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))


ATTN_CASES = [  # b, s, h, kv, hd, window
    (2, 48, 4, 2, 64, None),
    (1, 64, 8, 1, 64, 16),
    (2, 40, 4, 4, 96, 24),
    (1, 33, 4, 2, 128, None),
]


@pytest.mark.parametrize("b,s,h,kv,hd,window", ATTN_CASES)
def test_flash_prefill_gradients_match_jax(b, s, h, kv, hd, window):
    q, k, v, g = _attn_inputs(0, b, s, h, kv, hd)
    jg = _attn_jax_grads(q, k, v, g, window)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fp.flash_prefill(*ts, window=window)
    tg = torch.autograd.grad(out, ts, torch.from_numpy(g))
    for name, a, r in zip("qkv", tg, jg):
        _close(a, r, name)


@pytest.mark.parametrize("b,s,h,kv,hd,window", ATTN_CASES)
def test_flash_prefill_backward_node_on_the_cpu(b, s, h, kv, hd, window):
    """The CUDA node's backward (``_FlashPrefill.backward`` and the
    ``flash_prefill_vjp`` it calls) on CPU tensors: the gradients of q,
    k, v equal JAX's, and the window gets none."""
    q, k, v, g = _attn_inputs(1, b, s, h, kv, hd)
    jg = _attn_jax_grads(q, k, v, g, window)
    ctx = SimpleNamespace(saved_tensors=tuple(torch.from_numpy(a)
                                              for a in (q, k, v)),
                          window=window)
    grads = fp._FlashPrefill.backward(ctx, torch.from_numpy(g))
    assert len(grads) == 4 and grads[3] is None
    for name, a, r in zip("qkv", grads[:3], jg):
        _close(a, r, name)


def _ssd_inputs(seed, b, s, h, p, g, n, init):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.1
          ).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 4.0, h)).astype(np.float32)
    B = rng.standard_normal((b, s, g, n)).astype(np.float32)
    C = rng.standard_normal((b, s, g, n)).astype(np.float32)
    d_skip = rng.uniform(0.5, 1.5, h).astype(np.float32)
    st = rng.standard_normal((b, h, p, n)).astype(np.float32) if init \
        else None
    gy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    gs = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return (x, dt, a_log, B, C, d_skip, st), gy, gs


NAMES = ("x", "dt", "a_log", "B", "C", "d_skip", "init_state")


def _ssd_jax_grads(ins, gy, gs, chunk):
    """jax.grad of ``<y, gy> + <final, gs>`` through the oracle
    ``ssd_chunked`` (with the carried state as its ``init_state``)."""
    from repro.models.mamba2 import ssd_chunked
    have = [i for i, a in enumerate(ins) if a is not None]

    def f(*args):
        full = list(ins)
        for i, a in zip(have, args):
            full[i] = a
        y, final = ssd_chunked(*full[:6], chunk, init_state=full[6])
        return jnp.sum(y * gy) + jnp.sum(final * gs)
    gr = jax.grad(f, argnums=tuple(range(len(have))))(
        *[jnp.asarray(ins[i]) for i in have])
    out = [None] * len(ins)
    for i, a in zip(have, gr):
        out[i] = a
    return out


SSD_CASES = [  # b, s, h, p, g, n, chunk, init
    (2, 64, 4, 64, 1, 16, 32, True),
    (1, 96, 4, 64, 2, 32, 32, True),
    (2, 64, 2, 64, 1, 64, 64, False),
]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,init", SSD_CASES)
def test_ssd_scan_gradients_match_jax(b, s, h, p, g, n, chunk, init):
    ins, gy, gs = _ssd_inputs(0, b, s, h, p, g, n, init)
    jg = _ssd_jax_grads(ins, gy, gs, chunk)
    ts = [None if a is None else torch.from_numpy(a).requires_grad_()
          for a in ins]
    y, final = ss.ssd_scan(*ts[:6], chunk, init_state=ts[6])
    wrt = [t for t in ts if t is not None]
    tg = iter(torch.autograd.grad((y, final), wrt, (torch.from_numpy(gy),
                                                    torch.from_numpy(gs))))
    for name, t, r in zip(NAMES, ts, jg):
        if t is not None:
            _close(next(tg), r, name)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,init", SSD_CASES)
def test_ssd_backward_node_on_the_cpu(b, s, h, p, g, n, chunk, init):
    """The CUDA node's backward (``_SsdScan.backward`` and ``ssd_vjp``)
    on CPU tensors: every input's gradient equals JAX's; the chunk and
    the launch plan get none; a final state nobody used (its cotangent
    None) contributes nothing."""
    ins, gy, gs = _ssd_inputs(1, b, s, h, p, g, n, init)
    ts = tuple(None if a is None else torch.from_numpy(a) for a in ins)
    ctx = SimpleNamespace(saved_tensors=ts, chunk=chunk)
    grads = ss._SsdScan.backward(ctx, torch.from_numpy(gy),
                                 torch.from_numpy(gs))
    assert len(grads) == 10 and grads[7:] == (None, None, None)
    for name, a, r in zip(NAMES, grads, _ssd_jax_grads(ins, gy, gs, chunk)):
        if r is None:
            assert a is None, name
        else:
            _close(a, r, name)
    only_y = ss._SsdScan.backward(ctx, torch.from_numpy(gy), None)
    ref = _ssd_jax_grads(ins, gy, np.zeros_like(gs), chunk)
    for name, a, r in zip(NAMES, only_y, ref):
        if r is not None:
            _close(a, r, name)
