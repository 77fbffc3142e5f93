"""The port's Mamba2 SSD scan and mixer against the JAX package's, on the
CPU.

Inputs are drawn with numpy from a seed and fed to both packages; the
JAX weights are carried across with ``params_to_torch``.  On CPU
tensors the port's ``ssd_chunked`` runs its plain version
(``kernels/ssd_scan.ssd_plain``); the CUDA kernel is held to it on the
card (``tests/test_torch_cuda.py``).  Tolerance 1e-4 in float32, as the
JAX package's own SSD tests: the two sum in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels.ssd_scan import ssd_scan as j_ssd_scan
from repro.models import mamba2 as JM
from repro.models.transformer import init_params as jinit
from repro_torch import configs as tconfigs
from repro_torch.models import mamba2 as TM
from repro_torch.models.transformer import init_params, params_to_torch

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, b, s, h, p, g, n, init=False, masked=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.1
          ).astype(np.float32)
    if masked:                      # padded tails, as a length mask gives
        dt[:, s - s // 3:] = 0.0
    a_log = np.log(np.linspace(1.0, 4.0, h)).astype(np.float32)
    B = rng.standard_normal((b, s, g, n)).astype(np.float32)
    C = rng.standard_normal((b, s, g, n)).astype(np.float32)
    d_skip = rng.uniform(0.5, 1.5, h).astype(np.float32)
    st = (rng.standard_normal((b, h, p, n)).astype(np.float32)
          if init else None)
    return x, dt, a_log, B, C, d_skip, st


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,init,masked", [
    (1, 128, 4, 64, 1, 32, 32, False, False),
    (2, 64, 4, 32, 2, 16, 16, True, False),       # groups, carried state
    (2, 96, 2, 64, 1, 16, 32, True, True),        # dt masked to 0
    (1, 64, 8, 64, 2, 64, 64, False, True),
])
def test_plain_ssd_matches_jax_ssd_chunked(b, s, h, p, g, n, chunk, init,
                                           masked):
    arrs = _inputs(0, b, s, h, p, g, n, init, masked)
    x, dt, a_log, B, C, d_skip, st = arrs
    y_j, f_j = JM.ssd_chunked(
        jnp.asarray(x), jnp.asarray(dt), jnp.asarray(a_log), jnp.asarray(B),
        jnp.asarray(C), jnp.asarray(d_skip), chunk,
        init_state=None if st is None else jnp.asarray(st))
    tx, tdt, ta, tB, tC, td, tst = _torch(*arrs)
    y_t, f_t = TM.ssd_chunked(tx, tdt, ta, tB, tC, td, chunk, init_state=tst)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), **TOL)


@pytest.mark.parametrize("b,s,h,n,chunk", [(1, 128, 4, 32, 32),
                                           (2, 64, 8, 64, 64)])
def test_plain_ssd_matches_pallas_ssd_scan(b, s, h, n, chunk):
    """The TPU kernel itself (Pallas, interpret mode), G = 1."""
    arrs = _inputs(1, b, s, h, 64, 1, n)
    x, dt, a_log, B, C, d_skip, _ = arrs
    y_j, f_j = j_ssd_scan(jnp.asarray(x), jnp.asarray(dt),
                          jnp.asarray(a_log), jnp.asarray(B), jnp.asarray(C),
                          jnp.asarray(d_skip), chunk=chunk, interpret=True)
    tx, tdt, ta, tB, tC, td, _ = _torch(*arrs)
    y_t, f_t = TM.ssd_chunked(tx, tdt, ta, tB, tC, td, chunk)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), **TOL)


@pytest.mark.parametrize("s,chunk", [(40, 32), (300, 256), (17, 16)])
def test_ragged_sequence_is_padded_exactly(s, chunk):
    """S > chunk not a multiple of it: the JAX package asserts; the port
    pads with dt = 0 and matches the JAX scan run at chunk = S."""
    arrs = _inputs(2, 2, s, 4, 64, 2, 16, init=True)
    x, dt, a_log, B, C, d_skip, st = arrs
    y_j, f_j = JM.ssd_chunked(*(jnp.asarray(a) for a in arrs[:6]), s,
                              init_state=jnp.asarray(st))
    y_t, f_t = TM.ssd_chunked(*_torch(*arrs[:6]), chunk,
                              init_state=torch.from_numpy(st))
    assert y_t.shape == (2, s, 4, 64)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), **TOL)


def _mamba_params(arch="mamba2-2.7b"):
    cfg = jconfigs.get_reduced(arch)
    jp = jinit(jax.random.PRNGKey(3), cfg, jnp.float32)
    tp = params_to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return cfg, tconfigs.get_reduced(arch), jp["layers"], tp["layers"]


@pytest.mark.parametrize("s,carry", [(24, False), (32, True), (64, True)])
def test_mixer_matches_jax(s, carry):
    """``mamba2_mixer`` with a length mask, and (carry) the conv tail and
    SSM state of an earlier chunk, on reduced mamba2 (chunk 32)."""
    jcfg, tcfg, jl, tl = _mamba_params()
    rng = np.random.default_rng(4)
    b, d = 2, jcfg.d_model
    sc = jcfg.ssm
    conv_dim = jcfg.d_inner + 2 * sc.n_groups * sc.d_state
    x = (rng.standard_normal((b, s, d)) * 0.5).astype(np.float32)
    mask = np.arange(s)[None, :] < np.array([[s], [s - 5]])
    tail = st = None
    if carry:
        tail = rng.standard_normal((b, sc.conv_kernel - 1, conv_dim)
                                   ).astype(np.float32)
        st = (rng.standard_normal((b, jcfg.n_ssm_heads, sc.head_dim,
                                   sc.d_state)) * 0.1).astype(np.float32)
    for li in range(jcfg.n_layers):
        oj, fj, tj = JM.mamba2_mixer(
            jnp.asarray(x), jl, li, jcfg,
            conv_tail=None if tail is None else jnp.asarray(tail),
            ssm_state=None if st is None else jnp.asarray(st),
            return_cache=True, length_mask=jnp.asarray(mask))
        ot, ft, tt = TM.mamba2_mixer(
            torch.from_numpy(x), tl, li, tcfg,
            conv_tail=None if tail is None else torch.from_numpy(tail),
            ssm_state=None if st is None else torch.from_numpy(st),
            return_cache=True, length_mask=torch.from_numpy(mask))
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), **TOL)
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), **TOL)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_decode_step_matches_jax(arch):
    """``mamba2_decode_step`` from a carried tail and state, three
    steps, each feeding the next."""
    jcfg, tcfg, jl, tl = _mamba_params(arch)
    rng = np.random.default_rng(5)
    b, sc = 3, jcfg.ssm
    conv_dim = jcfg.d_inner + 2 * sc.n_groups * sc.d_state
    tail = rng.standard_normal((b, sc.conv_kernel - 1, conv_dim)
                               ).astype(np.float32)
    st = (rng.standard_normal((b, jcfg.n_ssm_heads, sc.head_dim, sc.d_state))
          * 0.1).astype(np.float32)
    jt, js = jnp.asarray(tail), jnp.asarray(st)
    tt, ts = torch.from_numpy(tail), torch.from_numpy(st)
    for step in range(3):
        x = (rng.standard_normal((b, jcfg.d_model)) * 0.5).astype(np.float32)
        oj, jt, js = JM.mamba2_decode_step(jnp.asarray(x), jl, step % 2,
                                           jcfg, jt, js)
        ot, tt, ts = TM.mamba2_decode_step(torch.from_numpy(x), tl, step % 2,
                                           tcfg, tt, ts)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_trees_match_jax_and_keep_float32_leaves(arch):
    """Same keys and shapes as the JAX tree; a bf16 tree (random or
    carried across) keeps ``a_log``, ``dt_bias`` and ``d_skip`` in
    float32, as the JAX package's ``init_mamba2`` does."""
    jcfg = jconfigs.get_reduced(arch)
    jp = jax.tree_util.tree_map(np.asarray,
                                jinit(jax.random.PRNGKey(0), jcfg))
    ours = init_params(tconfigs.get_reduced(arch),
                       torch.Generator().manual_seed(0), torch.bfloat16,
                       "cpu")
    carried = params_to_torch(jp, "cpu", torch.bfloat16)
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    for tree in (ours, carried):
        flat_t = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
        assert {str(k) for k in flat_t} == {str(k) for k in flat_j}
        for k, leaf in flat_t.items():
            name = k[-1].key
            assert tuple(leaf.shape) == flat_j[k].shape, name
            want = (torch.float32 if name in TM.FLOAT32_LEAVES
                    else torch.bfloat16)
            assert leaf.dtype == want, name
    if arch == "zamba2-1.2b":
        assert ours["shared_attn"]["wq"].shape[0] == 1
