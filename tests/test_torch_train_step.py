"""The port's train step (``repro_torch.train.train_step``) against the
JAX package's, on the CPU, on the five architectures of
``tests/test_train.py::test_loss_decreases``, from the same weights
(the reference's ``init_params``, carried across with
``params_to_torch``) and the same batches (``synth_batch``, equal in
both packages).

Each case runs five steps, plain, with ``remat`` and with two
microbatches.  Held:

* each step taken from the reference's state before it (parameters and
  moments carried across): its loss and ``grad_norm`` within 2e-5
  relative (the two sum in other orders), ``lr`` within 1e-6;
* the port's own five-step run: loss within 1e-4 relative, ``grad_norm``
  within 1e-3.  The runs drift apart by the sign flips described below:
  on reduced musicgen-medium the relative ``grad_norm`` difference went
  0, 2e-7, 1e-6, 9e-6, 1.5e-4 over the five steps (about ×10 a step),
  the loss's to 1.5e-5;
* after the first step, the moments ``m`` and ``v`` within 1e-4 of each
  leaf's largest reference element, and the parameters within 1e-6
  absolute where the gradient is well above its rounding (|g| at least
  1e-3 of the leaf's largest): AdamW's first step is about
  ``lr·sign(g)`` per element, so an element whose gradient is rounding
  noise can take the opposite sign in the two packages and differ by
  2·lr — a difference in the noise, not in the step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.transformer import init_params as jinit
from repro.train import optimizer as JO
from repro.train.data import DataConfig, synth_batch
from repro.train.train_step import make_train_step as jmake
from repro_torch import configs as tconfigs
from repro_torch.models.transformer import params_to_torch
from repro_torch.train import optimizer as TO
from repro_torch.train.pytree import leaves
from repro_torch.train.train_step import make_train_step as tmake

torch.set_num_threads(2)
ARCHS = ["qwen2-7b", "granite-moe-3b-a800m", "mamba2-2.7b", "zamba2-1.2b",
         "musicgen-medium"]
VARIANTS = {"plain": dict(remat=False, microbatches=1),
            "remat": dict(remat=True, microbatches=1),
            "microbatches 2": dict(remat=False, microbatches=2)}
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=60, grad_clip=1.0)
STEPS = 5


def _jargs(batch):
    return [jnp.asarray(a) for a in batch if a is not None]


def _targs(batch):
    toks, labels, prefix = batch
    out = [torch.from_numpy(toks).long(), torch.from_numpy(labels)]
    return out + ([] if prefix is None else [torch.from_numpy(prefix)])


def _to_torch(jp, js):
    """The reference's parameters and AdamW state as the port's."""
    def conv(tree):
        return params_to_torch(jax.tree_util.tree_map(np.asarray, tree),
                               "cpu")
    return conv(jp), TO.AdamWState(
        step=torch.tensor(int(js.step), dtype=torch.int32), m=conv(js.m),
        v=conv(js.v))


def _rel_close(got, ref, rtol, what):
    assert abs(got - ref) <= rtol * abs(ref), (what, got, ref)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch, variant):
    kw = VARIANTS[variant]
    cfg = jconfigs.get_reduced(arch)
    jp = jinit(jax.random.PRNGKey(0), cfg, jnp.float32)
    tp = params_to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4,
                      seed=1, n_patterns=2, frontend_dim=cfg.frontend_dim,
                      n_prefix_tokens=cfg.n_prefix_tokens)
    jstep = jax.jit(jmake(cfg, JO.AdamWConfig(**OPT), **kw))
    tstep = tmake(tconfigs.get_reduced(arch), TO.AdamWConfig(**OPT), **kw)
    js, ts = JO.init_state(jp), TO.init_state(tp)
    for i in range(STEPS):
        batch = synth_batch(dcfg, i)
        synced = tstep(*_to_torch(jp, js), *_targs(batch))[2]
        jp, js, jm = jstep(jp, js, *_jargs(batch))
        tp, ts, tm = tstep(tp, ts, *_targs(batch))
        for m, tol in ((synced, (2e-5, 2e-5)), (tm, (1e-4, 1e-3))):
            _rel_close(float(m["loss"]), float(jm["loss"]), tol[0],
                       ("loss", i))
            _rel_close(float(m["grad_norm"]), float(jm["grad_norm"]),
                       tol[1], ("grad_norm", i))
            _rel_close(float(m["lr"]), float(jm["lr"]), 1e-6, ("lr", i))
        assert int(ts.step) == int(js.step) == i + 1
        if i:
            continue
        jl = [np.asarray(a) for a in jax.tree_util.tree_leaves(jp)]
        # the reference's first moment is (1 - beta1) times the clipped
        # gradient this step used: it tells signal from rounding
        gl = [np.asarray(a) for a in jax.tree_util.tree_leaves(js.m)]
        for name, jt, tt in (("m", js.m, ts.m), ("v", js.v, ts.v)):
            for a, b in zip(jax.tree_util.tree_leaves(jt), leaves(tt)):
                a = np.asarray(a)
                scale = max(float(np.abs(a).max()), 1e-30)
                assert np.abs(b.numpy() - a).max() <= 1e-4 * scale, name
        for a, b, g in zip(jl, leaves(tp), gl):
            signal = np.abs(g) >= 1e-3 * np.abs(g).max()
            err = np.abs(b.numpy() - a)[signal]
            assert err.size == 0 or err.max() <= 1e-6, err.max()
