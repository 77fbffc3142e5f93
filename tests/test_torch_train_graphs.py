"""The compiled train step (``repro_torch.train.graphs``) on the CPU,
through the capture stub of ``tests/test_torch_step_graphs.py``
(``RecordingCapture``: recording runs nothing, a replay runs the step
on the graph's static inputs, as a CUDA graph would).

* On the five architectures of ``tests/test_torch_train_step.py`` (the
  SSM and hybrid ones in ``tests/test_torch_train_graphs_ssm.py``), from
  the reference's ``init_params`` carried across with
  ``params_to_torch``, plain, with ``remat`` and with two microbatches,
  three steps each (one capture, two replays): each step, taken from
  the reference's state before it (copied into the compiled step's
  tensors in place, so the graph is replayed), equals the port's eager
  step bit for bit and holds to ``jax.jit(make_train_step(...))``'s
  within ``tests/test_torch_train_step.py``'s tolerances (loss and
  ``grad_norm`` 2e-5 relative, ``lr`` 1e-6).
* Run free, the compiled step's ``lr`` after k replays is
  ``cosine_lr(k + 1)`` and its trajectory the eager one's: the step
  counter advances in the graph's own buffer.
* Keys: a new tree or a new batch shape captures anew, a dead tree's
  graph (or a dead compiled step's) is dropped, ``disable_graphs()``
  captures nothing, a failed capture raises; kernel launch counts after
  replays equal the eager run's.

The CPU adds an embedding gradient's rows in parallel, in an order that
varies between runs once a batch has ~32k elements of them (reduced
musicgen-medium at 4 x 32): the file runs under
``torch.use_deterministic_algorithms(True)``, which sorts them.
"""
import functools
import gc

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
from repro_torch.kernels import flash_prefill as fp
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models.transformer import params_to_torch
from repro_torch.serving import graphs
from repro_torch.train import optimizer as TO
from repro_torch.train.graphs import METRICS, compile_train_step
from repro_torch.train.pytree import leaves
from repro_torch.train.train_step import make_train_step as tmake
from test_torch_step_graphs import stub  # noqa: F401
from test_torch_step_graphs_ssm import _FailingCapture
from test_torch_train_step import OPT, VARIANTS, _jargs, _targs

torch.set_num_threads(2)
STEPS = 3
# the architectures of tests/test_torch_train_step.py but the SSM and
# hybrid ones (tests/test_torch_train_graphs_ssm.py)
ARCHS = ["qwen2-7b", "granite-moe-3b-a800m", "musicgen-medium"]


@pytest.fixture(autouse=True)
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def _batches(arch, n=STEPS, batch=4, seq=32):
    cfg = jconfigs.get_reduced(arch)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, seed=1, n_patterns=2,
                      frontend_dim=cfg.frontend_dim,
                      n_prefix_tokens=cfg.n_prefix_tokens)
    return [synth_batch(dcfg, i) for i in range(n)]


@functools.lru_cache(maxsize=None)
def _jparams(arch, seed=0):
    return jinit(jax.random.PRNGKey(seed), jconfigs.get_reduced(arch),
                 jnp.float32)


def _tree(arch, seed=0):
    return params_to_torch(jax.tree_util.tree_map(
        np.asarray, _jparams(arch, seed)), "cpu")


def _load(tree, jtree):
    """Copy the reference's (params, AdamW state) into the port's
    tensors in place."""
    for t, a in zip(leaves(tree), jax.tree_util.tree_leaves(jtree)):
        t.copy_(torch.from_numpy(np.array(a)))


def _rel_close(got, ref, rtol, what):
    assert abs(got - ref) <= rtol * abs(ref), (what, got, ref)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def check_against_eager_and_reference(stub, arch, variant):
    """``STEPS`` compiled steps of ``arch``, each re-synced from the
    reference's state, against the eager step and the reference's."""
    kw = VARIANTS[variant]
    jcfg = jconfigs.get_reduced(arch)
    jp = _jparams(arch)
    js = JO.init_state(jp)
    jstep = jax.jit(jmake(jcfg, JO.AdamWConfig(**OPT), **kw))
    step = tmake(tconfigs.get_reduced(arch), TO.AdamWConfig(**OPT), **kw)
    compiled = compile_train_step(step)
    gp = _tree(arch)
    gs = TO.init_state(gp)
    ep = _tree(arch)
    es = TO.init_state(ep)
    replays = graphs.GRAPH_REPLAYS["train"]
    for i, batch in enumerate(_batches(arch)):
        _load((gp, gs), (jp, js))
        _load((ep, es), (jp, js))
        gp2, gs2, gm = compiled(gp, gs, *_targs(batch))
        _, _, em = step(ep, es, *_targs(batch))
        jp, js, jm = jstep(jp, js, *_jargs(batch))
        assert gp2 is gp and gs2 is gs
        assert all(torch.equal(gm[k], em[k]) for k in METRICS), (i, gm, em)
        assert _equal((gp, gs), (ep, es)), i
        for k, tol in (("loss", 2e-5), ("grad_norm", 2e-5), ("lr", 1e-6)):
            _rel_close(float(gm[k]), float(jm[k]), tol, (k, i))
        assert int(gs.step) == int(js.step) == i + 1
    assert len(stub.keys) == 1
    assert graphs.GRAPH_REPLAYS["train"] - replays == STEPS - 1


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_compiled_step_matches_eager_and_reference(stub, arch, variant):
    check_against_eager_and_reference(stub, arch, variant)


@pytest.mark.parametrize("variant", ["plain", "microbatches 2"])
def test_lr_after_k_replays_is_the_schedule(stub, variant):
    """Free-running, the replays read and advance the graph's own step
    counter: a counter the update replaced by a new tensor would leave
    every replay at step 1's ``lr`` and bias corrections."""
    arch, n = "qwen2-7b", 5
    opt = TO.AdamWConfig(**OPT)
    step = tmake(tconfigs.get_reduced(arch), opt, **VARIANTS[variant])
    compiled = compile_train_step(step)
    gp, ep = _tree(arch), _tree(arch)
    gs, es = TO.init_state(gp), TO.init_state(ep)
    for k, batch in enumerate(_batches(arch, n)):
        _, _, gm = compiled(gp, gs, *_targs(batch))
        _, _, em = step(ep, es, *_targs(batch))
        assert torch.equal(gm["lr"], TO.cosine_lr(opt, k + 1)), k
        assert int(gs.step) == k + 1
        assert all(torch.equal(gm[m], em[m]) for m in METRICS)
        assert _equal((gp, gs), (ep, es)), k
    assert len(stub.keys) == 1


def test_keys_follow_the_tree_and_the_batch_shape(stub):
    arch = "zamba2-1.2b"
    cfg = tconfigs.get_reduced(arch)
    compiled = compile_train_step(tmake(cfg, TO.AdamWConfig(**OPT),
                                        remat=False))
    pa = _tree(arch)
    sa = TO.init_state(pa)
    b32 = _batches(arch, 2)
    for b in b32:
        compiled(pa, sa, *_targs(b))
    assert len(stub.keys) == 1 and len(graphs.REGISTRY.graphs) == 1
    # a new batch shape: a new key beside the first
    compiled(pa, sa, *_targs(_batches(arch, 1, seq=16)[0]))
    assert len(stub.keys) == 2 and len(graphs.REGISTRY.graphs) == 2
    # another tree (as a restore from a checkpoint makes): captured anew
    pb = _tree(arch, seed=1)
    sb = TO.init_state(pb)
    compiled(pb, sb, *_targs(b32[0]))
    compiled(pb, sb, *_targs(b32[1]))
    assert len(stub.keys) == 3 and len(graphs.REGISTRY.graphs) == 3
    # the same tree with a new optimizer state replaces its graph
    sb2 = TO.init_state(pb)
    compiled(pb, sb2, *_targs(b32[0]))
    assert len(stub.keys) == 4 and len(graphs.REGISTRY.graphs) == 3
    # a dead tree's graphs go; so do a dead compiled step's
    del pb, sb, sb2
    gc.collect()
    assert len(graphs.REGISTRY.graphs) == 2
    del compiled
    gc.collect()
    assert not graphs.REGISTRY.graphs
    assert all(k[0][0] == "train" for k in stub.keys)


def test_disable_graphs_runs_the_eager_step(stub):
    arch = "mamba2-2.7b"
    step = tmake(tconfigs.get_reduced(arch), TO.AdamWConfig(**OPT))
    compiled = compile_train_step(step)
    gp, ep = _tree(arch), _tree(arch)
    gs, es = TO.init_state(gp), TO.init_state(ep)
    with graphs.disable_graphs():
        for batch in _batches(arch, 2):
            _, _, gm = compiled(gp, gs, *_targs(batch))
            _, _, em = step(ep, es, *_targs(batch))
            assert all(torch.equal(gm[m], em[m]) for m in METRICS)
    assert not stub.keys and not graphs.REGISTRY.graphs
    assert _equal((gp, gs), (ep, es))


def test_launch_counts_after_replays_equal_the_eager_run(stub, monkeypatch):
    """Each plain call of kernels 3 and 4 on the CPU counted as a launch
    of its kernel (a wrapper counts where Python calls it): a compiled
    run counts what an eager run of the same steps counts."""
    def counted(fn, kernel):
        def call(*a, **kw):
            kernel.launches += 1
            return fn(*a, **kw)
        return call
    monkeypatch.setattr(fp, "flash_prefill_plain",
                        counted(fp.flash_prefill_plain, fp.FLASH_KERNEL))
    monkeypatch.setattr(ss, "ssd_plain", counted(ss.ssd_plain, ss.SSD_KERNEL))
    arch = "zamba2-1.2b"
    step = tmake(tconfigs.get_reduced(arch), TO.AdamWConfig(**OPT),
                 remat=True)
    counts = {}
    for mode in ("eager", "graphs"):
        run = step if mode == "eager" else compile_train_step(step)
        p = _tree(arch)
        s = TO.init_state(p)
        ops.reset_launch_counts()
        for batch in _batches(arch, 4):
            run(p, s, *_targs(batch))
        counts[mode] = ops.launch_counts()
    assert counts["graphs"] == counts["eager"]
    assert counts["eager"]["repro_flash_prefill"] > 0
    assert counts["eager"]["repro_ssd_scan"] > 0
    assert graphs.GRAPH_REPLAYS["train"] and len(stub.keys) == 1


def test_a_failed_capture_raises():
    """The compiled step raises at every call whose capture fails: no
    quiet eager step, no graph kept."""
    saved = graphs.REGISTRY.capture
    graphs.REGISTRY.clear()
    graphs.REGISTRY.capture = _FailingCapture()
    try:
        arch = "qwen2-7b"
        compiled = compile_train_step(tmake(tconfigs.get_reduced(arch),
                                            TO.AdamWConfig(**OPT)))
        p = _tree(arch)
        s = TO.init_state(p)
        for batch in _batches(arch, 2):
            with pytest.raises(RuntimeError, match="capture failed"):
                compiled(p, s, *_targs(batch))
        assert not graphs.REGISTRY.graphs
    finally:
        graphs.REGISTRY.capture = saved
        graphs.REGISTRY.clear()


def test_apply_updates_advances_the_step_in_place():
    p = {"w_up": torch.ones((3, 2))}
    s = TO.init_state(p)
    counter = s.step
    g = {"w_up": torch.full((3, 2), 0.5)}
    for k in range(3):
        _, s2, info = TO.apply_updates(p, g, s, TO.AdamWConfig(
            warmup_steps=1, total_steps=4))
        assert s2.step is counter and int(counter) == k + 1
        assert torch.equal(info["lr"], TO.cosine_lr(TO.AdamWConfig(
            warmup_steps=1, total_steps=4), k + 1))
