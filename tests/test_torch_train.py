"""The port's training substrate (``repro_torch.train``: optimizer,
data, checkpoint, eval step; ``launch/train.py``;
``core/costmodel.train_step_bytes``) against the JAX package's, on the
CPU, and the reference's ``tests/test_train.py`` properties in the port.

Exact where the arithmetic is the same: ``synth_batch`` (numpy in both)
bit for bit, checkpoint manifests and ``train_step_bytes`` with ``==``.
Float32 arithmetic in both packages: ``cosine_lr`` within 1e-6
relative (``cos`` of another library), the clip, AdamW's update and
moments on one random tree within 1e-6 of each leaf's largest element,
the eval loss within 1e-5 relative.  The train step itself is held in
``tests/test_torch_train_step.py``.
"""
import io
import json
import os
import re
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import costmodel as JC
from repro.models.transformer import init_params as jinit
from repro.train import checkpoint as jckpt
from repro.train import data as JD
from repro.train import optimizer as JO
from repro.train.train_step import make_eval_step as jmake_eval
from repro_torch import configs as tconfigs
from repro_torch.core import costmodel as TC
from repro_torch.launch import train as tcli
from repro_torch.models.transformer import init_params, params_to_torch
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import data as TD
from repro_torch.train import optimizer as TO
from repro_torch.train.pytree import flatten_with_path, leaves, path_str
from repro_torch.train.train_step import make_eval_step, make_train_step

from conftest import ALL_ARCHS

torch.set_num_threads(2)


def _jparams(arch, seed=0):
    cfg = jconfigs.get_reduced(arch)
    jp = jinit(jax.random.PRNGKey(seed), cfg, jnp.float32)
    return cfg, jp, params_to_torch(jax.tree_util.tree_map(np.asarray, jp),
                                    "cpu")


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(lr=1e-3, warmup_steps=10, total_steps=110, min_lr_frac=0.1),
    dict(lr=3e-3, warmup_steps=2, total_steps=60),
    dict(lr=5e-4, warmup_steps=0, total_steps=7, min_lr_frac=0.0),
])
def test_cosine_lr_matches_reference(kw):
    jc, tc = JO.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    for step in list(range(0, kw["total_steps"] + 3)):
        ref = float(JO.cosine_lr(jc, jnp.int32(step)))
        got = float(TO.cosine_lr(tc, torch.tensor(step, dtype=torch.int32)))
        assert abs(got - ref) <= 1e-6 * abs(ref), (step, got, ref)


def test_cosine_schedule():
    cfg = TO.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=110,
                         min_lr_frac=0.1)
    assert float(TO.cosine_lr(cfg, 0)) == 0.0
    assert np.isclose(float(TO.cosine_lr(cfg, 10)), 1e-3)
    assert 1e-4 < float(TO.cosine_lr(cfg, 60)) < 1e-3
    assert np.isclose(float(TO.cosine_lr(cfg, 110)), 1e-4, rtol=1e-2)


def test_grad_clip_matches_reference():
    rng = np.random.default_rng(0)
    g = {"a": rng.standard_normal(10).astype(np.float32) * 3,
         "b": {"c": rng.standard_normal((4, 5)).astype(np.float32)}}
    for max_norm in (1.0, 100.0):
        jcl, jn = JO.clip_by_global_norm(jax.tree_util.tree_map(
            jnp.asarray, g), max_norm)
        tcl, tn = TO.clip_by_global_norm(jax.tree_util.tree_map(
            torch.from_numpy, g), max_norm)
        assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
        for a, b in zip(jax.tree_util.tree_leaves(jcl), leaves(tcl)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
    # the reference test's numbers
    g = {"a": torch.full((10,), 3.0), "b": torch.full((10,), 4.0)}
    clipped, norm = TO.clip_by_global_norm(g, 1.0)
    assert np.isclose(float(norm), np.sqrt(90 + 160))
    assert np.isclose(float(TO.global_norm(clipped)), 1.0, rtol=1e-5)
    c2, _ = TO.clip_by_global_norm(g, 100.0)
    assert torch.equal(c2["a"], g["a"])


def test_decay_mask_matches_reference():
    """The rule goes by key name, verbatim: on reduced zamba2 it decays
    the matrices (``conv_b`` too, ``[L, ·]``) and spares the norms,
    ``a_log``, ``d_skip`` and ``dt_bias``; on reduced qwen2-7b it decays
    ``bq``/``bk``/``bv`` (``[L, ·]``, no "bias" in the name), as the
    reference does."""
    got = {}
    for arch in ("zamba2-1.2b", "qwen2-7b", "granite-moe-3b-a800m"):
        _, jp, tp = _jparams(arch)
        flat = jax.tree_util.tree_flatten_with_path(jp)[0]
        ref = {path_str(tuple(str(k.key) for k in path)):
               JO._decay_mask(path, leaf) for path, leaf in flat}
        mine = {path_str(path): TO._decay_mask(path, leaf)
                for path, leaf in flatten_with_path(tp)}
        assert mine == ref, arch
        got[arch] = {p.split("/")[-1] for p, d in mine.items() if d}
    assert got["zamba2-1.2b"] == {
        "conv_b", "conv_w", "embed", "in_proj", "lm_head", "out_proj",
        "w_down", "w_gate", "w_up", "wk", "wo", "wq", "wv"}
    assert {"bq", "bk", "bv"} <= got["qwen2-7b"]
    assert "router" in got["granite-moe-3b-a800m"]


def test_adamw_decay_mask():
    """Norm/bias/scalar leaves get no weight decay: with zero grads,
    matrices shrink, norms stay."""
    params = {"w_gate": torch.ones((4, 4)), "ln1": torch.ones((4,))}
    state = TO.init_state(params)
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    cfg = TO.AdamWConfig(lr=1e-2, weight_decay=0.5, warmup_steps=0,
                         total_steps=10)
    p2, _, _ = TO.apply_updates(params, grads, state, cfg)
    assert p2["w_gate"] is params["w_gate"]            # in place
    assert float(p2["w_gate"].mean()) < 1.0
    assert float((p2["ln1"] - 1.0).abs().max()) == 0.0


def test_apply_updates_matches_reference():
    """Three AdamW steps on one random tree (matrices, norms, a clip
    that binds): parameters and moments within 1e-6 of each leaf's
    largest element, the step counter, lr and grad_norm."""
    rng = np.random.default_rng(1)
    shapes = {"w_up": (6, 5), "gnorm": (2, 5), "b": {"bias": (3, 4)},
              "ln1": (5,)}

    def tree(scale):
        return jax.tree_util.tree_map(
            lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
            shapes, is_leaf=lambda x: isinstance(x, tuple))
    p = tree(1.0)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = jax.tree_util.tree_map(torch.from_numpy, p)
    js, ts = JO.init_state(jp), TO.init_state(tp)
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=5, grad_clip=0.5)
    for _ in range(3):
        g = tree(2.0)
        jp, js, ji = JO.apply_updates(jp, jax.tree_util.tree_map(
            jnp.asarray, g), js, JO.AdamWConfig(**cfg))
        tp, ts, ti = TO.apply_updates(tp, jax.tree_util.tree_map(
            torch.from_numpy, g), ts, TO.AdamWConfig(**cfg))
        assert int(ts.step) == int(js.step)
        for key in ("lr", "grad_norm"):
            assert abs(float(ti[key]) - float(ji[key])) <= \
                1e-6 * abs(float(ji[key]))
        for jt, tt in ((jp, tp), (js.m, ts.m), (js.v, ts.v)):
            for a, b in zip(jax.tree_util.tree_leaves(jt), leaves(tt)):
                a = np.asarray(a)
                assert np.abs(b.numpy() - a).max() <= \
                    1e-6 * np.abs(a).max()


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(vocab_size=64, seq_len=32, global_batch=4, seed=7),
    dict(vocab_size=512, seq_len=17, global_batch=3, seed=1, n_patterns=2),
    dict(vocab_size=512, seq_len=16, global_batch=2, seed=0,
         frontend_dim=16, n_prefix_tokens=4),
])
def test_synth_batch_equals_reference(kw):
    jd, td = JD.DataConfig(**kw), TD.DataConfig(**kw)
    for step in (0, 3, 11):
        for a, b in zip(JD.synth_batch(jd, step), TD.synth_batch(td, step)):
            if a is None:
                assert b is None
            else:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    ji, ti = JD.iterate(jd, 5), TD.iterate(td, 5)
    for _ in range(2):
        np.testing.assert_array_equal(next(ji)[0], next(ti)[0])


def test_data_deterministic_and_learnable():
    cfg = TD.DataConfig(vocab_size=64, seq_len=32, global_batch=4, seed=7)
    t1, l1, _ = TD.synth_batch(cfg, 3)
    t2, _, _ = TD.synth_batch(cfg, 3)
    np.testing.assert_array_equal(t1, t2)
    assert not np.array_equal(t1, TD.synth_batch(cfg, 4)[0])
    assert (l1[:, -1] == -100).all()
    assert (l1[:, :-1] == t1[:, 1:]).mean() > 0.99


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2-7b", "granite-moe-3b-a800m",
                                  "mamba2-2.7b", "zamba2-1.2b",
                                  "musicgen-medium"])
def test_loss_decreases(arch):
    """~40 steps on the reduced config cut the loss from step 0 (the data
    has learnable Markov structure): the reference test, in the port."""
    cfg = tconfigs.get_reduced(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    opt = TO.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60,
                         grad_clip=1.0)
    state = TO.init_state(params)
    dcfg = TD.DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                         global_batch=8, seed=1, n_patterns=2,
                         frontend_dim=cfg.frontend_dim,
                         n_prefix_tokens=cfg.n_prefix_tokens)
    step = make_train_step(cfg, opt, remat=False)
    losses = []
    for i in range(40):
        toks, labels, prefix = TD.synth_batch(dcfg, i)
        args = [params, state, torch.from_numpy(toks).long(),
                torch.from_numpy(labels)]
        if prefix is not None:
            args.append(torch.from_numpy(prefix))
        params, state, m = step(*args)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < losses[0] - 0.5, \
        f"{arch}: {losses[0]:.3f} → {np.mean(losses[-5:]):.3f}"


@pytest.mark.parametrize("arch", ["qwen3-14b", "phi-3-vision-4.2b"])
def test_eval_step_matches_reference(arch):
    cfg, jp, tp = _jparams(arch)
    dcfg = TD.DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                         global_batch=2, seed=0,
                         frontend_dim=cfg.frontend_dim,
                         n_prefix_tokens=cfg.n_prefix_tokens)
    t, l, pre = TD.synth_batch(dcfg, 0)
    ref = float(jax.jit(jmake_eval(cfg))(
        jp, jnp.asarray(t), jnp.asarray(l),
        None if pre is None else jnp.asarray(pre))["loss"])
    got = make_eval_step(tconfigs.get_reduced(arch))(
        tp, torch.from_numpy(t).long(), torch.from_numpy(l),
        None if pre is None else torch.from_numpy(pre))["loss"]
    assert not got.requires_grad
    assert abs(float(got) - ref) <= 1e-5 * abs(ref)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def test_checkpoint_round_trips_between_packages(tmp_path):
    """A checkpoint either package writes restores in the other, leaf
    for leaf, and the two packages write equal manifests: JAX's leaf
    order and key paths (``o`` before ``p``, ``o/.step``,
    ``o/.m/layers/a_log``, ...)."""
    cfg, jp, tp = _jparams("zamba2-1.2b")
    jtree = {"p": jp, "o": JO.init_state(jp)}
    jtree["o"] = jtree["o"]._replace(step=jnp.int32(7))
    ttree = {"p": tp, "o": TO.init_state(tp)._replace(
        step=torch.tensor(7, dtype=torch.int32))}
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    os.makedirs(jdir)
    jpath = jckpt.save(jdir, jtree, step=7, extra={"note": "hi"})
    tpath = tckpt.save(tdir, ttree, step=7, extra={"note": "hi"})
    jm, tm = _manifest(jpath), _manifest(tpath)
    assert tm == jm
    paths = [e["path"] for e in tm["leaves"]]
    assert len(paths) == 64 and paths[0] == "o/.step"
    assert "o/.m/layers/a_log" in paths and paths[-1].startswith("p/")
    for a, b in zip(sorted(os.listdir(jpath)), sorted(os.listdir(tpath))):
        assert a == b
        if a.endswith(".npy"):
            np.testing.assert_array_equal(np.load(os.path.join(jpath, a)),
                                          np.load(os.path.join(tpath, a)))
    # JAX's checkpoint into the port's tree (other values first) ...
    _, _, other = _jparams("zamba2-1.2b", seed=9)
    like = {"p": other, "o": TO.init_state(other)}
    restored, step, extra = tckpt.restore(jdir, like)
    assert step == 7 and extra == {"note": "hi"}
    assert int(restored["o"].step) == 7
    assert isinstance(restored["o"], TO.AdamWState)
    for a, b in zip(jax.tree_util.tree_leaves(jtree), leaves(restored)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # ... and the port's into JAX's
    jlike = {"p": jinit(jax.random.PRNGKey(9), cfg, jnp.float32),
             "o": JO.init_state(jp)}
    jrest, step, _ = jckpt.restore(tdir, jlike)
    assert step == 7
    for a, b in zip(jax.tree_util.tree_leaves(jrest), leaves(ttree)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert tckpt.latest_step(tdir) == 7 and tckpt.latest_step(
        str(tmp_path / "none")) is None


def test_checkpoint_resume_continues_training(tmp_path):
    """Save at step N, restore, keep training: the loss stays finite and
    the optimizer's step counter continues; a missing leaf raises."""
    cfg = tconfigs.get_reduced("qwen2-7b")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    opt = TO.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=30)
    state = TO.init_state(params)
    dcfg = TD.DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                         global_batch=4, seed=2)
    step_fn = make_train_step(cfg, opt, remat=False)

    def batch(i):
        t, l, _ = TD.synth_batch(dcfg, i)
        return torch.from_numpy(t).long(), torch.from_numpy(l)
    for i in range(3):
        params, state, _ = step_fn(params, state, *batch(i))
    tckpt.save(str(tmp_path), {"p": params, "o": state}, step=3)
    fresh = init_params(cfg, torch.Generator().manual_seed(5),
                        torch.float32, "cpu")
    restored, st, _ = tckpt.restore(str(tmp_path),
                                    {"p": fresh, "o": TO.init_state(fresh)})
    assert st == 3 and int(restored["o"].step) == 3
    for a, b in zip(leaves({"p": params, "o": state}), leaves(restored)):
        assert torch.equal(a, b)
    _, s2, m = step_fn(restored["p"], restored["o"], *batch(3))
    assert np.isfinite(float(m["loss"])) and int(s2.step) == 4
    with pytest.raises(KeyError, match="missing leaf"):
        tckpt.restore(str(tmp_path), {"p": fresh, "x": torch.zeros(1)})


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def _run(main, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue().splitlines()


def _shape(line):
    """A log line with its numbers (and the checkpoint's directory)
    blanked: what both CLIs must print alike."""
    line = re.sub(r"→ .*step_", "→ <dir>/step_", line)
    return re.sub(r"-?\d+(\.\d+)?(e[-+]\d+)?", "#", line)


def test_train_cli_on_the_cpu_resumes_from_its_checkpoint(tmp_path,
                                                          monkeypatch):
    """``launch/train.py --device cpu`` trains, checkpoints, and a second
    run resumes from the last checkpoint; its log lines read as the JAX
    CLI's."""
    ck = str(tmp_path / "ck")
    argv = ["--arch", "qwen2-7b", "--steps", "4", "--batch", "2", "--seq",
            "16", "--log-every", "1", "--ckpt-every", "2", "--ckpt", ck]
    first = _run(tcli.main, argv + ["--device", "cpu"])
    assert first[0].startswith("[train] qwen2-7b-reduced: ")
    assert sum("checkpoint →" in ln for ln in first) == 2
    assert tckpt.latest_step(ck) == 4
    again = _run(tcli.main, argv[:3] + ["6"] + argv[4:] + ["--device", "cpu"])
    assert again[0] == "[train] resumed from step 4"
    assert [ln.split()[2] for ln in again if "loss=" in ln] == ["5", "6"]

    from repro.launch import train as jcli
    jck = str(tmp_path / "jck")
    os.makedirs(jck)                  # the reference's save needs it
    monkeypatch.setattr(sys, "argv", ["train"] + argv[:-1] + [jck])
    ref = _run(lambda _: jcli.main(), None)
    assert [_shape(ln) for ln in first] == [_shape(ln) for ln in ref]


def test_train_cli_refuses_a_missing_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["--steps", "1"])


# ---------------------------------------------------------------------------
# the cost model's training bytes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_train_step_bytes_equals_reference(arch):
    for batch, seq, db in ((2, 1024, 4), (256, 4096, 2), (8, 64, 2)):
        assert TC.train_step_bytes(tconfigs.get(arch), batch, seq, db) == \
            JC.train_step_bytes(jconfigs.get(arch), batch, seq, db)
