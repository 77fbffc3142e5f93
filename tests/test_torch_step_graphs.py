"""The compiled serving steps (``serving/graphs.py``) on the CPU.

* The fixed-shape step bodies of ``fused_decode``, ``fused_prefill_chunk``,
  ``decode`` and ``chunk`` (reduced qwen2-7b, float32) against the port's
  eager steps as they were before the split (their code kept below, with
  the variable-length write plan) bit for bit — logits and every arena
  row — and against the JAX package's ``_fused_decode_impl`` /
  ``_fused_prefill_chunk_impl`` / ``_decode_impl`` /
  ``_prefill_chunk_impl``: the arena entries each package leaves
  untouched are the same and untouched bit for bit, logits and written
  entries agree within 2e-5 (float32 matmuls of two libraries differ in
  the last bits).  The cases cover padded rows with −1 tables, chunk
  positions past the table and a step that keeps no write.
* The registry's keys and invalidation, through a capture stub that
  records keys and replays by running the body on the static inputs
  into the static output: one program per bucket, a recapture after a
  reallocating ``grow``, after ``adopt_stacked`` and after
  ``migrate_view``, none after a ``grow`` into the slack, none in the
  ``fused_tick`` gate's measured waves, tokens equal to the eager run's.
* ``total_traces``, ``MuxStats.throughput_reqs`` and the
  ``FusedDecodeGroup`` alias against the reference's.
"""
import contextlib
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.transformer import init_params as jinit
from repro.serving import engine as JE
from repro.serving import mux as JM
from repro_torch import configs
from repro_torch.config import replace
from repro_torch.models.layers import (attn_qkv, embed_tokens, linear,
                                       lm_logits, rms_norm)
from repro_torch.models.moe import ffn
from repro_torch.models.transformer import params_to_torch
from repro_torch.serving import cache_ops, graphs
from repro_torch.serving import engine as TE
from repro_torch.serving import mux as TM
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.kvcache import UnifiedKVPool, migrate_view
from repro_torch.serving.mux import MuxScheduler

torch.set_num_threads(2)

ARCH = "qwen2-7b"
N_BLOCKS = 256           # arena head-blocks of the body tests (groups of 4)
W = 4                    # table width of the body tests (64 tokens a row)
TOL = 2e-5


# ---------------------------------------------------------------------------
# the port's steps before the split (variable-length write plan)
# ---------------------------------------------------------------------------
def _old_token_slots(table, start_pos, n_new, block_tokens):
    table = np.asarray(table, np.int64)
    start = np.asarray(start_pos, np.int64)
    Wt = table.shape[1]
    pos = start[:, None] + np.arange(n_new)[None, :]
    blk = pos // block_tokens
    base = np.take_along_axis(table, np.minimum(blk, Wt - 1), axis=1)
    src = np.nonzero(((blk < Wt) & (base >= 0)).reshape(-1))[0]
    return (torch.from_numpy(src), torch.from_numpy(base.reshape(-1)[src]),
            torch.from_numpy((pos % block_tokens).reshape(-1)[src]))


def _old_write(pool_k, pool_v, k_new, v_new, slots, layer, n_kv):
    src, base, off = slots
    hd = k_new.shape[-1]
    phys = base[:, None] + layer * n_kv + torch.arange(n_kv)[None, :]
    off = off[:, None].expand_as(phys)
    pool_k[phys, off] = k_new.reshape(-1, n_kv, hd)[src]
    pool_v[phys, off] = v_new.reshape(-1, n_kv, hd)[src]


def _old_fused_decode(params, toks, lens, pool, tables, cfg):
    M, R = toks.shape
    lp = params["layers"]
    n_h, n_kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pos = lens.astype(np.int64) - 1
    flat = tables.reshape(M * R, -1)
    slots = _old_token_slots(flat, pos.reshape(-1), 1, pool.block_tokens)
    flat_t = torch.from_numpy(flat.copy())
    flat_lens = torch.from_numpy(lens.reshape(-1).astype(np.int32))
    pos_t = torch.from_numpy(pos)[:, :, None]
    x = embed_tokens(params["tok"]["embed"],
                     torch.from_numpy(toks.astype(np.int64)))
    for li in range(cfg.n_layers):
        h = rms_norm(x, lp["ln1"][:, li], cfg.rms_eps)
        q, k, v = attn_qkv(h[:, :, None, :], lp, li, cfg, pos_t)
        _old_write(pool.k, pool.v, k.reshape(M * R, 1, n_kv, hd),
                   v.reshape(M * R, 1, n_kv, hd), slots, li, n_kv)
        phys = cache_ops.resolve_physical_blocks(flat_t, li, n_kv)
        o = cache_ops.fused_paged_decode_attention(
            q.reshape(M * R, n_h, hd).contiguous(), pool.k, pool.v, phys,
            flat_lens)
        x = x + linear(o.reshape(M, R, n_h * hd), lp["wo"][:, li])
        h = rms_norm(x, lp["ln2"][:, li], cfg.rms_eps)
        x = x + ffn(h, lp, li, cfg)
    return lm_logits(x, params["tok"], cfg)[..., :cfg.vocab_size]


def _old_fused_chunk(params, toks, offs, clens, pool, tables, cfg):
    M, R, C = toks.shape
    lp = params["layers"]
    n_h, n_kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    flat = tables.reshape(M * R, -1)
    slots = _old_token_slots(flat, offs.reshape(-1), C, pool.block_tokens)
    flat_t = torch.from_numpy(flat.copy())
    flat_offs = torch.from_numpy(offs.reshape(-1).astype(np.int32))
    positions = torch.from_numpy(offs[..., None].astype(np.int64)
                                 + np.arange(C)[None, None, :])
    x = embed_tokens(params["tok"]["embed"],
                     torch.from_numpy(toks.astype(np.int64)))
    for li in range(cfg.n_layers):
        h = rms_norm(x, lp["ln1"][:, li], cfg.rms_eps)
        q, k, v = attn_qkv(h, lp, li, cfg, positions)
        _old_write(pool.k, pool.v, k.reshape(M * R, C, n_kv, hd),
                   v.reshape(M * R, C, n_kv, hd), slots, li, n_kv)
        phys = cache_ops.resolve_physical_blocks(flat_t, li, n_kv)
        o = cache_ops.fused_paged_chunk_attention(
            q.reshape(M * R, C, n_h, hd).contiguous(), pool.k, pool.v, phys,
            flat_offs)
        x = x + linear(o.reshape(M, R, C, n_h * hd), lp["wo"][:, li])
        h = rms_norm(x, lp["ln2"][:, li], cfg.rms_eps)
        x = x + ffn(h, lp, li, cfg)
    idx = torch.from_numpy(np.maximum(clens - 1, 0).astype(np.int64))
    x_last = x.gather(2, idx[:, :, None, None].expand(M, R, 1, x.shape[-1]))
    return lm_logits(x_last[:, :, 0], params["tok"], cfg)[..., :cfg.vocab_size]


# ---------------------------------------------------------------------------
# the bodies against the old port steps and the JAX steps
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def weights():
    jcfg = jconfigs.get_reduced(ARCH)
    trees = [jax.tree_util.tree_map(np.asarray, jinit(
        jax.random.PRNGKey(i), jcfg, jnp.float32)) for i in range(2)]
    jstack = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *trees)
    ported = [params_to_torch(t, "cpu") for t in trees]
    tstack = TE.tree_map(lambda a: a, {
        g: {k: torch.stack([t[g][k] for t in ported]) for k in ported[0][g]}
        for g in ported[0]})
    return jcfg, jstack, tstack


def _inputs(case: str, M: int, R: int, C: int, seed: int):
    """Tables, tokens, lengths / offsets of one step.  ``padded``: the
    last row of the last model is a padded row (−1 table, length 1 /
    clen 0); ``past``: a row whose new tokens run past its table (decode
    at position W·16, chunks from W·16 − C/2); ``none``: every table −1,
    so the step keeps no write."""
    rng = np.random.default_rng(seed)
    cfg = configs.get_reduced(ARCH)
    gs = cfg.n_layers * cfg.n_kv_heads
    tables = (rng.permutation(N_BLOCKS // gs)[:M * R * W] * gs).reshape(
        M, R, W).astype(np.int32)
    toks = rng.integers(1, cfg.vocab_size, (M, R, C)).astype(np.int32)
    lens = rng.integers(1, 16 * W, (M, R)).astype(np.int32)
    offs = (rng.integers(0, (16 * W - C) // 16 + 1, (M, R)) * 16).astype(
        np.int32)
    clens = rng.integers(1, C + 1, (M, R)).astype(np.int32)
    if case == "padded":
        tables[-1, -1] = -1
        lens[-1, -1], clens[-1, -1], offs[-1, -1] = 1, 0, 0
        toks[-1, -1] = 0
        tables[0, 1, 2:] = -1                  # a partly filled table
        lens[0, 1] = 20
        offs[0, 1] = 16
    elif case == "past":
        lens[0, 0] = 16 * W + 1                 # position 16·W: past W
        offs[0, 0] = 16 * W - C // 2            # half the chunk past W
        clens[0, 0] = C
    elif case == "none":
        tables[:] = -1
    return tables, toks, lens, offs, clens


def _arena(seed: int):
    rng = np.random.default_rng(100 + seed)
    shape = (N_BLOCKS, 16, configs.get_reduced(ARCH).hd)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _port_pool(pk, pv):
    pool = UnifiedKVPool(N_BLOCKS, pk.shape[-1], torch.float32, device="cpu")
    pool.k.copy_(torch.from_numpy(pk))
    pool.v.copy_(torch.from_numpy(pv))
    return pool


KINDS = ("fused_decode", "fused_prefill_chunk", "decode", "chunk")
CASES = ("padded", "past", "none")


def _run_three(kind, case, weights):
    """(new port step, old port step, JAX step) on the same inputs:
    each a (logits, k arena, v arena) of numpy arrays."""
    jcfg, jstack, tstack = weights
    cfg = configs.get_reduced(ARCH)
    M, R, C = (2, 4, 16) if kind.startswith("fused") else (1, 4, 16)
    tables, toks, lens, offs, clens = _inputs(case, M, R, C, KINDS.index(kind))
    pk, pv = _arena(KINDS.index(kind))
    midx = 1
    one = TE._select_model(tstack, midx)
    res = {}
    for which in ("new", "old"):
        pool = _port_pool(pk, pv)
        if kind == "fused_decode":
            fn = TE._fused_decode_step if which == "new" else (
                lambda *a, cfg: _old_fused_decode(*a, cfg))
            out = fn(tstack, toks[:, :, 0], lens, pool, tables, cfg=cfg)
        elif kind == "fused_prefill_chunk":
            fn = TE._fused_prefill_chunk_step if which == "new" else (
                lambda *a, cfg: _old_fused_chunk(*a, cfg))
            out = fn(tstack, toks, offs, clens, pool, tables, cfg=cfg)
        elif kind == "decode":
            out = (TE._decode_step(tstack, midx, toks[0, :, 0], lens[0], pool,
                                   tables[0], cfg=cfg) if which == "new"
                   else _old_fused_decode(one, toks[:, :, 0], lens, pool,
                                          tables, cfg)[0])
        else:
            out = (TE._prefill_chunk_step(tstack, midx, toks[0], offs[0],
                                          clens[0], pool, tables[0], cfg=cfg)
                   if which == "new"
                   else _old_fused_chunk(one, toks, offs, clens, pool, tables,
                                         cfg)[0])
        res[which] = (out.numpy(), pool.k.numpy(), pool.v.numpy())
    a = {k: jnp.asarray(x) for k, x in dict(
        toks=toks, lens=lens, offs=offs, clens=clens, tables=tables,
        pk=pk, pv=pv).items()}
    if kind == "fused_decode":
        jk, jv, jl = JE._fused_decode_impl(jstack, a["toks"][:, :, 0],
                                           a["lens"], a["pk"], a["pv"],
                                           a["tables"], cfg=jcfg)
    elif kind == "fused_prefill_chunk":
        jk, jv, jl = JE._fused_prefill_chunk_impl(
            jstack, a["toks"], a["offs"], a["clens"], a["pk"], a["pv"],
            a["tables"], cfg=jcfg)
    elif kind == "decode":
        jk, jv, jl, _, _ = JE._decode_impl(
            jstack, midx, a["toks"][0, :, 0], a["lens"][0], a["pk"], a["pv"],
            a["tables"][0], None, None, cfg=jcfg)
    else:
        jk, jv, jl = JE._prefill_chunk_impl(
            jstack, midx, a["toks"][0], a["offs"][0], a["clens"][0], a["pk"],
            a["pv"], a["tables"][0], cfg=jcfg)
    res["jax"] = tuple(np.asarray(x) for x in (jl, jk, jv))
    res["arena"] = (pk, pv)
    return res


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kind", KINDS)
def test_fixed_shape_body_matches_old_step_and_reference(kind, case,
                                                         weights):
    res = _run_three(kind, case, weights)
    new, old, ref = res["new"], res["old"], res["jax"]
    # against the port's eager step before the split: bit for bit
    for a, b in zip(new, old):
        np.testing.assert_array_equal(a, b)
    # against the JAX step: the same entries written, the rest untouched
    for got, want, before in zip(new[1:], ref[1:], res["arena"]):
        wrote = (got != before).any(axis=-1)
        wrote_ref = (want != before).any(axis=-1)
        np.testing.assert_array_equal(wrote, wrote_ref)
        np.testing.assert_array_equal(got[~wrote], before[~wrote])
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(new[0], ref[0], rtol=TOL, atol=TOL)
    if case == "none":
        for got, before in zip(new[1:], res["arena"]):
            np.testing.assert_array_equal(got, before)


def test_plan_has_the_bucket_length():
    """The write plan's length depends on shapes only: B·S entries
    whatever the table keeps, each dropped entry a copy of a kept one."""
    table = np.array([[8, -1], [-1, -1]], np.int32)
    for start, n_kept in (([0, 0], 16), ([8, 0], 8), ([40, 0], 0)):
        plan = cache_ops.plan_slots(table, np.array(start), 16, 16)
        assert plan["src"].shape == (32,) and plan["base"].shape == (32,)
        assert bool(plan["live"]) == (n_kept > 0)
        assert len(set(plan["src"].tolist())) == max(n_kept, 1)


# ---------------------------------------------------------------------------
# the registry, through a capture stub
# ---------------------------------------------------------------------------
class RecordingCapture:
    """The capture on CPU operands: records each captured key; a replay
    runs the body on the graph's static input into its static output,
    as the graph would.  Like a CUDA graph capture, recording runs
    nothing (a step that writes state in place must not run twice): the
    static output is shaped on the eager run's result."""

    device_types = ("cpu",)

    def __init__(self):
        self.keys = []
        self._last = None

    def eager(self, fn, device):
        self._last = fn()
        return self._last

    def record(self, key, fn, device):
        self.keys.append(key)
        out, self._last = torch.empty_like(self._last), None
        return (lambda body: out.copy_(body())), out


@pytest.fixture
def stub():
    saved = graphs.REGISTRY.capture
    graphs.REGISTRY.clear()
    graphs.REGISTRY.capture = rec = RecordingCapture()
    try:
        yield rec
    finally:
        graphs.REGISTRY.capture = saved
        graphs.REGISTRY.clear()


def _trees(n):
    jcfg = jconfigs.get_reduced(ARCH)
    return [params_to_torch(jax.tree_util.tree_map(np.asarray, jinit(
        jax.random.PRNGKey(i), jcfg, jnp.float32)), "cpu") for i in range(n)]


def _unit(trees, fused=True, pool_blocks=4000, chunk=16, slots=4):
    base = configs.get_reduced(ARCH)
    pool = UnifiedKVPool(pool_blocks, base.hd, torch.float32, device="cpu")
    engines = {}
    for i, tree in enumerate(trees):
        cfg = replace(base, name=f"llm{i}")
        view = pool.register_model(cfg, pool_blocks // len(trees))
        engines[cfg.name] = Engine(cfg, TE.tree_map(lambda a: a.clone(), tree),
                                   view, max_slots=slots, chunk_tokens=chunk,
                                   max_blocks_per_seq=16)
    return MuxScheduler(engines, pool, policy="adbs", fused=fused)


def _wave(mux, n, max_new, seed, rid=0):
    rng = np.random.default_rng(seed)
    for name, eng in mux.engines.items():
        for j in range(n):
            plen = (24, 40, 56)[j % 3]
            mux.submit(Request(rid, name, list(rng.integers(
                1, eng.cfg.vocab_size, plen)), max_new))
            rid += 1
    return rid


def _outputs(mux):
    return {r.req_id: list(r.output) for r in mux.stats.finished}


def _kinds(keys):
    return [k[0][0] for k in keys]


def _chunk_rows(keys):
    """The rows a member of each captured fused chunk sweep, in order
    (the key's layout opens with the ``[M, R, C]`` tokens)."""
    return [k[0][2][0][1][1] for k in keys
            if k[0][0] == "fused_prefill_chunk"]


def test_registry_one_program_per_bucket(stub):
    """A fused unit served through the registry gives the eager run's
    tokens; every key is captured once, the fused decode once (the
    group's fixed rows), the fused chunk sweep once per row bucket
    (``FusedGroup.chunk_buckets``), the serial kinds once per
    power-of-two rows; ``TRACE_COUNTS``' buckets are untouched by the
    registry."""
    trees = _trees(2)
    mux = _unit(trees)
    _wave(mux, 5, 6, seed=1)
    mux.run(max_ticks=2_000)
    with graphs.disable_graphs():
        eager = _unit(trees)
        _wave(eager, 5, 6, seed=1)
        eager.run(max_ticks=2_000)
    assert len(mux.stats.finished) == 10
    assert _outputs(mux) == _outputs(eager)
    assert len(stub.keys) == len(set(stub.keys))
    kinds = _kinds(stub.keys)
    assert kinds.count("fused_decode") == 1
    (grp,) = mux.fused_groups
    assert grp.chunk_buckets == (1, 2, 4)
    assert _chunk_rows(stub.keys) == [1, 2, 4]
    for kind in ("decode", "chunk"):
        rows = {k[0][2][0][1][1] for k in stub.keys if k[0][0] == kind}
        assert rows <= {1, 2, 4}
        assert kinds.count(kind) == len({(k[0][2], k[0][3])
                                         for k in stub.keys
                                         if k[0][0] == kind})
    assert set(graphs.REGISTRY.graphs) == set(stub.keys)
    assert TE.total_traces() == sum(TE.TRACE_COUNTS.values())


def _submit_rows(mux, in_flight, plen=40, max_new=3, seed=8, rid=0):
    """``in_flight[m]`` requests of ``plen`` tokens for member ``m``, ids
    from ``rid``: one tick admits them all, so each chunk sweep of the
    prompts runs that many rows a member."""
    rng = np.random.default_rng(seed)
    for n, (name, eng) in zip(in_flight, mux.engines.items()):
        for _ in range(n):
            mux.submit(Request(rid, name, list(rng.integers(
                1, eng.cfg.vocab_size, plen)), max_new))
            rid += 1


@pytest.mark.parametrize("in_flight", [(1, 0), (1, 1), (3, 1), (5, 2),
                                       (9, 16), (16, 16)])
def test_chunk_sweep_runs_the_bucket_of_its_busiest_member(stub, in_flight):
    """With 16 slots a member, the fused chunk sweep runs ``[2, R, C]``
    tokens, ``R`` the power of two that holds the busiest member's rows
    (16 at most), and counts ``2·R·C`` tokens computed; a lone
    prefilling member takes its own bucketed step.  The tokens equal
    those of the eager run and of the serial (unfused) path."""
    from repro_torch.serving.metrics import RECORDER
    trees = _trees(2)
    C = 16
    busiest = max(in_flight)
    R = 1 << (busiest - 1).bit_length()
    outs, sweeps = {}, []
    for mode in ("graphs", "eager", "serial"):
        ctx = graphs.disable_graphs() if mode == "eager" else \
            contextlib.nullcontext()
        with ctx:
            mux = _unit(trees, fused=mode != "serial", chunk=C, slots=16)
            if mode == "graphs":
                (grp,) = mux.fused_groups

                def seen(params, toks, *rest, sweep=grp._prefill_fn):
                    sweeps.append(toks.shape)
                    return sweep(params, toks, *rest)
                grp._prefill_fn = seen
                RECORDER.disarm()
                RECORDER.reset()
                RECORDER.arm(capacity=1 << 14)
            _submit_rows(mux, in_flight)
            try:
                mux.tick()              # admits all, runs one chunk step
            finally:
                counted = dict(RECORDER.counters)
                RECORDER.disarm()
                RECORDER.reset()
            mux.run(max_ticks=2_000)
            assert len(mux.stats.finished) == sum(in_flight)
            outs[mode] = _outputs(mux)
            if mode != "graphs":
                continue
            assert counted["tokens.chunk.real"] == C * sum(in_flight)
            if min(in_flight) == 0:
                # the lone member's serial step: no fused sweep
                assert not sweeps
                assert counted["tokens.chunk.computed"] == R * C
            else:
                # 40-token prompts: three sweeps of the same rows
                assert sweeps == [(2, R, C)] * 3
                assert counted["tokens.chunk.computed"] == 2 * R * C
                assert R in grp.chunk_buckets
    assert outs["graphs"] == outs["eager"] == outs["serial"]


def test_first_chunk_sweep_captures_every_bucket(stub):
    """The group's first chunk sweep, of one row a member, captures every
    bucket (6 slots: 1, 2, 4 and 6 rows) at once, each once; later
    sweeps at any rows capture no chunk sweep.  The buckets' runs on
    padded rows write nothing into the arena."""
    trees = _trees(2)
    idle = _unit(trees, slots=6)
    (grp,) = idle.fused_groups
    assert grp.chunk_buckets == (1, 2, 4, 6)
    k0, v0 = (t.clone() for t in idle.pool.arena())
    grp._warm_chunk_buckets(idle.pool)
    assert _chunk_rows(stub.keys) == [1, 2, 4, 6]
    assert torch.equal(idle.pool.arena()[0], k0)
    assert torch.equal(idle.pool.arena()[1], v0)
    mux = _unit(trees, slots=6)
    n = len(stub.keys)
    _submit_rows(mux, (1, 1))
    mux.tick()
    assert _chunk_rows(stub.keys[n:]) == [1, 2, 4, 6]
    n = len(stub.keys)
    mux.run(max_ticks=2_000)
    for in_flight in ((5, 2), (6, 3), (2, 2)):
        _submit_rows(mux, in_flight, seed=sum(in_flight))
        mux.run(max_ticks=2_000)
    assert "fused_prefill_chunk" not in _kinds(stub.keys[n:])
    assert len(mux.stats.finished) == 2 + 7 + 9 + 4


def test_chunk_buckets_recaptured_together_after_reallocating_grow(stub):
    """After a ``grow`` that reallocates the arena, the next chunk sweep
    recaptures every bucket on the new arena, all in that sweep, each
    once; the tokens equal the eager twin's."""
    trees = _trees(2)
    outs = {}
    for mode in ("graphs", "eager"):
        ctx = graphs.disable_graphs() if mode == "eager" else \
            contextlib.nullcontext()
        with ctx:
            mux = _unit(trees, pool_blocks=2000, slots=8)
            (grp,) = mux.fused_groups
            _submit_rows(mux, (3, 2))
            mux.run(max_ticks=2_000)
            pool = mux.pool
            k_before = pool.arena()[0]
            pool.grow(k_before.shape[0])            # past the buffer
            assert pool.arena()[0] is not k_before
            del k_before
            if mode == "graphs":
                assert not any(k[0][0] == "fused_prefill_chunk"
                               for k in graphs.REGISTRY.graphs)
            n = len(stub.keys)
            _submit_rows(mux, (2, 1), seed=9, rid=100)
            mux.tick()
            if mode == "graphs":
                assert _chunk_rows(stub.keys[n:]) == list(grp.chunk_buckets)
                assert all(k[1][0] == pool.arena()[0].data_ptr()
                           for k in stub.keys[n:])
            n = len(stub.keys)
            mux.run(max_ticks=2_000)
            if mode == "graphs":
                assert "fused_prefill_chunk" not in _kinds(stub.keys[n:])
            outs[mode] = _outputs(mux)
    assert outs["graphs"] == outs["eager"] and len(outs["graphs"]) == 8


def test_registry_no_capture_in_fused_tick_measured_waves(stub):
    """The ``fused_tick`` gate's drain (three engines, a warm-up wave,
    two measured waves of ≥ 50 ticks): no capture after warm-up, and
    the tokens of the eager drain."""
    trees = _trees(3)
    outs = {}
    for mode in ("graphs", "eager"):
        ctx = graphs.disable_graphs() if mode == "eager" else \
            contextlib.nullcontext()
        with ctx:
            mux = _unit(trees)
            _wave(mux, 6, 20, seed=1)
            mux.run(max_ticks=5_000)
            ticks, fin = mux.stats.ticks, len(mux.stats.finished)
            captured = len(stub.keys)
            rid = 0
            for wave in range(2):
                rid = _wave(mux, 6, 20, seed=2 + wave, rid=rid)
                mux.run(max_ticks=5_000)
            assert mux.stats.ticks - ticks >= 50
            assert len(mux.stats.finished) - fin == 36
            assert len(stub.keys) == captured, \
                "a shape-stable drain must capture nothing new"
            outs[mode] = {r.req_id: r.output
                          for r in mux.stats.finished[fin:]}
    assert outs["graphs"] == outs["eager"]


def _decode_all(mux):
    """Run decode ticks until every live sequence finished."""
    while mux.pending():
        mux.tick()


def test_registry_recaptures_after_reallocating_grow_only(stub):
    """Live sequences across a ``shrink``, a ``grow`` into the slack (no
    recapture: the buffers stay) and a ``grow`` past the buffer (the
    arena reallocates: the old graphs are dropped and the steps
    recaptured once each), with the eager twin's tokens."""
    trees = _trees(2)
    runs = {}
    for mode in ("graphs", "eager"):
        ctx = graphs.disable_graphs() if mode == "eager" else \
            contextlib.nullcontext()
        with ctx:
            mux = _unit(trees, pool_blocks=2000)
            _wave(mux, 2, 12, seed=3)
            for _ in range(6):
                mux.tick()
            pool = mux.pool
            n0 = len(stub.keys)
            old = set(graphs.REGISTRY.graphs)
            pool.shrink(200)
            assert pool.grow(200) == 200       # into the slack
            for _ in range(3):
                mux.tick()
            if mode == "graphs":
                assert len(stub.keys) == n0
                assert set(graphs.REGISTRY.graphs) == old
                assert any(k[0][0] == "fused_decode" for k in old)
            k_before = pool.arena()[0]
            pool.grow(pool.arena()[0].shape[0])       # past the buffer
            assert pool.arena()[0] is not k_before
            del k_before
            if mode == "graphs":
                # every graph on the old arena died with it
                assert not set(graphs.REGISTRY.graphs) & old
            n1 = len(stub.keys)
            for _ in range(3):
                mux.tick()
            if mode == "graphs":
                slots = [k[0] for k in stub.keys[n1:]]
                assert len(slots) == len(set(slots))
                assert "fused_decode" in _kinds(stub.keys[n1:])
            _decode_all(mux)
            runs[mode] = _outputs(mux)
    assert runs["graphs"] == runs["eager"]
    assert len(runs["graphs"]) == 4


def test_registry_recaptures_after_adopt_stacked(stub):
    """Two engines decode alone (serial steps on their private trees);
    mid-run they adopt a stacked tree (``FusedGroup``): the private
    trees' graphs are dropped with the trees, the serial steps are
    recaptured on the stack (model indices 0 and 1), and the tokens equal
    a run without the adoption."""
    trees = _trees(2)
    outs = {}
    for adopt in (False, True):
        gc.collect()
        graphs.REGISTRY.clear()
        mux = _unit(trees, fused=False)
        _wave(mux, 2, 8, seed=4)
        for _ in range(6):
            mux.tick()
        serial = set(graphs.REGISTRY.graphs)
        assert serial and all(k[0][3] == 0 for k in serial)
        n0 = len(stub.keys)
        if adopt:
            TM.FusedGroup([mux.engines["llm0"], mux.engines["llm1"]])
            assert mux.engines["llm1"].model_index == 1
            assert not set(graphs.REGISTRY.graphs) & serial
        mux.run(max_ticks=2_000)
        if adopt:
            assert {k[0][3] for k in stub.keys[n0:]} == {0, 1}
        outs[adopt] = _outputs(mux)
    assert outs[True] == outs[False] and len(outs[True]) == 4


def test_registry_recaptures_after_migrate_view(stub):
    """An engine with live decodes moves to another pool
    (``migrate_view`` + ``rebind_view``): its decode is recaptured on
    the new arena, the graph on the old arena dropped, and its tokens
    equal those of an engine that never moved."""
    trees = _trees(1)
    outs = {}
    for move in (False, True):
        gc.collect()
        graphs.REGISTRY.clear()
        base = replace(configs.get_reduced(ARCH), name="m")
        src = UnifiedKVPool(1000, base.hd, torch.float32, device="cpu")
        dst = UnifiedKVPool(1200, base.hd, torch.float32, device="cpu")
        eng = Engine(base, TE.tree_map(lambda a: a.clone(), trees[0]),
                     src.register_model(base, 1000), max_slots=4,
                     chunk_tokens=16, max_blocks_per_seq=16)
        rng = np.random.default_rng(6)
        reqs = [Request(i, "m", list(rng.integers(1, 512, 30)), 10)
                for i in range(3)]
        eng.prefill(reqs)
        while eng.has_prefill_work():
            eng.prefill([])
        for _ in range(3):
            eng.decode()
        if move:
            before = [k for k in graphs.REGISTRY.graphs
                      if k[0][0] == "decode"]
            assert before
            n0 = len(stub.keys)
            view, _ = migrate_view(eng.view, dst, 1200)
            eng.rebind_view(view)
        while eng.has_decode_work():
            eng.decode()
        if move:
            assert "decode" in _kinds(stub.keys[n0:])
            assert not set(before) & set(graphs.REGISTRY.graphs)
            assert all(k[1][0] == dst.arena()[0].data_ptr()
                       for k in graphs.REGISTRY.graphs if k[0][0] == "decode")
        outs[move] = {r.req_id: list(r.output) for r in eng.finished}
    assert outs[True] == outs[False] and len(outs[True]) == 3


def test_warmup_drain_captures_before_the_clock(stub):
    """Under the wall clock the warm-up drain (and the solo probes) meet
    every bucket first: the served run captures nothing more, as the
    reference compiles its buckets before the clock starts."""
    from repro_torch.core.workload import synthesize
    from repro_torch.serving import driver as TD
    names = ["llm0", "llm1"]
    wl = synthesize(names, alpha=2.1, max_rate=12.0, horizon=1.0, seed=0,
                    mean_prompt=24, mean_output=6, max_len=96)
    unit = TD.build_unit_from_specs(
        [(n, ARCH, wl.rates[n]) for n in names], pool_blocks=4000,
        chunk_tokens=16, fused=True, dtype=torch.float32, device="cpu")
    reqs = TD.requests_from_workload(wl, unit.engines, seed=0,
                                     max_new_cap=4)
    sess = TD.ServeSession([unit], reqs)
    warmed = len(stub.keys)
    assert {"fused_decode", "fused_prefill_chunk"} <= set(_kinds(stub.keys))
    while sess.step()[0] != "done":
        pass
    assert sess.report().aggregate.finished == len(reqs) > 0
    assert len(stub.keys) == warmed


def test_graphs_off_on_cpu_and_not_for_other_families():
    """CPU operands never reach the registry; every family's steps are
    captured on the card (MoE's too, ``tests/test_torch_step_graphs_moe.py``),
    and the dense attention family alone fuses."""
    graphs.REGISTRY.clear()
    mux = _unit(_trees(2))
    _wave(mux, 2, 3, seed=7)
    mux.run(max_ticks=1_000)
    assert not graphs.REGISTRY.graphs
    for arch in (ARCH, "musicgen-medium", "phi-3-vision-4.2b"):
        assert TE.dense_attention(configs.get_reduced(arch))
    for arch in ("granite-moe-3b-a800m", "qwen3-moe-235b-a22b",
                 "mamba2-2.7b", "zamba2-1.2b"):
        assert not TE.dense_attention(configs.get_reduced(arch))


# ---------------------------------------------------------------------------
# names the port shares with the reference
# ---------------------------------------------------------------------------
def test_total_traces_matches_reference_definition():
    TE.TRACE_COUNTS["probe"] += 2
    JE.TRACE_COUNTS["probe"] += 2
    try:
        assert TE.total_traces() == sum(TE.TRACE_COUNTS.values())
        assert JE.total_traces() == sum(JE.TRACE_COUNTS.values())
    finally:
        for c in (TE.TRACE_COUNTS, JE.TRACE_COUNTS):
            c["probe"] -= 2
            if not c["probe"]:
                del c["probe"]


@pytest.mark.parametrize("horizon", [2.5, 0.0])
def test_throughput_reqs_matches_reference(horizon):
    t, j = TM.MuxStats(), JM.MuxStats()
    for i in range(7):
        t.finished.append(Request(i, "m", [1], 1))
        j.finished.append(JE.Request(i, "m", [1], 1))
    assert t.throughput_reqs(horizon) == j.throughput_reqs(horizon)


def test_fused_decode_group_alias():
    assert TM.FusedDecodeGroup is TM.FusedGroup
    assert JM.FusedDecodeGroup is JM.FusedGroup


# ---------------------------------------------------------------------------
# chip_smoke.py's phases rehearsed through the registry (the stub)
# ---------------------------------------------------------------------------
def _chip_smoke():
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


def test_graphs_phase_rehearses_on_cpu(stub):
    """``serve_graphs`` at reduced width: eager and captured runs give
    one report and one set of tokens, with and without the arena grown
    past its buffer mid-run; the grow drops the old arena's graphs and
    recaptures the fused decode once."""
    res = _chip_smoke().serve_graphs(torch, device="cpu", reduced=True)
    runs = res["runs"]
    # (b) once; (c) once on its fresh unit and once after the grow
    assert res["captures"]["fused_decode"] == 3
    # one capture per chunk bucket of the group's 4 slots: 1, 2, 4 rows
    assert runs["(b) graphs"]["captured"].count("fused_prefill_chunk") == 3
    assert not runs["(a) eager"]["captured"]
    grow = runs["(c) graphs, grown"]["grow"]
    assert grow["reallocated"] and grow["graphs_on_old_arena"] > 0
    assert grow["graphs_left_on_old_arena"] == 0
    assert grow["recaptured"]["fused_decode"] == 1
    assert res["first_decode_rel_err"] == 0.0
    assert runs["(a) eager"]["ticks"] == runs["(b) graphs"]["ticks"] > 0


def test_prefix_phase_rehearses_through_the_registry(stub):
    """``serve_prefix`` at reduced width with every dense step through
    the registry: kernel 2's check at the first off-grid step still
    runs (that step eagerly), and the phase's checks hold."""
    res = _chip_smoke().serve_prefix(torch, device="cpu", reduced=True)
    k2 = res["kernel_2_at_served_offsets"]
    assert any(o % 64 for o in k2["q_offsets"])
    assert k2["max_abs_err"] <= k2["tolerance"]
    assert stub.keys and res["logit_check"]["max_rel_err"] < \
        res["logit_check"]["tolerance"]
