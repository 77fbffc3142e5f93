"""Prefix caching in the port's unified KV pool against the JAX
package's, on the CPU: the nine scenarios of ``tests/test_prefix_cache.py``,
each run through both packages on the same weights (``_torch_twins``)
and the same seeded prompts, with the port's tokens, prefix-index
entries and ``stats()``, refcounts, free lists, sequence tables and
copied pages held exactly equal to the reference's.

* shared-prefix decode equals the uncached run, fused and serial;
* a partial hit resumes prefill at the first uncached chunk;
* adoption is clamped below the full prompt;
* copy-on-write divergence, and the in-place unshare when the sharer is
  the sole holder;
* ``share_prefix``'s full quota charge;
* a block loss invalidates the doomed index entries;
* crash recovery clears the index with no leak;
* LRU eviction of cache inventory under allocation pressure.

The serve CLI's ``--prefix-cache`` / ``--prefix-reuse`` give the JAX
CLI's report JSON (``wall_s`` apart), and its argument errors.
"""
import json
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_twins import twin_units
from repro import configs as jconfigs
from repro.config import replace as jreplace
from repro.serving import driver as JD
from repro.serving.engine import Request as JRequest
from repro.launch import serve as jserve
from repro.serving.kvcache import UnifiedKVPool as JPool
from repro_torch import configs as tconfigs
from repro_torch.config import BLOCK_TOKENS
from repro_torch.config import replace as treplace
from repro_torch.launch import serve
from repro_torch.serving import driver as TD
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.kvcache import UnifiedKVPool as TPool

torch.set_num_threads(2)

SPECS = [("a", "qwen2-7b", 2.0), ("b", "qwen2-7b", 1.0)]

JAX = SimpleNamespace(
    name="jax", Request=JRequest, LogicalClock=JD.LogicalClock,
    pool=lambda n, hd, cache=False: JPool(n, hd, dtype=jnp.float32,
                                          prefix_cache=cache),
    cfg=lambda hd: jreplace(jconfigs.get_reduced("qwen2-7b"), head_dim=hd))
PORT = SimpleNamespace(
    name="port", Request=TRequest, LogicalClock=TD.LogicalClock,
    pool=lambda n, hd, cache=False: TPool(n, hd, dtype=torch.float32,
                                          device="cpu", prefix_cache=cache),
    cfg=lambda hd: treplace(tconfigs.get_reduced("qwen2-7b"), head_dim=hd))


def _prefix(n_blocks=2):
    rng = np.random.default_rng(9)
    return list(rng.integers(1, 500, n_blocks * BLOCK_TOKENS))


def _twins(cache, fused=True, pool_blocks=6_000):
    """(jax unit, port unit) of the reference test's ``_unit``, each on a
    logical clock of its own."""
    units = twin_units(SPECS, seed=0, pool_blocks=pool_blocks, max_slots=4,
                       chunk_tokens=16, policy="adbs", fused=fused,
                       prefix_cache=cache)
    for u, pkg in zip(units, (JAX, PORT)):
        clock = pkg.LogicalClock()
        u.clock = clock
        for e in u.engines.values():
            e.clock = clock
    return units


def _drain(u, max_ticks=800):
    for _ in range(max_ticks):
        if not u.pending():
            return
        u.tick()
        u.clock.advance(0.005)
    raise AssertionError("unit did not drain")


def _sharer_reqs(pkg, pref, n=3, tail=8, out=6):
    rng = np.random.default_rng(13)
    return [pkg.Request(1 + i, "a", pref + list(rng.integers(1, 500, tail)),
                        out, arrival=0.0)
            for i in range(n)]


def _pool_state(pool):
    """Everything the pool's host bookkeeping holds, as plain values."""
    a = pool.allocator
    views = {}
    for n, v in pool.views.items():
        idx = v.prefix_index
        views[n] = dict(
            quota=v.quota, used=v.used,
            seqs={s: (list(map(int, c.bases)), c.n_tokens, c.shared)
                  for s, c in v.seqs.items()},
            index=None if idx is None else (idx.entries(), idx.stats()))
    return dict(free=a.free_ranges(), refs=a.refcounts(), used=a.used,
                physical=a.physical_used, n_blocks=pool.n_head_blocks,
                available=pool.available_blocks(), views=views)


def _outputs(u):
    return {r.req_id: list(map(int, r.output)) for r in u.stats.finished}


def _pages(pool, lo, hi):
    k, v = pool.k[lo:hi], pool.v[lo:hi]
    if isinstance(k, torch.Tensor):
        return k.numpy().copy(), v.numpy().copy()
    return np.asarray(k), np.asarray(v)


def _assert_equal_pages(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# served scenarios
# ---------------------------------------------------------------------------
def _run_schedule(u, pkg):
    """Donor first (populates the index), then three sharers."""
    pref = _prefix()
    u.submit(pkg.Request(0, "a", pref + [7, 7, 7, 7], 6, arrival=0.0))
    _drain(u)
    for r in _sharer_reqs(pkg, pref):
        u.submit(r)
    _drain(u)
    return _outputs(u)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "serial"])
def test_shared_prefix_decode_bit_identical(fused):
    """Decoding on adopted prefix blocks gives the uncached run's tokens
    in the port, and the port's tokens, counters and pool equal the
    reference's."""
    ref_j, ref_t = _twins(cache=False, fused=fused)
    hit_j, hit_t = _twins(cache=True, fused=fused)
    outs = {}
    for name, u, pkg in (("ref_j", ref_j, JAX), ("ref_t", ref_t, PORT),
                         ("hit_j", hit_j, JAX), ("hit_t", hit_t, PORT)):
        outs[name] = _run_schedule(u, pkg)
    assert set(outs["hit_t"]) == {0, 1, 2, 3}
    assert outs["hit_t"] == outs["ref_t"], \
        "shared-prefix outputs must be bit-identical to the uncached run"
    assert outs["hit_t"] == outs["hit_j"] and outs["ref_t"] == outs["ref_j"]
    stats = hit_t.prefix_stats()["a"]
    assert stats["hits"] == 3 and stats["hit_tokens"] == 3 * 2 * BLOCK_TOKENS
    assert hit_t.prefix_stats() == hit_j.prefix_stats()
    assert ref_t.prefix_stats() == {} == ref_j.prefix_stats()
    pool = hit_t.pool
    assert pool.allocator.used == sum(
        v.prefix_index.held_blocks for v in pool.views.values()
        if v.prefix_index is not None)
    assert _pool_state(pool) == _pool_state(hit_j.pool)


def test_partial_hit_resumes_at_right_chunk():
    """A prompt whose first two blocks are cached starts prefill at token
    32 in both packages, with the same job, sequence and counters."""
    pref = _prefix()
    seen = {}
    for u, pkg in zip(_twins(cache=True), (JAX, PORT)):
        u.submit(pkg.Request(0, "a", pref + [7, 7, 7, 7], 6, arrival=0.0))
        _drain(u)
        eng = u.engines["a"]
        idx = eng.view.prefix_index
        assert len(idx) == 2 and idx.inserted == 2
        r = _sharer_reqs(pkg, pref, n=1)[0]
        eng.admit_chunked([r])
        sc = eng.view.seqs[r._seq_id]
        assert sc.shared == 2 and sc.n_tokens == 40
        assert list(eng._prefilling.values()) == [32]
        job = eng.export_prefill_job()
        assert list(job.offs) == [32] and list(job.clens) == [8]
        assert idx.hits == 1 and idx.hit_tokens == 32
        assert r.prefill_done < 0 and r.first_token < 0
        mid = _pool_state(u.pool)
        _drain(u)
        assert r.first_token >= 0 and len(r.output) == 6
        seen[pkg.name] = (mid, job.toks.tolist(), _outputs(u),
                          _pool_state(u.pool), r.first_token)
    assert seen["port"] == seen["jax"]


def test_adoption_clamped_below_full_prompt():
    """A prompt that IS a cached chain adopts one block less in both
    packages, and serves the uncached run's tokens."""
    pref = _prefix()
    seen = {}
    for u, ref, pkg in zip(_twins(cache=True), _twins(cache=False),
                           (JAX, PORT)):
        u.submit(pkg.Request(0, "a", pref, 4, arrival=0.0))
        _drain(u)
        eng = u.engines["a"]
        eng.admit_chunked([pkg.Request(1, "a", list(pref), 4, arrival=0.0)])
        assert list(eng._prefilling.values()) == [BLOCK_TOKENS]
        _drain(u)
        ref.submit(pkg.Request(0, "a", pref, 4, arrival=0.0))
        ref.submit(pkg.Request(1, "a", list(pref), 4, arrival=0.0))
        _drain(ref)
        assert _outputs(u) == _outputs(ref)
        seen[pkg.name] = (_outputs(u), _pool_state(u.pool))
    assert seen["port"] == seen["jax"]


# ---------------------------------------------------------------------------
# copy-on-write at the view + cache_ops level
# ---------------------------------------------------------------------------
def _crafted_view(pkg):
    pool = pkg.pool(256, 8)
    view = pool.register_model(pkg.cfg(8), quota=10**6)
    assert view.append_tokens(0, BLOCK_TOKENS)    # donor: one full block
    base = view.seqs[0].bases[0]
    gs = view.group_size
    if pkg is PORT:
        pool.k[base:base + gs] = 1.0
        pool.v[base:base + gs] = 2.0
    else:
        pool.k = pool.k.at[base:base + gs].set(1.0)
        pool.v = pool.v.at[base:base + gs].set(2.0)
    return pool, view, base, gs


def test_cow_divergence_independent_continuations():
    """A write into a shared tail block copies the donor's pages into a
    private group, in place on the port's arena: the same group, the
    same pages and the same refcounts as the reference."""
    seen = {}
    for pkg in (JAX, PORT):
        pool, view, base, gs = _crafted_view(pkg)
        assert view.share_prefix(1, [base], 8)
        assert pool.allocator.refcount(base) == 2
        assert view.used == 2 * gs
        assert view.append_tokens(1, 1)               # write → COW
        sc = view.seqs[1]
        new = sc.bases[0]
        assert new != base and sc.shared == 0
        assert pool.allocator.refcount(base) == 1
        assert pool.allocator.refcount(new) == 1
        _assert_equal_pages(_pages(pool, new, new + gs),
                            _pages(pool, base, base + gs))
        seen[pkg.name] = (new, _pool_state(pool), _pages(pool, 0, 256))
        if pkg is PORT:
            assert pool.k.data_ptr() == pool._k_buf.data_ptr(), \
                "the copy must land in the arena's buffer"
            pool.k[new] += 5.0                        # diverge the copy
        else:
            pool.k = pool.k.at[new].add(5.0)
        assert (_pages(pool, base, base + gs)[0] == 1.0).all()
        assert not np.array_equal(_pages(pool, new, new + gs)[0],
                                  _pages(pool, base, base + gs)[0])
        assert view.used == 2 * gs
        view.free_seq(0)
        view.free_seq(1)
        assert pool.allocator.used == 0
    assert seen["port"][:2] == seen["jax"][:2]
    _assert_equal_pages(seen["port"][2], seen["jax"][2])


def test_cow_unshare_in_place_when_sole_holder():
    seen = {}
    for pkg in (JAX, PORT):
        pool, view, base, gs = _crafted_view(pkg)
        assert view.share_prefix(1, [base], 8)
        view.free_seq(0)                              # donor leaves first
        assert pool.allocator.refcount(base) == 1
        free_before = pool.allocator.free_blocks
        pages = _pages(pool, 0, 256)
        assert view.append_tokens(1, 1)
        sc = view.seqs[1]
        assert sc.bases[0] == base and sc.shared == 0, "unshare in place"
        assert pool.allocator.free_blocks == free_before
        _assert_equal_pages(_pages(pool, 0, 256), pages)   # no copy
        seen[pkg.name] = _pool_state(pool)
        view.free_seq(1)
        assert pool.allocator.used == 0
    assert seen["port"] == seen["jax"]


def test_share_prefix_full_quota_charge_enforced():
    seen = {}
    for pkg in (JAX, PORT):
        pool, view, base, gs = _crafted_view(pkg)
        view.quota = gs                               # donor already uses it
        assert not view.share_prefix(1, [base], 8), \
            "a sharer over quota must be refused (full-charge policy)"
        assert pool.allocator.refcount(base) == 1 and 1 not in view.seqs
        seen[pkg.name] = _pool_state(pool)
    assert seen["port"] == seen["jax"]


# ---------------------------------------------------------------------------
# index lifecycle: block loss, crash recovery, eviction under pressure
# ---------------------------------------------------------------------------
def _no_dangling(pool):
    for v in pool.views.values():
        if v.prefix_index is None:
            continue
        for _, (b, _) in v.prefix_index.entries():
            assert b + v.group_size <= pool.n_head_blocks
            assert pool.allocator.refcount(b) >= 1


def test_block_loss_invalidates_doomed_index_entries():
    pref = _prefix()
    seen = {}
    for u, pkg in zip(_twins(cache=True), (JAX, PORT)):
        pool = u.pool
        hog = pool.allocator.alloc(3_000)       # cached blocks land high
        assert hog == 0
        u.submit(pkg.Request(0, "a", pref + [7, 7, 7, 7], 6, arrival=0.0))
        _drain(u)
        sharer = _sharer_reqs(pkg, pref, n=1)[0]
        u.submit(sharer)
        for _ in range(3):                       # adopt + get into flight
            u.tick()
            u.clock.advance(0.005)
        idx = u.engines["a"].view.prefix_index
        assert len(idx) == 2 and idx.hits == 1
        shared_bases = {b for _, (b, _) in idx.entries()}
        n_before = pool.n_head_blocks
        n_lose = n_before - min(min(shared_bases),
                                min(b for v in pool.views.values()
                                    for sc in v.seqs.values()
                                    for b in sc.bases))
        before = _pool_state(pool)
        rec = u._lose_blocks(n_lose)
        assert rec["blocks"] == n_lose
        assert pool.n_head_blocks == n_before - n_lose
        assert rec["requeued"] >= 1
        assert len(idx) == 0 and idx.evicted >= 2
        _no_dangling(pool)
        assert pool.allocator.used \
            == sum(v.used for v in pool.views.values()) + 3_000
        after = _pool_state(pool)
        pool.allocator.free(hog, 3_000)
        _drain(u)
        assert {r.req_id for r in u.stats.finished} == {0, sharer.req_id}
        seen[pkg.name] = (before, rec, after, _outputs(u),
                          _pool_state(pool))
        assert pool.k.shape[0] == pool.n_head_blocks
    assert seen["port"] == seen["jax"]


def test_crash_recovery_clears_index_without_leaks():
    pref = _prefix()
    seen = {}
    for u, pkg in zip(_twins(cache=True), (JAX, PORT)):
        u.submit(pkg.Request(0, "a", pref + [7, 7, 7, 7], 6, arrival=0.0))
        _drain(u)
        pool = u.pool
        assert len(u.engines["a"].view.prefix_index) == 2
        assert pool.allocator.used > 0           # index inventory only
        u.recover_engine("a", reason="crash")
        idx = u.engines["a"].view.prefix_index
        assert idx is not None and len(idx) == 0
        assert pool.allocator.used == 0
        _no_dangling(pool)
        for r in _sharer_reqs(pkg, pref, n=2):   # a cold cache still serves
            u.submit(r)
        _drain(u)
        assert len(u.stats.finished) == 3
        seen[pkg.name] = (_outputs(u), _pool_state(pool), u.prefix_stats())
    assert seen["port"] == seen["jax"]


def test_index_evicted_under_allocation_pressure():
    seen = {}
    for pkg in (JAX, PORT):
        pool = pkg.pool(8 * 4, 8, cache=True)
        view = pool.register_model(pkg.cfg(8), quota=10**6)
        gs = view.group_size                     # 4 → arena holds 8 groups
        rng = np.random.default_rng(3)
        for sid in range(8):                     # fill the arena with cache
            prompt = list(rng.integers(1, 500, BLOCK_TOKENS))
            assert view.append_tokens(sid, BLOCK_TOKENS)
            view.prefix_index.insert(prompt, view.seqs[sid].bases)
            view.free_seq(sid)
        assert pool.allocator.free_blocks == 0
        assert pool.available_blocks() == 8 * gs
        assert view.can_append(100, BLOCK_TOKENS)
        full = _pool_state(pool)
        assert view.append_tokens(100, 2 * BLOCK_TOKENS)
        assert len(view.prefix_index) == 6 and view.prefix_index.evicted == 2
        _no_dangling(pool)
        seen[pkg.name] = (full, _pool_state(pool))
        view.free_seq(100)
        view.prefix_index.clear()
        assert pool.allocator.used == 0
    assert seen["port"] == seen["jax"]


def test_torch_scalar_prompts_never_hit():
    """Prompt blocks key by value only for Python or numpy integers: the
    index of a prompt held as tensor scalars (which hash by identity)
    finds nothing — the engine's prompts are lists of integers."""
    pool = PORT.pool(64, 8, cache=True)
    view = pool.register_model(PORT.cfg(8), quota=10**6)
    prompt = list(range(1, 2 * BLOCK_TOKENS + 2))
    assert view.append_tokens(0, len(prompt))
    assert view.prefix_index.insert(prompt, view.seqs[0].bases) == 2
    assert view.prefix_index.lookup(list(np.array(prompt)))[0] == 32
    assert view.prefix_index.lookup(list(torch.tensor(prompt)))[0] == 0


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------
CLI_FLAGS = ["--deterministic", "--horizon", "3", "--rate", "4",
             "--mean-prompt", "64", "--chunk-tokens", "16", "--prefix-cache",
             "--prefix-reuse", "0.9"]


def test_cli_prefix_cache_matches_reference(tmp_path, capsys, monkeypatch):
    """The default pair (qwen2-7b + mamba2-2.7b: the SSM view never
    indexes) on a shared-prefix trace: the port's report JSON equals the
    JAX CLI's, its ``prefix`` section included, and both print the
    per-LLM prefix line."""
    out = {}
    for pkg, run in (("jax", jserve.main), ("port", serve.main)):
        rep = tmp_path / f"{pkg}.json"
        args = [*CLI_FLAGS, "--report", str(rep)]
        if pkg == "jax":
            monkeypatch.setattr(sys, "argv", ["serve", *args])
            assert run() == 0
        else:
            assert run([*args, "--device", "cpu"]) == 0
        text = capsys.readouterr().out
        assert "qwen2-7b prefix cache: " in text
        report = json.loads(rep.read_text())
        report.pop("wall_s")
        out[pkg] = json.dumps(report, sort_keys=True)
    assert out["port"] == out["jax"]
    prefix = json.loads(out["port"])["prefix"]
    assert list(prefix) == ["qwen2-7b"] and prefix["qwen2-7b"]["hits"] > 0


@pytest.mark.parametrize("args", [
    ["--prefix-cache", "--chunk-tokens", "0"],
    ["--prefix-reuse", "1.5"],
    ["--prefix-reuse", "-0.1", "--chunk-tokens", "16"],
], ids=["needs-chunks", "reuse-above-one", "reuse-negative"])
def test_cli_prefix_errors_equal_reference(args, capsys, monkeypatch):
    def error_of(run):
        with pytest.raises(SystemExit) as exc:
            run()
        assert exc.value.code == 2
        err = capsys.readouterr().err.strip().splitlines()[-1]
        return err.split("error: ", 1)[1]

    monkeypatch.setattr(sys, "argv", ["serve", *args])
    want = error_of(jserve.main)
    assert error_of(lambda: serve.main([*args, "--device", "cpu"])) == want
