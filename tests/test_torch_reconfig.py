"""Live reconfiguration in the port against the JAX package's, on the
CPU: the 16 tests of ``tests/test_reconfig.py``, each run through both
packages — the port's engines on the JAX package's weights
(``_torch_twins``, float32, TF32 off) — with the port held to the
reference test's assertions and its state held equal to the reference's:

* the drift monitor (EWMA, hysteresis, the eps floor, frozen idle
  windows, windows against the caller's clock): every estimate, the
  trigger and the window count equal;
* KV migration: post-migration decode logits bit for bit equal to an
  unmigrated twin's in the port, fused and serial, and with shared
  prefix blocks; tokens, block tables, allocator state and prefix-index
  entries equal to the reference's with ``==``; pages copied exactly;
  prefill-phase requests requeued, a move to a full pool skipped;
* fused-group dissolve and rebuild returning and re-growing the grant;
* the re-planner, a share-only re-plan, and the controller end to end
  on a regime-shift trace: ``ReconfigSummary``, events and the whole
  report equal to the reference's as canonical JSON apart from
  ``wall_s``.

Two tests of other reference files that need the executor join them: a
``migration_abort`` re-homing the engine (``tests/test_faults.py``) and
the wall clock's analytic references under reconfiguration
(``tests/test_sm_frac.py``).
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_twins import placement_trees, report_text, twin_units
from repro import configs as jconfigs
from repro.config import replace as jreplace
from repro.core.estimator import LLMSpec as JSpec
from repro.core.placement import Mesh as JMesh
from repro.core.placement import Placement as JPlacement
from repro.core.placement import place_onto_meshes as jplace_onto
from repro.core.workload import piecewise_poisson_trace as jshift_trace
from repro.serving import driver as JD
from repro.serving import faults as JF
from repro.serving import kvcache as JK
from repro.serving import reconfig as JR
from repro.serving.engine import Request as JRequest
from repro.serving.engine import _next_pow2 as j_next_pow2
from repro.serving.engine import _pad_rows as j_pad_rows
from repro_torch import configs as tconfigs
from repro_torch.config import replace as treplace
from repro_torch.core.estimator import LLMSpec as TSpec
from repro_torch.core.placement import Mesh as TMesh
from repro_torch.core.placement import Placement as TPlacement
from repro_torch.core.placement import place_onto_meshes as tplace_onto
from repro_torch.core.workload import piecewise_poisson_trace as tshift_trace
from repro_torch.serving import driver as TD
from repro_torch.serving import faults as TF
from repro_torch.serving import kvcache as TK
from repro_torch.serving import reconfig as TR
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import _next_pow2, _pad_rows

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

JAX = SimpleNamespace(name="jax", R=JR, K=JK, D=JD, F=JF, Request=JRequest,
                      configs=jconfigs, replace=jreplace, Spec=JSpec,
                      Mesh=JMesh, Placement=JPlacement,
                      place_onto=jplace_onto, trace=jshift_trace)
PORT = SimpleNamespace(name="port", R=TR, K=TK, D=TD, F=TF,
                       Request=TRequest,
                       configs=tconfigs, replace=treplace, Spec=TSpec,
                       Mesh=TMesh, Placement=TPlacement,
                       place_onto=tplace_onto, trace=tshift_trace)
PKGS = (JAX, PORT)


def _ints(xs):
    return list(map(int, xs))


# ---------------------------------------------------------------------------
# drift monitor
# ---------------------------------------------------------------------------
def _monitor_state(mon):
    return (dict(mon.rate_ewma), dict(mon.token_ewma), dict(mon.planned),
            mon.triggered(), mon.max_drift(), mon.windows_closed)


def test_monitor_ewma_and_hysteresis():
    seen = {}
    for pkg in PKGS:
        mon = pkg.R.WorkloadMonitor({"a": 4.0, "b": 1.0}, interval=1.0,
                                    alpha=0.5, threshold=2.0, sustain=2,
                                    eps=1.0)
        trail = []
        for _ in range(4):
            mon.observe("a", tokens=10)
        mon.observe("b")
        assert mon.advance(1.0) == 1
        assert mon.rate_ewma["a"] == pytest.approx(4.0)
        assert not mon.triggered()
        trail.append(_monitor_state(mon))
        # one window above threshold must NOT trigger, the second must
        for _ in range(16):
            mon.observe("a")
        assert mon.advance(2.0) == 1
        assert not mon.triggered(), "one window above threshold must not arm"
        trail.append(_monitor_state(mon))
        for _ in range(16):
            mon.observe("a")
        mon.advance(3.0)
        assert mon.triggered()
        assert mon.max_drift() > 2.0
        trail.append(_monitor_state(mon))
        mon.rebase(dict(mon.rate_ewma))
        assert not mon.triggered()
        assert mon.token_ewma["a"] > 0
        trail.append(_monitor_state(mon))
        seen[pkg.name] = trail
    assert seen["port"] == seen["jax"]


def test_monitor_eps_floor_masks_sparse_noise():
    seen = {}
    for pkg in PKGS:
        mon = pkg.R.WorkloadMonitor({"cold": 0.5, "busy": 4.0},
                                    interval=0.5, threshold=2.0, sustain=2,
                                    eps=1.0)
        for w in range(1, 11):
            for _ in range(2):             # busy keeps its planned rate
                mon.observe("busy")
            mon.advance(0.5 * w)
        assert mon.rate_ewma["cold"] < 0.01
        assert not mon.triggered()
        seen[pkg.name] = _monitor_state(mon)
    assert seen["port"] == seen["jax"]


def test_monitor_idle_windows_frozen():
    seen = {}
    for pkg in PKGS:
        mon = pkg.R.WorkloadMonitor({"a": 4.0, "b": 1.0}, interval=0.5,
                                    threshold=2.0, sustain=2, eps=1.0)
        assert mon.advance(10.0) == 20     # long idle gap
        assert mon.rate_ewma == {"a": 4.0, "b": 1.0}, "EWMAs frozen"
        assert not mon.triggered()
        mon.observe("a")                   # traffic resumes
        mon.advance(10.5)
        assert mon.rate_ewma["a"] != 4.0
        seen[pkg.name] = _monitor_state(mon)
    assert seen["port"] == seen["jax"]


def test_monitor_windows_close_against_callers_clock():
    for pkg in PKGS:
        mon = pkg.R.WorkloadMonitor({"a": 1.0}, interval=0.25)
        assert mon.advance(0.2) == 0
        assert mon.advance(1.0) == 4
        assert mon.windows_closed == 4


# ---------------------------------------------------------------------------
# KV migration: bit-identical continuation
# ---------------------------------------------------------------------------
SPECS_A = [("m0", "qwen2-7b", 2.0), ("m1", "qwen2-7b", 1.0)]
SPECS_B = [("m2", "qwen2-7b", 1.0)]


def _twin_units(fused: bool, prefix_cache: bool = False):
    """{package name: (uA, uB)}: the reference test's two units in both
    packages, each package's pair on one logical clock."""
    kw = dict(pool_blocks=6_000, max_slots=4, chunk_tokens=16,
              policy="adbs", fused=fused, prefix_cache=prefix_cache)
    a = twin_units(SPECS_A, seed=0, **kw)
    b = twin_units(SPECS_B, seed=7, **kw)
    out = {}
    for pkg, uA, uB in zip(PKGS, a, b):
        clock = pkg.D.LogicalClock()
        for u in (uA, uB):
            u.clock = clock
            for e in u.engines.values():
                e.clock = clock
        out[pkg.name] = (uA, uB)
    return out


def _requests(pkg):
    rng = np.random.default_rng(3)
    return ([pkg.Request(i, "m1", list(rng.integers(1, 500, 24)), 8)
             for i in range(3)]
            + [pkg.Request(10 + i, "m0", list(rng.integers(1, 500, 20)), 6)
               for i in range(2)])


def _decode_logits(pkg, eng):
    """Run the engine's decode step WITHOUT committing it, on a copy of
    the pool (the steps write the new token's KV) — the probe for
    bit-identical post-migration logits."""
    job = eng.export_decode_job()
    assert job is not None
    B = len(job)
    lens = eng.view.seq_lens(job.seq_ids)
    table = eng.view.block_table(job.seq_ids, eng.max_blocks)
    last_tok = job.last_tok
    if pkg is JAX:
        Bp = j_next_pow2(B)
        if Bp != B:
            last_tok, lens, table = j_pad_rows(
                Bp, (job.last_tok, 0), (lens, 1), (table, -1))
        _, _, logits, _, _ = eng._decode_fn(
            eng.params, eng.model_index, jnp.asarray(last_tok),
            jnp.asarray(lens), eng.pool.k + 0, eng.pool.v + 0,
            jnp.asarray(table), None, None)
        return np.asarray(logits[:B])
    Bp = _next_pow2(B)
    if Bp != B:
        last_tok, lens, table = _pad_rows(
            Bp, (job.last_tok, 0), (lens, 1), (table, -1))
    pool = SimpleNamespace(k=eng.pool.k.clone(), v=eng.pool.v.clone(),
                           device=eng.pool.device,
                           block_tokens=eng.pool.block_tokens)
    logits = eng._decode_fn(eng.params, eng.model_index, last_tok, lens,
                            pool, table)
    return logits[:B].numpy()


def _migrate_m1(pkg, uA, uB):
    eng, queued = uA.remove_engine("m1")
    evicted = eng.evict_prefilling()
    view, blocks = pkg.K.migrate_view(eng.view, uB.pool,
                                      quota=eng.view.used)
    eng.rebind_view(view)
    uB.add_engine("m1", eng, list(evicted) + list(queued))
    return blocks


def _pool_state(pool):
    """Everything the pool's host bookkeeping holds, as plain values."""
    a = pool.allocator
    views = {}
    for n, v in pool.views.items():
        idx = v.prefix_index
        views[n] = dict(
            quota=v.quota, used=v.used,
            seqs={s: (_ints(c.bases), c.n_tokens, c.shared)
                  for s, c in v.seqs.items()},
            index=None if idx is None else (idx.entries(), idx.stats()))
    return dict(free=a.free_ranges(), refs=a.refcounts(), used=a.used,
                physical=a.physical_used, n_blocks=pool.n_head_blocks,
                views=views)


def _drain(*units, ticks=600):
    for _ in range(ticks):
        if not sum(u.pending() for u in units):
            return
        for u in units:
            if u.pending():
                u.tick()
    raise AssertionError("units did not drain")


def _outputs(*units):
    return {r.req_id: _ints(r.output) for u in units
            for r in u.stats.finished}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "serial"])
def test_migrated_decode_bit_identical(fused):
    """A decode continued after KV migration gives the unmigrated twin's
    logits bit for bit in the port (the page copy is exact, block tables
    re-resolve from the new pool), and the port's tokens, tables and
    allocator state equal the reference's."""
    seen = {}
    refs, migs = _twin_units(fused), _twin_units(fused)
    for pkg in PKGS:
        uA_ref, uB_ref = refs[pkg.name]
        for r in _requests(pkg):
            uA_ref.submit(r)
        for _ in range(6):
            uA_ref.tick()
        ref_logits = _decode_logits(pkg, uA_ref.engines["m1"])

        uA, uB = migs[pkg.name]
        reqs = _requests(pkg)
        for r in reqs:
            uA.submit(r)
        for _ in range(6):
            uA.tick()
        blocks = _migrate_m1(pkg, uA, uB)
        assert blocks > 0, "mid-decode migration must carry live KV pages"
        moved = (_pool_state(uA.pool), _pool_state(uB.pool))
        mig_logits = _decode_logits(pkg, uB.engines["m1"])
        assert np.array_equal(ref_logits, mig_logits), \
            "post-migration logits must be bit-identical"
        _drain(uA, uB, uA_ref, uB_ref)
        ref_out, mig_out = _outputs(uA_ref), _outputs(uA, uB)
        assert set(ref_out) == set(mig_out) == {r.req_id for r in reqs}
        assert ref_out == mig_out
        seen[pkg.name] = (blocks, moved, mig_out, mig_logits)
    assert seen["port"][:3] == seen["jax"][:3]
    np.testing.assert_allclose(seen["port"][3], seen["jax"][3],
                               rtol=2e-5, atol=2e-5)


def test_migrate_view_copies_pages_and_frees_source():
    seen = {}
    units = _twin_units(fused=False)
    for pkg in PKGS:
        uA, uB = units[pkg.name]
        eng = uA.engines["m1"]
        for r in _requests(pkg):
            uA.submit(r)
        for _ in range(6):
            uA.tick()
        src_pool = eng.pool
        seqs_before = {sid: (list(sc.bases), sc.n_tokens)
                       for sid, sc in eng.view.seqs.items()}
        assert seqs_before
        src_used = eng.view.used
        gs = eng.view.group_size
        src_pages = {
            sid: np.concatenate([np.asarray(src_pool.k[b:b + gs])
                                 for b in bases])
            for sid, (bases, _) in seqs_before.items()}
        view, blocks = pkg.K.migrate_view(eng.view, uB.pool, quota=src_used)
        eng.rebind_view(view)
        assert blocks == sum(len(b) for b, _ in seqs_before.values()) * gs
        for sid, (_bases, n_tokens) in seqs_before.items():
            assert view.seqs[sid].n_tokens == n_tokens
            dst = np.concatenate([np.asarray(uB.pool.k[b:b + gs])
                                  for b in view.seqs[sid].bases])
            assert np.array_equal(src_pages[sid], dst)
        assert view.used == src_used
        assert "m1" not in src_pool.views
        assert src_pool.used_by.get("m1") is None
        if pkg is PORT:
            assert uB.pool.k.data_ptr() == uB.pool._k_buf.data_ptr(), \
                "the copy must land in the destination arena's buffer"
        seen[pkg.name] = (blocks, _pool_state(src_pool),
                          _pool_state(uB.pool), src_pages)
    assert seen["port"][:3] == seen["jax"][:3]
    for sid, pages in seen["jax"][3].items():
        np.testing.assert_allclose(seen["port"][3][sid], pages,
                                   rtol=2e-5, atol=2e-5)


def test_prefilling_requests_requeue_not_carry():
    """Drain-or-carry: a request still in its prompt chunks at migration
    time is evicted (with a ``reset`` emitted), requeued at the
    destination and restarted exactly."""
    seen = {}
    refs, migs = _twin_units(fused=False), _twin_units(fused=False)
    for pkg in PKGS:
        uA_ref, _ = refs[pkg.name]
        for r in _requests(pkg):
            uA_ref.submit(r)
        uA_ref.tick()
        uA, uB = migs[pkg.name]
        reqs = _requests(pkg)
        for r in reqs:
            uA.submit(r)
        eng = uA.engines["m1"]
        for _ in range(4):
            uA.tick()
            if eng.has_prefill_work():
                break
        assert eng.has_prefill_work(), "ticks must leave m1 chunks in flight"
        n_prefilling = len(eng._prefilling)
        eng2, queued = uA.remove_engine("m1")
        resets = []
        eng2.emit = lambda kind, r, tok: resets.append((kind, r.req_id, tok))
        evicted = eng2.evict_prefilling()
        assert len(evicted) == n_prefilling and evicted
        for r in evicted:
            assert r.prefill_done < 0 and r.first_token < 0 and not r.output
        view, blocks = pkg.K.migrate_view(eng2.view, uB.pool,
                                          quota=eng2.view.used)
        eng2.rebind_view(view)
        uB.add_engine("m1", eng2, list(evicted) + list(queued))
        _drain(uA, uB, uA_ref)
        ref_out, mig_out = _outputs(uA_ref), _outputs(uA, uB)
        assert set(mig_out) == {r.req_id for r in reqs}, "zero drops"
        assert ref_out == mig_out, "restarted prefills are exact under greedy"
        seen[pkg.name] = ([r.req_id for r in evicted], blocks, resets,
                          mig_out)
    assert seen["port"] == seen["jax"]
    assert [k for k, _, _ in seen["port"][2]] == ["reset"] * len(
        seen["port"][0])


def test_move_skipped_when_destination_full():
    """A move whose destination pool cannot hold the live KV is skipped
    whole: the engine never detaches, nothing is dropped, and the plan
    records the spec back at its source mesh."""
    seen = {}
    units = _twin_units(fused=False)
    for pkg in PKGS:
        uA, uB = units[pkg.name]
        for r in _requests(pkg):
            uA.submit(r)
        for _ in range(6):
            uA.tick()
        hog = uB.pool.allocator.alloc(uB.pool.allocator.free_blocks)
        assert uB.pool.allocator.free_blocks == 0
        uA.mesh_id, uB.mesh_id = 0, 1
        ex = pkg.R.MigrationExecutor({0: uA, 1: uB})
        pl = _shift_placement(pkg)
        stats = ex.execute([("m1", 0, 1)], pl)
        assert stats["executed"] == [] and stats["skipped"] == [("m1", 0, 1)]
        assert "m1" in uA.engines and "m1" not in uB.engines
        uB.pool.allocator.free(hog, uB.pool.n_head_blocks)
        _drain(uA)
        assert len(uA.stats.finished) == len(_requests(pkg))
        seen[pkg.name] = (stats, _plan(pl), _outputs(uA))
    assert seen["port"] == seen["jax"]


def test_migration_abort_rehomes_engine():
    """(``tests/test_faults.py``) An injected ``migration_abort`` re-homes
    the engine on its source unit through the fragmentation-rollback
    path: nothing detaches, evicted prefills are requeued with a retry
    mark, the plan records the spec back at the source mesh, and every
    request still finishes — as in the reference."""
    seen = {}
    units = _twin_units(fused=False)
    for pkg in PKGS:
        uA, uB = units[pkg.name]
        reqs = _requests(pkg)
        for r in reqs:
            uA.submit(r)
        for _ in range(2):
            uA.tick()
            uA.clock.advance(0.005)
        uA.mesh_id, uB.mesh_id = 0, 1
        ex = pkg.R.MigrationExecutor({0: uA, 1: uB})
        ex.injector = pkg.F.FaultInjector(
            pkg.F.FaultPlan.parse("migration_abort@0.0"))
        cfg = pkg.configs.get("qwen2-7b")

        def spec(name, rate, pkg=pkg, cfg=cfg):
            return pkg.Spec(pkg.replace(cfg, name=name), rate,
                            mean_prompt=24, mean_output=8, tp=1, sm_frac=1.0,
                            arch="qwen2-7b")
        new_pl = pkg.Placement([pkg.Mesh(0, 2, [spec("m0", 2.0)]),
                                pkg.Mesh(1, 2, [spec("m2", 1.0),
                                                spec("m1", 1.0)])], 4.0)
        prefilling = len(uA.engines["m1"]._prefilling)
        stats = ex.execute([("m1", 0, 1)], new_pl, now=uA.clock())
        assert stats["executed"] == [] and stats["skipped"] == [("m1", 0, 1)]
        assert "m1" in uA.engines and "m1" not in uB.engines
        assert ex.injector.records[0]["kind"] == "migration_abort"
        assert pkg.R.assignment_of(new_pl)["m1"] == 0, \
            "spec must return to the source mesh"
        retried = sorted(r.req_id for r in reqs if r.requeues)
        assert len(retried) == prefilling
        _drain(uA)
        assert set(_outputs(uA)) == {r.req_id for r in reqs}
        seen[pkg.name] = (stats, _plan(new_pl), retried, _outputs(uA),
                          _pool_state(uA.pool), _pool_state(uB.pool))
    assert seen["port"] == seen["jax"]


def test_realtime_accepts_reconfig_with_analytic_refs():
    """(``tests/test_sm_frac.py``) Under the wall clock a reconfiguring
    session takes analytic SLO references at the owning mesh's size (no
    solo probes): equal to the reference's, and cheaper on the wider
    mesh."""
    refs = {}
    for pkg in PKGS:
        pl = _shift_placement(pkg)
        kw = dict(pool_blocks=12_000, max_slots=2, chunk_tokens=16)
        units = (TD.units_from_placement(pl, params=placement_trees(pl, 0),
                                         dtype=torch.float32, device="cpu",
                                         **kw)
                 if pkg is PORT else JD.units_from_placement(pl, **kw))
        ctrl = pkg.R.ReconfigController(pl, units)
        sess = pkg.D.ServeSession(units, [], cost=None, warm=False,
                                  reconfig=ctrl)
        refs[pkg.name] = [sess.ref_fn(n, 64, 8) for n in ("llm0", "llm2")]
        rep = pkg.D.serve_requests(units, [], cost=None, warm=False,
                                   reconfig=ctrl)
        assert not rep.deterministic and rep.aggregate.submitted == 0
    assert refs["port"] == refs["jax"]
    assert refs["port"][0] < refs["port"][1], "mesh 0 has 4 devices, mesh 1 one"


# ---------------------------------------------------------------------------
# fused-group dissolve/rebuild pool accounting
# ---------------------------------------------------------------------------
def test_group_dissolve_returns_pool_grant():
    seen = {}
    specs = [("g0", "qwen2-7b", 1.0), ("g1", "qwen2-7b", 1.0)]
    for pkg, u in zip(PKGS, twin_units(specs, seed=0, pool_blocks=6_000,
                                       max_slots=2, chunk_tokens=16,
                                       policy="adbs", fused=True)):
        assert len(u.fused_groups) == 1
        grp = u.fused_groups[0]
        granted = grp.granted_blocks
        assert granted > 0
        assert u.pool.n_head_blocks == 6_000 + granted
        eng, _ = u.remove_engine("g1")
        assert not u.fused_groups
        assert u.pool.n_head_blocks == 6_000
        assert u.reclaimed_weight_bytes == 0
        assert eng.params["tok"]["embed"].shape[0] == 1
        assert eng.model_index == 0
        u.add_engine("g1", eng)
        assert len(u.fused_groups) == 1
        assert u.pool.n_head_blocks == 6_000 + u.fused_groups[0].granted_blocks
        seen[pkg.name] = (granted, u.fused_groups[0].granted_blocks,
                          _pool_state(u.pool))
    assert seen["port"] == seen["jax"]


# ---------------------------------------------------------------------------
# re-planner + controller end-to-end
# ---------------------------------------------------------------------------
def _shift_placement(pkg):
    cfg = pkg.configs.get("qwen2-7b")

    def spec(name, rate):
        return pkg.Spec(pkg.replace(cfg, name=name), rate, mean_prompt=16,
                        mean_output=6, tp=1, sm_frac=1.0, arch="qwen2-7b")

    return pkg.Placement(
        meshes=[pkg.Mesh(0, 4, [spec("llm0", 12.0), spec("llm1", 2.0)]),
                pkg.Mesh(1, 1, [spec("llm2", 0.5)])],
        total_tpt=14.5)


def _plan(pl):
    return ([(m.mesh_id, m.n_devices,
              [(s.name, s.rate, s.tp, s.sm_frac, s.arch_id)
               for s in m.specs]) for m in pl.meshes], pl.total_tpt)


def test_place_onto_meshes_tracks_rates():
    seen = {}
    for pkg in PKGS:
        pl = _shift_placement(pkg)
        models_pre = [(s.cfg, s.rate) for m in pl.meshes for s in m.specs]
        mesh_sizes = [(m.mesh_id, m.n_devices) for m in pl.meshes]
        pre = pkg.place_onto(models_pre, mesh_sizes, mean_prompt=16,
                             mean_output=6)
        assert pkg.R.assignment_of(pre)["llm0"] == 0
        post_rates = {"llm0": 0.5, "llm1": 2.0, "llm2": 12.0}
        models_post = [(s.cfg, post_rates[s.name])
                       for m in pl.meshes for s in m.specs]
        post = pkg.place_onto(models_post, mesh_sizes, mean_prompt=16,
                              mean_output=6)
        assert pkg.R.assignment_of(post)["llm2"] == 0
        moves = pkg.R.diff_placements(pre, post)
        assert any(n == "llm2" and dst == 0 for n, _, dst in moves)
        seen[pkg.name] = (_plan(pre), _plan(post), moves,
                          pkg.R.shares_of(post))
    assert seen["port"] == seen["jax"]


def _serve_shift(pkg, reconfig: bool, horizon=2.4, sanitize=False):
    pl = _shift_placement(pkg)
    wl = pkg.trace(
        [(0.0, {"llm0": 12.0, "llm1": 2.0, "llm2": 0.5}),
         (horizon / 2, {"llm0": 0.5, "llm1": 2.0, "llm2": 12.0})],
        horizon, seed=0, mean_prompt=16, mean_output=6, max_len=128)
    kw = dict(pool_blocks=12_000, max_slots=4, chunk_tokens=16, seed=0,
              policy="adbs", fused=True)
    if pkg is PORT:
        units = TD.units_from_placement(pl, params=placement_trees(pl, 0),
                                        dtype=torch.float32, device="cpu",
                                        **kw)
    else:
        units = JD.units_from_placement(pl, **kw)
    ctrl = None
    if reconfig:
        ctrl = pkg.R.ReconfigController(
            pl, units, interval=0.2, drift_threshold=2.0, sustain=2,
            migration_cost=pkg.R.MigrationCostModel())
    extra = {"sanitize": sanitize} if sanitize else {}
    rep = pkg.D.serve_workload(units, wl, seed=1, slo_scales=(2.0, 4.0, 8.0),
                               cost=pkg.D.TickCostModel(), reconfig=ctrl,
                               **extra)
    return wl, rep


@pytest.fixture(scope="module")
def shift_runs():
    """The shift trace served with and without reconfiguration by both
    packages (the port's reconfig run under the sanitizer), and a
    second port reconfig run."""
    return {(pkg.name, r): _serve_shift(pkg, r, sanitize=(pkg is PORT))
            for pkg in PKGS for r in (True, False)} | {
        ("port", "again"): _serve_shift(PORT, True)}


def test_controller_end_to_end_zero_drops_and_events(shift_runs):
    wl, rep = shift_runs[("port", True)]
    assert rep.aggregate.finished == rep.aggregate.submitted \
        == len(wl.requests), "migration must not drop requests"
    assert rep.reconfig is not None and rep.reconfig.events >= 1
    assert rep.reconfig.moves >= 1, "the flip must move an engine"
    assert rep.reconfig.stall_ticks > 0
    assert rep.reconfig.dt_charged > 0
    assert set(rep.planned_rates) == {"llm0", "llm1", "llm2"}
    assert rep.planned_rates["llm0"] == 12.0
    assert rep.rate_estimates["llm2"] > rep.planned_rates["llm2"]
    ev = rep.reconfig.log[0]
    assert set(ev) >= {"t", "drift", "moves", "migrated_blocks",
                       "requeued", "quota_moved", "dt_charged",
                       "stall_ticks"}
    ref = shift_runs[("jax", True)][1]
    assert rep.reconfig.to_json() == ref.reconfig.to_json()
    assert all(e["token_estimates"] for e in rep.reconfig.log)
    assert report_text(rep) == report_text(ref)
    assert "reconfig: " in rep.summary()
    assert rep.summary() == ref.summary()


def test_controller_deterministic_reproducible(shift_runs):
    a, b = shift_runs[("port", True)][1], shift_runs[("port", "again")][1]
    assert a.horizon == b.horizon and a.ticks == b.ticks
    assert a.aggregate.attainment == b.aggregate.attainment
    assert a.aggregate.e2e == b.aggregate.e2e
    assert a.reconfig.to_json() == b.reconfig.to_json()
    assert a.rate_estimates == b.rate_estimates


def test_share_only_replan_executes():
    """A re-plan that changes ONLY sm_frac diffs to an empty move schedule
    and still executes: the executor applies the new shares."""
    from dataclasses import replace as dc_replace

    seen = {}
    for pkg in PKGS:
        pl = _shift_placement(pkg)
        for m in pl.meshes:
            for s in m.specs:
                s.sm_frac = 0.5
        kw = dict(pool_blocks=12_000, max_slots=2, chunk_tokens=16, seed=0,
                  policy="adbs", fused=True)
        if pkg is PORT:
            units = TD.units_from_placement(
                pl, params=placement_trees(pl, 0), dtype=torch.float32,
                device="cpu", **kw)
        else:
            units = JD.units_from_placement(pl, **kw)
        ex = pkg.R.MigrationExecutor({u.mesh_id: u for u in units})
        new_pl = pkg.Placement(
            [pkg.Mesh(m.mesh_id, m.n_devices,
                      [dc_replace(s, sm_frac=0.2 if s.name == "llm0"
                                  else s.sm_frac) for s in m.specs])
             for m in pl.meshes], pl.total_tpt)
        assert pkg.R.diff_placements(pl, new_pl) == []
        stats = ex.execute([], new_pl)
        assert stats["share_moved"] == pytest.approx(0.3)
        assert units[0].sm_frac["llm0"] == pytest.approx(0.2)
        assert pkg.R.shares_of(new_pl)["llm0"] == pytest.approx(0.2)
        again = ex.execute([], new_pl)
        assert again["share_moved"] == 0.0
        seen[pkg.name] = (stats, again, [dict(u.sm_frac) for u in units],
                          [_pool_state(u.pool) for u in units])
    assert seen["port"] == seen["jax"]


def test_static_report_still_exposes_estimates(shift_runs):
    wl, rep = shift_runs[("port", False)]
    assert rep.reconfig is None
    assert rep.planned_rates and rep.rate_estimates
    assert rep.rate_estimates["llm2"] > 2.0, \
        "the post-flip surge must show in the EWMA estimates"
    assert "rates est(plan)" in rep.summary()
    assert report_text(rep) == report_text(shift_runs[("jax", False)][1])


# ---------------------------------------------------------------------------
# migration × prefix sharing
# ---------------------------------------------------------------------------
def _shared_history(pkg, uA):
    """Donor populates m1's prefix index, then two sharers adopt the
    cached blocks and sit mid-decode."""
    rng = np.random.default_rng(21)
    pref = list(rng.integers(1, 500, 32))            # 2 full blocks
    uA.submit(pkg.Request(0, "m1", pref + [3, 3, 3, 3], 4))
    _drain(uA, ticks=200)
    sharers = [pkg.Request(1 + i, "m1",
                           pref + list(rng.integers(1, 500, 8)), 8)
               for i in range(2)]
    for r in sharers:
        uA.submit(r)
    for _ in range(6):
        uA.tick()
    return sharers


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "serial"])
def test_migrated_shared_prefix_bit_identical(fused):
    """Migrating a view with shared prefix blocks rebuilds the refcounts
    and the prefix index on the destination (distinct groups copied
    once, cache-only entries dropped) and the carried decode stays bit
    for bit equal to the unmigrated twin's in the port; the port's
    tables, refcounts, index entries and tokens equal the reference's."""
    seen = {}
    refs = _twin_units(fused, prefix_cache=True)
    migs = _twin_units(fused, prefix_cache=True)
    for pkg in PKGS:
        uA_ref, _ = refs[pkg.name]
        _shared_history(pkg, uA_ref)
        ref_logits = _decode_logits(pkg, uA_ref.engines["m1"])

        uA, uB = migs[pkg.name]
        sharers = _shared_history(pkg, uA)
        src_view = uA.engines["m1"].view
        src_alloc = uA.pool.allocator
        shared_bases = list(src_view.seqs[sharers[0]._seq_id].bases[:2])
        assert src_view.seqs[sharers[0]._seq_id].shared == 2
        assert src_view.seqs[sharers[1]._seq_id].bases[:2] == shared_bases
        assert all(src_alloc.refcount(b) == 3 for b in shared_bases)
        n_entries = len(src_view.prefix_index)
        assert n_entries == 2

        blocks = _migrate_m1(pkg, uA, uB)
        dst_view = uB.pool.views["m1"]
        gs = dst_view.group_size
        uniq = {b for sc in dst_view.seqs.values() for b in sc.bases}
        assert blocks == len(uniq) * gs, \
            "shared groups must be copied once, not once per sharer"
        new_shared = dst_view.seqs[sharers[0]._seq_id].bases[:2]
        assert dst_view.seqs[sharers[1]._seq_id].bases[:2] == new_shared
        assert dst_view.seqs[sharers[0]._seq_id].shared == 2
        assert len(dst_view.prefix_index) == n_entries
        assert {b for _, (b, _) in dst_view.prefix_index.entries()} \
            == set(new_shared)
        assert all(uB.pool.allocator.refcount(b) == 3 for b in new_shared)
        assert dst_view.used == sum(len(sc.bases) * gs
                                    for sc in dst_view.seqs.values())
        moved = (_pool_state(uA.pool), _pool_state(uB.pool))
        mig_logits = _decode_logits(pkg, uB.engines["m1"])
        assert np.array_equal(ref_logits, mig_logits), \
            "post-migration shared-prefix logits must be bit-identical"
        _drain(uA, uB, uA_ref)
        ref_out, mig_out = _outputs(uA_ref), _outputs(uA, uB)
        assert ref_out == mig_out and set(mig_out) == {0, 1, 2}
        seen[pkg.name] = (blocks, moved, mig_out)
    assert seen["port"] == seen["jax"]


def test_migrate_drops_cache_only_entries():
    """Index entries no live sequence shares are not migrated; the
    source's refs are released with the view."""
    seen = {}
    units = _twin_units(fused=False, prefix_cache=True)
    for pkg in PKGS:
        uA, uB = units[pkg.name]
        rng = np.random.default_rng(22)
        pref = list(rng.integers(1, 500, 32))
        uA.submit(pkg.Request(0, "m1", pref + [3, 3, 3, 3], 4))
        _drain(uA, ticks=200)
        src_view = uA.engines["m1"].view
        assert len(src_view.prefix_index) == 2 and not src_view.seqs
        blocks = _migrate_m1(pkg, uA, uB)
        assert blocks == 0, "cache-only inventory must not be copied"
        dst_view = uB.pool.views["m1"]
        assert len(dst_view.prefix_index) == 0
        assert uB.pool.allocator.used \
            == sum(v.used for v in uB.pool.views.values())
        seen[pkg.name] = (_pool_state(uA.pool), _pool_state(uB.pool))
    assert seen["port"] == seen["jax"]
