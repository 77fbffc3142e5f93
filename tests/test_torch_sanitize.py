"""The port's runtime invariant sanitizer (``repro_torch/serving/
sanitize.py``) on the port's objects, on the CPU: the sanitizer cases of
the JAX package's ``tests/test_muxlint.py``.

* a clean pool passes, a corrupted refcount-weighted ``used`` or view
  charge is caught, and so is a live block planted on the free list (a
  double free);
* the scheduler's grant algebra catches a phantom grant debt;
* a sanitized run's report equals an unsanitized one, and equals the
  JAX package's sanitized run (the sanitizer is a pure reader);
* a request that vanished from every queue and slot raises.
"""
import numpy as np
import pytest
import torch

from _torch_twins import CPU, report_text, twin_units
from repro.serving import driver as JD
from repro.serving.engine import Request as JRequest
from repro_torch import configs
from repro_torch.config import BLOCK_TOKENS
from repro_torch.serving.driver import (LogicalClock, ServeSession,
                                        TickCostModel, build_unit_from_specs,
                                        serve_requests)
from repro_torch.serving.engine import Request
from repro_torch.serving.kvcache import UnifiedKVPool
from repro_torch.serving.sanitize import (PoolSanitizer, SanitizeError,
                                          SchedulerSanitizer,
                                          sanitize_enabled)

torch.set_num_threads(2)

COST = TickCostModel()
SPECS = [("a", "qwen2-7b", 3.0), ("b", "qwen2-7b", 1.0)]
UNIT = dict(pool_blocks=4_000, max_slots=4, chunk_tokens=16,
            policy="adbs", fused=True)


def _unit(**kw):
    u = build_unit_from_specs(SPECS, seed=0, **UNIT, **CPU, **kw)
    clock = LogicalClock()
    u.clock = clock
    for e in u.engines.values():
        e.clock = clock
    return u


def _requests(cls=Request, n_a=3, n_b=2, plen=16, out=3):
    rng = np.random.default_rng(5)
    reqs = [cls(i, "a", list(rng.integers(1, 500, plen)), out,
                arrival=0.0) for i in range(n_a)]
    reqs += [cls(100 + i, "b", list(rng.integers(1, 500, plen)), out,
                 arrival=0.0) for i in range(n_b)]
    return reqs


def _pool_with_seq(n_tokens):
    pool = UnifiedKVPool(2_048, 64, dtype=torch.float32, device="cpu")
    view = pool.register_model(configs.get_reduced("qwen2-7b"), quota=2_048)
    assert view.append_tokens(0, n_tokens)
    return pool, view


def test_pool_sanitizer_clean_then_corrupted():
    pool, view = _pool_with_seq(BLOCK_TOKENS * 2)
    san = PoolSanitizer(pool)
    san.check("clean")

    pool.allocator.used += 3                     # refcount-weighted law
    with pytest.raises(SanitizeError, match="refcount-weighted"):
        san.check("corrupted")
    pool.allocator.used -= 3
    san.check("restored")

    view.used += 1                               # view charge law
    with pytest.raises(SanitizeError, match="recomputed"):
        san.check("view-corrupted")
    view.used -= 1
    assert san.checks == 4


def test_pool_sanitizer_detects_free_live_overlap():
    pool, view = _pool_with_seq(BLOCK_TOKENS)
    base = view.seqs[0].bases[0]
    # plant a live block on the free list (a double-free would do this)
    pool.allocator._free.insert(0, (base, base + 1))
    with pytest.raises(SanitizeError, match="free and live|covers"):
        PoolSanitizer(pool).check("double-free")


def test_pool_sanitizer_catches_a_short_arena():
    pool, _ = _pool_with_seq(BLOCK_TOKENS)
    pool.k = pool.k[:-1]                         # device arrays ≠ arena
    with pytest.raises(SanitizeError, match="device arrays"):
        PoolSanitizer(pool).check("arena")


def test_scheduler_sanitizer_grant_algebra():
    u = _unit()
    san = SchedulerSanitizer(u)
    assert u.sanitizer is san, "attach installs the fault-report hook"
    san.check("clean")
    u._grant_debt += 5                           # phantom debt
    with pytest.raises(SanitizeError, match="grant algebra"):
        san.check("debt-corrupted")
    u._grant_debt -= 5
    san.check("restored")


def test_scheduler_sanitizer_follows_a_block_loss():
    """``_lose_blocks`` reports the shrink to the attached sanitizer, so
    the grant algebra's base follows the arena."""
    u = _unit()
    san = SchedulerSanitizer(u)
    u._lose_blocks(100)
    san.check("after block loss")
    assert u.pool.n_head_blocks == san.base + u.fused_groups[0] \
        .granted_blocks


def test_session_sanitizer_clean_run_and_parity():
    """A sanitized deterministic run completes with every tick checked
    and gives the unsanitized report — and the JAX package's sanitized
    run's (``wall_s`` reads a real wall clock)."""
    reports = []
    for sanitize in (False, True):
        u = _unit()
        rep = serve_requests([u], _requests(), cost=COST, warm=False,
                             sanitize=sanitize)
        reports.append(report_text(rep))
    assert reports[0] == reports[1], "sanitizer must not perturb scheduling"
    uj, ut = twin_units(SPECS, **UNIT)
    rj = JD.serve_requests([uj], _requests(JRequest), cost=JD.TickCostModel(),
                           warm=False, sanitize=True)
    rt = serve_requests([ut], _requests(), cost=COST, warm=False,
                        sanitize=True)
    assert report_text(rt) == report_text(rj)


def test_session_sanitizer_detects_silently_lost_request():
    u = _unit()
    sess = ServeSession([u], _requests(), cost=COST, warm=False,
                        sanitize=True)
    assert sess.sanitizer is not None
    status, _ = sess.step()                      # submits + first tick
    assert status == "tick"
    # vanish one held request: not finished/shed/cancelled, yet in no
    # queue, slot or preempt buffer — the silent-loss bug class
    for q in u.queues.values():
        if q:
            q.popleft()
            break
    else:
        for eng in u.engines.values():
            for i, r in enumerate(eng.slots):
                if r is not None:
                    eng.slots[i] = None
                    break
    with pytest.raises(SanitizeError, match="SILENTLY LOST"):
        sess.sanitizer.check("after-theft")


def test_sanitize_env_switch(monkeypatch):
    monkeypatch.delenv("MUXSERVE_SANITIZE", raising=False)
    assert not sanitize_enabled()
    monkeypatch.setenv("MUXSERVE_SANITIZE", "0")
    assert not sanitize_enabled()
    monkeypatch.setenv("MUXSERVE_SANITIZE", "1")
    assert sanitize_enabled()
    sess = ServeSession([_unit()], _requests(), cost=COST, warm=False)
    assert sess.sanitizer is not None
