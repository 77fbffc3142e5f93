"""Runtime invariant sanitizer (port of ``repro/serving/sanitize.py``).

Enable it (``serve.py --sanitize``, ``sanitize=True`` on the driver or
``MUXSERVE_SANITIZE=1``) and every serving tick re-validates the
conservation laws of the unified pool and the serving loop, raising
``SanitizeError`` with the first violated law *at the tick that broke
it*.  It reads pool and scheduler state by attribute, as the JAX
package's does, so the code is that module's.

Checked laws, bottom-up:

* allocator — every live head-block has refcount ≥ 1; ``used`` equals
  the refcount-weighted sum over live blocks; ``physical_used`` counts
  distinct live blocks; the free list is sorted, coalesced, in-bounds
  and disjoint from the live set; free + live covers the arena exactly.
* pool/views — each view's ``used`` equals the recomputed charge of its
  sequences (group blocks + SSM state units + shared-prefix full
  charge); ``pool.used_by`` mirrors it; the allocator's ``used`` equals
  the sum of all holders (sequence charges + prefix-index refs); every
  sequence base and every prefix-index entry points at a live group;
  the device arrays match the arena size.
* scheduler — the zero-copy grant algebra: ``n_head_blocks == base +
  Σ granted + debt``, with ``base`` adjusted when a block-loss fault
  shrinks the arena (``note_blocks_lost``, wired in
  ``MuxScheduler._lose_blocks``); engine slots and pool views agree on
  the live sequence set.
* session — the disposition law: every submitted request is, at every
  tick, in exactly ONE of {finished, shed, cancelled, held}, and a held
  request is findable in a queue, a slot or a preempt buffer —
  ``submitted = finished + shed + cancelled`` at drain is its limit.

The sanitizer is a pure reader of host state (no device reads): a
sanitized run is bit-identical to an unsanitized one.
"""
from __future__ import annotations

import bisect
import os
from typing import Dict, List

__all__ = ["SanitizeError", "PoolSanitizer", "SchedulerSanitizer",
           "SessionSanitizer", "allocator_errors", "pool_errors",
           "sanitize_enabled"]


class SanitizeError(AssertionError):
    """A runtime invariant was violated.  The message lists every law
    broken at the failing check point, with the numbers that broke it."""


def sanitize_enabled() -> bool:
    """Environment override: ``MUXSERVE_SANITIZE=1`` arms the sanitizer
    in any driver entry point without touching call sites."""
    return os.environ.get("MUXSERVE_SANITIZE", "") not in ("", "0")


# ---------------------------------------------------------------------------
# allocator / pool (kvcache.py)
# ---------------------------------------------------------------------------
def allocator_errors(alloc) -> List[str]:
    """Conservation laws of one ``BlockAllocator``."""
    errs: List[str] = []
    refs = alloc.refcounts()
    bad = {b: r for b, r in refs.items() if r < 1}
    if bad:
        errs.append(f"live blocks with refcount < 1: {bad}")
    if alloc.physical_used != len(refs):
        errs.append(f"physical_used={alloc.physical_used} != "
                    f"{len(refs)} distinct live blocks")
    weighted = sum(refs.values())
    if alloc.used != weighted:
        errs.append(f"used={alloc.used} != refcount-weighted sum "
                    f"{weighted} over live blocks")
    free = alloc.free_ranges()
    prev_end = -1
    covered = 0
    for s, e in free:
        if not (0 <= s < e <= alloc.n_blocks):
            errs.append(f"free range [{s},{e}) out of arena "
                        f"[0,{alloc.n_blocks})")
        if s <= prev_end:
            errs.append(f"free list unsorted/uncoalesced at [{s},{e}) "
                        f"after end {prev_end}")
        prev_end = e
        covered += e - s
    # disjointness: walk the LIVE blocks (few) against the sorted free
    # ranges, not the free space (arena-sized) against the live set
    starts = [s for s, _ in free]
    overlap = []
    for b in refs:
        i = bisect.bisect_right(starts, b) - 1
        if i >= 0 and free[i][0] <= b < free[i][1]:
            overlap.append(b)
            if len(overlap) > 8:
                break
    if overlap:
        errs.append(f"blocks both free and live: {sorted(overlap)[:8]}"
                    f"{'…' if len(overlap) > 8 else ''}")
    if covered != alloc.n_blocks - len(refs):
        errs.append(f"free list covers {covered} blocks, expected "
                    f"{alloc.n_blocks - len(refs)} "
                    f"(arena {alloc.n_blocks} − live {len(refs)}) — "
                    f"blocks leaked or minted")
    return errs


def _view_charge(view) -> int:
    """Recompute what the view's sequences should be charged: group
    blocks per token-block (shared prefixes at FULL charge — the
    DESIGN.md §13 copy-on-write policy) plus the SSM state footprint."""
    charge = sum(len(sc.bases) for sc in view.seqs.values())\
        * view.group_size
    if view.cfg.ssm:
        started = sum(1 for sid in view.seqs if sid in view._started)
        charge += started * view._ssm_blocks_per_seq
    return charge


def pool_errors(pool) -> List[str]:
    """Conservation laws of one ``UnifiedKVPool`` and its views."""
    errs = [f"allocator: {e}" for e in allocator_errors(pool.allocator)]
    if pool.allocator.n_blocks != pool.n_head_blocks:
        errs.append(f"allocator arena {pool.allocator.n_blocks} != "
                    f"pool.n_head_blocks {pool.n_head_blocks}")
    if pool.k.shape[0] != pool.n_head_blocks\
            or pool.v.shape[0] != pool.n_head_blocks:
        errs.append(f"device arrays k[{pool.k.shape[0]}]/"
                    f"v[{pool.v.shape[0]}] != arena "
                    f"{pool.n_head_blocks}")
    refs = pool.allocator.refcounts()
    holders = 0
    for name, view in pool.views.items():
        charge = _view_charge(view)
        if view.used != charge:
            errs.append(f"view {name}: used={view.used} != recomputed "
                        f"sequence charge {charge}")
        if pool.used_by.get(name) != view.used:
            errs.append(f"view {name}: pool.used_by="
                        f"{pool.used_by.get(name)} != view.used "
                        f"{view.used}")
        if view.quota < 0:
            errs.append(f"view {name}: negative quota {view.quota}")
        for sid, sc in view.seqs.items():
            for base in sc.bases:
                dead = [b for b in range(base, base + view.group_size)
                        if b not in refs]
                if dead:
                    errs.append(f"view {name} seq {sid}: base {base} "
                                f"group holds dead blocks {dead[:4]}")
                    break
        # arena holders: token-block bases (SSM state units live in
        # the separate state arena, not the head-block allocator)
        holders += sum(len(sc.bases) for sc in view.seqs.values())\
            * view.group_size
        if view.prefix_index is not None:
            holders += view.prefix_index.held_blocks
            for _h, (base, _blk) in view.prefix_index.entries():
                if refs.get(base, 0) < 1:
                    errs.append(f"view {name}: prefix-index entry at "
                                f"base {base} holds a dead block "
                                f"(refcount "
                                f"{refs.get(base, 0)})")
    if pool.allocator.used != holders:
        errs.append(f"allocator.used={pool.allocator.used} != "
                    f"{holders} summed over holders (sequence charges "
                    f"+ prefix-index refs) — a holder was dropped or "
                    f"double-counted")
    return errs


class PoolSanitizer:
    """Per-tick checker for one pool (usable standalone in tests)."""

    def __init__(self, pool):
        self.pool = pool
        self.checks = 0

    def check(self, where: str = "") -> None:
        self.checks += 1
        errs = pool_errors(self.pool)
        if errs:
            raise SanitizeError(_fmt("pool", where, errs))


# ---------------------------------------------------------------------------
# scheduler (mux.py)
# ---------------------------------------------------------------------------
class SchedulerSanitizer:
    """Grant-algebra and slot/view coherence for one ``MuxScheduler``.

    Attaching installs itself as ``unit.sanitizer`` so the block-loss
    fault path can report arena shrinks that legitimately change the
    base size (``MuxScheduler._lose_blocks`` →
    ``note_blocks_lost``)."""

    def __init__(self, unit):
        self.unit = unit
        self.pool = PoolSanitizer(unit.pool)
        granted = sum(g.granted_blocks for g in unit.fused_groups)
        self.base = unit.pool.n_head_blocks - granted - unit._grant_debt
        self.checks = 0
        unit.sanitizer = self

    def note_blocks_lost(self, n: int) -> None:
        """A block-loss fault shrank the arena outside the grant
        algebra: the base size itself changed."""
        self.base -= n

    def errors(self) -> List[str]:
        u = self.unit
        errs: List[str] = []
        granted = sum(g.granted_blocks for g in u.fused_groups)
        debt = u._grant_debt
        if debt < 0:
            errs.append(f"negative grant debt {debt}")
        if u.pool.n_head_blocks != self.base + granted + debt:
            errs.append(
                f"grant algebra broken: n_head_blocks="
                f"{u.pool.n_head_blocks} != base {self.base} + granted "
                f"{granted} + debt {debt}")
        for name, eng in u.engines.items():
            live = set(eng.live_seq_ids())
            in_view = set(eng.view.seqs)
            if live != in_view:
                errs.append(
                    f"engine {name}: live slots {sorted(live)} != view "
                    f"sequences {sorted(in_view)} — a slot or a cache "
                    f"entry leaked")
            if eng.view.cfg.name != name:
                errs.append(f"engine {name} bound to view "
                            f"{eng.view.cfg.name}")
        return errs

    def check(self, where: str = "") -> None:
        self.checks += 1
        errs = pool_errors(self.unit.pool) + self.errors()
        if errs:
            raise SanitizeError(_fmt("scheduler", where, errs))


# ---------------------------------------------------------------------------
# session (driver.py)
# ---------------------------------------------------------------------------
class SessionSanitizer:
    """Disposition law + per-unit invariants for a ``ServeSession``.

    ``check`` runs after every busy tick (and once at drain): each
    submitted request must be in exactly one disposition state, and a
    request in none of them must be *held* — findable in a queue, an
    engine slot, or a preempt buffer.  A request that is nowhere is
    the bug class the law exists to catch (silently lost work)."""

    def __init__(self, session):
        self.session = session
        self.units = [SchedulerSanitizer(u) for u in session.units]
        self.checks = 0

    # -- helpers ---------------------------------------------------------
    def _held_ids(self) -> set:
        held = set()
        for u in self.session.units:
            for q in u.queues.values():
                held.update(id(r) for r in q)
            for eng in u.engines.values():
                held.update(id(r) for r in eng.slots if r is not None)
                held.update(id(r) for r in eng.preempted)
                held.update(id(r) for r in eng.finished)
        return held

    def errors(self) -> List[str]:
        s = self.session
        errs: List[str] = []
        held = self._held_ids()
        per: Dict[str, List[int]] = {}
        for r in s.requests[:s.idx]:
            fin = 1 if r.finish >= 0 else 0
            shd = 1 if r.shed else 0
            can = 1 if r.cancelled else 0
            if fin + shd + can > 1:
                errs.append(
                    f"request {r.req_id} ({r.model}) has multiple "
                    f"dispositions: finish={r.finish:.4g} "
                    f"shed={r.shed} cancelled={r.cancelled}")
            if fin + shd + can == 0 and id(r) not in held:
                errs.append(
                    f"request {r.req_id} ({r.model}) is SILENTLY LOST: "
                    f"submitted, not finished/shed/cancelled, and held "
                    f"by no queue, slot, or preempt buffer")
            c = per.setdefault(r.model, [0, 0, 0, 0, 0])
            c[0] += 1
            c[1] += fin
            c[2] += shd
            c[3] += can
            c[4] += 1 - min(fin + shd + can, 1)
        for name, (sub, fin, shd, can, out) in sorted(per.items()):
            if sub != fin + shd + can + out:
                errs.append(
                    f"disposition law broken for {name}: submitted "
                    f"{sub} != finished {fin} + shed {shd} + cancelled "
                    f"{can} + outstanding {out}")
        # stats lists must agree with request flags (each disposition
        # recorded exactly once)
        for u in s.units:
            fin_ids = [id(r) for r in u.stats.finished]
            if len(fin_ids) != len(set(fin_ids)):
                errs.append("a request appears twice in stats.finished")
            bad = [r.req_id for r in u.stats.finished if r.finish < 0]
            if bad:
                errs.append(f"requests in stats.finished without a "
                            f"finish stamp: {bad[:8]}")
            bad = [r.req_id for r in u.stats.shed if not r.shed]
            if bad:
                errs.append(f"requests in stats.shed without the shed "
                            f"flag: {bad[:8]}")
        return errs

    def check(self, where: str = "") -> None:
        self.checks += 1
        errs: List[str] = []
        for us in self.units:
            errs.extend(pool_errors(us.unit.pool))
            errs.extend(us.errors())
        errs.extend(self.errors())
        if errs:
            raise SanitizeError(_fmt("session", where, errs))


def _fmt(scope: str, where: str, errs: List[str]) -> str:
    head = f"sanitizer[{scope}]{f' at {where}' if where else ''}: "\
           f"{len(errs)} invariant violation"\
           f"{'s' if len(errs) != 1 else ''}"
    return head + "".join(f"\n  - {e}" for e in errs)
