"""MuxScheduler — spatial-temporal multiplexing of colocated LLMs (port
of ``repro/serving/mux.py``).

Implements the paper's ADBS (Alg. 3) over real ``Engine`` instances
sharing one ``UnifiedKVPool``:

  * prefill jobs are prioritized and selected round-robin across LLMs;
  * remaining capacity is filled with decode jobs round-robin;
  * per-LLM token-block quotas bound KV usage (Eq. 2's R);
  * quotas adapt periodically from low- to high-utilization LLMs.

With ``fused=True`` same-architecture engines form a ``FusedGroup``
whose stacked weight tree is the single weight copy of the group; every
tick runs ONE decode sweep and, with chunked prefill, ONE prefill sweep
over all members — on the card one launch of each attention kernel per
layer serves every colocated model.  The weight memory the stacking
de-duplicates is granted to the pool as extra head-blocks.
Fusion-ineligible engines (SSM and hybrid: ``fusion_signature`` None)
take the serial prefill and decode paths next to the groups.

``policy``: "adbs" (paper), "fcfs" (temporal multiplexing baseline),
"round_robin" (no prefill priority, fixed quotas).  ``sm_frac``:
per-engine compute shares; when given, the adbs tick dispatches decode
first under the shares and every tick is metered per engine and phase
(``tick_prefill_by`` / ``tick_decode_by``) for the share-aware clock.

Graceful degradation, all default-off: a fault injector polled every
tick (crash recovery, block loss, transient step failures with a retry
budget), bounded admission queues with ``shed_policy`` "reject" or
"deadline", client cancellation, and the engine-membership changes that
recovery runs on (``remove_engine`` / ``add_engine``, which dissolve
and rebuild the fused groups with the grant-debt algebra).  The token
emission hook (``set_emit``) feeds the streaming front end.
"""
from __future__ import annotations

import time
import weakref
from dataclasses import dataclass, field
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.serving.engine import (Engine, Request, count_fill,
                                        greedy_tokens, step_fn, tree_bytes,
                                        tree_map, unique_tree_bytes)
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.kvcache import UnifiedKVPool, fused_block_tables
from repro_torch.serving.metrics import RECORDER, traced

SHED_POLICIES = ("none", "reject", "deadline")


@dataclass
class MuxStats:
    finished: List[Request] = field(default_factory=list)
    # deliberately dropped requests (backpressure, deadline shedding,
    # requeue-budget exhaustion, watchdog drains), each with its
    # ``shed_reason``: SLO misses with a visible disposition
    shed: List[Request] = field(default_factory=list)
    # client-abandoned requests: reports keep
    # ``submitted = finished + shed + cancelled``
    cancelled: List[Request] = field(default_factory=list)
    prefill_tokens: int = 0
    decode_tokens: int = 0
    ticks: int = 0

    def throughput_reqs(self, horizon: float) -> float:
        return len(self.finished) / max(horizon, 1e-9)


def _stack_members(trees: List[dict]) -> dict:
    """Concatenate the members' ``[1, ...]`` trees on the model axis,
    leaf by leaf, dropping each member's leaf as soon as it is stacked:
    the peak is the members plus one stacked leaf, not two full copies
    (at full width two copies of two 7B models would not fit the
    card)."""
    out = {}
    for key in list(trees[0]):
        if isinstance(trees[0][key], dict):
            out[key] = _stack_members([t[key] for t in trees])
        else:
            out[key] = torch.cat([t[key] for t in trees], dim=0)
            for t in trees:
                t[key] = None
    return out


def _unstack_members(stacked: dict, trees: List[dict]) -> None:
    """Inverse of ``_stack_members``: cut member ``m``'s ``[1, ...]``
    slice of each stacked leaf into ``trees[m]`` (a copy), popping the
    stacked leaf once every member has its slice — the peak is the
    stack plus one leaf's copies, not two full copies."""
    for key in list(stacked):
        if isinstance(stacked[key], dict):
            subs = [t.setdefault(key, {}) for t in trees]
            _unstack_members(stacked[key], subs)
        else:
            leaf = stacked.pop(key)
            for m, t in enumerate(trees):
                t[key] = leaf[m:m + 1].clone()
            del leaf


class FusedGroup:
    """Colocated engines whose decode (and chunked-prefill) steps run as
    ONE sweep over a stacked weight tree.

    Members have matching ``Engine.fusion_signature()``; their trees are
    concatenated once on a leading model axis and every member *adopts*
    the stacked tree, so the group holds exactly one weight copy.
    ``reclaimed_bytes`` (the members' former private trees) is what the
    scheduler grants the pool as extra head-blocks.

    A decode sweep always runs ``rows`` rows a member: it reads every
    weight once whatever its rows, so a padded row costs next to
    nothing.  A chunk sweep runs the smallest of ``chunk_buckets`` that
    holds the busiest member's rows, since there every padded row is a
    whole chunk of GEMM work; every bucket is run once on padded rows at
    the first sweep on an arena, so none is met first under traffic."""

    def __init__(self, engines: List[Engine],
                 names: Optional[List[str]] = None):
        if len(engines) < 2:
            raise ValueError("a fused group needs at least two engines")
        sigs = {e.fusion_signature() for e in engines}
        if len(sigs) != 1 or None in sigs:
            raise ValueError("fused group requires matching fusion signatures")
        self.engines = engines
        self.names = list(names) if names else [e.cfg.name for e in engines]
        self.cfg_key = engines[0].cfg_key
        self.max_blocks = engines[0].max_blocks
        self.chunk_tokens = engines[0].chunk_tokens
        # the decode sweep's rows; the chunk sweep's largest bucket
        self.rows = max(e.max_slots for e in engines)
        self.chunk_buckets = tuple(sorted(
            {1 << k for k in range(self.rows.bit_length())
             if 1 << k < self.rows} | {self.rows}))
        # the arena the chunk buckets last ran on (``_warm_chunk_buckets``)
        self._warm_arena = None
        member_bytes = sum(tree_bytes(e.params) for e in engines)
        self.params = _stack_members([e.params for e in engines])
        for m, e in enumerate(engines):
            e.adopt_stacked(self.params, m)
        self.reclaimed_bytes = member_bytes
        # pool grant bookkeeping, set by the scheduler when it converts
        # reclaimed_bytes into head-blocks: total blocks grown into the
        # pool and the per-member quota share — dissolve() needs both
        # to hand the grant back
        self.granted_blocks = 0
        self.quota_share = 0
        self._decode_fn = step_fn("fused_decode", self.cfg_key)
        self._prefill_fn = (step_fn("fused_prefill_chunk", self.cfg_key)
                            if self.chunk_tokens else None)

    def weight_bytes(self) -> int:
        """Live weight bytes of the whole group (de-duplicated)."""
        return unique_tree_bytes([e.params for e in self.engines])

    def dissolve(self) -> None:
        """Undo the zero-copy adoption: every member re-owns a private
        ``[1, ...]`` copy of its weights, cut out of the stack leaf by
        leaf so the stack and the copies never coexist whole.  The
        scheduler pairs this with revoking the quota shares and
        shrinking the pool by ``granted_blocks``
        (``MuxScheduler.dissolve_fused_groups``)."""
        trees: List[dict] = [{} for _ in self.engines]
        _unstack_members(self.params, trees)
        for e, tree in zip(self.engines, trees):
            e.materialize_private(tree)
        self.params = None

    def decode(self, jobs) -> Dict[str, int]:
        """One fused decode step.  ``jobs`` is aligned with
        ``self.engines`` (None where an engine has no decode work — its
        rows are padded and masked).  Returns committed tokens per
        member name."""
        pool = self.engines[0].pool
        if RECORDER.on:
            count_fill("rows.decode", sum(len(j) for j in jobs if j),
                       len(self.engines) * self.rows)
        toks, lens, tables = self._decode_batch(jobs)
        logits = self._decode_fn(self.params, toks, lens, pool, tables)
        nxt = greedy_tokens(logits)                           # [M, rows]
        per: Dict[str, int] = {}
        for m, (eng, job) in enumerate(zip(self.engines, jobs)):
            if job is not None:
                per[eng.cfg.name] = eng.apply_decode_result(
                    job, nxt[m, :len(job)])
        return per

    @traced("plan.batch")
    def _decode_batch(self, jobs) -> tuple:
        """The sweep's ``[M, rows]`` last tokens and lengths and
        ``[M, rows, max_blocks]`` block tables (padded rows: token 0,
        length 1, table −1)."""
        toks = np.zeros((len(self.engines), self.rows), np.int32)
        for m, job in enumerate(jobs):
            if job is not None:
                toks[m, :len(job)] = job.last_tok
        tables, lens = fused_block_tables(
            [(eng.view, job.seq_ids if job is not None else [])
             for eng, job in zip(self.engines, jobs)],
            self.rows, self.max_blocks)
        return toks, lens, tables

    def prefill(self, jobs) -> Dict[str, int]:
        """One fused chunked-prefill sweep: every member's in-flight
        prompt chunks advance by one window.  ``jobs`` is aligned with
        ``self.engines`` (None where a member has nothing prefilling).
        Returns prompt tokens processed per member name."""
        pool = self.engines[0].pool
        self._warm_chunk_buckets(pool)
        busiest = max((len(j) for j in jobs if j is not None), default=1)
        rows = next(r for r in self.chunk_buckets if r >= busiest)
        toks, offs, clens, tables = self._prefill_batch(jobs, rows)
        if RECORDER.on:
            count_fill("tokens.chunk", int(clens.sum()), toks.size)
        logits = self._prefill_fn(self.params, toks, offs, clens, pool,
                                  tables)
        nxt = greedy_tokens(logits)                     # [M, bucket rows]
        per: Dict[str, int] = {}
        for m, (eng, job) in enumerate(zip(self.engines, jobs)):
            if job is not None:
                per[eng.cfg.name] = eng.apply_prefill_result(
                    job, nxt[m, :len(job)])
        return per

    def _warm_chunk_buckets(self, pool) -> None:
        """Run the chunk sweep once at each of ``chunk_buckets`` on
        padded rows (length 0, table −1: no KV lands, the logits are
        dropped) when the group first sweeps on ``pool``'s arena: on the
        card every bucket's graph is captured here, together, and again
        after the arena they read was replaced (a ``grow`` that
        reallocates, a migrated view)."""
        arena = pool.arena()[0]
        if self._warm_arena is not None and self._warm_arena() is arena:
            return
        # the step itself, not ``_prefill_fn``: that stays the one call
        # that sweeps real rows, for whatever wraps it to observe them
        step = step_fn("fused_prefill_chunk", self.cfg_key)
        for rows in self.chunk_buckets:
            toks, offs, clens, tables = self._prefill_batch(
                [None] * len(self.engines), rows)
            step(self.params, toks, offs, clens, pool, tables)
        self._warm_arena = weakref.ref(arena)

    @traced("plan.batch")
    def _prefill_batch(self, jobs, rows: int) -> tuple:
        """The sweep's ``[M, rows, C]`` chunk tokens, ``[M, rows]``
        offsets and true lengths, and block tables (padded rows: zeros,
        table −1)."""
        C, M = self.chunk_tokens, len(self.engines)
        toks = np.zeros((M, rows, C), np.int32)
        offs = np.zeros((M, rows), np.int32)
        clens = np.zeros((M, rows), np.int32)
        tables = np.full((M, rows, self.max_blocks), -1, np.int32)
        for m, (eng, job) in enumerate(zip(self.engines, jobs)):
            if job is None:
                continue
            b = len(job)
            toks[m, :b] = job.toks
            offs[m, :b] = job.offs
            clens[m, :b] = job.clens
            tables[m, :b] = eng.view.block_table(job.seq_ids,
                                                 self.max_blocks)
        return toks, offs, clens, tables


# backwards-compatible name (the group now fuses prefill too)
FusedDecodeGroup = FusedGroup


class MuxScheduler:
    """Paper Alg. 3 (ADBS) over real engines.

    ``clock``: zero-argument callable supplying the current time for
    request timestamps; a deterministic driver (``serving/driver.py``)
    passes a logical clock it advances itself."""

    def __init__(self, engines: Dict[str, Engine], pool: UnifiedKVPool,
                 policy: str = "adbs", adapt_every: int = 16,
                 fused: bool = False, clock=None,
                 sm_frac: Optional[Dict[str, float]] = None,
                 injector: Optional[FaultInjector] = None,
                 max_queue: Optional[int] = None,
                 shed_policy: str = "none",
                 requeue_budget: int = 3, retry_budget: int = 3):
        if policy not in ("adbs", "fcfs", "round_robin"):
            raise ValueError(f"unknown policy {policy!r}")
        if shed_policy not in SHED_POLICIES:
            raise ValueError(f"unknown shed_policy {shed_policy!r}")
        if max_queue is not None and max_queue <= 0:
            raise ValueError(f"max_queue must be > 0 (got {max_queue})")
        self.engines = engines
        self.pool = pool
        self.policy = policy
        self.adapt_every = adapt_every
        # graceful degradation, all default-off:
        #   injector        fault plan polled at every tick
        #   max_queue       per-LLM admission-queue bound (backpressure
        #                   sheds NEW arrivals when full; requeues from
        #                   preemption/recovery bypass it)
        #   shed_policy     "none" | "reject" (backpressure only) |
        #                   "deadline" (also shed queue heads whose
        #                   Request.deadline has passed)
        #   requeue_budget  teardowns one request may survive before it
        #                   is shed instead of requeued
        #   retry_budget    consecutive transiently-failed ticks before
        #                   a transient window escalates to crash
        #                   recovery
        self.injector = injector
        self.max_queue = max_queue
        self.shed_policy = shed_policy
        self.requeue_budget = requeue_budget
        self.retry_budget = retry_budget
        # recovery/degradation events of this unit, drained (and clock-
        # charged in deterministic mode) by serving/driver.py
        self.fault_events: List[dict] = []
        self._down: set = set()                  # transient-down engines
        self._transient_ticks: Dict[str, int] = {}
        self.queues: Dict[str, Deque[Request]] = {
            name: deque() for name in engines}
        self._names = list(engines)
        self._prefill_rr = 0
        self._decode_rr = 0
        self.stats = MuxStats()
        # per-engine compute shares, enforced only when supplied (and
        # never under fcfs, the temporal baseline)
        self.sm_frac: Dict[str, float] = {n: 1.0 for n in engines}
        if sm_frac:
            self.sm_frac.update({n: float(f) for n, f in sm_frac.items()
                                 if n in engines})
        self.enforce_shares = sm_frac is not None and policy != "fcfs"
        self.tick_prefill_by: Dict[str, int] = {}
        self.tick_decode_by: Dict[str, int] = {}
        self.clock = clock if clock is not None else time.perf_counter
        for eng in engines.values():
            eng.clock = self.clock
        # token-emission hook (serving/frontend.py) — see ``set_emit``
        self.emit = None
        self.fused = fused and policy != "fcfs"
        self.fused_groups: List[FusedGroup] = []
        self._serial_names = list(engines)          # serial decode set
        self._prefill_serial_names = list(engines)  # serial prefill set
        self.reclaimed_weight_bytes = 0
        # mesh identity and device count inside a placement
        # (units_from_placement tags both); −1 / 1 for a hand-built
        # unit.  The deterministic clock divides a tick's per-token cost
        # by n_devices.
        self.mesh_id = -1
        self.n_devices = 1
        # un-returned zero-copy grant: blocks a dissolve wanted back but
        # the pool's in-use tail kept (``UnifiedKVPool.shrink`` clamps).
        # The next build settles this debt before growing, so repeated
        # dissolve/rebuild cycles cannot inflate the arena past its
        # reclaimed-weight backing.
        self._grant_debt = 0
        # optional runtime invariant checker (serving.sanitize);
        # SchedulerSanitizer installs itself here so the block-loss
        # fault path can report arena shrinks that change the base
        self.sanitizer = None
        if self.fused:
            self._build_fused_groups()

    def _build_fused_groups(self) -> None:
        """Group engines by fusion signature, stack weights zero-copy,
        and grant the de-duplicated bytes to the pool."""
        by_sig: Dict[tuple, List[str]] = {}
        for name, eng in self.engines.items():
            sig = eng.fusion_signature()
            if sig is not None:
                by_sig.setdefault(sig, []).append(name)
        grouped, chunk_grouped = set(), set()
        for names in by_sig.values():
            if len(names) >= 2:
                grp = FusedGroup([self.engines[n] for n in names], names)
                self.fused_groups.append(grp)
                grouped.update(names)
                if grp.chunk_tokens:
                    chunk_grouped.update(names)
                # the dividend minus any un-returned grant of a prior
                # dissolve (the arena still holds those blocks)
                want = grp.reclaimed_bytes // self.pool.head_block_bytes
                settle = min(self._grant_debt, want)
                self._grant_debt -= settle
                granted = self.pool.grow(want - settle) + settle
                share = granted // len(grp.engines)
                grp.granted_blocks = granted
                grp.quota_share = share
                if share:
                    for e in grp.engines:
                        e.view.quota += share
                self.reclaimed_weight_bytes += grp.reclaimed_bytes
        self._serial_names = [n for n in self.engines if n not in grouped]
        self._prefill_serial_names = [n for n in self.engines
                                      if n not in chunk_grouped]

    def dissolve_fused_groups(self) -> int:
        """Undo every fused group: members re-own private weight copies,
        their quota shares are revoked (clamped so quota never drops
        below live usage) and the pool shrinks by the zero-copy grant —
        only as far as its free tail allows; the rest becomes grant debt
        that the next build settles.  Returns the head-blocks actually
        shrunk."""
        shrunk = 0
        for grp in self.fused_groups:
            grp.dissolve()
            if grp.quota_share:
                for e in grp.engines:
                    e.view.quota -= min(grp.quota_share,
                                        max(e.view.quota - e.view.used, 0))
            got = self.pool.shrink(grp.granted_blocks)
            self._grant_debt += grp.granted_blocks - got
            shrunk += got
            self.reclaimed_weight_bytes -= grp.reclaimed_bytes
        self.fused_groups = []
        self._serial_names = list(self.engines)
        self._prefill_serial_names = list(self.engines)
        return shrunk

    def rebuild_fused_groups(self) -> None:
        """Re-derive fused groups after a membership change (an engine
        joined or left the unit): dissolve, then build."""
        self.dissolve_fused_groups()
        if self.fused:
            self._build_fused_groups()

    # ------------------------------------------------------------------
    def remove_engine(self, name: str):
        """Detach one engine: dissolve the fused groups (and rebuild the
        remainder), drop it from every scheduling structure and hand
        back ``(engine, queued_requests)``.  The engine keeps its live
        slots and cache view."""
        if name not in self.engines:
            raise KeyError(name)
        eng = self.engines.pop(name)
        queued = list(self.queues.pop(name))
        self.sm_frac.pop(name, None)
        self._names = list(self.engines)
        self._prefill_rr = self._decode_rr = 0
        self.rebuild_fused_groups()
        return eng, queued

    def add_engine(self, name: str, eng, queued=(),
                   sm_frac: float = 1.0) -> None:
        """Adopt an engine (and its carried queue) into this unit: it
        joins the tick rotation, inherits the scheduler's clock, emit
        hook and compute share, and fuses with matching-signature
        residents."""
        if name in self.engines:
            raise ValueError(f"engine {name!r} is already in the unit")
        if eng.pool is not self.pool:
            raise ValueError("the engine's view must be on this unit's pool")
        self.engines[name] = eng
        self.queues[name] = deque(queued)
        self.sm_frac[name] = float(sm_frac)
        eng.clock = self.clock
        eng.emit = self.emit
        self._names = list(self.engines)
        self._prefill_rr = self._decode_rr = 0
        self.rebuild_fused_groups()

    # ------------------------------------------------------------------
    def set_emit(self, fn) -> None:
        """Install the token-emission hook on this unit and every engine
        it hosts: ``fn(event, request, token)`` with events "token" /
        "finish" / "reset" (engine commit points), "shed" and
        "cancelled" (scheduler dispositions).  ``add_engine`` re-applies
        it, so an engine rebuilt by crash recovery keeps streaming."""
        self.emit = fn
        for eng in self.engines.values():
            eng.emit = fn

    def submit(self, req: Request) -> None:
        q = self.queues[req.model]
        if (self.shed_policy != "none" and self.max_queue is not None
                and len(q) >= self.max_queue):
            # bounded admission queue: backpressure sheds the NEW
            # arrival instead of growing the queue without bound
            self._shed(req, "queue_full")
            return
        q.append(req)
        if RECORDER.on:
            RECORDER.queued(req)

    def pending(self) -> int:
        return sum(len(q) for q in self.queues.values()) + sum(
            len(e.active_slots()) for e in self.engines.values())

    # ---- graceful degradation ------------------------------------------
    def _shed(self, req: Request, reason: str) -> None:
        """Deliberately drop one request: flagged (never silent),
        ``finish`` stays −1 so the roll-up counts an SLO miss."""
        req.shed = True
        req.shed_reason = reason
        self.stats.shed.append(req)
        if self.emit is not None:
            self.emit("shed", req, -1)

    def _shed_expired(self) -> None:
        """Deadline-aware shedding: pop queue heads whose admission
        deadline has passed (even immediate solo-speed service would
        miss their scaled TTFT target)."""
        now = self.clock()
        for q in self.queues.values():
            while q and q[0].deadline < now:
                self._shed(q.popleft(), "deadline")

    def cancel(self, req: Request) -> bool:
        """Client abandonment: release what the request holds NOW — its
        queue position, or its engine slot, KV blocks and prefix-index
        refs (``evict_seqs`` → ``free_seq`` drops shared-prefix
        refcounts with the rest) — and record the ``cancelled``
        disposition.  Returns False when the request already finished,
        was shed, or isn't held by this unit."""
        if req.cancelled or req.shed or req.finish >= 0:
            return False
        removed = False
        q = self.queues.get(req.model)
        if q is not None and req in q:
            q.remove(req)
            removed = True
        else:
            eng = self.engines.get(req.model)
            if eng is not None:
                if req in eng.preempted:
                    # evicted this tick, awaiting requeue
                    eng.preempted.remove(req)
                    removed = True
                else:
                    for slot in eng.active_slots():
                        if eng.slots[slot] is req:
                            eng.evict_seqs([int(eng.slot_seq[slot])])
                            removed = True
                            break
        if not removed:
            return False
        req.cancelled = True
        self.stats.cancelled.append(req)
        if self.emit is not None:
            self.emit("cancelled", req, -1)
        return True

    def _apply_faults(self) -> None:
        """Tick preamble: fire due plan events for this unit and track
        transient windows.  Crash and block-loss events mutate the unit
        at once; a transient window marks its engine down for this tick
        (its work is skipped and retried next tick) and escalates to
        crash recovery once it has burned ``retry_budget`` consecutive
        ticks."""
        now = self.clock()
        for ev in self.injector.poll(self, now):
            if ev.kind == "engine_crash":
                self.recover_engine(ev.target, reason="crash")
            elif ev.kind == "block_loss":
                self._lose_blocks(ev.magnitude)
        for name in list(self.engines):
            if self.injector.consume_transient(name):
                ticks = self._transient_ticks.get(name, 0) + 1
                if ticks > self.retry_budget:
                    # retry budget exhausted: rebuild the engine (which
                    # clears the window too)
                    self._transient_ticks.pop(name, None)
                    self.injector.clear_transient(name)
                    self.recover_engine(name, reason="transient")
                else:
                    self._transient_ticks[name] = ticks
                    self._down.add(name)
            else:
                self._transient_ticks.pop(name, None)

    def recover_engine(self, name: str, reason: str = "crash") -> dict:
        """Crash recovery: tear down the dead engine and rebuild it on a
        fresh pool view, requeueing its in-flight requests.
        ``remove_engine`` dissolves the fused groups, the live sequences
        are evicted, and ``add_engine`` re-fuses the rebuilt engine with
        its matching-signature residents.  The rebuilt engine starts
        from clean state (zero SSM carries, empty slots); restart from
        scratch is exact under greedy decoding.  Requests past
        ``requeue_budget`` teardowns are shed instead.  The dead view's
        prefix index is cleared with it (``unregister_model``) and the
        fresh view's starts cold.  Returns the recovery record (also
        appended to ``fault_events``).

        Memory: the dead engine's weights become the fresh engine's (a
        view, no copy), and the old engine drops its reference before
        the rebuild stacks them, so a recovery holds at most one stacked
        leaf and no second arena over the steady state."""
        share = self.sm_frac.get(name, 1.0)
        eng, queued = self.remove_engine(name)
        blocks_held = eng.view.used
        evicted = eng.evict_seqs(eng.live_seq_ids())
        quota = eng.view.quota
        self.pool.unregister_model(name)
        view = self.pool.register_model(eng.cfg, quota)
        fresh = Engine(eng.cfg, tree_map(lambda a: a[0], eng.params),
                       view, max_slots=eng.max_slots,
                       max_blocks_per_seq=eng.max_blocks,
                       chunk_tokens=eng.chunk_tokens, clock=self.clock)
        eng.params = None
        del eng
        for r in evicted:
            r.requeues += 1
        carried: List[Request] = []
        shed = 0
        # deterministic arrival-order requeue: evicted in-flight work
        # and the carried queue re-enter in (arrival, req_id) order
        for r in sorted(list(evicted) + list(queued),
                        key=lambda r: (r.arrival, r.req_id)):
            if r.requeues > self.requeue_budget:
                self._shed(r, "requeue_budget")
                shed += 1
            else:
                carried.append(r)
        self.add_engine(name, fresh, carried, sm_frac=share)
        rec = {"kind": "engine_crash", "reason": reason,
               "t": self.clock(), "target": name,
               "requeued": len(evicted), "shed": shed,
               "blocks": blocks_held}
        self.fault_events.append(rec)
        return rec

    def _lose_blocks(self, n: int) -> dict:
        """Block-loss fault: the arena loses its last ``n`` head-blocks.
        Sequences with pages in the doomed tail are torn down at the
        engine level and requeued at the head of their queues in
        arrival order; then the tail is entirely free and the pool
        shrinks by exactly the lost blocks.  A shared doomed block
        evicts every sharer (each sharer's block table names it, so
        ``tail_victims`` lists them all), and ``pool.shrink`` drops
        doomed prefix-index entries with it — no dangling cached base
        survives a block loss."""
        n = min(max(n, 0), self.pool.n_head_blocks)
        requeued = shed = 0
        for name, sids in self.pool.tail_victims(n).items():
            eng = self.engines.get(name)
            if eng is None:
                continue
            evicted = eng.evict_seqs(sids)
            keep: List[Request] = []
            for r in evicted:
                r.requeues += 1
                if r.requeues > self.requeue_budget:
                    self._shed(r, "requeue_budget")
                    shed += 1
                else:
                    keep.append(r)
            for r in sorted(keep, key=lambda r: (r.arrival, r.req_id),
                            reverse=True):
                self.queues[name].appendleft(r)
            requeued += len(evicted)
        removed = self.pool.shrink(n)
        if self.sanitizer is not None:
            self.sanitizer.note_blocks_lost(removed)
        rec = {"kind": "block_loss", "t": self.clock(), "target": None,
               "requeued": requeued, "shed": shed, "blocks": removed}
        self.fault_events.append(rec)
        return rec

    def prefix_stats(self) -> Dict[str, dict]:
        """Per-LLM prefix-cache counters for this unit's pool (empty
        when the prefix cache is off) — the ServeReport's hit-rate
        source.  Read from the pool's CURRENT views, so counters survive
        engine replacement on crash recovery (the fresh view's index
        starts cold, as it must: the old refs died with it)."""
        return self.pool.prefix_stats()

    def shed_all(self, reason: str = "watchdog") -> int:
        """Force-drain the unit: shed every queued AND in-flight request
        (the watchdog's last resort).  Returns the number shed."""
        n = 0
        for q in self.queues.values():
            while q:
                self._shed(q.popleft(), reason)
                n += 1
        for eng in self.engines.values():
            for r in eng.evict_seqs(eng.live_seq_ids()):
                self._shed(r, reason)
                n += 1
        return n

    def _meter(self, counter: Dict[str, int], name: str, toks: int) -> None:
        if toks:
            counter[name] = counter.get(name, 0) + toks

    # ------------------------------------------------------------------
    def _pull_batch(self, name: str) -> List[Request]:
        """Pop an admissible batch for one LLM — Alg. 3's
        ``resource_enough`` gate: whole-lifetime quota check,
        cumulative across the batch."""
        if name in self._down:
            # transient step failure this tick: admit nothing, retry
            # the same queue next tick
            return []
        q = self.queues[name]
        eng = self.engines[name]
        if q and eng.lifetime_blocks(q[0]) > eng.view.quota:
            # adapt_quotas shrank this LLM's quota below the head
            # request's lifetime — pull spare quota back first
            self.pool.grant_min_quota(eng.view,
                                      eng.lifetime_blocks(q[0]))
        batch: List[Request] = []
        pending = 0
        while q and len(batch) < len(eng.free_slots()):
            if eng.can_admit(q[0], pending):
                pending += eng.lifetime_blocks(q[0])
                batch.append(q.popleft())
            else:
                break
        if RECORDER.on and batch:
            RECORDER.admitted(batch)
        return batch

    def _run_prefill_round_robin(self) -> bool:
        """Try one prefill job round-robin across the serially
        prefilled LLMs (Alg. 3's prefill-selection step)."""
        names = self._prefill_serial_names
        n = len(names)
        for i in range(n):
            name = names[(self._prefill_rr + i) % n]
            if name in self._down:
                continue
            eng = self.engines[name]
            batch = self._pull_batch(name)
            if batch or eng.has_prefill_work():
                toks = eng.prefill(batch)
                for r in batch:
                    r.prefill_done = self.clock()
                self.stats.prefill_tokens += toks
                self._meter(self.tick_prefill_by, name, toks)
                self._prefill_rr = (self._prefill_rr + i + 1) % n
                return True
        return False

    def _run_prefill_fused_groups(self) -> bool:
        """Fused prefill tick: admit round-robin into every chunked
        group member, then advance ALL members' in-flight chunks in one
        sweep per group."""
        ran = False
        for grp in self.fused_groups:
            if grp.chunk_tokens is None:
                continue
            now = self.clock()
            for name, eng in zip(grp.names, grp.engines):
                batch = self._pull_batch(name)
                if batch:
                    eng.admit_chunked(batch)
                    for r in batch:
                        r.prefill_done = now
            jobs = [None if name in self._down else eng.export_prefill_job()
                    for name, eng in zip(grp.names, grp.engines)]
            n_active = sum(j is not None for j in jobs)
            if n_active == 0:
                continue
            if n_active == 1:
                # a lone prefilling engine runs its job serially, off
                # the same stacked buffers
                m = next(i for i, j in enumerate(jobs) if j is not None)
                toks = grp.engines[m].run_chunk_job(jobs[m])
                self.stats.prefill_tokens += toks
                self._meter(self.tick_prefill_by, grp.names[m], toks)
            else:
                per = grp.prefill(jobs)
                self.stats.prefill_tokens += sum(per.values())
                for name, toks in per.items():
                    self._meter(self.tick_prefill_by, name, toks)
            ran = True
        return ran

    def _run_prefill(self) -> bool:
        ran = self._run_prefill_fused_groups() if self.fused else False
        return self._run_prefill_round_robin() or ran

    def _run_decode_round_robin(self) -> int:
        """Fill the tick with decode jobs from every LLM (Alg. 3's
        decode-fill step)."""
        total = 0
        n = len(self._names)
        for i in range(n):
            name = self._names[(self._decode_rr + i) % n]
            if name in self._down:
                continue
            eng = self.engines[name]
            if eng.has_decode_work():
                toks = eng.decode()
                self._meter(self.tick_decode_by, name, toks)
                total += toks
        self._decode_rr = (self._decode_rr + 1) % max(n, 1)
        return total

    def _run_decode_fused(self) -> int:
        """Fused decode tick: one sweep per fused group, serial fallback
        for the rest."""
        total = 0
        for grp in self.fused_groups:
            jobs = [None if name in self._down else eng.export_decode_job()
                    for name, eng in zip(grp.names, grp.engines)]
            n_active = sum(j is not None for j in jobs)
            if n_active == 0:
                continue
            if n_active == 1:
                m = next(i for i, j in enumerate(jobs) if j is not None)
                toks = grp.engines[m].decode(jobs[m])
                self._meter(self.tick_decode_by, grp.names[m], toks)
                total += toks
            else:
                per = grp.decode(jobs)
                for name, toks in per.items():
                    self._meter(self.tick_decode_by, name, toks)
                total += sum(per.values())
        n = len(self._serial_names)
        for i in range(n):
            name = self._serial_names[(self._decode_rr + i) % n]
            if name in self._down:
                continue
            eng = self.engines[name]
            if eng.has_decode_work():
                toks = eng.decode()
                self._meter(self.tick_decode_by, name, toks)
                total += toks
        self._decode_rr = (self._decode_rr + 1) % max(n, 1)
        return total

    def _decode_tick(self) -> int:
        return self._run_decode_fused() if self.fused \
            else self._run_decode_round_robin()

    def _harvest(self) -> None:
        for name, eng in self.engines.items():
            if eng.finished:
                self.stats.finished.extend(eng.finished)
                eng.finished.clear()
            if eng.preempted:
                # stall-escape evictions go back to the head of their
                # queue in (arrival, req_id) order, NOT eviction order
                # (the engine preempts youngest-first)
                for r in sorted(eng.preempted,
                                key=lambda r: (r.arrival, r.req_id),
                                reverse=True):
                    self.queues[name].appendleft(r)
                eng.preempted.clear()

    # ------------------------------------------------------------------
    @traced("sched.tick")
    def tick(self) -> None:
        """One scheduler iteration (paper Alg. 3 main loop).

        * ``adbs`` — prefill-priority round-robin selection, decode
          fills the remaining resources, quota adaptation every
          ``adapt_every`` ticks (decode first under enforced shares);
        * ``round_robin`` — no prefill priority (prefill every other
          tick), fixed quotas;
        * ``fcfs`` — strict global arrival order, one LLM at a time.

        A degradation preamble runs first, for every policy: shed
        expired queue heads (``shed_policy="deadline"``), fire due
        fault-plan events, mark transient-down engines for this tick.
        """
        self.stats.ticks += 1
        self.tick_prefill_by = {}
        self.tick_decode_by = {}
        self._down = set()
        if self.shed_policy == "deadline":
            self._shed_expired()
        if self.injector is not None:
            self._apply_faults()
        if self.policy == "adbs":
            if self.enforce_shares:
                self.stats.decode_tokens += self._decode_tick()
                self._run_prefill()
            else:
                self._run_prefill()
                self.stats.decode_tokens += self._decode_tick()
            if self.stats.ticks % self.adapt_every == 0:
                self.pool.adapt_quotas()
        elif self.policy == "round_robin":
            if self.stats.ticks % 2 == 0:
                self._run_prefill()
            self.stats.decode_tokens += self._decode_tick()
        else:  # fcfs
            # the one-LLM-at-a-time admission gate reads the FULL busy
            # sets; transient-down engines only skip the work loops
            busy_prefill = [n for n, e in self.engines.items()
                            if e.has_prefill_work()]
            busy_decode = [n for n, e in self.engines.items()
                           if e.has_decode_work()]
            for name in [n for n in busy_prefill if n not in self._down]:
                toks = self.engines[name].prefill([])
                self.stats.prefill_tokens += toks
                self._meter(self.tick_prefill_by, name, toks)
            oldest_name, oldest_t = None, float("inf")
            for name, q in self.queues.items():
                if q and q[0].arrival < oldest_t:
                    oldest_name, oldest_t = name, q[0].arrival
            if oldest_name is not None and not busy_decode \
                    and not busy_prefill and oldest_name not in self._down:
                eng = self.engines[oldest_name]
                q = self.queues[oldest_name]
                if q and eng.lifetime_blocks(q[0]) > eng.view.quota:
                    self.pool.grant_min_quota(eng.view,
                                              eng.lifetime_blocks(q[0]))
                batch = []
                pending = 0
                while q and len(batch) < len(eng.free_slots()) \
                        and eng.can_admit(q[0], pending):
                    pending += eng.lifetime_blocks(q[0])
                    batch.append(q.popleft())
                if batch:
                    if RECORDER.on:
                        RECORDER.admitted(batch)
                    now = self.clock()
                    for r in batch:
                        r.prefill_done = now
                    toks = eng.prefill(batch)
                    self.stats.prefill_tokens += toks
                    self._meter(self.tick_prefill_by, oldest_name, toks)
            for name in [n for n in busy_decode if n not in self._down]:
                toks = self.engines[name].decode()
                self.stats.decode_tokens += toks
                self._meter(self.tick_decode_by, name, toks)
        self._harvest()

    def run(self, max_ticks: int = 10_000) -> MuxStats:
        """Drain all queues."""
        t = 0
        while self.pending() and t < max_ticks:
            self.tick()
            t += 1
        return self.stats
