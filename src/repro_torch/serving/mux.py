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

The JAX package's fault injection, shedding, cancellation, crash
recovery and live regrouping arrive with later slices.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.serving.engine import (Engine, Request, greedy_tokens,
                                        step_fn, tree_bytes,
                                        unique_tree_bytes)
from repro_torch.serving.kvcache import UnifiedKVPool, fused_block_tables


@dataclass
class MuxStats:
    finished: List[Request] = field(default_factory=list)
    prefill_tokens: int = 0
    decode_tokens: int = 0
    ticks: int = 0


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


class FusedGroup:
    """Colocated engines whose decode (and chunked-prefill) steps run as
    ONE sweep over a stacked weight tree.

    Members have matching ``Engine.fusion_signature()``; their trees are
    concatenated once on a leading model axis and every member *adopts*
    the stacked tree, so the group holds exactly one weight copy.
    ``reclaimed_bytes`` (the members' former private trees) is what the
    scheduler grants the pool as extra head-blocks."""

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
        # fixed row count: one shape per group sweep
        self.rows = max(e.max_slots for e in engines)
        member_bytes = sum(tree_bytes(e.params) for e in engines)
        self.params = _stack_members([e.params for e in engines])
        for m, e in enumerate(engines):
            e.adopt_stacked(self.params, m)
        self.reclaimed_bytes = member_bytes
        self._decode_fn = step_fn("fused_decode", self.cfg_key)
        self._prefill_fn = (step_fn("fused_prefill_chunk", self.cfg_key)
                            if self.chunk_tokens else None)

    def weight_bytes(self) -> int:
        """Live weight bytes of the whole group (de-duplicated)."""
        return unique_tree_bytes([e.params for e in self.engines])

    def decode(self, jobs) -> Dict[str, int]:
        """One fused decode step.  ``jobs`` is aligned with
        ``self.engines`` (None where an engine has no decode work — its
        rows are padded and masked).  Returns committed tokens per
        member name."""
        pool = self.engines[0].pool
        rows = self.rows
        toks = np.zeros((len(self.engines), rows), np.int32)
        for m, job in enumerate(jobs):
            if job is not None:
                toks[m, :len(job)] = job.last_tok
        tables, lens = fused_block_tables(
            [(eng.view, job.seq_ids if job is not None else [])
             for eng, job in zip(self.engines, jobs)],
            rows, self.max_blocks)
        logits = self._decode_fn(self.params, toks, lens, pool, tables)
        nxt = greedy_tokens(logits)                           # [M, rows]
        per: Dict[str, int] = {}
        for m, (eng, job) in enumerate(zip(self.engines, jobs)):
            if job is not None:
                per[eng.cfg.name] = eng.apply_decode_result(
                    job, nxt[m, :len(job)])
        return per

    def prefill(self, jobs) -> Dict[str, int]:
        """One fused chunked-prefill sweep: every member's in-flight
        prompt chunks advance by one window.  ``jobs`` is aligned with
        ``self.engines`` (None where a member has nothing prefilling).
        Returns prompt tokens processed per member name."""
        pool = self.engines[0].pool
        rows, C, M = self.rows, self.chunk_tokens, len(self.engines)
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
        logits = self._prefill_fn(self.params, toks, offs, clens, pool,
                                  tables)
        nxt = greedy_tokens(logits)                           # [M, rows]
        per: Dict[str, int] = {}
        for m, (eng, job) in enumerate(zip(self.engines, jobs)):
            if job is not None:
                per[eng.cfg.name] = eng.apply_prefill_result(
                    job, nxt[m, :len(job)])
        return per


class MuxScheduler:
    """Paper Alg. 3 (ADBS) over real engines.

    ``clock``: zero-argument callable supplying the current time for
    request timestamps; a deterministic driver (``serving/driver.py``)
    passes a logical clock it advances itself."""

    def __init__(self, engines: Dict[str, Engine], pool: UnifiedKVPool,
                 policy: str = "adbs", adapt_every: int = 16,
                 fused: bool = False, clock=None,
                 sm_frac: Optional[Dict[str, float]] = None):
        if policy not in ("adbs", "fcfs", "round_robin"):
            raise ValueError(f"unknown policy {policy!r}")
        self.engines = engines
        self.pool = pool
        self.policy = policy
        self.adapt_every = adapt_every
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
                granted = self.pool.grow(
                    grp.reclaimed_bytes // self.pool.head_block_bytes)
                share = granted // len(grp.engines)
                if share:
                    for e in grp.engines:
                        e.view.quota += share
                self.reclaimed_weight_bytes += grp.reclaimed_bytes
        self._serial_names = [n for n in self.engines if n not in grouped]
        self._prefill_serial_names = [n for n in self.engines
                                      if n not in chunk_grouped]

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queues[req.model].append(req)

    def pending(self) -> int:
        return sum(len(q) for q in self.queues.values()) + sum(
            len(e.active_slots()) for e in self.engines.values())

    def _meter(self, counter: Dict[str, int], name: str, toks: int) -> None:
        if toks:
            counter[name] = counter.get(name, 0) + toks

    # ------------------------------------------------------------------
    def _pull_batch(self, name: str) -> List[Request]:
        """Pop an admissible batch for one LLM — Alg. 3's
        ``resource_enough`` gate: whole-lifetime quota check,
        cumulative across the batch."""
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
        return batch

    def _run_prefill_round_robin(self) -> bool:
        """Try one prefill job round-robin across the serially
        prefilled LLMs (Alg. 3's prefill-selection step)."""
        names = self._prefill_serial_names
        n = len(names)
        for i in range(n):
            name = names[(self._prefill_rr + i) % n]
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
            jobs = [eng.export_prefill_job() for eng in grp.engines]
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
            jobs = [eng.export_decode_job() for eng in grp.engines]
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
                # queue in (arrival, req_id) order
                for r in sorted(eng.preempted,
                                key=lambda r: (r.arrival, r.req_id),
                                reverse=True):
                    self.queues[name].appendleft(r)
                eng.preempted.clear()

    # ------------------------------------------------------------------
    def tick(self) -> None:
        """One scheduler iteration (paper Alg. 3 main loop).

        * ``adbs`` — prefill-priority round-robin selection, decode
          fills the remaining resources, quota adaptation every
          ``adapt_every`` ticks (decode first under enforced shares);
        * ``round_robin`` — no prefill priority (prefill every other
          tick), fixed quotas;
        * ``fcfs`` — strict global arrival order, one LLM at a time.
        """
        self.stats.ticks += 1
        self.tick_prefill_by = {}
        self.tick_decode_by = {}
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
            busy_prefill = [n for n, e in self.engines.items()
                            if e.has_prefill_work()]
            busy_decode = [n for n, e in self.engines.items()
                           if e.has_decode_work()]
            for name in busy_prefill:
                toks = self.engines[name].prefill([])
                self.stats.prefill_tokens += toks
                self._meter(self.tick_prefill_by, name, toks)
            oldest_name, oldest_t = None, float("inf")
            for name, q in self.queues.items():
                if q and q[0].arrival < oldest_t:
                    oldest_name, oldest_t = name, q[0].arrival
            if oldest_name is not None and not busy_decode \
                    and not busy_prefill:
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
                    now = self.clock()
                    for r in batch:
                        r.prefill_done = now
                    toks = eng.prefill(batch)
                    self.stats.prefill_tokens += toks
                    self._meter(self.tick_prefill_by, oldest_name, toks)
            for name in busy_decode:
                toks = self.engines[name].decode()
                self.stats.decode_tokens += toks
                self._meter(self.tick_decode_by, name, toks)
        self._harvest()
