"""Per-LLM runtime engine: disaggregated prefill / decode jobs (port of
``repro/serving/engine.py``: the dense, MoE, SSM and hybrid families,
and vlm / audio served as token decoders, as the reference engine does:
it reads no prefix embeddings).

Prefill and decode are separate jobs over shared weights and the
unified KV pool; the scheduler (serving/mux.py) decides which job runs
each tick.  ``export_decode_job`` / ``apply_decode_result`` and
``export_prefill_job`` / ``apply_prefill_result`` are this engine's half
of the fused multi-LLM tick; ``_fused_decode_step`` /
``_fused_prefill_chunk_step`` are the stacked-weights sweeps.

Zero-copy stacked weights: every step takes a param tree stacked on a
leading model axis ``M`` plus a model index — a singleton engine holds
an ``M=1`` stack (a view of its own weights), an engine adopted into a
fused group points at the group's tree.  The serial steps run the
fused bodies on a one-model slice of that tree (a view, no copy).

Shape stability: batches are padded to bucketed shapes — power-of-2
rows and block-multiple prompt lengths — exactly as the JAX package
pads them, so the two packages see the same batches; ``TRACE_COUNTS``
counts the distinct shape buckets each step ran at.

Compiled steps: on the card every step of every family runs as one
CUDA graph per shape bucket (``serving/graphs.py``, the JAX package's
``jitted_step``).  On CUDA tensors the attention, the SSD scan and the
MoE experts go through the Hopper kernels (``serving/cache_ops``,
``models/mamba2``, ``models/moe``), on CPU tensors through their plain
versions.  KV writes update the arena in place.  SSM state
(constant size) lives in per-slot arrays: ``ssm_state`` [L, slots, H,
P, N] float32 and ``conv_tail`` [L, slots, K-1, conv_dim]; a step
gathers its rows, runs, and writes the new state back into them.
"""
from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass, field
from functools import lru_cache, partial
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.config import BLOCK_TOKENS, ModelConfig, replace
from repro_torch.models import mamba2 as M2
from repro_torch.models.layers import (attn_qkv, embed_tokens, linear,
                                       lm_logits, mlp, rms_norm)
from repro_torch.models.moe import ffn
from repro_torch.serving import cache_ops, graphs
from repro_torch.serving.kvcache import ModelCacheView
from repro_torch.serving.metrics import RECORDER, traced


@dataclass
class Request:
    """One serving request, carrying its whole latency timeline.

    Timestamps are stamped from the owning scheduler's clock, so they
    live in one time domain — wall seconds for live serving, logical
    seconds under a deterministic clock (serving/driver.py):

      * ``arrival``      — trace arrival time (set by the submitter);
      * ``prefill_done`` — prefill job dispatched (admission time);
      * ``first_token``  — first output token committed (TTFT end);
      * ``finish``       — last token committed (E2E end).

    Degradation disposition: a request is never silently dropped —
    overload and fault handling either requeue it (``requeues`` counts
    the teardowns it survived; a finished request with ``requeues > 0``
    was *recovered*) or shed it (``shed`` set, ``finish`` stays −1 so it
    is an SLO miss at every scale, ``shed_reason`` says why).
    ``deadline`` is the absolute clock instant past which admission can
    no longer meet the request's scaled TTFT target (stamped by the
    driver under ``shed_policy="deadline"``; +inf = never
    deadline-shed).  ``cancelled`` is the client's abandonment
    (``MuxScheduler.cancel``), the third disposition beside finished
    and shed.
    """
    req_id: int
    model: str
    prompt: List[int]
    max_new_tokens: int
    arrival: float = 0.0
    # runtime state
    output: List[int] = field(default_factory=list)
    prefill_done: float = -1.0
    first_token: float = -1.0
    finish: float = -1.0
    deadline: float = float("inf")
    shed: bool = False
    shed_reason: str = ""
    requeues: int = 0
    cancelled: bool = False

    @property
    def done(self) -> bool:
        return len(self.output) >= self.max_new_tokens


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _next_pow2(x: int) -> int:
    """Smallest power of two ≥ x (bucketed batch rows)."""
    return 1 << max(0, (x - 1).bit_length())


def _pad_rows(rows: int, *specs):
    """Pad each ``(array, fill)`` to ``rows`` leading rows: −1 block
    tables (KV writes drop, attention resolves to a masked block), 0
    tokens/lengths (dead logits, sliced off host-side) and length-1
    decode rows (one masked garbage softmax)."""
    out = []
    for arr, fill in specs:
        p = np.full((rows,) + arr.shape[1:], fill, arr.dtype)
        p[:arr.shape[0]] = arr
        out.append(p)
    return out


def greedy_tokens(logits: torch.Tensor) -> np.ndarray:
    """Greedy next tokens on the host (the first maximum on ties, as
    ``jnp.argmax``).  A non-finite logit is a fault, never a token."""
    if not _all_finite(logits):
        raise FloatingPointError("non-finite logits in a serving step")
    return _host_argmax(logits)


@traced("readback.finite")
def _all_finite(logits: torch.Tensor) -> bool:
    """Whether every logit is finite: the host waits here for the step."""
    return bool(torch.isfinite(logits).all())


@traced("readback.tokens")
def _host_argmax(logits: torch.Tensor) -> np.ndarray:
    return logits.argmax(dim=-1).cpu().numpy()


def count_fill(kind: str, real: int, computed: int) -> None:
    """Count a step's ``real`` rows or tokens against the ``computed``
    ones its shape runs (``RECORDER`` counters ``<kind>.real`` and
    ``<kind>.computed``; ``kind`` is ``rows.decode`` or
    ``tokens.chunk``).  Call only while ``RECORDER`` is armed."""
    RECORDER.add(kind + ".real", real)
    RECORDER.add(kind + ".computed", computed)


# ---------------------------------------------------------------------------
# weight-tree accounting (zero-copy stacked weights)
# ---------------------------------------------------------------------------
def tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_bytes(tree) -> int:
    """Total bytes of every leaf in a param tree."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def unique_tree_bytes(trees) -> int:
    """Bytes of the *distinct* buffers across several param trees —
    engines of a fused group share one stacked tree, so the group pays
    ~1× (not M×) weight memory."""
    seen: set = set()
    total = 0
    for tree in trees:
        for t in tree_leaves(tree):
            key = (t.untyped_storage().data_ptr(), t.storage_offset())
            if key not in seen:
                seen.add(key)
                total += t.numel() * t.element_size()
    return total


# ---------------------------------------------------------------------------
# shape-bucket counting
# ---------------------------------------------------------------------------
# distinct (step, geometry, shapes) buckets each step kind has run at —
# the JAX package's TRACE_COUNTS (its compiled programs); bounded after
# warm-up when the bucketing holds.  The CUDA graphs captured on the
# card are counted apart (``graphs.GRAPH_CAPTURES``).
TRACE_COUNTS: Counter = Counter()
_BUCKETS: set = set()


def _note_step(kind: str, cfg: ModelConfig, *shapes) -> None:
    key = (kind, cfg, shapes)
    if key not in _BUCKETS:
        _BUCKETS.add(key)
        TRACE_COUNTS[kind] += 1


def total_traces() -> int:
    return sum(TRACE_COUNTS.values())


def _select_model(params, midx: int):
    """One model's ``[1, ...]`` slice of a stacked ``[M, ...]`` tree (a
    view — no weight copy)."""
    return tree_map(lambda a: a[midx:midx + 1], params)


@dataclass
class DecodeJob:
    """One engine's decode rows for the current tick, in export form.
    Block tables and lengths are resolved from the pool view at
    execution time."""
    slots: List[int]
    reqs: List[Request]
    seq_ids: List[int]
    last_tok: np.ndarray          # [B] int32 — token decoded this step

    def __len__(self) -> int:
        return len(self.reqs)


@dataclass
class PrefillJob:
    """One engine's in-flight prompt chunks for the current tick
    (exported unpadded — the runner owns the padding policy)."""
    slots: List[int]
    reqs: List[Request]
    seq_ids: List[int]
    toks: np.ndarray              # [B, C] int32 chunk tokens
    offs: np.ndarray              # [B] int32 absolute chunk start
    clens: np.ndarray             # [B] int32 true chunk lengths

    def __len__(self) -> int:
        return len(self.reqs)


class Engine:
    """Inference engine for one LLM (any family) over the shared pool."""

    def __init__(self, cfg: ModelConfig, params, view: ModelCacheView,
                 max_slots: int = 8, max_blocks_per_seq: int = 64,
                 chunk_tokens: Optional[int] = None,
                 clock=time.perf_counter):
        """``params``: the model's tree on the pool's device.
        ``chunk_tokens``: enable chunked prefill — prompts are processed
        ``chunk_tokens`` at a time, one chunk per scheduler tick
        (attention families against the pool, pure SSM through the
        mixer's state carry; hybrid keeps whole-prompt prefill)."""
        if cfg.family not in ("dense", "vlm", "audio", "moe", "ssm",
                              "hybrid"):
            raise ValueError(f"unknown family {cfg.family!r} ({cfg.name})")
        self.cfg = cfg
        self.clock = clock
        # steps are cached per *geometry*, not per model name
        self.cfg_key = replace(cfg, name="")
        self.view = view
        self.pool = view.pool
        self.max_slots = max_slots
        self.max_blocks = max_blocks_per_seq
        self.chunk_tokens = None if cfg.family == "hybrid" else chunk_tokens
        self.slots: List[Optional[Request]] = [None] * max_slots
        self.slot_seq: np.ndarray = np.full(max_slots, -1, np.int64)
        self.finished: List[Request] = []
        self.preempted: List[Request] = []      # evicted by stall escape
        self._prefilling = {}                   # slot → next prompt pos
        self._stall_ticks = 0
        self._rolled_rows: List[int] = []
        self._next_seq = 0
        # token-emission hook (serving/frontend.py): called as
        # ``emit(event, request, token)`` at every COMMITTED progress
        # point — "token" (an output token survived its reserve step;
        # rolled-back tokens never emit), "finish", "reset" (an eviction
        # cleared the request's progress).  Installed by
        # ``MuxScheduler.set_emit``; None = no streaming consumer.  The
        # tokens are on the host already when they commit: the hook
        # adds no device synchronisation.
        self.emit: Optional[Callable[[str, Request, int], None]] = None
        # SSM per-slot state
        self.ssm_state = self.conv_tail = None
        if cfg.ssm:
            sc = cfg.ssm
            conv_dim = cfg.d_inner + 2 * sc.n_groups * sc.d_state
            self.ssm_state = torch.zeros(
                (cfg.n_layers, max_slots, cfg.n_ssm_heads, sc.head_dim,
                 sc.d_state), dtype=torch.float32, device=self.pool.device)
            self.conv_tail = torch.zeros(
                (cfg.n_layers, max_slots, sc.conv_kernel - 1, conv_dim),
                dtype=params["tok"]["embed"].dtype, device=self.pool.device)
            # a decode's rows of the state before the step (rows 0..B-1),
            # which a rollback restores; written inside the step
            self._prev = (torch.empty_like(self.ssm_state),
                          torch.empty_like(self.conv_tail))
        # zero-copy weights: an M=1 stacked view of the engine's tree
        self.params = tree_map(lambda a: a.unsqueeze(0), params)
        self.model_index = 0
        ssm = "_ssm" if cfg.ssm else ""
        self._prefill_fn = step_fn("prefill" + ssm, self.cfg_key)
        self._decode_fn = step_fn("decode" + ssm, self.cfg_key)
        self._chunk_fn = step_fn("chunk" + ssm, self.cfg_key)

    # ------------------------------------------------------------------
    def adopt_stacked(self, stacked, model_index: int) -> None:
        """Point this engine at a fused group's shared stacked tree; the
        private ``[1, ...]`` tree is dropped."""
        self.params = stacked
        self.model_index = model_index

    def materialize_private(self, tree) -> None:
        """Inverse of ``adopt_stacked``: re-own ``tree``, a private
        ``[1, ...]`` copy of this engine's weights.  ``FusedGroup.dissolve``
        cuts the copies out of the stack leaf by leaf, dropping each
        stacked leaf as it goes (a slice of the stack would be a view
        that keeps the whole stack alive)."""
        self.params = tree
        self.model_index = 0

    def rebind_view(self, view: ModelCacheView) -> None:
        """Point the engine at a migrated cache view (and its pool).
        The view must carry this engine's live sequences — block tables
        and lengths are re-resolved from it on every step, so in-flight
        decodes continue without any engine-side fixup."""
        if view.cfg.name != self.cfg.name:
            raise ValueError(f"view of {view.cfg.name!r} for engine "
                             f"{self.cfg.name!r}")
        self.view = view
        self.pool = view.pool

    def evict_prefilling(self) -> List[Request]:
        """Evict every in-flight (chunk-phase) prefill: free its cache,
        reset its progress and hand the requests back for requeueing.
        Migration drains or carries per request — decodes carry their
        KV to the destination pool, but a half-written prompt is cheaper
        to restart than to move; greedy decoding makes the restart
        exact."""
        return [self._reset(slot) for slot in sorted(self._prefilling)]

    def _reset(self, slot: int) -> Request:
        """Free the sequence in ``slot`` and clear its request's
        progress (eviction: the request restarts from scratch, exact
        under greedy decoding)."""
        r = self.slots[slot]
        self.view.free_seq(int(self.slot_seq[slot]))
        self.slots[slot] = None
        self.slot_seq[slot] = -1
        self._prefilling.pop(slot, None)
        r.output.clear()
        r.prefill_done = -1.0
        r.first_token = -1.0
        if self.emit is not None:
            self.emit("reset", r, -1)
        return r

    def evict_seqs(self, seq_ids) -> List[Request]:
        """Evict specific live sequences (prefilling OR decoding): free
        their cache, reset request progress and hand the requests back
        for requeueing.  Crash recovery evicts every live sequence,
        block loss only those with pages in the lost arena tail."""
        wanted = set(int(s) for s in seq_ids)
        return [self._reset(slot) for slot in self.active_slots()
                if int(self.slot_seq[slot]) in wanted]

    def live_seq_ids(self) -> List[int]:
        """Sequence ids of every occupied slot (prefilling included)."""
        return [int(self.slot_seq[s]) for s in self.active_slots()]

    def _finish_slot(self, slot: int, r: Request) -> None:
        """Finalize a request: stamp ``finish``, free its cache and
        slot, hand it to ``finished``."""
        r.finish = self.clock()
        self.view.free_seq(int(self.slot_seq[slot]))
        self.slots[slot] = None
        self.slot_seq[slot] = -1
        self.finished.append(r)
        if self.emit is not None:
            self.emit("finish", r, -1)

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    def active_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is not None]

    def lifetime_blocks(self, req: Request) -> int:
        """Head-blocks this request needs over its whole lifetime
        (prompt + max_new tokens, plus SSM state pages)."""
        total = len(req.prompt) + req.max_new_tokens
        blocks = -(-total // BLOCK_TOKENS) * self.view.group_size
        if self.cfg.ssm:
            blocks += self.view._ssm_blocks_per_seq
        return blocks

    def can_admit(self, req: Request, pending_blocks: int = 0) -> bool:
        """Whether the request's whole-lifetime quota fits the current
        headroom; ``pending_blocks`` are lifetime blocks of requests
        already selected for the same batch but not yet reserved."""
        if not self.free_slots():
            return False
        # available_blocks counts evictable prefix-cache inventory:
        # cached blocks are disposable and must never starve admission
        return self.lifetime_blocks(req) + pending_blocks <= min(
            self.view.quota_headroom(), self.pool.available_blocks())

    # ------------------------------------------------------------------
    def prefill(self, reqs: List[Request]) -> int:
        """Run one prefill job for up to len(free_slots) requests.
        Returns prompt tokens processed (0 if nothing ran).  With
        ``chunk_tokens`` set, admits the requests and advances every
        in-flight prefill by one chunk instead."""
        if self.chunk_tokens:
            return self._prefill_chunked(reqs)
        reqs = reqs[:len(self.free_slots())]
        admitted = []
        pending = 0
        for r in reqs:
            if self.can_admit(r, pending):
                admitted.append(r)
                pending += self.lifetime_blocks(r)
        if not admitted:
            return 0
        B = len(admitted)
        # shape buckets: rows to the next power of two, prompt length to
        # the next BLOCK_TOKENS multiple (padded rows: −1 tables, 0 lens)
        Bp = _next_pow2(B)
        S = _round_up(max(len(r.prompt) for r in admitted), BLOCK_TOKENS)
        toks = np.zeros((B, S), np.int32)
        lens = np.zeros((B,), np.int32)
        slot_ids = self.free_slots()[:B]
        seq_ids = []
        for i, r in enumerate(admitted):
            lens[i] = len(r.prompt)
            toks[i, :lens[i]] = r.prompt
            sid = self._next_seq
            self._next_seq += 1
            seq_ids.append(sid)
            ok = self.view.append_tokens(sid, int(lens[i]))
            assert ok, "admission check guaranteed quota"
            self.slots[slot_ids[i]] = r
            self.slot_seq[slot_ids[i]] = sid
            r._seq_id = sid

        toks, lens, table = _pad_rows(
            Bp, (toks, 0), (lens, 0),
            (self.view.block_table(seq_ids, self.max_blocks), -1))
        if self.cfg.ssm:
            # the rows' new state goes into their slots inside the step
            logits = self._prefill_fn(
                self.params, self.model_index, toks, lens, self.pool, table,
                state=(self.ssm_state, self.conv_tail), slots=slot_ids)
        else:
            logits = self._prefill_fn(self.params, self.model_index, toks,
                                      lens, self.pool, table)
        nxt = greedy_tokens(logits[:B])
        for i, r in enumerate(admitted):
            if r.max_new_tokens <= 0:
                # prefill-only request: done at prompt end
                r.first_token = self.clock()
                self._finish_slot(slot_ids[i], r)
                continue
            # reserve BEFORE committing the token: on quota overcommit
            # the token is dropped and decode regenerates it
            if self.view.append_tokens(seq_ids[i], 1):
                r.output.append(int(nxt[i]))
                r.first_token = self.clock()
                if self.emit is not None:
                    self.emit("token", r, int(nxt[i]))
                if r.done:
                    self._finish_slot(slot_ids[i], r)
        return int(lens.sum())

    # ------------------------------------------------------------------
    def _adopt_prefix(self, sid: int, r: Request) -> int:
        """Consult the per-LLM prefix index at admission (DESIGN.md
        §13).  On a hit the cached prefix blocks are adopted read-only
        via ``share_prefix`` and prefill resumes at the first uncached
        block.  Chunked engines only: the chunk machinery starts at any
        offset, the whole-prompt path cannot resume mid-prompt.  Returns
        adopted tokens (0 = miss; always a BLOCK_TOKENS multiple ≤
        len(prompt) − 1, so prefill still computes the logits the first
        generated token needs)."""
        idx = self.view.prefix_index
        if idx is None:
            return 0
        hit, bases = idx.lookup(r.prompt)
        if hit and self.view.share_prefix(sid, bases, hit):
            return hit
        return 0

    def admit_chunked(self, reqs: List[Request]) -> None:
        """Host-side admission for chunked prefill: reserve the prompt
        (adopting a cached prefix where the index has one), bind a slot
        and mark it in-flight — no compute."""
        # prompts reserve immediately, so only the not-yet-reserved
        # growth of earlier admits carries into ``pending``
        pending = 0
        for r in reqs[:len(self.free_slots())]:
            if not self.free_slots():
                break
            if not self.can_admit(r, pending):
                continue
            slot = self.free_slots()[0]
            sid = self._next_seq
            self._next_seq += 1
            used_before = self.view.used
            hit = self._adopt_prefix(sid, r)
            ok = self.view.append_tokens(sid, len(r.prompt) - hit)
            if not ok and hit:
                # adoption landed but the private remainder could not
                # be carved out — drop the shared refs and admit the
                # request unshared (the lifetime check covered it)
                self.view.free_seq(sid)
                hit = 0
                ok = self.view.append_tokens(sid, len(r.prompt))
            assert ok, "admission check guaranteed quota"
            pending += self.lifetime_blocks(r) - (self.view.used
                                                  - used_before)
            self.slots[slot] = r
            self.slot_seq[slot] = sid
            r._seq_id = sid
            # prefill resumes at the first uncached token; completion
            # times stamp at prompt completion, whenever that is
            self._prefilling[slot] = hit

    @traced("plan.batch")
    def export_prefill_job(self) -> Optional[PrefillJob]:
        """Snapshot the in-flight chunk rows (None when nothing is
        prefilling)."""
        if not self._prefilling:
            return None
        C = self.chunk_tokens
        slots = sorted(self._prefilling)
        B = len(slots)
        toks = np.zeros((B, C), np.int32)
        offs = np.zeros((B,), np.int32)
        clens = np.zeros((B,), np.int32)
        for i, sl in enumerate(slots):
            r = self.slots[sl]
            pos = self._prefilling[sl]
            n = min(C, len(r.prompt) - pos)
            toks[i, :n] = r.prompt[pos:pos + n]
            offs[i] = pos
            clens[i] = n
        return PrefillJob(slots=slots, reqs=[self.slots[sl] for sl in slots],
                          seq_ids=[int(self.slot_seq[sl]) for sl in slots],
                          toks=toks, offs=offs, clens=clens)

    @traced("engine.commit")
    def apply_prefill_result(self, job: PrefillJob, nxt: np.ndarray) -> int:
        """Commit one chunk advance (shared by the serial and fused
        prefill paths); ``nxt`` is the greedy next token per job row."""
        done_tokens = 0
        for i, sl in enumerate(job.slots):
            r = self.slots[sl]
            self._prefilling[sl] += int(job.clens[i])
            done_tokens += int(job.clens[i])
            if self._prefilling[sl] >= len(r.prompt):
                del self._prefilling[sl]
                # prompt complete → its full blocks are final (decode
                # appends strictly past the prompt): index them before
                # _finish_slot, so prefill-only requests populate the
                # cache too (the index's own refs keep the blocks)
                idx = self.view.prefix_index
                if idx is not None:
                    idx.insert(r.prompt, self.view.seqs[r._seq_id].bases)
                if r.max_new_tokens <= 0:
                    r.first_token = self.clock()
                    self._finish_slot(sl, r)
                    continue
                if self.view.append_tokens(r._seq_id, 1):
                    r.output.append(int(nxt[i]))
                    r.first_token = self.clock()
                    if self.emit is not None:
                        self.emit("token", r, int(nxt[i]))
                    if r.done:
                        self._finish_slot(sl, r)
        return done_tokens

    def run_chunk_job(self, job: PrefillJob) -> int:
        """Advance one exported chunk job serially: one step over a
        power-of-2 row bucket."""
        B = len(job)
        Bp = _next_pow2(B)
        if RECORDER.on:
            count_fill("tokens.chunk", int(job.clens.sum()),
                       Bp * self.chunk_tokens)
        toks, offs, clens, table = self._chunk_batch(job, Bp)
        logits = self._chunk_fn(self.params, self.model_index, toks, offs,
                                clens, self.pool, table)
        return self.apply_prefill_result(job, greedy_tokens(logits[:B]))

    @traced("plan.batch")
    def _chunk_batch(self, job: PrefillJob, rows: int) -> list:
        """A chunk job's tokens, offsets, lengths and block table padded
        to ``rows`` rows."""
        return _pad_rows(
            rows, (job.toks, 0), (job.offs, 0), (job.clens, 0),
            (self.view.block_table(job.seq_ids, self.max_blocks), -1))

    def _prefill_chunked(self, reqs: List[Request]) -> int:
        self.admit_chunked(reqs)
        if not self._prefilling:
            return 0
        if self.cfg.ssm:
            return self._run_chunk_ssm()
        return self.run_chunk_job(self.export_prefill_job())

    def _run_chunk_ssm(self) -> int:
        """Chunk advance for pure-SSM engines (state carry, no pool):
        exact rows, fresh sequences start from zero state; the step reads
        and writes the rows' state in the engine's buffers."""
        job = self.export_prefill_job()
        if RECORDER.on:
            count_fill("tokens.chunk", int(job.clens.sum()), job.toks.size)
        logits = self._chunk_fn(
            self.params, self.model_index, job.toks, job.clens,
            self.ssm_state, self.conv_tail, slots=job.slots,
            fresh=job.offs == 0)
        return self.apply_prefill_result(job, greedy_tokens(logits))

    # ------------------------------------------------------------------
    @traced("plan.batch")
    def export_decode_job(self) -> Optional[DecodeJob]:
        """Active decode rows (prefilling slots excluded) plus per-row
        sequence identity; None when there is no decode work."""
        act = [s for s in self.active_slots() if s not in self._prefilling]
        if not act:
            return None
        reqs = [self.slots[i] for i in act]
        last = np.array([r.output[-1] if r.output else r.prompt[-1]
                         for r in reqs], np.int32)
        return DecodeJob(slots=act, reqs=reqs,
                         seq_ids=[r._seq_id for r in reqs], last_tok=last)

    @traced("engine.commit")
    def apply_decode_result(self, job: DecodeJob, nxt: np.ndarray) -> int:
        """Commit one decode step's tokens (shared by the serial and
        fused paths).  Rows that cannot reserve their next-token block
        roll back and retry next tick; the retry rewrites the same KV
        position with the same values (greedy), so the in-place write
        of the rolled-back step is harmless."""
        done_tokens = 0
        self._rolled_rows = []
        for i, r in enumerate(job.reqs):
            r.output.append(int(nxt[i]))
            done_tokens += 1
            if r.done:
                if r.first_token < 0:
                    r.first_token = self.clock()
                if self.emit is not None:
                    self.emit("token", r, int(nxt[i]))
                self._finish_slot(job.slots[i], r)
            else:
                ok = self.view.append_tokens(job.seq_ids[i], 1)
                if ok:
                    if r.first_token < 0:
                        r.first_token = self.clock()
                    # emit only AFTER the reserve validated: a token
                    # that rolls back was never committed
                    if self.emit is not None:
                        self.emit("token", r, int(nxt[i]))
                else:
                    r.output.pop()
                    done_tokens -= 1
                    self._rolled_rows.append(i)
        # stall escape: if EVERY row rolled back and nothing finished,
        # preempt the youngest sequence after two such ticks
        rollbacks = len(self._rolled_rows)
        if rollbacks and rollbacks == len(job.reqs):
            self._stall_ticks += 1
            if self._stall_ticks >= 2:
                self._preempt_youngest()
                self._stall_ticks = 0
        else:
            self._stall_ticks = 0
        return done_tokens

    def _preempt_youngest(self) -> None:
        """Evict the most recently admitted sequence and hand its
        request back via ``self.preempted`` (restart is exact under
        greedy decoding)."""
        act = [s for s in self.active_slots() if s not in self._prefilling]
        if not act:
            return
        slot = max(act, key=lambda s: self.slot_seq[s])
        self.preempted.append(self._reset(slot))

    def decode(self, job: Optional[DecodeJob] = None) -> int:
        """One decode step over all active slots.  Returns #tokens."""
        job = job or self.export_decode_job()
        if job is None:
            return 0
        if self.cfg.ssm:
            return self._decode_ssm(job)
        B = len(job)
        Bp = _next_pow2(B)
        if RECORDER.on:
            count_fill("rows.decode", B, Bp)
        last_tok, lens, table = self._decode_batch(job, Bp)
        logits = self._decode_fn(self.params, self.model_index, last_tok,
                                 lens, self.pool, table)
        return self.apply_decode_result(job, greedy_tokens(logits[:B]))

    @traced("plan.batch")
    def _decode_batch(self, job: DecodeJob, rows: int) -> tuple:
        """A decode job's last tokens, lengths (the reserved current
        token included) and block table, padded to ``rows`` rows."""
        lens = self.view.seq_lens(job.seq_ids)
        table = self.view.block_table(job.seq_ids, self.max_blocks)
        if rows == len(job):
            return job.last_tok, lens, table
        return tuple(_pad_rows(rows, (job.last_tok, 0), (lens, 1),
                               (table, -1)))

    def _decode_ssm(self, job: DecodeJob) -> int:
        """Decode step of an SSM/hybrid engine: exact rows (a bucket is a
        row count).  The step copies its rows of the state into
        ``_prev`` (rows 0..B-1) before it writes the new state into the
        slots; the rows that roll back are restored from there before the
        next step overwrites it: the SSM carry is not idempotent, so a
        retry must start from the pre-step state."""
        B = len(job)
        if RECORDER.on:
            count_fill("rows.decode", B, B)
        last_tok, lens, table = self._decode_batch(job, B)
        logits = self._decode_fn(
            self.params, self.model_index, last_tok, lens, self.pool,
            table, self.ssm_state, self.conv_tail, slots=job.slots,
            prev=self._prev)
        toks = self.apply_decode_result(job, greedy_tokens(logits))
        if self._rolled_rows:
            self._restore_rolled(job)
        return toks

    @traced("engine.commit")
    def _restore_rolled(self, job: DecodeJob) -> None:
        """Put back the pre-step state of the decode rows that rolled
        back (``_prev``'s rows 0..B-1)."""
        dev = self.pool.device
        ri = torch.tensor(self._rolled_rows, device=dev)
        sl = torch.tensor(job.slots, device=dev)[ri]
        self.ssm_state[:, sl] = self._prev[0][:, ri]
        self.conv_tail[:, sl] = self._prev[1][:, ri]

    def has_decode_work(self) -> bool:
        return any(s not in self._prefilling for s in self.active_slots())

    def has_prefill_work(self) -> bool:
        return bool(self._prefilling)

    # ------------------------------------------------------------------
    def fusion_signature(self) -> Optional[tuple]:
        """Key under which this engine's steps fuse with other colocated
        engines: everything that shapes the stacked tree and the fused
        computation (geometry, head layout, projection extras, vocab,
        param dtype, block-table width, chunk window).  None marks the
        engine fusion-ineligible (SSM/hybrid keep their own scan, MoE
        its own routed FFN): the scheduler runs it on the serial path."""
        cfg = self.cfg
        if not dense_attention(cfg):
            return None
        return (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
                cfg.n_kv_heads, cfg.hd, cfg.d_ff, cfg.vocab_size,
                cfg.qkv_bias, cfg.qk_norm, cfg.rope_theta, cfg.rms_eps,
                cfg.tie_embeddings, cfg.frontend_dim, cfg.n_prefix_tokens,
                str(self.params["tok"]["embed"].dtype), self.max_blocks,
                self.chunk_tokens)


# ---------------------------------------------------------------------------
# step functions
#
# Every step is split in two.  The host part (``_decode_inputs``,
# ``_chunk_inputs``, ``_prefill_inputs``, ``_ssm_inputs``) turns the
# numpy token / length / offset / table arrays of one bucket into
# fixed-shape arrays: the KV write plan (``cache_ops.plan_slots``: one
# entry per new token, so its length is the bucket's) and the slots of
# the SSM state rows included.  The device part (the ``_*_body``
# functions) takes device tensors only — no host data, no
# data-dependent shape — over ``bufs``, the buffers it reads and writes
# in place: the arena (``UnifiedKVPool.arena``, where the step reads the
# pool) and an SSM engine's state buffers.  The dense bodies run the
# layers over a param tree with a leading model axis M: matmuls batched
# over M, KV writes and attention over all M×R rows at once (each row's
# table resolves to its own model's blocks).  ``graphs.run_step`` runs
# the device part as a CUDA graph of its bucket on the card
# (``serving/graphs.py``) for every family, eagerly on the CPU and under
# ``graphs.disable_graphs()``.
# ---------------------------------------------------------------------------
def _to(dev, a, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=dev, dtype=dtype) if dtype is not None else t.to(dev)


def dense_attention(cfg: ModelConfig) -> bool:
    """The dense attention family (dense, vlm and audio without experts
    or SSM): the engines that fuse (``Engine.fusion_signature``)."""
    return cfg.family in ("dense", "vlm", "audio") and not cfg.ssm \
        and not cfg.moe


def _arena(pool) -> tuple:
    """A pool's whole K/V buffers (``UnifiedKVPool.arena``), or ``(k,
    v)`` of any object that has them."""
    return pool.arena() if hasattr(pool, "arena") else (pool.k, pool.v)


@traced("plan.inputs")
def _decode_inputs(toks, lens, tables, block_tokens: int) -> dict:
    """Host part of a decode step: toks [M, R] last tokens, lens [M, R]
    lengths incl. the current token, tables [M, R, W] group bases."""
    M, R = toks.shape
    flat = tables.reshape(M * R, -1)
    pos = lens.astype(np.int64) - 1
    return dict(toks=toks.astype(np.int64),
                lens=lens.reshape(-1).astype(np.int32), pos=pos,
                table=flat.astype(np.int32),
                **cache_ops.plan_slots(flat, pos.reshape(-1), 1,
                                       block_tokens))


@traced("plan.inputs")
def _chunk_inputs(toks, offs, clens, tables, block_tokens: int) -> dict:
    """Host part of a chunked-prefill step: toks [M, R, C], offs and
    clens [M, R], tables [M, R, W]."""
    M, R, C = toks.shape
    flat = tables.reshape(M * R, -1)
    return dict(toks=toks.astype(np.int64),
                offs=offs.reshape(-1).astype(np.int32),
                positions=(offs[..., None].astype(np.int64)
                           + np.arange(C)[None, None, :]),
                last=np.maximum(clens - 1, 0).astype(np.int64),
                table=flat.astype(np.int32),
                **cache_ops.plan_slots(flat, offs.reshape(-1), C,
                                       block_tokens))


@traced("plan.inputs")
def _prefill_inputs(toks, lens, table, block_tokens: int) -> dict:
    """Host part of a whole-prompt prefill with attention: toks [B, S],
    lens [B], table [B, W]; every row's prompt starts at position 0."""
    B, S = toks.shape
    return dict(toks=toks.astype(np.int64),
                positions=np.broadcast_to(np.arange(S, dtype=np.int64),
                                          (B, S)),
                last=np.maximum(lens - 1, 0).astype(np.int64),
                **cache_ops.plan_slots(table, np.zeros(B, np.int64), S,
                                       block_tokens))


@traced("plan.inputs")
def _state_rows(slots, rows: int) -> dict:
    """Which state slot each of a step's ``rows`` rows reads and writes:
    ``rows`` [rows], the slot, and ``take`` [rows], the row whose new
    state goes there.  A padded row (past ``len(slots)``) writes row 0's
    state onto row 0's slot: the same value twice, so the write is
    deterministic and changes nothing."""
    take = np.arange(rows, dtype=np.int64)
    take[len(slots):] = 0
    return dict(rows=np.asarray(slots, np.int64)[take], take=take)


def _slots(a) -> cache_ops.TokenSlots:
    return cache_ops.TokenSlots(a["src"], a["base"], a["off"], a["live"])


def _decode_body(params, bufs, a, *, cfg: ModelConfig) -> torch.Tensor:
    """Device part of a decode step over the arena ``bufs`` and
    ``_decode_inputs``' tensors ``a``.  Returns logits [M, R,
    vocab]."""
    pool_k, pool_v = bufs
    M, R = a["toks"].shape
    lp = params["layers"]
    n_h, n_kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    slots = _slots(a)
    pos_t = a["pos"][:, :, None]                                # [M,R,1]
    x = embed_tokens(params["tok"]["embed"], a["toks"])
    for li in range(cfg.n_layers):
        h = rms_norm(x, lp["ln1"][:, li], cfg.rms_eps)
        q, k, v = attn_qkv(h[:, :, None, :], lp, li, cfg, pos_t)
        cache_ops.write_slots(pool_k, pool_v, k.reshape(M * R, 1, n_kv, hd),
                              v.reshape(M * R, 1, n_kv, hd), slots, li, n_kv)
        phys = cache_ops.resolve_physical_blocks(a["table"], li, n_kv)
        o = cache_ops.fused_paged_decode_attention(
            q.reshape(M * R, n_h, hd).contiguous(), pool_k, pool_v, phys,
            a["lens"])
        x = x + linear(o.reshape(M, R, n_h * hd), lp["wo"][:, li])
        h = rms_norm(x, lp["ln2"][:, li], cfg.rms_eps)
        x = x + ffn(h, lp, li, cfg)
    return lm_logits(x, params["tok"], cfg)[..., :cfg.vocab_size]


def _chunk_body(params, bufs, a, *, cfg: ModelConfig) -> torch.Tensor:
    """Device part of a chunked-prefill step over the arena ``bufs`` and
    ``_chunk_inputs``' tensors ``a``.  Returns logits [M, R, vocab] at
    each row's last true token."""
    pool_k, pool_v = bufs
    M, R, C = a["toks"].shape
    lp = params["layers"]
    n_h, n_kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    slots = _slots(a)
    x = embed_tokens(params["tok"]["embed"], a["toks"])
    for li in range(cfg.n_layers):
        h = rms_norm(x, lp["ln1"][:, li], cfg.rms_eps)
        q, k, v = attn_qkv(h, lp, li, cfg, a["positions"])  # [M,R,C,{H,KV},hd]
        cache_ops.write_slots(pool_k, pool_v, k.reshape(M * R, C, n_kv, hd),
                              v.reshape(M * R, C, n_kv, hd), slots, li, n_kv)
        phys = cache_ops.resolve_physical_blocks(a["table"], li, n_kv)
        o = cache_ops.fused_paged_chunk_attention(
            q.reshape(M * R, C, n_h, hd).contiguous(), pool_k, pool_v, phys,
            a["offs"])
        x = x + linear(o.reshape(M, R, C, n_h * hd), lp["wo"][:, li])
        h = rms_norm(x, lp["ln2"][:, li], cfg.rms_eps)
        x = x + ffn(h, lp, li, cfg)
    idx = a["last"]                                               # [M,R]
    x_last = x.gather(2, idx[:, :, None, None].expand(M, R, 1, x.shape[-1]))
    return lm_logits(x_last[:, :, 0], params["tok"], cfg)[..., :cfg.vocab_size]


def _prefill_body(params, bufs, a, *, cfg: ModelConfig) -> torch.Tensor:
    """Device part of a whole-prompt prefill of one model (a ``[1, ...]``
    stacked tree) over the arena ``bufs`` and ``_prefill_inputs``'
    tensors ``a``: dense causal attention over the prompt (the
    flash-prefill kernel on CUDA), KV written into the arena.  Returns
    logits [1, B, vocab] at each row's last prompt token."""
    pool_k, pool_v = bufs
    B, S = a["toks"].shape
    lp = params["layers"]
    n_kv = cfg.n_kv_heads
    slots = _slots(a)
    positions = a["positions"][None]                            # [1,B,S]
    x = embed_tokens(params["tok"]["embed"], a["toks"][None])
    for li in range(cfg.n_layers):
        h = rms_norm(x, lp["ln1"][:, li], cfg.rms_eps)
        q, k, v = attn_qkv(h, lp, li, cfg, positions)      # [1,B,S,{H,KV},hd]
        o = cache_ops.flash_prefill(q[0].contiguous(), k[0].contiguous(),
                                    v[0].contiguous())
        cache_ops.write_slots(pool_k, pool_v, k[0], v[0], slots, li, n_kv)
        x = x + linear(o.reshape(1, B, S, -1), lp["wo"][:, li])
        h = rms_norm(x, lp["ln2"][:, li], cfg.rms_eps)
        x = x + ffn(h, lp, li, cfg)
    x_last = x[0, torch.arange(B, device=x.device), a["last"]]   # [B, d]
    return lm_logits(x_last[None], params["tok"], cfg)[..., :cfg.vocab_size]


def _on_model(body, midx: int):
    """``body`` on model ``midx``'s one-model slice of a stacked tree (a
    view), returning that model's logits [R, vocab]."""
    def run(params, bufs, a):
        return body(_select_model(params, midx), bufs, a)[0]
    return run


def _fused_decode_step(params, toks, lens, pool, tables, *,
                       cfg: ModelConfig) -> torch.Tensor:
    """Fused multi-LLM decode step: advances every row of every stacked
    model by one token.

    params: trees stacked on a leading [M] axis
    toks: [M, R] last tokens; lens: [M, R] lengths incl. the current
        token (1 on padded rows); tables: [M, R, W] group bases (−1 on
        padded rows, so their KV writes drop)
    Returns logits [M, R, vocab].
    """
    M, R = toks.shape
    _note_step("fused_decode", cfg, (M, R, tables.shape[2]))
    return graphs.run_step(
        "fused_decode", cfg, None, params, _arena(pool),
        _decode_inputs(toks, lens, tables, pool.block_tokens),
        partial(_decode_body, cfg=cfg))


def _fused_prefill_chunk_step(params, toks, offs, clens, pool, tables, *,
                              cfg: ModelConfig) -> torch.Tensor:
    """Fused multi-LLM chunked-prefill sweep: advances every in-flight
    prompt chunk of every stacked model by one window.

    toks: [M, R, C] chunk tokens (zero on padded rows)
    offs: [M, R] absolute chunk starts; clens: [M, R] true chunk
        lengths (0 on padded rows); tables: [M, R, W] (−1 padded)
    Garbage KV at padded positions (i ≥ clens) lands on future decode
    slots, which decode overwrites before attending.
    Returns logits [M, R, vocab] at each row's last true token.
    """
    M, R, C = toks.shape
    _note_step("fused_prefill_chunk", cfg, (M, R, C, tables.shape[2]))
    return graphs.run_step(
        "fused_prefill_chunk", cfg, None, params, _arena(pool),
        _chunk_inputs(toks, offs, clens, tables, pool.block_tokens),
        partial(_chunk_body, cfg=cfg))


def _prefill_step(params, midx, toks, lens, pool, table, *,
                  cfg: ModelConfig) -> torch.Tensor:
    """Whole-prompt prefill of one model: ``_prefill_body`` on its
    one-model slice.  toks: [B, S] (S a block multiple); lens: [B];
    table: [B, W].  Returns logits [B, vocab]."""
    B, S = toks.shape
    _note_step("prefill", cfg, (B, S, table.shape[1]))
    return graphs.run_step(
        "prefill", cfg, midx, params, _arena(pool),
        _prefill_inputs(toks, lens, table, pool.block_tokens),
        _on_model(partial(_prefill_body, cfg=cfg), midx))


def _prefill_chunk_step(params, midx, toks, offs, clens, pool, table, *,
                        cfg: ModelConfig) -> torch.Tensor:
    """Serial chunked prefill of one model: the fused sweep's body on its
    one-model slice.  toks [B, C]; offs, clens [B]; table [B, W]."""
    B, C = toks.shape
    _note_step("prefill_chunk", cfg, (B, C, table.shape[1]))
    return graphs.run_step(
        "chunk", cfg, midx, params, _arena(pool),
        _chunk_inputs(toks[None], offs[None], clens[None], table[None],
                      pool.block_tokens),
        _on_model(partial(_chunk_body, cfg=cfg), midx))


def _decode_step(params, midx, last_tok, lens, pool, table, *,
                 cfg: ModelConfig) -> torch.Tensor:
    """Serial decode of one model: the fused step's body on its
    one-model slice.  last_tok, lens [B] (lens incl. the current token,
    whose position is lens−1); table [B, W]."""
    _note_step("decode", cfg, (last_tok.shape[0], table.shape[1]))
    return graphs.run_step(
        "decode", cfg, midx, params, _arena(pool),
        _decode_inputs(last_tok[None], lens[None], table[None],
                       pool.block_tokens),
        _on_model(partial(_decode_body, cfg=cfg), midx))


# ---------------------------------------------------------------------------
# SSM / hybrid steps: one model's [L, ...] tree.  Each takes the state
# in one of two forms: an engine's buffers ``[L, slots, ...]`` with the
# step's slots (the new state is written into them inside the step,
# which returns logits only: the engine's path, captured on the card),
# or the rows' own caches ``[L, B, ...]`` (never written; the new state
# comes back in fresh buffers beside the logits; eager).
# ---------------------------------------------------------------------------
def _one_model(params, midx: int):
    """One model's unstacked tree (views of the stacked leaves)."""
    return tree_map(lambda a: a[midx], params)


def _on_one(body, midx: int):
    """``body`` on model ``midx``'s unstacked tree (views)."""
    def run(params, bufs, a):
        return body(_one_model(params, midx), bufs, a)
    return run


def _put_rows(buf, new, a) -> None:
    """Write the rows ``new`` [rows, ...] of one layer's state into their
    slots of ``buf`` [slots, ...] (``_state_rows``)."""
    buf.index_copy_(0, a["rows"], new.index_select(0, a["take"]).to(buf.dtype))


@traced("plan.inputs")
def _ssm_inputs(toks, valid, **extra) -> dict:
    """Host part of an SSM prefill or chunk: toks [B, S]; ``valid`` [B]
    the true length of each row (padded positions get dt = 0)."""
    S = toks.shape[1]
    return dict(toks=toks.astype(np.int64),
                mask=np.arange(S)[None, :] < valid[:, None],
                last=np.maximum(valid - 1, 0).astype(np.int64), **extra)


def _fresh_state(cfg: ModelConfig, rows: int, dtype, dev) -> tuple:
    """Empty ``(ssm_state, conv_tail)`` buffers of ``rows`` rows."""
    sc = cfg.ssm
    return (torch.empty((cfg.n_layers, rows, cfg.n_ssm_heads, sc.head_dim,
                         sc.d_state), dtype=torch.float32, device=dev),
            torch.empty((cfg.n_layers, rows, sc.conv_kernel - 1,
                         cfg.d_inner + 2 * sc.n_groups * sc.d_state),
                        dtype=dtype, device=dev))


def _prefill_ssm_body(p, bufs, a, *, cfg: ModelConfig) -> torch.Tensor:
    """Device part of a whole-prompt SSM / hybrid prefill over ``bufs``
    (the arena for hybrid, then ``ssm_state`` and ``conv_tail``) and
    ``_ssm_inputs``' tensors ``a``.  Returns logits [B, vocab]."""
    ssm_state, conv_tail = bufs[-2:]
    B, S = a["toks"].shape
    lp = p["layers"]
    x = embed_tokens(p["tok"]["embed"], a["toks"])
    if cfg.family == "hybrid":
        pool_k, pool_v = bufs[:2]
        slots = _slots(a)
        sa = p["shared_attn"]
    attn_li = 0
    for li in range(cfg.n_layers):
        h = rms_norm(x, lp["ln1"][li], cfg.rms_eps)
        out, st, tail = M2.mamba2_mixer(h, lp, li, cfg, return_cache=True,
                                        length_mask=a["mask"])
        _put_rows(ssm_state[li], st, a)
        _put_rows(conv_tail[li], tail, a)
        x = x + out
        if cfg.family == "hybrid" and (li + 1) % cfg.attn_every == 0:
            h = rms_norm(x, sa["ln1"][0], cfg.rms_eps)
            q, k, v = attn_qkv(h, sa, 0, cfg,
                               a["positions"])            # [B,S,{H,KV},hd]
            o = cache_ops.flash_prefill(q.contiguous(), k.contiguous(),
                                        v.contiguous())
            cache_ops.write_slots(pool_k, pool_v, k, v, slots, attn_li,
                                  cfg.n_kv_heads)
            attn_li += 1
            x = x + linear(o.reshape(B, S, -1), sa["wo"][0])
            x = x + mlp(rms_norm(x, sa["ln2"][0], cfg.rms_eps), sa, 0)
    x_last = x[torch.arange(B, device=x.device), a["last"]]       # [B, d]
    return lm_logits(x_last, p["tok"], cfg)[:, :cfg.vocab_size]


def _prefill_ssm_step(params, midx, toks, lens, pool, table, *,
                      cfg: ModelConfig, state=None, slots=None):
    """Whole-prompt prefill of an SSM or hybrid model: the mixer over
    the prompt (the SSD kernel on CUDA) with padded positions masked,
    and for hybrid the shared attention block after every
    ``attn_every`` layers (the flash-prefill kernel on CUDA; KV written
    into the pool at attention-layer index ``attn_li``).  Like the JAX
    package's engine, the hybrid path ignores ``sliding_window``.

    toks: [B, S] (S a block multiple); lens: [B]; table: [B, W]
    ``state`` (an engine's ``(ssm_state, conv_tail)``) and ``slots``
    (its slots of the first len(slots) rows; the rest are padding):
    the new state is written there and logits [B, vocab] returned.
    Without them returns (logits, ssm_state [L, B, H, P, N] f32,
    conv_tail [L, B, K-1, conv_dim]).
    """
    B, S = toks.shape
    _note_step("prefill", cfg, (B, S, table.shape[1]))
    hybrid = cfg.family == "hybrid"
    own = state is None
    if own:
        state = _fresh_state(cfg, B, params["tok"]["embed"].dtype,
                             pool.device)
        slots = range(B)
    host = _ssm_inputs(toks, lens, **_state_rows(slots, B))
    if hybrid:
        host.update(_prefill_inputs(toks, lens, table, pool.block_tokens))
    bufs = (_arena(pool) if hybrid else ()) + tuple(state)
    logits = graphs.run_step("prefill_ssm", cfg, midx, params, bufs, host,
                             _on_one(partial(_prefill_ssm_body, cfg=cfg),
                                     midx),
                             not own)
    return (logits, *state) if own else logits


def _chunk_ssm_body(p, bufs, a, *, cfg: ModelConfig) -> torch.Tensor:
    """Device part of a pure-SSM chunk over ``bufs`` = ``(ssm_state,
    conv_tail)``: each layer gathers the rows' carried state from their
    slots (zero where the row is ``fresh``), runs the mixer and writes
    the new state back.  Returns logits [B, vocab]."""
    ssm_state, conv_tail = bufs
    B = a["toks"].shape[0]
    lp = p["layers"]
    fresh = a["fresh"]
    x = embed_tokens(p["tok"]["embed"], a["toks"])
    for li in range(cfg.n_layers):
        st = ssm_state[li].index_select(0, a["rows"])
        tail = conv_tail[li].index_select(0, a["rows"])
        st = torch.where(fresh[:, None, None, None], 0.0, st)
        tail = torch.where(fresh[:, None, None], 0.0, tail)
        h = rms_norm(x, lp["ln1"][li], cfg.rms_eps)
        out, st, tail = M2.mamba2_mixer(
            h, lp, li, cfg, conv_tail=tail, ssm_state=st,
            return_cache=True, length_mask=a["mask"])
        _put_rows(ssm_state[li], st, a)
        _put_rows(conv_tail[li], tail, a)
        x = x + out
    x_last = x[torch.arange(B, device=x.device), a["last"]]
    return lm_logits(x_last, p["tok"], cfg)[:, :cfg.vocab_size]


def _prefill_chunk_ssm_step(params, midx, toks, clens, ssm_state, conv_tail,
                            *, cfg: ModelConfig, slots=None, fresh=None):
    """Chunked prefill of a pure-SSM model: the mixer's conv-tail +
    state carry IS the chunk boundary.  ``clens`` masks padded chunk
    positions (dt=0 ⇒ state frozen past the true chunk length).

    toks: [B, C]; clens: [B].  With ``slots`` [B], ``ssm_state`` /
    ``conv_tail`` are an engine's buffers: the rows' state is read from
    those slots (zero where ``fresh`` [B] is set), the new state written
    back, and logits [B, vocab] returned.  Without, they are the rows'
    carried caches, and the result is (logits, new ssm_state, new
    conv_tail)."""
    B, C = toks.shape
    _note_step("prefill_chunk_ssm", cfg, (B, C))
    own = slots is None
    if own:
        ssm_state, conv_tail = ssm_state.clone(), conv_tail.clone()
        slots, fresh = range(B), np.zeros(B, bool)
    host = _ssm_inputs(toks, clens, fresh=np.asarray(fresh, bool),
                       **_state_rows(slots, B))
    logits = graphs.run_step("chunk_ssm", cfg, midx, params,
                             (ssm_state, conv_tail), host,
                             _on_one(partial(_chunk_ssm_body, cfg=cfg), midx),
                             not own)
    return (logits, ssm_state, conv_tail) if own else logits


def _decode_ssm_body(p, bufs, a, *, cfg: ModelConfig) -> torch.Tensor:
    """Device part of an SSM / hybrid decode over ``bufs``: the arena
    for hybrid, then ``ssm_state``, ``conv_tail`` and the engine's
    ``prev`` pair.  Each layer copies its rows' state into rows 0..B-1
    of ``prev`` (what a rollback restores), steps from there and writes
    the new state into the slots.  Returns logits [B, vocab]."""
    ssm_state, conv_tail, prev_ssm, prev_tail = bufs[-4:]
    B = a["toks"].shape[0]
    lp = p["layers"]
    x = embed_tokens(p["tok"]["embed"], a["toks"])
    if cfg.family == "hybrid":
        pool_k, pool_v = bufs[:2]
        slots = _slots(a)
        pos_t = a["pos"][:, None]                                   # [B, 1]
        sa = p["shared_attn"]
    n_h, n_kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    attn_li = 0
    for li in range(cfg.n_layers):
        st, tail = prev_ssm[li, :B], prev_tail[li, :B]
        torch.index_select(ssm_state[li], 0, a["rows"], out=st)
        torch.index_select(conv_tail[li], 0, a["rows"], out=tail)
        h = rms_norm(x, lp["ln1"][li], cfg.rms_eps)
        out, tail, st = M2.mamba2_decode_step(h, lp, li, cfg, tail, st)
        _put_rows(ssm_state[li], st, a)
        _put_rows(conv_tail[li], tail, a)
        x = x + out
        if cfg.family == "hybrid" and (li + 1) % cfg.attn_every == 0:
            h = rms_norm(x, sa["ln1"][0], cfg.rms_eps)
            q, k, v = attn_qkv(h[:, None, :], sa, 0, cfg, pos_t)
            cache_ops.write_slots(pool_k, pool_v, k, v, slots, attn_li, n_kv)
            phys = cache_ops.resolve_physical_blocks(a["table"], attn_li,
                                                     n_kv)
            o = cache_ops.fused_paged_decode_attention(
                q.reshape(B, n_h, hd).contiguous(), pool_k, pool_v, phys,
                a["lens"])
            attn_li += 1
            x = x + linear(o.reshape(B, n_h * hd), sa["wo"][0])
            x = x + mlp(rms_norm(x, sa["ln2"][0], cfg.rms_eps), sa, 0)
    return lm_logits(x, p["tok"], cfg)[:, :cfg.vocab_size]


def _decode_ssm_step(params, midx, last_tok, lens, pool, table, ssm_state,
                     conv_tail, *, cfg: ModelConfig, slots=None, prev=None):
    """One decode step of an SSM or hybrid model: ``mamba2_decode_step``
    per layer and, for hybrid, the shared attention block over the pool
    (the paged-decode kernel on CUDA) after every ``attn_every``
    layers.  last_tok, lens [B] (lens incl. the current token, whose
    position is lens−1); table [B, W].  With ``slots`` [B] and ``prev``
    (an engine's pair of pre-step buffers), ``ssm_state`` / ``conv_tail``
    are the engine's buffers: the step reads and writes the slots' rows
    and returns logits [B, vocab].  Without, they are the rows' caches,
    and the result is (logits, new ssm_state, new conv_tail)."""
    B = last_tok.shape[0]
    _note_step("decode", cfg, (B, table.shape[1]))
    own = slots is None
    if own:
        prev = (torch.empty_like(ssm_state), torch.empty_like(conv_tail))
        ssm_state, conv_tail = ssm_state.clone(), conv_tail.clone()
        slots = range(B)
    host = dict(toks=last_tok.astype(np.int64), **_state_rows(slots, B))
    hybrid = cfg.family == "hybrid"
    if hybrid:
        plan = _decode_inputs(last_tok[None], lens[None], table[None],
                              pool.block_tokens)
        host.update(plan, toks=host["toks"], pos=plan["pos"][0])
    bufs = (_arena(pool) if hybrid else ()) + (ssm_state, conv_tail) \
        + tuple(prev)
    logits = graphs.run_step("decode_ssm", cfg, midx, params, bufs, host,
                             _on_one(partial(_decode_ssm_body, cfg=cfg),
                                     midx),
                             not own)
    return (logits, ssm_state, conv_tail) if own else logits


_STEP_TABLE = {
    "prefill": _prefill_step,
    "decode": _decode_step,
    "chunk": _prefill_chunk_step,
    "prefill_ssm": _prefill_ssm_step,
    "decode_ssm": _decode_ssm_step,
    "chunk_ssm": _prefill_chunk_ssm_step,
    "fused_decode": _fused_decode_step,
    "fused_prefill_chunk": _fused_prefill_chunk_step,
}


@lru_cache(maxsize=None)
def step_fn(kind: str, cfg_key: ModelConfig):
    """The step ``kind`` bound to a geometry, shared by every engine with
    the same ``cfg_key`` (the model name stripped)."""
    return partial(_STEP_TABLE[kind], cfg=cfg_key)
