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
counts the distinct shape buckets each step ran at (the set a CUDA
graph per bucket would capture).

The step functions run eagerly; on CUDA tensors the attention and the
SSD scan go through the Hopper kernels (``serving/cache_ops``,
``models/mamba2``), on CPU tensors through their plain versions.  KV
writes update the arena in place.  SSM state (constant size) lives in
per-slot arrays: ``ssm_state`` [L, slots, H, P, N] float32 and
``conv_tail`` [L, slots, K-1, conv_dim].
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
from repro_torch.serving import cache_ops
from repro_torch.serving.kvcache import ModelCacheView


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
    if not bool(torch.isfinite(logits).all()):
        raise FloatingPointError("non-finite logits in a serving step")
    return logits.argmax(dim=-1).cpu().numpy()


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
# the JAX package's TRACE_COUNTS; bounded after warm-up when the
# bucketing holds
TRACE_COUNTS: Counter = Counter()
_BUCKETS: set = set()


def _note_step(kind: str, cfg: ModelConfig, *shapes) -> None:
    key = (kind, cfg, shapes)
    if key not in _BUCKETS:
        _BUCKETS.add(key)
        TRACE_COUNTS[kind] += 1


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
        out = self._prefill_fn(self.params, self.model_index, toks, lens,
                               self.pool, table)
        if self.cfg.ssm:
            logits, new_ssm, new_tail = out
            sl = torch.tensor(slot_ids, device=self.pool.device)
            self.ssm_state[:, sl] = new_ssm[:, :B]
            self.conv_tail[:, sl] = new_tail[:, :B].to(self.conv_tail.dtype)
        else:
            logits = out
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
    def admit_chunked(self, reqs: List[Request]) -> None:
        """Host-side admission for chunked prefill: reserve the prompt,
        bind a slot and mark it in-flight — no compute."""
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
            ok = self.view.append_tokens(sid, len(r.prompt))
            assert ok, "admission check guaranteed quota"
            pending += self.lifetime_blocks(r) - (self.view.used
                                                  - used_before)
            self.slots[slot] = r
            self.slot_seq[slot] = sid
            r._seq_id = sid
            self._prefilling[slot] = 0

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
        toks, offs, clens, table = _pad_rows(
            Bp, (job.toks, 0), (job.offs, 0), (job.clens, 0),
            (self.view.block_table(job.seq_ids, self.max_blocks), -1))
        logits = self._chunk_fn(self.params, self.model_index, toks, offs,
                                clens, self.pool, table)
        return self.apply_prefill_result(job, greedy_tokens(logits[:B]))

    def _prefill_chunked(self, reqs: List[Request]) -> int:
        self.admit_chunked(reqs)
        if not self._prefilling:
            return 0
        if self.cfg.ssm:
            return self._run_chunk_ssm()
        return self.run_chunk_job(self.export_prefill_job())

    def _run_chunk_ssm(self) -> int:
        """Chunk advance for pure-SSM engines (state carry, no pool):
        exact rows, fresh sequences start from zero state."""
        job = self.export_prefill_job()
        sl = torch.tensor(job.slots, device=self.pool.device)
        st = self.ssm_state[:, sl]                  # gathered copies
        tail = self.conv_tail[:, sl]
        fresh = torch.from_numpy(job.offs == 0).to(self.pool.device)
        st[:, fresh] = 0
        tail[:, fresh] = 0
        logits, new_st, new_tail = self._chunk_fn(
            self.params, self.model_index, job.toks, job.clens, st, tail)
        self.ssm_state[:, sl] = new_st
        self.conv_tail[:, sl] = new_tail.to(self.conv_tail.dtype)
        return self.apply_prefill_result(job, greedy_tokens(logits))

    # ------------------------------------------------------------------
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
        lens = self.view.seq_lens(job.seq_ids)  # incl. reserved current token
        table = self.view.block_table(job.seq_ids, self.max_blocks)
        last_tok = job.last_tok
        Bp = _next_pow2(B)
        if Bp != B:
            last_tok, lens, table = _pad_rows(
                Bp, (job.last_tok, 0), (lens, 1), (table, -1))
        logits = self._decode_fn(self.params, self.model_index, last_tok,
                                 lens, self.pool, table)
        return self.apply_decode_result(job, greedy_tokens(logits[:B]))

    def _decode_ssm(self, job: DecodeJob) -> int:
        """Decode step of an SSM/hybrid engine: exact rows (the per-slot
        state scatter must not see padded duplicates).  The step's rows
        of the state are gathered (a copy) before the step and restored
        for the rows that roll back: the SSM carry is not idempotent,
        so a retry must start from the pre-step state."""
        lens = self.view.seq_lens(job.seq_ids)
        table = self.view.block_table(job.seq_ids, self.max_blocks)
        sl = torch.tensor(job.slots, device=self.pool.device)
        prev_ssm = self.ssm_state[:, sl]
        prev_tail = self.conv_tail[:, sl]
        logits, new_ssm, new_tail = self._decode_fn(
            self.params, self.model_index, job.last_tok, lens, self.pool,
            table, prev_ssm, prev_tail)
        self.ssm_state[:, sl] = new_ssm
        self.conv_tail[:, sl] = new_tail.to(self.conv_tail.dtype)
        toks = self.apply_decode_result(job, greedy_tokens(logits))
        if self._rolled_rows:
            ri = torch.tensor(self._rolled_rows, device=self.pool.device)
            self.ssm_state[:, sl[ri]] = prev_ssm[:, ri]
            self.conv_tail[:, sl[ri]] = prev_tail[:, ri]
        return toks

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
        if cfg.family not in ("dense", "vlm", "audio") or cfg.ssm \
                or cfg.moe:
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
# Each takes host (numpy) token/length/table arrays, moves them to the
# pool's device once, plans the step's KV writes once (token slots), and
# runs the layers over a param tree with a leading model axis M —
# matmuls batched over M, KV writes and attention over all M×R rows at
# once (each row's table resolves to its own model's blocks).
# ---------------------------------------------------------------------------
def _to(dev, a, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=dev, dtype=dtype) if dtype is not None else t.to(dev)


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
    W = tables.shape[2]
    _note_step("fused_decode", cfg, (M, R, W))
    dev = pool.device
    lp = params["layers"]
    n_h, n_kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pos = lens.astype(np.int64) - 1
    slots = cache_ops.token_slots(tables.reshape(M * R, W), pos.reshape(-1),
                                  1, pool.block_tokens, dev)
    flat_table = _to(dev, tables.reshape(M * R, W))
    flat_lens = _to(dev, lens.reshape(M * R), torch.int32)
    pos_t = _to(dev, pos)[:, :, None]                           # [M,R,1]
    x = embed_tokens(params["tok"]["embed"], _to(dev, toks, torch.int64))
    for li in range(cfg.n_layers):
        h = rms_norm(x, lp["ln1"][:, li], cfg.rms_eps)
        q, k, v = attn_qkv(h[:, :, None, :], lp, li, cfg, pos_t)
        cache_ops.write_slots(pool.k, pool.v, k.reshape(M * R, 1, n_kv, hd),
                              v.reshape(M * R, 1, n_kv, hd), slots, li, n_kv)
        phys = cache_ops.resolve_physical_blocks(flat_table, li, n_kv)
        o = cache_ops.fused_paged_decode_attention(
            q.reshape(M * R, n_h, hd).contiguous(), pool.k, pool.v, phys,
            flat_lens)
        x = x + linear(o.reshape(M, R, n_h * hd), lp["wo"][:, li])
        h = rms_norm(x, lp["ln2"][:, li], cfg.rms_eps)
        x = x + ffn(h, lp, li, cfg)
    return lm_logits(x, params["tok"], cfg)[..., :cfg.vocab_size]


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
    W = tables.shape[2]
    _note_step("fused_prefill_chunk", cfg, (M, R, C, W))
    dev = pool.device
    lp = params["layers"]
    n_h, n_kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    slots = cache_ops.token_slots(tables.reshape(M * R, W), offs.reshape(-1),
                                  C, pool.block_tokens, dev)
    flat_table = _to(dev, tables.reshape(M * R, W))
    flat_offs = _to(dev, offs.reshape(M * R), torch.int32)
    positions = _to(dev, offs[..., None].astype(np.int64)
                    + np.arange(C)[None, None, :])              # [M,R,C]
    x = embed_tokens(params["tok"]["embed"], _to(dev, toks, torch.int64))
    for li in range(cfg.n_layers):
        h = rms_norm(x, lp["ln1"][:, li], cfg.rms_eps)
        q, k, v = attn_qkv(h, lp, li, cfg, positions)     # [M,R,C,{H,KV},hd]
        cache_ops.write_slots(pool.k, pool.v, k.reshape(M * R, C, n_kv, hd),
                              v.reshape(M * R, C, n_kv, hd), slots, li, n_kv)
        phys = cache_ops.resolve_physical_blocks(flat_table, li, n_kv)
        o = cache_ops.fused_paged_chunk_attention(
            q.reshape(M * R, C, n_h, hd).contiguous(), pool.k, pool.v, phys,
            flat_offs)
        x = x + linear(o.reshape(M, R, C, n_h * hd), lp["wo"][:, li])
        h = rms_norm(x, lp["ln2"][:, li], cfg.rms_eps)
        x = x + ffn(h, lp, li, cfg)
    idx = _to(dev, np.maximum(clens - 1, 0), torch.int64)      # [M,R]
    x_last = x.gather(2, idx[:, :, None, None].expand(M, R, 1, x.shape[-1]))
    return lm_logits(x_last[:, :, 0], params["tok"], cfg)[..., :cfg.vocab_size]


def _prefill_step(params, midx, toks, lens, pool, table, *,
                  cfg: ModelConfig) -> torch.Tensor:
    """Whole-prompt prefill of one model: dense causal attention over
    the prompt (the flash-prefill kernel on CUDA), KV written into the
    pool, logits at each row's last prompt token.

    toks: [B, S] (S a block multiple); lens: [B]; table: [B, W]
    Returns logits [B, vocab].
    """
    B, S = toks.shape
    _note_step("prefill", cfg, (B, S, table.shape[1]))
    dev = pool.device
    p = _select_model(params, midx)
    lp = p["layers"]
    n_kv, hd = cfg.n_kv_heads, cfg.hd
    slots = cache_ops.token_slots(table, np.zeros(B, np.int64), S,
                                  pool.block_tokens, dev)
    positions = torch.arange(S, device=dev).expand(1, B, S)
    x = embed_tokens(p["tok"]["embed"], _to(dev, toks, torch.int64)[None])
    for li in range(cfg.n_layers):
        h = rms_norm(x, lp["ln1"][:, li], cfg.rms_eps)
        q, k, v = attn_qkv(h, lp, li, cfg, positions)      # [1,B,S,{H,KV},hd]
        o = cache_ops.flash_prefill(q[0].contiguous(), k[0].contiguous(),
                                    v[0].contiguous())
        cache_ops.write_slots(pool.k, pool.v, k[0], v[0], slots, li, n_kv)
        x = x + linear(o.reshape(1, B, S, -1), lp["wo"][:, li])
        h = rms_norm(x, lp["ln2"][:, li], cfg.rms_eps)
        x = x + ffn(h, lp, li, cfg)
    idx = _to(dev, np.maximum(lens - 1, 0), torch.int64)
    x_last = x[0, torch.arange(B, device=dev), idx]              # [B, d]
    return lm_logits(x_last[None], p["tok"], cfg)[0, :, :cfg.vocab_size]


def _prefill_chunk_step(params, midx, toks, offs, clens, pool, table, *,
                        cfg: ModelConfig) -> torch.Tensor:
    """Serial chunked prefill of one model: the fused sweep on its
    one-model slice.  toks [B, C]; offs, clens [B]; table [B, W]."""
    logits = _fused_prefill_chunk_step(
        _select_model(params, midx), toks[None], offs[None], clens[None],
        pool, table[None], cfg=cfg)
    return logits[0]


def _decode_step(params, midx, last_tok, lens, pool, table, *,
                 cfg: ModelConfig) -> torch.Tensor:
    """Serial decode of one model: the fused step on its one-model
    slice.  last_tok, lens [B] (lens incl. the current token, whose
    position is lens−1); table [B, W]."""
    logits = _fused_decode_step(_select_model(params, midx), last_tok[None],
                                lens[None], pool, table[None], cfg=cfg)
    return logits[0]


# ---------------------------------------------------------------------------
# SSM / hybrid steps: one model's [L, ...] tree, per-slot state in and
# out (the inputs are never written: the engine restores rolled-back
# rows from them)
# ---------------------------------------------------------------------------
def _one_model(params, midx: int):
    """One model's unstacked tree (views of the stacked leaves)."""
    return tree_map(lambda a: a[midx], params)


def _prefill_ssm_step(params, midx, toks, lens, pool, table, *,
                      cfg: ModelConfig):
    """Whole-prompt prefill of an SSM or hybrid model: the mixer over
    the prompt (the SSD kernel on CUDA) with padded positions masked,
    and for hybrid the shared attention block after every
    ``attn_every`` layers (the flash-prefill kernel on CUDA; KV written
    into the pool at attention-layer index ``attn_li``).  Like the JAX
    package's engine, the hybrid path ignores ``sliding_window``.

    toks: [B, S] (S a block multiple); lens: [B]; table: [B, W]
    Returns (logits [B, vocab], ssm_state [L, B, H, P, N] f32,
    conv_tail [L, B, K-1, conv_dim]).
    """
    B, S = toks.shape
    _note_step("prefill", cfg, (B, S, table.shape[1]))
    dev = pool.device
    p = _one_model(params, midx)
    lp = p["layers"]
    x = embed_tokens(p["tok"]["embed"], _to(dev, toks, torch.int64))
    lens_t = _to(dev, lens, torch.int64)
    mask = torch.arange(S, device=dev)[None, :] < lens_t[:, None]
    sc = cfg.ssm
    new_ssm = torch.empty((cfg.n_layers, B, cfg.n_ssm_heads, sc.head_dim,
                           sc.d_state), dtype=torch.float32, device=dev)
    new_tail = torch.empty((cfg.n_layers, B, sc.conv_kernel - 1,
                            cfg.d_inner + 2 * sc.n_groups * sc.d_state),
                           dtype=x.dtype, device=dev)
    if cfg.family == "hybrid":
        slots = cache_ops.token_slots(table, np.zeros(B, np.int64), S,
                                      pool.block_tokens, dev)
        positions = torch.arange(S, device=dev).expand(B, S)
        sa = p["shared_attn"]
    attn_li = 0
    for li in range(cfg.n_layers):
        h = rms_norm(x, lp["ln1"][li], cfg.rms_eps)
        out, new_ssm[li], new_tail[li] = M2.mamba2_mixer(
            h, lp, li, cfg, return_cache=True, length_mask=mask)
        x = x + out
        if cfg.family == "hybrid" and (li + 1) % cfg.attn_every == 0:
            h = rms_norm(x, sa["ln1"][0], cfg.rms_eps)
            q, k, v = attn_qkv(h, sa, 0, cfg, positions)   # [B,S,{H,KV},hd]
            o = cache_ops.flash_prefill(q.contiguous(), k.contiguous(),
                                        v.contiguous())
            cache_ops.write_slots(pool.k, pool.v, k, v, slots, attn_li,
                                  cfg.n_kv_heads)
            attn_li += 1
            x = x + linear(o.reshape(B, S, -1), sa["wo"][0])
            x = x + mlp(rms_norm(x, sa["ln2"][0], cfg.rms_eps), sa, 0)
    idx = _to(dev, np.maximum(lens - 1, 0), torch.int64)
    x_last = x[torch.arange(B, device=dev), idx]                 # [B, d]
    logits = lm_logits(x_last, p["tok"], cfg)[:, :cfg.vocab_size]
    return logits, new_ssm, new_tail


def _prefill_chunk_ssm_step(params, midx, toks, clens, ssm_state, conv_tail,
                            *, cfg: ModelConfig):
    """Chunked prefill of a pure-SSM model: the mixer's conv-tail +
    state carry IS the chunk boundary.  ``clens`` masks padded chunk
    positions (dt=0 ⇒ state frozen past the true chunk length).

    toks: [B, C]; clens: [B]; ssm_state / conv_tail: the rows' carried
    caches.  Returns (logits [B, vocab], new ssm_state, new conv_tail).
    """
    B, C = toks.shape
    _note_step("prefill_chunk_ssm", cfg, (B, C))
    dev = ssm_state.device
    p = _one_model(params, midx)
    lp = p["layers"]
    x = embed_tokens(p["tok"]["embed"], _to(dev, toks, torch.int64))
    clens_t = _to(dev, clens, torch.int64)
    mask = torch.arange(C, device=dev)[None, :] < clens_t[:, None]
    new_ssm, new_tail = torch.empty_like(ssm_state), torch.empty_like(
        conv_tail)
    for li in range(cfg.n_layers):
        h = rms_norm(x, lp["ln1"][li], cfg.rms_eps)
        out, new_ssm[li], new_tail[li] = M2.mamba2_mixer(
            h, lp, li, cfg, conv_tail=conv_tail[li], ssm_state=ssm_state[li],
            return_cache=True, length_mask=mask)
        x = x + out
    x_last = x[torch.arange(B, device=dev), (clens_t - 1).clamp(min=0)]
    logits = lm_logits(x_last, p["tok"], cfg)[:, :cfg.vocab_size]
    return logits, new_ssm, new_tail


def _decode_ssm_step(params, midx, last_tok, lens, pool, table, ssm_state,
                     conv_tail, *, cfg: ModelConfig):
    """One decode step of an SSM or hybrid model: ``mamba2_decode_step``
    per layer and, for hybrid, the shared attention block over the pool
    (the paged-decode kernel on CUDA) after every ``attn_every``
    layers.  last_tok, lens [B] (lens incl. the current token, whose
    position is lens−1); table [B, W]; ssm_state / conv_tail the rows'
    caches.  Returns (logits [B, vocab], new ssm_state, new conv_tail).
    """
    B = last_tok.shape[0]
    _note_step("decode", cfg, (B, table.shape[1]))
    dev = ssm_state.device
    p = _one_model(params, midx)
    lp = p["layers"]
    x = embed_tokens(p["tok"]["embed"], _to(dev, last_tok, torch.int64))
    new_ssm, new_tail = torch.empty_like(ssm_state), torch.empty_like(
        conv_tail)
    if cfg.family == "hybrid":
        pos = lens.astype(np.int64) - 1
        slots = cache_ops.token_slots(table, pos, 1, pool.block_tokens, dev)
        table_t = _to(dev, table)
        lens_t = _to(dev, lens, torch.int32)
        pos_t = _to(dev, pos)[:, None]                              # [B, 1]
        sa = p["shared_attn"]
    n_h, n_kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    attn_li = 0
    for li in range(cfg.n_layers):
        h = rms_norm(x, lp["ln1"][li], cfg.rms_eps)
        out, new_tail[li], new_ssm[li] = M2.mamba2_decode_step(
            h, lp, li, cfg, conv_tail[li], ssm_state[li])
        x = x + out
        if cfg.family == "hybrid" and (li + 1) % cfg.attn_every == 0:
            h = rms_norm(x, sa["ln1"][0], cfg.rms_eps)
            q, k, v = attn_qkv(h[:, None, :], sa, 0, cfg, pos_t)
            cache_ops.write_slots(pool.k, pool.v, k, v, slots, attn_li, n_kv)
            phys = cache_ops.resolve_physical_blocks(table_t, attn_li, n_kv)
            o = cache_ops.fused_paged_decode_attention(
                q.reshape(B, n_h, hd).contiguous(), pool.k, pool.v, phys,
                lens_t)
            attn_li += 1
            x = x + linear(o.reshape(B, n_h * hd), sa["wo"][0])
            x = x + mlp(rms_norm(x, sa["ln2"][0], cfg.rms_eps), sa, 0)
    logits = lm_logits(x, p["tok"], cfg)[:, :cfg.vocab_size]
    return logits, new_ssm, new_tail


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
