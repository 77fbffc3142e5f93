"""Unified head-wise KV cache pool (port of ``repro/serving/kvcache.py``).

The pool is a single arena of *head-blocks*: each block holds
``BLOCK_TOKENS`` tokens of one KV head (``[BLOCK_TOKENS, head_dim]``).
Because the block shape is model-independent, LLMs of different
depths/head-counts share one memory space.  ADBS enforces per-LLM
head-block quotas and re-allocates them at runtime (paper Alg. 3).

Allocation granularity: within one LLM, a logical *token block* (16
tokens of one sequence) needs ``n_layers × n_kv_heads`` head-blocks,
allocated as one contiguous range ("group") so the device-side block
table is a single base id per token block and the physical index is
``base + layer*KV + head``.

The host-side bookkeeping (allocator, views, tables) is the JAX
package's line for line; the arena is a pair of torch tensors on the
pool's device, and ``grow``/``shrink`` reallocate them.  The prefix
cache, fault-injection victims and cross-pool migration arrive with
their slices.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import BLOCK_TOKENS, ModelConfig


class BlockAllocator:
    """First-fit contiguous range allocator over head-blocks (host side).

    Free space kept as a sorted list of ``[start, end)`` ranges.

    Blocks carry the JAX package's refcounts (DESIGN.md §13): ``alloc``
    hands out ranges at refcount 1 and ``free`` drops one holder, a
    block returning to the free list when its last holder lets go.
    ``used`` is refcount-weighted, ``physical_used`` counts distinct
    live blocks (``free_blocks`` derives from it); until the prefix
    cache adds shared holders the two are equal.
    """

    def __init__(self, n_blocks: int):
        self.n_blocks = n_blocks
        self._free: List[Tuple[int, int]] = [(0, n_blocks)]
        self._refs: Dict[int, int] = {}
        self.used = 0
        self.physical_used = 0

    def alloc(self, n: int) -> Optional[int]:
        for i, (s, e) in enumerate(self._free):
            if e - s >= n:
                if e - s == n:
                    self._free.pop(i)
                else:
                    self._free[i] = (s + n, e)
                self.used += n
                self.physical_used += n
                for b in range(s, s + n):
                    self._refs[b] = 1
                return s
        return None

    def refcounts(self) -> Dict[int, int]:
        """Copy of the live refcount map (tests/debugging)."""
        return dict(self._refs)

    def free_ranges(self) -> List[Tuple[int, int]]:
        """Copy of the sorted free list (sanitizer/tests) — half-open
        ``(start, end)`` ranges."""
        return list(self._free)

    def free(self, start: int, n: int) -> None:
        """Drop one holder per block; blocks reaching refcount 0 are
        coalesced back into the free list.  Freeing a dead block
        raises — a double free would corrupt a later allocation."""
        if n <= 0:
            return
        refs = self._refs
        runs: List[Tuple[int, int]] = []   # maximal runs reaching 0
        run_s: Optional[int] = None
        for b in range(start, start + n):
            r = refs.get(b)
            if r is None:
                raise ValueError(f"double free of head-block {b}")
            if r == 1:
                del refs[b]
                self.physical_used -= 1
                if run_s is None:
                    run_s = b
            else:
                refs[b] = r - 1
                if run_s is not None:
                    runs.append((run_s, b))
                    run_s = None
        if run_s is not None:
            runs.append((run_s, start + n))
        self.used -= n
        if not runs:
            return
        for new in runs:
            bisect.insort(self._free, new)
        # coalesce neighbours
        merged: List[Tuple[int, int]] = []
        for s, e in self._free:
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        self._free = merged

    def grow(self, n: int) -> None:
        """Extend the arena by ``n`` head-blocks of new free space
        (zero-copy weight de-dup grants reclaimed HBM back to the
        pool — see UnifiedKVPool.grow)."""
        if n <= 0:
            return
        start = self.n_blocks
        self.n_blocks += n
        if self._free and self._free[-1][1] == start:
            self._free[-1] = (self._free[-1][0], start + n)
        else:
            self._free.append((start, start + n))

    def shrink(self, n: int) -> int:
        """Remove up to ``n`` head-blocks from the END of the arena.

        The inverse of ``grow``: only entirely-free tail space is
        released — in-use blocks are never reclaimed, so a shrink that
        would cut below a live allocation is clamped to the free tail
        (possibly 0).  When the tail is idle, ``shrink(n)`` after
        ``grow(n)`` restores the arena exactly.  Returns the number of
        blocks actually removed.
        """
        if n <= 0:
            return 0
        take = 0
        if self._free and self._free[-1][1] == self.n_blocks:
            s, e = self._free[-1]
            take = min(n, e - s)
            if take == e - s:
                self._free.pop()
            else:
                self._free[-1] = (s, e - take)
        self.n_blocks -= take
        return take

    @property
    def free_blocks(self) -> int:
        return self.n_blocks - self.physical_used

    def largest_free_range(self) -> int:
        """Largest contiguous free run — an *allocatability* figure
        (can a group-size run be placed?), NOT a shrink capacity:
        ``shrink`` only takes from the arena tail, which a single
        pinned block clamps regardless of interior space.  Use
        ``shrinkable_tail`` when planning shrinks."""
        return max((e - s for s, e in self._free), default=0)

    def shrinkable_tail(self) -> int:
        """Head-blocks ``shrink`` could actually remove right now: the
        length of the free run ending exactly at ``n_blocks``, 0 when
        any live block (a sequence's — or a shared/prefix-cached
        one's) pins the tail."""
        if self._free and self._free[-1][1] == self.n_blocks:
            s, e = self._free[-1]
            return e - s
        return 0


@dataclass
class SeqCache:
    """Host-side bookkeeping for one sequence's cache."""
    seq_id: int
    bases: List[int] = field(default_factory=list)   # group base per token-block
    n_tokens: int = 0


class ModelCacheView:
    """Per-LLM adapter onto the shared pool.

    Tracks quota (head-blocks) granted by ADBS and per-sequence block
    tables.  ``group_size = n_layers × n_kv_heads`` head-blocks per
    token block (attention models); SSM models have group_size 0 and a
    fixed per-seq state cost (accounted against quota, not the arena).
    """

    def __init__(self, cfg: ModelConfig, pool: "UnifiedKVPool", quota: int):
        self.cfg = cfg
        self.pool = pool
        self.quota = quota
        self.used = 0
        self.group_size = cfg.n_attn_layers * cfg.n_kv_heads
        self.seqs: Dict[int, SeqCache] = {}
        self._started: set = set()
        # SSM quota accounting: state bytes expressed in head-block units
        self._ssm_blocks_per_seq = 0
        if cfg.ssm:
            state_bytes = (cfg.n_ssm_layers * cfg.n_ssm_heads
                           * cfg.ssm.head_dim * cfg.ssm.d_state * 4)
            self._ssm_blocks_per_seq = max(
                1, state_bytes // pool.head_block_bytes)

    # ---- quota ------------------------------------------------------
    def quota_headroom(self) -> int:
        return self.quota - self.used

    def can_append(self, seq_id: int, n_tokens: int) -> bool:
        return self._blocks_needed(seq_id, n_tokens) <= min(
            self.quota_headroom(), self.pool.allocator.free_blocks)

    def _blocks_needed(self, seq_id: int, n_tokens: int) -> int:
        sc = self.seqs.get(seq_id)
        have = len(sc.bases) * BLOCK_TOKENS if sc else 0
        cur = sc.n_tokens if sc else 0
        need_tokens = max(0, cur + n_tokens - have)
        n_groups = -(-need_tokens // BLOCK_TOKENS)
        cost = n_groups * self.group_size
        if sc is None and self.cfg.ssm:
            cost += self._ssm_blocks_per_seq
        return cost

    # ---- allocation ---------------------------------------------------
    def append_tokens(self, seq_id: int, n_tokens: int) -> bool:
        """Reserve cache space for n_tokens more tokens of seq_id."""
        cost = self._blocks_needed(seq_id, n_tokens)
        if cost > self.quota_headroom():
            return False
        sc = self.seqs.setdefault(seq_id, SeqCache(seq_id))
        have = len(sc.bases) * BLOCK_TOKENS
        need_tokens = max(0, sc.n_tokens + n_tokens - have)
        n_groups = -(-need_tokens // BLOCK_TOKENS)
        newly = []
        for _ in range(n_groups):
            if self.group_size > 0:
                base = self.pool.allocator.alloc(self.group_size)
                if base is None:
                    for b in newly:   # roll back
                        self.pool.allocator.free(b, self.group_size)
                    return False
                newly.append(base)
        sc.bases.extend(newly)
        sc.n_tokens += n_tokens
        extra = n_groups * self.group_size
        if seq_id not in self._started and self.cfg.ssm:
            extra += self._ssm_blocks_per_seq
        self._started.add(seq_id)
        self.used += extra
        self.pool.used_by[self.cfg.name] = self.used
        return True

    def free_seq(self, seq_id: int) -> None:
        sc = self.seqs.pop(seq_id, None)
        if sc is None:
            return
        for b in sc.bases:
            self.pool.allocator.free(b, self.group_size)
        freed = len(sc.bases) * self.group_size
        if self.cfg.ssm and seq_id in self._started:
            freed += self._ssm_blocks_per_seq
        self._started.discard(seq_id)
        self.used -= freed
        self.pool.used_by[self.cfg.name] = self.used

    # ---- device-side tables -------------------------------------------
    def block_table(self, seq_ids: List[int], max_blocks: int) -> np.ndarray:
        """[len(seq_ids), max_blocks] int32 group bases (−1 padded)."""
        t = np.full((len(seq_ids), max_blocks), -1, np.int32)
        for i, sid in enumerate(seq_ids):
            bases = self.seqs[sid].bases[:max_blocks]
            t[i, :len(bases)] = bases
        return t

    def seq_lens(self, seq_ids: List[int]) -> np.ndarray:
        return np.array([self.seqs[s].n_tokens for s in seq_ids], np.int32)


def fused_block_tables(views_seqs: List[Tuple["ModelCacheView", List[int]]],
                       rows: int, max_blocks: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Combined block-table assembly for the fused multi-LLM decode tick
    (DESIGN.md §2): each colocated model's per-sequence tables are
    resolved by its own ``ModelCacheView`` against the shared arena,
    then padded to a common ``rows × max_blocks`` shape so one jitted
    step can consume every model's rows at once.

    Returns ``(tables [M, rows, max_blocks] int32, lens [M, rows]
    int32)``.  Padded table entries are −1 (KV writes drop, attention
    masks); padded lens are 1 so the fused attention sweep reads a
    single masked position instead of an empty range.
    """
    M = len(views_seqs)
    tables = np.full((M, rows, max_blocks), -1, np.int32)
    lens = np.ones((M, rows), np.int32)
    for m, (view, seq_ids) in enumerate(views_seqs):
        b = len(seq_ids)
        tables[m, :b] = view.block_table(seq_ids, max_blocks)
        lens[m, :b] = view.seq_lens(seq_ids)
    return tables, lens


class UnifiedKVPool:
    """The shared device arena + host allocator for one LLM unit."""

    def __init__(self, n_head_blocks: int, head_dim: int,
                 dtype=torch.bfloat16, block_tokens: int = BLOCK_TOKENS,
                 device="cuda"):
        self.n_head_blocks = n_head_blocks
        self.head_dim = head_dim
        self.block_tokens = block_tokens
        self.dtype = dtype
        self.device = resolve_device(device)
        self.k = self._zeros(n_head_blocks)
        self.v = self._zeros(n_head_blocks)
        self.allocator = BlockAllocator(n_head_blocks)
        self.views: Dict[str, ModelCacheView] = {}
        self.used_by: Dict[str, int] = {}

    def _zeros(self, n: int) -> torch.Tensor:
        return torch.zeros((n, self.block_tokens, self.head_dim),
                           dtype=self.dtype, device=self.device)

    @property
    def head_block_bytes(self) -> int:
        return 2 * self.block_tokens * self.head_dim * self.dtype_bytes

    @property
    def dtype_bytes(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()

    def hbm_bytes(self) -> int:
        """Device bytes held by the arena (k + v)."""
        return (self.k.numel() * self.k.element_size()
                + self.v.numel() * self.v.element_size())

    def grow(self, extra_blocks: int) -> int:
        """Extend the arena by ``extra_blocks`` head-blocks.

        The zero-copy stacked-weights scheme frees one full weight copy
        per fused group; those bytes are granted back to the pool here
        (reclaimed weight memory becomes KV head-blocks, which admit
        more sequences).  Returns the blocks actually added.
        """
        if extra_blocks <= 0:
            return 0
        n = self.n_head_blocks + extra_blocks
        if self.allocator.used == 0:
            # no sequence holds blocks, so the arena's contents are
            # dead: drop it BEFORE allocating the new one — the grant is
            # as large as the weights it replaces, and holding both
            # arenas at full width would not fit the card
            self.k = self.v = None
            self.k = self._zeros(n)
            self.v = self._zeros(n)
        else:
            self.k = torch.cat([self.k, self._zeros(extra_blocks)])
            self.v = torch.cat([self.v, self._zeros(extra_blocks)])
        self.allocator.grow(extra_blocks)
        self.n_head_blocks = n
        return extra_blocks

    def shrink(self, extra_blocks: int) -> int:
        """Release up to ``extra_blocks`` head-blocks from the arena
        tail — the inverse of ``grow``.  Only free tail space is
        released (the allocator refuses to cut below in-use blocks), so
        the returned count may be smaller than requested."""
        removed = self.allocator.shrink(extra_blocks)
        if removed:
            n = self.n_head_blocks - removed
            self.k = self.k[:n].clone()
            self.v = self.v[:n].clone()
            self.n_head_blocks = n
        return removed

    def register_model(self, cfg: ModelConfig, quota: int) -> ModelCacheView:
        if not (cfg.attn_free or cfg.hd == self.head_dim):
            raise ValueError(
                f"pools are grouped by head_dim: model {cfg.name!r} has "
                f"head_dim {cfg.hd}, pool has {self.head_dim}")
        v = ModelCacheView(cfg, self, quota)
        self.views[cfg.name] = v
        self.used_by[cfg.name] = 0
        return v

    def grant_min_quota(self, view: "ModelCacheView", need: int) -> bool:
        """Raise ``view``'s quota to at least ``need`` head-blocks by
        pulling spare quota (quota − used) from the other views,
        most-spare first.  Escape hatch for the scheduler when a
        queued request's lifetime no longer fits a quota that
        ``adapt_quotas`` shrank — without it the request would be
        re-queued forever.  Returns True if the target was reached.
        """
        if view.quota >= need:
            return True
        donors = sorted((v for v in self.views.values() if v is not view),
                        key=lambda v: v.quota - v.used, reverse=True)
        for d in donors:
            # leave one block-group of growth headroom per active
            # sequence so draining the donor doesn't immediately stall
            # its in-flight decodes into rollback/preemption
            margin = len(d.seqs) * d.group_size
            spare = max(0, d.quota - d.used - margin)
            take = min(spare, need - view.quota)
            if take > 0:
                d.quota -= take
                view.quota += take
            if view.quota >= need:
                return True
        return view.quota >= need

    # ---- ADBS quota adaptation (paper Alg. 3, last line) ---------------
    def adapt_quotas(self, min_quota: int = 64) -> None:
        """Move head-block quota from low- to high-utilization LLMs."""
        if len(self.views) < 2:
            return
        util = {n: (v.used / v.quota if v.quota else 1.0)
                for n, v in self.views.items()}
        lo = min(util, key=util.get)
        hi = max(util, key=util.get)
        if util[hi] - util[lo] < 0.2:
            return
        v_lo, v_hi = self.views[lo], self.views[hi]
        spare = v_lo.quota - v_lo.used
        move = min(spare // 2, self.n_head_blocks // 8)
        if move > 0 and v_lo.quota - move >= min_quota:
            v_lo.quota -= move
            v_hi.quota += move

    def utilization(self) -> float:
        return self.allocator.used / self.n_head_blocks
