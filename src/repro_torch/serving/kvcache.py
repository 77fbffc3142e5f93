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
pool's device.  ``shrink`` narrows the arena's view and keeps its
buffer, and ``grow`` re-exposes (zeroed) rows the buffer still holds
before it allocates anything: a crash recovery or a block loss, which
shrink the arena under live sequences and grow it back, never hold a
second arena (at full width the arena is as large as a weight copy).

Prefix caching (``PrefixIndex``) shares block groups across sequences
by refcount, read-only, with copy-on-write (``cache_ops.
copy_block_groups``, in place on the arena) when a write lands inside
a shared block.  ``migrate_view`` moves one LLM's live cache to another
pool (live reconfiguration); its page copy writes the destination arena
in place through the same ``copy_block_groups``.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import BLOCK_TOKENS, ModelConfig
from repro_torch.serving.cache_ops import copy_block_groups
from repro_torch.serving.metrics import traced


class BlockAllocator:
    """First-fit contiguous range allocator over head-blocks (host side).

    Free space kept as a sorted list of ``[start, end)`` ranges.

    Blocks are refcounted (DESIGN.md §13): ``alloc`` hands out ranges
    at refcount 1, ``share`` adds a holder, and ``free`` drops one — a
    block returns to the free list only when its last holder lets go.
    ``used`` is refcount-weighted (what every holder is charged, so
    per-view quota sums still equal it), ``physical_used`` counts
    distinct live blocks (what the arena spends — ``free_blocks``
    derives from it).  Absent sharing the two are equal.
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

    def share(self, start: int, n: int) -> None:
        """Add one holder to every block in ``[start, start+n)``.  The
        range must be live — sharing free space is a caller bug."""
        if n <= 0:
            return
        refs = self._refs
        for b in range(start, start + n):
            if b not in refs:
                raise ValueError(f"share of unallocated head-block {b}")
        for b in range(start, start + n):
            refs[b] += 1
        self.used += n

    def refcount(self, block: int) -> int:
        return self._refs.get(block, 0)

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

    def fragmentation(self) -> float:
        """1 − largest_free/total_free (0 = one contiguous free range).
        Like ``largest_free_range`` this describes interior
        allocatability, not the shrinkable tail."""
        if self.free_blocks == 0:
            return 0.0
        return 1.0 - self.largest_free_range() / self.free_blocks


@dataclass
class SeqCache:
    """Host-side bookkeeping for one sequence's cache."""
    seq_id: int
    bases: List[int] = field(default_factory=list)   # group base per token-block
    n_tokens: int = 0
    # leading block groups adopted read-only from other holders via
    # share_prefix (prefix caching); writes into this region trigger
    # copy-on-write.  Always a prefix: bases[:shared].
    shared: int = 0


class PrefixIndex:
    """Per-LLM prompt-prefix → cached-block-group index (DESIGN.md §13).

    Keyed by a hash chain over FULL prompt token-blocks: ``h_i =
    hash((h_{i−1}, block_i_tokens))``, so an entry for block *i* is only
    reachable when blocks ``0..i−1`` matched too — a lookup always
    adopts a chain prefix.  Only fully-written blocks are indexed
    (chunked prefill's pad garbage lands at positions ≥ the prompt
    length, never inside an indexed block), and each entry stores the
    block's tokens beside the base so a hash collision can never adopt
    wrong KV.  Prompts are lists of Python (or numpy) integers: a block
    is a tuple of them, and those hash by value — a tensor scalar would
    hash by identity and never hit.

    Entries hold their own allocator refcount on the group, so cached
    prefixes survive the inserting sequence; they are disposable pool
    inventory, never quota-charged: evicted LRU-first under allocation
    pressure (``reclaim``), dropped when a shrink dooms their tail
    blocks (``release_from``), and cleared wholesale when the view
    unregisters (crash recovery).  Dict insertion order doubles as the
    LRU order.
    """

    def __init__(self, view: "ModelCacheView"):
        self.view = view
        self._entries: Dict[int, Tuple[int, Tuple[int, ...]]] = {}
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.inserted = 0
        self.evicted = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def held_blocks(self) -> int:
        """Head-blocks the index holds a refcount on."""
        return len(self._entries) * self.view.group_size

    def entries(self) -> List[Tuple[int, Tuple[int, Tuple[int, ...]]]]:
        """(hash, (base, block_tokens)) pairs in LRU→MRU order."""
        return list(self._entries.items())

    @staticmethod
    def chain_hashes(prompt: List[int], n_blocks: int
                     ) -> List[Tuple[int, Tuple[int, ...]]]:
        out: List[Tuple[int, Tuple[int, ...]]] = []
        h = 0
        for i in range(n_blocks):
            blk = tuple(prompt[i * BLOCK_TOKENS:(i + 1) * BLOCK_TOKENS])
            h = hash((h, blk))
            out.append((h, blk))
        return out

    def lookup(self, prompt: List[int]) -> Tuple[int, List[int]]:
        """Longest cached chain prefix of ``prompt`` as ``(n_tokens,
        group bases)``.  Clamped to ``(len(prompt)−1)//BLOCK_TOKENS``
        blocks so prefill always computes at least the prompt's last
        token — the engine needs its logits for the first generated
        token."""
        self.lookups += 1
        bases: List[int] = []
        max_adopt = (len(prompt) - 1) // BLOCK_TOKENS
        for h, blk in self.chain_hashes(prompt, max_adopt):
            ent = self._entries.get(h)
            if ent is None or ent[1] != blk:
                break
            self._entries[h] = self._entries.pop(h)      # LRU touch
            bases.append(ent[0])
        if bases:
            self.hits += 1
            self.hit_tokens += len(bases) * BLOCK_TOKENS
        return len(bases) * BLOCK_TOKENS, bases

    def insert(self, prompt: List[int], bases: List[int]) -> int:
        """Index every full prompt block of a live sequence (called at
        prompt completion — the blocks are fully written and stable
        from then on: decode appends past the prompt).  Takes a share
        ref per new entry; existing hashes are kept (first writer
        wins).  Returns entries added."""
        n_full = min(len(prompt) // BLOCK_TOKENS, len(bases))
        added = 0
        for (h, blk), base in zip(self.chain_hashes(prompt, n_full), bases):
            if h in self._entries:
                continue
            self.view.pool.allocator.share(base, self.view.group_size)
            self._entries[h] = (base, blk)
            added += 1
        self.inserted += added
        return added

    def adopt(self, h: int, base: int, blk: Tuple[int, ...]) -> None:
        """Install a remapped entry (migration rebuild): share the
        destination group and record it under the unchanged hash."""
        if h in self._entries:
            return
        self.view.pool.allocator.share(base, self.view.group_size)
        self._entries[h] = (base, blk)

    def evictable_blocks(self) -> int:
        """Head-blocks ``reclaim`` could free right now (entries whose
        group the index alone holds)."""
        alloc = self.view.pool.allocator
        g = self.view.group_size
        return sum(g for base, _ in self._entries.values()
                   if alloc.refcount(base) == 1)

    def reclaim(self, need_blocks: int) -> int:
        """Evict LRU-first entries whose group the index alone holds
        until ``need_blocks`` head-blocks returned to the free list.
        Entries a live sequence shares free nothing by eviction and
        keep their future hits — skipped.  Returns blocks freed."""
        alloc = self.view.pool.allocator
        g = self.view.group_size
        freed = 0
        for h, (base, _) in list(self._entries.items()):
            if freed >= need_blocks:
                break
            if alloc.refcount(base) == 1:
                alloc.free(base, g)
                del self._entries[h]
                freed += g
                self.evicted += 1
        return freed

    def release_from(self, doomed_start: int) -> int:
        """Pre-shrink invalidation: drop index-only entries whose group
        intersects ``[doomed_start, ∞)`` so the doomed tail becomes free
        and the shrink isn't clamped by disposable cache inventory.
        Entries a live sequence still shares keep their blocks alive —
        the shrink clamps below them, the entry stays valid, so it is
        kept.  Returns blocks freed."""
        alloc = self.view.pool.allocator
        g = self.view.group_size
        dropped = 0
        for h, (base, _) in list(self._entries.items()):
            if base + g > doomed_start and alloc.refcount(base) == 1:
                alloc.free(base, g)
                del self._entries[h]
                dropped += g
                self.evicted += 1
        return dropped

    def clear(self) -> None:
        """Drop every entry and its ref (view unregister — crash
        recovery tears the whole view down)."""
        alloc = self.view.pool.allocator
        g = self.view.group_size
        for base, _ in self._entries.values():
            alloc.free(base, g)
        self.evicted += len(self._entries)
        self._entries.clear()

    def stats(self) -> dict:
        return {"entries": len(self._entries), "lookups": self.lookups,
                "hits": self.hits, "hit_tokens": self.hit_tokens,
                "inserted": self.inserted, "evicted": self.evicted,
                "held_blocks": self.held_blocks,
                "hit_rate": (self.hits / self.lookups
                             if self.lookups else 0.0)}


class ModelCacheView:
    """Per-LLM adapter onto the shared pool.

    Tracks quota (head-blocks) granted by ADBS and per-sequence block
    tables.  ``group_size = n_layers × n_kv_heads`` head-blocks per
    token block (attention models); SSM models have group_size 0 and a
    fixed per-seq state cost (accounted against quota, not the arena).
    """

    def __init__(self, cfg: ModelConfig, pool: "UnifiedKVPool", quota: int,
                 prefix_cache: bool = False):
        self.cfg = cfg
        self.pool = pool
        self.quota = quota
        self.used = 0
        self.group_size = cfg.n_attn_layers * cfg.n_kv_heads
        self.seqs: Dict[int, SeqCache] = {}
        self._started: set = set()
        # prefix caching is a paged-attention feature: SSM/hybrid state
        # is a running summary of the whole prefix and cannot be
        # adopted block-wise, so those views never index
        self.prefix_index: Optional[PrefixIndex] = (
            PrefixIndex(self)
            if prefix_cache and self.group_size > 0 and not cfg.ssm
            else None)
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
        # available_blocks (not raw free_blocks): prefix-cache blocks
        # are disposable and evicted on demand, so admission may count
        # them — otherwise a full cache would starve admission forever
        return self._blocks_needed(seq_id, n_tokens) <= min(
            self.quota_headroom(), self.pool.available_blocks())

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
    def share_prefix(self, seq_id: int, bases: List[int],
                     n_tokens: int) -> bool:
        """Adopt ``bases`` — block groups already live in the pool (a
        cached prefix) — as the leading blocks of a NEW sequence,
        read-only.  Quota policy (DESIGN.md §13): the sharer is charged
        fully, exactly as if it had allocated the blocks itself, so a
        later copy-on-write never needs quota headroom — only physical
        blocks.  Returns False (nothing changed) when quota is short."""
        assert seq_id not in self.seqs, "share_prefix needs a new sequence"
        assert self.group_size > 0 and not self.cfg.ssm, \
            "prefix sharing is a paged-attention feature"
        assert (len(bases) - 1) * BLOCK_TOKENS < n_tokens \
            <= len(bases) * BLOCK_TOKENS, (len(bases), n_tokens)
        cost = len(bases) * self.group_size
        if cost > self.quota_headroom():
            return False
        for b in bases:
            self.pool.allocator.share(b, self.group_size)
        self.seqs[seq_id] = SeqCache(seq_id, list(bases), n_tokens,
                                     shared=len(bases))
        self._started.add(seq_id)
        self.used += cost
        self.pool.used_by[self.cfg.name] = self.used
        return True

    def _cow_tail(self, sc: SeqCache) -> bool:
        """Copy-on-write before a write lands inside the shared prefix.
        Only the LAST shared block can ever be hit: earlier ones are
        full and append-only writes never revisit a full block.  Sole
        remaining holder → unshare in place (no copy); otherwise
        allocate a private group, copy the pages on the device (in
        place on the arena), drop our ref on the shared group and swap
        the base — ``paging.resolve_physical_blocks`` never sees any of
        this.  View quota/used are untouched (the sharer already paid
        full charge).  Returns False when no private group can be
        carved out even after evicting cache inventory."""
        blk = sc.shared - 1
        assert sc.n_tokens // BLOCK_TOKENS == blk, \
            "write into a full shared block — sharing invariant broken"
        old = sc.bases[blk]
        alloc = self.pool.allocator
        if alloc.refcount(old) == 1:
            sc.shared = blk
            return True
        new = alloc.alloc(self.group_size)
        if new is None:
            self.pool.reclaim_index_blocks(self.group_size)
            new = alloc.alloc(self.group_size)
            if new is None:
                return False
        copy_block_groups(self.pool.k, self.pool.v, [old], [new],
                          self.cfg.n_kv_heads, self.cfg.n_attn_layers)
        alloc.free(old, self.group_size)
        sc.bases[blk] = new
        sc.shared = blk
        return True

    @traced("pool.append")
    def append_tokens(self, seq_id: int, n_tokens: int) -> bool:
        """Reserve cache space for n_tokens more tokens of seq_id."""
        cost = self._blocks_needed(seq_id, n_tokens)
        if cost > self.quota_headroom():
            return False
        sc = self.seqs.setdefault(seq_id, SeqCache(seq_id))
        if (n_tokens > 0 and sc.shared
                and sc.n_tokens < sc.shared * BLOCK_TOKENS):
            if not self._cow_tail(sc):
                return False
        have = len(sc.bases) * BLOCK_TOKENS
        need_tokens = max(0, sc.n_tokens + n_tokens - have)
        n_groups = -(-need_tokens // BLOCK_TOKENS)
        newly = []
        for _ in range(n_groups):
            if self.group_size > 0:
                base = self.pool.allocator.alloc(self.group_size)
                if base is None and self.pool.reclaim_index_blocks(
                        self.group_size):
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

    @traced("pool.free")
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
    @traced("pool.table")
    def block_table(self, seq_ids: List[int], max_blocks: int) -> np.ndarray:
        """[len(seq_ids), max_blocks] int32 group bases (−1 padded)."""
        t = np.full((len(seq_ids), max_blocks), -1, np.int32)
        for i, sid in enumerate(seq_ids):
            bases = self.seqs[sid].bases[:max_blocks]
            t[i, :len(bases)] = bases
        return t

    @traced("pool.table")
    def seq_lens(self, seq_ids: List[int]) -> np.ndarray:
        return np.array([self.seqs[s].n_tokens for s in seq_ids], np.int32)


@traced("pool.table")
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
                 device="cuda", prefix_cache: bool = False):
        self.n_head_blocks = n_head_blocks
        self.head_dim = head_dim
        self.block_tokens = block_tokens
        self.dtype = dtype
        # pool-level so register_model (including the re-register on
        # crash recovery) creates per-view prefix indexes uniformly
        self.prefix_cache = prefix_cache
        self.device = resolve_device(device)
        # the arena's buffers; ``k``/``v`` are their first
        # ``n_head_blocks`` rows (a view: contiguous, what the kernels
        # take)
        self._k_buf = self._zeros(n_head_blocks)
        self._v_buf = self._zeros(n_head_blocks)
        self._view_arena()
        self.allocator = BlockAllocator(n_head_blocks)
        self.views: Dict[str, ModelCacheView] = {}
        self.used_by: Dict[str, int] = {}

    def _zeros(self, n: int) -> torch.Tensor:
        return torch.zeros((n, self.block_tokens, self.head_dim),
                           dtype=self.dtype, device=self.device)

    def _view_arena(self) -> None:
        self.k = self._k_buf[:self.n_head_blocks]
        self.v = self._v_buf[:self.n_head_blocks]

    def arena(self):
        """The arena's whole buffers ``(k, v)``, slack rows included: the
        tensors the steps write and the kernels read through block ids
        (``k``/``v`` are their first ``n_head_blocks`` rows).  They are
        replaced only when ``grow`` reallocates, never by a ``shrink``
        or a ``grow`` into the slack, so a captured step stays valid
        across those (``serving/graphs.py``)."""
        return self._k_buf, self._v_buf

    @property
    def head_block_bytes(self) -> int:
        return 2 * self.block_tokens * self.head_dim * self.dtype_bytes

    @property
    def dtype_bytes(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()

    def hbm_bytes(self) -> int:
        """Device bytes of the arena (k + v) as the pool uses it."""
        return (self.k.numel() * self.k.element_size()
                + self.v.numel() * self.v.element_size())

    def grow(self, extra_blocks: int) -> int:
        """Extend the arena by ``extra_blocks`` head-blocks.

        The zero-copy stacked-weights scheme frees one full weight copy
        per fused group; those bytes are granted back to the pool here
        (reclaimed weight memory becomes KV head-blocks, which admit
        more sequences).  The new blocks read zero, and with no
        sequence holding blocks the whole arena does, as in the JAX
        package.  Rows an earlier ``shrink`` released are re-exposed
        first; past the buffer the arena is reallocated — dropped first
        when no sequence holds blocks (its contents are dead), else
        copied one buffer at a time.  Returns the blocks actually
        added.
        """
        if extra_blocks <= 0:
            return 0
        old, n = self.n_head_blocks, self.n_head_blocks + extra_blocks
        live = self.allocator.used > 0
        if n <= self._k_buf.shape[0]:
            for buf in (self._k_buf, self._v_buf):
                buf[old if live else 0:n].zero_()
        elif not live:
            self.k = self.v = self._k_buf = self._v_buf = None
            self._k_buf = self._zeros(n)
            self._v_buf = self._zeros(n)
        else:
            for name in ("_k_buf", "_v_buf"):
                new = torch.empty((n, self.block_tokens, self.head_dim),
                                  dtype=self.dtype, device=self.device)
                new[:old].copy_(getattr(self, name)[:old])
                new[old:].zero_()
                self.k = self.v = None
                setattr(self, name, new)
                del new
        self.allocator.grow(extra_blocks)
        self.n_head_blocks = n
        self._view_arena()
        return extra_blocks

    def shrink(self, extra_blocks: int) -> int:
        """Release up to ``extra_blocks`` head-blocks from the arena
        tail — the inverse of ``grow``.  Only free tail space is
        released (the allocator refuses to cut below in-use blocks), so
        the returned count may be smaller than requested.  Index-only
        prefix-cache entries in the doomed tail are dropped first, so
        cached blocks never clamp a shrink (and a lost-tail shrink
        removes exactly what the fault doomed — see ``tail_victims``).
        The arena's view narrows; its buffer stays for a later
        ``grow``."""
        if (extra_blocks > 0
                and extra_blocks > self.allocator.shrinkable_tail()):
            doomed = self.n_head_blocks - extra_blocks
            for v in self.views.values():
                if v.prefix_index is not None:
                    v.prefix_index.release_from(doomed)
        removed = self.allocator.shrink(extra_blocks)
        if removed:
            self.n_head_blocks -= removed
            self._view_arena()
        return removed

    def shrinkable_tail(self) -> int:
        """Head-blocks a ``shrink`` could remove right now (free tail
        only) — what reconfiguration should consult instead of
        ``largest_free_range`` when planning capacity returns."""
        return self.allocator.shrinkable_tail()

    def available_blocks(self) -> int:
        """Free head-blocks plus prefix-cache inventory evictable on
        demand — the figure admission may count on.  Equals
        ``allocator.free_blocks`` when prefix caching is off."""
        n = self.allocator.free_blocks
        for v in self.views.values():
            if v.prefix_index is not None:
                n += v.prefix_index.evictable_blocks()
        return n

    def reclaim_index_blocks(self, need: int) -> int:
        """Evict prefix-cache entries (LRU-first, index-only holders)
        across views until ``need`` head-blocks are free.  Returns the
        blocks actually freed."""
        freed = 0
        for v in self.views.values():
            short = need - self.allocator.free_blocks
            if short <= 0:
                break
            if v.prefix_index is not None:
                freed += v.prefix_index.reclaim(short)
        return freed

    def prefix_stats(self) -> Dict[str, dict]:
        """Per-LLM prefix-cache counters (empty when caching is off)."""
        return {n: v.prefix_index.stats() for n, v in self.views.items()
                if v.prefix_index is not None}

    def tail_victims(self, n_lost: int) -> Dict[str, List[int]]:
        """Sequences whose cache touches the arena's last ``n_lost``
        head-blocks (the ``block_loss`` fault: a bad HBM region eats the
        tail).  A block group is a victim if ANY of its head-blocks lies
        in ``[n_blocks − n_lost, n_blocks)``; the whole sequence is torn
        down.  Once every victim is evicted the doomed tail is entirely
        free, so ``shrink(n_lost)`` then removes exactly the lost
        blocks.  Returns {view name: [seq ids]} for the scheduler to
        evict at the engine level."""
        doomed = self.n_head_blocks - max(n_lost, 0)
        out: Dict[str, List[int]] = {}
        for name, v in self.views.items():
            if v.group_size == 0:
                continue            # SSM state lives off-arena
            ids = sorted(sid for sid, sc in v.seqs.items()
                         if any(b + v.group_size > doomed
                                for b in sc.bases))
            if ids:
                out[name] = ids
        return out

    def register_model(self, cfg: ModelConfig, quota: int) -> ModelCacheView:
        if not (cfg.attn_free or cfg.hd == self.head_dim):
            raise ValueError(
                f"pools are grouped by head_dim: model {cfg.name!r} has "
                f"head_dim {cfg.hd}, pool has {self.head_dim}")
        v = ModelCacheView(cfg, self, quota, prefix_cache=self.prefix_cache)
        self.views[cfg.name] = v
        self.used_by[cfg.name] = 0
        return v

    def unregister_model(self, name: str) -> None:
        """Drop a model's view; its sequences must already be freed (a
        view with live sequences would leak their blocks).  The view's
        prefix index is cleared with it: every cached base the index
        alone held returns to the free list, so crash recovery can never
        leave a dangling index ref."""
        v = self.views.pop(name, None)
        self.used_by.pop(name, None)
        if v is not None and v.prefix_index is not None:
            v.prefix_index.clear()
        if v is not None and v.seqs:
            raise ValueError(f"unregistering view {name!r} with live "
                             f"sequences {sorted(v.seqs)} leaks pool blocks")

    @traced("pool.quota")
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
    @traced("pool.quota")
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


def migrate_view(src: ModelCacheView, dst_pool: "UnifiedKVPool",
                 quota: int) -> Tuple[ModelCacheView, int]:
    """Move one LLM's live cache between pools (engine/KV migration —
    the zero-downtime half of live reconfiguration).

    Every sequence keeps its identity: logical token-blocks are
    re-allocated in the destination arena, the KV pages are copied on
    the device, in place into the destination arena, through
    ``copy_block_groups`` (physical ids resolved by
    ``paging.resolve_physical_blocks``, the resolution every kernel
    uses), and the per-sequence bookkeeping (block tables, lengths, SSM
    state accounting) is rebuilt on a fresh ``ModelCacheView``.
    In-flight decodes continue off the new pool because the pages are
    exact copies and block tables are re-resolved from the view at
    every step.  The source view is drained and unregistered, which
    returns its groups to the source allocator.

    Shared prefix blocks migrate as shared: a group referenced by
    several sequences is allocated ONCE on the destination and
    ``share``d for every further holder (the src→dst base map keeps the
    sharing structure, and ``SeqCache.shared`` carries over so
    copy-on-write still triggers where it would have).  The prefix
    index is rebuilt on the destination from the same map (entries
    whose blocks a migrating sequence holds keep their hashes and
    refs); cache-only entries are dropped, so warm-cache state never
    inflates the capacity pre-check.

    Returns ``(dst_view, migrated_head_blocks)``.  Raises
    ``RuntimeError`` when the destination pool cannot hold the live
    cache (too few free blocks, or no contiguous group-size run); the
    source is untouched then and the destination rolled back.
    """
    cfg = src.cfg
    if dst_pool is src.pool:
        raise ValueError("migrate_view needs two pools")
    if (dst_pool.block_tokens, dst_pool.head_dim, dst_pool.dtype) != (
            src.pool.block_tokens, src.pool.head_dim, src.pool.dtype):
        raise ValueError("pools must share block geometry and dtype for "
                         "a page-exact migration")
    # physical need = DISTINCT groups (shared bases land once)
    uniq = {b for sc in src.seqs.values() for b in sc.bases}
    need = len(uniq) * src.group_size
    if need > dst_pool.allocator.free_blocks:
        dst_pool.reclaim_index_blocks(need)   # cache blocks are disposable
    if need > dst_pool.allocator.free_blocks:
        raise RuntimeError(
            f"destination pool cannot hold migrated KV of {cfg.name}: "
            f"need {need} head-blocks, "
            f"free {dst_pool.allocator.free_blocks}")

    dst = dst_pool.register_model(cfg, quota)
    base_map: Dict[int, int] = {}
    refs_made: List[int] = []   # one entry per alloc/share, for rollback
    src_groups: List[int] = []
    dst_groups: List[int] = []
    for sid, sc in src.seqs.items():
        new_bases = []
        for b in sc.bases:
            nb = base_map.get(b)
            if nb is None:
                nb = dst_pool.allocator.alloc(dst.group_size)
                if nb is None and dst_pool.reclaim_index_blocks(
                        dst.group_size):
                    nb = dst_pool.allocator.alloc(dst.group_size)
                if nb is None:
                    # the free total passed the pre-check but no
                    # CONTIGUOUS group-size run is left (fragmentation):
                    # roll the half-built destination back; the source
                    # is untouched until the copy below
                    for rb in refs_made:
                        dst_pool.allocator.free(rb, dst.group_size)
                    dst.seqs.clear()
                    dst.used = 0
                    dst_pool.unregister_model(cfg.name)
                    raise RuntimeError(
                        f"destination pool too fragmented for {cfg.name}: "
                        f"no contiguous {dst.group_size}-block run "
                        f"(free {dst_pool.allocator.free_blocks}, largest "
                        f"run {dst_pool.allocator.largest_free_range()})")
                base_map[b] = nb
                src_groups.append(b)
                dst_groups.append(nb)
            else:
                dst_pool.allocator.share(nb, dst.group_size)
            refs_made.append(nb)
            new_bases.append(nb)
        dst.seqs[sid] = SeqCache(sid, new_bases, sc.n_tokens,
                                 shared=sc.shared)
        used = len(new_bases) * dst.group_size
        if cfg.ssm and sid in src._started:
            used += dst._ssm_blocks_per_seq
        dst.used += used
    dst._started = set(src._started)
    dst.quota = max(dst.quota, dst.used)
    dst_pool.used_by[cfg.name] = dst.used

    # rebuild the prefix index under the remap (LRU order preserved);
    # the hash chain is content-addressed, so hashes carry unchanged
    if src.prefix_index is not None and dst.prefix_index is not None:
        for h, (b, blk) in src.prefix_index.entries():
            nb = base_map.get(b)
            if nb is not None:
                dst.prefix_index.adopt(h, nb, blk)

    migrated = 0
    if src_groups:
        # each distinct group is copied exactly once, elementwise
        # aligned src→dst, in place into the destination arena (a view
        # that shrink/grow re-slice: a new tensor would be lost there)
        copy_block_groups(dst_pool.k, dst_pool.v, src_groups, dst_groups,
                          cfg.n_kv_heads, cfg.n_attn_layers,
                          src_k=src.pool.k, src_v=src.pool.v)
        migrated = len(src_groups) * src.group_size

    for sid in list(src.seqs):
        src.free_seq(sid)
    src.pool.unregister_model(cfg.name)
    return dst, migrated
