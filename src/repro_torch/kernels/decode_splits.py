"""The host's plan for the split-KV decode kernels (``csrc/decode_splitkv.cuh``,
bound by ``paged_attention`` and ``paged_attention_int8``).

Each (row, kv head)'s cached tokens are cut into splits of ``split``
tokens, one CTA each; splits past a row's ``seq_len`` exit at once.  The
plan is a function of shapes only: the longest row the cache can hold
(``max_tok``), never ``seq_lens``, whose values live on the card —
reading them would cost a host sync per layer of the serving loop.

``split`` starts at 64 tokens (one ring chunk of the bf16 body, two of
the f32 body's) and doubles while the grid still holds at least one CTA
per SM of the card (``sms``: 132 on an H100 SXM, read from the device's
properties), so a short tick fills the card and a long context gets
fewer, longer splits.  (On an H100 at full-width qwen2-7b, one CTA an
SM timed faster than a half, two and four, and than one wave of three
CTAs an SM with 64-multiple splits; see PERF.md.)  It is capped so a
split's block ids fit the kernel's shared memory (``split / bt + 2 <=
MAX_IDS``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.build import sm_count

ALIGN = 64              # SK_SPLIT_ALIGN: a split is whole ring chunks
MIN_SPLIT = 64
MAX_SPLIT = 4096
MAX_IDS = 258           # SK_MAX_IDS
MAX_GROUP = 8           # SK_MAX_GROUP: (m, l) slots per split in the workspace


class SplitPlan(NamedTuple):
    split: int          # tokens per split, a multiple of ALIGN
    n_splits: int       # splits per (row, kv head): split * n_splits >= max_tok


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan_splits(rows: int, n_kv: int, max_tok: int, bt: Optional[int],
                sms: int) -> SplitPlan:
    """The split of a launch over ``rows`` x ``n_kv`` (row, kv head)
    pairs of at most ``max_tok`` cached tokens on a card of ``sms`` SMs;
    ``bt`` is the block size when the kernel reads a block table (None:
    no table)."""
    cap = MAX_SPLIT if bt is None else min(MAX_SPLIT, (MAX_IDS - 2) * bt)
    cap = max(ALIGN, cap // ALIGN * ALIGN)
    split = min(MIN_SPLIT, cap)
    pairs = rows * n_kv
    while (split < max_tok and split * 2 <= cap
           and pairs * _cdiv(max_tok, split * 2) >= sms):
        split *= 2
    return SplitPlan(split, max(1, _cdiv(max_tok, split)))


def workspace_floats(plan: SplitPlan, rows: int, n_kv: int, group: int,
                     hd: int) -> int:
    """f32 slots of the partial states: (m, l) per head slot, then
    acc[group][hd], for every split of every (row, kv head)."""
    return rows * n_kv * plan.n_splits * (2 * MAX_GROUP + group * hd)


def workspace(plan: SplitPlan, rows: int, n_kv: int, group: int, hd: int,
              device: torch.device) -> Optional[torch.Tensor]:
    """The kernel's workspace (uninitialised: only live splits write it,
    and the merge reads only those), or None for a one-split plan."""
    if plan.n_splits == 1:
        return None
    return torch.empty(workspace_floats(plan, rows, n_kv, group, hd),
                       dtype=torch.float32, device=device)


def prepare(q: torch.Tensor, n_kv: int, max_tok: int, bt: Optional[int],
            sms: Optional[int] = None):
    """The plan and the workspace of one launch over queries ``q`` [B,
    H, hd], from shapes alone (no tensor's values are read); ``sms``
    defaults to ``q``'s card's SM count."""
    B, H, hd = q.shape
    plan = plan_splits(B, n_kv, max_tok, bt,
                       sm_count(q.device) if sms is None else sms)
    return plan, workspace(plan, B, n_kv, H // n_kv, hd, q.device)
