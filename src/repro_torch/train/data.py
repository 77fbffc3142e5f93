"""Deterministic synthetic token pipeline (a copy of
``repro/train/data.py``, numpy only: its batches equal the JAX
package's bit for bit).

A seeded, shardable data source: documents are Markov chains over the
vocabulary with per-document transition structure so the LM loss has a
learnable signal (loss decreases within a few dozen steps on the
reduced configs — asserted in tests/test_torch_train.py).  Batches are
produced host-side as numpy; the iterator is stateless given (seed,
step) so training is reproducible and resumable from a checkpoint
without data-state serialization.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_patterns: int = 64           # distinct Markov row-patterns
    frontend_dim: Optional[int] = None   # audio/vlm stub embeddings
    n_prefix_tokens: int = 0


def _batch_rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, 0xC0FFEE]))


def synth_batch(cfg: DataConfig, step: int
                ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Returns (tokens [B,S] int32, labels [B,S] int32, prefix or None).

    Each sequence follows ``next = (a*cur + b) % V`` with per-sequence
    (a, b) drawn from a small pattern set + 10% uniform noise — a signal
    an LM head can pick up quickly, with an irreducible floor.
    """
    rng = _batch_rng(cfg, step)
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    pat = rng.integers(0, cfg.n_patterns, B)
    a = (2 * pat + 1) % V            # odd multiplier → full-period-ish
    b = (7 * pat + 3) % V
    toks = np.empty((B, S), np.int32)
    toks[:, 0] = rng.integers(0, V, B)
    noise = rng.random((B, S)) < 0.1
    rand = rng.integers(0, V, (B, S))
    for t in range(1, S):
        nxt = (a * toks[:, t - 1] + b) % V
        toks[:, t] = np.where(noise[:, t], rand[:, t], nxt)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -100, np.int32)],
                            axis=1)
    prefix = None
    if cfg.frontend_dim:
        prefix = rng.standard_normal(
            (B, cfg.n_prefix_tokens, cfg.frontend_dim)).astype(np.float32)
    return toks, labels, prefix


def iterate(cfg: DataConfig, start_step: int = 0) -> Iterator:
    step = start_step
    while True:
        yield synth_batch(cfg, step)
        step += 1
