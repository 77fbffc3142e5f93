"""Token sampling: greedy / temperature / top-k / top-p (port of
``repro/serving/sampling.py``).

The masks are the JAX package's: top-k keeps every logit at or above
the k-th largest, top-p keeps the smallest set of sorted logits whose
probability mass reaches ``top_p`` (ties at the threshold kept).  The
draw takes an explicit ``torch.Generator``, so it is reproducible per
generator but equals the JAX package's draws only in distribution (the
random streams differ); greedy equals its argmax exactly.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.0       # 0 → greedy
    top_k: int = 0                 # 0 → off
    top_p: float = 1.0             # 1 → off


def masked_logits(logits: torch.Tensor, cfg: SamplingConfig) -> torch.Tensor:
    """The temperature-scaled float32 logits with every token outside the
    top-k / top-p sets at −inf (what ``sample`` draws from)."""
    logits = logits.float() / cfg.temperature
    if cfg.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -cfg.top_k][:, None]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if cfg.top_p < 1.0:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_l, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # smallest set whose mass ≥ top_p: keep entries with cum−p < top_p
        keep = cum - probs < cfg.top_p
        thresh = torch.where(keep, sorted_l, torch.inf).min(dim=-1).values
        logits = torch.where(logits < thresh[:, None], -torch.inf, logits)
    return logits


def sample(logits: torch.Tensor, generator: torch.Generator,
           cfg: SamplingConfig) -> torch.Tensor:
    """logits: [B, V] → tokens [B] int32.  ``generator`` must live on
    the logits' device."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(masked_logits(logits, cfg), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
