"""Throughput estimator — paper Eq. 3 + batch-size binary search (copy
of ``repro/core/estimator.py``).

    tpt_S(m, b, W) = min( b^m / (Σ_i t_p^i + t_d^m · l_o^m), W_m )

Prefill phases of colocated LLMs serialize; decode phases overlap
(paper Fig. 12).  ``F(unit)`` sums the per-LLM estimates subject to the
token-block fairness constraint (Eq. 2) and is the objective the
placement algorithm (Alg. 1) maximizes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from repro_torch.config import BLOCK_TOKENS, ModelConfig
from repro_torch.core import costmodel as cm
from repro_torch.core.costmodel import Hardware, A100


@dataclass
class LLMSpec:
    """One LLM's serving config inside a unit."""
    cfg: ModelConfig
    rate: float                 # W_m: request arrival rate (req/s)
    mean_prompt: int = 161
    mean_output: int = 338
    tp: int = 1                 # intra-op parallelism degree
    sm_frac: float = 1.0        # compute fraction (MPS share / interleave)
    # base architecture id when it differs from the (unit-unique) name —
    # the placement→runtime bridge resolves configs by it; None means
    # the name itself (minus any ``#i`` colocation tag) is the arch
    arch: Optional[str] = None

    @property
    def name(self) -> str:
        return self.cfg.name

    @property
    def arch_id(self) -> str:
        return self.arch or self.cfg.name.split("#")[0]


def request_throughput(spec: LLMSpec, batch: int, unit_specs: Sequence[LLMSpec],
                       hw: Hardware = A100) -> float:
    """Eq. 3 for LLM m with batch size b^m inside a unit."""
    if batch <= 0:
        return 0.0
    # Σ_i t_p^i: one prefill per LLM in the unit at its own batch/rate share
    t_p_sum = 0.0
    for s in unit_specs:
        bs = max(1, int(round(batch * s.rate / max(spec.rate, 1e-9))))
        bs = min(bs, 64)
        t_p_sum += cm.prefill_latency(s.cfg, 1, s.mean_prompt, tp=s.tp,
                                      f=max(s.sm_frac, 0.05), hw=hw) * bs
    t_d = cm.decode_latency(spec.cfg, batch,
                            spec.mean_prompt + spec.mean_output / 2,
                            tp=spec.tp, f=max(spec.sm_frac, 0.05), hw=hw)
    denom = t_p_sum + t_d * spec.mean_output
    tpt = batch / max(denom, 1e-9)
    return min(tpt, spec.rate)


def solve_batch(spec: LLMSpec, unit_specs: Sequence[LLMSpec],
                hw: Hardware = A100, max_batch: int = 256
                ) -> Tuple[int, float]:
    """Binary search the smallest batch whose Eq.-3 throughput meets the
    arrival rate (paper §3.3); returns (batch, throughput)."""
    lo, hi = 1, max_batch
    best_b, best_t = max_batch, request_throughput(spec, max_batch,
                                                   unit_specs, hw)
    while lo <= hi:
        mid = (lo + hi) // 2
        t = request_throughput(spec, mid, unit_specs, hw)
        if t >= spec.rate - 1e-9:
            best_b, best_t = mid, t
            hi = mid - 1
        else:
            lo = mid + 1
    return best_b, best_t


# ---------------------------------------------------------------------------
# R(m, W): normalized resource usage (token blocks) — Eq. 2 fairness
# ---------------------------------------------------------------------------
def token_block_usage(spec: LLMSpec, batch: int) -> float:
    """Expected head-block usage of LLM m at batch b, normalized by rate
    (paper §3.3: counting token blocks accounts for LLM scale; dividing
    by rate accounts for popularity)."""
    tokens = batch * (spec.mean_prompt + spec.mean_output / 2)
    if spec.cfg.attn_free:
        blocks = batch * max(1, spec.cfg.n_ssm_layers)
    else:
        blocks = (tokens / BLOCK_TOKENS) * spec.cfg.n_attn_layers \
            * spec.cfg.n_kv_heads
    return blocks / max(spec.rate, 1e-9)


def unit_throughput(specs: Sequence[LLMSpec], n_devices: int,
                    hw: Hardware = A100,
                    fairness_eps: float = 3.0) -> float:
    """F(b, W_b): aggregate unit throughput under the fairness constraint.

    Memory feasibility: weights of all colocated LLMs must fit the
    unit's total HBM with KV headroom; infeasible → −inf.
    """
    if not specs:
        return 0.0
    w_bytes = sum(s.cfg.weight_bytes() for s in specs)
    total = hw.hbm_bytes * n_devices
    if w_bytes > 0.85 * total:
        return float("-inf")

    total_tpt = 0.0
    usages = []
    for s in specs:
        b, tpt = solve_batch(s, specs, hw)
        # KV feasibility: batches must fit the remaining memory
        total_tpt += tpt
        usages.append(token_block_usage(s, b))
    # fairness constraint |R_i − R_j| ≤ ε (in normalized log-space)
    if len(usages) > 1:
        lo, hi = min(usages), max(usages)
        if lo > 0 and math.log(hi / max(lo, 1e-12)) > fairness_eps:
            # heavily-imbalanced colocation: penalize rather than forbid
            total_tpt *= 0.8
    return total_tpt
