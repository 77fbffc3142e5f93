"""Analytic latency/throughput cost model (copy of
``repro/core/costmodel.py``, roofline-based).

Replaces the paper's profiled latency tables (§3.3: "prefill and
decoding latency ... can be profiled in advance") with a first-
principles roofline model.  With A100 constants (the default, as in
the JAX package) it reproduces the paper's setting (Figs. 3, 5, 7–10);
with H100 constants it plans for the card the port serves on.  The
TPU entry of the JAX package is left out.  The arithmetic is the JAX
package's, operation for operation, so both packages plan alike.

A job holding compute fraction ``f`` (paper: MPS SM percentage) runs
at:

    t(job) = max( FLOPs / (f · peak · eff),  bytes / HBM_bw ) + t_coll

i.e. compute scales with the fraction, HBM bandwidth does not (MPS
partitions SMs, not memory channels).  This reproduces Fig. 3: decode
(memory-bound) latency is flat in f until f is tiny, prefill
(compute-bound) scales ≈ 1/f.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.config import ModelConfig


@dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float          # bf16 FLOP/s per device
    hbm_bw: float              # bytes/s per device
    hbm_bytes: float           # capacity per device
    link_bw: float             # interconnect bytes/s per device
    mfu: float = 0.55          # achievable fraction of peak in GEMMs
    mbu: float = 0.75          # achievable fraction of HBM bw


A100 = Hardware("a100-80g", 312e12, 2.039e12, 80e9, 600e9 / 8)
# NVIDIA H100 SXM5 data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3,
# 80 GB; its 900 GB/s NVLink over 8, as A100's 600e9 / 8
H100 = Hardware("h100-sxm-80g", 989e12, 3.35e12, 80e9, 900e9 / 8)


# ---------------------------------------------------------------------------
# per-step FLOPs / bytes
# ---------------------------------------------------------------------------
def step_flops(cfg: ModelConfig, n_tokens: int, ctx_len: float) -> float:
    """FLOPs for one forward step over n_tokens with average context
    ctx_len (attention term); 2·N_active per token for the GEMMs."""
    gemm = 2.0 * cfg.active_param_count() * n_tokens
    attn = 4.0 * cfg.n_attn_layers * cfg.n_heads * cfg.hd * n_tokens * ctx_len
    return gemm + attn


def decode_bytes(cfg: ModelConfig, batch: int, ctx_len: float,
                 dtype_bytes: int = 2) -> float:
    """HBM traffic of one decode step: weights once + KV of each seq."""
    w = cfg.active_param_count() * dtype_bytes
    kv = batch * ctx_len * cfg.kv_bytes_per_token(dtype_bytes)
    ssm = 0.0
    if cfg.ssm:
        ssm = (batch * cfg.n_ssm_layers * cfg.n_ssm_heads
               * cfg.ssm.head_dim * cfg.ssm.d_state * 4)
    return w + kv + ssm


def prefill_bytes(cfg: ModelConfig, batch: int, seq: int,
                  dtype_bytes: int = 2, block_q: int = 512) -> float:
    w = cfg.param_count() * dtype_bytes
    act = 2.0 * batch * seq * cfg.d_model * cfg.n_layers * dtype_bytes
    # flash attention re-reads K/V once per q-block pass
    flash = 0.0
    if cfg.n_attn_layers and seq > block_q:
        passes = seq / block_q
        flash = passes * batch * seq * 2 * cfg.n_kv_heads * cfg.hd \
            * dtype_bytes * cfg.n_attn_layers
    return w + act + flash


def train_step_bytes(cfg: ModelConfig, batch: int, seq: int,
                     dtype_bytes: int = 2) -> float:
    """HBM traffic of one optimizer step (fwd + bwd with per-layer
    remat + AdamW): weights ×3 reads (fwd, remat, bwd) + grad write/
    read + f32 m/v read+write + param write, plus activation traffic
    and flash K/V re-reads (fwd ×1, remat+bwd ×2)."""
    n = cfg.param_count()
    w_traffic = 3 * n * dtype_bytes          # fwd + remat + bwd reads
    grads = 2 * n * dtype_bytes              # write + read
    opt = n * (4 + 4) * 2 + n * dtype_bytes  # m,v rw (f32) + param write
    act = 12.0 * batch * seq * cfg.d_model * cfg.n_layers * dtype_bytes
    flash = 3 * (prefill_bytes(cfg, batch, seq, dtype_bytes)
                 - cfg.param_count() * dtype_bytes
                 - 2.0 * batch * seq * cfg.d_model * cfg.n_layers
                 * dtype_bytes)
    return w_traffic + grads + opt + act + max(flash, 0.0)


# ---------------------------------------------------------------------------
# latencies under a compute fraction f and TP degree
# ---------------------------------------------------------------------------
def _tp_collective_time(cfg: ModelConfig, n_tokens: int, tp: int,
                        hw: Hardware, dtype_bytes: int = 2) -> float:
    """Per-step all-reduce cost of Megatron TP: 2 all-reduces per layer
    over [n_tokens, d_model], ring cost 2(tp−1)/tp · bytes / link_bw."""
    if tp <= 1:
        return 0.0
    bytes_per_ar = n_tokens * cfg.d_model * dtype_bytes
    ars = 2 * cfg.n_layers
    return ars * 2 * (tp - 1) / tp * bytes_per_ar / hw.link_bw


def prefill_latency(cfg: ModelConfig, batch: int, seq: int, *, tp: int = 1,
                    f: float = 1.0, hw: Hardware = A100) -> float:
    """Latency of one prefill job for `batch` prompts of length `seq`."""
    fl = step_flops(cfg, batch * seq, seq / 2) / tp
    by = prefill_bytes(cfg, batch, seq) / tp
    t = max(fl / (f * hw.peak_flops * hw.mfu), by / (hw.hbm_bw * hw.mbu))
    return t + _tp_collective_time(cfg, batch * seq, tp, hw)


def decode_latency(cfg: ModelConfig, batch: int, ctx: float, *, tp: int = 1,
                   f: float = 1.0, hw: Hardware = A100) -> float:
    """Latency of one decode step for a running batch at avg context ctx."""
    if batch <= 0:
        return 0.0
    fl = step_flops(cfg, batch, ctx) / tp
    by = decode_bytes(cfg, batch, ctx) / tp
    t = max(fl / (f * hw.peak_flops * hw.mfu), by / (hw.hbm_bw * hw.mbu))
    return t + _tp_collective_time(cfg, batch, tp, hw)


def weight_devices_needed(cfg: ModelConfig, hw: Hardware,
                          headroom: float = 0.75) -> int:
    """Minimum TP degree so weights (+ some KV) fit."""
    need = cfg.weight_bytes()
    per_dev = hw.hbm_bytes * headroom
    return max(1, math.ceil(need / per_dev))


def max_kv_tokens(cfg: ModelConfig, tp: int, hw: Hardware,
                  weight_frac_used: float | None = None) -> int:
    """KV-capacity (tokens) of a tp-way group serving only this LLM."""
    total = hw.hbm_bytes * tp * 0.9
    free = total - cfg.weight_bytes()
    if free <= 0:
        return 0
    per_tok = cfg.kv_bytes_per_token()
    if cfg.ssm and per_tok == 0:
        return 10**9  # SSM state is O(1) per seq
    return int(free / per_tok)
