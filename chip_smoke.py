#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py

1. builds the five Hopper kernels (three attention kernels, the Mamba2
   SSD scan and the int8 decode attention of the W8/KV8 path) from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel),
   and counts the tensor-core instructions (from ``cuobjdump -sass``) of
   each prefill (``HGMMA``), decode and SSD (``HMMA``) kernel
   instantiation: every bf16 one must have some, the f32 ones
   (CUDA-core bodies) none;
2. holds each kernel against its plain PyTorch version at the serving
   path's shapes — full-width qwen2-7b (bf16, head_dim 128), zamba2-1.2b's
   shared attention (bf16, 32 heads of 64, group 1, a 272-token
   whole-prompt bucket), the reduced CPU-test model (f32, head_dim
   64), and the shapes of the configs beyond them: phi-3-vision-4.2b
   (head_dim 96, 32 heads, group 1), command-r-plus-104b (96/8 heads
   of 128: group 12), qwen3-moe-235b-a22b (64/4: group 16) and reduced
   f32 cases at head_dim 96 and at group 16 — for attention (the decode
   kernels' CTAs an SM, shared memory and registers printed), the int8
   decode through both of its addressings (paged pool and dense cache
   layer); the mamba2-2.7b chunk step with 4, 2 and 1 slots, a
   zamba2-1.2b whole-prompt bucket of 2 rows and of 1, and a reduced
   ragged f32 case for the SSD scan — and times the
   kernel, the plain version, one PyTorch library call over the same
   work where one exists (scaled_dot_product_attention on gathered,
   dequantized K/V, a yardstick only; none computes SSD), the card's
   bound for the work and the kernel's achieved TFLOP/s, and for the bf16
   prefill kernels, the two decode kernels and the SSD scan the host's
   enqueue time per wrapper call and the wall time of one call met with
   the card idle (enqueue, launch and device time in series); the decode
   and SSD rows also carry the span of a call in ``torch.profiler``'s
   CUDA trace (beside the CUDA-event time) and the kernel's time before
   its redesign (``earlier_ms``, a constant), the decode rows a
   long-context point, 8 rows of 4096 cached tokens, held to a tolerance
   relative to the plain output's largest magnitude, and the bf16 SSD
   rows the launch's plan (P-slice, warps, CTAs), whose shared memory
   by the host's copy of the layout must equal the built source's;
3. checks the serving steps on the card against the same steps on the
   CPU (plain versions) on the reduced models (qwen2-7b; the SSM
   chunk, prefill and decode steps of mamba2-2.7b and zamba2-1.2b; the
   W8/KV8 prefill and decode of qwen2-7b and granite-moe-3b-a800m), and
   that both devices serve a small qwen2 trace to the same report;
4. serves two colocated full-width qwen2-7b (random bf16 weights) with
   the fused chunked-prefill ADBS loop under the logical clock, then
   one with whole-prompt prefill; then the JAX CLI's default pair,
   full-width qwen2-7b + mamba2-2.7b (chunked, ADBS, serial: no
   fusable pair), and full-width zamba2-1.2b with whole-prompt prefill;
   then the MoE family and the configs beyond them at full width:
   granite-moe-3b-a800m + musicgen-medium (chunked, full depth, the
   MoE FFN counted on every layer), qwen3-moe-235b-a22b cut to 4 of 94
   layers (chunked; group 16), two phi-3-vision-4.2b fused (chunked)
   and one whole-prompt (head_dim 96), and command-r-plus-104b (4 of
   64 layers; group 12) beside deepseek-coder-33b (16 of 62 layers;
   group 7), whole-prompt; a cut config is
   ``config.replace(configs.get(arch), n_layers=k)`` served by a unit
   this script assembles (``build_cut_unit``); launches are counted in
   each phase;
5. plans full-width qwen2-7b ×2 + mamba2-2.7b for one H100 with the
   paper's placement algorithm (``core/placement.place``, H100
   constants), round-trips the plan through its JSON file, serves ~16
   requests of the plan's rates through the placement → runtime bridge
   with the plan's compute shares enforced (kernels 1, 2 and 4), and
   prints the discrete-event simulator's prediction for the same plan
   and trace beside the served result; then the serve CLI's
   ``--save-placement`` / ``--placement`` flags at reduced width plan
   two meshes and serve the plan on the card and on the CPU to the same
   report;
6. runs the W8/KV8 decode of full-width qwen2-7b: the weights quantized
   to int8 on the card, 8 prompts of 512 tokens prefilled, then 32
   decode steps with int8 weights and an int8 KV cache in lockstep with
   the bf16 decode and with a W8-only control (the int8 weights
   dequantized, bf16 cache), held at every step to the reference test's
   logit bound against bf16 and to its greedy rule against the control;
7. streams at full width (``serve_streaming``): two units of unequal
   mesh size (4 devices and 1 in the tick-cost model), each hosting one
   replica of qwen2-7b and mamba2-2.7b (full depth, no fused group);
   an explicit-replica trace served by ``serve_requests`` and streamed
   through ``ServingFrontend`` on fresh units of the same seeds must
   agree stream for output and report for report; a family-named trace
   through ``least_loaded`` routing with ``ServingMetrics`` and one
   stream cancelled mid-decode must free that request's blocks at once
   and keep the metrics consistent with the report (kernels 1, 2, 4);
8. degrades at full width (``serve_chaos``): a fused pair of qwen2-7b
   armed with bounded queues and deadline shedding gives the plain
   unit's tokens and report under an empty fault plan; then a burst at
   twice the rate streams through the front end with the sanitizer on
   every tick, a transient window, a crash (recovery re-stacks the
   pair) and a block loss of a quarter of the pair's grant, one stream
   cancelled: every request is finished, shed or cancelled, the arena
   shrinks by exactly the lost blocks, the pool ends free, kernels 1
   and 2 launch after the recovery, and the recovery's own peak device
   memory is printed.

Any failed phase raises and the script exits non-zero.  The last two
lines of standard output are the card (name, power limit) and a JSON
object; the line before them lists the kernels' numbers as JSON.
"""
from __future__ import annotations

import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
# The decode kernels' times at the full-width shapes before their
# split-KV redesign (one CTA per row and kv head; NVIDIA H100 80GB HBM3,
# 700 W; timed with an L2 flush by writing and no card sleep), and the
# SSD scan's: printed beside this run's times, not measured by it.
EARLIER_MS = {"decode": 0.1228, "dense_w8kv8_step": 0.0856,
              # the SSD scan's CUDA-core kernel before its tensor-core
              # redesign, by its own smoke script on the same card: the
              # mean of the two turns PERF.md's kernel table gives as
              # kernel 4's earlier time (NVIDIA H100 80GB HBM3, 700 W)
              "mamba2-2.7b chunk step bf16": 0.17495,
              "zamba2-1.2b whole-prompt bucket bf16": 0.4526}
LONG_TOKENS = 4096                 # the decode kernels' long-context point
LONG_SHAPES = ("qwen2-7b full width bf16",)   # the shapes that time it
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core bf16
              "float32": 67e12}    # f32 outside the tensor cores
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# The SSD scan's y sums up to a chunk's worth (Q <= 256) of terms, so a
# fixed absolute bf16 tolerance does not fit its range: its tolerance
# is relative to the plain output's largest magnitude (same numbers).
SSD_TOL_REL = TOL

# The attention kernels' shapes, each named by its label, with its dtype
# by name (``attn_shape`` resolves it): the kernel table's (PERF.md §6),
# full-width qwen2-7b and zamba2-1.2b's shared attention, which
# chip_compare.py also times, and the reduced f32 one.
FULL = dict(label="qwen2-7b full width bf16", dtype="bfloat16", H=28, KV=4,
            hd=128, layers=28, rows=8, max_blocks=64, C=64, S=512,
            flash_rows=4)
# zamba2-1.2b's shared attention block (6 applications, 32 heads of 64,
# group 1) at a whole-prompt bucket that is not a multiple of 64
ZAMBA = dict(label="zamba2-1.2b shared attention bf16", dtype="bfloat16",
             H=32, KV=32, hd=64, layers=6, rows=8, max_blocks=64, C=64,
             S=272, flash_rows=2)
SMALL = dict(label="qwen2-7b reduced f32", dtype="float32", H=4, KV=2, hd=64,
             layers=2, rows=8, max_blocks=64, C=16, S=64, flash_rows=4)
# the shapes of the configs beyond qwen2-7b: head_dim 96 (phi-3-vision
# -4.2b, MHA), group 12 (command-r-plus-104b) and group 16
# (qwen3-moe-235b-a22b), at the depths their phases serve, and the
# reduced f32 bodies at head_dim 96 and at group 16
WIDE = [
    dict(label="phi-3-vision-4.2b full width bf16", dtype="bfloat16", H=32,
         KV=32, hd=96, layers=32, rows=8, max_blocks=64, C=64, S=512,
         flash_rows=4),
    dict(label="command-r-plus-104b full width bf16", dtype="bfloat16",
         H=96, KV=8, hd=128, layers=4, rows=8, max_blocks=64, C=64, S=512,
         flash_rows=4),
    dict(label="qwen3-moe-235b-a22b full width bf16", dtype="bfloat16",
         H=64, KV=4, hd=128, layers=4, rows=8, max_blocks=64, C=64, S=512,
         flash_rows=4),
    dict(label="reduced f32 head_dim 96", dtype="float32", H=4, KV=4, hd=96,
         layers=2, rows=8, max_blocks=64, C=16, S=64, flash_rows=4),
    dict(label="reduced f32 group 16", dtype="float32", H=16, KV=1, hd=64,
         layers=2, rows=8, max_blocks=64, C=16, S=64, flash_rows=4),
]


def attn_shape(torch, shape: dict) -> dict:
    """One of the shapes above with its dtype as a torch dtype, as
    ``check_kernels`` and ``check_int8`` take it."""
    return {**shape, "dtype": getattr(torch, shape["dtype"])}



def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _cold_l2(torch, buf):
    """Evict the L2 cache as the serving loop does between attention
    calls: by reading 256 MB (streamed weights), which leaves clean
    lines.  Then keep the card busy ~0.2 ms, so the host has enqueued
    the timed call before the card reaches it: the window then holds
    the call's device time, not the host's enqueue."""
    buf.sum()
    torch.cuda._sleep(400_000)


def time_ms(torch, fn, iters: int = 25) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each with
    L2 cold (``_cold_l2``), between CUDA events."""
    flush = torch.ones(64 << 20, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        _cold_l2(torch, flush)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del flush
    times.sort()
    return times[len(times) // 2]


def host_us(torch, fn, n: int = 60) -> float:
    """Host time per call, in microseconds, to enqueue ``n`` calls of
    ``fn`` (no sync between them: 60 launches stay far inside the launch
    queue, so the card does not hold the host back)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / n * 1e6


def call_us(torch, fn, iters: int = 25) -> float:
    """Median wall time of one call of ``fn``, in microseconds, from the
    host's call to the card's end of its work, each with L2 cold and the
    card idle before it: the host's enqueue, the launches and the device
    time in series (and one synchronize), as a call that finds the card
    idle sees them."""
    flush = torch.ones(64 << 20, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.sum()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    del flush
    times.sort()
    return times[len(times) // 2] * 1e6


def profiler_ms(torch, fn, match: str = "splitkv_", iters: int = 20):
    """Device time of ``fn``'s kernels whose names contain ``match``,
    from ``torch.profiler``'s CUDA activity over ``iters`` calls, each
    with L2 cold as in ``time_ms``: ``ms``, the mean span of a call
    (its first kernel's start to its last kernel's end: the merge
    kernel's launch overlaps the split kernel), and each kernel's mean
    duration.  ``ms`` is None when the trace holds no device time."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    flush = torch.ones(64 << 20, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            _cold_l2(torch, flush)
            fn()
        torch.cuda.synchronize()
    del flush
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    kern = sorted((e for e in events if str(e.get("cat", "")).lower()
                   == "kernel" and match in e.get("name", "")),
                  key=lambda e: e["ts"])
    spans, per = [], {}
    for e in kern:                     # a call opens with its split kernel
        name = re.sub(r"^void repro::|\(.*$", "", e["name"])
        per.setdefault(name, []).append(e["dur"])
        if "combine" not in name or not spans:
            spans.append([e["ts"], e["ts"] + e["dur"]])
        else:
            spans[-1][1] = max(spans[-1][1], e["ts"] + e["dur"])
    return dict(ms=(sum(b - a for a, b in spans) / len(spans) / 1e3
                    if spans else None),
                calls=len(spans),
                kernels_ms={k: sum(v) / len(v) / 1e3 for k, v in per.items()})


def bound_ms(n_bytes: float, flops: float, dtype_name: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _sass_counts(src: str, opcode: str) -> dict:
    """Instructions of ``opcode`` per kernel in the SASS of ``src``'s
    library (``cuobjdump -sass``), by demangled name."""
    from repro_torch.kernels import build
    tool = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(build.library_path(src))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and re.search(rf"\b{opcode}\b", line):
            counts[fn] += 1
    if shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(counts),
                               capture_output=True, text=True, check=True,
                               timeout=60).stdout.splitlines()
        counts = dict(zip(names, counts.values()))
    return counts


def tensor_core_sass() -> dict:
    """Tensor-core instructions per kernel instantiation: HGMMA (wgmma)
    in the two prefill libraries (head dims 64, 96, 128), HMMA
    (mma.sync) in the two decode libraries (head dims 64, 96, 128, one
    or two 8-head halves of the m16 tile) and the SSD scan's.  Raises
    unless every bf16 instantiation (``tc_attention_kernel``,
    ``splitkv_tc_kernel``, ``ssd_scan_tc_kernel``) has some and every
    float32 one (the CUDA-core bodies) has none."""
    counts = {}
    for src in ("flash_prefill.cu", "paged_prefill.cu"):
        counts.update(_sass_counts(src, "HGMMA"))
    tc = {k: v for k, v in counts.items() if "tc_attention_kernel" in k}
    f32 = {k: v for k, v in counts.items() if "prefill_kernel" in k}
    if len(tc) != 6 or min(tc.values()) == 0:
        raise AssertionError(f"bf16 prefill kernels without HGMMA: {tc}")
    if len(f32) != 6 or max(f32.values()) != 0:
        raise AssertionError(f"float32 prefill kernels with HGMMA: {f32}")
    dec = {}
    for src in ("paged_decode.cu", "paged_decode_int8.cu"):
        dec.update(_sass_counts(src, "HMMA"))
    dec_tc = {k: v for k, v in dec.items() if "splitkv_tc_kernel" in k}
    dec_f32 = {k: v for k, v in dec.items() if "splitkv_f32_kernel" in k}
    if len(dec_tc) != 12 or min(dec_tc.values()) == 0:
        raise AssertionError(f"bf16 decode kernels without HMMA: {dec_tc}")
    if len(dec_f32) != 6 or max(dec_f32.values()) != 0:
        raise AssertionError(f"float32 decode kernels with HMMA: {dec_f32}")
    ssd = _sass_counts("ssd_scan.cu", "HMMA")
    ssd_tc = {k: v for k, v in ssd.items() if "ssd_scan_tc_kernel" in k}
    ssd_f32 = {k: v for k, v in ssd.items() if "ssd_scan_kernel" in k}
    if len(ssd_tc) != 3 or min(ssd_tc.values()) == 0:
        raise AssertionError(f"bf16 SSD kernels without HMMA: {ssd_tc}")
    if len(ssd_f32) != 1 or max(ssd_f32.values()) != 0:
        raise AssertionError(f"float32 SSD kernel with HMMA: {ssd_f32}")
    return {"HGMMA": {"bf16": tc, "float32": f32},
            "HMMA": {"bf16": {**dec_tc, **ssd_tc},
                     "float32": {**dec_f32, **ssd_f32}}}


# ---------------------------------------------------------------------------
# kernel checks
# ---------------------------------------------------------------------------
def _random_tables(np, rng, rows, max_blocks, n_groups, group_size,
                   blocks_needed):
    bases = rng.permutation(n_groups)[:rows * max_blocks] * group_size
    t = np.full((rows, max_blocks), -1, np.int32)
    used = 0
    for r in range(rows):
        k = int(blocks_needed[r])
        t[r, :k] = bases[used:used + k]
        used += k
    return t


def check_kernels(torch, np, shape: dict) -> dict:
    """Hold the three kernels against their plain versions at one set of
    serving shapes; returns per-kernel numbers."""
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.paging import resolve_physical_blocks
    F = torch.nn.functional

    dt = shape["dtype"]
    dname = str(dt).replace("torch.", "")
    es = torch.empty((), dtype=dt).element_size()
    H, KV, hd, L = shape["H"], shape["KV"], shape["hd"], shape["layers"]
    G = H // KV
    rows, W, C, S = shape["rows"], shape["max_blocks"], shape["C"], shape["S"]
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*s):
        return torch.randn(s, generator=gen, device="cuda").to(dt)

    gsz = L * KV
    n_groups = rows * W
    pool_k, pool_v = randn(n_groups * gsz, 16, hd), randn(n_groups * gsz, 16, hd)
    res = {}

    # decode: rows of the fused tick at mixed lengths
    lens = rng.integers(16, 16 * W - 16, rows).astype(np.int32)
    table = _random_tables(np, rng, rows, W, n_groups, gsz, -(-lens // 16))
    phys = resolve_physical_blocks(torch.from_numpy(table).cuda(), L - 1, KV)
    seq = torch.from_numpy(lens).cuda()
    q = randn(rows, H, hd)
    out = pa.fused_paged_decode_attention(q, pool_k, pool_v, phys, seq)
    ref = pa.decode_plain(q, pool_k, pool_v, phys, seq)
    err = (out.float() - ref.float()).abs().max().item()
    idx = phys.long()
    kg = pool_k[idx].reshape(rows, KV, W * 16, hd).repeat_interleave(G, 1)
    vg = pool_v[idx].reshape(rows, KV, W * 16, hd).repeat_interleave(G, 1)
    mask = (torch.arange(W * 16, device="cuda")[None, :]
            < seq[:, None])[:, None, None, :]

    def decode_row(q, pool_k, pool_v, phys, seq, err, kg, vg, mask, tok):
        flops = 4 * tok * H * hd
        b, why = bound_ms(2 * rows * H * hd * es + 2 * tok * KV * hd * es
                          + phys.numel() * 4 + rows * 4, flops, dname)
        kern = lambda: pa.fused_paged_decode_attention(q, pool_k, pool_v,
                                                        phys, seq)
        q4 = q[:, :, None, :]
        return dict(
            max_abs_err=err, flops=flops, cached_tokens=tok,
            ms=time_ms(torch, kern),
            plain_ms=time_ms(torch, lambda: pa.decode_plain(
                q, pool_k, pool_v, phys, seq)),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, kg, vg, attn_mask=mask)),
            bound_ms=b, bound_by=why, host_us=host_us(torch, kern),
            call_us=call_us(torch, kern), profiler=profiler_ms(torch, kern))

    res["decode"] = decode_row(q, pool_k, pool_v, phys, seq, err, kg, vg,
                               mask, int(lens.sum()))
    if shape["label"] in LONG_SHAPES:
        res["decode"]["earlier_ms"] = EARLIER_MS["decode"]
    del kg, vg
    if shape["label"] in LONG_SHAPES:
        # the long-context point: every row at LONG_TOKENS cached tokens
        # (one layer's pool, so the pool is the bytes the kernel reads),
        # from generators of its own: the other shapes' inputs stay
        lgen = torch.Generator(device="cuda").manual_seed(1)

        def lrandn(*s):
            return torch.randn(s, generator=lgen, device="cuda").to(dt)
        Wl = LONG_TOKENS // 16
        lk, lv = lrandn(rows * Wl * KV, 16, hd), lrandn(rows * Wl * KV, 16, hd)
        tl = (np.arange(rows * Wl, dtype=np.int32) * KV).reshape(rows, Wl)
        tl = np.ascontiguousarray(
            tl[:, np.random.default_rng(1).permutation(Wl)])
        lphys = resolve_physical_blocks(torch.from_numpy(tl).cuda(), 0, KV)
        lseq = torch.full((rows,), LONG_TOKENS, dtype=torch.int32,
                          device="cuda")
        ql = lrandn(rows, H, hd)
        out = pa.fused_paged_decode_attention(ql, lk, lv, lphys, lseq)
        ref = pa.decode_plain(ql, lk, lv, lphys, lseq)
        lerr = (out.float() - ref.float()).abs().max().item()
        # a 4096-token row's outputs are ~sqrt(e / 4096) in size, so an
        # absolute tolerance would be as large as the outputs themselves:
        # the tolerance is relative to the plain output's largest magnitude
        ltol = TOL[dname] * ref.float().abs().max().item()
        idx = lphys.long()
        kg = lk[idx].reshape(rows, KV, LONG_TOKENS, hd).repeat_interleave(G, 1)
        vg = lv[idx].reshape(rows, KV, LONG_TOKENS, hd).repeat_interleave(G, 1)
        lmask = torch.ones((rows, 1, 1, LONG_TOKENS), dtype=torch.bool,
                           device="cuda")
        res["decode_long"] = dict(
            decode_row(ql, lk, lv, lphys, lseq, lerr, kg, vg, lmask,
                       rows * LONG_TOKENS),
            tolerance=ltol, tolerance_rel=TOL[dname])
        del kg, vg, lk, lv

    # chunk prefill: C-token chunks at mixed offsets
    offs = (rng.integers(0, (16 * W - C) // C, rows) * C).astype(np.int32)
    offs[0] = 0
    table = _random_tables(np, rng, rows, W, n_groups, gsz,
                           -(-(offs + C) // 16))
    phys = resolve_physical_blocks(torch.from_numpy(table).cuda(), L - 1, KV)
    qo = torch.from_numpy(offs).cuda()
    q = randn(rows, C, H, hd)
    out = fp.fused_paged_flash_prefill(q, pool_k, pool_v, phys, qo)
    ref = fp.paged_prefill_plain(q, pool_k, pool_v, phys, qo)
    err = (out.float() - ref.float()).abs().max().item()
    idx = phys.long()
    kg = pool_k[idx].reshape(rows, KV, W * 16, hd).repeat_interleave(G, 1)
    vg = pool_v[idx].reshape(rows, KV, W * 16, hd).repeat_interleave(G, 1)
    qpos = qo[:, None] + torch.arange(C, device="cuda")[None, :]
    mask = (torch.arange(W * 16, device="cuda")[None, None, :]
            <= qpos[:, :, None])[:, None]
    qt = q.transpose(1, 2)
    keys = int((offs + C).sum())
    pairs = int(sum(C * o + C * (C + 1) // 2 for o in offs))
    flops = 4 * pairs * H * hd
    b, why = bound_ms(2 * q.numel() * es + 2 * keys * KV * hd * es
                      + phys.numel() * 4 + rows * 4, flops, dname)
    res["chunk"] = dict(
        max_abs_err=err, flops=flops,
        ms=time_ms(torch, lambda: fp.fused_paged_flash_prefill(
            q, pool_k, pool_v, phys, qo)),
        plain_ms=time_ms(torch, lambda: fp.paged_prefill_plain(
            q, pool_k, pool_v, phys, qo)),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kg, vg, attn_mask=mask)),
        bound_ms=b, bound_by=why)
    if dname == "bfloat16":   # checks, output, two TMA maps, launch
        kern = lambda: fp.fused_paged_flash_prefill(q, pool_k, pool_v, phys,
                                                    qo)
        res["chunk"]["host_us"] = host_us(torch, kern)
        res["chunk"]["call_us"] = call_us(torch, kern)
    del kg, vg, pool_k, pool_v

    # dense flash prefill: a whole-prompt bucket
    B = shape["flash_rows"]
    q, k, v = randn(B, S, H, hd), randn(B, S, KV, hd), randn(B, S, KV, hd)
    out = fp.flash_prefill(q, k, v)
    ref = fp.flash_prefill_plain(q, k, v)
    err = (out.float() - ref.float()).abs().max().item()
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2).repeat_interleave(G, 1)
    vt = v.transpose(1, 2).repeat_interleave(G, 1)
    flops = 4 * B * H * hd * S * (S + 1) // 2
    b, why = bound_ms((2 * q.numel() + 2 * k.numel()) * es, flops, dname)
    res["flash"] = dict(
        max_abs_err=err, flops=flops,
        ms=time_ms(torch, lambda: fp.flash_prefill(q, k, v)),
        plain_ms=time_ms(torch, lambda: fp.flash_prefill_plain(q, k, v)),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        bound_ms=b, bound_by=why)
    if dname == "bfloat16":
        kern = lambda: fp.flash_prefill(q, k, v)
        res["flash"]["host_us"] = host_us(torch, kern)
        res["flash"]["call_us"] = call_us(torch, kern)
    for name, r in res.items():
        tol = r.setdefault("tolerance", TOL[dname])
        if not r["max_abs_err"] <= tol:
            raise AssertionError(f"{name} kernel disagrees with its plain "
                                 f"version at {shape['label']}: "
                                 f"{r['max_abs_err']} > {tol}")
        r["tflops"] = r["flops"] / r["ms"] / 1e9
    torch.cuda.synchronize()
    return res


def check_int8(torch, np, shape: dict) -> dict:
    """Hold the int8 decode kernel against its plain version at one set
    of shapes, through both of its addressings: the paged pool (the
    Pallas kernel's) over rows of 16 .. 16*W-16 cached tokens, and one
    layer of a dense [L, B, S, KV, hd] cache read in place, first with
    the same rows' tokens (S = 16*W: the two addressings read the same
    data), then at the W8/KV8 decode's own shape (S = 544).  Returns
    per-addressing numbers."""
    from repro_torch.kernels import paged_attention_int8 as pi8
    from repro_torch.paging import resolve_physical_blocks
    F = torch.nn.functional

    dt = shape["dtype"]
    dname = str(dt).replace("torch.", "")
    es = torch.empty((), dtype=dt).element_size()
    H, KV, hd, L = shape["H"], shape["KV"], shape["hd"], shape["layers"]
    G = H // KV
    rows, W = shape["rows"], shape["max_blocks"]
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def int8_cache(*s, g=gen):
        q = torch.randint(-127, 128, s, generator=g, device="cuda",
                          dtype=torch.int8)
        return q, torch.rand(s[:-1], generator=g, device="cuda") * 0.05 + 1e-3

    gsz = L * KV
    n_groups = rows * W
    pk, psk = int8_cache(n_groups * gsz, 16, hd)
    pv, psv = int8_cache(n_groups * gsz, 16, hd)
    lens = rng.integers(16, 16 * W - 16, rows).astype(np.int32)
    table = _random_tables(np, rng, rows, W, n_groups, gsz, -(-lens // 16))
    phys = resolve_physical_blocks(torch.from_numpy(table).cuda(), L - 1, KV)
    seq = torch.from_numpy(lens).cuda()
    q = torch.randn((rows, H, hd), generator=gen, device="cuda").to(dt)
    # the dense layout of the same rows: layer 1 of a 3-layer cache
    idx = phys.long()

    def dense_of(pool):
        x = pool[idx].reshape(rows, KV, W * 16, *pool.shape[2:])
        return x.transpose(1, 2).contiguous()
    dense = [torch.stack([torch.zeros_like(d), d, torch.zeros_like(d)])
             for d in (dense_of(pk), dense_of(pv), dense_of(psk),
                       dense_of(psv))]
    S2, lo = 544, 513           # the W8/KV8 phase: 512 + 32 tokens
    d2 = [int8_cache(3, rows, S2, KV, hd) for _ in range(2)]
    seq2 = torch.from_numpy(rng.integers(lo, S2 + 1, rows)
                            .astype(np.int32)).cuda()
    def dense_case(ck, cv, sk, sv, lens_t):
        args = (q, ck, cv, sk, sv, lens_t)
        return (lambda: pi8.dense_decode_attention_int8(*args),
                lambda: pi8.dense_int8_plain(*args),
                lambda: tuple((c.float() * sc[..., None]).transpose(1, 2)
                              for c, sc in ((ck, sk), (cv, sv))),
                lens_t, ck.shape[1])
    cases = {}
    if shape["label"] in LONG_SHAPES:
        # the long-context point: a one-layer dense cache, every row at
        # LONG_TOKENS cached tokens (a generator of its own)
        lgen = torch.Generator(device="cuda").manual_seed(1)
        dl = [int8_cache(1, rows, LONG_TOKENS, KV, hd, g=lgen)
              for _ in range(2)]
        cases["dense_long"] = dense_case(
            dl[0][0][0], dl[1][0][0], dl[0][1][0], dl[1][1][0],
            torch.full((rows,), LONG_TOKENS, dtype=torch.int32,
                       device="cuda"))
    cases = {
        **cases,
        "paged": (lambda: pi8.fused_paged_decode_attention_int8(
                      q, pk, pv, psk, psv, phys, seq),
                  lambda: pi8.paged_int8_plain(q, pk, pv, psk, psv, phys,
                                               seq),
                  lambda: (pk[idx].float() * psk[idx][..., None],
                           pv[idx].float() * psv[idx][..., None]), seq, W * 16),
        "dense": dense_case(*(d[1] for d in dense), seq),
        "dense_w8kv8_step": dense_case(d2[0][0][1], d2[1][0][1], d2[0][1][1],
                                       d2[1][1][1], seq2),
    }
    res = {}
    outs = {}
    for name, (kern, plain, deq, lens_t, T) in cases.items():
        out = outs[name] = kern()
        ref = plain()
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL[dname] * ref.float().abs().max().item()
        if not err <= tol:
            raise AssertionError(f"int8 decode kernel ({name}) disagrees with "
                                 f"its plain version at {shape['label']}: "
                                 f"{err} > {tol}")
        # library yardstick: SDPA over K/V dequantized and gathered
        # beforehand (only the call is timed)
        kd, vd = (x.reshape(rows, KV, T, hd).to(dt).repeat_interleave(G, 1)
                  for x in deq())
        mask = (torch.arange(T, device="cuda")[None, :]
                < lens_t[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        tok = int(lens_t.sum().item())
        # bytes: the int8 K/V and their f32 scales of the cached tokens,
        # q and the output once (and the table for the paged pool)
        n_bytes = (2 * rows * H * hd * es + 2 * tok * KV * (hd + 4)
                   + (phys.numel() * 4 if name == "paged" else 0) + rows * 4)
        flops = 4 * tok * H * hd
        b, why = bound_ms(n_bytes, flops, dname)
        ms = time_ms(torch, kern)
        res[name] = dict(
            max_abs_err=err, tolerance=tol, tolerance_rel=TOL[dname],
            ms=ms, tflops=flops / ms / 1e9, plain_ms=time_ms(torch, plain),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, kd, vd, attn_mask=mask)),
            bound_ms=b, bound_by=why, bytes=n_bytes,
            cached_tokens=[int(lens_t.min()), int(lens_t.max())],
            host_us=host_us(torch, kern), call_us=call_us(torch, kern),
            profiler=profiler_ms(torch, kern))
        if shape["label"] in LONG_SHAPES and name in EARLIER_MS:
            res[name]["earlier_ms"] = EARLIER_MS[name]
        del kd, vd
    res["dense"]["max_abs_diff_vs_paged"] = (
        outs["dense"].float() - outs["paged"].float()).abs().max().item()
    torch.cuda.synchronize()
    return res


def check_ssd(torch, shape: dict) -> dict:
    """Hold the SSD-scan kernel against its plain version at one shape;
    returns its numbers: the kernel's time, the plain version's, the
    bound, the wrapper's host time and one call's wall time, the
    profiler's span and the launch's plan (P-slice, warps) and CTA count.
    No single
    PyTorch call computes SSD, so there is no library yardstick
    (``library_ms`` null)."""
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels.build import sm_count
    dt_ = shape["dtype"]
    dname = str(dt_).replace("torch.", "")
    es = torch.empty((), dtype=dt_).element_size()
    b, S, H, G, N, Q = (shape[k] for k in ("b", "S", "H", "G", "N", "chunk"))
    P = ss.HEAD_DIM
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*s):
        return torch.randn(s, generator=gen, device="cuda")
    x = randn(b, S, H, P).to(dt_)
    dt = torch.nn.functional.softplus(randn(b, S, H) - 2.0)
    a_log = torch.log(torch.linspace(1.0, 16.0, H, device="cuda"))
    B, C = randn(b, S, G, N).to(dt_), randn(b, S, G, N).to(dt_)
    d_skip = torch.ones(H, device="cuda")
    st = randn(b, H, P, N) * 0.1 if shape["init"] else None
    y, fs = ss.ssd_scan(x, dt, a_log, B, C, d_skip, Q, st)
    y_ref, fs_ref = ss.ssd_plain(x, dt, a_log, B, C, d_skip, Q, st)
    rel = SSD_TOL_REL[dname]
    errs, tols = [], []               # y, then the final state
    for out, ref in ((y, y_ref), (fs, fs_ref)):
        errs.append((out.float() - ref.float()).abs().max().item())
        tols.append(rel * ref.float().abs().max().item())
    # bytes: every input read once, every output written once; flops:
    # per chunk of q rows and head, C.B and scores.(x dt) over the q(q+1)/2
    # causal pairs, C.S_prev and the state update over q x P x N
    n_bytes = (2 * x.numel() * es + dt.numel() * 4 + 2 * H * 4
               + 2 * B.numel() * es + (2 if st is not None else 1)
               * b * H * P * N * 4)
    flops = 0
    for c0 in range(0, S, Q):
        q = min(Q, S - c0)
        flops += (q * (q + 1) // 2) * (2 * N + 2 * P) + 4 * q * P * N
    flops *= b * H
    bnd, why = bound_ms(n_bytes, flops, dname)
    kern = lambda: ss.ssd_scan(x, dt, a_log, B, C, d_skip, Q, st)
    plan = (ss.plan_launch(b, H, Q, N, sm_count(x.device))
            if dt_ == torch.bfloat16 else ss.F32_PLAN)
    res = dict(max_abs_err=errs[0], tolerance=tols[0],
               state_max_abs_err=errs[1], state_tolerance=tols[1],
               tolerance_rel=rel, ms=time_ms(torch, kern),
               plain_ms=time_ms(torch, lambda: ss.ssd_plain(
                   x, dt, a_log, B, C, d_skip, Q, st)),
               library_ms=None, bound_ms=bnd, bound_by=why,
               bytes=n_bytes, flops=flops, p_slice=plan[0], warps=plan[1],
               ctas=ss.grid_ctas(b, H, plan[0]),
               host_us=host_us(torch, kern), call_us=call_us(torch, kern),
               profiler=profiler_ms(torch, kern, match="ssd_scan"))
    res["tflops"] = flops / res["ms"] / 1e9
    if shape["label"] in EARLIER_MS:
        res["earlier_ms"] = EARLIER_MS[shape["label"]]
    if dt_ == torch.bfloat16:
        # the plan was made from the host's copy of the shared-memory
        # layout: it must be the built source's
        smem = (ss.tc_smem_bytes(Q, N, plan[0]), ss.source_smem(Q, N, plan[0]))
        if smem[0] != smem[1] or ss.source_smem(0, 0, 0) != ss.MAX_SMEM:
            raise AssertionError(f"ssd_scan: the host's shared-memory "
                                 f"layout {smem[0]} B is not the source's "
                                 f"{smem[1]} B at {shape['label']}")
    if not all(e <= t for e, t in zip(errs, tols)):
        raise AssertionError(f"ssd_scan disagrees with its plain version at "
                             f"{shape['label']}: |Δ| {errs} > {tols} "
                             f"({rel} of the plain outputs' largest "
                             f"magnitudes)")
    torch.cuda.synchronize()
    return res


# ---------------------------------------------------------------------------
# serving phases
# ---------------------------------------------------------------------------
def reduced_steps_match(torch, np) -> str:
    """The serving steps on the card (kernels) against the same steps on
    the CPU (plain versions), reduced qwen2-7b in f32, same weights and
    inputs; then the same small trace served on both to one report."""
    from repro_torch import configs
    from repro_torch.core.workload import synthesize
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import driver, engine
    from repro_torch.serving.engine import tree_map
    from repro_torch.serving.kvcache import UnifiedKVPool

    cfg = configs.get_reduced("qwen2-7b")
    trees = [init_params(cfg, torch.Generator().manual_seed(i),
                         torch.float32, "cpu") for i in range(2)]
    stacked = {k: torch.stack([t["tok"][k] for t in trees])
               for k in trees[0]["tok"]}
    stacked = {"tok": stacked,
               "layers": {k: torch.stack([t["layers"][k] for t in trees])
                          for k in trees[0]["layers"]}}
    rng = np.random.default_rng(0)
    M, R, C, W = 2, 4, 16, 8
    worst = 0.0
    pools = {}
    for dev in ("cpu", "cuda"):
        pools[dev] = UnifiedKVPool(2048, cfg.hd, torch.float32, device=dev)
    for dev in ("cpu", "cuda"):
        pools[dev].k.copy_(torch.randn(pools["cpu"].k.shape,
                                       generator=torch.Generator().manual_seed(7)))
        pools[dev].v.copy_(torch.randn(pools["cpu"].v.shape,
                                       generator=torch.Generator().manual_seed(8)))
    tables = (rng.permutation(2048 // 4)[:M * R * W] * 4).reshape(M, R, W)
    tables = tables.astype(np.int32)
    toks = rng.integers(1, cfg.vocab_size, (M, R, C)).astype(np.int32)
    offs = np.array([[0, 16, 32, 48]] * M, np.int32)
    clens = np.full((M, R), C, np.int32)
    lens = rng.integers(1, 16 * W, (M, R)).astype(np.int32)
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda a: a.to(dev), stacked)
        pool = pools[dev]
        lc = engine._fused_prefill_chunk_step(p, toks, offs, clens, pool,
                                              tables, cfg=cfg)
        ld = engine._fused_decode_step(p, toks[:, :, 0], lens, pool, tables,
                                       cfg=cfg)
        lp = engine._prefill_step(p, 1, toks[0], clens[0], pool, tables[0],
                                  cfg=cfg)
        out[dev] = [x.float().cpu() for x in (lc, ld, lp)] + [pool.k.cpu()]
    for a, b in zip(out["cpu"], out["cuda"]):
        worst = max(worst, (a - b).abs().max().item())
    if not worst <= 1e-3:
        raise AssertionError(f"reduced serving steps: card vs CPU {worst}")

    names = ["a", "b"]
    wl = synthesize(names, alpha=2.1, max_rate=12.0, horizon=1.0, seed=0,
                    mean_prompt=24, mean_output=8, max_len=128)
    reports, toks_by = {}, {}
    for dev in ("cpu", "cuda"):
        unit = driver.build_unit_from_specs(
            [(n, "qwen2-7b", wl.rates[n]) for n in names], pool_blocks=4000,
            chunk_tokens=16, fused=True, dtype=torch.float32, device=dev,
            params=[tree_map(lambda a: a.to(dev), t) for t in trees])
        rep = driver.serve_workload([unit], wl, cost=driver.TickCostModel())
        reports[dev] = {k: v for k, v in rep.to_json().items()
                        if k != "wall_s"}
        toks_by[dev] = {r.req_id: r.output for r in unit.stats.finished}
    if reports["cpu"] != reports["cuda"]:
        raise AssertionError("reduced trace: card and CPU reports differ")
    same = sum(toks_by["cpu"][i] == toks_by["cuda"].get(i)
               for i in toks_by["cpu"])
    return (f"reduced steps card-vs-CPU max|Δ|={worst:.2e}; trace of "
            f"{len(toks_by['cpu'])} requests: reports identical, "
            f"{same}/{len(toks_by['cpu'])} greedy outputs identical")


def reduced_ssm_steps_match(torch, np) -> str:
    """The SSM serving steps on the card (SSD kernel; flash-prefill and
    paged-decode kernels for zamba2's shared attention) against the same
    steps on the CPU (plain versions): reduced mamba2-2.7b (chunk,
    whole-prompt and decode steps) and zamba2-1.2b (whole-prompt and
    decode), f32, same weights, carried states and pool contents.  The
    whole prompt is 80 tokens, which the 32-token chunk does not divide,
    so it runs through the padded scan."""
    from repro_torch import configs
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import engine
    from repro_torch.serving.engine import tree_map
    from repro_torch.serving.kvcache import UnifiedKVPool

    worst = {}
    for arch in ("mamba2-2.7b", "zamba2-1.2b"):
        cfg = configs.get_reduced(arch)
        sc = cfg.ssm
        tree = tree_map(lambda a: a[None], init_params(
            cfg, torch.Generator().manual_seed(3), torch.float32, "cpu"))
        rng = np.random.default_rng(1)
        B, C, S, W = 4, 16, 80, 8
        toks = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
        lens = np.array([80, 71, 40, 9], np.int32)
        clens = np.array([16, 16, 9, 1], np.int32)
        gsz = max(cfg.n_attn_layers * cfg.n_kv_heads, 1)
        tables = (rng.permutation(2048 // gsz)[:B * W] * gsz).reshape(B, W)
        tables = tables.astype(np.int32)
        g = torch.Generator().manual_seed(5)
        conv_dim = cfg.d_inner + 2 * sc.n_groups * sc.d_state
        st0 = torch.randn((cfg.n_layers, B, cfg.n_ssm_heads, sc.head_dim,
                           sc.d_state), generator=g) * 0.1
        tail0 = torch.randn((cfg.n_layers, B, sc.conv_kernel - 1, conv_dim),
                            generator=g)
        kv0 = torch.randn((2, 2048, 16, 64), generator=g)
        out = {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda a: a.to(dev), tree)
            pool = UnifiedKVPool(2048, 64, torch.float32, device=dev)
            pool.k.copy_(kv0[0])
            pool.v.copy_(kv0[1])
            res = []
            if cfg.family == "ssm":
                res += engine._prefill_chunk_ssm_step(
                    p, 0, toks[:, :C], clens, st0.to(dev), tail0.to(dev),
                    cfg=cfg)
            lp, sp, tp = engine._prefill_ssm_step(p, 0, toks, lens, pool,
                                                  tables, cfg=cfg)
            res += [lp, sp, tp]
            res += engine._decode_ssm_step(p, 0, toks[:, 0], lens + 1, pool,
                                           tables, sp, tp, cfg=cfg)
            res.append(pool.k)
            out[dev] = [t.float().cpu() for t in res]
        worst[arch] = max((a - b).abs().max().item()
                          for a, b in zip(out["cpu"], out["cuda"]))
        if not worst[arch] <= 1e-3:
            raise AssertionError(f"reduced {arch} SSM steps: card vs CPU "
                                 f"{worst[arch]}")
    return ("reduced SSM steps card-vs-CPU max|Δ|: "
            + ", ".join(f"{a} {w:.2e}" for a, w in worst.items()))


def _w8kv8_caches(torch, pk, pv, steps: int):
    """int8 caches [L, B, S + steps, KV, hd] and scales [L, B, S + steps,
    KV] holding a prefill cache (the reference test's quantization,
    ``tests/test_quantize.py``), plus float caches of the same length
    for the float decode."""
    from repro_torch.serving.quantize import quantize_kv
    L, B, S, KV, hd = pk.shape
    out = []
    for p in (pk, pv):
        q, s = quantize_kv(p)
        c = torch.zeros((L, B, S + steps, KV, hd), dtype=torch.int8,
                        device=p.device)
        sc = torch.zeros((L, B, S + steps, KV), device=p.device)
        c[:, :, :S], sc[:, :, :S] = q, s
        out.append((c, sc))
    (ck, sk), (cv, sv) = out
    fk = torch.zeros((L, B, S + steps, KV, hd), dtype=pk.dtype,
                     device=pk.device)
    fv = torch.zeros_like(fk)
    fk[:, :, :S], fv[:, :, :S] = pk, pv
    return (ck, cv, sk, sv), (fk, fv)


def _greedy_flips(logits_q, logits_ref):
    """Rows whose greedy token differs, in two counts: all of them, and
    those beyond the reference test's near-tie (``tests/test_quantize.py``:
    the reference's gap to the chosen token above 1 % of its logit
    spread)."""
    aq = logits_q.argmax(-1)
    flip = aq != logits_ref.argmax(-1)
    gap = logits_ref.max(-1).values - logits_ref.gather(
        -1, aq[:, None])[:, 0]
    spread = logits_ref.max(-1).values - logits_ref.min(-1).values
    return int(flip.sum()), int((flip & (gap > 0.01 * spread)).sum())


def _near_tie_ok(logits_q, logits_ref) -> bool:
    """The reference test's greedy rule: same argmax, or a near-tie."""
    return _greedy_flips(logits_q, logits_ref)[1] == 0


def reduced_w8kv8_match(torch, np) -> str:
    """The W8/KV8 path on the card (flash-prefill and int8 decode
    kernels) against the same path on the CPU (plain versions): reduced
    qwen2-7b and reduced granite-moe-3b-a800m (the dropless MoE FFN, as
    the engine runs it), f32 weights drawn on the CPU and quantized on
    each device, the same prompts, 3 decode steps fed the CPU run's
    greedy token.
    Tolerances: the f32 prefill 1e-3 (as the other reduced steps); the
    W8/KV8 step runs bf16 products, which cuBLAS and the CPU round at
    different places, so logits within 2e-2 of the CPU's largest
    |logit|, scales within 2e-2 relative, int8 cache entries at most 2
    steps apart (as between the two packages on the CPU,
    ``tests/test_torch_steps.py``: rounding, plus a step where the bf16
    K/V differ by about 1 % of the row's largest value), greedy tokens
    equal except on near-ties."""
    return "; ".join(_reduced_w8kv8(torch, np, arch)
                     for arch in ("qwen2-7b", "granite-moe-3b-a800m"))


def _reduced_w8kv8(torch, np, arch) -> str:
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import tree_map
    from repro_torch.serving.quantize import quantize_params

    cfg = configs.get_reduced(arch)
    params = init_params(cfg, torch.Generator().manual_seed(11),
                         torch.float32, "cpu")
    rng = np.random.default_rng(12)
    B, S, n = 4, 40, 3
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    lens = torch.tensor([40, 33, 17, 8], dtype=torch.int32)
    moe = cfg.family == "moe"
    prefill = steps.make_prefill_step(cfg, moe_dropless=moe)
    decode = steps.make_decode_step_w8kv8(cfg, moe_dropless=moe)
    runs = {}
    nxt_cpu = []
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda a: a.to(dev), params)
        qp = quantize_params(p)
        ops.reset_launch_counts()
        out = prefill(p, toks.to(dev), lens.to(dev))
        caches, _ = _w8kv8_caches(torch, out["cache_k"], out["cache_v"], n)
        logits = [out["logits"]]
        for t in range(n):
            if dev == "cpu":
                nxt_cpu.append(logits[-1].argmax(-1))
            o = decode(qp, *caches, nxt_cpu[t].to(dev), (lens + t + 1).to(dev))
            logits.append(o["logits"])
        runs[dev] = dict(prefill=[out[k].cpu() for k in
                                  ("logits", "cache_k", "cache_v")],
                         logits=[x.float().cpu() for x in logits[1:]],
                         caches=[c.cpu() for c in caches],
                         launches=ops.launch_counts())
    c, g = runs["cpu"], runs["cuda"]
    worst_prefill = max((a - b).abs().max().item()
                        for a, b in zip(c["prefill"], g["prefill"]))
    worst_logit = max(((a - b).abs().max() / a.abs().max()).item()
                      for a, b in zip(c["logits"], g["logits"]))
    worst_int8 = max((a.int() - b.int()).abs().max().item()
                     for a, b in zip(c["caches"][:2], g["caches"][:2]))
    worst_scale = max(((a - b).abs().max() / a.abs().max()).item()
                      for a, b in zip(c["caches"][2:], g["caches"][2:]))
    ties = all(_near_tie_ok(b, a) for a, b in zip(c["logits"], g["logits"]))
    want = {"repro_flash_prefill": cfg.n_layers,
            "repro_decode_int8": cfg.n_layers * n}
    got = {k: g["launches"][k] for k in want}
    if not (worst_prefill <= 1e-3 and worst_logit <= 2e-2 and worst_int8 <= 2
            and worst_scale <= 2e-2 and ties and got == want):
        raise AssertionError(
            f"reduced {arch} W8/KV8 card vs CPU: prefill {worst_prefill}, logits "
            f"{worst_logit}, int8 {worst_int8}, scales {worst_scale}, greedy "
            f"{ties}, launches {got} (want {want})")
    return (f"reduced {arch} W8/KV8 card-vs-CPU: prefill "
            f"max|Δ|={worst_prefill:.2e}, "
            f"decode logits max|Δ|/max|logit|={worst_logit:.2e}, int8 cache "
            f"max|Δ|={worst_int8}, scales rel {worst_scale:.2e}, greedy tokens "
            f"equal except near-ties; kernel launches {got}")


def _dequantized_tree(torch, qparams):
    """The int8 tree's weights dequantized to bf16 as ``QLayerView``
    does (q and s each cast to bf16, then multiplied), as a plain tree
    for ``make_decode_step``: the W8 control."""
    def walk(d):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k.endswith("_q"):
                out[k[:-2]] = (v.to(torch.bfloat16)
                               * d[k[:-2] + "_s"].to(torch.bfloat16))
            elif not (k.endswith("_s") and k[:-2] + "_q" in d):
                out[k] = v
        return out
    return walk(qparams)


def w8kv8_full_width(torch, np, rows: int = 8, prompt: int = 512,
                     n_steps: int = 32) -> dict:
    """Full-width qwen2-7b W8/KV8 decode: a random bf16 tree from a
    seeded generator, quantized on the card; ``rows`` prompts of
    ``prompt`` tokens prefilled through the flash-prefill kernel; then
    ``n_steps`` decode steps of ``make_decode_step_w8kv8`` (every layer's
    attention through the int8 decode kernel) in lockstep with the bf16
    ``make_decode_step``, both fed the bf16 path's greedy token, and
    with a control: ``make_decode_step`` on the int8 weights dequantized
    to bf16 and the bf16 KV cache (W8 only: no int8 cache, no int8
    decode kernel).  Every step must meet: every logit finite; the
    reference test's max |Δlogit| / max |logit_bf16| < 0.1; and the
    reference test's greedy rule (same token, or the other's gap to it
    within 1 % of the logit spread) between the W8/KV8 step and the W8
    control — what the int8 cache and its kernel add.  Between the
    W8/KV8 and the bf16 step that rule does not hold at this vocabulary:
    it was set on 512 tokens, and over 152,064 random logits the int8
    weights alone flip rows beyond it; the flips against bf16, of both
    the W8/KV8 step and the W8 control, are counted and reported."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import tree_bytes
    from repro_torch.serving.quantize import quantize_params

    cfg = configs.get("qwen2-7b")
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(7),
                         torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qparams = quantize_params(params)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (rows, prompt))
                            ).cuda()
    lens = torch.full((rows,), prompt, dtype=torch.int32, device="cuda")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = steps.make_prefill_step(cfg)(params, toks, lens)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    caches, (fk, fv) = _w8kv8_caches(torch, out["cache_k"], out["cache_v"],
                                     n_steps)
    wk, wv = fk.clone(), fv.clone()
    w8params = _dequantized_tree(torch, qparams)
    logits_f = out["logits"]
    del out
    dec_q = steps.make_decode_step_w8kv8(cfg)
    dec_f = steps.make_decode_step(cfg)
    wall = {"w8kv8": 0.0, "bf16": 0.0}
    worst, rms, worst_kv = 0.0, 0.0, 0.0
    flips = {"w8kv8_vs_bf16": [0, 0], "w8_control_vs_bf16": [0, 0],
             "w8kv8_vs_w8_control": [0, 0]}
    for t in range(n_steps):
        nxt = logits_f.argmax(-1)
        lens_t = lens + t + 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lq = dec_q(qparams, *caches, nxt, lens_t)["logits"]
        torch.cuda.synchronize()
        wall["w8kv8"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        logits_f = dec_f(params, fk, fv, nxt, lens_t)["logits"]
        torch.cuda.synchronize()
        wall["bf16"] += time.perf_counter() - t0
        lw = dec_f(w8params, wk, wv, nxt, lens_t)["logits"]
        lq, lf, lw = lq.float(), logits_f.float(), lw.float()
        if not all(bool(torch.isfinite(x).all()) for x in (lq, lf, lw)):
            raise AssertionError(f"W8/KV8 step {t}: non-finite logits")
        rel = ((lq - lf).abs().max() / lf.abs().max()).item()
        worst = max(worst, rel)
        rms = max(rms, ((lq - lf).pow(2).mean().sqrt()
                        / lf.pow(2).mean().sqrt()).item())
        worst_kv = max(worst_kv,
                       ((lq - lw).abs().max() / lw.abs().max()).item())
        if not rel < 0.1:
            raise AssertionError(f"W8/KV8 step {t}: rel logit err {rel}")
        for key, (a, b) in (("w8kv8_vs_bf16", (lq, lf)),
                            ("w8_control_vs_bf16", (lw, lf)),
                            ("w8kv8_vs_w8_control", (lq, lw))):
            flips[key] = [x + y for x, y in zip(flips[key],
                                                _greedy_flips(a, b))]
        if flips["w8kv8_vs_w8_control"][1]:
            raise AssertionError(
                f"W8/KV8 step {t}: greedy tokens differ from the W8 "
                f"control beyond a near-tie")
    launches = ops.launch_counts()
    if launches["repro_decode_int8"] != cfg.n_layers * n_steps:
        raise AssertionError(f"int8 decode kernel launched "
                             f"{launches['repro_decode_int8']} times, not "
                             f"{cfg.n_layers} x {n_steps}")
    if launches["repro_flash_prefill"] != cfg.n_layers:
        raise AssertionError("the prefill did not run the flash-prefill "
                             "kernel once per layer")
    res = dict(
        rows=rows, prompt_tokens=prompt, decode_steps=n_steps,
        bf16_tree_gb=tree_bytes(params) / 1e9,
        int8_tree_gb=tree_bytes(qparams) / 1e9,
        int8_cache_gb=sum(c.numel() * c.element_size() for c in caches) / 1e9,
        bf16_cache_gb=2 * fk.numel() * fk.element_size() / 1e9,
        quantize_s=quant_s, prefill_s=prefill_s,
        max_rel_logit_err=worst, max_rel_rms_logit_err=rms,
        max_rel_logit_err_vs_w8_control=worst_kv,
        greedy_flips={k: dict(all=v[0], beyond_1pct_spread=v[1])
                      for k, v in flips.items()},
        decode_wall_s=wall,
        decode_tok_s={k: rows * n_steps / v for k, v in wall.items()},
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=launches)
    del params, qparams, w8params, caches, fk, fv, wk, wv
    gc.collect()
    torch.cuda.empty_cache()
    return res


def build_cut_unit(torch, specs, pool_blocks: int, chunk_tokens: int,
                   seed: int):
    """One colocated unit of ``(name, config, rate)`` specs whose configs
    may be cut in depth (``config.replace(configs.get(arch),
    n_layers=k)``), assembled from ``UnifiedKVPool``, ``Engine`` and
    ``MuxScheduler`` as ``serving/driver.build_unit_from_specs`` does:
    quotas ∝ rate, random bf16 weights from a ``torch.Generator`` seeded
    ``seed + i``, fused ADBS (engines of one geometry fuse)."""
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.kvcache import UnifiedKVPool
    from repro_torch.serving.mux import MuxScheduler
    head_dims = {cfg.hd for _, cfg, _ in specs if not cfg.attn_free}
    if len(head_dims) != 1:
        raise ValueError(f"one pool, one head_dim: {sorted(head_dims)}")
    pool = UnifiedKVPool(pool_blocks, head_dims.pop(), dtype=torch.bfloat16,
                         device="cuda")
    rate_sum = sum(max(r, 0.0) for _, _, r in specs)
    min_quota = max(pool_blocks // (8 * len(specs)), 1)
    engines = {}
    for i, (name, cfg, rate) in enumerate(specs):
        gen = torch.Generator(device="cuda").manual_seed(seed + i)
        tree = init_params(cfg, gen, torch.bfloat16, "cuda")
        quota = max(int(pool_blocks * max(rate, 0.0) / rate_sum), min_quota)
        engines[name] = Engine(cfg, tree, pool.register_model(cfg, quota),
                               max_slots=4, chunk_tokens=chunk_tokens or None)
        del tree
    return MuxScheduler(engines, pool, policy="adbs", fused=True)


def serve_full_width(torch, *args, **kw) -> dict:
    """One serve phase (``_serve_phase``), then the card's memory freed:
    the unit dies with that function's frame, and the collector frees
    what it leaves in reference cycles, so the next phase starts with
    nothing of it held."""
    res = _serve_phase(torch, *args, **kw)
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _serve_phase(torch, archs, chunk_tokens: int, n_target: int, seed: int,
                 must_launch, alpha: float = 2.1, pool_blocks: int = 16384,
                 depth=None) -> dict:
    """Serve the colocated full-width ``archs`` (random bf16 weights)
    under the logical clock; every request must finish, the pool must
    be freed and each kernel of ``must_launch`` must have launched in
    this run (every step's logits are checked finite by
    ``engine.greedy_tokens``, which raises otherwise).  ``depth`` (arch
    → layers) cuts configs in depth; such a unit is assembled by
    ``build_cut_unit``.  A MoE model's dropless FFN is counted per
    layer: every layer must have run it.  Returns the run's numbers and
    launch counts."""
    from collections import Counter

    from repro_torch import configs
    from repro_torch.config import replace
    from repro_torch.core.workload import synthesize
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.serving import driver, engine

    names = [f"{a}#{i}" for i, a in enumerate(archs)]
    # ~n_target requests: power-law rates (α) over a 1.6 s window
    wl = synthesize(names, alpha=alpha, max_rate=n_target / 2.0,
                    horizon=1.6, seed=seed, mean_prompt=256, mean_output=40,
                    max_len=512)
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9   # left by earlier work
    t0 = time.perf_counter()
    if depth:
        unit = build_cut_unit(torch, [
            (n, replace(configs.get(a), name=n,
                        n_layers=depth.get(a, configs.get(a).n_layers)),
             wl.rates[n]) for n, a in zip(names, archs)],
            pool_blocks, chunk_tokens, seed)
    else:
        unit = driver.build_unit_from_specs(
            [(n, a, wl.rates[n]) for n, a in zip(names, archs)],
            pool_blocks=pool_blocks, max_slots=4, chunk_tokens=chunk_tokens,
            seed=seed, policy="adbs", fused=True, reduced=False,
            dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    buckets0 = set(engine._BUCKETS)
    moe_calls = Counter()
    moe_ffn = moe.moe_ffn_dropless     # what moe.ffn calls for the engine

    def counted_moe(x, p, li, cfg):
        moe_calls[(cfg, li)] += 1      # cfg: the step's geometry key
        return moe_ffn(x, p, li, cfg)
    moe.moe_ffn_dropless = counted_moe
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        rep = driver.serve_workload([unit], wl, seed=seed, max_new_cap=64,
                                    cost=driver.TickCostModel())
        torch.cuda.synchronize()
    finally:
        moe.moe_ffn_dropless = moe_ffn
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    moe_layers = {}
    for name, eng in unit.engines.items():
        if eng.cfg.family == "moe":
            ran = {li for (c, li) in moe_calls if c == eng.cfg_key}
            if ran != set(range(eng.cfg.n_layers)):
                raise AssertionError(f"{name}: the MoE FFN ran on layers "
                                     f"{sorted(ran)} of {eng.cfg.n_layers}")
            moe_layers[name] = eng.cfg.n_layers
    agg = rep.aggregate
    if agg.finished != agg.submitted or agg.submitted == 0:
        raise AssertionError(f"served {agg.finished}/{agg.submitted}")
    if unit.pool.allocator.used != 0:
        raise AssertionError(f"pool not freed: {unit.pool.allocator.used}")
    for symbol in must_launch:
        if launches[symbol] <= 0:
            raise AssertionError(f"{symbol} never launched in this run")
    fin = unit.stats.finished
    n_out = sum(len(r.output) for r in fin)
    n_prompt = sum(len(r.prompt) for r in fin)
    lens = sorted(len(r.prompt) for r in fin)
    outs = sorted(len(r.output) for r in fin)
    per_model = {n: sum(r.model == n for r in fin) for n in names}
    # padded prompt lengths of the SSM/hybrid whole-prompt prefills
    ssm_prefill_lens = sorted({shapes[0][1] for kind, cfg, shapes
                               in engine._BUCKETS - buckets0
                               if kind == "prefill" and cfg.ssm})
    res = dict(models=archs, requests_per_model=per_model,
               depth={n: e.cfg.n_layers for n, e in unit.engines.items()},
               head_dim=unit.pool.head_dim,
               groups={n: e.cfg.n_heads // e.cfg.n_kv_heads
                       for n, e in unit.engines.items()
                       if not e.cfg.attn_free},
               chunk_tokens=chunk_tokens,
               requests=agg.submitted, ticks=rep.ticks,
               prompt_tokens=n_prompt, output_tokens=n_out,
               prompt_len_range=[lens[0], lens[-1]],
               output_len_range=[outs[0], outs[-1]],
               build_s=build_s, wall_s=wall,
               wall_tok_s=(n_prompt + n_out) / wall,
               wall_out_tok_s=n_out / wall,
               fused_groups=len(unit.fused_groups),
               pool_head_blocks=unit.pool.n_head_blocks,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
               held_before_gb=held_gb,
               phase_peak_gb=torch.cuda.max_memory_allocated() / 1e9 - held_gb,
               ssm_prefill_lens=ssm_prefill_lens,
               # one host synchronisation per MoE FFN call (its
               # per-expert counts)
               moe_ffn_calls=sum(moe_calls.values()),
               moe_ffn_layers=moe_layers,
               serial_engines=sorted(unit._serial_names),
               launches=launches, summary=rep.summary())
    return res


# ---------------------------------------------------------------------------
# the live serving layer and graceful degradation at full width
# ---------------------------------------------------------------------------
STREAM_FAMILIES = {"llm0": "qwen2-7b", "llm1": "mamba2-2.7b"}
STREAM_SCALES = (1.25, 1.5, 2.0, 3.0, 4.0, 6.0)


class _Memory:
    """The card's allocator counters for a phase (zeros on the CPU, where
    the phases are rehearsed at reduced width)."""

    def __init__(self, torch, dev):
        self.torch, self.cuda = torch, dev.type == "cuda"
        self.peak = 0.0
        if self.cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        self.held = self.now()

    def now(self) -> float:
        return (self.torch.cuda.memory_allocated() / 1e9 if self.cuda
                else 0.0)

    def fold(self) -> float:
        """The peak so far (the allocator's, kept across resets)."""
        if self.cuda:
            self.torch.cuda.synchronize()
            self.peak = max(self.peak,
                            self.torch.cuda.max_memory_allocated() / 1e9)
        return self.peak

    def reset(self) -> None:
        self.fold()
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats()


def _free(torch, dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _run_numbers(rep, reqs, wall: float, launches: dict) -> dict:
    """A served run's numbers: ticks, tick ms, wall s, wall tok/s,
    attainment and launches by kernel."""
    n_tok = sum(len(r.prompt) + len(r.output) for r in reqs
                if r.finish >= 0)
    agg = rep.aggregate
    return dict(requests=agg.submitted, finished=agg.finished,
                shed=agg.shed, cancelled=agg.cancelled, ticks=rep.ticks,
                tick_ms=1e3 * wall / max(rep.ticks, 1), wall_s=wall,
                wall_tok_s=n_tok / wall,
                attainment={f"{float(k):g}": v
                            for k, v in agg.attainment.items()},
                launches=launches)


def _report_text(rep, drop=("wall_s",)) -> str:
    d = rep.to_json()
    for k in drop:
        d.pop(k)
    return json.dumps(d, sort_keys=True)


async def _cancel_after(fe, victim, n_tokens: int, views, stream):
    """Consume ``victim``'s ``stream`` and cancel it at its ``n_tokens``-th
    token; return (tokens seen, its view's used blocks just before and
    just after the cancel, the terminal exception's type name)."""
    from repro_torch.serving.frontend import StreamCancelled
    got, used = 0, None
    try:
        async for _ in stream:
            got += 1
            if got == n_tokens:
                view = views(victim.model)
                before = view.used
                if not fe.cancel(victim):
                    raise AssertionError("cancelling an in-flight "
                                         "request failed")
                used = (before, view.used)
    except StreamCancelled:
        return got, used, "StreamCancelled"
    raise AssertionError(f"request {victim.req_id}'s stream ended "
                         f"without StreamCancelled after {got} tokens")


def _serve_streams(fe, reqs, victim=None, views=None):
    """Stream every request through ``fe`` (cancelling ``victim`` at its
    second token) and run the loop; returns the report, each request's
    collected tokens or terminal exception, and the cancel's record."""
    import asyncio

    async def main():
        # every stream is registered before the loop's first tick
        jobs = [(_cancel_after(fe, r, 2, views, fe.stream(r)) if r is victim
                 else fe.stream(r).collect()) for r in reqs]
        serve = asyncio.ensure_future(fe.serve())
        outs = await asyncio.gather(*jobs, return_exceptions=True)
        return await serve, outs

    rep, outs = asyncio.run(main())
    by_id = {r.req_id: o for r, o in zip(reqs, outs)}
    cancel = by_id.pop(victim.req_id) if victim is not None else None
    for o in by_id.values():
        if isinstance(o, Exception) and not hasattr(o, "reason"):
            raise o
    if isinstance(cancel, Exception):
        raise cancel
    return rep, by_id, cancel


def serve_streaming(torch, device="cuda", reduced=False) -> dict:
    """The streaming front end at full width: two units of unequal mesh
    size (4 devices and 1 in the tick-cost model), each hosting one
    replica of qwen2-7b (``llm0``) and mamba2-2.7b (``llm1``), full
    depth, random bf16 weights, 4 slots, 64-token chunks, ADBS, the
    logical clock.  (a) ``serve_requests`` serves an explicit-replica
    trace; (b) ``ServingFrontend`` streams the same trace on fresh units
    of the same seeds — every stream must equal (a)'s ``Request.output``
    and the reports must be equal apart from ``wall_s``; (c) a
    family-named trace streams through ``least_loaded`` routing with
    ``ServingMetrics``, one llm0 stream cancelled at its second token
    (its view's blocks must drop at once, the stream must end in
    ``StreamCancelled``) and the metrics' counters, TTFT histogram and
    router decisions must agree with the report.  Kernels 1, 2 and 4
    must launch.  ``reduced`` rehearses the phase on the CPU."""
    from repro_torch.core.workload import synthesize
    from repro_torch.kernels import ops
    from repro_torch.serving import driver
    from repro_torch.serving.frontend import ServingFrontend
    from repro_torch.serving.metrics import ServingMetrics

    dev = torch.device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    cost = driver.TickCostModel()
    families = list(STREAM_FAMILIES)
    wl = synthesize(families, alpha=2.1, max_rate=8.0, horizon=1.3, seed=9,
                    mean_prompt=256, mean_output=40, max_len=512)
    mem = _Memory(torch, dev)

    def build():
        units = []
        for mesh_id, devices in ((0, 4), (1, 1)):
            u = driver.build_unit_from_specs(
                [(f"{fam}@{mesh_id}", arch, wl.rates[fam])
                 for fam, arch in STREAM_FAMILIES.items()],
                pool_blocks=16384 if reduced else 196608, max_slots=4,
                chunk_tokens=64, seed=20,
                policy="adbs", fused=True, reduced=reduced, dtype=dtype,
                device=dev)
            u.mesh_id, u.n_devices = mesh_id, devices
            units.append(u)
        reqs = driver.requests_from_workload(
            wl, {f: units[0].engines[f"{f}@0"] for f in families}, seed=1,
            max_new_cap=64)
        return units, reqs

    def explicit(reqs):
        for r in reqs:
            r.model = f"{r.model}@{r.req_id % 2}"
        return reqs

    def served(units, reqs, t0):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if any(u.pool.allocator.used for u in units):
            raise AssertionError("a pool was not freed")
        return wall

    ops.reset_launch_counts()
    runs = {}
    # (a) the closed loop over explicit replicas
    units, reqs = build()
    explicit(reqs)
    t0 = time.perf_counter()
    rep_a = driver.serve_requests(units, reqs, slo_scales=STREAM_SCALES,
                                  cost=cost)
    runs["closed_loop"] = _run_numbers(rep_a, reqs, served(units, reqs, t0),
                                       ops.launch_counts())
    closed = {r.req_id: list(r.output) for r in reqs}
    if rep_a.aggregate.finished != rep_a.aggregate.submitted:
        raise AssertionError(f"closed loop served "
                             f"{rep_a.aggregate.finished}/"
                             f"{rep_a.aggregate.submitted}")
    del units, reqs
    _free(torch, dev)
    # (b) the same trace streamed, fresh units of the same seeds
    units, reqs = build()
    explicit(reqs)
    before = ops.launch_counts()
    t0 = time.perf_counter()
    rep_b, outs, _ = _serve_streams(ServingFrontend(
        units, reqs, slo_scales=STREAM_SCALES, cost=cost), reqs)
    runs["streamed"] = _run_numbers(rep_b, reqs, served(units, reqs, t0), {
        k: v - before[k] for k, v in ops.launch_counts().items()})
    differ = [r.req_id for r in reqs
              if outs[r.req_id] != closed[r.req_id] or r.output
              != closed[r.req_id]]
    if differ:
        raise AssertionError(f"streams of requests {differ} differ from "
                             f"the closed loop's outputs")
    if _report_text(rep_b) != _report_text(rep_a):
        raise AssertionError("the streamed run's report differs from the "
                             "closed loop's (wall_s apart)")
    del units, reqs
    _free(torch, dev)
    # (c) family-named requests, least_loaded routing, metrics, a cancel
    units, reqs = build()
    metrics = ServingMetrics()
    fe = ServingFrontend(units, reqs, strategy="least_loaded",
                         metrics=metrics, planned_rates=dict(wl.rates),
                         slo_scales=STREAM_SCALES, cost=cost)
    victim = max((r for r in reqs if r.model == "llm0"),
                 key=lambda r: (r.max_new_tokens, -r.req_id))
    before = ops.launch_counts()
    t0 = time.perf_counter()
    rep_c, outs, (n_seen, used, end) = _serve_streams(
        fe, reqs, victim, lambda name: fe.router.unit_for(name).pool
        .views[name])
    runs["least_loaded"] = _run_numbers(
        rep_c, reqs, served(units, reqs, t0),
        {k: v - before[k] for k, v in ops.launch_counts().items()})
    launches = ops.launch_counts()
    agg = rep_c.aggregate
    if not (victim.cancelled and used[1] < used[0]):
        raise AssertionError(f"cancel did not free the victim's blocks at "
                             f"once: view used {used}")
    if agg.cancelled != 1 or agg.submitted != (agg.finished + agg.shed
                                               + agg.cancelled):
        raise AssertionError(f"dispositions: {agg.to_json()}")
    bad = [i for i, o in outs.items() if not isinstance(o, list)]
    if bad:
        raise AssertionError(f"streams {bad} ended without finishing")
    fams = {f["name"]: f for f in metrics.snapshot()["families"]}

    def total(name, key="value"):
        return sum(s[key] for s in fams[name]["series"])

    per_llm = {n: r.finished for n, r in rep_c.per_llm.items()
               if r.finished}
    ttft = {s["labels"]["llm"]: s["count"]
            for s in fams["mux_ttft_seconds"]["series"]}
    decisions = {s["labels"]["llm"]: s["value"]
                 for s in fams["mux_router_decisions_total"]["series"]}
    routed = {}
    for r in reqs:
        routed[r.model] = routed.get(r.model, 0) + 1
    checks = {
        "submitted": (total("mux_requests_submitted_total"),
                      agg.submitted),
        "finished": (total("mux_requests_finished_total"), agg.finished),
        "cancelled": (total("mux_requests_cancelled_total"),
                      agg.cancelled),
        "ttft_count_by_llm": (ttft, per_llm),
        "router_decisions_by_llm": (decisions, routed)}
    wrong = {k: v for k, v in checks.items() if v[0] != v[1]}
    if wrong:
        raise AssertionError(f"metrics disagree with the report: {wrong}")
    for symbol in ("repro_paged_decode", "repro_paged_prefill",
                   "repro_ssd_scan"):
        if launches[symbol] <= 0:
            raise AssertionError(f"{symbol} never launched in this phase")
    res = dict(models=STREAM_FAMILIES, meshes={"unit 0": 4, "unit 1": 1},
               runs=runs, phase_peak_gb=mem.fold() - mem.held,
               held_before_gb=mem.held, launches=launches,
               cancel={"req_id": victim.req_id, "routed_to": victim.model,
                       "tokens_before_cancel": n_seen,
                       "view_used_before_after": list(used),
                       "stream_end": end},
               routed=routed, metrics_checked=sorted(checks),
               summary=rep_c.summary())
    del units, reqs, fe, metrics
    _free(torch, dev)
    return res


CHAOS_NAMES = ["llm0", "llm1"]


def serve_chaos(torch, device="cuda", reduced=False) -> dict:
    """Graceful degradation at full width: one fused ADBS unit of two
    qwen2-7b (``llm0``, ``llm1``; random bf16 weights, 4 slots, 64-token
    chunks, the logical clock), armed with ``max_queue`` 8 an LLM and
    deadline shedding.  Parity first: the armed unit with an empty fault
    plan must give the plain unit's tokens and report (apart from
    ``wall_s`` and the armed run's empty fault section) on the card,
    shedding nothing.  Then a burst at twice that arrival rate streams
    through ``ServingFrontend`` with the sanitizer on every tick and the
    plan ``transient:llm0:2`` / ``crash:llm1`` / ``block_loss:llm0:<a
    quarter of the group's grant>`` at 20, 40 and 60 % of the horizon,
    one stream cancelled: the run must terminate with ``submitted =
    finished + shed + cancelled``, every shed stream ending in
    ``StreamShed``, the arena shrunk by exactly the lost blocks, the
    pool free, and kernels 1 and 2 launched after the recovery.  The
    recovery's own peak is measured around ``recover_engine``."""
    from repro_torch.core.workload import synthesize
    from repro_torch.kernels import ops
    from repro_torch.serving import driver
    from repro_torch.serving.faults import FaultPlan
    from repro_torch.serving.frontend import ServingFrontend, StreamShed

    dev = torch.device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    cost = driver.TickCostModel()
    # the rate at which the armed unit sheds nothing (~11 requests); the
    # burst doubles it
    horizon, rate = 1.6, 6.0
    trace = dict(alpha=2.1, horizon=horizon, seed=13, mean_prompt=256,
                 mean_output=40, max_len=512)
    wl = synthesize(CHAOS_NAMES, max_rate=rate, **trace)
    mem = _Memory(torch, dev)

    def build(armed, w):
        return driver.build_unit_from_specs(
            [(n, "qwen2-7b", w.rates[n]) for n in CHAOS_NAMES],
            pool_blocks=16384, max_slots=4, chunk_tokens=64, seed=30,
            policy="adbs", fused=True, reduced=reduced, dtype=dtype,
            device=dev, max_queue=(8 if armed else None),
            shed_policy=("deadline" if armed else "none"))

    def finish(t0):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    ops.reset_launch_counts()
    runs, parity = {}, {}
    for armed in (False, True):
        unit = build(armed, wl)
        reqs = driver.requests_from_workload(wl, unit.engines, seed=1,
                                             max_new_cap=64)
        before = ops.launch_counts()
        t0 = time.perf_counter()
        rep = driver.serve_requests(
            [unit], reqs, cost=cost,
            faults=(FaultPlan([]) if armed else None))
        key = "armed, empty plan" if armed else "plain"
        runs[key] = _run_numbers(rep, reqs, finish(t0), {
            k: v - before[k] for k, v in ops.launch_counts().items()})
        if unit.pool.allocator.used:
            raise AssertionError("the pool was not freed")
        parity[armed] = ({r.req_id: list(r.output) for r in reqs},
                         _report_text(rep, ("wall_s", "faults")), rep)
        del unit, reqs, rep
        _free(torch, dev)
    plain, armed = parity[False], parity[True]
    fs0 = armed[2].faults
    if plain[0] != armed[0] or plain[1] != armed[1]:
        raise AssertionError("the armed unit with an empty plan differs "
                             "from the plain unit (tokens or report)")
    if fs0 is None or fs0.injected or fs0.log or armed[2].aggregate.shed:
        raise AssertionError(f"the empty plan did something: "
                             f"{fs0 and fs0.to_json()}")
    if plain[2].aggregate.finished != plain[2].aggregate.submitted:
        raise AssertionError("the plain unit did not finish its trace")
    del parity, plain, armed

    # the burst: twice the rate, the plan fixed up front
    burst = synthesize(CHAOS_NAMES, max_rate=2 * rate, **trace)
    unit = build(True, burst)
    reqs = driver.requests_from_workload(burst, unit.engines, seed=1,
                                         max_new_cap=64)
    grant = unit.fused_groups[0].granted_blocks
    lost = grant // 4
    n0 = unit.pool.n_head_blocks
    plan = FaultPlan.parse(f"transient:llm0:2@{0.2 * horizon},"
                           f"crash:llm1@{0.4 * horizon},"
                           f"block_loss:llm0:{lost}@{0.6 * horizon}")
    fe = ServingFrontend([unit], reqs, cost=cost, faults=plan, sanitize=True)
    recoveries, check_s = [], []
    recover = unit.recover_engine

    def measured_recover(name, reason="crash"):
        held = mem.now()
        mem.reset()
        t = time.perf_counter()
        rec = recover(name, reason=reason)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        recoveries.append(dict(
            target=name, reason=reason, s=time.perf_counter() - t,
            held_gb=held, peak_gb=(torch.cuda.max_memory_allocated() / 1e9
                                   if dev.type == "cuda" else 0.0),
            after_gb=mem.now(), launches_at=ops.launch_counts()))
        return rec
    unit.recover_engine = measured_recover
    check = fe.session.sanitizer.check

    def timed_check(where=""):
        t = time.perf_counter()
        check(where)
        check_s.append(time.perf_counter() - t)
    fe.session.sanitizer.check = timed_check
    victim = max((r for r in reqs if r.model == "llm0"),
                 key=lambda r: (r.max_new_tokens, -r.req_id))
    before = ops.launch_counts()
    t0 = time.perf_counter()
    rep, outs, (n_seen, used, end) = _serve_streams(
        fe, reqs, victim, lambda name: unit.pool.views[name])
    runs["burst with faults"] = _run_numbers(rep, reqs, finish(t0), {
        k: v - before[k] for k, v in ops.launch_counts().items()})
    launches = ops.launch_counts()
    agg, fs = rep.aggregate, rep.faults
    problems = []
    if agg.submitted != len(reqs) or agg.submitted != (
            agg.finished + agg.shed + agg.cancelled):
        problems.append(f"dispositions {agg.to_json()}")
    if agg.cancelled != 1 or not victim.cancelled or used[1] >= used[0]:
        problems.append(f"cancel: {agg.cancelled}, view used {used}")
    if agg.shed == 0:
        problems.append("a 2x burst over bounded queues shed nothing")
    for r in reqs:
        o = outs.get(r.req_id)
        if r.shed and not (isinstance(o, StreamShed)
                           and o.reason == r.shed_reason):
            problems.append(f"shed request {r.req_id} ended with {o!r}")
        if r.finish >= 0 and o != r.output:
            problems.append(f"request {r.req_id}'s stream != its output")
    if (fs.recoveries, fs.block_losses, fs.injected, fs.unfired) != (
            1, 1, 3, 0) or fs.blocks_lost != lost:
        problems.append(f"fault summary {fs.to_json()}")
    if unit.pool.n_head_blocks != n0 - lost \
            or unit.pool.k.shape[0] != n0 - lost:
        problems.append(f"arena {unit.pool.n_head_blocks} != {n0} - {lost}")
    if unit.pool.allocator.used or any(v.used for v in
                                       unit.pool.views.values()):
        problems.append("the pool is not free at the end")
    if len(check_s) != rep.ticks + 1:
        problems.append(f"{len(check_s)} sanitizer checks for "
                        f"{rep.ticks} ticks")
    if len(recoveries) != 1:
        problems.append(f"{len(recoveries)} recoveries")
    else:
        at = recoveries[0]["launches_at"]
        for symbol in ("repro_paged_decode", "repro_paged_prefill"):
            if launches[symbol] <= at[symbol]:
                problems.append(f"{symbol} did not launch after the "
                                f"recovery")
    if problems:
        raise AssertionError("chaos phase: " + "; ".join(problems))
    fsj = fs.to_json()
    res = dict(models=["qwen2-7b", "qwen2-7b"], fused_groups=1,
               pool_blocks={"base": 16384, "grant": grant,
                            "before": n0, "after": unit.pool.n_head_blocks,
                            "lost": lost},
               plan=plan.to_json(), runs=runs,
               phase_peak_gb=mem.fold() - mem.held, held_before_gb=mem.held,
               launches=launches,
               recovery={k: v for k, v in recoveries[0].items()
                         if k != "launches_at"},
               sanitizer={"checks": len(check_s),
                          "host_ms_mean": 1e3 * sum(check_s) / len(check_s),
                          "host_ms_max": 1e3 * max(check_s)},
               cancel={"req_id": victim.req_id,
                       "tokens_before_cancel": n_seen,
                       "view_used_before_after": list(used),
                       "stream_end": end},
               shed_reasons=dict(agg.shed_reasons),
               faults={k: v for k, v in fsj.items() if k != "log"},
               fault_log=fsj["log"], summary=rep.summary())
    del unit, reqs, fe, rep
    _free(torch, dev)
    return res


def print_degradation(stream: dict, chaos: dict) -> None:
    """Print the streaming and chaos phases' results."""
    for label, res in (("streaming phase", stream), ("chaos phase", chaos)):
        print(f"{label}: " + json.dumps(
            {k: v for k, v in res.items()
             if k not in ("runs", "summary", "fault_log")}))
        for name, run in res["runs"].items():
            print(f"  {label}, {name}: " + json.dumps(run))
        for line in res["summary"].splitlines():
            print(f"  {line}")
    print("streaming phase: attainment closed loop "
          + json.dumps(stream["runs"]["closed_loop"]["attainment"])
          + ", streamed " + json.dumps(stream["runs"]["streamed"]["attainment"])
          + ", least_loaded " + json.dumps(
              stream["runs"]["least_loaded"]["attainment"]))
    rec = chaos["recovery"]
    print(f"chaos phase: FaultSummary {json.dumps(chaos['faults'])}; "
          f"fault log {json.dumps(chaos['fault_log'])}")
    print(f"chaos phase: recovery of {rec['target']} took {rec['s']:.3f} s, "
          f"peak {rec['peak_gb']:.2f} GB over {rec['held_gb']:.2f} GB held "
          f"before it ({rec['after_gb']:.2f} after); sanitizer "
          f"{chaos['sanitizer']['checks']} checks, "
          f"{chaos['sanitizer']['host_ms_mean']:.2f} ms host each "
          f"(max {chaos['sanitizer']['host_ms_max']:.2f})")


PLACED = ["qwen2-7b#0", "qwen2-7b#1", "mamba2-2.7b"]


def serve_placement(torch, seed: int = 1) -> dict:
    """The paper's pipeline on the card: Alg. 1 plans the three
    full-width LLMs of ``PLACED`` (power-law rates, α 1, max 8 req/s)
    for one H100, the plan goes through its JSON file and back, the
    placement → runtime bridge builds its unit with the plan's shares
    enforced, and ~16 requests of the plan's rates are served under the
    logical clock; then the simulator predicts the same plan on the same
    trace.  Every request must finish, the pool must be freed, the
    report must carry the plan's shares and kernels 1, 2 and 4 must have
    launched.  Returns the run's numbers, the served and simulated
    results side by side (printed, not compared: the cost model's
    efficiencies are assumptions, not measurements)."""
    import dataclasses
    import tempfile
    from repro_torch import configs
    from repro_torch.config import replace
    from repro_torch.core.costmodel import H100
    from repro_torch.core.placement import (load_placement, place,
                                            placement_to_json,
                                            save_placement)
    from repro_torch.core.simulator import simulate
    from repro_torch.core.workload import (Workload, poisson_trace,
                                           power_law_rates)
    from repro_torch.kernels import ops
    from repro_torch.serving import driver

    rates = power_law_rates(PLACED, alpha=1.0, max_rate=8.0)
    models = [(replace(configs.get(n.split("#")[0]), name=n), rates[n])
              for n in PLACED]
    t0 = time.perf_counter()
    pl = place(models, n_devices=1, hw=H100, mean_prompt=256, mean_output=40)
    place_s = time.perf_counter() - t0
    want = placement_to_json(pl)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "plan.json")
        save_placement(pl, path)
        pl = load_placement(path, configs.get)
    if placement_to_json(pl) != want:
        raise AssertionError("the plan changed through its JSON file")
    meshes = [m for m in pl.meshes if m.specs]
    specs = [s for m in meshes for s in m.specs]
    if (len(meshes) != 1 or sorted(s.name for s in specs) != sorted(PLACED)
            or any(s.tp != 1 or not 0.0 < s.sm_frac <= 1.0
                   for s in specs)):
        raise AssertionError(f"unexpected plan:\n{pl.describe()}")
    shares = {s.name: s.sm_frac for s in specs}

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    units = driver.units_from_placement(
        pl, pool_blocks=196608, max_slots=4, chunk_tokens=64, fused=True,
        reduced=False, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    (unit,) = units
    if not unit.enforce_shares or unit.sm_frac != shares:
        raise AssertionError(f"unit shares {unit.sm_frac} != plan {shares}")
    wl = poisson_trace({s.name: s.rate for s in specs}, horizon=1.1,
                       seed=seed, mean_prompt=256, mean_output=40,
                       max_len=512)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = driver.serve_workload(units, wl, seed=seed, max_new_cap=64,
                                cost=driver.TickCostModel())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    agg = rep.aggregate
    if agg.finished != agg.submitted or agg.submitted == 0:
        raise AssertionError(f"served {agg.finished}/{agg.submitted}")
    if unit.pool.allocator.used != 0:
        raise AssertionError(f"pool not freed: {unit.pool.allocator.used}")
    for symbol in ("repro_paged_decode", "repro_paged_prefill",
                   "repro_ssd_scan"):
        if launches[symbol] <= 0:
            raise AssertionError(f"{symbol} never launched in this run")
    if rep.sm_frac != shares:
        raise AssertionError(f"report shares {rep.sm_frac} != {shares}")
    fin = unit.stats.finished
    n_prompt = sum(len(r.prompt) for r in fin)
    n_out = sum(len(r.output) for r in fin)
    # the simulator replays the trace as it was served: outputs capped
    # at the served cap
    served = Workload(rates=dict(wl.rates), horizon=wl.horizon, requests=[
        dataclasses.replace(r, output_len=min(r.output_len, 64))
        for r in wl.requests])
    t0 = time.perf_counter()
    sim = simulate(pl, served, mode="spatial-temporal", policy="adbs",
                   hw=H100)
    sim_s = time.perf_counter() - t0
    res = dict(
        plan=placement_to_json(pl), place_s=place_s, simulate_s=sim_s,
        requests_per_model={n: sum(r.model == n for r in fin)
                            for n in PLACED},
        requests=agg.submitted, ticks=rep.ticks, prompt_tokens=n_prompt,
        output_tokens=n_out, build_s=build_s, wall_s=wall,
        wall_tok_s=(n_prompt + n_out) / wall, wall_out_tok_s=n_out / wall,
        fused_groups=len(unit.fused_groups),
        pool_head_blocks=unit.pool.n_head_blocks,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=launches,
        served={"attainment": {f"{float(k):g}": v for k, v in
                               agg.attainment.items()},
                "logical_s": rep.horizon,
                "throughput_req_s": agg.throughput,
                "e2e_p99_s": agg.e2e.p99},
        simulated={"attainment": {f"{float(k):g}": v for k, v in
                                  sim.slo_attainment.items()},
                   "throughput_req_s": sim.throughput,
                   "p99_latency_s": sim.p99_latency,
                   "finished": sim.finished},
        describe=pl.describe(), summary=rep.summary(),
        sim_summary=sim.summary())
    del units, unit, rep
    gc.collect()
    torch.cuda.empty_cache()
    return res


def print_placement(placed: dict) -> None:
    """Print the placement phase's plan, served run and the simulator's
    prediction beside it."""
    print("placement plan (Alg. 1, H100 constants, one device; place took "
          f"{placed['place_s']:.3f} s on the host):")
    print(placed["describe"])
    print("placement serve: " + json.dumps(
        {k: v for k, v in placed.items()
         if k not in ("describe", "summary", "sim_summary")}))
    for line in placed["summary"].splitlines():
        print(f"  {line}")
    print(f"  simulated (spatial-temporal, adbs, H100): "
          f"{placed['sim_summary']}")
    sv, sm = placed["served"], placed["simulated"]
    print("served vs simulated, same plan and trace (printed, not "
          "compared): attainment "
          + ", ".join(f"{k}x {sv['attainment'][k]:.2f} vs "
                      f"{sm['attainment'][k]:.2f}" for k in sv["attainment"])
          + f"; throughput {sv['throughput_req_s']:.2f} vs "
          f"{sm['throughput_req_s']:.2f} req/s (served in logical s); "
          f"p99 latency {sv['e2e_p99_s']:.3f} vs "
          f"{sm['p99_latency_s']:.3f} s; served wall "
          f"{placed['wall_s']:.1f} s ("
          f"{placed['requests'] / placed['wall_s']:.2f} req/s, "
          f"{placed['wall_tok_s']:.0f} tok/s), peak "
          f"{placed['max_memory_allocated_gb']:.1f} GB")


def cli_placement(torch) -> str:
    """The serve CLI's placement flags on the card, at reduced width:
    ``--save-placement`` plans ``PLACED`` on two devices (two meshes)
    and serves the plan, then ``--placement`` serves the saved plan on
    the card and on the CPU; the two reports must agree on submitted,
    finished, ticks and attainment (the logical clock depends on
    lengths only; the devices draw different random weights)."""
    import contextlib
    import io
    import tempfile
    from repro_torch.launch import serve

    def run(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = serve.main(argv)
        if rc != 0:
            raise AssertionError(f"serve {argv} exited {rc}")
        return out.getvalue()

    common = ["--fused", "--chunk-tokens", "16", "--deterministic",
              "--pool-blocks", "16000", "--max-new", "8"]
    with tempfile.TemporaryDirectory() as tmp:
        plan = os.path.join(tmp, "plan.json")
        log = run(["--save-placement", plan, "--devices", "2", "--archs",
                   ",".join(a.split("#")[0] for a in PLACED), "--alpha",
                   "1", "--rate", "8", "--mean-prompt", "256",
                   "--mean-output", "40", "--horizon", "0.5", *common])
        with open(plan) as f:
            n_meshes = sum(1 for m in json.load(f)["meshes"] if m["specs"])
        if n_meshes != 2:
            raise AssertionError(f"CLI plan has {n_meshes} meshes, not 2")
        reports = {}
        for dev in ("cuda", "cpu"):
            path = os.path.join(tmp, f"{dev}.json")
            log += run(["--placement", plan, "--device", dev, "--horizon",
                        "1", "--report", path, *common])
            with open(path) as f:
                reports[dev] = json.load(f)
    keys = [(r["aggregate"]["submitted"], r["aggregate"]["finished"],
             r["ticks"], r["aggregate"]["attainment"])
            for r in (reports["cuda"], reports["cpu"])]
    if keys[0] != keys[1]:
        raise AssertionError(f"CLI plan: card and CPU reports differ {keys}")
    agg = reports["cuda"]["aggregate"]
    if agg["finished"] != agg["submitted"] or not agg["submitted"]:
        raise AssertionError(f"CLI plan served {agg['finished']}/"
                             f"{agg['submitted']}")
    lines = [ln for ln in log.splitlines()
             if ln.startswith(("[serve] optimized", "  mesh[",
                               "[serve] unit mesh", "[serve] finished"))]
    return "\n".join(["CLI placement round trip (reduced, two meshes):"]
                     + [f"  {ln}" for ln in lines]
                     + [f"  card and CPU reports agree: {agg['submitted']} "
                        f"submitted and finished, "
                        f"{reports['cuda']['ticks']} ticks, attainment "
                        f"{agg['attainment']}"])


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(src/repro_torch not found beside it)", file=sys.stderr)
        return 2
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this smoke run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build, ops

    card = card_line()
    print(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    took = build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f}s "
          f"(per source: {json.dumps({k: round(v, 1) for k, v in took.items()})})")
    print("tensor cores (HGMMA and HMMA instructions in cuobjdump -sass): "
          + json.dumps(tensor_core_sass()))

    full, zamba, small = (attn_shape(torch, s) for s in (FULL, ZAMBA, SMALL))
    wide = [attn_shape(torch, s) for s in WIDE]
    checks = {s["label"]: check_kernels(torch, np, s)
              for s in [full, zamba, small] + wide}
    for label, res in checks.items():
        for name, r in res.items():
            print(f"check [{label}] {name}: " + json.dumps(r))
    # what the compiled decode kernels get on this card: CTAs an SM,
    # shared memory, registers (the bf16 body at each head dim, with one
    # and two 8-head halves of its m16 tile)
    from repro_torch.kernels import decode_splits
    occ = {f"{src} bf16 hd {hd} group {g}": decode_splits.occupancy(
               src, hd, torch.bfloat16, g)
           for src in ("paged_decode.cu", "paged_decode_int8.cu")
           for hd in (64, 96, 128) for g in (8, 16)}
    print("decode occupancy: " + json.dumps(occ))

    ssd_shapes = [
        dict(label="mamba2-2.7b chunk step bf16", dtype=torch.bfloat16, b=4,
             S=64, chunk=64, H=80, G=1, N=128, init=True),
        dict(label="mamba2-2.7b chunk step bf16, two slots",
             dtype=torch.bfloat16, b=2, S=64, chunk=64, H=80, G=1, N=128,
             init=True),
        dict(label="mamba2-2.7b chunk step bf16, one slot",
             dtype=torch.bfloat16, b=1, S=64, chunk=64, H=80, G=1, N=128,
             init=True),
        dict(label="zamba2-1.2b whole-prompt bucket bf16",
             dtype=torch.bfloat16, b=2, S=512, chunk=256, H=64, G=1, N=64,
             init=False),
        dict(label="zamba2-1.2b whole-prompt bucket bf16, one row",
             dtype=torch.bfloat16, b=1, S=512, chunk=256, H=64, G=1, N=64,
             init=False),
        dict(label="reduced f32, 2 groups, ragged chunk", dtype=torch.float32,
             b=2, S=72, chunk=32, H=8, G=2, N=16, init=True),
    ]
    ssd = {s["label"]: check_ssd(torch, s) for s in ssd_shapes}
    for label, r in ssd.items():
        print(f"check [{label}] ssd_scan: " + json.dumps(r))
    int8 = {s["label"]: check_int8(torch, np, s)
            for s in [full, small] + wide}
    for label, res in int8.items():
        for name, r in res.items():
            print(f"check [{label}] int8 decode, {name}: " + json.dumps(r))

    print(reduced_steps_match(torch, np))
    print(reduced_ssm_steps_match(torch, np))
    print(reduced_w8kv8_match(torch, np))

    qwen = "qwen2-7b"
    phases = [
        ("fused chunked serve", dict(
            archs=[qwen, qwen], chunk_tokens=64, n_target=16, seed=0,
            must_launch=("repro_paged_decode", "repro_paged_prefill"))),
        ("whole-prompt serve", dict(
            archs=[qwen], chunk_tokens=0, n_target=8, seed=1,
            must_launch=("repro_paged_decode", "repro_flash_prefill"))),
        # the JAX CLI's default pair; α 1 gives mamba2 a third of the
        # traffic, and the pool's quota arithmetic (mamba2's state is
        # 20,480 head-block units a sequence) admits several at once
        ("serve A: qwen2-7b + mamba2-2.7b, chunked", dict(
            archs=[qwen, "mamba2-2.7b"], chunk_tokens=64, n_target=12,
            seed=2, alpha=1.0, pool_blocks=196608,
            must_launch=("repro_ssd_scan", "repro_paged_prefill",
                         "repro_paged_decode"))),
        ("serve B: zamba2-1.2b, whole-prompt", dict(
            archs=["zamba2-1.2b"], chunk_tokens=0, n_target=12, seed=3,
            pool_blocks=131072,
            must_launch=("repro_ssd_scan", "repro_flash_prefill",
                         "repro_paged_decode"))),
        # the MoE family: granite-moe (24/8 heads of 64, 32 experts
        # top-8) beside musicgen-medium (audio, MHA 24 heads of 64), full
        # depth; different architectures, so the ticks are serial
        ("MoE A: granite-moe-3b-a800m + musicgen-medium, chunked", dict(
            archs=["granite-moe-3b-a800m", "musicgen-medium"],
            chunk_tokens=64, n_target=16, seed=4, alpha=1.0,
            pool_blocks=524288,
            must_launch=("repro_paged_decode", "repro_paged_prefill"))),
        # qwen3-moe at full width, 4 of 94 layers: 128 experts of 4096 x
        # 1536 a layer, group 16 at head_dim 128
        ("MoE B: qwen3-moe-235b-a22b (4 of 94 layers), chunked", dict(
            archs=["qwen3-moe-235b-a22b"], chunk_tokens=64, n_target=8,
            seed=5, pool_blocks=65536, depth={"qwen3-moe-235b-a22b": 4},
            must_launch=("repro_paged_decode", "repro_paged_prefill"))),
        # head_dim 96: two phi-3-vision-4.2b fused (chunked), then one
        # with whole-prompt prefill
        ("hd 96: phi-3-vision-4.2b x2, fused chunked", dict(
            archs=["phi-3-vision-4.2b", "phi-3-vision-4.2b"],
            chunk_tokens=64, n_target=16, seed=6, pool_blocks=524288,
            must_launch=("repro_paged_decode", "repro_paged_prefill"))),
        ("hd 96: phi-3-vision-4.2b, whole-prompt", dict(
            archs=["phi-3-vision-4.2b"], chunk_tokens=0, n_target=8, seed=7,
            pool_blocks=262144,
            must_launch=("repro_paged_decode", "repro_flash_prefill"))),
        # group 12 (command-r-plus-104b, 4 of 64 layers, tied 256k vocab)
        # beside group 7 (deepseek-coder-33b, 16 of 62 layers)
        ("big dense pair: command-r-plus-104b (4/64) + deepseek-coder-33b "
         "(16/62), whole-prompt", dict(
            archs=["command-r-plus-104b", "deepseek-coder-33b"],
            chunk_tokens=0, n_target=8, seed=8, pool_blocks=65536,
            depth={"command-r-plus-104b": 4, "deepseek-coder-33b": 16},
            must_launch=("repro_paged_decode", "repro_flash_prefill"))),
    ]
    served = {}
    for label, kw in phases:
        res = served[label] = serve_full_width(torch, **kw)
        print(f"{label}: " + json.dumps(
            {k: v for k, v in res.items() if k != "summary"}))
        for line in res["summary"].splitlines():
            print(f"  {line}")
    # some whole prompts pad to a length the 256-token chunk does not
    # divide: those run through the scan's ragged last chunk
    ragged = [S for S in served["serve B: zamba2-1.2b, whole-prompt"][
        "ssm_prefill_lens"] if S > 256 and S % 256]
    if not ragged:
        raise AssertionError("serve B ran no ragged whole-prompt prefill")
    print(f"serve B prefilled ragged whole prompts of {ragged} tokens "
          f"(256-token chunks)")
    print("every served step had finite logits (engine.greedy_tokens "
          "raises otherwise); every request finished; pools freed")

    placed = serve_placement(torch)
    print_placement(placed)
    print(cli_placement(torch))

    w8 = w8kv8_full_width(torch, np)
    print("W8/KV8 decode, qwen2-7b full width: " + json.dumps(w8))
    fl = w8["greedy_flips"]
    print(f"W8/KV8 decode, all {w8['decode_steps']} steps: max rel logit "
          f"err vs bf16 {w8['max_rel_logit_err']:.4f} < 0.1; greedy tokens "
          f"equal to the W8 control's except on near-ties "
          f"({fl['w8kv8_vs_w8_control']['all']} flips of "
          f"{w8['rows'] * w8['decode_steps']}); against bf16 "
          f"{fl['w8kv8_vs_bf16']['all']} flips, "
          f"{fl['w8kv8_vs_bf16']['beyond_1pct_spread']} beyond 1 % of the "
          f"spread (the W8 control alone: {fl['w8_control_vs_bf16']['all']}"
          f", {fl['w8_control_vs_bf16']['beyond_1pct_spread']})")

    stream = serve_streaming(torch)
    chaos = serve_chaos(torch)
    print_degradation(stream, chaos)

    runs = list(served.values()) + [placed, w8, stream, chaos]
    launches = {k.symbol: sum(r["launches"][k.symbol] for r in runs)
                for k in ops.path_kernels()}
    attn_names = {"repro_paged_decode": ("fused_paged_decode_attention",
                                         "decode"),
                  "repro_paged_prefill": ("fused_paged_flash_prefill",
                                          "chunk"),
                  "repro_flash_prefill": ("flash_prefill", "flash")}
    rows = []
    for k in ops.path_kernels():
        base = {"route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{k.source}",
                "replaces": k.replaces, "launches": launches[k.symbol]}
        if k.symbol == "repro_ssd_scan":
            # earlier_ms is a constant, not this run's: the check lines
            # print it, the kernels line does not
            main_shape, *others = ssd_shapes
            measured = {label: {k: v for k, v in r.items()
                                if k != "earlier_ms"}
                        for label, r in ssd.items()}
            r = measured[main_shape["label"]]
            rows.append({
                "name": "ssd_scan", **base, **r, "kernel_ms": r["ms"],
                "shapes": main_shape["label"],
                "other_shapes": [{"shapes": o["label"],
                                  **measured[o["label"]]} for o in others]})
            continue
        if k.symbol == "repro_decode_int8":
            # the main path's shape (one dense cache layer of the W8/KV8
            # decode) first; kernel 1's paged shapes beside it
            r = int8[full["label"]]
            main_r = r["dense_w8kv8_step"]
            rows.append({
                "name": "paged_decode_attention_int8", **base,
                **{k: v for k, v in main_r.items() if k != "earlier_ms"},
                "kernel_ms": main_r["ms"],
                "shapes": full["label"] + ", dense cache layer of the "
                "W8/KV8 decode (S 544)",
                "long_context": r["dense_long"],
                "paged": r["paged"], "dense": r["dense"],
                "reduced": {"shapes": small["label"],
                            **int8[small["label"]]},
                "other_shapes": [{"shapes": w["label"], **int8[w["label"]]}
                                 for w in wide]})
            continue
        name, key = attn_names[k.symbol]
        r = checks[full["label"]][key]
        s = checks[small["label"]][key]
        rows.append({
            "name": name, **base,
            "max_abs_err": r["max_abs_err"], "tolerance": r["tolerance"],
            "ms": r["ms"], "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "tflops": r["tflops"],
            **{k: r[k] for k in ("host_us", "call_us", "profiler") if k in r},
            "shapes": full["label"],
            **({"long_context": checks[full["label"]]["decode_long"]}
               if key == "decode" else {}),
            "other_shapes": [{"shapes": o["label"], **checks[o["label"]][key]}
                             for o in [zamba] + wide],
            "reduced": {"shapes": small["label"], **s}})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
