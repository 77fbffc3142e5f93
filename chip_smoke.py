#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py

1. builds the five Hopper kernels (three attention kernels, the Mamba2
   SSD scan and the int8 decode attention of the W8/KV8 path) from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel),
   and counts the tensor-core instructions (from ``cuobjdump -sass``) of
   each prefill (``HGMMA``) and SSD (``HMMA``) kernel instantiation:
   every bf16 one must have some, the f32 ones (CUDA-core bodies) none;
2. holds each kernel against its plain PyTorch version at the serving
   path's shapes — full-width qwen2-7b (bf16, head_dim 128), zamba2-1.2b's
   shared attention (bf16, 32 heads of 64, group 1, a 272-token
   whole-prompt bucket) and the reduced CPU-test model (f32, head_dim
   64) for attention, the int8
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
   W8/KV8 prefill and decode of qwen2-7b), and that both devices serve a
   small qwen2 trace to the same report;
4. serves two colocated full-width qwen2-7b (random bf16 weights) with
   the fused chunked-prefill ADBS loop under the logical clock, then
   one with whole-prompt prefill; then the JAX CLI's default pair,
   full-width qwen2-7b + mamba2-2.7b (chunked, ADBS, serial: no
   fusable pair), and full-width zamba2-1.2b with whole-prompt prefill,
   counting kernel launches in each;
5. runs the W8/KV8 decode of full-width qwen2-7b: the weights quantized
   to int8 on the card, 8 prompts of 512 tokens prefilled, then 32
   decode steps with int8 weights and an int8 KV cache in lockstep with
   the bf16 decode and with a W8-only control (the int8 weights
   dequantized, bf16 cache), held at every step to the reference test's
   logit bound against bf16 and to its greedy rule against the control.

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
    in the two prefill libraries, HMMA (mma.sync) in the SSD scan's.
    Raises unless every bf16 instantiation (``tc_attention_kernel``,
    ``ssd_scan_tc_kernel``) has some and every float32 one (the
    CUDA-core bodies) has none."""
    counts = {}
    for src in ("flash_prefill.cu", "paged_prefill.cu"):
        counts.update(_sass_counts(src, "HGMMA"))
    tc = {k: v for k, v in counts.items() if "tc_attention_kernel" in k}
    f32 = {k: v for k, v in counts.items() if "prefill_kernel" in k}
    if len(tc) != 4 or min(tc.values()) == 0:
        raise AssertionError(f"bf16 prefill kernels without HGMMA: {tc}")
    if len(f32) != 4 or max(f32.values()) != 0:
        raise AssertionError(f"float32 prefill kernels with HGMMA: {f32}")
    ssd = _sass_counts("ssd_scan.cu", "HMMA")
    ssd_tc = {k: v for k, v in ssd.items() if "ssd_scan_tc_kernel" in k}
    ssd_f32 = {k: v for k, v in ssd.items() if "ssd_scan_kernel" in k}
    if len(ssd_tc) != 3 or min(ssd_tc.values()) == 0:
        raise AssertionError(f"bf16 SSD kernels without HMMA: {ssd_tc}")
    if len(ssd_f32) != 1 or max(ssd_f32.values()) != 0:
        raise AssertionError(f"float32 SSD kernel with HMMA: {ssd_f32}")
    return {"HGMMA": {"bf16": tc, "float32": f32},
            "HMMA": {"bf16": ssd_tc, "float32": ssd_f32}}


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
    qwen2-7b, f32 weights drawn on the CPU and quantized on each device,
    the same prompts, 3 decode steps fed the CPU run's greedy token.
    Tolerances: the f32 prefill 1e-3 (as the other reduced steps); the
    W8/KV8 step runs bf16 products, which cuBLAS and the CPU round at
    different places, so logits within 2e-2 of the CPU's largest
    |logit|, scales within 2e-2 relative, int8 cache entries at most 2
    steps apart (as between the two packages on the CPU,
    ``tests/test_torch_steps.py``: rounding, plus a step where the bf16
    K/V differ by about 1 % of the row's largest value), greedy tokens
    equal except on near-ties."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import tree_map
    from repro_torch.serving.quantize import quantize_params

    cfg = configs.get_reduced("qwen2-7b")
    params = init_params(cfg, torch.Generator().manual_seed(11),
                         torch.float32, "cpu")
    rng = np.random.default_rng(12)
    B, S, n = 4, 40, 3
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    lens = torch.tensor([40, 33, 17, 8], dtype=torch.int32)
    prefill = steps.make_prefill_step(cfg)
    decode = steps.make_decode_step_w8kv8(cfg)
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
            f"reduced W8/KV8 card vs CPU: prefill {worst_prefill}, logits "
            f"{worst_logit}, int8 {worst_int8}, scales {worst_scale}, greedy "
            f"{ties}, launches {got} (want {want})")
    return (f"reduced W8/KV8 card-vs-CPU: prefill max|Δ|={worst_prefill:.2e}, "
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


def serve_full_width(torch, archs, chunk_tokens: int, n_target: int,
                     seed: int, must_launch, alpha: float = 2.1,
                     pool_blocks: int = 16384) -> dict:
    """Serve the colocated full-width ``archs`` (random bf16 weights)
    under the logical clock; every request must finish, the pool must
    be freed and each kernel of ``must_launch`` must have launched in
    this run (every step's logits are checked finite by
    ``engine.greedy_tokens``, which raises otherwise).  Returns the
    run's numbers and launch counts."""
    from repro_torch.core.workload import synthesize
    from repro_torch.kernels import ops
    from repro_torch.serving import driver, engine

    names = [f"{a}#{i}" for i, a in enumerate(archs)]
    # ~n_target requests: power-law rates (α) over a 1.6 s window
    wl = synthesize(names, alpha=alpha, max_rate=n_target / 2.0,
                    horizon=1.6, seed=seed, mean_prompt=256, mean_output=40,
                    max_len=512)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    unit = driver.build_unit_from_specs(
        [(n, a, wl.rates[n]) for n, a in zip(names, archs)],
        pool_blocks=pool_blocks, max_slots=4, chunk_tokens=chunk_tokens,
        seed=seed, policy="adbs", fused=True, reduced=False,
        dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    buckets0 = set(engine._BUCKETS)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = driver.serve_workload([unit], wl, seed=seed, max_new_cap=64,
                                cost=driver.TickCostModel())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
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
               ssm_prefill_lens=ssm_prefill_lens,
               launches=launches, summary=rep.summary())
    del unit, rep
    gc.collect()
    torch.cuda.empty_cache()
    return res


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

    full = dict(label="qwen2-7b full width bf16", dtype=torch.bfloat16, H=28,
                KV=4, hd=128, layers=28, rows=8, max_blocks=64, C=64, S=512,
                flash_rows=4)
    # zamba2-1.2b's shared attention block (6 applications, 32 heads of
    # 64, group 1) at a whole-prompt bucket that is not a multiple of 64
    zamba = dict(label="zamba2-1.2b shared attention bf16",
                 dtype=torch.bfloat16, H=32, KV=32, hd=64, layers=6, rows=8,
                 max_blocks=64, C=64, S=272, flash_rows=2)
    small = dict(label="qwen2-7b reduced f32", dtype=torch.float32, H=4,
                 KV=2, hd=64, layers=2, rows=8, max_blocks=64, C=16, S=64,
                 flash_rows=4)
    checks = {s["label"]: check_kernels(torch, np, s)
              for s in (full, zamba, small)}
    for label, res in checks.items():
        for name, r in res.items():
            print(f"check [{label}] {name}: " + json.dumps(r))

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
    int8 = {s["label"]: check_int8(torch, np, s) for s in (full, small)}
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

    runs = list(served.values()) + [w8]
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
                            **int8[small["label"]]}})
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
            "other_shapes": [{"shapes": zamba["label"],
                              **checks[zamba["label"]][key]}],
            "reduced": {"shapes": small["label"], **s}})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
