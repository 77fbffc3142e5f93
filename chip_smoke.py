#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py

1. builds the six Hopper kernels (three attention kernels, the Mamba2
   SSD scan, the int8 decode attention of the W8/KV8 path and the
   grouped-expert SwiGLU of the dropless MoE FFN) from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel),
   and counts the tensor-core instructions (from ``cuobjdump -sass``) of
   each prefill (``HGMMA``), decode, SSD and MoE (``HMMA``) kernel
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
   kernels' CTAs an SM, shared memory and registers printed; one chunk
   row starts 16 tokens past a chunk boundary, as after an adopted
   prefix), the int8
   decode through both of its addressings (paged pool and dense cache
   layer); the mamba2-2.7b chunk step with 4, 2 and 1 slots, a
   zamba2-1.2b whole-prompt bucket of 2 rows and of 1, and a reduced
   ragged f32 case for the SSD scan; granite-moe-3b-a800m's and
   qwen3-moe-235b-a22b's experts at a 4-row decode, a 64-token chunk
   and the serving phases' largest buckets (granite-moe 4 × 64 chunk,
   qwen3-moe 4 × 512 whole prompts; bf16), the reduced experts at the same token counts (f32), and
   every slot on one expert and a single token at both dtypes for the
   grouped-expert SwiGLU (kernel 6, beside ``torch._grouped_mm`` as its
   yardstick) — and times the
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
   each phase.  Every step of every family runs as a CUDA graph, one
   per shape bucket (``serving/graphs.py``); the graphs phase
   (``serve_graphs``) serves the fused qwen2-7b pair's trace eagerly
   (``disable_graphs``) and with graphs, then both again with the arena
   grown past its buffer under live sequences: equal reports, tokens
   and launch counts, the first fused decodes' logits within bf16's
   tolerance, each graph on the old arena dropped and recaptured once;
   it prints the captures, their seconds, the graph pool's bytes, peak
   memory and per-tick wall ms and host µs in each mode; the graph
   steps phase (``serve_graph_steps``) serves the whole-prompt qwen2-7b
   trace, serve A's, serve B's, one mamba2-2.7b prefilling whole
   prompts, MoE A's (granite-moe cut to 8 of 32 layers) and qwen3-moe
   (4 of 94 layers) prefilling whole prompts, each twice on one unit,
   with graphs and eagerly: equal reports, tokens and launch counts,
   the whole-prompt ``prefill``, ``prefill_ssm``, ``chunk_ssm`` and
   ``decode_ssm`` and the MoE engines' ``chunk``, ``decode`` and
   ``prefill`` captured and replayed (kernels 1, 2, 3, 4 and 6 launched
   by replays), their first call's and first replay's logits within
   bf16's tolerance, each MoE kind's first sight run under
   ``torch.cuda.set_sync_debug_mode("error")``, and a capture that
   fails raising out of the step; it prints the same measures per run,
   the replays of each whole-prompt key after each wave and the decode
   rows rolled back;
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
   memory is printed;
9. caches prompt prefixes at full width (``serve_prefix``): a fused pair
   of qwen2-7b serves one shared-prefix trace (~25 requests, 4 prefixes
   of 256 tokens an LLM, reuse 0.9) with the prefix cache off, then on:
   the cache must hit at no less than half the trace's ceiling, the
   chunk steps must compute exactly the adopted tokens fewer, kernel 2
   must run chunks at ``q_offset``s off the 64-token grid, where it is
   held to its plain version on the served inputs, and the first-token
   logits of 8 hit prompts served with the cache on must hold to those
   served with it off, while a planted wrong adoption of the same
   prompts must read far above that bound; a copy-on-write round trip
   on the served pool must copy pages bit for bit; then the pair
   unfused on an arena of six
   longest sequences, sanitized every tick, must evict index entries
   and drain to index-only blocks, and to none once the views
   unregister.
10. reconfigures live at the published widths, cut in depth
   (``serve_reconfig``): the ``reconfig_shift`` gate's three qwen2-7b on
   its two-unit plan and popularity-flip trace (16-token chunks), at the
   depth whose reckoned peak fits 60 GB, served static and then under
   ``ReconfigController`` with the sanitizer on every tick: every request
   finishes, the move of llm2 into a fused triple executes and beats the
   static run at some SLO scale, every copied page equals its source
   (``torch.equal``), the carried decodes' first logits after the move
   hold to the static run's within bf16's tolerance while a planted copy
   fault reads far above it, and kernels 1 and 2 launch after the move;
   kernel 2 is also held to its plain version at the gate's 16-query
   chunk beside the table's 64;
11. trains through kernels 3 and 4, whose autograd nodes launch the
   kernel in the forward and take the plain version's VJP in the
   backward: (a) at the training shapes (``GRAD_SHAPES``: zamba2-1.2b's
   shared attention 2 x 1024 in f32 and bf16, qwen2-7b's windowed 4096
   over 4352 tokens, zamba2-1.2b's scan) every input's gradient against
   autograd through the plain version, the Function's forward + backward
   timed beside the plain version's; (b) three AdamW steps of five
   reduced architectures on the card against the CPU, and a card
   checkpoint restored into a CPU tree; (c) zamba2-1.2b at full width
   and depth, f32, remat, 20 steps of 2 x 1024 tokens: finite losses
   that fall, a finite non-zero step-1 gradient on every leaf behind a
   kernel, kernels 3 and 4 launched every step, step time beside the
   bytes and flops bounds, peak memory, one step's device time by part;
   (d) the serve steps of ``launch/steps.py`` at full width in f32: the
   sliding-window ring-buffer decode of qwen2-7b past its 4096-token
   window, the hybrid (zamba2-1.2b) and SSM (mamba2-2.7b) prefill and
   decode, each held to ``forward``; (e) the train step as one CUDA
   graph (``train/graphs.compile_train_step``): (c)'s 20 steps as one
   capture and 19 replays, losses and every parameter bit-equal to (c)'s
   and kernels 3 and 4 launched by every replay as often as eagerly; the
   five reduced architectures at the trainer's defaults (8 x 64), plain
   and with two microbatches, eagerly twice and as graphs, bit-equal or
   within the eager runs' spread; a ``launch/train.py --ckpt`` run
   stopped and resumed, its losses equal to an uninterrupted run's; step
   ms p50, capture seconds and peak memory in each mode;
12. holds the lowering tools' accounting against the card
   (``check_lowering``): on the 1×1 host mesh, qwen2-7b prefill_32k and
   mamba2-2.7b prefill_32k (batch 1 of 32: kernels 3 and 4 at S =
   32768), qwen2-7b decode_32k (batch 8 of 128), zamba2-1.2b long_500k
   and zamba2-1.2b train_4k (batch 2 of 256: one AdamW step through
   kernels 3 and 4) are each dry-run on meta (``launch/dryrun.predict``)
   and then run once on the card from arguments materialized from a
   seeded generator: argument bytes equal to the prediction's, outputs
   of the predicted shapes and dtypes and finite, a serve pair's peak
   within 1.1 × the predicted peak + 1 GiB (the train pair's ratio
   printed), the step time of that first call and of a second, warm
   one printed beside the predicted FLOPs.

Any failed phase raises and the script exits non-zero.  The last two
lines of standard output are the card (name, power limit) and a JSON
object; the line before them lists the kernels' numbers as JSON.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time
import warnings
from collections import Counter
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

# The SSD scan's shapes, each named by its label, with its dtype by
# name: the kernel table's (mamba2-2.7b's chunk step at 4, 2 and 1 slots,
# zamba2-1.2b's whole-prompt bucket of 2 rows and of 1) and a reduced
# float32 one with two groups and a ragged chunk.
SSD_SHAPES = [
    dict(label="mamba2-2.7b chunk step bf16", dtype="bfloat16", b=4,
         S=64, chunk=64, H=80, G=1, N=128, init=True),
    dict(label="mamba2-2.7b chunk step bf16, two slots",
         dtype="bfloat16", b=2, S=64, chunk=64, H=80, G=1, N=128,
         init=True),
    dict(label="mamba2-2.7b chunk step bf16, one slot",
         dtype="bfloat16", b=1, S=64, chunk=64, H=80, G=1, N=128,
         init=True),
    dict(label="zamba2-1.2b whole-prompt bucket bf16",
         dtype="bfloat16", b=2, S=512, chunk=256, H=64, G=1, N=64,
         init=False),
    dict(label="zamba2-1.2b whole-prompt bucket bf16, one row",
         dtype="bfloat16", b=1, S=512, chunk=256, H=64, G=1, N=64,
         init=False),
    dict(label="reduced f32, 2 groups, ragged chunk", dtype="float32",
         b=2, S=72, chunk=32, H=8, G=2, N=16, init=True),
]

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


def profiler_ms(torch, fn, match: str = "splitkv_", iters: int = 20,
                per_call: int = 0):
    """Device time of ``fn``'s kernels whose names contain ``match``,
    from ``torch.profiler``'s CUDA activity over ``iters`` calls, each
    with L2 cold as in ``time_ms``: ``ms``, the mean span of a call
    (its first kernel's start to its last kernel's end: the merge
    kernel's launch overlaps the split kernel; with ``per_call``, each
    run of that many kernels is one call), and each kernel's mean
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
    for i, e in enumerate(kern):       # a call opens with its split kernel
        name = re.sub(r"^void repro::|\(.*$", "", e["name"])
        per.setdefault(name, []).append(e["dur"])
        opens = (i % per_call == 0 if per_call else "combine" not in name)
        if opens or not spans:
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
    in the two prefill libraries (head dims 64, 96, 128) and kernel 6's
    (gate/up and down at 64 / 128 rows and 64 / 128 columns), HMMA
    (mma.sync) in the two decode libraries (head dims 64, 96, 128, one
    or two 8-head halves of the m16 tile) and the SSD scan's.  Raises
    unless every bf16 instantiation (``tc_attention_kernel``,
    ``splitkv_tc_kernel``, ``ssd_scan_tc_kernel``, ``moe_wgmma_kernel``)
    has some and every float32 one (the CUDA-core bodies) has none."""
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
    moe_tc = {k: v for k, v in _sass_counts("moe_grouped.cu", "HGMMA").items()
              if "moe_wgmma_kernel" in k}
    moe_f32 = {k: v for k, v in _sass_counts("moe_grouped.cu",
                                             "H[G]?MMA").items()
               if "moe_f32_kernel" in k}
    if len(moe_tc) != 8 or min(moe_tc.values()) == 0:
        raise AssertionError(f"bf16 MoE kernels without HGMMA: {moe_tc}")
    if len(moe_f32) != 2 or max(moe_f32.values()) != 0:
        raise AssertionError(f"float32 MoE kernels with HMMA or HGMMA: "
                             f"{moe_f32}")
    return {"HGMMA": {"bf16": {**tc, **moe_tc}, "float32": f32},
            "HMMA": {"bf16": {**dec_tc, **ssd_tc},
                     "float32": {**dec_f32, **ssd_f32, **moe_f32}}}


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

    # chunk prefill: C-token chunks at mixed offsets; row 1 starts a
    # block past a chunk boundary, as a first chunk after an adopted
    # cached prefix does (a multiple of 16, not of C)
    offs = (rng.integers(0, (16 * W - C) // C, rows) * C).astype(np.int32)
    offs[0] = 0
    offs[1] += 16
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


def check_gate_chunk(torch, np, shape: dict, rows: int = 12,
                     C: int = 16) -> dict:
    """Kernel 2 at the reconfiguration phase's chunk: ``rows`` rows (the
    fused triple's 3 × 4 slots) of ``C`` queries each, at offsets on the
    16-token grid below 256 (the gate's prompts), held against
    ``paged_prefill_plain`` at the dtype's tolerance and timed as the
    kernel table's chunk row is (inputs from generators of their own)."""
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.paging import resolve_physical_blocks
    F = torch.nn.functional

    dt = shape["dtype"]
    dname = str(dt).replace("torch.", "")
    es = torch.empty((), dtype=dt).element_size()
    H, KV, hd, L, W = (shape[k] for k in ("H", "KV", "hd", "layers",
                                          "max_blocks"))
    G = H // KV
    rng = np.random.default_rng(2)
    gen = torch.Generator(device="cuda").manual_seed(2)

    def randn(*s):
        return torch.randn(s, generator=gen, device="cuda").to(dt)
    gsz, n_groups = L * KV, rows * W
    pool_k, pool_v = randn(n_groups * gsz, 16, hd), randn(n_groups * gsz, 16, hd)
    offs = (rng.integers(0, 256 // C, rows) * C).astype(np.int32)
    table = _random_tables(np, rng, rows, W, n_groups, gsz,
                           -(-(offs + C) // 16))
    phys = resolve_physical_blocks(torch.from_numpy(table).cuda(), L - 1, KV)
    qo = torch.from_numpy(offs).cuda()
    q = randn(rows, C, H, hd)
    out = fp.fused_paged_flash_prefill(q, pool_k, pool_v, phys, qo)
    ref = fp.paged_prefill_plain(q, pool_k, pool_v, phys, qo)
    err = (out.float() - ref.float()).abs().max().item()
    if not err <= TOL[dname]:
        raise AssertionError(f"kernel 2 disagrees with its plain version at "
                             f"{rows} x {C} queries: {err} > {TOL[dname]}")
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

    def kern():
        return fp.fused_paged_flash_prefill(q, pool_k, pool_v, phys, qo)
    ms = time_ms(torch, kern)
    res = dict(
        shapes=f"{shape['label']}, {rows} rows x {C} queries",
        q_offsets=offs.tolist(), max_abs_err=err, tolerance=TOL[dname],
        flops=flops, ms=ms, tflops=flops / ms / 1e9,
        plain_ms=time_ms(torch, lambda: fp.paged_prefill_plain(
            q, pool_k, pool_v, phys, qo)),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kg, vg, attn_mask=mask)),
        bound_ms=b, bound_by=why, host_us=host_us(torch, kern),
        call_us=call_us(torch, kern))
    del kg, vg, pool_k, pool_v
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


# Kernel 6's shapes (the grouped-expert SwiGLU of the dropless MoE FFN),
# each named by its label, with its dtype by name: granite-moe-3b-a800m
# (32 experts, top 8, d 1536, f_e 512) and qwen3-moe-235b-a22b (128, top 8,
# 4096, 1536) at a decode (4 rows, 32 slots) and a 64-token chunk (512
# slots), bf16, and at the largest buckets the serving phases give them:
# granite-moe's 4 rows of 64-token chunks (2,048 slots, the MoE A serve
# phase) and qwen3-moe's 4 whole prompts of 512 (16,384 slots) and 1
# (4,096 slots, the largest key graph steps run (vi) serves); d and f
# that are not multiples of 64 (the tiles' zero-filled edges), bf16; the
# reduced configs' experts (4, top 2, 256, 128) at the 4- and 64-token
# counts and 128 experts top 8 at that width, float32; and two edge
# routings at each dtype: every slot on one expert, one token (and
# qwen3-moe's one-token decode, its most frequent served slot count).
# The first is the kernels line's shape.
GRANITE_MOE = dict(E=32, k=8, d=1536, f=512)
QWEN3_MOE = dict(E=128, k=8, d=4096, f=1536)
REDUCED_MOE = dict(E=4, k=2, d=256, f=128)
MOE_SHAPES = [
    dict(label="granite-moe decode bf16", dtype="bfloat16", T=4,
         **GRANITE_MOE),
    dict(label="granite-moe chunk bf16", dtype="bfloat16", T=64,
         **GRANITE_MOE),
    dict(label="qwen3-moe decode bf16", dtype="bfloat16", T=4, **QWEN3_MOE),
    dict(label="qwen3-moe chunk bf16", dtype="bfloat16", T=64, **QWEN3_MOE),
    dict(label="granite-moe 4 x 64 chunk bf16", dtype="bfloat16", T=256,
         **GRANITE_MOE),
    dict(label="qwen3-moe 4 x 512 whole-prompt prefill bf16",
         dtype="bfloat16", T=2048, **QWEN3_MOE),
    dict(label="qwen3-moe 1 x 512 whole-prompt prefill bf16",
         dtype="bfloat16", T=512, **QWEN3_MOE),
    dict(label="bf16, d 72 and f 40 (ragged tile edges)", dtype="bfloat16",
         T=7, E=8, k=3, d=72, f=40),
    dict(label="reduced decode f32", dtype="float32", T=4, **REDUCED_MOE),
    dict(label="reduced chunk f32", dtype="float32", T=64, **REDUCED_MOE),
    dict(label="128 experts top 8 at reduced width, chunk f32",
         dtype="float32", T=64, E=128, k=8, d=256, f=128),
    dict(label="granite-moe bf16, every slot on one expert",
         dtype="bfloat16", T=64, one_expert=True, **GRANITE_MOE),
    dict(label="granite-moe bf16, one token", dtype="bfloat16", T=1,
         **GRANITE_MOE),
    dict(label="qwen3-moe bf16, one token", dtype="bfloat16", T=1,
         **QWEN3_MOE),
    dict(label="reduced f32, every slot on one expert", dtype="float32",
         T=64, one_expert=True, **REDUCED_MOE),
    dict(label="reduced f32, one token", dtype="float32", T=1,
         **REDUCED_MOE),
]
# kernel 6 against its plain version: max |Δ| over the plain output's
# largest magnitude
MOE_TOL_REL = {"bfloat16": 2e-2, "float32": 2e-5}


def _grouped_mm_fn(torch, x, order, offsets, wg, wu, wd, k):
    """The library yardstick for kernel 6: the same function through
    ``torch._grouped_mm`` (gather, the gate and up grouped products on
    the same offsets, SwiGLU, the down product, scatter), weights laid
    out as it wants them (column-major B); never on the port's path.
    None where this torch has no ``_grouped_mm``."""
    if not hasattr(torch, "_grouped_mm"):
        return None
    F = torch.nn.functional
    cm = [w.transpose(-2, -1).contiguous().transpose(-2, -1)
          for w in (wg, wu, wd)]
    ends = offsets[1:]
    o = order.long()

    def run():
        xs = x[o // k]
        g = torch._grouped_mm(xs, cm[0], offs=ends)
        u = torch._grouped_mm(xs, cm[1], offs=ends)
        ys = torch._grouped_mm(F.silu(g) * u, cm[2], offs=ends)
        y = torch.empty_like(ys)
        y[o] = ys
        return y
    return run


def check_moe(torch, shape: dict) -> dict:
    """Hold kernel 6 against its plain version at one shape; returns its
    numbers: max |Δ| (against the plain version in the kernel's dtype,
    and against it in float32 on the same inputs), the kernel's time,
    the plain version's, the bound (the distinct experts hit × 3·d·f_e
    weights, x read and y written once, over 3.35 TB/s, against 6·n·d·f_e
    flops over the dtype's peak), the ``torch._grouped_mm`` yardstick's
    time (bf16 only), the launches of one call, the tile plan (held
    equal to the built source's), and for bf16 the wrapper's host time
    and one call's wall time."""
    from repro_torch.kernels import moe_grouped as mg
    dt_ = shape["dtype"]
    dname = str(dt_).replace("torch.", "")
    es = torch.empty((), dtype=dt_).element_size()
    T, E, k, d, f = (shape[n] for n in ("T", "E", "k", "d", "f"))
    gen = torch.Generator(device="cuda").manual_seed(6)

    def randn(*s, scale=1.0):
        return (torch.randn(s, generator=gen, device="cuda") * scale).to(dt_)
    x = randn(T, d)
    wg, wu = randn(E, d, f, scale=d ** -0.5), randn(E, d, f, scale=d ** -0.5)
    wd = randn(E, f, d, scale=f ** -0.5)
    if shape.get("one_expert"):
        idx = torch.full((T, k), E - 1, dtype=torch.int64, device="cuda")
    else:
        idx = torch.randn(T, E, generator=gen, device="cuda").topk(k).indices
    order, offsets = mg.sort_slots(idx, E)
    n0 = mg.MOE_KERNEL.launches
    y = mg.grouped_swiglu(x, order, offsets, wg, wu, wd, k)
    launches = mg.MOE_KERNEL.launches - n0
    ref = mg.grouped_swiglu_plain(x, order, offsets, wg, wu, wd, k)
    ref32 = mg.grouped_swiglu_plain(x.float(), order, offsets, wg.float(),
                                    wu.float(), wd.float(), k)
    err = (y.float() - ref.float()).abs().max().item()
    err32 = (y.float() - ref32).abs().max().item()
    tol = MOE_TOL_REL[dname] * ref.float().abs().max().item()
    n = T * k
    plan = mg.plan(n, E, d, f, dt_)
    hit = int(torch.unique(idx).numel())
    n_bytes = (hit * 3 * d * f + T * d + n * d) * es + 4 * (n + E + 1)
    flops = 6 * n * d * f
    bnd, why = bound_ms(n_bytes, flops, dname)
    kern = lambda: mg.grouped_swiglu(x, order, offsets, wg, wu, wd, k)
    lib = (_grouped_mm_fn(torch, x, order, offsets, wg, wu, wd, k)
           if dt_ == torch.bfloat16 else None)
    lib_ms, lib_note = None, ("no torch._grouped_mm for float32"
                              if dt_ != torch.bfloat16 else
                              "this torch has no torch._grouped_mm")
    if lib is not None:
        try:        # a yardstick only: a refusal is reported, not a fault
            lib_ms, lib_note = time_ms(torch, lib), "torch._grouped_mm"
        except RuntimeError as e:
            lib_note = f"torch._grouped_mm refused: {str(e)[:160]}"
    res = dict(max_abs_err=err, tolerance=tol, tolerance_rel=MOE_TOL_REL[
                   dname], max_abs_err_vs_f32_plain=err32,
               ms=time_ms(torch, kern),
               plain_ms=time_ms(torch, lambda: mg.grouped_swiglu_plain(
                   x, order, offsets, wg, wu, wd, k)),
               library_ms=lib_ms, library=lib_note, bound_ms=bnd,
               bound_by=why, bytes=n_bytes, flops=flops, tokens=T,
               slots=n, experts_hit=hit,
               plan=dict(zip(("bm", "bn_gate_up", "bn_down"), plan)),
               grid_m_tiles=mg.m_tiles(n, E, plan[0]),
               launches_per_call=launches)
    res["tflops"] = flops / res["ms"] / 1e9
    if dt_ == torch.bfloat16:
        # the profiler's span of a call: the gate/up and the down
        # launch's device time each, and the gap between them
        res.update(host_us=host_us(torch, kern), call_us=call_us(torch, kern),
                   profiler=profiler_ms(torch, kern, match="moe_",
                                        per_call=2))
    src = (mg.source_plan(n, E, d, f, dt_),
           mg.source_m_tiles(n, E, plan[0]))
    if launches != 1 or src != (plan, mg.m_tiles(n, E, plan[0])):
        raise AssertionError(f"grouped_swiglu at {shape['label']}: "
                             f"{launches} launches of one call, plan and M "
                             f"tiles {src} (source) vs {plan}, "
                             f"{mg.m_tiles(n, E, plan[0])} (host)")
    if not err <= tol:
        raise AssertionError(f"grouped_swiglu disagrees with its plain "
                             f"version at {shape['label']}: |Δ| {err} > "
                             f"{tol} ({MOE_TOL_REL[dname]} of the plain "
                             f"output's largest magnitude)")
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
                   seed: int, device="cuda", sm_fracs=None):
    """One colocated unit of ``(name, config, rate)`` specs whose configs
    may be cut in depth (``config.replace(configs.get(arch),
    n_layers=k)``), assembled from ``UnifiedKVPool``, ``Engine`` and
    ``MuxScheduler`` as ``serving/driver.build_unit_from_specs`` does:
    quotas ∝ rate, random weights (bf16 on the card, float32 on the CPU)
    from a ``torch.Generator`` seeded ``seed + i``, fused ADBS (engines
    of one geometry fuse), ``sm_fracs`` enforced when given."""
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.kvcache import UnifiedKVPool
    from repro_torch.serving.mux import MuxScheduler
    dev = torch.device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    head_dims = {cfg.hd for _, cfg, _ in specs if not cfg.attn_free}
    if len(head_dims) != 1:
        raise ValueError(f"one pool, one head_dim: {sorted(head_dims)}")
    pool = UnifiedKVPool(pool_blocks, head_dims.pop(), dtype=dtype,
                         device=dev)
    rate_sum = sum(max(r, 0.0) for _, _, r in specs)
    min_quota = max(pool_blocks // (8 * len(specs)), 1)
    engines = {}
    for i, (name, cfg, rate) in enumerate(specs):
        gen = torch.Generator(device=dev).manual_seed(seed + i)
        tree = init_params(cfg, gen, dtype, dev)
        quota = max(int(pool_blocks * max(rate, 0.0) / rate_sum), min_quota)
        engines[name] = Engine(cfg, tree, pool.register_model(cfg, quota),
                               max_slots=4, chunk_tokens=chunk_tokens or None)
        del tree
    return MuxScheduler(engines, pool, policy="adbs", fused=True,
                        sm_frac=sm_fracs)


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
    layer where Python calls it (a step's first sight and its capture;
    a replay calls nothing): every layer must have run it.  Returns the
    run's numbers and launch counts."""
    from collections import Counter

    from repro_torch import configs
    from repro_torch.config import replace
    from repro_torch.core.workload import synthesize
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.serving import driver, engine, graphs

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
    moe_slots = Counter()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with _moe_slot_launches(graphs, moe_slots):
            rep = driver.serve_workload([unit], wl, seed=seed,
                                        max_new_cap=64,
                                        cost=driver.TickCostModel())
            torch.cuda.synchronize()
    finally:
        moe.moe_ffn_dropless = moe_ffn
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    if sum(moe_slots.values()) != launches["repro_moe_grouped"]:
        raise AssertionError(f"kernel 6's launches by slot count "
                             f"{dict(moe_slots)} do not sum to its count")
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
               # MoE FFN calls made by Python: at a step's first sight
               # and its capture (replays call nothing)
               moe_ffn_calls=sum(moe_calls.values()),
               moe_ffn_layers=moe_layers,
               moe_launches_by_slots=dict(sorted(moe_slots.items())),
               serial_engines=sorted(unit._serial_names),
               launches=launches, summary=rep.summary())
    return res


# ---------------------------------------------------------------------------
# compiled steps: one CUDA graph per shape bucket (serving/graphs.py)
# ---------------------------------------------------------------------------
GRAPH_NAMES = ["qwen2-7b#0", "qwen2-7b#1"]
# the first fused decodes' logits, graphs against eager: max |Δ| over
# the largest |logit| (expected 0: the graph replays the same kernels).
# The first fused decode is the one that captures (its result is the
# eager first run's); the second is the first replay
GRAPH_LOGIT_TOL = 2e-2
FIRST_DECODES = 3


def _graph_pool_bytes(torch, graphs):
    """Bytes of the segments of the registry's graph pool (the card's
    allocator snapshot), or None where the snapshot names no pool."""
    pool = getattr(graphs.REGISTRY.capture, "pool", None)
    if pool is None or not torch.cuda.is_available():
        return None
    segs = [s for s in torch.cuda.memory_snapshot()
            if tuple(s.get("segment_pool_id", ())) == tuple(pool)]
    return sum(s["total_size"] for s in segs) if segs else None


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else float("nan")


def serve_graphs(torch, device="cuda", reduced=False) -> dict:
    """The compiled steps at full width: the fused chunked serve phase's
    pair and trace (two qwen2-7b, random bf16 weights from seed 0, 4
    slots, 64-token chunks, ADBS, the logical clock) served (a) under
    ``graphs.disable_graphs()``, (b) with graphs, then (c) with graphs
    and (d) eagerly with the arena grown past its buffer at a third of
    the run (live sequences: the arena reallocates).  Checks: (b)'s
    report equals (a)'s but for the wall fields, and so do (c)'s and
    (d)'s; every greedy token equal; the first ``FIRST_DECODES`` fused
    decodes' logits (the first replay among them) within
    ``GRAPH_LOGIT_TOL`` of the largest; the launch counts equal
    between the eager and graph runs; (b) captures the fused decode once
    and the fused chunk sweep once a row bucket; in (c) every graph on
    the old arena dropped at the grow and each step recaptured at most once
    after it, the fused decode exactly once.  Measures the captures by
    kind and their seconds, the graph pool's bytes, the peak memory of
    each run, and per tick (capture ticks aside) the wall ms and the
    host µs spent in the step calls (planning and enqueue; the argmax
    waits for the card after them)."""
    from repro_torch.core.workload import synthesize
    from repro_torch.kernels import ops
    from repro_torch.serving import driver, graphs

    t_phase = time.perf_counter()
    dev = torch.device(device)
    _free(torch, dev)
    cuda = dev.type == "cuda"
    dtype = torch.bfloat16 if cuda else torch.float32
    wl = synthesize(GRAPH_NAMES, alpha=2.1, max_rate=16 / 2.0, horizon=1.6,
                    seed=0, mean_prompt=256, mean_output=40, max_len=512)
    cost = driver.TickCostModel()

    def run(mode, grow_at=None):
        unit = driver.build_unit_from_specs(
            [(n, "qwen2-7b", wl.rates[n]) for n in GRAPH_NAMES],
            pool_blocks=16384, max_slots=4, chunk_tokens=64, seed=0,
            policy="adbs", fused=True, reduced=reduced, dtype=dtype,
            device=dev)
        reqs = driver.requests_from_workload(wl, unit.engines, seed=0,
                                             max_new_cap=64)
        rec = _timed_steps(unit)
        mem = _Memory(torch, dev)
        sess = driver.ServeSession([unit], reqs, cost=cost)
        ctx = (graphs.disable_graphs() if mode == "eager"
               else contextlib.nullcontext())
        ticks, grow = [], None
        n_log = len(graphs.REGISTRY.log)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with ctx:
            while True:
                if grow_at is not None and grow is None \
                        and unit.stats.ticks == grow_at:
                    grow = _grow_past_buffer(torch, unit, graphs)
                n0, caps = unit.stats.ticks, len(graphs.REGISTRY.log)
                rec["host"] = 0.0
                t = time.perf_counter()
                status = sess.step()[0]
                if unit.stats.ticks > n0:
                    ticks.append(dict(
                        wall_ms=1e3 * (time.perf_counter() - t),
                        host_us=1e6 * rec["host"],
                        captured=len(graphs.REGISTRY.log) > caps))
                if status == "done":
                    break
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rep = sess.report()
        agg = rep.aggregate
        if agg.finished != agg.submitted or agg.submitted == 0:
            raise AssertionError(f"graphs phase ({mode}): served "
                                 f"{agg.finished}/{agg.submitted}")
        if unit.pool.allocator.used:
            raise AssertionError(f"graphs phase ({mode}): the pool was "
                                 f"not freed")
        if grow_at is not None and grow is None:
            raise AssertionError(f"graphs phase ({mode}): no grow at tick "
                                 f"{grow_at}")
        steady = [t for t in ticks if not t["captured"]]
        nums = dict(
            ticks=rep.ticks, wall_s=wall,
            tick_ms_p50=_pct([t["wall_ms"] for t in steady], 0.5),
            tick_ms_p90=_pct([t["wall_ms"] for t in steady], 0.9),
            host_us_p50=_pct([t["host_us"] for t in steady], 0.5),
            host_us_p90=_pct([t["host_us"] for t in steady], 0.9),
            capture_ticks=len(ticks) - len(steady),
            peak_gb=mem.fold(), launches=ops.launch_counts(),
            captured=[k[0][0] for k in graphs.REGISTRY.log[n_log:]],
            chunk_buckets=sum(len(g.chunk_buckets)
                              for g in unit.fused_groups),
            # while the run's graphs live (they go with the unit)
            graph_pool_bytes=_graph_pool_bytes(torch, graphs))
        if grow is not None:
            log = graphs.REGISTRY.log[grow["log_at"]:]
            grow["recaptured"] = dict(Counter(k[0][0] for k in log))
            grow["slots_recaptured_twice"] = sum(
                n > 1 for n in Counter(k[0] for k in log).values())
            nums["grow"] = grow
        out = dict(report=_report_text(rep),
                   tokens={r.req_id: list(r.output) for r in reqs},
                   first=rec["first"], nums=nums)
        del unit, reqs, sess, rep
        _free(torch, dev)
        return out

    caps0, secs0 = Counter(graphs.GRAPH_CAPTURES), Counter(
        graphs.CAPTURE_SECONDS)
    runs = {"(a) eager": run("eager")}
    runs["(b) graphs"] = run("graphs")
    grow_at = runs["(a) eager"]["nums"]["ticks"] // 3
    runs["(c) graphs, grown"] = run("graphs", grow_at)
    runs["(d) eager, grown"] = run("eager", grow_at)
    a, b = runs["(a) eager"], runs["(b) graphs"]
    c, d = runs["(c) graphs, grown"], runs["(d) eager, grown"]
    problems = []
    for x, y, what in ((a, b, "(b)"), (d, c, "(c)")):
        if x["report"] != y["report"]:
            problems.append(f"{what}'s report differs from the eager run's")
        differ = sum(x["tokens"][i] != y["tokens"][i] for i in x["tokens"])
        if differ:
            problems.append(f"{what}: {differ} requests with other tokens")
        if x["nums"]["launches"] != y["nums"]["launches"]:
            problems.append(f"{what} launches {y['nums']['launches']} != "
                            f"eager {x['nums']['launches']}")
    if len(b["first"]) != FIRST_DECODES:
        problems.append(f"{len(b['first'])} fused decodes")
    first_err = max((y - x).abs().max().item() / x.abs().max().item()
                    for x, y in zip(a["first"], b["first"]))
    if not first_err < GRAPH_LOGIT_TOL:
        problems.append(f"first fused decodes: max rel err {first_err}")
    for x, what in ((a, "(a)"), (d, "(d)")):
        if x["nums"]["captured"]:
            problems.append(f"{what} captured {x['nums']['captured']} "
                            f"under disable_graphs")
    caught = Counter(b["nums"]["captured"])
    if caught["fused_decode"] != 1 \
            or caught["fused_prefill_chunk"] != b["nums"]["chunk_buckets"]:
        problems.append(f"(b) captured {dict(caught)}")
    g = c["nums"]["grow"]
    if not g["live_blocks"] or g["reallocated"] is not True:
        problems.append(f"the grow: {g}")
    if g["graphs_left_on_old_arena"]:
        problems.append(f"{g['graphs_left_on_old_arena']} graphs kept "
                        f"the old arena")
    if g["recaptured"].get("fused_decode") != 1 \
            or g["slots_recaptured_twice"]:
        problems.append(f"recaptures after the grow: {g}")
    if problems:
        raise AssertionError("graphs phase: " + "; ".join(problems))
    launches = {k: sum(r["nums"]["launches"][k] for r in runs.values())
                for k in a["nums"]["launches"]}
    return dict(
        models=["qwen2-7b", "qwen2-7b"], chunk_tokens=64,
        requests=len(a["tokens"]),
        captures={k: graphs.GRAPH_CAPTURES[k] - caps0[k]
                  for k in graphs.GRAPH_CAPTURES},
        capture_s={k: graphs.CAPTURE_SECONDS[k] - secs0[k]
                   for k in graphs.CAPTURE_SECONDS},
        graph_pool_bytes=b["nums"]["graph_pool_bytes"],
        first_decode_rel_err=first_err,
        runs={k: r["nums"] for k, r in runs.items()}, launches=launches,
        phase_s=time.perf_counter() - t_phase)


def _timed_steps(unit) -> dict:
    """Wrap ``unit``'s step functions: the returned record sums the wall
    seconds spent in them under ``host`` and keeps the first
    ``FIRST_DECODES`` fused decodes' logits (float32, on the host) under
    ``first``."""
    rec = dict(host=0.0, first=[])

    def timed(fn, first=False):
        def call(*args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            rec["host"] += time.perf_counter() - t
            if first and len(rec["first"]) < FIRST_DECODES:
                rec["first"].append(out.float().cpu())
            return out
        return call
    for grp in unit.fused_groups:
        grp._decode_fn = timed(grp._decode_fn, first=True)
        grp._prefill_fn = timed(grp._prefill_fn)
    for eng in unit.engines.values():
        eng._decode_fn = timed(eng._decode_fn)
        eng._chunk_fn = timed(eng._chunk_fn)
    return rec


def _grow_past_buffer(torch, unit, graphs) -> dict:
    """Grow ``unit``'s arena past its buffer, under live sequences: the
    arena reallocates and the graphs captured on it must go."""
    pool = unit.pool
    k_old = pool.arena()[0]
    old_ptr = k_old.data_ptr()
    extra = k_old.shape[0] - pool.n_head_blocks + 1024
    del k_old
    def on_old():
        return sum(key[1][0] == old_ptr for key in graphs.REGISTRY.graphs)
    before = on_old()
    live = pool.allocator.used
    pool.grow(extra)
    return dict(at_tick=unit.stats.ticks, live_blocks=live,
                added_blocks=extra, graphs_on_old_arena=before,
                reallocated=pool.arena()[0].data_ptr() != old_ptr,
                graphs_left_on_old_arena=on_old(),
                log_at=len(graphs.REGISTRY.log))


def print_graphs(res: dict, card: str) -> None:
    """Print the graphs phase's results, each number beside the card."""
    print(f"graphs phase ({card}): " + json.dumps(
        {k: v for k, v in res.items() if k != "runs"}))
    for name, r in res["runs"].items():
        print(f"graphs phase ({card}): {name}: {r['ticks']} ticks, tick "
              f"{r['tick_ms_p50']:.2f} ms p50 / {r['tick_ms_p90']:.2f} p90, "
              f"host {r['host_us_p50']:.0f} us p50 / {r['host_us_p90']:.0f} "
              f"p90 a tick in the step calls, {r['capture_ticks']} capture "
              f"ticks, wall {r['wall_s']:.2f} s, peak {r['peak_gb']:.2f} GB, "
              f"captured {dict(Counter(r['captured']))}"
              + (f", grow {r['grow']}" if "grow" in r else ""))
    caps = res["captures"]
    pool = res["graph_pool_bytes"]
    print(f"graphs phase ({card}): captures {caps} in "
          f"{sum(res['capture_s'].values()):.2f} s "
          f"({ {k: round(v, 3) for k, v in res['capture_s'].items()} }); "
          f"graph pool "
          + ("not named by the allocator's snapshot" if pool is None
             else f"{pool / 1e6:.1f} MB")
          + f"; first {FIRST_DECODES} fused decodes graphs vs eager max rel err "
          f"{res['first_decode_rel_err']:.3g} < {GRAPH_LOGIT_TOL}; "
          f"phase {res['phase_s']:.1f} s")


# ---------------------------------------------------------------------------
# the rest of the compiled steps: whole-prompt prefill, SSM and hybrid
# ---------------------------------------------------------------------------
# (label, the serve phase's trace and unit, the step kinds it must
# capture and replay, the kernels its replays must launch); each run
# serves its trace twice on one unit (the second wave meets the buckets
# the first captured)
STEP_RUNS = (
    ("(i) whole-prompt serve: qwen2-7b", dict(
        archs=["qwen2-7b"], chunk_tokens=0, n_target=8, seed=1,
        pool_blocks=16384), ("prefill", "decode"),
     ("repro_flash_prefill", "repro_paged_decode")),
    ("(ii) serve A: qwen2-7b + mamba2-2.7b, chunked", dict(
        archs=["qwen2-7b", "mamba2-2.7b"], chunk_tokens=64, n_target=12,
        seed=2, alpha=1.0, pool_blocks=196608), ("chunk_ssm", "decode_ssm"),
     ("repro_ssd_scan",)),
    ("(iii) serve B: zamba2-1.2b, whole-prompt", dict(
        archs=["zamba2-1.2b"], chunk_tokens=0, n_target=12, seed=3,
        pool_blocks=131072), ("prefill_ssm", "decode_ssm"),
     ("repro_ssd_scan", "repro_flash_prefill", "repro_paged_decode")),
    ("(iv) mamba2-2.7b, whole-prompt", dict(
        archs=["mamba2-2.7b"], chunk_tokens=0, n_target=4, seed=13,
        pool_blocks=131072), ("prefill_ssm", "decode_ssm"),
     ("repro_ssd_scan",)),
    # the MoE family (kernel 6), its kinds checked on the MoE engine's
    # keys: MoE A's pair and trace, granite-moe cut to 8 of 32 layers so
    # that the eager twin stays short (width never cut; the MoE A serve
    # phase runs it at full depth), and qwen3-moe at 4 of 94 layers
    # prefilling whole prompts
    ("(v) MoE A: granite-moe-3b-a800m (8 of 32 layers) + musicgen-medium, "
     "chunked", dict(
         archs=["granite-moe-3b-a800m", "musicgen-medium"], chunk_tokens=64,
         n_target=16, seed=4, alpha=1.0, pool_blocks=524288,
         depth={"granite-moe-3b-a800m": 8}), ("chunk", "decode"),
     ("repro_moe_grouped", "repro_paged_prefill", "repro_paged_decode")),
    ("(vi) MoE B: qwen3-moe-235b-a22b (4 of 94 layers), whole-prompt", dict(
        archs=["qwen3-moe-235b-a22b"], chunk_tokens=0, n_target=8, seed=5,
        pool_blocks=65536, depth={"qwen3-moe-235b-a22b": 4}),
     ("prefill", "decode"), ("repro_moe_grouped", "repro_flash_prefill")),
)
STEP_WAVES = 2
# outputs capped at 32 tokens (the serve phases cap at 64): the eager
# runs are host-bound and a wave lasts as long as its longest output,
# so the phase's time is cut in output tokens — cutting requests leaves
# the longest output (serve A's first 8 of 12 requests: 256 ticks of
# 288) — never in width or requests
STEP_MAX_NEW = 32
NEW_KINDS = ("prefill", "prefill_ssm", "chunk_ssm", "decode_ssm")
# the step kinds an MoE engine runs: each captured and replayed, and its
# first sight run under the sync check, in the MoE runs of STEP_RUNS
MOE_KINDS = ("chunk", "decode", "prefill")


def _step_kind(eng, fn: str) -> str:
    """The registry's kind of an engine's step function ``fn``."""
    if fn == "_prefill_fn":
        return "prefill_ssm" if eng.cfg.ssm else "prefill"
    base = "decode" if fn == "_decode_fn" else "chunk"
    return base + ("_ssm" if eng.cfg.ssm else "")


def _is_moe(cfg) -> bool:
    """Whether a step's geometry key (None for a planted step) is MoE."""
    return cfg is not None and cfg.moe is not None


@contextlib.contextmanager
def _moe_sync_checked(torch, graphs, checked: set):
    """Inside the block, a MoE step whose key the registry meets for the
    first time runs its body's eager first run (before the capture)
    under ``torch.cuda.set_sync_debug_mode("error")``: a host sync in
    the body raises out of the step.  ``checked`` collects the kinds so
    run, each once."""
    run_step = graphs.run_step

    def run(kind, cfg_key, midx, params, bufs, host, body, capturable=True):
        if not _is_moe(cfg_key) or kind in checked:
            return run_step(kind, cfg_key, midx, params, bufs, host, body,
                            capturable)

        def synced(p, b, a):
            if torch.cuda.is_current_stream_capturing():
                return body(p, b, a)
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return body(p, b, a)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        n = len(graphs.REGISTRY.log)
        out = run_step(kind, cfg_key, midx, params, bufs, host, synced,
                       capturable)
        if len(graphs.REGISTRY.log) > n:
            checked.add(kind)
        return out
    graphs.run_step = run
    try:
        yield
    finally:
        graphs.run_step = run_step


@contextlib.contextmanager
def _moe_slot_launches(graphs, counts: Counter):
    """Inside the block, kernel 6's launches by layer shape and slot
    count (``E<e> d<d> f<f> n<T·k>``) go into ``counts``: an eager
    launch as the wrapper makes it, a replayed graph's as its capture
    recorded them (a capture's calls launch nothing).  Their sum equals
    the kernel's launch count over the block."""
    from repro_torch.kernels import moe_grouped as mg
    launch, capture = mg._launch, graphs.REGISTRY.capture
    record, own = capture.record, vars(capture).get("record")
    under_way = []      # the slot keys of the capture under way

    def counted_launch(x, order, offsets, w_gate, *rest):
        E, d, f = w_gate.shape
        key = f"E{E} d{d} f{f} n{order.shape[0]}"
        if under_way:
            under_way[-1].append(key)
        else:
            counts[key] += 1
        return launch(x, order, offsets, w_gate, *rest)

    def counted_record(key, fn, dev):
        mine = []
        under_way.append(mine)
        try:
            replay, out = record(key, fn, dev)
        finally:
            under_way.pop()

        def counted_replay(f):
            r = replay(f)
            counts.update(mine)
            return r
        return counted_replay, out
    mg._launch = counted_launch
    capture.record = counted_record
    try:
        yield
    finally:
        mg._launch = launch
        if own is None:
            del capture.record
        else:
            capture.record = own


def _recorded_steps(unit, graphs, keep) -> dict:
    """Wrap ``unit``'s engine step functions: the record sums the wall
    seconds spent in them under ``host``, numbers the calls of each
    kind and keeps (float32, on the host) the logits of the calls
    ``keep`` names by kind, or where ``keep`` is None (a run with graphs)
    of each kind's first call and first replay (its first call that
    captured nothing); a MoE engine's kinds are labelled apart (``decode
    [MoE]``).  It also counts the decode rows that roll back."""
    rec = dict(host=0.0, calls=Counter(), logits={}, replayed=set(),
               rolled=0)

    def timed(fn, kind):
        def call(*args, **kw):
            log = len(graphs.REGISTRY.log)
            t = time.perf_counter()
            out = fn(*args, **kw)
            rec["host"] += time.perf_counter() - t
            i = rec["calls"][kind]
            rec["calls"][kind] += 1
            if keep is None:
                first_replay = (len(graphs.REGISTRY.log) == log
                                and kind not in rec["replayed"])
                if first_replay:
                    rec["replayed"].add(kind)
                want = i == 0 or first_replay
            else:
                want = i in keep.get(kind, ())
            if want:
                rec["logits"].setdefault(kind, {})[i] = out.float().cpu()
            return out
        return call

    def rolled(apply, eng):
        def call(*args):
            n = apply(*args)
            rec["rolled"] += len(eng._rolled_rows)
            return n
        return call
    for eng in unit.engines.values():
        tag = " [MoE]" if _is_moe(eng.cfg) else ""
        for fn in ("_prefill_fn", "_decode_fn", "_chunk_fn"):
            setattr(eng, fn, timed(getattr(eng, fn),
                                   _step_kind(eng, fn) + tag))
        eng.apply_decode_result = rolled(eng.apply_decode_result, eng)
    return rec


def _serve_steps_run(torch, dev, spec, mode, reduced, keep=None) -> dict:
    """One run of ``serve_graph_steps``: the trace served ``STEP_WAVES``
    times on one unit, eagerly or with graphs.  A spec's ``depth`` cuts
    configs in depth at full width (``build_cut_unit``).  With graphs on
    the card, each MoE kind's first sight runs under the sync check
    (``_moe_sync_checked``)."""
    from repro_torch import configs
    from repro_torch.config import replace
    from repro_torch.core.workload import synthesize
    from repro_torch.kernels import ops
    from repro_torch.serving import driver, graphs

    cuda = dev.type == "cuda"
    archs = spec["archs"]
    names = [f"{a}#{i}" for i, a in enumerate(archs)]
    wl = synthesize(names, alpha=spec.get("alpha", 2.1),
                    max_rate=spec["n_target"] / 2.0, horizon=1.6,
                    seed=spec["seed"], mean_prompt=256, mean_output=40,
                    max_len=512)
    depth = {} if reduced else spec.get("depth", {})
    if depth:
        unit = build_cut_unit(torch, [
            (n, replace(configs.get(a), name=n,
                        n_layers=depth.get(a, configs.get(a).n_layers)),
             wl.rates[n]) for n, a in zip(names, archs)],
            spec["pool_blocks"], spec["chunk_tokens"], spec["seed"], dev)
    else:
        unit = driver.build_unit_from_specs(
            [(n, a, wl.rates[n]) for n, a in zip(names, archs)],
            pool_blocks=4000 if reduced else spec["pool_blocks"],
            max_slots=4, chunk_tokens=spec["chunk_tokens"],
            seed=spec["seed"], policy="adbs", fused=True, reduced=reduced,
            dtype=torch.bfloat16 if cuda else torch.float32, device=dev)
    rec = _recorded_steps(unit, graphs, keep)
    mem = _Memory(torch, dev)
    n_log = len(graphs.REGISTRY.log)
    sync_checked = set()
    ctx = contextlib.ExitStack()
    if mode == "eager":
        ctx.enter_context(graphs.disable_graphs())
    elif cuda:
        ctx.enter_context(_moe_sync_checked(torch, graphs, sync_checked))
    ticks, reports, tokens, prefill_replays = [], [], {}, []
    moe_slots = Counter()
    ctx.enter_context(_moe_slot_launches(graphs, moe_slots))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with ctx:
        for wave in range(STEP_WAVES):
            reqs = driver.requests_from_workload(
                wl, unit.engines, seed=spec["seed"],
                max_new_cap=STEP_MAX_NEW)
            sess = driver.ServeSession([unit], reqs,
                                       cost=driver.TickCostModel())
            while True:
                n0, caps = unit.stats.ticks, len(graphs.REGISTRY.log)
                rec["host"] = 0.0
                t = time.perf_counter()
                status = sess.step()[0]
                if unit.stats.ticks > n0:
                    ticks.append(dict(
                        wall_ms=1e3 * (time.perf_counter() - t),
                        host_us=1e6 * rec["host"],
                        captured=len(graphs.REGISTRY.log) > caps))
                if status == "done":
                    break
            rep = sess.report()
            agg = rep.aggregate
            if agg.finished != agg.submitted or agg.submitted == 0:
                raise AssertionError(f"graph steps ({mode}), wave {wave}: "
                                     f"served {agg.finished}/{agg.submitted}")
            reports.append(_report_text(rep))
            tokens.update({(wave, r.req_id): list(r.output) for r in reqs})
            prefill_replays.append({
                str(k[0][2][0][1]): g.replays
                for k, g in graphs.REGISTRY.graphs.items()
                if k[0][0] in ("prefill", "prefill_ssm")
                and k in graphs.REGISTRY.log[n_log:]})
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if unit.pool.allocator.used:
        raise AssertionError(f"graph steps ({mode}): the pool was not "
                             f"freed")
    if sum(moe_slots.values()) != ops.launch_counts()["repro_moe_grouped"]:
        raise AssertionError(f"graph steps ({mode}): kernel 6's launches "
                             f"by slot count {dict(moe_slots)} do not sum "
                             f"to its count")
    mine = {k: g for k, g in graphs.REGISTRY.graphs.items()
            if k in graphs.REGISTRY.log[n_log:]}
    replays, moe_replays = Counter(), Counter()
    replay_launches = Counter()
    for k, g in mine.items():
        replays[k[0][0]] += g.replays
        if _is_moe(k[0][1]):
            moe_replays[k[0][0]] += g.replays
        for kernel, n in g.launches:
            replay_launches[kernel.symbol] += n * g.replays
    steady = [t for t in ticks if not t["captured"]]
    nums = dict(
        requests=STEP_WAVES * len(reqs),
        ticks=len(ticks), wall_s=wall,
        tick_ms_p50=_pct([t["wall_ms"] for t in steady], 0.5),
        tick_ms_p90=_pct([t["wall_ms"] for t in steady], 0.9),
        host_us_p50=_pct([t["host_us"] for t in steady], 0.5),
        host_us_p90=_pct([t["host_us"] for t in steady], 0.9),
        capture_ticks=len(ticks) - len(steady), peak_gb=mem.fold(),
        launches=ops.launch_counts(),
        moe_launches_by_slots=dict(sorted(moe_slots.items())),
        captured=dict(Counter(k[0][0]
                              for k in graphs.REGISTRY.log[n_log:])),
        replays=dict(replays), replay_launches=dict(replay_launches),
        moe_captured=dict(Counter(k[0][0]
                                  for k in graphs.REGISTRY.log[n_log:]
                                  if _is_moe(k[0][1]))),
        moe_replays=dict(moe_replays), sync_checked=sorted(sync_checked),
        # replays of each whole-prompt key at the end of each wave
        # (keyed by the packed tokens' shape: rows, padded length)
        prefill_key_replays=prefill_replays,
        rolled_back_rows=rec["rolled"],
        graph_pool_bytes=_graph_pool_bytes(torch, graphs))
    out = dict(reports=reports, tokens=tokens, logits=rec["logits"],
               nums=nums)
    del unit, sess, rep, mine
    _free(torch, dev)
    return out


def serve_graph_steps(torch, device="cuda", reduced=False) -> dict:
    """The rest of the compiled steps at full width (``STEP_RUNS``): the
    whole-prompt serve (kernel 3: ``prefill``), serve A (kernel 4:
    ``chunk_ssm``, the SSM ``decode_ssm``), serve B (zamba2-1.2b, kernels
    4, 3 and 1: ``prefill_ssm``, ``decode_ssm``), one mamba2-2.7b
    prefilling whole prompts (``prefill_ssm``), MoE A's pair chunked
    (granite-moe cut in depth beside musicgen-medium; kernel 6 in the
    MoE ``chunk`` and ``decode``) and qwen3-moe cut in depth prefilling
    whole prompts (the MoE ``prefill``, ``decode``), each trace served
    twice on one unit, with graphs and then eagerly
    (``disable_graphs``).  Checks per run: the reports (wall fields
    aside), greedy tokens and launch counts equal; each of the run's
    kinds captured and replayed (the MoE engine's own, in the MoE runs);
    the kernels of ``STEP_RUNS`` launched by replays; the logits of
    each kind's first call and first replay within ``GRAPH_LOGIT_TOL``
    of the largest; nothing captured eagerly.  On the card every MoE
    kind's first sight runs its body under the sync check.  Over the
    whole script so far: MoE steps captured.  Then a capture that fails
    (the body raises while capturing) must raise out of the step and
    leave no graph.  Measures per run and mode the ticks' wall ms and
    the host µs in the step calls (capture ticks aside), peak memory,
    the graph pool's bytes, captures and replays by kind (and the MoE
    engine's), the replays of each whole-prompt key after each wave,
    and the decode rows rolled back."""
    from repro_torch import configs
    from repro_torch.serving import graphs

    t_phase = time.perf_counter()
    dev = torch.device(device)
    _free(torch, dev)
    runs, problems, sync_checked = {}, [], set()
    for label, spec, kinds, kernels in STEP_RUNS:
        g = _serve_steps_run(torch, dev, spec, "graphs", reduced)
        keep = {k: set(v) for k, v in g["logits"].items()}
        e = _serve_steps_run(torch, dev, spec, "eager", reduced, keep)
        gn, en = g["nums"], e["nums"]
        if g["reports"] != e["reports"]:
            problems.append(f"{label}: the reports differ")
        differ = sum(g["tokens"][i] != e["tokens"][i] for i in e["tokens"])
        if differ or g["tokens"].keys() != e["tokens"].keys():
            problems.append(f"{label}: {differ} requests with other tokens")
        if gn["launches"] != en["launches"]:
            problems.append(f"{label}: launches {gn['launches']} != eager "
                            f"{en['launches']}")
        if gn["moe_launches_by_slots"] != en["moe_launches_by_slots"]:
            problems.append(f"{label}: kernel 6's launches by slot count "
                            f"{gn['moe_launches_by_slots']} != eager "
                            f"{en['moe_launches_by_slots']}")
        if en["captured"]:
            problems.append(f"{label}: captured {en['captured']} eagerly")
        moe_run = any(_is_moe(configs.get(a)) for a in spec["archs"])
        caught, replayed = ((gn["moe_captured"], gn["moe_replays"])
                            if moe_run else (gn["captured"], gn["replays"]))
        for kind in kinds:
            if not caught.get(kind) or not replayed.get(kind):
                problems.append(f"{label}: {kind} captured "
                                f"{caught.get(kind, 0)}, replayed "
                                f"{replayed.get(kind, 0)}")
        sync_checked |= set(gn["sync_checked"])
        for symbol in kernels if dev.type == "cuda" else ():
            if not gn["replay_launches"].get(symbol):
                problems.append(f"{label}: no replay launched {symbol}")
        errs = {}
        for kind, calls in g["logits"].items():
            errs[kind] = max(
                (y - e["logits"][kind][i]).abs().max().item()
                / e["logits"][kind][i].abs().max().item()
                for i, y in calls.items())
        if not all(v < GRAPH_LOGIT_TOL for v in errs.values()):
            problems.append(f"{label}: logits graphs vs eager {errs}")
        runs[label] = dict(graphs=gn, eager=en, logit_rel_err=errs,
                           compared_calls={k: sorted(v)
                                           for k, v in keep.items()})
    moe = [k[0][0] for k in graphs.REGISTRY.log if _is_moe(k[0][1])]
    if not moe:
        problems.append("no MoE step captured")
    if dev.type == "cuda" and not set(MOE_KINDS) <= sync_checked:
        problems.append(f"MoE kinds run under the sync check: "
                        f"{sorted(sync_checked)}, not {MOE_KINDS}")
    # (the capture stub of the CPU rehearsal records without running)
    raised = (_failed_capture(torch, dev, graphs) if dev.type == "cuda"
              else dict(raised=None, graphs_added=0))
    if dev.type == "cuda" and (not raised["raised"]
                               or raised["graphs_added"]):
        problems.append(f"a failed capture: {raised}")
    if problems:
        raise AssertionError("graph steps phase: " + "; ".join(problems))
    launches = Counter()
    for r in runs.values():
        for mode in ("eager", "graphs"):
            launches.update(r[mode]["launches"])
    return dict(runs=runs, moe_captures=len(moe),
                moe_captured=dict(Counter(moe)),
                moe_sync_checked=sorted(sync_checked), failed_capture=raised,
                total_captures=dict(graphs.GRAPH_CAPTURES),
                launches=dict(launches),
                phase_s=time.perf_counter() - t_phase)


def _failed_capture(torch, dev, graphs) -> dict:
    """A step whose body raises while it is being captured (after its
    eager first run succeeded): the error must leave ``run_step``, and
    the registry must hold no graph of it."""
    import numpy as np
    buf = torch.zeros(4, device=dev)

    class Planted(RuntimeError):
        pass

    def body(params, bufs, a):
        if torch.cuda.is_current_stream_capturing():
            raise Planted("planted failure inside the capture")
        return bufs[0] + a["x"].to(bufs[0].dtype)
    n = len(graphs.REGISTRY.graphs)
    try:
        with warnings.catch_warnings():
            # the capture that raised before its first launch is empty
            warnings.filterwarnings("ignore", "The CUDA Graph is empty")
            graphs.run_step("planted", None, None, {"w": buf}, (buf,),
                            {"x": np.arange(4)}, body)
    except Planted as err:
        return dict(raised=type(err).__name__,
                    graphs_added=len(graphs.REGISTRY.graphs) - n)
    return dict(raised=None, graphs_added=len(graphs.REGISTRY.graphs) - n)


def print_graph_steps(res: dict, card: str) -> None:
    """Print the graph steps phase's results, each number beside the
    card."""
    for label, r in res["runs"].items():
        for mode in ("eager", "graphs"):
            n = r[mode]
            print(f"graph steps ({card}): {label}, {mode}: {n['ticks']} "
                  f"ticks over {STEP_WAVES} waves of the trace, tick "
                  f"{n['tick_ms_p50']:.2f} ms p50 / {n['tick_ms_p90']:.2f} "
                  f"p90, host {n['host_us_p50']:.0f} us p50 / "
                  f"{n['host_us_p90']:.0f} p90 a tick in the step calls, "
                  f"{n['capture_ticks']} capture ticks, wall "
                  f"{n['wall_s']:.2f} s, peak {n['peak_gb']:.2f} GB, "
                  f"captured {n['captured']}, replayed {n['replays']}"
                  + (f" (MoE engine: captured {n['moe_captured']}, "
                     f"replayed {n['moe_replays']})" if n["moe_captured"]
                     else "")
                  + f", rolled-back rows {n['rolled_back_rows']}")
        g, errs = r["graphs"], r["logit_rel_err"]
        pool = g["graph_pool_bytes"]
        if g["moe_launches_by_slots"]:
            print(f"graph steps ({card}): {label}: kernel 6 launches by "
                  f"layer shape and slot count (both modes) "
                  f"{json.dumps(g['moe_launches_by_slots'])}")
        print(f"graph steps ({card}): {label}: launches by replays "
              f"{g['replay_launches']}; whole-prompt key replays after "
              f"each wave {g['prefill_key_replays']}; graph pool "
              + ("not named by the allocator's snapshot" if pool is None
                 else f"{pool / 1e6:.1f} MB")
              + f"; logits graphs vs eager max rel err "
              f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} } < "
              f"{GRAPH_LOGIT_TOL} at calls {r['compared_calls']}")
    print(f"graph steps ({card}): MoE steps captured in the whole script "
          f"{res['moe_captures']} {res['moe_captured']}; MoE bodies run "
          f"under set_sync_debug_mode('error') at their first sight: "
          f"{res['moe_sync_checked']}; a failed capture raised "
          f"{res['failed_capture']['raised']} and added "
          f"{res['failed_capture']['graphs_added']} graphs; captures by "
          f"kind so far {res['total_captures']}; phase "
          f"{res['phase_s']:.1f} s")


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


# ---------------------------------------------------------------------------
# prefix caching at full width
# ---------------------------------------------------------------------------
PREFIX_NAMES = ["llm0", "llm1"]
PREFIX_TRACE = dict(seed=22, mean_prompt=384, mean_output=16, max_len=512,
                    n_prefixes=4, prefix_len=256, reuse=0.9)
PREFIX_HIT_FLOOR = 0.5          # the prefix_cache gate's floor factor
PREFIX_LOGIT_TOL = TOL["bfloat16"]
# a planted wrong adoption must read at least this many times the bound
PREFIX_FAULT_FACTOR = 5


def _recorded(unit, rec: dict) -> None:
    """Record, on the host, what ``unit``'s engines do: every exported
    chunk job's offsets and true lengths (each one runs: kernel 2 at
    those ``q_offset`` rows), each admission's adopted prefix tokens,
    the wall times of each request's submission and first token, and
    the served first-token logits of each request (float32, the logits
    row of its prompt's last chunk, from the fused pair's sweep or an
    engine's own chunk step, whichever served it)."""
    from repro_torch.serving import graphs
    step = {}

    def held_step():
        # the step ``_HeldChunkKernel`` checks runs eagerly: a replayed
        # graph calls no Python wrapper
        held = rec.get("held")
        return (graphs.disable_graphs() if held is not None
                and held.result is None and rec.get("off_grid_job")
                else contextlib.nullcontext())
    for grp in unit.fused_groups:
        def fused(*args, sweep=grp._prefill_fn,
                  names=[e.cfg.name for e in grp.engines]):
            with held_step():
                logits = sweep(*args)
            for m, name in enumerate(names):
                step[name] = logits[m]
            return logits
        grp._prefill_fn = fused
    for name, eng in unit.engines.items():
        def exported(export=eng.export_prefill_job):
            job = export()
            if job is not None:
                rec["offs"].extend(int(o) for o in job.offs)
                rec["computed"] += int(job.clens.sum())
                if any(int(o) % 64 for o in job.offs):
                    rec["off_grid_job"] = True
            return job

        def adopted(sid, r, adopt=eng._adopt_prefix):
            hit = adopt(sid, r)
            rec["hits"][r.req_id] = hit
            return hit

        def chunk(*args, run=eng._chunk_fn, name=name):
            with held_step():
                step[name] = run(*args)
            return step[name]

        def applied(job, nxt, apply=eng.apply_prefill_result, name=name):
            for i, r in enumerate(job.reqs):
                if job.offs[i] + job.clens[i] >= len(r.prompt):
                    rec["logits"][r.req_id] = step[name][i].float().clone()
            return apply(job, nxt)
        eng.export_prefill_job = exported
        eng._adopt_prefix = adopted
        eng._chunk_fn = chunk
        eng.apply_prefill_result = applied

    def submit(r, submit=unit.submit):
        rec["submit"][r.req_id] = time.perf_counter()
        submit(r)

    def emit(kind, r, _tok):
        if kind == "token" and r.req_id not in rec["first"]:
            rec["first"][r.req_id] = time.perf_counter()
    unit.submit = submit
    unit.set_emit(emit)


class _HeldChunkKernel:
    """Kernel 2 held against its plain version inside a served run: the
    engines' chunk-attention call is wrapped so that the first call
    after the recorder saw a chunk job with a row off the 64-token grid
    (that step's layer 0) also runs ``paged_prefill_plain`` on the same
    q, pool, blocks and offsets.  The bound is ``TOL`` of the dtype
    times the plain output's largest magnitude (served activations are
    not unit-scale).  The plain call launches nothing.  On the card that
    one step runs eagerly (``_recorded``): a step replayed as a CUDA
    graph calls no Python wrapper."""

    def __init__(self, torch, rec: dict):
        from repro_torch.serving import cache_ops
        self.torch, self.rec, self.ops = torch, rec, cache_ops
        self.kernel = cache_ops.fused_paged_chunk_attention
        self.result = None

    def __enter__(self):
        self.ops.fused_paged_chunk_attention = self
        self.rec["held"] = self
        return self

    def __exit__(self, *exc):
        self.ops.fused_paged_chunk_attention = self.kernel
        self.rec.pop("held")

    def __call__(self, q, pool_k, pool_v, phys, q_offset):
        from repro_torch.kernels import flash_prefill as fp
        out = self.kernel(q, pool_k, pool_v, phys, q_offset)
        if self.result is None and self.rec.get("off_grid_job"):
            ref = fp.paged_prefill_plain(q, pool_k, pool_v, phys, q_offset)
            scale = ref.float().abs().max().item()
            dname = str(q.dtype).replace("torch.", "")
            self.result = dict(
                rows=q.shape[0], q_offsets=q_offset.tolist(),
                max_abs_err=(out.float() - ref.float()).abs().max().item(),
                tolerance=TOL[dname] * scale, tolerance_rel=TOL[dname],
                plain_max_abs=scale)
        return out


def _logit_errors(torch, picked, on: dict, off: dict) -> dict:
    """The ``picked`` requests' first-token logits ``on`` against ``off``
    (dicts by request id): per LLM the largest error over the largest
    logit (the phase's bound reads the largest of these), per prompt
    the same ratio, and the greedy flips, all and beyond the reference
    test's 1 % near-tie."""
    rel, flips, far, per_prompt = 0.0, 0, 0, []
    for name in PREFIX_NAMES:
        ids = [r.req_id for r in picked if r.model == name]
        if not ids:
            continue
        a = torch.stack([on[i] for i in ids])
        b = torch.stack([off[i] for i in ids])
        rel = max(rel, float((a - b).abs().max() / b.abs().max()))
        per_prompt += [float((a[j] - b[j]).abs().max() / b[j].abs().max())
                       for j in range(len(ids))]
        f_all, f_far = _greedy_flips(a, b)
        flips, far = flips + f_all, far + f_far
    return {"prompts": len(per_prompt), "max_rel_err": rel,
            "per_prompt": per_prompt, "greedy_flips": flips,
            "beyond_near_tie_flips": far}


def _planted_fault(torch, unit, reqs, picked, rec) -> dict:
    """The logit check's control: the ``picked`` prompts served again on
    ``unit`` (one token each, through the same fused path) with each
    prompt's adoption planted wrong — its first cached blocks replaced
    by those a prompt of another prefix of the same LLM has in the
    index, as a hash collision would.  Returns the first-token logits by
    request id (the check must read these far above its bound)."""
    from repro_torch.serving.engine import Request
    saved, rec["logits"] = rec["logits"], {}
    wrong, copies = {}, []
    for name in PREFIX_NAMES:
        idx = unit.engines[name].view.prefix_index
        cached = [idx.lookup(r.prompt) + (r.prompt,) for r in reqs
                  if r.model == name]
        for r in picked:
            if r.model != name:
                continue
            other = next((b for hit, b, p in cached
                          if hit and p[:16] != r.prompt[:16]), None)
            if other is None:
                raise AssertionError(f"no prompt of another prefix cached "
                                     f"for request {r.req_id}")
            wrong[tuple(r.prompt)] = list(other)
            copies.append(Request(req_id=r.req_id, model=name,
                                  prompt=list(r.prompt), max_new_tokens=1))

        def planted(prompt, lookup=idx.lookup):
            hit, bases = lookup(prompt)
            other = wrong.get(tuple(prompt))
            if hit and other:
                k = min(len(other), len(bases))
                bases = other[:k] + list(bases[k:])
            return hit, bases
        idx.lookup = planted
    try:
        for r in copies:
            unit.submit(r)
        unit.run()
    finally:
        for name in PREFIX_NAMES:
            del unit.engines[name].view.prefix_index.lookup
    if any(not r.done for r in copies):
        raise AssertionError("the planted-fault requests did not finish")
    faulted, rec["logits"] = rec["logits"], saved
    return faulted


def _cow_round_trip(torch, unit) -> dict:
    """Copy-on-write on the card, on a served pool: a sequence adopts an
    indexed group (real prefilled pages) up to a mid-block token and
    appends one token: its private group must hold the source's pages
    bit for bit, the source untouched.  Then a sharer whose donor left
    first is the sole holder: its append unshares in place, with no
    allocation and no copy.  The sanitizer checks the pool after each."""
    from repro_torch.config import BLOCK_TOKENS
    from repro_torch.serving.sanitize import PoolSanitizer
    pool = unit.pool
    view = unit.engines[PREFIX_NAMES[0]].view
    gs, alloc = view.group_size, pool.allocator
    san = PoolSanitizer(pool)
    _, (base, _) = view.prefix_index.entries()[-1]
    src_k = pool.k[base:base + gs].clone()
    src_v = pool.v[base:base + gs].clone()
    sid = 1 << 30
    refs = alloc.refcount(base)
    if not view.share_prefix(sid, [base], BLOCK_TOKENS // 2):
        raise AssertionError("share_prefix refused")
    if alloc.refcount(base) != refs + 1 or not view.append_tokens(sid, 1):
        raise AssertionError("the copy-on-write append failed")
    new = view.seqs[sid].bases[0]
    problems = []
    if new == base or view.seqs[sid].shared != 0:
        problems.append(f"no private group: {new} vs {base}")
    if not (torch.equal(pool.k[new:new + gs], src_k)
            and torch.equal(pool.v[new:new + gs], src_v)):
        problems.append("the private group's pages differ from the source")
    if not (torch.equal(pool.k[base:base + gs], src_k)
            and torch.equal(pool.v[base:base + gs], src_v)):
        problems.append("the copy touched the source group")
    if alloc.refcount(base) != refs:
        problems.append(f"source refcount {alloc.refcount(base)} != {refs}")
    san.check("copy-on-write")
    # the sole holder: the donor leaves before the sharer writes
    if not view.append_tokens(sid + 1, BLOCK_TOKENS):
        raise AssertionError("no room for the sole-holder donor")
    g = view.seqs[sid + 1].bases[0]
    if not view.share_prefix(sid + 2, [g], BLOCK_TOKENS // 2):
        raise AssertionError("share_prefix refused")
    view.free_seq(sid + 1)
    free, pages = alloc.free_blocks, pool.k[g:g + gs].clone()
    if not view.append_tokens(sid + 2, 1):
        raise AssertionError("the sole holder's append failed")
    if view.seqs[sid + 2].bases[0] != g or view.seqs[sid + 2].shared:
        problems.append("the sole holder did not unshare in place")
    if alloc.free_blocks != free or not torch.equal(pool.k[g:g + gs], pages):
        problems.append("the sole holder's unshare allocated or copied")
    san.check("unshare in place")
    for s in (sid, sid + 2):
        view.free_seq(s)
    san.check("after the round trip")
    if problems:
        raise AssertionError("copy-on-write: " + "; ".join(problems))
    return dict(group_blocks=gs, source_base=base, private_base=new,
                mid_block_tokens=BLOCK_TOKENS // 2, pages_equal=True,
                sole_holder_in_place=True, sanitizer_checks=san.checks)


def serve_prefix(torch, device="cuda", reduced=False) -> dict:
    """Prefix caching at full width: a fused pair of qwen2-7b (``llm0``,
    ``llm1``; random bf16 weights from the same seeds in every run, 4
    slots, 64-token chunks, ADBS, the logical clock) serves one
    ``shared_prefix_trace`` (α 2.1 over a 12 req/s peak for 1.6 s, ~24
    requests; 4 prefixes of 256 tokens an LLM, reuse 0.9, 384-token
    prompts on average, at most 512, 16-token outputs) (a) with the
    cache off, then (b) with it on, on fresh units.  Checks: (b) hits,
    at a request hit rate of at least ``PREFIX_HIT_FLOOR`` × the trace's
    ceiling; the prompt tokens (b)'s chunk steps computed are (a)'s less
    (b)'s adopted tokens; kernel 2 ran (b)'s chunks at some ``q_offset``
    that is not a multiple of 64, and kernels 1 and 2 both launched;
    kernel 2 holds to its plain version at the first such step of (b)
    (``_HeldChunkKernel``); on 8 hit prompts the first-token logits (b)
    served (adopted prefix, suffix chunks) hold to those (a) served for
    the same prompts within ``PREFIX_LOGIT_TOL`` of the largest logit,
    with equal greedy tokens but on near-ties; a copy-on-write round trip
    on (b)'s pool (``_cow_round_trip``); the control: the same prompts
    served again on (b)'s unit with a planted wrong adoption
    (``_planted_fault``) must read at least ``PREFIX_FAULT_FACTOR`` × the
    logit bound.  Then (c) the same pair unfused
    (a fused pair's zero-copy grant would give the arena a weight copy
    of blocks) on an arena of six longest sequences, the sanitizer on
    every tick: LRU ``reclaim`` must evict index entries, every request
    must finish, the drained allocator must hold only index blocks, and
    none once the views unregister."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.core.workload import (power_law_rates,
                                           prefix_repeat_fraction,
                                           shared_prefix_trace)
    from repro_torch.kernels import ops
    from repro_torch.serving import driver

    t_phase = time.perf_counter()
    dev = torch.device(device)
    # the chaos phase's unit lives on in reference cycles (its patched
    # recovery and sanitizer hooks) until the collector runs: free it
    # before a weight copy is built
    _free(torch, dev)
    cuda = dev.type == "cuda"
    dtype = torch.bfloat16 if cuda else torch.float32
    cost = driver.TickCostModel()
    rates = power_law_rates(PREFIX_NAMES, 2.1, 12.0)
    wl = shared_prefix_trace(rates, 1.6, **PREFIX_TRACE)
    ceiling = prefix_repeat_fraction(wl)

    def build(cache, fused=True, pool_blocks=16384):
        return driver.build_unit_from_specs(
            [(n, "qwen2-7b", rates[n]) for n in PREFIX_NAMES],
            pool_blocks=pool_blocks, max_slots=4, chunk_tokens=64, seed=40,
            policy="adbs", fused=fused, reduced=reduced, dtype=dtype,
            device=dev, prefix_cache=cache)

    def serve(unit, sanitize=False, hold=False):
        reqs = driver.requests_from_workload(wl, unit.engines, seed=1,
                                             max_new_cap=64)
        rec = dict(offs=[], computed=0, hits={}, submit={}, first={},
                   logits={}, checks=0)
        _recorded(unit, rec)
        mem = _Memory(torch, dev)
        sess = driver.ServeSession([unit], reqs, cost=cost,
                                   sanitize=sanitize)
        if sanitize:
            check = sess.sanitizer.check

            def counted(where=""):
                rec["checks"] += 1
                check(where)
            sess.sanitizer.check = counted
        held = _HeldChunkKernel(torch, rec)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with held if hold else contextlib.nullcontext():
            while sess.step()[0] != "done":
                pass
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rep = sess.report()
        nums = _run_numbers(rep, reqs, wall, ops.launch_counts())
        rec["kernel_2"] = held.result
        ttft = sorted(rec["first"][i] - rec["submit"][i]
                      for i in rec["first"])
        nums.update(wall_ttft_p50_s=float(np.median(ttft)),
                    logical_ttft_p50_s=rep.aggregate.ttft.p50,
                    peak_gb=mem.fold(), prompt_tokens_computed=rec["computed"],
                    prefix=rep.prefix)
        agg = rep.aggregate
        if agg.finished != agg.submitted or agg.submitted == 0:
            raise AssertionError(f"served {agg.finished}/{agg.submitted}")
        return reqs, rep, rec, nums

    runs = {}
    # (a) cache off
    unit = build(False)
    reqs_a, _, rec_a, runs["(a) cache off"] = serve(unit)
    if unit.pool.allocator.used:
        raise AssertionError("(a): the pool was not freed")
    out_a = {r.req_id: list(r.output) for r in reqs_a}
    del unit, reqs_a
    _free(torch, dev)

    # (b) cache on, fresh units
    unit = build(True)
    reqs_b, rep_b, rec_b, runs["(b) cache on"] = serve(unit, hold=True)
    nb, na = runs["(b) cache on"], runs["(a) cache off"]
    hits = sum(p["hits"] for p in rep_b.prefix.values())
    lookups = sum(p["lookups"] for p in rep_b.prefix.values())
    hit_tokens = sum(p["hit_tokens"] for p in rep_b.prefix.values())
    problems = []
    if hits == 0 or hits / lookups < PREFIX_HIT_FLOOR * ceiling:
        problems.append(f"hit rate {hits}/{lookups} below "
                        f"{PREFIX_HIT_FLOOR} x ceiling {ceiling:.3f}")
    if rec_b["computed"] != rec_a["computed"] - hit_tokens:
        problems.append(f"(b) computed {rec_b['computed']} prompt tokens, "
                        f"(a) {rec_a['computed']} less {hit_tokens} adopted")
    off64 = sorted({o for o in rec_b["offs"] if o % 64})
    if not off64:
        problems.append("no chunk of (b) started off a multiple of 64")
    for symbol in ("repro_paged_decode", "repro_paged_prefill"):
        for key, n in (("(a) cache off", na), ("(b) cache on", nb)):
            if cuda and n["launches"][symbol] <= 0:
                problems.append(f"{symbol} never launched in {key}")
    differ = sum(out_a[r.req_id] != list(r.output) for r in reqs_b)
    if problems:
        raise AssertionError("prefix phase: " + "; ".join(problems))

    # kernel 2 against its plain version at a served off-grid step
    k2 = rec_b["kernel_2"]
    if k2 is None or not any(o % 64 for o in k2["q_offsets"]):
        problems.append("kernel 2 was not held at an off-grid step")
    elif not k2["max_abs_err"] <= k2["tolerance"]:
        problems.append(f"kernel 2 disagrees with its plain version at "
                        f"served offsets {k2['q_offsets']}: "
                        f"{k2['max_abs_err']} > {k2['tolerance']}")
    # the logit check: 8 hit prompts, (b)'s served first-token logits
    # against (a)'s
    picked = [r for r in sorted(reqs_b, key=lambda r: r.req_id)
              if rec_b["hits"].get(r.req_id, 0) > 0][:8]
    logits = _logit_errors(torch, picked, rec_b["logits"], rec_a["logits"])
    logits.update(tolerance=PREFIX_LOGIT_TOL,
                  adopted_tokens=[rec_b["hits"][r.req_id] for r in picked])
    if logits["prompts"] != 8:
        problems.append(f"{logits['prompts']} hit prompts for the logit "
                        f"check")
    if logits["beyond_near_tie_flips"]:
        problems.append(f"{logits['beyond_near_tie_flips']} greedy flips "
                        f"beyond a near-tie")
    if logits["max_rel_err"] >= PREFIX_LOGIT_TOL:
        problems.append(f"cached vs uncached first-token logits: max rel "
                        f"err {logits['max_rel_err']:.4f} >= "
                        f"{PREFIX_LOGIT_TOL}")
    cow = _cow_round_trip(torch, unit)
    # the control: a planted wrong adoption must read far above the bound
    fault = _logit_errors(torch, picked, _planted_fault(
        torch, unit, reqs_b, picked, rec_b), rec_a["logits"])
    fault["floor"] = PREFIX_FAULT_FACTOR * PREFIX_LOGIT_TOL
    if fault["max_rel_err"] < fault["floor"]:
        problems.append(f"a planted wrong adoption read "
                        f"{fault['max_rel_err']:.4f}, under "
                        f"{fault['floor']}")
    if problems:
        raise AssertionError("prefix phase: " + "; ".join(problems))
    del unit, reqs_b, rep_b, picked
    _free(torch, dev)

    # (c) an arena of six longest sequences: reclaim must fire
    cfg = (configs.get_reduced if reduced else configs.get)("qwen2-7b")
    small = 6 * (-(-(512 + 64) // 16)) * cfg.n_layers * cfg.n_kv_heads
    unit = build(True, fused=False, pool_blocks=small)
    _, rep_c, rec_c, runs["(c) cache on, small arena"] = serve(
        unit, sanitize=True)
    pool = unit.pool
    evicted = sum(p["evicted"] for p in rep_c.prefix.values())
    held = sum(v.prefix_index.held_blocks for v in pool.views.values())
    if evicted == 0:
        problems.append("(c): no index entry was evicted")
    if rec_c["checks"] != rep_c.ticks + 1:
        problems.append(f"(c): {rec_c['checks']} sanitizer checks for "
                        f"{rep_c.ticks} ticks")
    if pool.allocator.used != held or held == 0:
        problems.append(f"(c): the drained allocator holds "
                        f"{pool.allocator.used} blocks, the index {held}")
    for name in PREFIX_NAMES:
        pool.unregister_model(name)
    if pool.allocator.used:
        problems.append(f"(c): {pool.allocator.used} blocks held after "
                        f"the views unregistered")
    if problems:
        raise AssertionError("prefix phase: " + "; ".join(problems))
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in runs["(a) cache off"]["launches"]}
    res = dict(
        models=["qwen2-7b", "qwen2-7b"], chunk_tokens=64,
        trace={**PREFIX_TRACE, "rates": rates, "horizon": 1.6,
               "requests": len(wl.requests)},
        ceiling=ceiling, hits=hits, lookups=lookups, hit_tokens=hit_tokens,
        off_64_offsets=off64[:16],
        prompt_tokens_computed={"a": na["prompt_tokens_computed"],
                                "b": nb["prompt_tokens_computed"]},
        paged_prefill_launches_saved=(
            na["launches"]["repro_paged_prefill"]
            - nb["launches"]["repro_paged_prefill"]),
        requests_with_other_tokens=differ,
        kernel_2_at_served_offsets=k2, logit_check=logits,
        planted_fault=fault,
        cow=cow, small_arena_blocks=small, evicted=evicted,
        sanitizer_checks=rec_c["checks"], index_blocks_after_drain=held,
        runs=runs, launches=launches,
        phase_s=time.perf_counter() - t_phase)
    del unit, pool, rep_c
    _free(torch, dev)
    return res


def print_prefix(res: dict, card: str) -> None:
    """Print the prefix phase's results."""
    print("prefix phase: " + json.dumps(
        {k: v for k, v in res.items() if k != "runs"}))
    for name, run in res["runs"].items():
        print(f"  prefix phase, {name}: " + json.dumps(run))
    a, b = res["runs"]["(a) cache off"], res["runs"]["(b) cache on"]
    lc, pf, k2 = (res["logit_check"], res["planted_fault"],
                  res["kernel_2_at_served_offsets"])
    print(f"prefix phase ({card}): (a) cache off {a['wall_tok_s']:.1f} "
          f"tok/s wall, TTFT p50 {a['wall_ttft_p50_s']:.3f} s wall, peak "
          f"{a['peak_gb']:.2f} GB; (b) cache on {b['wall_tok_s']:.1f} tok/s "
          f"wall, TTFT p50 {b['wall_ttft_p50_s']:.3f} s wall, peak "
          f"{b['peak_gb']:.2f} GB; {res['hits']}/{res['lookups']} hits, "
          f"{res['hit_tokens']} hit tokens, "
          f"{res['paged_prefill_launches_saved']} kernel-2 launches saved; "
          f"first-token logits max rel err {lc['max_rel_err']:.4f} < "
          f"{lc['tolerance']} on {lc['prompts']} hit prompts "
          f"({lc['greedy_flips']} greedy flips, "
          f"{lc['beyond_near_tie_flips']} beyond a near-tie; per prompt "
          f"{', '.join(f'{e:.4f}' for e in lc['per_prompt'])}); a planted "
          f"wrong adoption reads {pf['max_rel_err']:.4f} >= {pf['floor']} "
          f"(per prompt {', '.join(f'{e:.4f}' for e in pf['per_prompt'])}); "
          f"kernel 2 at served offsets {k2['q_offsets']}: max abs err "
          f"{k2['max_abs_err']:.3g} <= {k2['tolerance']:.3g}; "
          f"{res['requests_with_other_tokens']} served requests' tokens "
          f"differ between (a) and (b); (c) {res['evicted']} entries "
          f"evicted; the phase took {res['phase_s']:.1f} s")


# ---------------------------------------------------------------------------
# live reconfiguration at the published widths, cut in depth
# ---------------------------------------------------------------------------
RECONFIG_PRE = {"llm0": 25.0, "llm1": 2.0, "llm2": 0.5}
RECONFIG_POST = {"llm0": 0.5, "llm1": 2.0, "llm2": 25.0}
RECONFIG_HORIZON = 4.0
RECONFIG_TRACE = dict(seed=0, mean_prompt=24, mean_output=10, max_len=256)
RECONFIG_SCALES = (1.5, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0)
RECONFIG_BUDGET_GB = 60.0       # the reckoned peak the depth cut must fit
RECONFIG_LOGIT_TOL = TOL["bfloat16"]
# a planted copy fault must read at least this many times the bound
RECONFIG_FAULT_FACTOR = 5


def weight_bytes(cfg, es: int) -> dict:
    """Bytes of a dense config's weight tree, from its shapes (the leaves
    of ``init_params``, ``es`` bytes an element): the embedding, head and
    final norm; one layer; a layer's largest leaf; the embedding leaf."""
    from repro_torch.config import pad_vocab
    d, f, v = cfg.d_model, cfg.d_ff, pad_vocab(cfg.vocab_size)
    q, kv = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    layer = 2 * d * q + 2 * d * kv + 3 * d * f + 2 * d
    if cfg.qkv_bias:
        layer += q + 2 * kv
    if cfg.qk_norm:
        layer += 2 * cfg.hd
    return dict(tok=es * (v * d * (1 if cfg.tie_embeddings else 2) + d),
                layer=es * layer, layer_leaf=es * max(d * q, d * f),
                embed=es * v * d)


def reconfig_depth(cfg, es: int = 2,
                   budget_gb: float = RECONFIG_BUDGET_GB) -> dict:
    """The reconfiguration phase's depth cut, reckoned before the run.
    With W(k) one LLM's weight bytes at k layers: the static run holds
    5·W (the fused pair's stack 2W and its zero-copy grant 2W, llm2 W).
    After the move unit 0 stacks the three (3W) and grows a 3W grant
    while its sequences live, one arena buffer at a time beside the
    pair's 2W buffer that ``shrink`` kept: about 7·W, plus one stacked
    leaf (3 × the largest leaf).  Returns the largest k whose reckoned
    peak fits ``budget_gb``, with its reckoning."""
    b = weight_bytes(cfg, es)

    def reckon(k):
        w = (b["tok"] + k * b["layer"]) / 1e9
        leaf = 3 * max(k * b["layer_leaf"], b["embed"]) / 1e9
        return dict(layers=k, weights_gb=w, static_gb=5 * w,
                    stacked_leaf_gb=leaf, move_gb=7 * w + leaf)
    fits = [k for k in range(1, cfg.n_layers + 1)
            if reckon(k)["move_gb"] <= budget_gb]
    if not fits:
        raise AssertionError(f"no depth of {cfg.name} fits {budget_gb} GB")
    return dict(reckon(max(fits)), budget_gb=budget_gb,
                full=reckon(cfg.n_layers))


def _reconfig_plan():
    """The gate's startup plan (``benchmarks/reconfig_shift.py``,
    full-width configs as the re-planner prices them): llm0 and llm1 on
    a 4-device mesh, llm2 alone on 1 device."""
    from repro_torch import configs
    from repro_torch.config import replace
    from repro_torch.core.estimator import LLMSpec
    from repro_torch.core.placement import Mesh, Placement
    cfg = configs.get("qwen2-7b")

    def spec(name):
        return LLMSpec(replace(cfg, name=name), RECONFIG_PRE[name],
                       mean_prompt=RECONFIG_TRACE["mean_prompt"],
                       mean_output=RECONFIG_TRACE["mean_output"], tp=1,
                       sm_frac=1.0, arch="qwen2-7b")
    return Placement([Mesh(0, 4, [spec("llm0"), spec("llm1")]),
                      Mesh(1, 1, [spec("llm2")])],
                     total_tpt=sum(RECONFIG_PRE.values()))


def _reconfig_units(torch, dev, cfg):
    """The units ``units_from_placement`` builds for the gate's plan, at
    ``cfg``'s depth (``build_cut_unit``): 16,000 pool blocks split by
    mesh size (12,800 and 4,096), mesh ``m``'s weights from seeds ``m +
    i``, shares 1.0 enforced, 4 slots, 16-token chunks, fused ADBS."""
    from repro_torch.config import replace
    units = []
    for mesh_id, n_dev, names in ((0, 4, ("llm0", "llm1")),
                                  (1, 1, ("llm2",))):
        u = build_cut_unit(
            torch, [(n, replace(cfg, name=n), RECONFIG_PRE[n]) for n in names],
            max(int(16000 * n_dev / 5), 4096), 16, mesh_id, device=dev,
            sm_fracs={n: 1.0 for n in names})
        u.mesh_id, u.n_devices = mesh_id, n_dev
        units.append(u)
    return units


class _DecodeRows:
    """The served decode logits (float32) of the requests ``want(r)``
    picks, by (request id, output index): ``greedy_tokens`` (engine and
    mux) keeps each step's logits, and every engine's
    ``apply_decode_result`` files its rows — row ``i`` of a serial step,
    row ``[model_index, i]`` of a fused sweep."""

    def __init__(self, units, want):
        from repro_torch.serving import engine, mux
        self.mods, self.greedy = (engine, mux), engine.greedy_tokens
        self.engines = [e for u in units for e in u.engines.values()]
        self.want, self.rows, self.last = want, {}, None

    def __enter__(self):
        def greedy(logits):
            self.last = logits
            return self.greedy(logits)
        for m in self.mods:
            m.greedy_tokens = greedy
        for eng in self.engines:
            def applied(job, nxt, apply=eng.apply_decode_result, eng=eng):
                for i, r in enumerate(job.reqs):
                    if self.want(r):
                        row = (self.last[eng.model_index, i]
                               if self.last.dim() == 3 else self.last[i])
                        self.rows[(r.req_id, len(r.output))] = \
                            row.float().clone()
                return apply(job, nxt)
            eng.apply_decode_result = applied
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m.greedy_tokens = self.greedy
        for eng in self.engines:
            del eng.apply_decode_result
        # the rows outlive the run; its engines (and weights) must not
        self.engines, self.last = [], None


class _CheckedCopy:
    """The migration's page copy (``kvcache.copy_block_groups`` with a
    source pool) timed to the card's end of it, and every destination
    group's K and V held to its source group's with ``torch.equal`` right
    after the copy, before ``migrate_view`` frees the source."""

    def __init__(self, torch, dev):
        from repro_torch.serving import kvcache
        self.torch, self.cuda, self.mod = torch, dev.type == "cuda", kvcache
        self.copy, self.records = kvcache.copy_block_groups, []

    def __enter__(self):
        self.mod.copy_block_groups = self
        return self

    def __exit__(self, *exc):
        self.mod.copy_block_groups = self.copy

    def __call__(self, pool_k, pool_v, src_bases, dst_bases, n_kv, n_layers,
                 src_k=None, src_v=None):
        if src_k is None:
            return self.copy(pool_k, pool_v, src_bases, dst_bases, n_kv,
                             n_layers)
        torch = self.torch
        if self.cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = self.copy(pool_k, pool_v, src_bases, dst_bases, n_kv, n_layers,
                        src_k=src_k, src_v=src_v)
        if self.cuda:
            torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t)
        gs = n_kv * n_layers
        equal = sum(torch.equal(pool_k[d:d + gs], src_k[s:s + gs])
                    and torch.equal(pool_v[d:d + gs], src_v[s:s + gs])
                    for s, d in zip(src_bases, dst_bases))
        self.records.append(dict(
            groups=len(src_bases), head_blocks=len(src_bases) * gs,
            groups_equal=int(equal), copy_ms=ms,
            gb=(torch.cuda.memory_allocated() / 1e9 if self.cuda else 0.0)))
        return out


@contextlib.contextmanager
def _uncounted():
    """Kernel launches inside the block leave the launch counts as they
    were (a side computation, not the served path)."""
    from repro_torch.kernels import ops
    saved = {k: k.launches for k in ops.path_kernels()}
    try:
        yield
    finally:
        for k, n in saved.items():
            k.launches = n


def _side_decode(torch, np, eng, plant: bool) -> dict:
    """The carried engine's next decode logits computed off a side copy
    of its rows' block groups (the served pool is not written): with
    ``plant``, the first group of its first row rolled by one head-block
    in the side copy (each (layer, head) page takes its neighbour's, as
    a copy misaligned by one block would leave it).  Returns the logits
    by (request id, output index)."""
    from types import SimpleNamespace

    from repro_torch.serving.engine import _next_pow2, _pad_rows
    job = eng.export_decode_job()
    pool, gs = eng.pool, eng.view.group_size
    lens = eng.view.seq_lens(job.seq_ids)
    table = eng.view.block_table(job.seq_ids, eng.max_blocks)
    bases = sorted({int(b) for b in table.ravel() if b >= 0})
    remap = {b: j * gs for j, b in enumerate(bases)}
    idx = torch.cat([torch.arange(b, b + gs) for b in bases]).to(pool.device)
    side = SimpleNamespace(k=pool.k[idx], v=pool.v[idx], device=pool.device,
                           block_tokens=pool.block_tokens)
    if plant:
        g = remap[int(table[0, 0])]
        for t in (side.k, side.v):
            t[g:g + gs] = torch.roll(t[g:g + gs], 1, dims=0)
    table = np.vectorize(lambda b: remap.get(int(b), -1))(table).astype(
        np.int32)
    last_tok, B = job.last_tok, len(job)
    if _next_pow2(B) != B:
        last_tok, lens, table = _pad_rows(
            _next_pow2(B), (job.last_tok, 0), (lens, 1), (table, -1))
    with _uncounted():
        logits = eng._decode_fn(eng.params, eng.model_index, last_tok, lens,
                                side, table)
    return {(r.req_id, len(r.output)): logits[i].float()
            for i, r in enumerate(job.reqs)}


def _rel_errors(torch, rows: dict, ref: dict) -> dict:
    """``rows`` against ``ref`` (same keys): the largest error over the
    largest reference logit, per row and overall, and the greedy flips,
    all and beyond the reference test's 1 % near-tie."""
    keys = sorted(rows)
    a = torch.stack([rows[k] for k in keys])
    b = torch.stack([ref[k].to(a.device) for k in keys])
    per = [float((a[i] - b[i]).abs().max() / b[i].abs().max())
           for i in range(len(keys))]
    flips, far = _greedy_flips(a, b)
    return {"rows": len(keys), "max_rel_err": max(per), "per_row": per,
            "greedy_flips": flips, "beyond_near_tie_flips": far}


def serve_reconfig(torch, device="cuda", reduced=False) -> dict:
    """Live reconfiguration at the published widths, cut in depth: the
    ``reconfig_shift`` gate's setup — three qwen2-7b (``llm0``–``llm2``)
    on its two-unit plan (mesh 0: llm0 + llm1, 4 devices in the cost
    model; mesh 1: llm2, 1 device; both units on the one card), its
    ``piecewise_poisson_trace`` (25 / 2 / 0.5 req/s, llm0 and llm2
    swapping at 2 s of 4; 24-token prompts, 10-token outputs, at most
    256), 16-token chunks, 4 slots, fused ADBS, shares enforced,
    ``TickCostModel`` — at the depth ``reconfig_depth`` reckons to fit
    ``RECONFIG_BUDGET_GB`` (random bf16 weights).  The trace is served
    static, then, on fresh units, under ``ReconfigController(interval=
    0.25, drift_threshold=2.0, sustain=2)`` with the sanitizer on every
    tick.  Checks: both runs finish every request; the reconfig run
    executes an event with a move and beats the static run at some SLO
    scale; every copied group's K and V equal its source's
    (``_CheckedCopy``); each decode the move carried gives, at its first
    step after the move (inside the fused triple), logits within
    ``RECONFIG_LOGIT_TOL`` of the largest logit the static run served
    for the same request and step, with equal greedy tokens but on
    near-ties, while the same step off a side copy with one copied group
    rolled by one head-block reads at least ``RECONFIG_FAULT_FACTOR`` ×
    that bound; kernels 1 and 2 launch after the move.  ``reduced``
    rehearses the phase on the CPU (reduced width, no depth cut)."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.config import replace
    from repro_torch.core.workload import piecewise_poisson_trace
    from repro_torch.kernels import ops
    from repro_torch.serving import driver
    from repro_torch.serving.reconfig import (MigrationCostModel,
                                              ReconfigController)

    t_phase = time.perf_counter()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    _free(torch, dev)
    depth = reconfig_depth(configs.get("qwen2-7b"))
    cfg = (configs.get_reduced("qwen2-7b") if reduced else
           replace(configs.get("qwen2-7b"), n_layers=depth["layers"]))
    wl = piecewise_poisson_trace(
        [(0.0, RECONFIG_PRE), (RECONFIG_HORIZON / 2, RECONFIG_POST)],
        RECONFIG_HORIZON, **RECONFIG_TRACE)
    cost = driver.TickCostModel()

    def serve(units, reqs, ctrl=None):
        sess = driver.ServeSession(units, reqs, slo_scales=RECONFIG_SCALES,
                                   cost=cost, planned_rates=dict(wl.rates),
                                   reconfig=ctrl, sanitize=ctrl is not None)
        checks = []
        if ctrl is not None:
            check = sess.sanitizer.check

            def counted(where=""):
                checks.append(where)
                check(where)
            sess.sanitizer.check = counted
        t0 = time.perf_counter()
        while sess.step()[0] != "done":
            pass
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rep = sess.report()
        agg = rep.aggregate
        if agg.finished != agg.submitted or agg.submitted != len(reqs):
            raise AssertionError(f"served {agg.finished}/{agg.submitted} of "
                                 f"{len(reqs)}")
        return rep, wall, len(checks)

    def reqs_for(units):
        engines = {n: e for u in units for n, e in u.engines.items()}
        return driver.requests_from_workload(wl, engines, seed=1)

    # (a) static: the startup placement throughout
    ops.reset_launch_counts()
    mem = _Memory(torch, dev)
    units = _reconfig_units(torch, dev, cfg)
    reqs = reqs_for(units)
    with _DecodeRows(units, lambda r: r.model == "llm2") as static_rows:
        rep_s, wall_s, _ = serve(units, reqs)
    runs = {"static": dict(
        _run_numbers(rep_s, reqs, wall_s, ops.launch_counts()),
        peak_gb=mem.fold() - mem.held, reckoned_peak_gb=depth["static_gb"])}
    static_out = {r.req_id: list(r.output) for r in reqs}
    del units, reqs
    _free(torch, dev)

    # (b) live reconfiguration, fresh units of the same seeds
    ops.reset_launch_counts()
    mem = _Memory(torch, dev)
    units = _reconfig_units(torch, dev, cfg)
    reqs = reqs_for(units)
    ctrl = ReconfigController(_reconfig_plan(), units, interval=0.25,
                              drift_threshold=2.0, sustain=2,
                              migration_cost=MigrationCostModel())
    carried, moves, probes = {}, [], {}
    execute = ctrl.executor.execute

    def measured(schedule, new_pl, now=0.0):
        """One executed schedule, timed to the card's end of it, with its
        own peak; the decodes a move carried, and the side-copy probes of
        their next step."""
        held = mem.now()
        mem.reset()
        launches_at = ops.launch_counts()
        n_copies = len(copy.records)
        t = time.perf_counter()
        stats = execute(schedule, new_pl, now)
        if cuda:
            torch.cuda.synchronize()
        rec = dict(t=now, s=time.perf_counter() - t, held_gb=held,
                   peak_gb=(torch.cuda.max_memory_allocated() / 1e9
                            if cuda else 0.0), after_gb=mem.now(),
                   executed=[list(m) for m in stats["executed"]],
                   copies=copy.records[n_copies:], launches_at=launches_at)
        for name, _, dst in stats["executed"]:
            eng = ctrl.units[dst].engines[name]
            live = [eng.slots[s] for s in eng.active_slots()]
            carried.update({r.req_id: len(r.output) for r in live})
            rec["carried_prefix_equal"] = sum(
                static_out[r.req_id][:len(r.output)] == r.output
                for r in live)
            probes["side copy"] = _side_decode(torch, np, eng, plant=False)
            probes["planted fault"] = _side_decode(torch, np, eng,
                                                   plant=True)
        moves.append(rec)
        return stats
    ctrl.executor.execute = measured
    with _CheckedCopy(torch, dev) as copy, _DecodeRows(
            units, lambda r: carried.get(r.req_id) == len(r.output)) as rows:
        rep_r, wall_r, checks = serve(units, reqs, ctrl)
    launches = ops.launch_counts()
    runs["reconfig"] = dict(
        _run_numbers(rep_r, reqs, wall_r, launches),
        peak_gb=mem.fold() - mem.held, reckoned_peak_gb=depth["move_gb"],
        sanitizer_checks=checks)

    problems = []
    rc = rep_r.reconfig
    if rc.events < 1 or rc.moves < 1:
        problems.append(f"{rc.events} events, {rc.moves} moves")
    s_att, r_att = rep_s.aggregate.attainment, rep_r.aggregate.attainment
    better = [s for s in RECONFIG_SCALES if r_att[s] > s_att[s]]
    if not better:
        problems.append(f"reconfig not above static at any scale: "
                        f"{r_att} vs {s_att}")
    if checks != rep_r.ticks + 1:
        problems.append(f"{checks} sanitizer checks for {rep_r.ticks} ticks")
    copies = [c for m in moves for c in m["copies"]]
    if not copies or any(c["groups_equal"] != c["groups"] for c in copies):
        problems.append(f"migration copies {copies}")
    at = next((m["launches_at"] for m in moves if m["executed"]), None)
    for symbol in ("repro_paged_decode", "repro_paged_prefill"):
        if cuda and (at is None or launches[symbol] <= at[symbol]):
            problems.append(f"{symbol} did not launch after the move")
    if not carried or set(carried.items()) != set(rows.rows):
        problems.append(f"carried decodes {carried}, first steps after the "
                        f"move {sorted(rows.rows)}")
    if problems:
        raise AssertionError("reconfig phase: " + "; ".join(problems))
    logits = _rel_errors(torch, rows.rows, static_rows.rows)
    logits["tolerance"] = RECONFIG_LOGIT_TOL
    side = _rel_errors(torch, probes["side copy"], static_rows.rows)
    fault = _rel_errors(torch, probes["planted fault"], static_rows.rows)
    fault["floor"] = RECONFIG_FAULT_FACTOR * RECONFIG_LOGIT_TOL
    if logits["max_rel_err"] >= RECONFIG_LOGIT_TOL:
        problems.append(f"carried decodes' logits: max rel err "
                        f"{logits['max_rel_err']:.4f} >= {RECONFIG_LOGIT_TOL}")
    if logits["beyond_near_tie_flips"]:
        problems.append(f"{logits['beyond_near_tie_flips']} greedy flips "
                        f"beyond a near-tie")
    if fault["max_rel_err"] < fault["floor"]:
        problems.append(f"a planted copy fault read {fault['max_rel_err']:.4f}"
                        f", under {fault['floor']}")
    if problems:
        raise AssertionError("reconfig phase: " + "; ".join(problems))
    per_move = {round(m["t"], 6): m for m in moves}
    events = []
    for ev in rc.log:
        m = per_move.get(round(ev["t"], 6), {})
        cp = m.get("copies", [])
        events.append(dict(
            t=ev["t"], moves=ev["moves"],
            migrated_blocks=ev["migrated_blocks"], requeued=ev["requeued"],
            quota_moved=ev["quota_moved"], share_moved=ev["share_moved"],
            shrunk_blocks=ev["shrunk_blocks"],
            copy_ms=sum(c["copy_ms"] for c in cp),
            groups_equal=[c["groups_equal"] for c in cp],
            cost_model_ms=1e3 * MigrationCostModel().dt(
                ev["migrated_blocks"]),
            execute_s=m.get("s"), held_gb=m.get("held_gb"),
            peak_gb=m.get("peak_gb"), after_gb=m.get("after_gb"),
            carried_prefix_equal=m.get("carried_prefix_equal")))
    res = dict(
        models=["qwen2-7b"] * 3, layers=cfg.n_layers, depth=depth,
        trace={"pre": RECONFIG_PRE, "post": RECONFIG_POST,
               "horizon": RECONFIG_HORIZON, **RECONFIG_TRACE,
               "requests": len(wl.requests)},
        runs=runs, events=events, better_scales=better,
        carried={str(k): v for k, v in sorted(carried.items())},
        logit_check=logits, side_copy=side, planted_fault=fault,
        launches=launches, launches_at_move=at,
        summary=rep_r.summary(), phase_s=time.perf_counter() - t_phase)
    del units, reqs, ctrl, rows, static_rows, probes
    _free(torch, dev)
    return res


def print_reconfig(res: dict, card: str) -> None:
    """Print the reconfiguration phase's results."""
    d = res["depth"]
    print("reconfig phase: " + json.dumps(
        {k: v for k, v in res.items() if k not in ("runs", "summary")}))
    for name, run in res["runs"].items():
        print(f"  reconfig phase, {name}: " + json.dumps(run))
    for line in res["summary"].splitlines():
        print(f"  {line}")
    print(f"reconfig phase ({card}): qwen2-7b x3 at {res['layers']} of "
          f"{d['full']['layers']} layers (W {d['weights_gb']:.2f} GB; "
          f"reckoned peak {d['move_gb']:.2f} GB <= {d['budget_gb']} GB, "
          f"full depth {d['full']['move_gb']:.1f})")
    for name, run in res["runs"].items():
        att = ", ".join(f"{k}x {v:.3f}" for k, v in run["attainment"].items())
        print(f"  {name}: {run['ticks']} ticks, {run['tick_ms']:.1f} ms a "
              f"tick, {run['wall_s']:.2f} s wall, {run['wall_tok_s']:.1f} "
              f"tok/s wall; attainment {att}; peak {run['peak_gb']:.2f} GB "
              f"(reckoned {run['reckoned_peak_gb']:.2f})")
    for ev in res["events"]:
        print(f"  event @{ev['t']:.3f}s: moves {ev['moves']}, "
              f"{ev['migrated_blocks']} head-blocks migrated, "
              f"{ev['requeued']} requeued, quota moved {ev['quota_moved']}, "
              f"share moved {ev['share_moved']:.2f}; copy "
              f"{ev['copy_ms']:.3f} ms wall (groups equal "
              f"{ev['groups_equal']}) beside MigrationCostModel.dt "
              f"{ev['cost_model_ms']:.3f} ms; peak "
              f"{ev['peak_gb'] or 0.0:.2f} GB with both pools live")
    lc, sc, pf = res["logit_check"], res["side_copy"], res["planted_fault"]
    print(f"  carried decodes ({lc['rows']}): first step after the move vs "
          f"static, max rel err {lc['max_rel_err']:.4f} < "
          f"{lc['tolerance']} ({lc['greedy_flips']} greedy flips, "
          f"{lc['beyond_near_tie_flips']} beyond a near-tie); side copy "
          f"{sc['max_rel_err']:.4f}; planted copy fault "
          f"{pf['max_rel_err']:.4f} >= {pf['floor']}; the phase took "
          f"{res['phase_s']:.1f} s")


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


# ---------------------------------------------------------------------------
# training through kernels 3 and 4, and the serve steps (launch/steps.py)
# ---------------------------------------------------------------------------
# (a) kernel gradients at the training shapes: zamba2-1.2b's shared
# attention (2 x 1024, 32 heads of 64) in f32 and bf16, qwen2-7b's
# attention (28/4 heads of 128, bf16) with window 4096 over 4352 tokens,
# and zamba2-1.2b's SSD scan (b 2, S 1024, chunk 256, 64 heads, N 64)
GRAD_SHAPES = [
    dict(label="zamba2-1.2b shared attention f32, 2 x 1024",
         kernel="flash_prefill", dtype="float32", b=2, S=1024, H=32, KV=32,
         hd=64, window=None),
    dict(label="zamba2-1.2b shared attention bf16, 2 x 1024",
         kernel="flash_prefill", dtype="bfloat16", b=2, S=1024, H=32, KV=32,
         hd=64, window=None),
    dict(label="qwen2-7b bf16, window 4096 over 4352 tokens",
         kernel="flash_prefill", dtype="bfloat16", b=1, S=4352, H=28, KV=4,
         hd=128, window=4096),
    dict(label="zamba2-1.2b scan f32, 2 x 1024", kernel="ssd_scan",
         dtype="float32", b=2, S=1024, H=64, G=1, N=64, chunk=256),
]
# (b) the reduced train steps, card (kernels) against CPU (plain)
TRAIN_ARCHS = ("qwen2-7b", "granite-moe-3b-a800m", "mamba2-2.7b",
               "zamba2-1.2b", "musicgen-medium")
TRAIN_TOL = 1e-4   # f32: the loss (relative), each leaf's gradient (of
#                    its largest element), as the CPU tests hold them
# (c) full-width training: zamba2-1.2b, 38 layers, f32, remat on
TRAIN_FULL = dict(arch="zamba2-1.2b", batch=2, seq=1024, steps=20, lr=1e-3)
KERNEL_LEAVES = {"shared_attn": ("wq", "wk", "wv"),
                 "layers": ("in_proj", "conv_w", "conv_b", "dt_bias",
                            "a_log", "d_skip")}
# (d) the serve steps at full width, f32, against ``forward``
SERVE_STEPS_TOL = TOL["bfloat16"]
SERVE_NEW = 8


def _attn_work(b, S, H, hd, window) -> int:
    """(query, key) pairs of causal attention over S tokens (a window
    keeps the last ``window`` keys), times b * H * hd."""
    w = S if window is None else min(window, S)
    pairs = sum(min(i + 1, w) for i in range(S))
    return b * H * hd * pairs


def check_grads(torch, shape: dict) -> dict:
    """Kernel 3 or 4 on inputs that require grad, at a training shape:
    the output's node must be the kernel's autograd Function, its forward
    must launch the kernel once and hold to the plain version run in
    float32 on the same inputs (attention: ``TOL`` absolute; the scan's
    y and final state: ``SSD_TOL_REL`` of the plain output's largest, as
    ``check_ssd`` holds them), and the gradient of every input (the
    plain version's VJP from the saved inputs) must hold to autograd
    through the plain version on the same inputs within ``TOL`` of the
    largest plain gradient.  Times the Function's forward + backward
    beside the plain version's.  Bound: the bytes of the inputs, the
    cotangents, the outputs and the gradients once; operations: the
    forward's products and the backward's (twice as many)."""
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import ssd_scan as ss
    dname = shape["dtype"]
    dt_ = getattr(torch, dname)
    es = torch.empty((), dtype=dt_).element_size()
    gen = torch.Generator(device="cuda").manual_seed(11)

    def randn(*s, dtype=dt_):
        return torch.randn(s, generator=gen, device="cuda").to(dtype)
    b, S = shape["b"], shape["S"]
    if shape["kernel"] == "flash_prefill":
        H, KV, hd, w = shape["H"], shape["KV"], shape["hd"], shape["window"]
        ins = [randn(b, S, H, hd), randn(b, S, KV, hd), randn(b, S, KV, hd)]
        cots = [randn(b, S, H, hd)]
        kern = fp.flash_prefill
        names = ("q", "k", "v")

        def run(fn, args):
            return (fn(*args, window=w),)
        plain = fp.flash_prefill_plain
        node, counter = "_FlashPrefillBackward", fp.FLASH_KERNEL
        n_bytes = es * (2 * ins[0].numel() * 2 + 2 * 2 * ins[1].numel())
        flops = 3 * 4 * _attn_work(b, S, H, hd, w)
    else:
        H, G, N, Q = shape["H"], shape["G"], shape["N"], shape["chunk"]
        P = ss.HEAD_DIM
        f32 = torch.float32
        ins = [randn(b, S, H, P),
               torch.nn.functional.softplus(randn(b, S, H, dtype=f32) - 2.0),
               torch.log(torch.linspace(1.0, 16.0, H, device="cuda")),
               randn(b, S, G, N), randn(b, S, G, N),
               torch.ones(H, device="cuda"), randn(b, H, P, N, dtype=f32)]
        cots = [randn(b, S, H, P), randn(b, H, P, N, dtype=f32)]
        kern = ss.ssd_scan
        names = ("x", "dt", "a_log", "B", "C", "d_skip", "init_state")

        def run(fn, args):
            return fn(*args[:6], Q, args[6])
        plain = ss.ssd_plain
        node, counter = "_SsdScanBackward", ss.SSD_KERNEL
        # each input read and its gradient written once, plus y and the
        # final state with their cotangents
        n_bytes = 2 * sum(t.numel() * t.element_size() for t in ins) \
            + 2 * (ins[0].numel() * es + b * H * P * N * 4)
        fwd = 0
        for c0 in range(0, S, Q):
            q = min(Q, S - c0)
            fwd += (q * (q + 1) // 2) * (2 * N + 2 * P) + 4 * q * P * N
        flops = 3 * fwd * b * H
    leaves_ = [t.requires_grad_() for t in ins]
    n0 = counter.launches
    outs = run(kern, leaves_)
    if type(outs[0].grad_fn).__name__ != node or counter.launches != n0 + 1:
        raise AssertionError(f"{shape['label']}: the output's node is "
                             f"{type(outs[0].grad_fn).__name__}, launches "
                             f"{counter.launches - n0}; expected {node}, 1")
    # the forward: the kernel's outputs against the plain version in
    # float32 (the bf16 plain version rounds its scores to bf16, the
    # kernel does not)
    with torch.no_grad():
        fref = run(plain, [t.detach().float() for t in leaves_])
    fwd_errs, fwd_tols = [], []
    for o, r in zip(outs, fref):
        fwd_errs.append((o.detach().float() - r).abs().max().item())
        fwd_tols.append(TOL[dname] if shape["kernel"] == "flash_prefill"
                        else SSD_TOL_REL[dname] * r.abs().max().item())
    del fref
    if not all(e <= t for e, t in zip(fwd_errs, fwd_tols)):
        raise AssertionError(f"{shape['label']}: the kernel's forward "
                             f"differs from the plain version's by "
                             f"{fwd_errs} > {fwd_tols}")
    got = torch.autograd.grad(outs, leaves_, cots)
    ref = torch.autograd.grad(run(plain, leaves_), leaves_, cots)
    torch.cuda.synchronize()
    errs = {}
    for name, a, r in zip(names, got, ref):
        scale = r.float().abs().max().item()
        errs[name] = (a.float() - r.float()).abs().max().item() / scale
        if not (torch.isfinite(a.float()).all() and errs[name] <= TOL[dname]):
            raise AssertionError(f"{shape['label']}: d{name} differs from "
                                 f"the plain version's by {errs[name]:.3g} "
                                 f"of its largest (tolerance {TOL[dname]})")
    del outs, got, ref

    def fwd_bwd(fn):
        return lambda: torch.autograd.grad(run(fn, leaves_), leaves_, cots)
    bnd, why = bound_ms(n_bytes, flops, dname)
    res = dict(label=shape["label"], ms=time_ms(torch, fwd_bwd(kern), 10),
               plain_ms=time_ms(torch, fwd_bwd(plain), 10), bound_ms=bnd,
               bound_by=why, max_rel_err=max(errs.values()),
               rel_err=errs, tolerance=TOL[dname],
               fwd_max_abs_err=fwd_errs, fwd_tolerance=fwd_tols)
    _free(torch, torch.device("cuda"))
    return res


def train_reduced_match(torch, device="cuda") -> dict:
    """(b) Three AdamW steps (remat on) of the reduced five
    architectures of the CPU tests' loss test on ``device`` (kernels 3
    and 4 on the card) and on the CPU (plain versions), from the same
    float32 weights and ``synth_batch`` batches: every step's loss within
    ``TRAIN_TOL`` relative, and the first step's gradients of every leaf
    within ``TRAIN_TOL`` of the leaf's largest.  Then a checkpoint of
    the card's parameters and AdamW state restores into a CPU tree equal
    to them.  Returns the numbers and the kernels' launches on the card
    (main path)."""
    import tempfile

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_params, loss_fn
    from repro_torch.train import checkpoint
    from repro_torch.train.data import DataConfig, synth_batch
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.pytree import leaves, tree_map
    from repro_torch.train.train_step import _value_and_grad, make_train_step

    t0 = time.perf_counter()
    launches = {k.symbol: 0 for k in ops.path_kernels()}
    out, devs = {}, ("cpu", device)
    for arch in TRAIN_ARCHS:
        cfg = configs.get_reduced(arch)
        base = init_params(cfg, torch.Generator().manual_seed(0),
                           torch.float32, "cpu")
        opt = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=60)
        dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                          global_batch=4, seed=1, n_patterns=2,
                          frontend_dim=cfg.frontend_dim,
                          n_prefix_tokens=cfg.n_prefix_tokens)
        run = {}
        for dev in devs:
            before = ops.launch_counts()
            params = tree_map(lambda t: t.to(dev, copy=True), base)
            state = init_state(params)
            step = make_train_step(cfg, opt, remat=True)

            def batch(i):
                toks, labels, prefix = synth_batch(dcfg, i)
                b = [torch.from_numpy(toks).long().to(dev),
                     torch.from_numpy(labels).to(dev)]
                return b + ([] if prefix is None
                            else [torch.from_numpy(prefix).to(dev)])
            b0 = batch(0)
            _, grads = _value_and_grad(lambda p: loss_fn(
                p, cfg, b0[0], b0[1], b0[2] if len(b0) > 2 else None), params)
            losses = []
            for i in range(3):
                params, state, m = step(params, state, *batch(i))
                losses.append(float(m["loss"]))
            after = ops.launch_counts()
            if dev != "cpu":
                for k in launches:
                    launches[k] += after[k] - before[k]
            run[dev] = dict(grads=[g.cpu() for g in leaves(grads)],
                            losses=losses,
                            tree={"p": params, "o": state})
        cpu, card = run["cpu"], run[device]
        loss_err = max(abs(a - b) / abs(b) for a, b in
                       zip(card["losses"], cpu["losses"]))
        grad_err = max(((a - b).abs().max() / b.abs().max().clamp(
            min=1e-30)).item() for a, b in zip(card["grads"], cpu["grads"]))
        with tempfile.TemporaryDirectory() as d:
            checkpoint.save(d, card["tree"], step=3)
            like = {"p": tree_map(torch.zeros_like, base)}
            like["o"] = init_state(like["p"])
            restored, st, _ = checkpoint.restore(d, like)
        exact = st == 3 and all(
            torch.equal(a.cpu(), b) and b.device.type == "cpu"
            for a, b in zip(leaves(card["tree"]), leaves(restored)))
        out[arch] = dict(losses_card=card["losses"],
                         losses_cpu=cpu["losses"], max_loss_rel=loss_err,
                         max_grad_rel=grad_err, checkpoint_equal=exact)
        if not (loss_err <= TRAIN_TOL and grad_err <= TRAIN_TOL and exact):
            raise AssertionError(f"reduced {arch} training, card vs CPU: "
                                 f"{out[arch]} (tolerance {TRAIN_TOL})")
    for sym in ("repro_flash_prefill", "repro_ssd_scan"):
        if device != "cpu" and not launches[sym]:
            raise AssertionError(f"reduced training launched no {sym}")
    return dict(archs=out, launches=launches,
                seconds=time.perf_counter() - t0)


def _kernel_leaf_check(torch, grads, cfg) -> dict:
    """The step-1 gradient of every leaf behind kernel 3 (the shared
    block's wq, wk, wv) and kernel 4 (each Mamba2 layer's in_proj,
    conv_w, conv_b, dt_bias, a_log, d_skip): finite and not all zero,
    per layer.  Returns each leaf's smallest per-layer largest |g|."""
    res = {}
    for group, names in KERNEL_LEAVES.items():
        for name in names:
            g = grads[group][name]
            per_layer = [g[li] for li in range(g.shape[0])]
            amax = [t.abs().max().item() for t in per_layer]
            if not (all(torch.isfinite(t).all().item() for t in per_layer)
                    and min(amax) > 0):
                raise AssertionError(f"full-width training: {group}/{name}"
                                     f" has a zero or non-finite gradient "
                                     f"at step 1 (largest per layer "
                                     f"{amax})")
            res[f"{group}/{name}"] = min(amax)
    return res


class _Spans:
    """Device time of labelled spans of work on the current stream:
    CUDA events around each (no synchronisation until ``ms``), or the
    host clock on the CPU, where every op is synchronous."""

    def __init__(self, torch, dev):
        self.torch, self.cuda = torch, dev.type == "cuda"
        self.marks = {}

    @contextlib.contextmanager
    def span(self, label: str):
        if self.cuda:
            a = self.torch.cuda.Event(enable_timing=True)
            b = self.torch.cuda.Event(enable_timing=True)
            a.record()
            yield
            b.record()
        else:
            a = time.perf_counter()
            yield
            b = time.perf_counter()
        self.marks.setdefault(label, []).append((a, b))

    def ms(self) -> dict:
        if self.cuda:
            self.torch.cuda.synchronize()
        return {k: sum((a.elapsed_time(b) if self.cuda else (b - a) * 1e3)
                       for a, b in v) for k, v in self.marks.items()}


def _step_breakdown(torch, cfg, params, state, opt, toks, labels) -> dict:
    """One training step (remat on) cut into its parts, device ms each:
    the forward, the backward and the AdamW update; inside them kernels 3
    and 4 (their launches in the forward, and again in the backward's
    remat recompute) and their plain backward (``flash_prefill_vjp``,
    ``ssd_vjp``).  The kernels and the VJPs are timed through wrappers
    put in place of the module names their autograd nodes call; the
    parameters are updated as in any step."""
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models.transformer import loss_fn
    from repro_torch.train.optimizer import apply_updates
    from repro_torch.train.pytree import leaves, tree_map, unflatten

    spans = _Spans(torch, toks.device)
    phase = ["forward"]

    def timed(fn, label):
        def run(*a, **kw):
            with spans.span(f"{label} ({phase[0]})"):
                return fn(*a, **kw)
        return run

    class _TimedKernel:
        def __init__(self, k, label):
            self.k, self.label = k, label

        def __call__(self, *a, **kw):
            with spans.span(f"{self.label} ({phase[0]})"):
                self.k(*a, **kw)

    saved = (fp.FLASH_KERNEL, ss.SSD_KERNEL, fp.flash_prefill_vjp,
             ss.ssd_vjp)
    fp.FLASH_KERNEL = _TimedKernel(saved[0], "kernel 3")
    ss.SSD_KERNEL = _TimedKernel(saved[1], "kernel 4")
    fp.flash_prefill_vjp = timed(saved[2], "kernel 3 plain VJP")
    ss.ssd_vjp = timed(saved[3], "kernel 4 plain VJP")
    try:
        alias = tree_map(lambda p: p.detach().requires_grad_(), params)
        with spans.span("forward"):
            loss = loss_fn(alias, cfg, toks, labels, remat=True)
        phase[0] = "backward"
        with spans.span("backward"):
            grads = torch.autograd.grad(loss, leaves(alias))
        with spans.span("optimizer"):
            apply_updates(params, unflatten(params, grads), state, opt)
    finally:
        (fp.FLASH_KERNEL, ss.SSD_KERNEL, fp.flash_prefill_vjp,
         ss.ssd_vjp) = saved
    ms = spans.ms()
    ms["step"] = ms["forward"] + ms["backward"] + ms["optimizer"]
    return ms


def train_full_width(torch, device="cuda", reduced=False,
                     keep=None) -> dict:
    """(c) zamba2-1.2b at the published widths and full depth (38 Mamba2
    layers, the shared attention block every 6), float32 parameters as
    ``launch/train.py`` makes them, remat on, ``TRAIN_FULL['steps']``
    AdamW steps of ``synth_batch`` (batch 2 x 1024 tokens).  Every loss
    must be finite and the mean of the last five below the first; at
    step 1 every leaf behind a kernel must have a finite, non-zero
    gradient (``_kernel_leaf_check``); kernels 3 and 4 must launch in
    every step.  ``reduced``: the reduced config on ``device`` (the CPU
    rehearsal).  Returns per-step losses, seconds and launches, tokens/s,
    peak memory, the step's bytes (``train_step_bytes``) and flops.
    ``keep``: a dict that receives the parameters after the last step
    (copies, ``keep["params"]``), for the train graphs phase's twin."""
    from repro_torch import configs
    from repro_torch.core.costmodel import step_flops, train_step_bytes
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_params, loss_fn
    from repro_torch.train.data import DataConfig, synth_batch
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.pytree import leaves
    from repro_torch.train.train_step import _value_and_grad, make_train_step

    import numpy as np
    dev = torch.device(device)
    _free(torch, dev)
    t_phase = time.perf_counter()
    arch = TRAIN_FULL["arch"]
    cfg = configs.get_reduced(arch) if reduced else configs.get(arch)
    B, S, steps = ((2, 64, 8) if reduced else
                   (TRAIN_FULL["batch"], TRAIN_FULL["seq"],
                    TRAIN_FULL["steps"]))
    mem = _Memory(torch, dev)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         torch.float32, dev)
    state = init_state(params)
    opt = AdamWConfig(lr=TRAIN_FULL["lr"], warmup_steps=2,
                      total_steps=steps)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                      seed=0, n_patterns=2)

    def batch(i):
        toks, labels, _ = synth_batch(dcfg, i)
        return (torch.from_numpy(toks).long().to(dev),
                torch.from_numpy(labels).to(dev))
    # step 1's gradients (the first step's parameters and batch), checked
    # leaf by leaf before the steps run
    _, grads = _value_and_grad(lambda p: loss_fn(p, cfg, *batch(0),
                                                 remat=True), params)
    checked = _kernel_leaf_check(torch, grads, cfg)
    del grads
    step_fn = make_train_step(cfg, opt, remat=True)
    losses, secs, per_step = [], [], []
    for i in range(steps):
        toks, labels = batch(i)
        before = ops.launch_counts()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, m = step_fn(params, state, toks, labels)
        losses.append(float(m["loss"]))       # syncs
        secs.append(time.perf_counter() - t)
        after = ops.launch_counts()
        per_step.append({k: after[k] - before[k] for k in after})
    peak = mem.fold()
    reserved = (torch.cuda.max_memory_reserved() / 1e9
                if dev.type == "cuda" else 0.0)
    if keep is not None:
        keep["params"] = [p.detach().clone() for p in leaves(params)]
    breakdown = _step_breakdown(torch, cfg, params, state, opt,
                                *batch(steps))
    need = ("repro_flash_prefill", "repro_ssd_scan") if dev.type == "cuda" \
        else ()
    if not all(np.isfinite(x) for x in losses) or \
            not sum(losses[-5:]) / 5 < losses[0]:
        raise AssertionError(f"full-width training: losses {losses}")
    for i, n in enumerate(per_step):
        if any(n[s] <= 0 for s in need):
            raise AssertionError(f"full-width training step {i + 1} "
                                 f"launched {n}")
    n_params = sum(p.numel() for p in leaves(params))
    steady = sorted(secs[1:])[len(secs[1:]) // 2]
    flops = 3 * step_flops(cfg, B * S, S / 2)      # forward + backward
    res = dict(
        config=cfg.name, layers=cfg.n_layers, params=n_params, batch=B,
        seq=S, steps=steps, losses=losses, step_s=secs,
        step_s_median=steady, tokens_per_s=B * S / steady,
        first_step_s=secs[0], peak_gb=peak, peak_reserved_gb=reserved,
        held_gb=mem.held,
        launches_per_step=per_step[-1],
        launches={k: sum(n[k] for n in per_step) for k in per_step[0]},
        kernel_leaf_grads=checked, breakdown_ms=breakdown,
        train_step_bytes=train_step_bytes(cfg, B, S, 4),
        bytes_bound_s=train_step_bytes(cfg, B, S, 4) / HBM_BYTES_PER_S,
        flops=flops, flops_bound_s=flops / PEAK_FLOPS["float32"],
        remat_flops=flops * 4 / 3,
        seconds=time.perf_counter() - t_phase)
    del params, state
    _free(torch, dev)
    return res


# (e) the train step as one CUDA graph: the reduced cases at the
# trainer's defaults (batch 8 x 64, its schedule for 200 steps), remat
# off as the trainer runs them
TRAIN_GRAPH_CASES = {"plain": 1, "microbatches 2": 2}
TRAIN_GRAPH_STEPS = 5
TRAIN_GRAPH_CLI_STEPS = 8
TRAIN_GRAPH_SPREAD = 100
TRAIN_KERNELS = ("repro_flash_prefill", "repro_ssd_scan")


def _train_steps(torch, step, params, state, batches) -> dict:
    """``step`` over ``batches``: each step's loss, host seconds (from a
    synchronised card to the loss read back) and kernel launches."""
    from repro_torch.kernels import ops
    cuda = state.step.device.type == "cuda"
    losses, secs, launches = [], [], []
    for b in batches:
        before = ops.launch_counts()
        if cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, m = step(params, state, *b)
        losses.append(float(m["loss"]))           # syncs
        secs.append(time.perf_counter() - t)
        after = ops.launch_counts()
        launches.append({k: after[k] - before[k] for k in after})
    return dict(losses=losses, step_s=secs, launches=launches,
                step_ms_p50=1e3 * _pct(secs[1:], 0.5))


def _peaks(torch, dev) -> dict:
    """The allocator's peak allocated and reserved GB since its last
    reset (zeros on the CPU)."""
    if dev.type != "cuda":
        return dict(peak_gb=0.0, peak_reserved_gb=0.0)
    torch.cuda.synchronize()
    return dict(peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9)


def _run_diff(torch, got: dict, ref: dict) -> float:
    """The largest difference of two runs (``losses``, ``final``
    parameter leaves): a loss's relative, or a leaf's over that leaf's
    largest |ref|; 0 where both are bit-equal."""
    worst = max(abs(a - b) / abs(b)
                for a, b in zip(got["losses"], ref["losses"]))
    for a, b in zip(got["final"], ref["final"]):
        if not torch.equal(a, b):
            worst = max(worst, ((a - b).abs().max() / b.abs().max().clamp(
                min=1e-30)).item())
    return worst


def _bit_equal(torch, got: dict, ref: dict) -> bool:
    return got["losses"] == ref["losses"] and all(
        torch.equal(a, b) for a, b in zip(got["final"], ref["final"]))


def _graph_counts(graphs, before=None) -> dict:
    """The train kind's captures, capture seconds and replays (since
    ``before``)."""
    now = dict(captures=graphs.GRAPH_CAPTURES["train"],
               capture_s=graphs.CAPTURE_SECONDS["train"],
               replays=graphs.GRAPH_REPLAYS["train"])
    return now if before is None else {k: now[k] - before[k] for k in now}


def _full_width_graphs(torch, dev, reduced, eager, kept) -> dict:
    """(i) phase (c)'s steps as one graph: the same seed, batches and
    schedule; losses and every parameter against phase (c)'s."""
    from repro_torch import configs
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import graphs
    from repro_torch.train.data import DataConfig, synth_batch
    from repro_torch.train.graphs import compile_train_step
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.pytree import leaves
    from repro_torch.train.train_step import make_train_step

    arch = TRAIN_FULL["arch"]
    cfg = configs.get_reduced(arch) if reduced else configs.get(arch)
    B, S, steps = eager["batch"], eager["seq"], eager["steps"]
    opt = AdamWConfig(lr=TRAIN_FULL["lr"], warmup_steps=2,
                      total_steps=steps)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                      seed=0, n_patterns=2)
    batches = []
    for i in range(steps):
        toks, labels, _ = synth_batch(dcfg, i)
        batches.append((torch.from_numpy(toks).long(),
                        torch.from_numpy(labels)))
    _free(torch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         torch.float32, dev)
    state = init_state(params)
    step = compile_train_step(make_train_step(cfg, opt, remat=True))
    before = _graph_counts(graphs)
    run = _train_steps(torch, step, params, state, batches)
    run.update(_graph_counts(graphs, before), **_peaks(torch, dev))
    run["final"] = [p.detach() for p in leaves(params)]
    twin = dict(losses=eager["losses"], final=kept["params"])
    res = dict(
        config=cfg.name, layers=cfg.n_layers, batch=B, seq=S, steps=steps,
        remat=True, bit_equal=_bit_equal(torch, run, twin),
        max_diff=_run_diff(torch, run, twin),
        leaves=len(run["final"]), step_count=int(state.step),
        eager=dict(step_ms_p50=1e3 * eager["step_s_median"],
                   peak_gb=eager["peak_gb"],
                   peak_reserved_gb=eager["peak_reserved_gb"],
                   launches_per_step={k: eager["launches_per_step"][k]
                                      for k in TRAIN_KERNELS}),
        graphs={k: run[k] for k in ("step_ms_p50", "captures", "capture_s",
                                    "replays", "peak_gb",
                                    "peak_reserved_gb")},
        graph_launches={k: [n[k] for n in run["launches"]]
                        for k in TRAIN_KERNELS},
        losses=run["losses"], step_s=run["step_s"])
    del params, state, step, run, twin
    kept.clear()
    _free(torch, dev)
    cuda = dev.type == "cuda"
    counted = not cuda or (res["graphs"]["captures"],
                           res["graphs"]["replays"]) == (1, steps - 1)
    if not (res["bit_equal"] and res["step_count"] == steps and counted):
        raise AssertionError(f"full-width training as one graph against "
                             f"phase (c)'s eager run: {res}")
    for k in TRAIN_KERNELS:
        per_step = res["graph_launches"][k]
        if any(n != res["eager"]["launches_per_step"][k] for n in per_step) \
                or (cuda and not all(per_step)):
            raise AssertionError(f"full-width training as one graph: {k} "
                                 f"launched {per_step} a step, eager "
                                 f"{res['eager']['launches_per_step'][k]}")
    return res


def _within_spread(bit_equal: bool, diff: float, spread: float) -> bool:
    """A graph run against its eager twin: bit-equal where two eager
    runs are (``spread`` 0), else within ``TRAIN_GRAPH_SPREAD`` times
    their spread (an op whose accumulation order varies between runs
    makes every run diverge from the others by as much)."""
    return bit_equal or (spread > 0 and diff <= TRAIN_GRAPH_SPREAD * spread)


def _reduced_graphs(torch, dev, reduced) -> dict:
    """(ii) The five reduced architectures at the trainer's defaults,
    plain and with two microbatches: eagerly twice (inside
    ``disable_graphs``: their spread) and as one graph, from one seed
    and one set of batches."""
    from repro_torch import configs
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import graphs
    from repro_torch.train.data import DataConfig, synth_batch
    from repro_torch.train.graphs import compile_train_step
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.pytree import leaves
    from repro_torch.train.train_step import make_train_step

    # the CPU rehearsal: 3 steps at 4 x 32, for its time
    steps, B, S = (3, 4, 32) if reduced else (TRAIN_GRAPH_STEPS, 8, 64)
    opt = AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=200)
    out = {}
    for arch in TRAIN_ARCHS:
        cfg = configs.get_reduced(arch)
        dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                          global_batch=B, seed=0,
                          frontend_dim=cfg.frontend_dim,
                          n_prefix_tokens=cfg.n_prefix_tokens)
        batches = []
        for i in range(steps):
            toks, labels, prefix = synth_batch(dcfg, i)
            b = (torch.from_numpy(toks).long(), torch.from_numpy(labels))
            batches.append(b if prefix is None
                           else b + (torch.from_numpy(prefix),))
        for variant, micro in TRAIN_GRAPH_CASES.items():
            runs = {}
            for mode in ("eager", "eager again", "graphs"):
                if dev.type == "cuda":
                    torch.cuda.reset_peak_memory_stats()
                params = init_params(
                    cfg, torch.Generator(device=dev).manual_seed(0),
                    torch.float32, dev)
                state = init_state(params)
                step = compile_train_step(make_train_step(
                    cfg, opt, remat=False, microbatches=micro))
                before = _graph_counts(graphs)
                ctx = (contextlib.nullcontext() if mode == "graphs"
                       else graphs.disable_graphs())
                with ctx:
                    run = _train_steps(torch, step, params, state, batches)
                run.update(_graph_counts(graphs, before), **_peaks(torch, dev))
                run["final"] = [p.detach() for p in leaves(params)]
                runs[mode] = run
                del params, state, step
            e, e2, g = runs["eager"], runs["eager again"], runs["graphs"]
            r = dict(
                batch=B, seq=S, spread=_run_diff(torch, e2, e),
                diff=_run_diff(torch, g, e), bit_equal=_bit_equal(torch, g, e),
                **{m: {k: runs[m][k] for k in (
                    "step_ms_p50", "captures", "capture_s", "replays",
                    "peak_gb", "peak_reserved_gb")} for m in runs},
                launches_per_step={m: {k: runs[m]["launches"][-1][k]
                                       for k in TRAIN_KERNELS}
                                   for m in runs},
                losses=g["losses"])
            out[f"{arch} {variant}"] = r
            for run in runs.values():
                run.pop("final")
            ok = _within_spread(r["bit_equal"], r["diff"], r["spread"])
            cuda = dev.type == "cuda"
            counted = (not cuda or (g["captures"] == 1
                                    and g["replays"] == steps - 1))
            same = all(n == e["launches"][-1] for n in g["launches"])
            if not (ok and counted and same
                    and e["captures"] == e2["captures"] == 0):
                raise AssertionError(f"reduced {arch} {variant} as one "
                                     f"graph against eager: {r}")
    _free(torch, dev)
    return out


def _cli_resume(torch, device, reduced) -> dict:
    """(iii) ``launch/train.py --ckpt`` on reduced zamba2-1.2b at its
    defaults (``reduced``: at 4 x 32, as ``_reduced_graphs``): a run
    stopped after its checkpoint at half way (the save raises once it
    has written), resumed by a second run, against an uninterrupted run.
    Every step's loss is read from the compiled step's metrics."""
    import io
    import tempfile
    from unittest import mock

    from repro_torch.launch import train as cli
    from repro_torch.serving import graphs
    from repro_torch.train import checkpoint

    n, half = TRAIN_GRAPH_CLI_STEPS, TRAIN_GRAPH_CLI_STEPS // 2

    class _Stop(Exception):
        pass

    compile_step, save = cli.compile_train_step, checkpoint.save
    losses = []

    def recording(step_fn):
        compiled = compile_step(step_fn)

        def run(*a):
            out = compiled(*a)
            losses[-1].append(float(out[2]["loss"]))
            return out
        return run

    def stopping(d, tree, step):
        path = save(d, tree, step=step)
        if step == half:
            raise _Stop
        return path

    argv = ["--arch", TRAIN_FULL["arch"], "--steps", str(n), "--log-every",
            "1", "--ckpt-every", str(half), "--device", device]
    if reduced:
        argv += ["--batch", "4", "--seq", "32"]
    runs = {}
    with tempfile.TemporaryDirectory() as d, \
            mock.patch.object(cli, "compile_train_step", recording):
        for name, ck, saver in (("uninterrupted", "u", save),
                                ("stopped", "s", stopping),
                                ("resumed", "s", save)):
            losses.append([])
            before = _graph_counts(graphs)
            text = io.StringIO()
            with contextlib.redirect_stdout(text), \
                    mock.patch.object(checkpoint, "save", saver):
                try:
                    cli.main(argv + ["--ckpt", os.path.join(d, ck)])
                except _Stop:
                    pass
            runs[name] = dict(losses=losses[-1],
                              first_line=text.getvalue().splitlines()[0],
                              **_graph_counts(graphs, before))
    u, s, r = runs["uninterrupted"], runs["stopped"], runs["resumed"]
    res = dict(arch=TRAIN_FULL["arch"], steps=n, stopped_at=half,
               equal=s["losses"] == u["losses"][:half]
               and r["losses"] == u["losses"][half:], runs=runs)
    cuda = device != "cpu"
    if not (res["equal"] and r["first_line"] == f"[train] resumed from "
            f"step {half}" and (not cuda or all(
                x["captures"] == 1 for x in runs.values()))):
        raise AssertionError(f"launch/train.py resumed against an "
                             f"uninterrupted run: {res}")
    return res


def train_graphs(torch, eager: dict, kept: dict, device="cuda",
                 reduced=False) -> dict:
    """(e) The train step as one CUDA graph (``train/graphs.py``, the
    reference's ``jax.jit(make_train_step)``): (i) phase (c)'s 20
    full-width steps (``eager`` is its result, ``kept`` its final
    parameters) as one capture and 19 replays, losses and every
    parameter bit-equal to phase (c)'s, kernels 3 and 4 launched by every
    replay as often as eagerly; (ii) the five reduced architectures at
    the trainer's defaults, plain and with two microbatches, eager and
    as graphs (``_reduced_graphs``); (iii) a ``launch/train.py`` run
    stopped and resumed from its checkpoint against an uninterrupted
    one.  ``reduced``: phase (c)'s CPU rehearsal as ``eager``, 3 steps a
    reduced case."""
    dev = torch.device(device)
    t0 = time.perf_counter()
    from repro_torch.kernels import ops
    before = ops.launch_counts()
    res = dict(full=_full_width_graphs(torch, dev, reduced, eager, kept),
               reduced=_reduced_graphs(torch, dev, reduced),
               cli=_cli_resume(torch, device, reduced))
    after = ops.launch_counts()
    res["launches"] = {k: after[k] - before[k] for k in after}
    res["seconds"] = time.perf_counter() - t0
    return res


def print_train_graphs(res: dict, card: str) -> None:
    f = res["full"]
    e, g = f["eager"], f["graphs"]
    print(f"train graphs ({card}): {f['config']} {f['layers']} layers f32 "
          f"remat, {f['batch']} x {f['seq']}, {f['steps']} steps: step p50 "
          f"eager {e['step_ms_p50']:.2f} ms, graph {g['step_ms_p50']:.2f} "
          f"ms; {g['captures']} capture ({g['capture_s']:.2f} s, the eager "
          f"first step included), {g['replays']} replays; peak GB eager "
          f"{e['peak_gb']:.2f} (reserved {e['peak_reserved_gb']:.2f}), "
          f"graph {g['peak_gb']:.2f} (reserved {g['peak_reserved_gb']:.2f});"
          f" kernel 3 / 4 launches a step eager "
          f"{json.dumps(e['launches_per_step'])}, graph (each step) "
          f"{json.dumps(f['graph_launches'])}; losses and all "
          f"{f['leaves']} parameter leaves bit-equal {f['bit_equal']}")
    for label, r in res["reduced"].items():
        e, g = r["eager"], r["graphs"]
        print(f"train graphs ({card}): {label}, {r['batch']} x "
              f"{r['seq']}: step p50 eager "
              f"{e['step_ms_p50']:.2f} ms, graph {g['step_ms_p50']:.2f} ms;"
              f" {g['captures']} capture ({g['capture_s']:.2f} s), "
              f"{g['replays']} replays; peak GB eager {e['peak_gb']:.3f}, "
              f"graph {g['peak_gb']:.3f} (reserved "
              f"{g['peak_reserved_gb']:.3f}); launches a step "
              f"{json.dumps(r['launches_per_step']['graphs'])} (eager "
              f"{json.dumps(r['launches_per_step']['eager'])}); bit-equal "
              f"{r['bit_equal']}, max diff {r['diff']:.3g} beside the "
              f"eager-vs-eager spread {r['spread']:.3g}")
    c = res["cli"]
    print(f"train graphs ({card}): launch/train.py --ckpt, {c['arch']} "
          f"reduced, {c['steps']} steps stopped at {c['stopped_at']} and "
          f"resumed: losses equal to the uninterrupted run's {c['equal']}; "
          f"captures / replays "
          + json.dumps({k: (v["captures"], v["replays"])
                        for k, v in c["runs"].items()}))
    print("train graphs: " + json.dumps(res))


def _ring(torch, cache, W: int, n: int):
    """Ring buffers ``[L, B, KV, W, hd]`` holding positions ``max(0,
    n - W)`` .. ``n - 1`` of a dense prefill cache ``[L, B, S, KV, hd]``
    at slot p % W (the positions a windowed decode still reads)."""
    L, b, _, kv, hd = cache.shape
    ring = torch.zeros((L, b, kv, W, hd), dtype=cache.dtype,
                       device=cache.device)
    pos = torch.arange(max(0, n - W), n, device=cache.device)
    ring[:, :, :, pos % W] = cache[:, :, pos].permute(0, 1, 3, 2, 4)
    return ring


def _rel(torch, a, ref) -> float:
    return ((a.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


def serve_steps_full_width(torch, device="cuda", reduced=False) -> dict:
    """(d) ``launch/steps.py`` at the published widths, float32 weights:

    * qwen2-7b prefills 2 rows of ``W + 256`` tokens (W = its
      sliding_window, 4096) through the windowed prefill, fills ring
      buffers of width W from its cache and takes ``SERVE_NEW`` greedy
      ring-buffer decode steps.  The last logits must hold to
      ``forward(window=W)`` over the whole sequence within
      ``SERVE_STEPS_TOL`` of its largest |logit|, and differ from the
      unwindowed forward's by more than that: the ring evicted.  The
      first ``S + SERVE_NEW − W`` tokens (the ones the window drops by
      the last step) repeat one token, so what the ring evicts is one
      coherent signal and not noise that averages out;
    * zamba2-1.2b (hybrid: dense shared-attention caches) and
      mamba2-2.7b (SSM) prefill 2 rows of 1024 tokens and take
      ``SERVE_NEW`` decode steps, held the same way to ``forward``.

    ``reduced``: the reduced configs on ``device`` (CPU rehearsal)."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models.transformer import forward, init_params

    dev = torch.device(device)
    _free(torch, dev)
    t_phase = time.perf_counter()
    get = configs.get_reduced if reduced else configs.get
    before = ops.launch_counts()
    mem = _Memory(torch, dev)
    res = {}
    rng = np.random.default_rng(21)
    for arch in ("qwen2-7b", "zamba2-1.2b", "mamba2-2.7b"):
        t0 = time.perf_counter()
        cfg = get(arch)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                             torch.float32, dev)
        W = cfg.sliding_window if cfg.family == "dense" else None
        S = W + (16 if reduced else 256) if W else (40 if reduced else 1024)
        toks = rng.integers(0, cfg.vocab_size, (2, S))
        if W:
            toks[:, :S + SERVE_NEW - W] = 17
        seq = torch.from_numpy(toks).to(dev)
        lens = torch.full((2,), S, dtype=torch.int32, device=dev)
        with torch.no_grad():
            out = steps.make_prefill_step(cfg, window=W)(params, seq, lens)
            if W:
                caches = [_ring(torch, out[k], W, S)
                          for k in ("cache_k", "cache_v")]
            else:
                caches = [out["ssm_state"], out["conv_tail"]]
            if cfg.family == "hybrid":
                for k in ("cache_k", "cache_v"):
                    c = out[k]
                    caches.append(torch.cat([c, c.new_zeros(
                        c.shape[:2] + (SERVE_NEW,) + c.shape[3:])], dim=2))
            logits = out["logits"]
            del out
            dec = steps.make_decode_step(cfg, windowed=W is not None)
            for t in range(SERVE_NEW):
                nxt = logits.argmax(-1)
                seq = torch.cat([seq, nxt[:, None]], dim=1)
                lens2 = torch.full((2,), S + t + 1, dtype=torch.int32,
                                   device=dev)
                logits = dec(params, *caches, nxt, lens2)["logits"]
            del caches
            ref = forward(params, cfg, seq, window=W, remat=False)[0][:, -1]
            r = dict(config=cfg.name, layers=cfg.n_layers, prompt=S,
                     window=W, decode_steps=SERVE_NEW,
                     rel_err=_rel(torch, logits, ref),
                     greedy_equal=bool(torch.equal(logits.argmax(-1),
                                                   ref.argmax(-1))))
            if W:
                full = forward(params, cfg, seq, remat=False)[0][:, -1]
                r["rel_diff_unwindowed"] = _rel(torch, logits, full)
                del full
        del params, ref
        _free(torch, dev)
        r["seconds"] = time.perf_counter() - t0
        res[arch] = r
        if not (np.isfinite(r["rel_err"]) and r["rel_err"] < SERVE_STEPS_TOL
                and r.get("rel_diff_unwindowed", 1.0) > SERVE_STEPS_TOL):
            raise AssertionError(f"serve steps of {cfg.name} against "
                                 f"forward: {r} (tolerance "
                                 f"{SERVE_STEPS_TOL})")
    after = ops.launch_counts()
    return dict(models=res, peak_gb=mem.fold(),
                launches={k: after[k] - before[k] for k in after},
                seconds=time.perf_counter() - t_phase)


def print_training(grads: list, reduced: dict, full: dict, served: dict,
                   card: str) -> None:
    """The training and serve-step phases' lines, each with the card."""
    for g in grads:
        print(f"kernel gradients [{g['label']}] ({card}): Function fwd+bwd "
              f"{g['ms']:.3f} ms beside plain fwd+bwd {g['plain_ms']:.3f} "
              f"ms (bound {g['bound_ms']:.4f} ms, {g['bound_by']}); "
              f"forward max |Δ| {[f'{e:.3g}' for e in g['fwd_max_abs_err']]}"
              f" <= {[f'{t:.3g}' for t in g['fwd_tolerance']]}; max "
              f"|Δgrad| / max|plain grad| {g['max_rel_err']:.3g} <= "
              f"{g['tolerance']}")
    print("reduced training, card vs CPU: " + json.dumps(reduced))
    f = full
    print(f"full-width training ({card}): {f['config']} {f['layers']} "
          f"layers, {f['params'] / 1e9:.3f} B params f32, batch "
          f"{f['batch']} x {f['seq']}, remat: loss {f['losses'][0]:.4f} -> "
          f"{sum(f['losses'][-5:]) / 5:.4f} (mean of the last 5 of "
          f"{f['steps']}); step {f['step_s_median']:.3f} s (first "
          f"{f['first_step_s']:.2f} s), {f['tokens_per_s']:.0f} tokens/s, "
          f"peak {f['peak_gb']:.2f} GB; beside train_step_bytes / 3.35 "
          f"TB/s {f['bytes_bound_s']:.4f} s and 3 x forward flops / 67 "
          f"TFLOP/s (f32) {f['flops_bound_s']:.4f} s; launches a step "
          f"{json.dumps(f['launches_per_step'])}")
    parts = {k: round(v, 3) for k, v in f["breakdown_ms"].items()}
    print(f"full-width training step, device ms by part ({card}): "
          + json.dumps(parts))
    print("full-width training: " + json.dumps(full))
    for r in served["models"].values():
        extra = (f", unwindowed forward differs by "
                 f"{r['rel_diff_unwindowed']:.4f}"
                 if "rel_diff_unwindowed" in r else "")
        win = f", window {r['window']}" if r["window"] else ""
        print(f"serve steps at full width ({card}): {r['config']} prompt "
              f"{r['prompt']}{win}, {r['decode_steps']} decode steps: "
              f"last logits vs "
              f"forward {r['rel_err']:.3g} of the largest (< "
              f"{SERVE_STEPS_TOL}){extra}; {r['seconds']:.1f} s")
    print("serve steps: " + json.dumps(served))


# ---------------------------------------------------------------------------
# 12. the lowering tools held against the card
# ---------------------------------------------------------------------------
# (arch, shape, batch): each pair's global batch is cut, never its width
# or its context
LOWERING_PAIRS = (
    ("qwen2-7b", "prefill_32k", 1),       # kernel 3 at S = 32768
    ("mamba2-2.7b", "prefill_32k", 1),    # kernel 4 at S = 32768
    ("qwen2-7b", "decode_32k", 8),        # ~15 GB of cache
    ("zamba2-1.2b", "long_500k", None),   # hybrid windowed decode
    ("zamba2-1.2b", "train_4k", 2),       # one AdamW step, kernels 3 and 4
)
# a serve pair's measured peak must stay within 1.1 × predicted + 1 GiB:
# the plain blocked attention on meta holds more than kernels 3 and 4
LOWERING_PEAK = (1.1, 2 ** 30)
LOWERING_LAUNCH = {"prefill_32k": {"qwen2-7b": ("repro_flash_prefill",),
                                   "mamba2-2.7b": ("repro_ssd_scan",)},
                   "train_4k": {"zamba2-1.2b": ("repro_flash_prefill",
                                                "repro_ssd_scan")}}
# the CPU rehearsal's contexts (reduced widths)
LOWERING_REDUCED_SEQ = {"train_4k": 64, "prefill_32k": 64,
                        "decode_32k": 64, "long_500k": 128}


@contextlib.contextmanager
def _reduced_lowering():
    """The lowering builders on the reduced configs at the rehearsal's
    contexts (``LOWERING_REDUCED_SEQ``)."""
    import dataclasses
    from unittest import mock
    from repro_torch import configs
    from repro_torch.launch import specs
    shapes = {k: dataclasses.replace(v, seq_len=LOWERING_REDUCED_SEQ[k])
              for k, v in specs.SHAPES.items()}
    with mock.patch.object(specs, "SHAPES", shapes), \
            mock.patch.object(configs, "get", configs.get_reduced):
        yield


def _lowering_args(torch, low, gen, dev) -> list:
    """The abstract arguments of ``low`` on ``dev`` at their dtypes:
    weights from ``init_params`` (its scales keep the activations finite
    through full depth), AdamW state from ``init_state``, caches and
    prefix embeddings normal × 0.1, tokens, labels and last tokens
    uniform over the vocabulary, and ``lens`` the shape's context (a
    decode's new token at the cache's last position)."""
    from repro_torch.launch import specs
    from repro_torch.models.transformer import init_params
    from repro_torch.train.optimizer import init_state
    cfg = low.cfg
    params = init_params(cfg, gen, dtype=torch.bfloat16, device=dev)

    def like(t):
        if t.dtype.is_floating_point:
            return torch.randn(t.shape, generator=gen, dtype=t.dtype,
                               device=dev).mul_(0.1)
        return torch.randint(0, cfg.vocab_size, t.shape, generator=gen,
                             dtype=t.dtype, device=dev)

    def full(t, n):
        return torch.full(t.shape, n, dtype=t.dtype, device=dev)
    if low.kind == "train":
        return [params, init_state(params)] + [like(t) for t in low.args[2:]]
    if low.kind == "prefill":
        toks = like(low.args[1])
        return [params, toks, full(low.args[2], toks.shape[1])] + \
            [like(t) for t in low.args[3:]]
    *caches, last, lens = low.args[1:]
    return [params] + [like(c) for c in caches] + \
        [like(last), full(lens, specs.SHAPES[low.shape].seq_len)]


def _tensor_table(tree) -> list:
    """[(path, shape, dtype)] of a tree's tensors in JAX's leaf order."""
    from repro_torch.train.pytree import flatten_with_path, path_str
    return [(path_str(p), tuple(t.shape), str(t.dtype).split(".")[-1])
            for p, t in flatten_with_path(tree) if hasattr(t, "shape")]


def _unique_bytes(tree) -> int:
    from repro_torch.train.pytree import leaves
    seen = {}
    for t in leaves(tree):
        if hasattr(t, "untyped_storage"):
            st = t.untyped_storage()
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def check_lowering(torch, device="cuda", reduced=False) -> dict:
    """12. The dry-run's accounting held against the card on the 1×1 host
    mesh, for each of ``LOWERING_PAIRS``: the lowering dry-runs on meta
    (``launch/dryrun.predict``, depth extrapolated); its arguments are
    materialized on the card from a seeded generator; the step runs once
    with the kernels on, timed with CUDA events, the allocator's peak
    read over it, then once more, warm, for its time alone.  The argument bytes must equal the prediction's, the
    outputs' shapes and dtypes too, every output must be finite, the
    pair's kernels must launch, and a serve pair's peak must stay within
    ``LOWERING_PEAK`` of the predicted one (the train pair's ratio is
    printed: the kernels' plain VJPs hold S × S scores, the reference's
    blocked backward never does).  ``reduced``: the reduced configs at
    short contexts on ``device`` (the CPU rehearsal)."""
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import predict
    from repro_torch.launch.mesh import make_host_mesh
    dev = torch.device(device)
    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    own_world = not dist.is_initialized()      # the mesh brings one up
    rows, launches = {}, {k: 0 for k in ops.launch_counts()}
    with (_reduced_lowering() if reduced else contextlib.nullcontext()):
        mesh = make_host_mesh(device)
        for arch, shape, batch in LOWERING_PAIRS:
            _free(torch, dev)
            t0 = time.perf_counter()
            pred = predict(arch, shape, mesh, batch=batch)
            an, low = pred.analysis, pred.low
            predict_s = time.perf_counter() - t0
            gen = torch.Generator(device=dev).manual_seed(0)
            args = _lowering_args(torch, low, gen, dev)
            if _tensor_table(args) != _tensor_table(low.args):
                raise AssertionError(f"lowering {arch} x {shape}: the "
                                     f"materialized arguments differ from "
                                     f"the abstract ones")
            arg_bytes = _unique_bytes(args)
            mem = _Memory(torch, dev)
            ops.reset_launch_counts()
            out, step_ms = _timed_step(torch, low.step_fn, args, cuda)
            n = ops.launch_counts()
            peak = int(mem.fold() * 1e9)
            for k in launches:
                launches[k] += n[k]
            got = _tensor_table(out)
            finite = all(bool(torch.isfinite(x).all())
                         for x in _leaves_of(out) if x.is_floating_point())
            # a second, warm call on the same arguments (a decode rewrites
            # its token's cache row, a train step takes one more AdamW
            # step): the first carries the allocator's growth and the
            # libraries' first use
            del out
            warm_ms = _timed_step(torch, low.step_fn, args, cuda)[1]
            key = f"{arch} x {shape}" + (f" (batch {batch})" if batch
                                         else "")
            bound = LOWERING_PEAK[0] * an.peak_bytes + LOWERING_PEAK[1]
            row = dict(
                depths=list(pred.depths), units=pred.units,
                predict_s=predict_s, step_ms=step_ms, warm_ms=warm_ms,
                flops_predicted=an.costs.flops,
                bytes_predicted=an.costs.bytes,
                argument_bytes=arg_bytes,
                argument_bytes_predicted=an.argument_bytes,
                peak_bytes=peak, peak_bytes_predicted=an.peak_bytes,
                peak_ratio=peak / an.peak_bytes,
                outputs_equal=got == list(an.outputs), finite=finite,
                launches={k: v for k, v in n.items() if v})
            rows[key] = row
            del args
            if arg_bytes != an.argument_bytes:
                raise AssertionError(f"lowering {key}: argument bytes "
                                     f"{arg_bytes} != predicted "
                                     f"{an.argument_bytes}")
            if got != list(an.outputs):
                raise AssertionError(f"lowering {key}: outputs {got} != "
                                     f"predicted {an.outputs}")
            if not finite:
                raise AssertionError(f"lowering {key}: non-finite output")
            for k in LOWERING_LAUNCH.get(shape, {}).get(arch, ()):
                if cuda and not n[k]:
                    raise AssertionError(f"lowering {key}: {k} never "
                                         f"launched")
            if cuda and low.kind != "train" and peak > bound:
                raise AssertionError(
                    f"lowering {key}: peak {peak} B > {LOWERING_PEAK[0]} "
                    f"x predicted {an.peak_bytes} B + 1 GiB")
    if own_world:
        dist.destroy_process_group()
    _free(torch, dev)
    return dict(pairs=rows, launches=launches,
                seconds=time.perf_counter() - t_phase)


def _timed_step(torch, fn, args, cuda: bool):
    """(``fn(*args)``, its ms): CUDA events on the card, the host's clock
    on the CPU."""
    if cuda:
        ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
        ev[0].record()
    t = time.perf_counter()
    out = fn(*args)
    if cuda:
        ev[1].record()
        torch.cuda.synchronize()
        return out, ev[0].elapsed_time(ev[1])
    return out, 1e3 * (time.perf_counter() - t)


def _leaves_of(tree) -> list:
    from repro_torch.train.pytree import leaves
    return [t for t in leaves(tree) if hasattr(t, "is_floating_point")]


def print_lowering(res: dict, card: str) -> None:
    for key, r in res["pairs"].items():
        gflop = r["flops_predicted"] / 1e9
        print(f"lowering phase ({card}): {key}: depths {r['depths']} x "
              f"{r['units']} units, predicted in {r['predict_s']:.1f} s; "
              f"step {r['step_ms']:.1f} ms cold, {r['warm_ms']:.1f} ms "
              f"warm, beside {gflop:.1f} GFLOP predicted; "
              f"args {r['argument_bytes']} B == predicted; peak "
              f"{r['peak_bytes'] / 2**30:.2f} GiB vs predicted "
              f"{r['peak_bytes_predicted'] / 2**30:.2f} GiB (ratio "
              f"{r['peak_ratio']:.3f}); outputs equal, finite; launches "
              f"{json.dumps(r['launches'])}")
    print(f"lowering phase: {res['seconds']:.1f} s")


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
    gate_chunk = check_gate_chunk(torch, np, full)
    print(f"check [{gate_chunk['shapes']}] chunk: " + json.dumps(gate_chunk))
    r = checks[full["label"]]["chunk"]
    print(f"kernel 2 at the reconfiguration gate's chunk: "
          f"{gate_chunk['ms']:.4f} ms (bound {gate_chunk['bound_ms']:.5f}, "
          f"{gate_chunk['bound_by']}) beside {r['ms']:.4f} ms (bound "
          f"{r['bound_ms']:.5f}) at 8 rows x 64 queries; max abs err "
          f"{gate_chunk['max_abs_err']:.4g} <= {gate_chunk['tolerance']}")
    # what the compiled decode kernels get on this card: CTAs an SM,
    # shared memory, registers (the bf16 body at each head dim, with one
    # and two 8-head halves of its m16 tile)
    from repro_torch.kernels import decode_splits
    occ = {f"{src} bf16 hd {hd} group {g}": decode_splits.occupancy(
               src, hd, torch.bfloat16, g)
           for src in ("paged_decode.cu", "paged_decode_int8.cu")
           for hd in (64, 96, 128) for g in (8, 16)}
    print("decode occupancy: " + json.dumps(occ))

    ssd = {s["label"]: check_ssd(torch, {**s,
                                         "dtype": getattr(torch, s["dtype"])})
           for s in SSD_SHAPES}
    for label, r in ssd.items():
        print(f"check [{label}] ssd_scan: " + json.dumps(r))
    moe_checks = {s["label"]: check_moe(torch, {
        **s, "dtype": getattr(torch, s["dtype"])}) for s in MOE_SHAPES}
    for label, r in moe_checks.items():
        print(f"check [{label}] grouped_swiglu: " + json.dumps(r))
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
            must_launch=("repro_paged_decode", "repro_paged_prefill",
                         "repro_moe_grouped"))),
        # qwen3-moe at full width, 4 of 94 layers: 128 experts of 4096 x
        # 1536 a layer, group 16 at head_dim 128
        ("MoE B: qwen3-moe-235b-a22b (4 of 94 layers), chunked", dict(
            archs=["qwen3-moe-235b-a22b"], chunk_tokens=64, n_target=8,
            seed=5, pool_blocks=65536, depth={"qwen3-moe-235b-a22b": 4},
            must_launch=("repro_paged_decode", "repro_paged_prefill",
                         "repro_moe_grouped"))),
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
    compiled = serve_graphs(torch)
    print_graphs(compiled, card)
    graph_steps = serve_graph_steps(torch)
    print_graph_steps(graph_steps, card)

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
    prefix = serve_prefix(torch)
    print_prefix(prefix, card)
    recfg = serve_reconfig(torch)
    print_reconfig(recfg, card)

    t0 = time.perf_counter()
    grads = [check_grads(torch, s) for s in GRAD_SHAPES]
    print(f"phase (a) kernel gradients: {time.perf_counter() - t0:.1f} s")
    reduced_train = train_reduced_match(torch)
    print(f"phase (b) reduced training, card vs CPU: "
          f"{reduced_train['seconds']:.1f} s")
    kept = {}
    full_train = train_full_width(torch, keep=kept)
    print(f"phase (c) full-width training: {full_train['seconds']:.1f} s")
    train_graph = train_graphs(torch, full_train, kept)
    print(f"phase (e) train graphs: {train_graph['seconds']:.1f} s")
    steps_served = serve_steps_full_width(torch)
    print(f"phase (d) serve steps at full width: "
          f"{steps_served['seconds']:.1f} s")
    print_training(grads, reduced_train, full_train, steps_served, card)
    print_train_graphs(train_graph, card)
    lowering = check_lowering(torch)
    print_lowering(lowering, card)

    runs = list(served.values()) + [compiled, graph_steps, placed, w8,
                                    stream, chaos,
                                    prefix, recfg,
                                    reduced_train, full_train, train_graph,
                                    steps_served, lowering]
    launches = {k.symbol: sum(r["launches"][k.symbol] for r in runs)
                for k in ops.path_kernels()}
    # kernel 6's launches by layer shape and slot count: the MoE serve
    # phases and graph steps runs (v) and (vi), both modes
    moe_by_slots = Counter()
    for r in served.values():
        moe_by_slots.update(r["moe_launches_by_slots"])
    for r in graph_steps["runs"].values():
        for mode in ("eager", "graphs"):
            moe_by_slots.update(r[mode]["moe_launches_by_slots"])
    moe_by_slots = dict(sorted(moe_by_slots.items()))
    print(f"kernel 6 launches by layer shape and slot count ({card}; MoE "
          f"serve phases and graph steps (v), (vi)): "
          + json.dumps(moe_by_slots))
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
            main_shape, *others = SSD_SHAPES
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
        if k.symbol == "repro_moe_grouped":
            main_shape, *others = MOE_SHAPES
            rows.append({
                "name": "grouped_swiglu", **base,
                "launches_by_slots": moe_by_slots,
                **moe_checks[main_shape["label"]],
                "kernel_ms": moe_checks[main_shape["label"]]["ms"],
                "shapes": main_shape["label"],
                "other_shapes": [{"shapes": o["label"],
                                  **moe_checks[o["label"]]} for o in others]})
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
            **({"gate_chunk": gate_chunk} if key == "chunk" else {}),
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
