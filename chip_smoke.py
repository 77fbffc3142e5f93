#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py

1. builds the three Hopper attention kernels from ``src/repro_torch/
   kernels/csrc`` (one nvcc per source, in parallel);
2. holds each kernel against its plain PyTorch version at the serving
   path's shapes — full-width qwen2-7b (bf16, head_dim 128) and the
   reduced CPU-test model (f32, head_dim 64) — and times the kernel,
   the plain version, one PyTorch library call over the same work
   (scaled_dot_product_attention on gathered K/V, a yardstick only)
   and the card's bound for the work;
3. checks the serving steps on the card against the same steps on the
   CPU (plain versions) on the reduced model, and that both serve a
   small trace to the same report;
4. serves two colocated full-width qwen2-7b (random bf16 weights) with
   the fused chunked-prefill ADBS loop under the logical clock, then
   one with whole-prompt prefill, counting kernel launches in each.

Any failed phase raises and the script exits non-zero.  The last two
lines of standard output are the card (name, power limit) and a JSON
object; the line before them lists the kernels' numbers as JSON.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core bf16
              "float32": 67e12}    # f32 outside the tensor cores
TOL = {"bfloat16": 2e-2, "float32": 1e-4}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 25) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each after
    an L2 flush (the serving loop streams weights between attention
    calls, so the kernels find L2 cold)."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
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


def bound_ms(n_bytes: float, flops: float, dtype_name: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


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
    q4 = q[:, :, None, :]
    tok = int(lens.sum())
    b, why = bound_ms(2 * rows * H * hd * es + 2 * tok * KV * hd * es
                      + phys.numel() * 4 + rows * 4, 4 * tok * H * hd, dname)
    res["decode"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: pa.fused_paged_decode_attention(
            q, pool_k, pool_v, phys, seq)),
        plain_ms=time_ms(torch, lambda: pa.decode_plain(
            q, pool_k, pool_v, phys, seq)),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, kg, vg, attn_mask=mask)),
        bound_ms=b, bound_by=why)
    del kg, vg

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
    b, why = bound_ms(2 * q.numel() * es + 2 * keys * KV * hd * es
                      + phys.numel() * 4 + rows * 4, 4 * pairs * H * hd, dname)
    res["chunk"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: fp.fused_paged_flash_prefill(
            q, pool_k, pool_v, phys, qo)),
        plain_ms=time_ms(torch, lambda: fp.paged_prefill_plain(
            q, pool_k, pool_v, phys, qo)),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kg, vg, attn_mask=mask)),
        bound_ms=b, bound_by=why)
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
    b, why = bound_ms((2 * q.numel() + 2 * k.numel()) * es,
                      4 * B * H * hd * S * (S + 1) // 2, dname)
    res["flash"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: fp.flash_prefill(q, k, v)),
        plain_ms=time_ms(torch, lambda: fp.flash_prefill_plain(q, k, v)),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        bound_ms=b, bound_by=why)
    for name, r in res.items():
        if not r["max_abs_err"] <= TOL[dname]:
            raise AssertionError(f"{name} kernel disagrees with its plain "
                                 f"version at {shape['label']}: "
                                 f"{r['max_abs_err']} > {TOL[dname]}")
        r["tolerance"] = TOL[dname]
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


def serve_full_width(torch, n_models: int, chunk_tokens: int, n_target: int,
                     seed: int, must_launch) -> dict:
    """Serve ``n_models`` colocated full-width qwen2-7b (random bf16
    weights) under the logical clock; every request must finish, the
    pool must be freed and each kernel of ``must_launch`` must have
    launched in this run (every step's logits are checked finite by
    ``engine.greedy_tokens``, which raises otherwise).  Returns the
    run's numbers and launch counts."""
    from repro_torch.core.workload import synthesize
    from repro_torch.kernels import ops
    from repro_torch.serving import driver

    names = [f"qwen2-7b#{i}" for i in range(n_models)]
    # ~n_target requests: power-law rates (α 2.1) over a 1.6 s window
    wl = synthesize(names, alpha=2.1, max_rate=n_target / 2.0, horizon=1.6,
                    seed=seed, mean_prompt=256, mean_output=40, max_len=512)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    unit = driver.build_unit_from_specs(
        [(n, "qwen2-7b", wl.rates[n]) for n in names], pool_blocks=16384,
        max_slots=4, chunk_tokens=chunk_tokens, seed=seed, policy="adbs",
        fused=True, reduced=False, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
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
    res = dict(models=n_models, chunk_tokens=chunk_tokens,
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

    full = dict(label="qwen2-7b full width bf16", dtype=torch.bfloat16, H=28,
                KV=4, hd=128, layers=28, rows=8, max_blocks=64, C=64, S=512,
                flash_rows=4)
    small = dict(label="qwen2-7b reduced f32", dtype=torch.float32, H=4,
                 KV=2, hd=64, layers=2, rows=8, max_blocks=64, C=16, S=64,
                 flash_rows=4)
    checks = {s["label"]: check_kernels(torch, np, s) for s in (full, small)}
    for label, res in checks.items():
        for name, r in res.items():
            print(f"check [{label}] {name}: " + json.dumps(r))

    print(reduced_steps_match(torch, np))

    fused = serve_full_width(torch, n_models=2, chunk_tokens=64,
                             n_target=16, seed=0,
                             must_launch=("repro_paged_decode",
                                          "repro_paged_prefill"))
    print("fused chunked serve: " + json.dumps(
        {k: v for k, v in fused.items() if k != "summary"}))
    for line in fused["summary"].splitlines():
        print(f"  {line}")
    whole = serve_full_width(torch, n_models=1, chunk_tokens=0,
                             n_target=8, seed=1,
                             must_launch=("repro_paged_decode",
                                          "repro_flash_prefill"))
    print("whole-prompt serve: " + json.dumps(
        {k: v for k, v in whole.items() if k != "summary"}))
    for line in whole["summary"].splitlines():
        print(f"  {line}")
    print("every served step had finite logits (engine.greedy_tokens "
          "raises otherwise); every request finished; pools freed")

    launches = {
        "repro_paged_decode": (fused["launches"]["repro_paged_decode"]
                               + whole["launches"]["repro_paged_decode"]),
        "repro_paged_prefill": fused["launches"]["repro_paged_prefill"],
        "repro_flash_prefill": whole["launches"]["repro_flash_prefill"],
    }
    kernel_names = {"repro_paged_decode": ("fused_paged_decode_attention",
                                           "decode"),
                    "repro_paged_prefill": ("fused_paged_flash_prefill",
                                            "chunk"),
                    "repro_flash_prefill": ("flash_prefill", "flash")}
    rows = []
    for k in ops.path_kernels():
        name, key = kernel_names[k.symbol]
        r = checks[full["label"]][key]
        s = checks[small["label"]][key]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{k.source}",
            "replaces": k.replaces, "launches": launches[k.symbol],
            "max_abs_err": r["max_abs_err"], "tolerance": r["tolerance"],
            "ms": r["ms"], "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "shapes": full["label"],
            "reduced": {"shapes": small["label"], **s}})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
