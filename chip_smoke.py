#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py

1. builds the four Hopper kernels (three attention kernels and the
   Mamba2 SSD scan) from ``src/repro_torch/kernels/csrc`` (one nvcc per
   source, in parallel);
2. holds each kernel against its plain PyTorch version at the serving
   path's shapes — full-width qwen2-7b (bf16, head_dim 128) and the
   reduced CPU-test model (f32, head_dim 64) for attention; the
   mamba2-2.7b chunk step, a zamba2-1.2b whole-prompt bucket and a
   reduced ragged f32 case for the SSD scan — and times the kernel,
   the plain version, one PyTorch library call over the same work
   where one exists (scaled_dot_product_attention on gathered K/V, a
   yardstick only; none computes SSD) and the card's bound for the
   work;
3. checks the serving steps on the card against the same steps on the
   CPU (plain versions) on the reduced models (qwen2-7b; the SSM
   chunk, prefill and decode steps of mamba2-2.7b and zamba2-1.2b), and
   that both devices serve a small qwen2 trace to the same report;
4. serves two colocated full-width qwen2-7b (random bf16 weights) with
   the fused chunked-prefill ADBS loop under the logical clock, then
   one with whole-prompt prefill; then the JAX CLI's default pair,
   full-width qwen2-7b + mamba2-2.7b (chunked, ADBS, serial: no
   fusable pair), and full-width zamba2-1.2b with whole-prompt prefill,
   counting kernel launches in each.

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


def check_ssd(torch, shape: dict) -> dict:
    """Hold the SSD-scan kernel against its plain version at one shape;
    returns its numbers.  No single PyTorch call computes SSD, so there
    is no library yardstick (``library_ms`` null)."""
    from repro_torch.kernels import ssd_scan as ss
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
    res = dict(max_abs_err=errs[0], tolerance=tols[0],
               state_max_abs_err=errs[1], state_tolerance=tols[1],
               tolerance_rel=rel,
               ms=time_ms(torch, lambda: ss.ssd_scan(x, dt, a_log, B, C,
                                                     d_skip, Q, st)),
               plain_ms=time_ms(torch, lambda: ss.ssd_plain(
                   x, dt, a_log, B, C, d_skip, Q, st)),
               library_ms=None, bound_ms=bnd, bound_by=why,
               bytes=n_bytes, flops=flops)
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

    ssd_shapes = [
        dict(label="mamba2-2.7b chunk step bf16", dtype=torch.bfloat16, b=4,
             S=64, chunk=64, H=80, G=1, N=128, init=True),
        dict(label="zamba2-1.2b whole-prompt bucket bf16",
             dtype=torch.bfloat16, b=2, S=512, chunk=256, H=64, G=1, N=64,
             init=False),
        dict(label="reduced f32, 2 groups, ragged chunk", dtype=torch.float32,
             b=2, S=72, chunk=32, H=8, G=2, N=16, init=True),
    ]
    ssd = {s["label"]: check_ssd(torch, s) for s in ssd_shapes}
    for label, r in ssd.items():
        print(f"check [{label}] ssd_scan: " + json.dumps(r))

    print(reduced_steps_match(torch, np))
    print(reduced_ssm_steps_match(torch, np))

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

    launches = {k.symbol: sum(r["launches"][k.symbol]
                              for r in served.values())
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
            main_shape, *others = ssd_shapes
            r = ssd[main_shape["label"]]
            rows.append({
                "name": "ssd_scan", **base, **r, "kernel_ms": r["ms"],
                "shapes": main_shape["label"],
                "other_shapes": [{"shapes": o["label"], **ssd[o["label"]]}
                                 for o in others]})
            continue
        name, key = attn_names[k.symbol]
        r = checks[full["label"]][key]
        s = checks[small["label"]][key]
        rows.append({
            "name": name, **base,
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
