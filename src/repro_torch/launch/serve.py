"""Multi-LLM SLO-attainment serving over real colocated engines (port of
``repro/launch/serve.py``, the subset the ported families support:
dense, SSM and hybrid).

Colocates the requested architectures' reduced variants on one unified
KV pool, replays a popularity-skewed Poisson workload
(``core/workload.py``) and reports per-LLM and aggregate TTFT/TPOT/E2E
percentiles, goodput and SLO attainment.  Runs on the GPU by default (``--device cuda``, random bf16
weights); ``--device cpu`` runs the plain versions of the kernels in
f32.

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --archs qwen2-7b,mamba2-2.7b --policy adbs --fused \\
      --chunk-tokens 16 --rate 2.0 --horizon 8 --deterministic
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch import resolve_device
from repro_torch.core.workload import poisson_trace, power_law_rates
from repro_torch.kernels import ops
from repro_torch.serving.driver import (TickCostModel, build_unit_from_specs,
                                        serve_workload)
from repro_torch.serving.engine import TRACE_COUNTS, unique_tree_bytes


def _unit_names(archs):
    """Unit-unique engine names: repeated archs get a ``#i`` tag."""
    return [a if archs.count(a) == 1 else f"{a}#{i}"
            for i, a in enumerate(archs)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="SLO-attainment serving over real colocated engines "
                    "(PyTorch/CUDA port)")
    ap.add_argument("--archs", default="qwen2-7b,mamba2-2.7b",
                    help="comma list of architectures to colocate "
                         "(repeat one to colocate instances)")
    ap.add_argument("--policy", default="adbs",
                    choices=["adbs", "fcfs", "round_robin"])
    ap.add_argument("--alpha", type=float, default=2.1,
                    help="power-law exponent of per-LLM rates")
    ap.add_argument("--rate", type=float, default=2.0,
                    help="max per-LLM arrival rate (req/s)")
    ap.add_argument("--horizon", type=float, default=8.0,
                    help="arrival-window length (s)")
    ap.add_argument("--mean-prompt", type=int, default=24)
    ap.add_argument("--mean-output", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=0,
                    help="hard cap on output tokens (0 = uncapped)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk-tokens", type=int, default=0,
                    help="chunked prefill window (0 = whole-prompt jobs)")
    ap.add_argument("--fused", action="store_true",
                    help="fused multi-LLM tick (one sweep per phase for "
                         "same-architecture engines)")
    ap.add_argument("--slo-scales", default="2,4,6,8,12,16",
                    help="comma list of SLO scale factors")
    ap.add_argument("--deterministic", action="store_true",
                    help="logical tick-cost clock instead of wall time")
    ap.add_argument("--pool-blocks", type=int, default=200_000)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the Hopper kernels) or cpu")
    ap.add_argument("--report", default=None, metavar="OUT_JSON",
                    help="write the full ServeReport JSON here")
    args = ap.parse_args(argv)

    for flag, v in [("--rate", args.rate), ("--horizon", args.horizon),
                    ("--alpha", args.alpha),
                    ("--pool-blocks", args.pool_blocks),
                    ("--max-slots", args.max_slots),
                    ("--mean-prompt", args.mean_prompt),
                    ("--mean-output", args.mean_output)]:
        if v <= 0:
            ap.error(f"{flag} must be > 0 (got {v})")
    for flag, v in [("--chunk-tokens", args.chunk_tokens),
                    ("--max-new", args.max_new)]:
        if v < 0:
            ap.error(f"{flag} must be >= 0 (got {v})")
    try:
        slo_scales = tuple(float(s) for s in args.slo_scales.split(","))
    except ValueError:
        ap.error(f"--slo-scales could not be parsed: {args.slo_scales!r}")
    if any(s <= 0 for s in slo_scales):
        ap.error(f"--slo-scales entries must be > 0: {args.slo_scales!r}")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32

    archs = args.archs.split(",")
    names = _unit_names(archs)
    rates = power_law_rates(names, args.alpha, args.rate)
    try:
        unit = build_unit_from_specs(
            [(n, a, rates[n]) for n, a in zip(names, archs)],
            pool_blocks=args.pool_blocks, max_slots=args.max_slots,
            chunk_tokens=args.chunk_tokens, seed=args.seed,
            policy=args.policy, fused=args.fused, dtype=dtype,
            device=device)
    except ValueError as e:
        ap.error(str(e))
    for g in unit.fused_groups:
        print(f"[serve] fused group ({len(g.engines)} engines): "
              f"{[e.cfg.name for e in g.engines]}, "
              f"{'fused' if g.chunk_tokens else 'serial'} prefill, "
              f"{g.weight_bytes() / 1e6:.1f} MB shared weights")
    if unit.reclaimed_weight_bytes:
        print(f"[serve] weight de-dup reclaimed "
              f"{unit.reclaimed_weight_bytes / 1e6:.1f} MB → pool grew to "
              f"{unit.pool.n_head_blocks} head-blocks")

    wl = poisson_trace(rates, args.horizon, seed=args.seed,
                       mean_prompt=args.mean_prompt,
                       mean_output=args.mean_output)
    print(f"[serve] {len(wl.requests)} requests over {args.horizon}s for "
          f"{len(rates)} LLMs (α={args.alpha}), policy={args.policy}, "
          f"fused={args.fused}, device={device}, "
          f"clock={'logical' if args.deterministic else 'wall'}")
    cost = TickCostModel() if args.deterministic else None
    ops.reset_launch_counts()
    report = serve_workload([unit], wl, seed=args.seed,
                            max_new_cap=args.max_new,
                            slo_scales=slo_scales, cost=cost)

    agg = report.aggregate
    print(f"[serve] finished {agg.finished}/{agg.submitted} over "
          f"{report.ticks} ticks in {report.wall_s:.1f}s wall")
    for line in report.summary().splitlines():
        print(f"[serve] {line}")
    pool = unit.pool
    print(f"[serve] pool: free={pool.allocator.free_blocks}"
          f"/{pool.n_head_blocks} head-blocks")
    for name, view in pool.views.items():
        print(f"[serve]   {name}: quota={view.quota} used={view.used}")
    print(f"[serve] memory: "
          f"{unique_tree_bytes([e.params for e in unit.engines.values()]) / 1e6:.1f}"
          f" MB weights (de-duplicated), {pool.hbm_bytes() / 1e6:.0f} MB "
          f"pool arena")
    print(f"[serve] shape buckets by step: {dict(TRACE_COUNTS)}")
    if device.type == "cuda":
        print(f"[serve] kernel launches: {ops.launch_counts()}")
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report.to_json(), f, indent=1)
        print(f"[serve] report JSON → {args.report}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
