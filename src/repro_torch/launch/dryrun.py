"""Multi-pod dry-run: run every (arch × shape × mesh) on placeholder
devices (port of ``repro/launch/dryrun.py``).

Proves the distribution config is coherent without the hardware: the
step runs on ``DTensor``s over 256 or 512 placeholder ranks
(``launch/mesh.py``), their local tensors on ``meta``, and
``launch/op_analysis.py`` reads per device the FLOPs, bytes and
collective traffic, and the argument, output and peak live bytes.

Depth: a step is a Python loop over its layers, so it runs at the
repeating unit u (one layer; ``attn_every`` Mamba2 layers and the
shared block for the hybrid) and at 2u, each with the remainder layers
r (zamba2: 38 = 6·6 + 2), and every count at the full depth L = n·u + r
is ``c(u + r) + (n − 1)·(c(2u + r) − c(u + r))``.  The reference counts
its scan bodies times their trip counts; a full-depth eager run of the
blocked attention at 32k would take minutes a pair.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes] [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch import configs
from repro_torch.config import SHAPES, ModelConfig
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_analysis import Analysis, Costs, analyze
from repro_torch.launch.specs import (Lowering, all_pairs,
                                      build_lowering, build_quantized_decode)
from repro_torch.models.layers import use_mesh


def unit_depths(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(u + r, 2u + r, n): the two depths the dry-run runs and the
    number of repeating units in the full depth."""
    if cfg.family == "hybrid":
        u = cfg.attn_every
        n, r = divmod(cfg.n_layers, u)
    else:
        u, n, r = 1, cfg.n_layers, 0
    return u + r, 2 * u + r, n


def _build(arch: str, shape: str, mesh, variant: str, batch, n_layers):
    build = build_quantized_decode if variant == "w8kv8" else build_lowering
    return build(arch, shape, mesh, batch=batch, n_layers=n_layers)


def run_lowering(low: Lowering, mesh, keep_ops: bool = False) -> Analysis:
    """One run of ``low``'s step on ``mesh`` under the counter."""
    from torch.distributed.tensor.experimental import implicit_replication
    args = shd.distribute(mesh, low.args, low.in_specs)
    with use_mesh(mesh), implicit_replication():
        return analyze(low.step_fn, args, mesh, keep_ops=keep_ops)


def extrapolate(a1: Analysis, a2: Analysis, k: int) -> Analysis:
    """Every count of ``a1 + k·(a2 − a1)``: ``k`` more units than
    ``a1``'s depth.  Output dims that grow with depth grow likewise; the
    whales are ``a2``'s."""
    if k == 0:
        return a1
    costs = Costs()
    costs.add(a1.costs)
    costs.add(a2.costs, k)
    costs.add(a1.costs, -k)

    def lin(x1, x2):
        return x1 + k * (x2 - x1)
    outputs = []
    for (p1, s1, d1), (p2, s2, d2) in zip(a1.outputs, a2.outputs):
        if p1 != p2 or d1 != d2 or len(s1) != len(s2):
            raise ValueError(f"outputs differ between depths: {p1} {p2}")
        outputs.append((p1, tuple(lin(x, y) for x, y in zip(s1, s2)), d1))
    return Analysis(costs, lin(a1.argument_bytes, a2.argument_bytes),
                    lin(a1.output_bytes, a2.output_bytes),
                    lin(a1.alias_bytes, a2.alias_bytes),
                    lin(a1.peak_bytes, a2.peak_bytes), outputs,
                    a2.whales, {})


@dataclass
class Prediction:
    low: Lowering                  # the full-depth lowering (args, specs)
    analysis: Analysis             # counts at the full depth
    depths: Tuple[int, int]
    units: int
    ops: Dict[int, Dict[str, List[int]]]   # depth → op table


def predict(arch: str, shape: str, mesh, *, variant: str = "baseline",
            batch: Optional[int] = None, keep_ops: bool = False,
            n_layers: Optional[int] = None) -> Prediction:
    """The dry-run's counts for ``arch`` × ``shape`` on ``mesh`` at the
    full depth (or ``n_layers``), by depth extrapolation; ``batch`` cuts
    the global batch.  A skipped pair returns its lowering and no
    analysis."""
    low = _build(arch, shape, mesh, variant, batch, n_layers)
    if low.skip:
        return Prediction(low, None, (0, 0), 0, {})
    d1, d2, n = unit_depths(low.cfg)
    if n <= 2:
        d1 = d2 = low.cfg.n_layers
    runs = {}
    for d in sorted({d1, d2}):
        runs[d] = run_lowering(_build(arch, shape, mesh, variant, batch, d),
                               mesh, keep_ops)
    an = extrapolate(runs[d1], runs[d2], n - 1 if d1 != d2 else 0)
    return Prediction(low, an, (d1, d2), n,
                      {d: a.ops for d, a in runs.items()})


def collective_stats(c: Costs) -> dict:
    return {"bytes_per_device": c.coll_bytes, "by_kind": c.coll_by_kind,
            "counts": c.coll_counts}


def print_whales(an: Analysis, top: int = 12) -> None:
    """Largest per-device tensors seen (at the deeper of the two runs)."""
    for k, (b, cnt) in sorted(an.whales.items(),
                              key=lambda kv: -kv[1][0])[:top]:
        print(f"   whale {b / 2**30:8.2f} GiB x{cnt:4d}  {k}")


def run_one(arch: str, shape: str, multi_pod: bool, out_dir: str,
            save_ops: bool = False, whales: bool = False,
            variant: str = "baseline") -> dict:
    mesh_name = "2x16x16" if multi_pod else "16x16"
    mesh = make_production_mesh(multi_pod=multi_pod)
    if variant == "w8kv8":
        mesh_name += "+w8kv8"
    t0 = time.perf_counter()
    pred = predict(arch, shape, mesh, variant=variant, keep_ops=save_ops)
    low = pred.low
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
           "kind": low.kind, "n_devices": mesh.size()}
    if low.skip:
        rec["skipped"] = low.skip
        print(f"[dryrun] {arch} × {shape} × {mesh_name}: SKIP ({low.skip})")
        return rec
    an = pred.analysis
    rec.update({
        "lower_s": round(time.perf_counter() - t0, 2),
        "depths": list(pred.depths), "units": pred.units,
        "flops_per_device": an.costs.flops,
        "bytes_accessed_per_device": an.costs.bytes,
        "collective": collective_stats(an.costs),
        "memory": {
            "argument_bytes": an.argument_bytes,
            "output_bytes": an.output_bytes,
            "temp_bytes": an.temp_bytes,
            "alias_bytes": an.alias_bytes,
        },
        "peak_bytes": an.peak_bytes,
        # blocked attention counts the kv blocks the causal / window mask
        # meets (as kernel 3 visits them); the reference's record counts
        # every block, masked
        "counted_blocks": "mask-visited",
        "outputs": [[p, list(s), d] for p, s, d in an.outputs],
    })
    print(f"[dryrun] {arch} × {shape} × {mesh_name}: OK  "
          f"lower={rec['lower_s']:.1f}s  "
          f"args={an.argument_bytes / 2**30:.2f}GiB  "
          f"peak={an.peak_bytes / 2**30:.2f}GiB  "
          f"temp={an.temp_bytes / 2**30:.2f}GiB  "
          f"flops/dev={an.costs.flops:.3e}  "
          f"bytes/dev={an.costs.bytes:.3e}  "
          f"coll={an.costs.coll_bytes / 2**30:.3f}GiB")
    if whales:
        print_whales(an)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        name = f"{arch}__{shape}__{mesh_name}.json"
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(rec, f, indent=1)
        if save_ops:
            with open(os.path.join(out_dir, name[:-5] + ".ops.json"),
                      "w") as f:
                json.dump({str(d): t for d, t in pred.ops.items()}, f,
                          indent=0)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(configs.ALIASES))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--save-ops", action="store_true",
                    help="write the per-device op table the counts "
                         "came from")
    ap.add_argument("--whales", action="store_true",
                    help="print the largest per-device tensors")
    ap.add_argument("--variant", default="baseline",
                    choices=["baseline", "w8kv8"])
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    pairs = list(all_pairs()) if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    for arch, shape in pairs:
        if args.variant == "w8kv8" and not _w8kv8_pair(arch, shape):
            continue
        for mp in meshes:
            try:
                run_one(arch, shape, mp, args.out, args.save_ops,
                        args.whales, args.variant)
            except Exception as e:   # noqa: BLE001 — report every pair
                failures.append((arch, shape, mp, repr(e)))
                print(f"[dryrun] {arch} × {shape} × "
                      f"{'2x16x16' if mp else '16x16'}: FAIL {e!r}")
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        return 1
    print("\nall dry-runs passed")
    return 0


def _w8kv8_pair(arch: str, shape: str) -> bool:
    """The W8/KV8 variant's pairs: the attention families' full-cache
    decode shape."""
    return SHAPES[shape].kind == "decode" and shape != "long_500k" and \
        configs.get(arch).family in ("dense", "moe", "vlm", "audio")


if __name__ == "__main__":
    sys.exit(main())
