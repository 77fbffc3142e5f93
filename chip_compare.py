#!/usr/bin/env python3
"""Kernel times of two or more trees of this repository on one GPU, in
turns, at the kernel table's shapes (PERF.md §6).

  python3 chip_compare.py [--moe] <tree>[:<tag>] <tree>[:<tag>] ...

Each argument is the root of a checkout (``.`` for this one; an older
commit unpacked with ``git archive`` under a git-ignored directory).
Trees run in the order given, each in a fresh process, so a call like
``build/parent:parent . . build/parent:parent`` gives parent, change,
change, parent on one card.  Each process builds that tree's kernels and
runs that tree's own ``chip_smoke.check_kernels`` at full-width
qwen2-7b and zamba2-1.2b's shared attention, ``check_int8`` at
full-width qwen2-7b, ``check_ssd`` at the SSD scan's shapes and
``check_moe`` at kernel 6's bf16 shapes, the shapes ``FULL``, ``ZAMBA``,
``SSD_SHAPES`` and ``MOE_SHAPES`` of this checkout's ``chip_smoke.py``
(the same shapes for every tree); with ``--moe`` first, ``check_moe``
alone.  The kernel times
(``time_ms``: median of 25 calls, L2 evicted before each), the plain and
library times, the bound and, where the tree measures them, the
wrapper's host time per call (``host_us``) and one call's wall time with
the card idle (``call_us``) are printed per tree, then one table side by
side for each of ``ms``, ``host_us`` and ``call_us``, and the card's
name and power limit.  Exits non-zero when a tree fails or no
GPU is present.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

from chip_smoke import FULL, MOE_SHAPES, SSD_SHAPES, ZAMBA

FIELDS = ("ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err",
          "host_us", "call_us", "profiler", "plan")
TABLES = ("ms", "host_us", "call_us")

_CHILD = r'''
import importlib.util, json, sys
root = sys.argv[1]
sys.path.insert(0, root + "/src")
spec = importlib.util.spec_from_file_location("tree_smoke",
                                              root + "/chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
import numpy as np, torch
if not torch.cuda.is_available():
    sys.exit("no CUDA device")
torch.backends.cuda.matmul.allow_tf32 = False
from repro_torch.kernels import build
build.build_all()
fields = json.loads(sys.argv[2])
shapes = [{**s, "dtype": getattr(torch, s["dtype"])}
          for s in json.loads(sys.argv[3])]
moe = [s for s in shapes if "E" in s]
out = {}
if len(moe) < len(shapes):
    full, zamba, *ssd = [s for s in shapes if "E" not in s]
    for shape in (full, zamba):
        for k, r in cs.check_kernels(torch, np, shape).items():
            out[f"{shape['label']}: {k}"] = {f: r.get(f) for f in fields}
    for k, r in cs.check_int8(torch, np, full).items():
        out[f"{full['label']}: int8 {k}"] = {f: r.get(f) for f in fields}
    for shape in ssd:
        r = cs.check_ssd(torch, shape)
        out[f"{shape['label']}: ssd_scan"] = {f: r.get(f) for f in fields}
for shape in moe:
    r = cs.check_moe(torch, shape)
    out[f"{shape['label']}: grouped_swiglu"] = {f: r.get(f) for f in fields}
print("RESULT " + json.dumps(out), flush=True)
'''


def run_tree(root: str, moe_only: bool) -> dict:
    moe = [s for s in MOE_SHAPES if s["dtype"] == "bfloat16"]
    shapes = json.dumps(moe if moe_only else
                        [FULL, ZAMBA, *SSD_SHAPES, *moe])
    proc = subprocess.run([sys.executable, "-c", _CHILD, root,
                           json.dumps(FIELDS), shapes], capture_output=True,
                          text=True, timeout=1200)
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"tree {root} failed (exit {proc.returncode}):\n"
                       f"{proc.stderr[-4000:]}")


def main(argv) -> int:
    moe_only = bool(argv) and argv[0] == "--moe"
    argv = argv[1:] if moe_only else argv
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    trees = [(a.split(":")[0], a.split(":")[1] if ":" in a else a)
             for a in argv]
    for root, _ in trees:
        if not (Path(root) / "chip_smoke.py").is_file():
            print(f"chip_compare.py: no chip_smoke.py under {root}",
                  file=sys.stderr)
            return 2
    results = []
    for root, tag in trees:
        res = run_tree(root, moe_only)
        print(f"tree {tag} ({root}): " + json.dumps(res), flush=True)
        results.append((tag, res))
    for field in TABLES:
        print(f"kernel {field}, in turns: "
              + ", ".join(t for t, _ in results))
        for key in results[0][1]:
            vals = [r.get(key, {}).get(field) for _, r in results]
            if any(v is not None for v in vals):
                print(f"  {key}: " + ", ".join(
                    "-" if v is None else f"{v:.4f}" for v in vals))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card.splitlines()[0] if card else "nvidia-smi: no card")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
