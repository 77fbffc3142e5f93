"""The two readings that a cell's limits are set from: for each seed, one
run of the cell as ``muxbench.run`` makes it (the same unit, warm-up,
fill and window), whose sampled sequences are held against the float32
reference and, on the same positions, against the control — the
reference computed with weight-only fp8 (e4m3, a scale an output
channel), the precision step below the configuration's bfloat16.

    python3 -m muxbench.calibrate --workload <cell> --seeds 1,2,3 \
        --seconds <s>

One JSON line a seed: the harness's verdict on the program
(``correct``) and, by the same rule and limits, on the control
(``control_correct``, which has to come out false), and per engine the
program's widest gap, the control's, and the tokens compared.  Seeds
run in one process, one after the other; each builds its own unit.  Run
on the card; the benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from muxbench import harness
from muxbench.run import run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("calibration needs a CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = run_cell(cell, seed, args.seconds, trace=False, t_start=t,
                       control=True)
        log = out["_log"]
        print(json.dumps(dict(seed=seed, correct=out["correct"],
                              control_correct=log["control correct"],
                              checked=log["checked"],
                              reference_s=log["reference s"],
                              attempted=out["attempted"],
                              metrics={k: v["value"] for k, v in
                                       out["metrics"].items()},
                              peak_gb=out["device"]["memory_peak_bytes"]
                              / 1e9)), flush=True)
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
