"""Find a cell's knee: serve its traffic at several fixed rates in one
process (one unit, warmed once) and record, for each, the end-to-end
metrics and the waiting queue across the window.

    python3 -m muxbench.sweep --workload <cell> --rates 2,3,4 \
        --seconds <s> --seed <n>

One JSON line a rate: the rate, the queue (requests waiting for a slot)
sampled every half second of the window, its growth (mean over the last
third of the window minus the first third), and ``out_tok_s``,
``ttft_p95_ms``, ``tpot_p90_ms``, ``ttft_p50_ms``.  The knee is the
highest rate at which the queue does not grow; a cell runs at four
fifths of it (its traffic file's ``rate``).  Run once, on the card, when
a cell is defined.
"""
from __future__ import annotations

import argparse
import json
import sys
from types import SimpleNamespace

import numpy as np
import torch

from muxbench import harness, metrics
from muxbench.run import seed_of


def sweep(cell: harness.Cell, rates, seconds: float, seed: int,
          device="cuda", dtype=None, out=sys.stdout) -> list:
    cfg = cell.config
    dtype = dtype or harness.DTYPES[cfg["dtype"]]
    device = torch.device(device)
    seed = seed_of(seed)
    unit = harness.build_unit(cfg, cell.traffic, seed, device, dtype)
    harness.warm(unit, seed, cell.traffic)
    rows = []
    for rate in rates:
        traffic = dict(cell.traffic, rate=float(rate))
        arrivals = harness.arrivals(cfg, traffic, seed, seconds)
        fill = float(traffic["fill_s"])
        queue = []

        def watch(now):
            if now >= fill and (not queue or now - queue[-1][0] >= 0.5):
                queue.append((now, sum(len(q) for q in
                                       unit.queues.values())))
        w = harness.serve(unit, arrivals, fill, seconds, watch=watch)
        run = SimpleNamespace(window=w, setup_s=0.0, probe=None)
        q = np.asarray([n for _, n in queue], np.float64)
        third = max(len(q) // 3, 1)
        due = metrics.window_requests(run)
        ttft = metrics.module("ttft_p95_ms").per_request(run)
        row = dict(rate=float(rate), due=len(due),
                   finished=sum(1 for s in due if s.finished),
                   queue=q.tolist(),
                   growth=float(q[-third:].mean() - q[:third].mean()),
                   ttft_p50_ms=(metrics.percentile(ttft, 50) or 0.0) * 1e3,
                   **{m: metrics.read(m, run) for m in
                      ("out_tok_s", "ttft_p95_ms", "tpot_p90_ms")})
        print(json.dumps(row), file=out, flush=True)
        rows.append(row)
        unit.shed_all("sweep")
        unit.stats.shed.clear()
        unit.stats.finished.clear()
        for eng in unit.engines.values():
            eng.finished.clear()
    harness.release(unit)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("the sweep needs a CUDA device", file=sys.stderr)
        return 2
    sweep(cell, [float(r) for r in args.rates.split(",")], args.seconds,
          args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
