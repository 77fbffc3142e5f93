"""Run one cell of the benchmark once.

    python3 -m muxbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Builds the cell's unit from the port's classes with weights drawn from
the seed, captures every step its traffic takes, serves the fill period
and then the measured window open loop under the wall clock, and holds a
sample of the served tokens against the float32 reference.  The last
line of standard output is one JSON object: ``correct``, ``attempted``
(requests due in the window), ``failed`` (of those, shed), ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit.  Needs as many CUDA
devices as the cell asks for; prints no result without them, or when
the process holds JAX or the JAX package after the window.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from collections import Counter  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from muxbench import harness, metrics  # noqa: E402


def seed_of(seed: int) -> int:
    """A non-negative seed for numpy's generators (any whole number)."""
    return int(seed) % (1 << 63)


def run_cell(cell: harness.Cell, seed: int, seconds: float, trace: bool,
             device="cuda", dtype=None, t_start: float = T_START,
             control: bool = False) -> dict:
    """One run of ``cell``; returns the result line's object, and under
    ``_log`` what the earlier lines print.  ``control`` also reads the
    control's gaps on the same sequences and judges them by the same
    limits: ``_log["control correct"]`` (``muxbench.calibrate``)."""
    from muxbench.probe import Probe
    cfg, traffic = cell.config, cell.traffic
    dtype = dtype or harness.DTYPES[cfg["dtype"]]
    device = torch.device(device)
    seed = seed_of(seed)
    unit = harness.build_unit(cfg, traffic, seed, device, dtype)
    warmed = harness.warm(unit, seed, traffic)
    arrivals = harness.arrivals(cfg, traffic, seed, seconds)
    probe = Probe(unit, harness.engine_models(cfg)) if trace else None
    if probe is not None:
        probe.install()
    window = harness.serve(unit, arrivals, float(traffic["fill_s"]),
                           seconds, probe)
    if probe is not None:
        probe.finish()
        probe.uninstall()
    setup_s = window.clock0 + window.t0 - t_start
    run = SimpleNamespace(window=window, setup_s=setup_s, probe=probe)
    wanted = cell.per_layer if trace else cell.end_to_end
    values = {}
    for m in wanted:
        v = metrics.read(m["name"], run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    due = [s for s in window.requests if s.window]
    picked = harness.sample(window, seed)
    harness.release(unit)
    del unit, probe
    harness.free(device)
    t_check = time.perf_counter()
    checks = harness.check(cfg, picked, seed, device, dtype, control)
    t_check = time.perf_counter() - t_check
    out = {"correct": harness.verdict(checks), "attempted": len(due),
           "failed": sum(1 for s in due if s.shed), "metrics": values,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": (torch.cuda.get_device_name(device) if cuda
                               else "cpu"),
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if trace and run.probe is not None and run.probe.trace is not None:
        t = run.probe.trace
        out["device"]["busy_s"] = t["busy_s"]
        out["device"]["window_s"] = t["window_s"]
        out["breakdown"] = {"device_ops": t["device_ops"],
                            "idle_gaps": t["idle_gaps"]}
    out["checks"] = {f"{n} gap": {"value": r.get("gap"), "limit": r["limit"]}
                     for n, r in checks.items()}
    late = np.asarray(window.lateness or [0.0])
    tails = {q: metrics.module(f).per_request(run) for q, f in
             (("ttft", "ttft_p95_ms"), ("tpot", "tpot_p90_ms"))}
    out["_log"] = {
        "requests due in window": len(due),
        "requests served in all": len(window.requests),
        "finished in window": sum(1 for s in due if s.finished),
        "tokens in window": window.tokens, "ticks in window": window.ticks,
        "generator lateness ms (p50, p95, max)": [
            float(np.percentile(late, 50) * 1e3),
            float(np.percentile(late, 95) * 1e3), float(late.max() * 1e3)],
        **{f"{q} ms (p50, p75, p90, p95, max)": [
            (metrics.percentile(v, p) or 0.0) * 1e3
            for p in (50, 75, 90, 95, 100)] for q, v in tails.items()},
        "warm-up s": warmed["seconds"], "graphs captured in warm-up":
            warmed["captures"],
        "whole-prompt probes in warm-up": warmed["whole_prompt_probes"],
        "graphs captured in fill and window": window.captures,
        "resets": sum(s.resets for s in window.requests),
        "reference s": t_check,
        "checked": {n: {k: v for k, v in r.items() if k != "limit"}
                    for n, r in checks.items()},
    }
    if control:
        out["_log"]["control correct"] = harness.verdict(checks,
                                                         "control_gap")
    if trace and run.probe is not None:
        out["_log"]["profiled steps"] = dict(sorted(Counter(
            f"{s.kind} {name}" for s in run.probe.steps
            for name, _ in s.parts).items()))
        if run.probe.trace is not None:
            out["_log"]["trace"] = run.probe.trace["info"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" available", file=sys.stderr)
        return 2
    harness.port()
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    held = harness.forbidden_modules()
    if held:
        print(f"the process holds {held} after the window", file=sys.stderr)
        return 3
    log = out.pop("_log")
    for k, v in log.items():
        print(f"{k}: {v}")
    print(json.dumps(out))
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
