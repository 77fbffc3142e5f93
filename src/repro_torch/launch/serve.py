"""Multi-LLM SLO-attainment serving over real colocated engines (port of
``repro/launch/serve.py``; ``--archs`` takes any of the ten configs of
``repro_torch.configs``).

Replays a popularity-skewed Poisson workload (``core/workload.py``)
over the requested architectures' reduced variants and reports per-LLM
and aggregate TTFT/TPOT/E2E percentiles, goodput and SLO attainment.
Runs on the GPU by default (``--device cuda``, random bf16 weights);
``--device cpu`` runs the plain versions of the kernels in f32.

Units come from one of two sources:

  * ``--archs a,b,...`` — one colocated unit holding every listed
    architecture on one unified KV pool, rates power-law over the list;
  * ``--placement plan.json`` — the placement → runtime bridge: a
    ``core/placement.py`` plan instantiates one real unit per mesh with
    the plan's rates and compute shares.  ``--save-placement`` plans
    ``--archs`` at the workload rates on ``--devices`` devices (full
    width, A100 constants, as the JAX package does), writes the JSON,
    and serves from it.

Graceful degradation and the live serving layer take the JAX CLI's
flags: ``--max-queue`` / ``--shed-policy`` / ``--shed-scale`` (bounded
admission and deadline shedding), ``--faults`` (a deterministic fault
plan), ``--watchdog-ticks``, ``--frontend`` with ``--router`` (the
async streaming front end and cross-LLM routing), ``--metrics-json`` /
``--port`` (the metrics layer, its HTTP endpoint on localhost) and
``--sanitize`` (the runtime invariant checker).  ``--prefix-cache``
shares the KV blocks of common prompt prefixes across requests
(copy-on-write; needs ``--chunk-tokens``), and ``--prefix-reuse``
switches the workload to ``core.workload.shared_prefix_trace``.
``--reconfig`` turns on live reconfiguration (``serving/reconfig.py``):
the drift monitor watches arrival rates over ``--reconfig-interval``
windows, and once they stray from the plan by ``--drift-threshold``× for
two windows the placement is re-solved over the fixed meshes and engines
migrate with their KV; a bare ``--archs`` unit is wrapped in a one-mesh
plan (quota rebalances only).

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --archs qwen2-7b,mamba2-2.7b --policy adbs --fused \\
      --chunk-tokens 16 --rate 2.0 --horizon 8 --deterministic
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch import configs, resolve_device
from repro_torch.config import replace
from repro_torch.core.estimator import LLMSpec
from repro_torch.core.placement import (Mesh, Placement, load_placement, place,
                                        save_placement)
from repro_torch.core.workload import (poisson_trace, power_law_rates,
                                       shared_prefix_trace)
from repro_torch.kernels import ops
from repro_torch.serving.driver import (TickCostModel, build_unit_from_specs,
                                        requests_from_workload, serve_workload,
                                        units_from_placement)
from repro_torch.serving.engine import TRACE_COUNTS, unique_tree_bytes
from repro_torch.serving.graphs import (CAPTURE_SECONDS, GRAPH_CAPTURES,
                                        GRAPH_REPLAYS)
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.frontend import ServingFrontend, serve_and_collect
from repro_torch.serving.metrics import MetricsServer, ServingMetrics
from repro_torch.serving.mux import SHED_POLICIES
from repro_torch.serving.reconfig import ReconfigController
from repro_torch.serving.router import ROUTER_STRATEGIES


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
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share KV blocks across requests with a common "
                         "prompt prefix (copy-on-write; needs "
                         "--chunk-tokens > 0; DESIGN.md §13)")
    ap.add_argument("--prefix-reuse", type=float, default=0.0,
                    help="fraction of requests that open with a popular "
                         "shared prefix (> 0 switches the workload to "
                         "core.workload.shared_prefix_trace; pairs with "
                         "--prefix-cache but works without it as the "
                         "uncached baseline)")
    ap.add_argument("--fused", action="store_true",
                    help="fused multi-LLM tick (one sweep per phase for "
                         "same-architecture engines)")
    ap.add_argument("--slo-scales", default="2,4,6,8,12,16",
                    help="comma list of SLO scale factors")
    ap.add_argument("--deterministic", action="store_true",
                    help="logical tick-cost clock instead of wall time")
    ap.add_argument("--pool-blocks", type=int, default=200_000)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--max-queue", type=int, default=None,
                    help="per-LLM admission-queue bound; arrivals past "
                         "it are shed with backpressure (needs a "
                         "--shed-policy other than 'none')")
    ap.add_argument("--shed-policy", default="none",
                    choices=list(SHED_POLICIES),
                    help="graceful-degradation ladder: 'none' (never "
                         "drop), 'reject' (bound the queue), 'deadline' "
                         "(also shed requests whose solo-speed TTFT "
                         "can no longer meet the SLO)")
    ap.add_argument("--shed-scale", type=float, default=None,
                    help="SLO scale the deadline shedder targets "
                         "(default: the largest --slo-scales entry)")
    ap.add_argument("--faults", default=None, metavar="PLAN",
                    help="fault-injection plan: comma list of "
                         "crash:<llm>@<t>, block_loss:<llm>:<blocks>@<t>, "
                         "transient:<llm>:<ticks>@<t>, "
                         "migration_abort@<t>")
    ap.add_argument("--watchdog-ticks", type=int, default=1000,
                    help="busy ticks with zero progress before the "
                         "watchdog sheds all pending work (0 disables)")
    ap.add_argument("--sm-frac", default=None, metavar="SHARES",
                    help="per-LLM compute-share overrides: a comma list "
                         "aligned with --archs (e.g. 0.5,0.3,0.2) or "
                         "name=frac pairs (e.g. qwen2-7b#0=0.5); with "
                         "--placement the overrides patch the plan's "
                         "shares, without it they turn on share "
                         "enforcement for the colocated unit")
    ap.add_argument("--no-enforce-shares", action="store_true",
                    help="ignore planned sm_frac at runtime (temporal "
                         "accounting: every job is charged as if it held "
                         "the whole mesh — the pure-temporal baseline)")
    ap.add_argument("--placement", default=None, metavar="PLAN_JSON",
                    help="build units from a core/placement.py plan")
    ap.add_argument("--save-placement", default=None, metavar="PLAN_JSON",
                    help="optimize a placement for --archs at the "
                         "workload rates, save it, and serve from it")
    ap.add_argument("--devices", type=int, default=8,
                    help="cluster size for --save-placement")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the Hopper kernels) or cpu")
    ap.add_argument("--report", default=None, metavar="OUT_JSON",
                    help="write the full ServeReport JSON here")
    ap.add_argument("--frontend", action="store_true",
                    help="serve through the async streaming front end: "
                         "open-loop ingestion and per-request token "
                         "streams over the same scheduling loop as the "
                         "closed-loop driver")
    ap.add_argument("--router", default=None,
                    choices=list(ROUTER_STRATEGIES),
                    help="cross-LLM routing strategy for --frontend; "
                         "requests naming a model family resolve to a "
                         "replica at submit time")
    ap.add_argument("--metrics-json", default=None, metavar="OUT_JSON",
                    help="arm the metrics layer and write the final "
                         "snapshot JSON here")
    ap.add_argument("--port", type=int, default=None,
                    help="arm the metrics layer and expose it over HTTP "
                         "on localhost while serving: GET /metrics, "
                         "/metrics.json, /events; 0 picks a free port")
    ap.add_argument("--sanitize", action="store_true",
                    help="arm the runtime invariant sanitizer: re-check "
                         "the pool, grant-algebra and request-disposition "
                         "laws after every tick and fail on the first "
                         "violation (also: MUXSERVE_SANITIZE=1)")
    ap.add_argument("--reconfig", action="store_true",
                    help="live reconfiguration: watch arrival-rate "
                         "drift, re-solve the placement online and "
                         "migrate engines/KV between units "
                         "(serving/reconfig.py)")
    ap.add_argument("--reconfig-interval", type=float, default=1.0,
                    help="drift-monitor window length in clock seconds")
    ap.add_argument("--drift-threshold", type=float, default=2.0,
                    help="estimated/planned rate ratio that arms the "
                         "re-plan trigger (sustained for 2 windows)")
    args = ap.parse_args(argv)

    for flag, v in [("--rate", args.rate), ("--horizon", args.horizon),
                    ("--alpha", args.alpha),
                    ("--pool-blocks", args.pool_blocks),
                    ("--max-slots", args.max_slots),
                    ("--mean-prompt", args.mean_prompt),
                    ("--mean-output", args.mean_output),
                    ("--devices", args.devices),
                    ("--reconfig-interval", args.reconfig_interval),
                    ("--drift-threshold", args.drift_threshold)]:
        if v <= 0:
            ap.error(f"{flag} must be > 0 (got {v})")
    for flag, v in [("--chunk-tokens", args.chunk_tokens),
                    ("--max-new", args.max_new),
                    ("--watchdog-ticks", args.watchdog_ticks)]:
        if v < 0:
            ap.error(f"{flag} must be >= 0 (got {v})")
    if args.max_queue is not None and args.max_queue <= 0:
        ap.error(f"--max-queue must be > 0 (got {args.max_queue})")
    if args.max_queue is not None and args.shed_policy == "none":
        ap.error("--max-queue needs --shed-policy reject or deadline "
                 "('none' never drops, so the bound is unenforceable)")
    if args.shed_scale is not None and args.shed_scale <= 0:
        ap.error(f"--shed-scale must be > 0 (got {args.shed_scale})")
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

    if not 0.0 <= args.prefix_reuse <= 1.0:
        ap.error(f"--prefix-reuse must be in [0, 1] "
                 f"(got {args.prefix_reuse})")
    if args.prefix_cache and args.chunk_tokens == 0:
        ap.error("--prefix-cache requires --chunk-tokens > 0: a partial "
                 "prefix hit resumes prefill mid-prompt, which only the "
                 "chunked path can do (DESIGN.md §13)")
    if args.placement and args.save_placement:
        ap.error("--placement and --save-placement are mutually "
                 "exclusive (load a plan OR optimize and save one)")
    if args.reconfig and args.policy == "fcfs":
        ap.error("--reconfig needs a multiplexing policy (adbs or "
                 "round_robin); fcfs has no quotas to rebalance")
    if args.reconfig and not args.deterministic:
        print("[serve] note: --reconfig under the wall clock uses "
              "analytic SLO references (TickCostModel at the owning "
              "mesh's size) instead of startup solo probes")
    if args.router is not None and not args.frontend:
        ap.error("--router needs --frontend (routing happens at the "
                 "front end's submit path)")
    if args.port is not None and args.port < 0:
        ap.error(f"--port must be >= 0 (got {args.port})")
    archs = args.archs.split(",")
    names = _unit_names(archs)

    # ---- per-LLM compute-share overrides -----------------------------
    sm_overrides = {}
    if args.sm_frac:
        parts = args.sm_frac.split(",")
        try:
            if any("=" in p for p in parts):
                for p in parts:
                    k, eq, v = p.partition("=")
                    if not eq:
                        raise ValueError(p)
                    sm_overrides[k.strip()] = float(v)
            else:
                if len(parts) != len(names):
                    ap.error(f"--sm-frac has {len(parts)} values for "
                             f"{len(names)} archs (use name=frac pairs to "
                             "override a subset)")
                sm_overrides = {n: float(v) for n, v in zip(names, parts)}
        except ValueError:
            ap.error(f"--sm-frac could not be parsed: {args.sm_frac!r} "
                     "(use a comma list of fractions aligned with --archs, "
                     "or name=frac pairs — not a mix)")
        bad = [f"{n}={v}" for n, v in sm_overrides.items()
               if not 0.0 < v <= 1.0]
        if bad:
            ap.error(f"--sm-frac values must be in (0, 1]: {', '.join(bad)}")

    # ---- units: placement bridge or a single colocated unit ----------
    pl = None
    try:
        if args.placement:
            pl = load_placement(args.placement, configs.get_reduced)
            print(f"[serve] placement plan {args.placement} "
                  f"(est. {pl.total_tpt:.2f} req/s):\n{pl.describe()}")
            rates = {s.name: s.rate for m in pl.meshes for s in m.specs}
        else:
            rates = power_law_rates(names, args.alpha, args.rate)
            if args.save_placement:
                models_rates = [(replace(configs.get(a), name=n), rates[n])
                                for n, a in zip(names, archs)]
                pl = place(models_rates, n_devices=args.devices,
                           mean_prompt=args.mean_prompt,
                           mean_output=args.mean_output)
                save_placement(pl, args.save_placement)
                print(f"[serve] optimized placement for {args.devices} "
                      f"devices (est. {pl.total_tpt:.2f} req/s) → "
                      f"{args.save_placement}:\n{pl.describe()}")
        if pl is not None:
            plan_names = {s.name for m in pl.meshes for s in m.specs}
            unknown = sorted(set(sm_overrides) - plan_names)
            if unknown:
                ap.error(f"--sm-frac names not in the plan: {unknown} "
                         f"(plan has {sorted(plan_names)})")
            for m in pl.meshes:
                for s in m.specs:
                    if s.name in sm_overrides:
                        s.sm_frac = sm_overrides[s.name]
            units = units_from_placement(
                pl, pool_blocks=args.pool_blocks, max_slots=args.max_slots,
                chunk_tokens=args.chunk_tokens, seed=args.seed,
                policy=args.policy, fused=args.fused,
                enforce_shares=not args.no_enforce_shares, dtype=dtype,
                device=device, max_queue=args.max_queue,
                shed_policy=args.shed_policy, prefix_cache=args.prefix_cache)
        else:
            unknown = sorted(set(sm_overrides) - set(names))
            if unknown:
                ap.error(f"--sm-frac names not in --archs: {unknown} "
                         f"(unit names are {names})")
            # a bare-archs unit enforces shares only when the user
            # supplies them (there is no plan to take shares from)
            sm_fracs = None
            if sm_overrides and not args.no_enforce_shares:
                sm_fracs = {n: sm_overrides.get(n, 1.0) for n in names}
            units = [build_unit_from_specs(
                [(n, a, rates[n]) for n, a in zip(names, archs)],
                pool_blocks=args.pool_blocks, max_slots=args.max_slots,
                chunk_tokens=args.chunk_tokens, seed=args.seed,
                policy=args.policy, fused=args.fused, sm_fracs=sm_fracs,
                dtype=dtype, device=device, max_queue=args.max_queue,
                shed_policy=args.shed_policy, prefix_cache=args.prefix_cache)]
    except ValueError as e:
        ap.error(str(e))

    # ---- fault-injection plan ----------------------------------------
    fault_plan = None
    if args.faults:
        try:
            fault_plan = FaultPlan.parse(args.faults)
        except ValueError as e:
            ap.error(f"--faults could not be parsed: {e}")
        engine_names = {n for u in units for n in u.engines}
        unknown = sorted(set(fault_plan.targets()) - engine_names)
        if unknown:
            ap.error(f"--faults targets not served here: {unknown} "
                     f"(engines are {sorted(engine_names)})")
        if not args.deterministic:
            print("[serve] note: fault times fire against the wall "
                  "clock; use --deterministic for reproducible chaos")
        if any(e.kind == "migration_abort" for e in fault_plan.events)\
                and not args.reconfig:
            print("[serve] note: migration_abort faults are inert "
                  "without --reconfig")
        print(f"[serve] fault plan armed: {len(fault_plan.events)} "
              f"event(s), shed_policy={args.shed_policy}")
    for u in units:
        for g in u.fused_groups:
            print(f"[serve] fused group ({len(g.engines)} engines): "
                  f"{[e.cfg.name for e in g.engines]}, "
                  f"{'fused' if g.chunk_tokens else 'serial'} prefill, "
                  f"{g.weight_bytes() / 1e6:.1f} MB shared weights")
        if u.reclaimed_weight_bytes:
            print(f"[serve] weight de-dup reclaimed "
                  f"{u.reclaimed_weight_bytes / 1e6:.1f} MB → pool grew to "
                  f"{u.pool.n_head_blocks} head-blocks")
        if u.enforce_shares:
            print(f"[serve] unit mesh[{u.mesh_id}] enforces compute "
                  f"shares: "
                  + ", ".join(f"{n}:{f:.2f}" for n, f in u.sm_frac.items()))

    if args.prefix_reuse > 0.0:
        wl = shared_prefix_trace(rates, args.horizon, seed=args.seed,
                                 mean_prompt=args.mean_prompt,
                                 mean_output=args.mean_output,
                                 reuse=args.prefix_reuse)
    else:
        wl = poisson_trace(rates, args.horizon, seed=args.seed,
                           mean_prompt=args.mean_prompt,
                           mean_output=args.mean_output)
    src = "plan rates" if args.placement else f"α={args.alpha}"
    print(f"[serve] {len(wl.requests)} requests over {args.horizon}s for "
          f"{len(rates)} LLMs ({src}: "
          f"{{{', '.join(f'{n}:{r:.2f}' for n, r in rates.items())}}}), "
          f"policy={args.policy}, fused={args.fused}, device={device}, "
          f"clock={'logical' if args.deterministic else 'wall'}")
    cost = TickCostModel() if args.deterministic else None

    # ---- live reconfiguration control plane --------------------------
    ctrl = None
    if args.reconfig:
        if pl is None:
            # single colocated unit: wrap it in a one-mesh placement so
            # the re-planner has a plan to diff against (moves are
            # impossible with one mesh, quota rebalances still apply)
            specs = [LLMSpec(replace(configs.get(a), name=n), rates[n],
                             mean_prompt=args.mean_prompt,
                             mean_output=args.mean_output,
                             tp=1, sm_frac=1.0, arch=a)
                     for n, a in zip(names, archs)]
            pl_ctrl = Placement([Mesh(0, args.devices, specs)],
                                sum(rates.values()))
        else:
            pl_ctrl = pl
        ctrl = ReconfigController(pl_ctrl, units,
                                  interval=args.reconfig_interval,
                                  drift_threshold=args.drift_threshold)
        print(f"[serve] reconfig on: window={args.reconfig_interval}s, "
              f"drift threshold {args.drift_threshold}×, "
              f"{len(ctrl.units)} unit(s)")

    # ---- observability layer -----------------------------------------
    metrics = None
    server = None
    if args.metrics_json or args.port is not None:
        metrics = ServingMetrics()
        if args.port is not None:
            server = MetricsServer(metrics, port=args.port).start()
            print(f"[serve] metrics endpoint live at {server.url}/metrics "
                  f"(also /metrics.json, /events)")

    ops.reset_launch_counts()
    if args.frontend:
        engines = {}
        for u in units:
            engines.update(u.engines)
        reqs = requests_from_workload(wl, engines, seed=args.seed,
                                      max_new_cap=args.max_new)
        fe = ServingFrontend(units, reqs, strategy=args.router,
                             metrics=metrics,
                             planned_rates=dict(wl.rates),
                             slo_scales=slo_scales, cost=cost,
                             reconfig=ctrl, faults=fault_plan,
                             watchdog_ticks=args.watchdog_ticks,
                             shed_scale=args.shed_scale,
                             sanitize=args.sanitize)
        report, outs = serve_and_collect(fe)
        streamed = sum(len(o) for o in outs.values() if isinstance(o, list))
        errors = sum(1 for o in outs.values() if isinstance(o, Exception))
        print(f"[serve] frontend streamed {streamed} tokens across "
              f"{len(outs)} request streams "
              f"({errors} terminated by shed/cancel)"
              + (f", router={args.router}" if args.router else ""))
    else:
        report = serve_workload(units, wl, seed=args.seed,
                                max_new_cap=args.max_new,
                                slo_scales=slo_scales, cost=cost,
                                reconfig=ctrl, faults=fault_plan,
                                watchdog_ticks=args.watchdog_ticks,
                                shed_scale=args.shed_scale,
                                metrics=metrics, sanitize=args.sanitize)

    agg = report.aggregate
    print(f"[serve] finished {agg.finished}/{agg.submitted} over "
          f"{report.ticks} ticks in {report.wall_s:.1f}s wall")
    for line in report.summary().splitlines():
        print(f"[serve] {line}")
    if report.faults is not None:
        for ev in report.faults.log:
            extra = (f", {ev['stalled_ticks']} stalled ticks"
                     if ev["kind"] == "watchdog" else
                     f", target={ev.get('target')}")
            print(f"[serve] fault @{ev['t']:.2f}s {ev['kind']}: "
                  f"{ev.get('requeued', 0)} requeued, "
                  f"{ev.get('shed', 0)} shed, "
                  f"{ev.get('blocks', 0)} blocks{extra}")
    if report.reconfig is not None:
        for ev in report.reconfig.log:
            moves = ", ".join(f"{n}: mesh{src}→mesh{dst}"
                              for n, src, dst in ev["moves"])\
                or "quotas/shares only"
            print(f"[serve] reconfig @{ev['t']:.2f}s "
                  f"(drift {ev['drift']:.1f}×): {moves}; "
                  f"{ev['migrated_blocks']} blocks migrated, "
                  f"{ev['requeued']} prefills requeued, "
                  f"{ev['quota_moved']} quota moved, "
                  f"Σ|Δsm_frac|={ev.get('share_moved', 0.0):.2f}")
    for u in units:
        pool = u.pool
        print(f"[serve] pool: free={pool.allocator.free_blocks}"
              f"/{pool.n_head_blocks} head-blocks, fragmentation="
              f"{pool.allocator.fragmentation():.3f}, shrinkable tail="
              f"{pool.allocator.shrinkable_tail()}")
        for name, view in pool.views.items():
            print(f"[serve]   {name}: quota={view.quota} used={view.used}")
        if args.prefix_cache:
            for name, st in pool.prefix_stats().items():
                print(f"[serve]   {name} prefix cache: "
                      f"{st['hits']}/{st['lookups']} hits "
                      f"({st['hit_rate']:.0%}), {st['hit_tokens']} tokens "
                      f"adopted, {st['entries']} entries holding "
                      f"{st['held_blocks']} head-blocks")
        print(f"[serve] memory: "
              f"{unique_tree_bytes([e.params for e in u.engines.values()]) / 1e6:.1f}"
              f" MB weights (de-duplicated), {pool.hbm_bytes() / 1e6:.0f} MB "
              f"pool arena")
    print(f"[serve] shape buckets by step: {dict(TRACE_COUNTS)}")
    if device.type == "cuda":
        print(f"[serve] CUDA graphs captured by step: {dict(GRAPH_CAPTURES)} "
              f"in {sum(CAPTURE_SECONDS.values()):.1f} s, replayed "
              f"{dict(GRAPH_REPLAYS)}")
        print(f"[serve] kernel launches: {ops.launch_counts()}")
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report.to_json(), f, indent=1)
        print(f"[serve] report JSON → {args.report}")
    if metrics is not None:
        snap = metrics.snapshot()
        n_series = sum(len(f["series"]) for f in snap["families"])
        print(f"[serve] metrics: {len(snap['families'])} families, "
              f"{n_series} live series, {metrics.log.seq} log records")
        if args.metrics_json:
            with open(args.metrics_json, "w") as f:
                json.dump(snap, f, indent=1)
            print(f"[serve] metrics snapshot JSON → {args.metrics_json}")
    if server is not None:
        server.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
