"""Closed-loop SLO-attainment serving driver over real engines (port of
``repro/serving/driver.py``).

  * **workload → runtime**: the ``core/workload.py`` generator (the
    same, seed for seed, as the JAX package's) produces the arrival
    trace;
  * **runtime → SLO report**: per-request TTFT/TPOT/E2E timelines roll
    up into per-LLM and aggregate p50/p99, goodput and SLO attainment
    at configurable scale factors, in the JAX package's ``ServeReport``
    schema (v2).

Two time domains, one code path:

  * **realtime** — a wall clock rebased to serving start; SLO
    references are calibrated per engine by timing solo probes.
  * **deterministic** — a logical clock the loop advances by a per-tick
    cost (``TickCostModel``).  Engines still run their real compute and
    produce real tokens; only *time* is modeled, so the scheduling
    behavior is exact and reproducible across machines — and across
    the two packages: the same trace yields the same report.

The JAX package's placement bridge, reconfiguration, fault injection,
sanitizer and metrics hooks arrive with later slices.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.config import BLOCK_TOKENS, replace
from repro_torch.core.workload import Workload
from repro_torch.models.transformer import init_params
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.kvcache import UnifiedKVPool
from repro_torch.serving.mux import MuxScheduler
from repro_torch.serving.reconfig import WorkloadMonitor

# same default ladder as the JAX package's simulator and driver
DEFAULT_SLO_SCALES: Tuple[float, ...] = (2.0, 4.0, 6.0, 8.0, 12.0, 16.0)

# ServeReport.to_json format version (the JAX package's schema v2)
SERVE_REPORT_SCHEMA_VERSION = 2


# ---------------------------------------------------------------------------
# clocks
# ---------------------------------------------------------------------------
class WallClock:
    """Wall time rebased to construction, so every ``Request``
    timestamp and trace arrival shares one origin (t=0 = serving
    start)."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def __call__(self) -> float:
        return time.perf_counter() - self.t0


class LogicalClock:
    """Deterministic clock advanced explicitly by the serving loop."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        assert dt >= 0
        self.t += dt


@dataclass(frozen=True)
class TickCostModel:
    """Logical seconds one scheduler tick costs in deterministic mode.

    ``dt = base + prefill_tokens·prefill_tok + decode_tokens·decode_tok``

    ``base`` is the per-tick dispatch cost (paid even by an idle
    policy branch — an fcfs tick that serves nothing is cheap but not
    free), the per-token terms are the compute cost.  The same
    constants define the solo SLO reference, so attainment is
    self-consistent: a request's reference is what IT would take on an
    otherwise idle unit under this very cost model.

    **Share awareness** (DESIGN.md §11).  ``dt`` is the legacy
    *temporal* accounting: every token is charged as if its job held
    the whole mesh, so colocated jobs serialize.  ``tick_dt`` is the
    *spatial-temporal* accounting for units that enforce placement
    compute shares (``MuxScheduler.enforce_shares``): each phase is
    charged ``tokens·per_tok·max(rho/effective_share, 1)/devices`` —
    the same roofline shape as ``core/costmodel.py`` (compute scales
    with the share, HBM bandwidth does not), with ``rho`` the phase's
    compute intensity.  Decode (memory-bound, ``rho_decode`` small) is
    flat in its share until the share dips below ``rho_decode``;
    prefill (compute-bound, ``rho_prefill`` ≈ 1) scales ≈ 1/share —
    paper Fig. 3, re-derived for the logical clock.
    """
    base: float = 4e-3
    prefill_tok: float = 2e-4
    decode_tok: float = 2e-3
    # phase compute intensities: the fraction of the full-share
    # per-token cost that is compute-limited (rest is HBM traffic,
    # which MPS-style share partitioning does not divide)
    rho_prefill: float = 0.9
    rho_decode: float = 0.25
    # no job ever runs below this effective share (MPS floors tiny
    # percentages; also guards the 1/share scaling)
    share_floor: float = 0.05

    def dt(self, prefill_tokens: int, decode_tokens: int,
           devices: int = 1) -> float:
        """``devices`` scales the per-token (compute) cost: a mesh of
        N devices moves tokens N× faster, while the per-tick dispatch
        ``base`` stays fixed.  The solo SLO reference stays at
        ``devices=1`` — the paper's reference is single-DEVICE
        execution latency, independent of where the placement put the
        model — so attainment rewards giving a hot LLM a bigger mesh
        (live reconfiguration's whole point) instead of silently
        re-normalizing it away."""
        return (self.base + (prefill_tokens * self.prefill_tok
                             + decode_tokens * self.decode_tok)
                / max(devices, 1))

    def phase_time(self, tokens: int, per_tok: float, rho: float,
                   share: float, devices: int = 1) -> float:
        """Roofline time of one phase at an effective compute share:
        ``tokens·per_tok·max(rho/share, 1)/devices`` — flat in the
        share while the phase stays memory-bound, 1/share beyond."""
        e = max(share, self.share_floor)
        return tokens * per_tok * max(rho / e, 1.0) / max(devices, 1)

    def tick_dt(self, prefill_by: Dict[str, int],
                decode_by: Dict[str, int], shares: Dict[str, float],
                devices: int = 1) -> float:
        """Share-aware tick cost for a unit that enforces ``sm_frac``
        (the deterministic twin of MPS SM assignment — DESIGN.md §11).

        Decode jobs of the colocated LLMs run *concurrently*, each at
        its planned share (Eq. 3's ``max_m t_d^m``); shares that
        oversubscribe the mesh (Σf > 1) slow every decode job
        proportionally.  Prefill is charged as the better of the two
        dispatches a flexible scheduler can pick:

          * **serial** — prefill takes the whole mesh after the decode
            phase (the simulator's Eq. 3: ``Σ t_p + max t_d``);
          * **spatial** — prefill fills the residual share
            ``1 − Σ_decoding f_m`` concurrently with the decode phase
            (Fig. 4's dispatch), with oversubscription contention when
            the residual is floored.

        A solo full-share engine therefore charges exactly the legacy
        ``dt`` (serial wins), while planned small decode shares let
        prefill overlap — which is where the paper's spatial-temporal
        gain lives.
        """
        def f_of(name: str) -> float:
            return min(max(shares.get(name, 1.0), 0.0), 1.0)

        dec = {n: t for n, t in decode_by.items() if t > 0}
        pre_tokens = sum(prefill_by.values())
        demand = sum(f_of(n) for n in dec)

        def t_decode(over: float) -> float:
            return max((self.phase_time(t, self.decode_tok,
                                        self.rho_decode,
                                        f_of(n) / over, devices)
                        for n, t in dec.items()), default=0.0)

        t_d = t_decode(max(demand, 1.0))
        if not pre_tokens:
            return self.base + t_d
        t_serial = self.phase_time(pre_tokens, self.prefill_tok,
                                   self.rho_prefill, 1.0, devices) + t_d
        resid = max(1.0 - demand, self.share_floor)
        over = max(demand + resid, 1.0)
        t_spatial = max(self.phase_time(pre_tokens, self.prefill_tok,
                                        self.rho_prefill, resid / over,
                                        devices),
                        t_decode(over))
        return self.base + min(t_serial, t_spatial)

    def solo_reference(self, prompt_len: int, output_len: int,
                       chunk_tokens: Optional[int] = None,
                       devices: int = 1) -> float:
        """Ideal single-request E2E on an idle unit: prefill runs as
        one tick (or ceil(prompt/chunk) chunk ticks) and every further
        output token as one decode tick.  The first output token is
        committed by the prefill tick itself and billed in neither
        phase's token count — mirroring exactly how the serving loop
        meters ``MuxStats`` tokens, so the reference is what the
        request would cost under this very clock.

        ``devices`` divides the per-token terms exactly like ``dt``
        does.  The DETERMINISTIC reference convention stays
        ``devices=1`` (the paper's single-device solo latency —
        attainment rewards giving a hot LLM a bigger mesh); the
        analytic wall-clock references used under live reconfiguration
        pass the owning mesh's size instead, because there the
        reference stands in for a solo probe on the engine's CURRENT
        hardware (DESIGN.md §14)."""
        n_prefill_ticks = (1 if not chunk_tokens
                           else -(-prompt_len // chunk_tokens))
        n_decode_ticks = max(output_len - 1, 0)   # first token ∈ prefill
        return ((n_prefill_ticks + n_decode_ticks) * self.base
                + (prompt_len * self.prefill_tok
                   + n_decode_ticks * self.decode_tok) / max(devices, 1))


# ---------------------------------------------------------------------------
# SLO references (DESIGN.md §9)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SLORef:
    """Per-model ideal-latency model: the runtime analogue of the
    simulator's ``_slo_reference_latency`` (single-job, dedicated
    hardware).  A request is SLO-attained at scale s iff
    ``E2E ≤ s × reference(prompt_len, output_len)``."""
    prefill_per_token: float
    decode_per_token: float
    base: float = 0.0

    def reference(self, prompt_len: int, output_len: int) -> float:
        return (self.base + prompt_len * self.prefill_per_token
                + output_len * self.decode_per_token)


def calibrate_slo_refs(engines: Dict[str, Engine], probe_prompt: int = 16,
                       probe_decode: int = 6, seed: int = 1234
                       ) -> Dict[str, SLORef]:
    """Measure each engine's solo per-token costs (realtime mode).

    Runs one warm-up probe (visits the shape buckets) and one
    measured probe per engine — a single request on the otherwise-idle
    engine, which is exactly the paper's 'single device execution
    latency' reference, profiled instead of cost-modeled.  Probes
    finish and free their cache, so pool state is untouched; the probe
    doubles as warm-up for serving.
    """
    rng = np.random.default_rng(seed)
    refs: Dict[str, SLORef] = {}
    for name, eng in engines.items():
        for _attempt in range(2):                 # warm-up, then measure
            req = Request(-1, name,
                          list(rng.integers(1, eng.cfg.vocab_size,
                                            probe_prompt)),
                          probe_decode + 1)
            t0 = time.perf_counter()
            eng.prefill([req])
            while eng.has_prefill_work():         # chunked engines
                eng.prefill([])
            t_prefill = time.perf_counter() - t0
            t0 = time.perf_counter()
            while not req.done and eng.has_decode_work():
                eng.decode()
            t_decode = time.perf_counter() - t0
            eng.finished.clear()
        refs[name] = SLORef(
            prefill_per_token=t_prefill / probe_prompt,
            decode_per_token=t_decode / max(probe_decode, 1))
    return refs


def tick_cost_refs(engines: Dict[str, Engine], cost: TickCostModel
                   ) -> Callable[[str, int, int], float]:
    """Deterministic-mode reference: analytic solo latency under the
    SAME cost model the clock uses (per-engine chunk window applied)."""
    chunk = {name: eng.chunk_tokens for name, eng in engines.items()}

    def ref(model: str, prompt_len: int, output_len: int) -> float:
        return cost.solo_reference(prompt_len, output_len, chunk[model])
    return ref


# ---------------------------------------------------------------------------
# workload → runtime requests
# ---------------------------------------------------------------------------
def requests_from_workload(wl: Workload, engines: Dict[str, Engine],
                           seed: int = 0, max_new_cap: int = 0
                           ) -> List[Request]:
    """Materialize a ``core/workload.py`` trace as engine requests.

    Length specs are clipped to each engine's sequence envelope
    (``max_blocks × BLOCK_TOKENS`` tokens for prompt + output + the
    reserved next-token slot); ``max_new_cap`` optionally caps output
    lengths (CPU-scale runs).  Token ids are drawn uniformly from the
    target model's vocab — content is irrelevant to scheduling, only
    lengths and arrivals matter — UNLESS the spec carries explicit
    ``prompt_tokens`` (shared-prefix traces): those are mapped into
    the model's vocab with a fixed modular map, which preserves
    cross-request prefix equality, the one content property the
    prefix cache keys on.  The rng is consumed identically either
    way, so a token-carrying trace and its plain twin materialize
    the same lengths and arrivals.
    """
    rng = np.random.default_rng(seed)
    reqs: List[Request] = []
    for rid, spec in enumerate(r for r in wl.requests
                               if r.model in engines):
        eng = engines[spec.model]
        envelope = eng.max_blocks * BLOCK_TOKENS
        out_len = max(1, min(spec.output_len,
                             max_new_cap or spec.output_len,
                             envelope // 2))
        plen = max(1, min(spec.prompt_len, envelope - out_len - 1))
        drawn = rng.integers(1, eng.cfg.vocab_size, plen)
        if spec.prompt_tokens is not None:
            vocab = eng.cfg.vocab_size
            prompt = [int(t) % (vocab - 1) + 1
                      for t in spec.prompt_tokens[:plen]]
            prompt += [int(t) for t in drawn[len(prompt):]]
        else:
            prompt = list(drawn)
        reqs.append(Request(rid, spec.model, prompt, out_len,
                            arrival=spec.arrival))
    return reqs


# ---------------------------------------------------------------------------
# colocated unit
# ---------------------------------------------------------------------------
def build_unit_from_specs(specs: Sequence[Tuple[str, str, float]],
                          pool_blocks: int = 200_000, max_slots: int = 4,
                          chunk_tokens: int = 0, seed: int = 0,
                          policy: str = "adbs", fused: bool = False,
                          reduced: bool = True,
                          sm_fracs: Optional[Dict[str, float]] = None,
                          dtype=torch.bfloat16, device="cuda",
                          params: Optional[Sequence[dict]] = None
                          ) -> MuxScheduler:
    """Instantiate one real colocated unit from ``(name, arch, rate)``
    triples: one engine per spec over a shared ``UnifiedKVPool``, with
    the initial head-block quota split ∝ arrival rate (ADBS adapts it
    from there).

    The pool takes its head_dim from the configs with attention (all
    must agree; 64 when none has any) and its dtype — like the weights' — from ``dtype``.  ``params`` gives
    one weight tree per spec (e.g. the JAX package's tree mapped
    through ``models.transformer.params_to_torch``); by default spec
    ``i`` draws random weights from a ``torch.Generator`` seeded
    ``seed + i``.  ``sm_fracs`` turns on share enforcement.
    """
    if not specs:
        raise ValueError("a unit needs at least one (name, arch, rate) spec")
    dev = resolve_device(device)
    cfgs = [replace(configs.get_reduced(arch) if reduced
                    else configs.get(arch), name=name)
            for name, arch, _ in specs]
    # attention-free models hold no KV: the head_dim comes from the
    # rest, 64 (the JAX package's pool) when no model has attention
    head_dims = {cfg.hd for cfg in cfgs if not cfg.attn_free}
    if len(head_dims) > 1:
        raise ValueError(f"a unit's pool has one head_dim; the specs have "
                         f"{sorted(head_dims)}")
    pool = UnifiedKVPool(pool_blocks, head_dims.pop() if head_dims else 64,
                         dtype=dtype, device=dev)
    rate_sum = sum(max(r, 0.0) for _, _, r in specs)
    min_quota = max(pool_blocks // (8 * len(specs)), 1)
    engines: Dict[str, Engine] = {}
    for i, ((name, _, rate), cfg) in enumerate(zip(specs, cfgs)):
        if params is not None:
            tree = params[i]
        else:
            gen = torch.Generator(device=dev).manual_seed(seed + i)
            tree = init_params(cfg, gen, dtype, dev)
        if policy == "fcfs":
            # the temporal baseline has no quotas: the arena's free
            # blocks are the only admission bound
            quota = pool_blocks
        else:
            share = (max(rate, 0.0) / rate_sum) if rate_sum\
                else 1 / len(specs)
            quota = max(int(pool_blocks * share), min_quota)
        view = pool.register_model(cfg, quota)
        engines[name] = Engine(cfg, tree, view, max_slots=max_slots,
                               chunk_tokens=chunk_tokens or None)
    # the engines hold the only references to their weights now, so a
    # fused group's stacking frees each member's leaves as it goes
    del tree
    return MuxScheduler(engines, pool, policy=policy, fused=fused,
                        sm_frac=sm_fracs)


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------
@dataclass
class LatencyStats:
    p50: float = float("nan")
    p99: float = float("nan")
    mean: float = float("nan")

    @classmethod
    def of(cls, xs: List[float]) -> "LatencyStats":
        if not xs:
            return cls()
        a = np.asarray(xs, np.float64)
        return cls(float(np.percentile(a, 50)), float(np.percentile(a, 99)),
                   float(a.mean()))

    def to_json(self) -> dict:
        return {"p50": self.p50, "p99": self.p99, "mean": self.mean}


@dataclass
class LLMReport:
    """SLO accounting for one LLM (or the aggregate): latency
    percentiles over finished requests, attainment and goodput per SLO
    scale over ALL submitted requests (an unfinished request is a
    miss at every scale — dropping it would flatter the tail)."""
    name: str
    submitted: int
    finished: int
    throughput: float                        # finished req/s
    ttft: LatencyStats
    tpot: LatencyStats
    e2e: LatencyStats
    attainment: Dict[float, float] = field(default_factory=dict)
    goodput: Dict[float, float] = field(default_factory=dict)
    # degradation dispositions (DESIGN.md §12), visible in EVERY run:
    #   shed      — deliberately dropped (backpressure, deadline,
    #               requeue budget, watchdog); SLO-missed, never silent
    #   retried   — survived ≥1 fault/recovery teardown and requeue
    #   recovered — retried AND still finished
    shed: int = 0
    retried: int = 0
    recovered: int = 0
    shed_reasons: Dict[str, int] = field(default_factory=dict)
    # client abandonments (DESIGN.md §14) — NOT sheds: the client
    # walked away, the server stayed healthy.  Cancelled requests keep
    # counting in the attainment denominator (submitted), preserving
    # submitted = finished + shed + cancelled at drain.
    cancelled: int = 0

    def to_json(self) -> dict:
        return {"name": self.name, "submitted": self.submitted,
                "finished": self.finished, "throughput": self.throughput,
                "ttft": self.ttft.to_json(), "tpot": self.tpot.to_json(),
                "e2e": self.e2e.to_json(),
                "attainment": {str(k): v for k, v in self.attainment.items()},
                "goodput": {str(k): v for k, v in self.goodput.items()},
                "shed": self.shed, "retried": self.retried,
                "recovered": self.recovered,
                "cancelled": self.cancelled,
                "shed_reasons": dict(self.shed_reasons)}


@dataclass
class ServeReport:
    horizon: float                           # clock time at last finish
    wall_s: float                            # real wall time (diagnostic)
    ticks: int
    deterministic: bool
    slo_scales: Tuple[float, ...]
    per_llm: Dict[str, LLMReport]
    aggregate: LLMReport
    # the drift monitor's final per-LLM EWMA arrival-rate estimates next
    # to the planned rates (populated when planned rates are known)
    planned_rates: Dict[str, float] = field(default_factory=dict)
    rate_estimates: Dict[str, float] = field(default_factory=dict)
    # per-LLM enforced compute shares (empty when no unit enforces them)
    sm_frac: Dict[str, float] = field(default_factory=dict)
    # sections of the JAX package's reconfiguration, fault, prefix-cache
    # and metrics layers; their slices fill them, this one emits them
    # empty so the JSON keeps the schema
    reconfig: Optional[dict] = None
    faults: Optional[dict] = None
    prefix: Dict[str, dict] = field(default_factory=dict)
    schema_version: int = SERVE_REPORT_SCHEMA_VERSION
    metrics: Optional[dict] = None

    def summary(self) -> str:
        a = self.aggregate
        att = ", ".join(f"{s:g}×:{a.attainment[s]:.0%}"
                        for s in self.slo_scales)
        lines = [f"aggregate: {a.finished}/{a.submitted} finished in "
                 f"{self.horizon:.2f}s ({'logical' if self.deterministic else 'wall'}) "
                 f"→ {a.throughput:.2f} req/s | SLO[{att}]",
                 f"aggregate: TTFT p50={a.ttft.p50:.3f}s "
                 f"p99={a.ttft.p99:.3f}s | TPOT p50={a.tpot.p50 * 1e3:.1f}ms "
                 f"p99={a.tpot.p99 * 1e3:.1f}ms | E2E p50={a.e2e.p50:.2f}s "
                 f"p99={a.e2e.p99:.2f}s"]
        for name, r in self.per_llm.items():
            att = ", ".join(f"{s:g}×:{r.attainment[s]:.0%}"
                            for s in self.slo_scales)
            lines.append(f"{name}: {r.finished}/{r.submitted} "
                         f"ttft_p99={r.ttft.p99:.3f}s "
                         f"tpot_p99={r.tpot.p99 * 1e3:.1f}ms "
                         f"e2e_p99={r.e2e.p99:.2f}s | SLO[{att}]")
        if self.rate_estimates:
            pairs = ", ".join(
                f"{n}:{self.rate_estimates[n]:.2f}"
                f"(plan {self.planned_rates.get(n, 0.0):.2f})"
                for n in self.rate_estimates)
            lines.append(f"rates est(plan) req/s: {pairs}")
        if self.sm_frac:
            lines.append("compute shares (sm_frac): "
                         + ", ".join(f"{n}:{f:.2f}"
                                     for n, f in self.sm_frac.items()))
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {"schema_version": self.schema_version,
                "horizon": self.horizon, "wall_s": self.wall_s,
                "ticks": self.ticks, "deterministic": self.deterministic,
                "slo_scales": list(self.slo_scales),
                "aggregate": self.aggregate.to_json(),
                "per_llm": {k: v.to_json() for k, v in self.per_llm.items()},
                "planned_rates": dict(self.planned_rates),
                "rate_estimates": dict(self.rate_estimates),
                "sm_frac": dict(self.sm_frac),
                "reconfig": self.reconfig, "faults": self.faults,
                "prefix": {k: dict(v) for k, v in self.prefix.items()},
                "metrics": self.metrics}


def _roll_up(name: str, reqs: List[Request], horizon: float,
             scales: Sequence[float],
             ref: Callable[[str, int, int], float]) -> LLMReport:
    fin = [r for r in reqs if r.finish >= 0]
    ttfts = [r.first_token - r.arrival for r in fin]
    tpots = [(r.finish - r.first_token) / max(len(r.output) - 1, 1)
             for r in fin]
    e2es = [r.finish - r.arrival for r in fin]
    att: Dict[float, float] = {}
    goodput: Dict[float, float] = {}
    for s in scales:
        ok = sum(1 for r in fin
                 if (r.finish - r.arrival)
                 <= s * ref(r.model, len(r.prompt), r.max_new_tokens))
        att[s] = ok / max(len(reqs), 1)
        goodput[s] = ok / max(horizon, 1e-9)
    shed_reasons: Dict[str, int] = {}
    for r in reqs:
        if r.shed:
            shed_reasons[r.shed_reason] =\
                shed_reasons.get(r.shed_reason, 0) + 1
    retried = [r for r in reqs if r.requeues > 0]
    return LLMReport(name=name, submitted=len(reqs), finished=len(fin),
                     throughput=len(fin) / max(horizon, 1e-9),
                     ttft=LatencyStats.of(ttfts), tpot=LatencyStats.of(tpots),
                     e2e=LatencyStats.of(e2es), attainment=att,
                     goodput=goodput,
                     shed=sum(1 for r in reqs if r.shed),
                     retried=len(retried),
                     recovered=sum(1 for r in retried if r.finish >= 0),
                     cancelled=sum(1 for r in reqs if r.cancelled),
                     shed_reasons=shed_reasons)


# ---------------------------------------------------------------------------
# the serving loop
# ---------------------------------------------------------------------------
def _warmup_drain(units: Sequence[MuxScheduler],
                  owner: Dict[str, MuxScheduler],
                  requests: List[Request], max_ticks: int = 50_000) -> None:
    """Run every shape bucket live serving will hit BEFORE the wall
    clock starts, so one-time costs (kernel builds, allocator growth,
    library autotuning) stay out of the measured window.

    Two passes: (1) per engine, one solo drain per (row-bucket ×
    prompt-bucket) combination present in the trace; (2) a flat-out
    replay of the trace through the schedulers, which exercises the
    fused sweeps and the multi-engine paths."""
    rng = np.random.default_rng(0)
    by_model: Dict[str, List[Request]] = {}
    for r in requests:
        by_model.setdefault(r.model, []).append(r)
    for u in units:
        for name, eng in u.engines.items():
            plens = sorted({-(-len(r.prompt) // BLOCK_TOKENS) * BLOCK_TOKENS
                            for r in by_model.get(name, [])})
            if not plens:
                continue
            rows = sorted({1 << k for k in range((eng.max_slots - 1)
                                                 .bit_length() + 1)
                           if 1 << k <= eng.max_slots} | {1})
            for b in rows:
                for plen in plens:
                    probe = [Request(-1, name,
                                     list(rng.integers(
                                         1, eng.cfg.vocab_size, plen)), 2)
                             for _ in range(b)]
                    eng.prefill(probe)
                    while eng.has_prefill_work():
                        eng.prefill([])
                    while eng.has_decode_work():
                        eng.decode()
                    eng.finished.clear()
    warm = [Request(-1 - i, r.model, r.prompt, r.max_new_tokens)
            for i, r in enumerate(requests)]
    for r in warm:
        owner[r.model].submit(r)
    t = 0
    while any(u.pending() for u in units) and t < max_ticks:
        for u in units:
            if u.pending():
                u.tick()
        t += 1
    for u in units:
        u.stats.finished.clear()


class ServeSession:
    """One serving run, decomposed into explicit steps: ``__init__``
    does the setup (ownership map, clock install, SLO references, drift
    monitor), ``step()`` runs one loop iteration (submit due arrivals →
    tick busy units or account an idle gap → monitor), ``report()``
    rolls the timelines up."""

    def __init__(self, units: Sequence[MuxScheduler],
                 requests: List[Request],
                 slo_scales: Sequence[float] = DEFAULT_SLO_SCALES,
                 cost: Optional[TickCostModel] = None,
                 refs: Optional[Dict[str, SLORef]] = None,
                 warm: bool = True,
                 max_ticks: int = 500_000,
                 planned_rates: Optional[Dict[str, float]] = None):
        self.units = list(units)
        self.owner: Dict[str, MuxScheduler] = {}
        self.engines: Dict[str, Engine] = {}
        for u in self.units:
            for name, eng in u.engines.items():
                if name in self.owner:
                    raise ValueError(f"duplicate model {name} across units")
                self.owner[name] = u
                self.engines[name] = eng
        self.cost = cost
        self.deterministic = cost is not None
        self.max_ticks = max_ticks
        self.slo_scales = tuple(slo_scales)
        if self.deterministic:
            self.clock: Callable[[], float] = LogicalClock()
            self.ref_fn = tick_cost_refs(self.engines, cost)
        else:
            if warm:
                _warmup_drain(self.units, self.owner, requests)
            slo = (refs if refs is not None
                   else calibrate_slo_refs(self.engines))

            def ref_fn(model, plen, olen, _slo=slo):
                return _slo[model].reference(plen, olen)
            self.ref_fn = ref_fn
            self.clock = WallClock()
        for u in self.units:
            u.clock = self.clock
            for eng in u.engines.values():
                eng.clock = self.clock
        self.monitor: Optional[WorkloadMonitor] = (
            WorkloadMonitor(planned_rates) if planned_rates is not None
            else None)
        self.planned0 = dict(self.monitor.planned) if self.monitor else {}
        self.requests = sorted(requests, key=lambda r: r.arrival)
        self.idx, self.ticks = 0, 0
        self._done = False
        self._report: Optional[ServeReport] = None
        self._wall0 = time.perf_counter()

    def step(self) -> Tuple[str, float]:
        """Run ONE serving-loop iteration.  Returns ``(status, wait)``:
        ``("tick", 0.0)`` when a unit ticked, ``("idle", gap)`` when
        nothing is pending until the next arrival (deterministic mode
        has advanced the clock already; realtime callers sleep up to
        ``wait``), ``("done", 0.0)`` when the trace drained or
        ``max_ticks`` was hit."""
        if self._done or (self.idx >= len(self.requests)
                          and not any(u.pending() for u in self.units)):
            self._done = True
            return ("done", 0.0)
        now = self.clock()
        while (self.idx < len(self.requests)
               and self.requests[self.idx].arrival <= now):
            self._submit(self.requests[self.idx])
            self.idx += 1
        busy = [u for u in self.units if u.pending()]
        status, wait = "tick", 0.0
        if busy:
            dt = 0.0
            for u in busy:
                p0, d0 = u.stats.prefill_tokens, u.stats.decode_tokens
                u.tick()
                if self.deterministic:
                    if u.enforce_shares:
                        step = self.cost.tick_dt(u.tick_prefill_by,
                                                 u.tick_decode_by,
                                                 u.sm_frac,
                                                 devices=u.n_devices)
                    else:
                        step = self.cost.dt(u.stats.prefill_tokens - p0,
                                            u.stats.decode_tokens - d0,
                                            devices=u.n_devices)
                    dt = max(dt, step)
            if self.deterministic:
                self.clock.advance(dt)
            self.ticks += 1
            if self.ticks >= self.max_ticks:
                self._done = True
                return ("tick", 0.0)
        elif self.idx < len(self.requests):
            gap = max(self.requests[self.idx].arrival - now, 0.0)
            if self.deterministic:
                self.clock.advance(gap)
                status, wait = "idle", 0.0
            else:
                status, wait = "idle", gap
        if self.monitor is not None:
            self.monitor.advance(self.clock())
        return (status, wait)

    def _submit(self, r: Request) -> None:
        self.owner[r.model].submit(r)
        if self.monitor is not None:
            self.monitor.observe(r.model)

    def report(self) -> ServeReport:
        if self._report is not None:
            return self._report
        wall_s = time.perf_counter() - self._wall0
        if self.monitor is not None:
            self.monitor.advance(self.clock())  # close trailing windows
        horizon = max([self.clock()]
                      + [r.finish for r in self.requests if r.finish >= 0])
        by_model: Dict[str, List[Request]] = {n: [] for n in self.engines}
        for r in self.requests:
            by_model.setdefault(r.model, []).append(r)
        per_llm = {n: _roll_up(n, rs, horizon, self.slo_scales, self.ref_fn)
                   for n, rs in by_model.items()}
        agg = _roll_up("aggregate", self.requests, horizon,
                       self.slo_scales, self.ref_fn)
        shares: Dict[str, float] = {}
        for u in self.units:
            if u.enforce_shares:
                shares.update({n: u.sm_frac.get(n, 1.0)
                               for n in u.engines})
        self._report = ServeReport(
            horizon=horizon, wall_s=wall_s, ticks=self.ticks,
            deterministic=self.deterministic, slo_scales=self.slo_scales,
            per_llm=per_llm, aggregate=agg,
            planned_rates=self.planned0,
            rate_estimates=(dict(self.monitor.rate_ewma)
                            if self.monitor else {}),
            sm_frac=shares)
        return self._report


def serve_requests(units: Sequence[MuxScheduler], requests: List[Request],
                   slo_scales: Sequence[float] = DEFAULT_SLO_SCALES,
                   cost: Optional[TickCostModel] = None,
                   refs: Optional[Dict[str, SLORef]] = None,
                   warm: bool = True,
                   max_ticks: int = 500_000,
                   planned_rates: Optional[Dict[str, float]] = None
                   ) -> ServeReport:
    """Drive real units through an arrival-ordered request list and roll
    the ``Request`` timelines up into a ``ServeReport``.

    ``cost`` set → deterministic mode: a ``LogicalClock`` advances by
    the max per-unit tick cost each iteration and SLO references are
    analytic under the same constants.  ``cost`` unset → realtime: wall
    clock, per-engine calibrated references (``refs`` overrides
    calibration), and — unless ``warm=False`` — a warm-up replay of the
    trace first.  ``planned_rates`` enables the drift monitor."""
    session = ServeSession(units, requests, slo_scales=slo_scales,
                           cost=cost, refs=refs, warm=warm,
                           max_ticks=max_ticks, planned_rates=planned_rates)
    while True:
        status, wait = session.step()
        if status == "done":
            break
        if status == "idle" and not session.deterministic:
            time.sleep(min(wait, 0.005))
    return session.report()


def serve_workload(units: Sequence[MuxScheduler], wl: Workload,
                   seed: int = 0, max_new_cap: int = 0,
                   slo_scales: Sequence[float] = DEFAULT_SLO_SCALES,
                   cost: Optional[TickCostModel] = None,
                   refs: Optional[Dict[str, SLORef]] = None,
                   max_ticks: int = 500_000) -> ServeReport:
    """``serve_requests`` over a ``core/workload.py`` trace.  The trace's
    per-LLM rates feed the drift monitor as the planned baseline."""
    engines: Dict[str, Engine] = {}
    for u in units:
        engines.update(u.engines)
    reqs = requests_from_workload(wl, engines, seed=seed,
                                  max_new_cap=max_new_cap)
    return serve_requests(units, reqs, slo_scales=slo_scales, cost=cost,
                          refs=refs, max_ticks=max_ticks,
                          planned_rates=dict(wl.rates))
