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

  * **placement → runtime**: ``units_from_placement`` builds one real
    unit per populated mesh of a ``core/placement.py`` plan, with the
    plan's compute shares enforced.

Graceful degradation and the live serving layer, all default-off:
``faults`` (a ``FaultPlan`` or ``FaultInjector``) arms fault injection on
every unit and charges each recovery's modeled stall to the logical
clock; ``shed_scale`` stamps deadlines for deadline-shedding units; a
watchdog sheds a stalled run's pending work; ``metrics`` records the
serving taxonomy of ``serving/metrics.py`` and embeds its snapshot in
the report; ``route_fn`` resolves family-named requests at submit time
(``serving/router.py``); ``sanitize`` re-checks the runtime invariants
after every tick (``serving/sanitize.py``).  The async front end
(``serving/frontend.py``) drives the same ``ServeSession`` stepper.  The
reconfiguration controller arrives with the live-reconfiguration slice.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.config import BLOCK_TOKENS, replace
from repro_torch.core.placement import Placement
from repro_torch.core.workload import Workload
from repro_torch.models.transformer import init_params
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.faults import FaultInjector, RecoveryCostModel
from repro_torch.serving.kvcache import UnifiedKVPool
from repro_torch.serving.mux import MuxScheduler
from repro_torch.serving.reconfig import WorkloadMonitor
from repro_torch.serving.sanitize import SessionSanitizer, sanitize_enabled

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
                          params: Optional[Sequence[dict]] = None,
                          max_queue: Optional[int] = None,
                          shed_policy: str = "none"
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
    ``seed + i``.  ``sm_fracs`` turns on share enforcement;
    ``max_queue`` and ``shed_policy`` arm the scheduler's degradation
    ladder.
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
                        sm_frac=sm_fracs, max_queue=max_queue,
                        shed_policy=shed_policy)


def units_from_placement(pl: Placement, pool_blocks: int = 200_000,
                         max_slots: int = 4, chunk_tokens: int = 0,
                         seed: int = 0, policy: str = "adbs",
                         fused: bool = False,
                         enforce_shares: bool = True,
                         reduced: bool = True, dtype=torch.bfloat16,
                         device="cuda",
                         params: Optional[Dict[str, dict]] = None,
                         max_queue: Optional[int] = None,
                         shed_policy: str = "none"
                         ) -> List[MuxScheduler]:
    """The placement → runtime bridge: one real unit per non-empty mesh
    of an optimizer plan (group membership = the mesh's LLM set, fused
    where architectures match).  Pool blocks are split across meshes ∝
    mesh size (at least 4096 each) — the runtime stand-in for per-mesh
    HBM — and mesh ``m`` draws its weights from seed ``seed + m.mesh_id``
    as the JAX package's bridge does.

    Each spec's planned ``sm_frac`` is threaded into its unit: the
    scheduler enforces the shares and the deterministic clock charges
    phases by them.  ``enforce_shares=False`` builds the same units
    with temporal accounting — the pure-temporal baseline.  ``reduced``,
    ``dtype``, ``device``, ``max_queue`` and ``shed_policy`` pass
    through to ``build_unit_from_specs``;
    ``params`` maps spec names to weight trees (e.g. the JAX package's
    carried across by ``models.transformer.params_to_torch``)."""
    total_dev = sum(m.n_devices for m in pl.meshes if m.specs) or 1
    units: List[MuxScheduler] = []
    for m in pl.meshes:
        if not m.specs:
            continue
        blocks = max(int(pool_blocks * m.n_devices / total_dev), 4096)
        unit_specs = [(s.name, s.arch_id, s.rate) for s in m.specs]
        sm = {s.name: float(s.sm_frac) for s in m.specs}
        u = build_unit_from_specs(
            unit_specs, pool_blocks=blocks, max_slots=max_slots,
            chunk_tokens=chunk_tokens, seed=seed + m.mesh_id,
            policy=policy, fused=fused, reduced=reduced,
            sm_fracs=(sm if enforce_shares else None), dtype=dtype,
            device=device,
            params=(None if params is None
                    else [params[s.name] for s in m.specs]),
            max_queue=max_queue, shed_policy=shed_policy)
        # mesh identity, and mesh size for the deterministic clock's
        # per-unit tick scaling
        u.mesh_id = m.mesh_id
        u.n_devices = m.n_devices
        units.append(u)
    if not units:
        raise ValueError("placement has no populated mesh")
    return units


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
class FaultSummary:
    """Fault-injection/degradation section of a ``ServeReport``
    (``serving/faults.py``): what the plan fired, what the runtime did
    to survive it, and what the recoveries cost on the deterministic
    clock."""
    injected: int = 0            # plan events that fired
    unfired: int = 0             # plan events that never fired
    recoveries: int = 0          # engine rebuilds (crash + escalation)
    block_losses: int = 0
    migration_aborts: int = 0
    watchdog_trips: int = 0
    requeued: int = 0            # requests torn down and requeued
    blocks_lost: int = 0         # arena head-blocks lost to block_loss
    dt_charged: float = 0.0      # modeled recovery stall (logical s)
    log: List[dict] = field(default_factory=list)

    def to_json(self) -> dict:
        return {"injected": self.injected, "unfired": self.unfired,
                "recoveries": self.recoveries,
                "block_losses": self.block_losses,
                "migration_aborts": self.migration_aborts,
                "watchdog_trips": self.watchdog_trips,
                "requeued": self.requeued,
                "blocks_lost": self.blocks_lost,
                "dt_charged": self.dt_charged, "log": self.log}


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
    # the JAX package's reconfiguration and prefix-cache sections: their
    # slices fill them, until then they stay empty so the JSON keeps the
    # schema
    reconfig: Optional[dict] = None
    faults: Optional[FaultSummary] = None
    prefix: Dict[str, dict] = field(default_factory=dict)
    schema_version: int = SERVE_REPORT_SCHEMA_VERSION
    # final ServingMetrics snapshot, when the run was served with one
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
        lines.append(f"aggregate: shed={a.shed} retried={a.retried} "
                     f"recovered={a.recovered}"
                     + (f" cancelled={a.cancelled}" if a.cancelled else "")
                     + (" (shed by: "
                        + ", ".join(f"{k}={v}" for k, v
                                    in sorted(a.shed_reasons.items()))
                        + ")" if a.shed_reasons else ""))
        for name, r in self.per_llm.items():
            att = ", ".join(f"{s:g}×:{r.attainment[s]:.0%}"
                            for s in self.slo_scales)
            lines.append(f"{name}: {r.finished}/{r.submitted} "
                         f"ttft_p99={r.ttft.p99:.3f}s "
                         f"tpot_p99={r.tpot.p99 * 1e3:.1f}ms "
                         f"e2e_p99={r.e2e.p99:.2f}s | SLO[{att}] | "
                         f"shed={r.shed} retried={r.retried} "
                         f"recovered={r.recovered}")
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
        if self.faults is not None:
            f = self.faults
            lines.append(
                f"faults: {f.injected} injected ({f.unfired} unfired) → "
                f"{f.recoveries} engine recoveries, "
                f"{f.block_losses} block losses "
                f"({f.blocks_lost} head-blocks), "
                f"{f.migration_aborts} migration aborts, "
                f"{f.watchdog_trips} watchdog trips | "
                f"{f.requeued} requeued "
                f"({f.dt_charged * 1e3:.1f}ms charged)")
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
                "reconfig": self.reconfig,
                "faults": (self.faults.to_json()
                           if self.faults else None),
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
    """One serving run, decomposed into explicit steps.

    The closed-loop driver (``serve_requests``) and the async front end
    (``serving/frontend.py``) drive the SAME stepper: ``__init__`` does
    the setup (ownership map, clock install, SLO references, injector
    threading, deadline stamping, drift monitor, sanitizer), ``step()``
    runs one loop iteration (submit due arrivals → tick busy units or
    account an idle gap → drain fault events → watchdog → monitor), and
    ``report()`` rolls the timelines up.  Because the front end replays
    the identical iteration, streamed serving is bit-identical to the
    closed-loop driver under the deterministic clock by construction.

    Front-end extensions (all default-off):

    * ``route_fn(request) -> engine_name`` — cross-LLM routing, applied
      when a request is SUBMITTED, so load-aware strategies see the
      live queue and pool state; the request's ``model`` is rewritten to
      the chosen engine.
    * ``metrics`` — a ``ServingMetrics`` bundle: the session records
      lifecycle counters, latency histograms, queue/pool gauges and
      fault events, and embeds the final snapshot in the report.
    * ``on_topology_change()`` — for a router to refresh its view when
      engines move between units (live reconfiguration, a later slice;
      nothing calls it yet).
    * ``cancel(request)`` — client abandonment: frees the request's
      queue position or slot and KV at once, counted as ``cancelled``.
    """

    def __init__(self, units: Sequence[MuxScheduler],
                 requests: List[Request],
                 slo_scales: Sequence[float] = DEFAULT_SLO_SCALES,
                 cost: Optional[TickCostModel] = None,
                 refs: Optional[Dict[str, SLORef]] = None,
                 warm: bool = True,
                 max_ticks: int = 500_000,
                 planned_rates: Optional[Dict[str, float]] = None,
                 faults=None,
                 recovery_cost: Optional[RecoveryCostModel] = None,
                 watchdog_ticks: int = 1000,
                 shed_scale: Optional[float] = None,
                 metrics=None,
                 route_fn: Optional[Callable[[Request], str]] = None,
                 on_topology_change: Optional[Callable[[], None]] = None,
                 sanitize: bool = False):
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
        self.watchdog_ticks = watchdog_ticks
        self.slo_scales = tuple(slo_scales)
        self.metrics = metrics
        self.route_fn = route_fn
        self.on_topology_change = on_topology_change
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

        # fault injection: one injector serves every unit; recovery
        # stalls are priced like any tick
        self.injector: Optional[FaultInjector] = None
        if faults is not None:
            self.injector = (faults if isinstance(faults, FaultInjector)
                             else FaultInjector(faults))
            for u in self.units:
                u.injector = self.injector
        self.recovery_cost = (recovery_cost if recovery_cost is not None
                              else RecoveryCostModel())

        # deadline stamping for deadline-shedding units: the latest
        # admission instant that still meets the scaled TTFT target at
        # solo speed (ref with output_len 0 IS the solo TTFT reference).
        # Family-routed requests are stamped at submit time instead.
        self._deadline_models = {
            n for u in self.units if u.shed_policy == "deadline"
            for n in u.engines}
        s = shed_scale if shed_scale is not None else max(self.slo_scales)
        self._deadline_slack = max(s - 1.0, 0.0)
        if self._deadline_models:
            for r in requests:
                if r.model in self._deadline_models:
                    r.deadline = r.arrival + self._deadline_slack *\
                        self.ref_fn(r.model, len(r.prompt), 0)

        self.monitor: Optional[WorkloadMonitor] = (
            WorkloadMonitor(planned_rates) if planned_rates is not None
            else None)
        self.planned0 = dict(self.monitor.planned) if self.monitor else {}
        self.requests = sorted(requests, key=lambda r: r.arrival)
        self.idx, self.ticks = 0, 0
        self.fault_log: List[dict] = []
        self.fault_dt = 0.0
        self.watchdog_trips = 0
        self._stall_run, self._last_progress = 0, -1
        self._submitted: set = set()             # id(request)
        self._done = False
        self._report: Optional[ServeReport] = None
        # per-unit indexes into stats.finished / stats.shed, so metrics
        # observation sees each disposition exactly once
        self._fin_idx = [0] * len(self.units)
        self._shed_idx = [0] * len(self.units)
        self._wall0 = time.perf_counter()
        # runtime invariant sanitizer: a pure reader re-validating the
        # pool, scheduler and disposition laws after every busy tick
        self.sanitizer = None
        if sanitize or sanitize_enabled():
            self.sanitizer = SessionSanitizer(self)

    def step(self) -> Tuple[str, float]:
        """Run ONE serving-loop iteration.  Returns ``(status, wait)``:
        ``("tick", 0.0)`` when a unit ticked, ``("idle", gap)`` when
        nothing is pending until the next arrival (deterministic mode
        has advanced the clock already; realtime callers sleep up to
        ``wait``), ``("done", 0.0)`` when the trace drained or
        ``max_ticks`` was hit."""
        if self._done or (self.idx >= len(self.requests)
                          and not any(u.pending() for u in self.units)):
            if not self._done and self.sanitizer is not None:
                self.sanitizer.check("drain")
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
            # recovery events of this round's ticks: charge their
            # modeled stall (deterministic mode) and log them
            for u in busy:
                for rec in u.fault_events:
                    if self.deterministic:
                        dt_r = self.recovery_cost.dt(
                            rec.get("requeued", 0), rec.get("blocks", 0))
                        self.clock.advance(dt_r)
                        self.fault_dt += dt_r
                        rec["dt_charged"] = dt_r
                    self.fault_log.append(rec)
                    if self.metrics is not None:
                        self._observe_fault(rec)
                u.fault_events.clear()
            # watchdog: zero progress (no tokens moved, nothing finished
            # or shed) across watchdog_ticks consecutive busy ticks —
            # shed everything pending so the run terminates with
            # submitted = finished + shed (+ cancelled)
            progress = sum(u.stats.prefill_tokens + u.stats.decode_tokens
                           + len(u.stats.finished) + len(u.stats.shed)
                           for u in self.units)
            if progress == self._last_progress:
                self._stall_run += 1
                if self.watchdog_ticks\
                        and self._stall_run >= self.watchdog_ticks:
                    shed_n = sum(u.shed_all("watchdog")
                                 for u in self.units)
                    self.watchdog_trips += 1
                    self.fault_log.append(
                        {"kind": "watchdog", "t": self.clock(),
                         "shed": shed_n,
                         "stalled_ticks": self._stall_run})
                    if self.metrics is not None:
                        self.metrics.watchdog_trips.inc()
                        self.metrics.fault_events.inc(kind="watchdog")
                    self._stall_run = 0
            else:
                self._stall_run = 0
            self._last_progress = progress
            if self.metrics is not None:
                self._observe_tick(busy)
            if self.sanitizer is not None:
                self.sanitizer.check(f"tick {self.ticks}")
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

    # -- submission / cancellation ---------------------------------------
    def _submit(self, r: Request) -> None:
        if r.cancelled:
            # cancelled before its arrival: never enters a unit, still
            # counted (submitted = finished + shed + cancelled)
            return
        if self.route_fn is not None:
            r.model = self.route_fn(r)
            if (r.model in self._deadline_models
                    and r.deadline == float("inf")):
                r.deadline = r.arrival + self._deadline_slack *\
                    self.ref_fn(r.model, len(r.prompt), 0)
        self.owner[r.model].submit(r)
        self._submitted.add(id(r))
        if self.monitor is not None:
            self.monitor.observe(r.model)
        if self.metrics is not None:
            self.metrics.requests_submitted.inc(llm=r.model)
            self.metrics.log.emit(self.clock(), "submit", r.req_id,
                                  llm=r.model, prompt_len=len(r.prompt),
                                  max_new=r.max_new_tokens)

    def cancel(self, req: Request) -> bool:
        """Client abandonment: free the request's resources NOW (queue
        position, or slot and KV blocks via the owning unit's
        ``cancel``).  A request cancelled before its arrival is never
        submitted.  Returns True iff the disposition changed to
        ``cancelled``."""
        if req.finish >= 0 or req.shed or req.cancelled:
            return False
        if id(req) in self._submitted:
            u = self.owner.get(req.model)
            ok = bool(u is not None and u.cancel(req))
        else:
            req.cancelled = True
            ok = True
        if ok and self.metrics is not None:
            self.metrics.requests_cancelled.inc(llm=req.model)
            self.metrics.log.emit(self.clock(), "cancel", req.req_id,
                                  llm=req.model)
        return ok

    # -- metrics observation (pure readers; never mutate serving state) --
    def _observe_tick(self, busy: List[MuxScheduler]) -> None:
        m = self.metrics
        now = self.clock()
        for u in busy:
            for name, t in u.tick_prefill_by.items():
                m.tokens_total.inc(t, llm=name, phase="prefill")
            for name, t in u.tick_decode_by.items():
                m.tokens_total.inc(t, llm=name, phase="decode")
        for ui, u in enumerate(self.units):
            fin = u.stats.finished
            for r in fin[self._fin_idx[ui]:]:
                m.requests_finished.inc(llm=r.model)
                m.ttft_seconds.observe(r.first_token - r.arrival,
                                       llm=r.model)
                m.tpot_seconds.observe(
                    (r.finish - r.first_token)
                    / max(len(r.output) - 1, 1), llm=r.model)
                m.e2e_seconds.observe(r.finish - r.arrival, llm=r.model)
                m.log.emit(now, "finish", r.req_id, llm=r.model,
                           tokens=len(r.output),
                           ttft=r.first_token - r.arrival,
                           e2e=r.finish - r.arrival)
            self._fin_idx[ui] = len(fin)
            shed = u.stats.shed
            for r in shed[self._shed_idx[ui]:]:
                m.requests_shed.inc(llm=r.model, reason=r.shed_reason)
                m.log.emit(now, "shed", r.req_id, llm=r.model,
                           reason=r.shed_reason)
            self._shed_idx[ui] = len(shed)
            for name, eng in u.engines.items():
                m.queue_depth.set(len(u.queues[name]), llm=name)
                m.running_seqs.set(len(eng.active_slots()), llm=name)
                m.pool_used_blocks.set(eng.view.used, llm=name)
            m.pool_available_blocks.set(u.pool.available_blocks(),
                                        unit=f"mesh{u.mesh_id}")
        if now > 1e-9:
            for name in self.owner:
                m.llm_qps.set(
                    m.requests_submitted.value(llm=name) / now, llm=name)

    def _observe_fault(self, rec: dict) -> None:
        m = self.metrics
        m.fault_events.inc(kind=rec.get("kind", "unknown"))
        if rec.get("kind") == "engine_crash":
            m.recoveries.inc(llm=rec.get("target") or "")
        if rec.get("requeued"):
            m.requests_retried.inc(rec["requeued"],
                                   llm=rec.get("target") or "pool")
        m.log.emit(self.clock(), "fault", "-",
                   kind=rec.get("kind"), target=rec.get("target"),
                   requeued=rec.get("requeued", 0))

    # -- roll-up ----------------------------------------------------------
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
            # family-named requests cancelled before routing keep their
            # family name and get their own row
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
        injector, fault_log = self.injector, self.fault_log
        fsum: Optional[FaultSummary] = None
        if injector is not None or fault_log:
            aborts = 0
            if injector is not None:
                aborts = sum(1 for rec in injector.records
                             if rec.get("kind") == "migration_abort")
            fsum = FaultSummary(
                injected=(len(injector.records) if injector else 0),
                unfired=(len(injector.unfired()) if injector else 0),
                recoveries=sum(1 for rec in fault_log
                               if rec["kind"] == "engine_crash"),
                block_losses=sum(1 for rec in fault_log
                                 if rec["kind"] == "block_loss"),
                migration_aborts=aborts,
                watchdog_trips=self.watchdog_trips,
                requeued=sum(rec.get("requeued", 0) for rec in fault_log),
                blocks_lost=sum(rec.get("blocks", 0) for rec in fault_log
                                if rec["kind"] == "block_loss"),
                dt_charged=self.fault_dt,
                log=fault_log)
        self._report = ServeReport(
            horizon=horizon, wall_s=wall_s, ticks=self.ticks,
            deterministic=self.deterministic, slo_scales=self.slo_scales,
            per_llm=per_llm, aggregate=agg,
            planned_rates=self.planned0,
            rate_estimates=(dict(self.monitor.rate_ewma)
                            if self.monitor else {}),
            sm_frac=shares, faults=fsum,
            metrics=(self.metrics.snapshot()
                     if self.metrics is not None else None))
        return self._report


def serve_requests(units: Sequence[MuxScheduler], requests: List[Request],
                   slo_scales: Sequence[float] = DEFAULT_SLO_SCALES,
                   cost: Optional[TickCostModel] = None,
                   refs: Optional[Dict[str, SLORef]] = None,
                   warm: bool = True,
                   max_ticks: int = 500_000,
                   planned_rates: Optional[Dict[str, float]] = None,
                   faults=None,
                   recovery_cost: Optional[RecoveryCostModel] = None,
                   watchdog_ticks: int = 1000,
                   shed_scale: Optional[float] = None,
                   metrics=None,
                   sanitize: bool = False
                   ) -> ServeReport:
    """Drive real units through an arrival-ordered request list and roll
    the ``Request`` timelines up into a ``ServeReport`` (a synchronous
    loop over ``ServeSession``).

    ``cost`` set → deterministic mode: a ``LogicalClock`` advances by
    the max per-unit tick cost each iteration and SLO references are
    analytic under the same constants.  ``cost`` unset → realtime: wall
    clock, per-engine calibrated references (``refs`` overrides
    calibration), and — unless ``warm=False`` — a warm-up replay of the
    trace first.  ``planned_rates`` enables the drift monitor.

    Graceful degradation: ``faults`` (a ``FaultPlan`` or
    ``FaultInjector``) is threaded onto every unit, whose recovery
    events the loop drains each iteration, charging
    ``recovery_cost.dt(requeued, blocks)`` to the logical clock.  A
    unit with ``shed_policy="deadline"`` gets each of its requests
    stamped with the admission deadline ``arrival + (s − 1)·ttft_ref``
    (s = ``shed_scale``, default ``max(slo_scales)``).  The watchdog
    sheds every pending request after ``watchdog_ticks`` busy ticks
    without progress (0 disables it).  ``metrics`` (a
    ``ServingMetrics``) records the run and rides in the report;
    ``sanitize`` checks the runtime invariants after every tick."""
    session = ServeSession(
        units, requests, slo_scales=slo_scales, cost=cost, refs=refs,
        warm=warm, max_ticks=max_ticks, planned_rates=planned_rates,
        faults=faults, recovery_cost=recovery_cost,
        watchdog_ticks=watchdog_ticks, shed_scale=shed_scale,
        metrics=metrics, sanitize=sanitize)
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
                   max_ticks: int = 500_000,
                   faults=None,
                   recovery_cost: Optional[RecoveryCostModel] = None,
                   watchdog_ticks: int = 1000,
                   shed_scale: Optional[float] = None,
                   metrics=None,
                   sanitize: bool = False) -> ServeReport:
    """``serve_requests`` over a ``core/workload.py`` trace.  The trace's
    per-LLM rates feed the drift monitor as the planned baseline."""
    engines: Dict[str, Engine] = {}
    for u in units:
        engines.update(u.engines)
    reqs = requests_from_workload(wl, engines, seed=seed,
                                  max_new_cap=max_new_cap)
    return serve_requests(units, reqs, slo_scales=slo_scales, cost=cost,
                          refs=refs, max_ticks=max_ticks,
                          planned_rates=dict(wl.rates), faults=faults,
                          recovery_cost=recovery_cost,
                          watchdog_ticks=watchdog_ticks,
                          shed_scale=shed_scale, metrics=metrics,
                          sanitize=sanitize)
