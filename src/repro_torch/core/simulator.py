"""Discrete-event cluster simulator for multi-LLM serving (copy of
``repro/core/simulator.py``).

Reproduces the paper's evaluation (Figs. 5, 7, 8, 9, 10) without GPUs:
job latencies come from the roofline cost model (core/costmodel.py) —
the same substitution the paper itself makes for its estimator ("the
prefill and decoding latency ... can be profiled in advance", §3.3).

Execution model per LLM unit (mesh + colocated LLMs), per round:

  * ``spatial-temporal`` (MuxServe): at most one prefill job runs per
    round (round-robin, prioritized); decode jobs of all colocated LLMs
    run *concurrently* with each other after it (decode-decode
    colocation), each at its placement compute-fraction ``f``:
        t_round = t_prefill + max_m t_decode_m            (Eq. 3 shape)
  * ``temporal`` (AlpaServe-style): jobs serialize, each takes the
    whole mesh (f = 1):
        t_round = t_prefill + Σ_m t_decode_m
  * ``spatial`` partitioning: one LLM per unit, continuous batching:
        t_round = t_prefill + t_decode

Scheduling policies *within* spatial-temporal units (Fig. 9):
  ``adbs``        prefill priority round-robin + KV quota + adaptation
  ``round_robin`` no prefill priority (alternating), fixed quotas
  ``fcfs``        strict arrival order across LLMs, no quotas

Runtime counterpart: ``serving/mux.MuxScheduler`` runs the same three
policy branches over REAL engines, and ``serving/driver.py`` measures
them under the same SLO conventions (DESIGN.md §9) on the same
``core/workload.py`` traces — each policy-bearing method below names
its runtime twin so the two implementations stay auditable against
each other.

KV accounting is in bytes of the unit's unified pool: capacity =
unit HBM − weights − activation reserve; per-LLM quotas bound usage and
ADBS re-allocates quota from low- to high-utilization LLMs periodically
(Alg. 3's ``adapt_quota_periodically``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import costmodel as cm
from repro_torch.core.costmodel import A100, Hardware
from repro_torch.core.estimator import LLMSpec
from repro_torch.core.placement import Placement
from repro_torch.core.workload import RequestSpec, Workload


@dataclass
class SimRequest:
    spec: RequestSpec
    prefill_end: float = -1.0
    finish: float = -1.0
    tokens_done: int = 0

    @property
    def latency(self) -> float:
        return self.finish - self.spec.arrival


@dataclass
class LLMState:
    spec: LLMSpec
    waiting: List[SimRequest] = field(default_factory=list)
    running: List[SimRequest] = field(default_factory=list)
    kv_bytes: float = 0.0
    quota: float = 0.0             # KV byte quota (ADBS)
    finished: List[SimRequest] = field(default_factory=list)
    next_arrival_idx: int = 0

    def kv_cost(self, req: SimRequest, extra_tokens: int) -> float:
        per_tok = self.spec.cfg.kv_bytes_per_token()
        if self.spec.cfg.ssm and per_tok == 0:
            return 0.0 if req.tokens_done else self._ssm_bytes()
        return extra_tokens * per_tok

    def _ssm_bytes(self) -> float:
        c = self.spec.cfg
        if not c.ssm:
            return 0.0
        return c.n_ssm_layers * c.n_ssm_heads * c.ssm.head_dim\
            * c.ssm.d_state * 4.0


class UnitSim:
    """One LLM unit: colocated LLMs sharing a mesh + unified KV pool."""

    def __init__(self, specs: Sequence[LLMSpec], n_devices: int,
                 mode: str = "spatial-temporal", policy: str = "adbs",
                 hw: Hardware = A100, max_batch: int = 64,
                 adapt_every: int = 32, activation_frac: float = 0.08,
                 equal_quota: bool = False):
        self.hw = hw
        self.mode = mode
        self.policy = policy
        self.n_devices = n_devices
        self.max_batch = max_batch
        self.adapt_every = adapt_every
        self.llms: Dict[str, LLMState] = {
            s.name: LLMState(spec=s) for s in specs}
        w_bytes = sum(s.cfg.weight_bytes() for s in specs)
        total = hw.hbm_bytes * n_devices
        self.kv_capacity = max(total * (1 - activation_frac) - w_bytes,
                               total * 0.05)
        # initial quota ∝ rate (popular LLMs start with more cache);
        # ``equal_quota`` models static per-LLM partitions (Fig. 10's
        # "no unified memory manager" ablation arm)
        rate_sum = sum(s.rate for s in specs) or 1.0
        for st in self.llms.values():
            if equal_quota:
                st.quota = self.kv_capacity / len(specs)
            elif policy == "fcfs":
                st.quota = self.kv_capacity
            else:
                st.quota = self.kv_capacity * (st.spec.rate / rate_sum)
        self.clock = 0.0
        self._prefill_rr = 0
        self._round = 0
        self._names = [s.name for s in specs]
        self.kv_used = 0.0
        self.busy_time = 0.0

    # ------------------------------------------------------------------
    def load(self, requests: Sequence[RequestSpec]) -> None:
        self._pending = sorted((SimRequest(r) for r in requests
                                if r.model in self.llms),
                               key=lambda r: r.spec.arrival)
        self._pending_idx = 0

    def _admit_arrivals(self) -> None:
        while self._pending_idx < len(self._pending) and\
                self._pending[self._pending_idx].spec.arrival <= self.clock:
            r = self._pending[self._pending_idx]
            self.llms[r.spec.model].waiting.append(r)
            self._pending_idx += 1

    def _next_arrival(self) -> Optional[float]:
        if self._pending_idx < len(self._pending):
            return self._pending[self._pending_idx].spec.arrival
        return None

    def _has_work(self) -> bool:
        return any(st.waiting or st.running for st in self.llms.values())

    # ------------------------------------------------------------------
    def _lifetime_cost(self, st: LLMState, r: SimRequest) -> float:
        """Whole-lifetime KV reservation (Alg. 3's resource_enough also
        gates decode jobs; reserving prompt+output at admission is the
        preemption-free equivalent).  Runtime twin:
        ``Engine.lifetime_blocks`` — same prompt+output+1 rule, in
        head-blocks instead of bytes (plus SSM state pages)."""
        if st.spec.cfg.ssm:
            return st._ssm_bytes() or 1.0
        per_tok = st.spec.cfg.kv_bytes_per_token()
        return (r.spec.prompt_len + r.spec.output_len + 1) * per_tok or 1.0

    def _try_prefill_batch(self, st: LLMState) -> List[SimRequest]:
        """Admit waiting requests of one LLM into a prefill job (quota-
        and pool-capacity-bounded) — Alg. 3's ``resource_enough`` gate
        over Eq. 2's per-LLM cache share.  Runtime twin:
        ``MuxScheduler._pull_batch`` + ``Engine.can_admit``
        (cumulative lifetime check across the batch)."""
        batch: List[SimRequest] = []
        free_pool = self.kv_capacity - self.kv_used
        quota_room = st.quota - st.kv_bytes
        budget = min(free_pool, quota_room)
        slots = self.max_batch - len(st.running)
        while st.waiting and len(batch) < slots:
            r = st.waiting[0]
            cost = self._lifetime_cost(st, r)
            if cost > budget:
                break
            budget -= cost
            st.waiting.pop(0)
            batch.append(r)
        return batch

    def _do_prefill(self, st: LLMState, batch: List[SimRequest],
                    f: float) -> float:
        if not batch:
            return 0.0
        seq = max(r.spec.prompt_len for r in batch)
        t = cm.prefill_latency(st.spec.cfg, len(batch), seq,
                               tp=st.spec.tp, f=f, hw=self.hw)
        for r in batch:
            cost = self._lifetime_cost(st, r)
            st.kv_bytes += cost
            self.kv_used += cost
            r.tokens_done = 1
            r.prefill_end = self.clock + t
            st.running.append(r)
        return t

    def _do_decode(self, st: LLMState, f: float) -> float:
        if not st.running:
            return 0.0
        ctx = float(np.mean([r.spec.prompt_len + r.tokens_done
                             for r in st.running]))
        t = cm.decode_latency(st.spec.cfg, len(st.running), ctx,
                              tp=st.spec.tp, f=f, hw=self.hw)
        return t

    def _finish_decode(self, st: LLMState, end: float) -> None:
        still = []
        for r in st.running:
            r.tokens_done += 1
            if r.tokens_done >= r.spec.output_len:
                r.finish = end
                freed = self._lifetime_cost(st, r)
                st.kv_bytes -= freed
                self.kv_used -= freed
                st.finished.append(r)
            else:
                still.append(r)
        st.running = still

    # ------------------------------------------------------------------
    def _adapt_quotas(self) -> None:
        """Alg. 3's ``adapt_quota_periodically``: move KV quota from
        low- to high-utilization LLMs.  Runtime twin:
        ``UnifiedKVPool.adapt_quotas`` (same low→high move, bounded
        step, min-quota floor), invoked from ``MuxScheduler.tick``
        every ``adapt_every`` ticks."""
        if len(self.llms) < 2:
            return
        util = {}
        demand = {}
        for n, st in self.llms.items():
            util[n] = st.kv_bytes / st.quota if st.quota > 0 else 1.0
            demand[n] = len(st.waiting)
        lo = min(util, key=lambda n: (util[n], demand[n]))
        hi = max(util, key=lambda n: (util[n], demand[n]))
        if util[hi] - util[lo] < 0.2 and demand[hi] == 0:
            return
        st_lo, st_hi = self.llms[lo], self.llms[hi]
        spare = st_lo.quota - st_lo.kv_bytes
        move = min(spare * 0.5, self.kv_capacity * 0.1)
        min_quota = self.kv_capacity * 0.02
        if move > 0 and st_lo.quota - move >= min_quota:
            st_lo.quota -= move
            st_hi.quota += move

    # ------------------------------------------------------------------
    def _round_spatial_temporal(self) -> float:
        """MuxServe round (Eq. 3 shape): prefill jobs of the colocated
        LLMs execute back-to-back (prioritized, round-robin order, each
        at full compute — a prefill job takes the SMs it needs, Fig. 4
        step 1), then decode jobs of all LLMs run concurrently at their
        placement fractions:

            t_round = Σ_i t_p^i + max_m t_d^m

        Policy variants: ``fcfs`` admits prefills in strict global
        arrival order and only when nothing decodes (the Fig. 9
        baseline); ``round_robin`` is the ADBS loop without quota
        adaptation (fixed quotas).

        Runtime twin: ``MuxScheduler.tick`` — same branch structure
        (prefill-priority round-robin, decode fill, periodic quota
        adaptation), but over real engines where "decode jobs run
        concurrently" is realized as the fused multi-LLM sweep
        (DESIGN.md §2) instead of Eq. 3's max over decode times."""
        n = len(self._names)
        t_prefill = 0.0
        if self.policy == "fcfs":
            # strict arrival order: only the globally-oldest waiting
            # request's LLM may prefill, and only if no decode running
            oldest, oname = math.inf, None
            for name, st in self.llms.items():
                if st.waiting and st.waiting[0].spec.arrival < oldest:
                    oldest, oname = st.waiting[0].spec.arrival, name
            any_running = any(st.running for st in self.llms.values())
            if oname is not None and not any_running:
                st = self.llms[oname]
                batch = self._try_prefill_batch(st)
                t_prefill = self._do_prefill(st, batch, 1.0)
        else:
            for i in range(n):
                name = self._names[(self._prefill_rr + i) % n]
                st = self.llms[name]
                if not st.waiting:
                    continue
                batch = self._try_prefill_batch(st)
                if batch:
                    t_prefill += self._do_prefill(st, batch, 1.0)
            self._prefill_rr = (self._prefill_rr + 1) % n
        # concurrent decode jobs (decode-decode colocation)
        t_dec = 0.0
        deced = []
        for st in self.llms.values():
            t = self._do_decode(st, st.spec.sm_frac)
            if t > 0:
                deced.append(st)
                t_dec = max(t_dec, t)
        t_round = t_prefill + t_dec
        end = self.clock + t_round
        for st in deced:
            self._finish_decode(st, end)
        if self.policy == "adbs":
            self._round += 1
            if self._round % self.adapt_every == 0:
                self._adapt_quotas()
        else:
            self._round += 1
        return t_round

    def _round_temporal(self) -> float:
        """AlpaServe-style: serialized jobs, each at f=1.  Runtime
        twin: the ``fcfs`` branch of ``MuxScheduler.tick`` (oldest
        waiting request picks the LLM, prefill+decode batch-wise to
        completion, no quotas)."""
        t_total = 0.0
        # FCFS across LLMs: oldest waiting request picks the prefill
        oldest, oname = math.inf, None
        for name, st in self.llms.items():
            if st.waiting and st.waiting[0].spec.arrival < oldest:
                oldest, oname = st.waiting[0].spec.arrival, name
        if oname is not None:
            st = self.llms[oname]
            batch = self._try_prefill_batch(st)
            t_total += self._do_prefill(st, batch, 1.0)
        deced = []
        for st in self.llms.values():
            t = self._do_decode(st, 1.0)
            if t > 0:
                t_total += t
                deced.append(st)
        end = self.clock + t_total
        for st in deced:
            self._finish_decode(st, end)
        return t_total

    # ------------------------------------------------------------------
    def run(self, horizon: float, max_rounds: int = 2_000_000) -> None:
        rounds = 0
        while rounds < max_rounds:
            self._admit_arrivals()
            if not self._has_work():
                nxt = self._next_arrival()
                if nxt is None:
                    break
                self.clock = nxt
                continue
            if self.mode == "temporal":
                dt = self._round_temporal()
            else:
                dt = self._round_spatial_temporal()
            if dt <= 0:
                # quota-blocked with nothing running: force smallest job
                nxt = self._next_arrival()
                if nxt is not None and nxt > self.clock:
                    self.clock = nxt
                    continue
                dt = 1e-3
            self.clock += dt
            self.busy_time += dt
            rounds += 1

    # ------------------------------------------------------------------
    def results(self) -> List[SimRequest]:
        out = []
        for st in self.llms.values():
            out.extend(st.finished)
        return out


# ---------------------------------------------------------------------------
# cluster-level driver + metrics
# ---------------------------------------------------------------------------
@dataclass
class SimReport:
    throughput: float                      # finished req/s (aggregate)
    rate_weighted_tpt: float               # paper's weighted metric
    slo_attainment: Dict[float, float]     # slo_scale → attainment
    p99_latency: float
    p99_ttft: float
    p99_tpot: float
    finished: int
    submitted: int
    kv_util_by_llm: Dict[str, float] = field(default_factory=dict)
    # per-LLM finished req/s — the runtime's ``LLMReport.throughput``
    # twin, so sim↔runtime throughput ORDERINGS are directly comparable
    # (tests/test_torch_placement_serve.py gates on this for shared
    # placements)
    per_llm_tpt: Dict[str, float] = field(default_factory=dict)

    def summary(self) -> str:
        att = ", ".join(f"{k:g}×:{v:.2%}" for k, v in
                        sorted(self.slo_attainment.items()))
        return (f"tpt={self.throughput:.2f} req/s (weighted "
                f"{self.rate_weighted_tpt:.2f}), SLO[{att}], "
                f"p99 lat={self.p99_latency:.2f}s ttft={self.p99_ttft:.2f}s "
                f"tpot={self.p99_tpot * 1e3:.1f}ms, "
                f"{self.finished}/{self.submitted} finished")


def _slo_reference_latency(spec: LLMSpec, req: RequestSpec,
                           hw: Hardware) -> float:
    """Single-job dedicated-hardware latency (the paper's 'single device
    execution latency', min-TP for models that need >1 device).

    This is the simulator's side of the shared SLO convention
    (DESIGN.md §9: attained iff E2E ≤ scale × reference).  Runtime
    twins: ``serving/driver.calibrate_slo_refs`` (measured solo
    probes) and ``TickCostModel.solo_reference`` (analytic, for the
    deterministic clock)."""
    tp = cm.weight_devices_needed(spec.cfg, hw)
    t_p = cm.prefill_latency(spec.cfg, 1, req.prompt_len, tp=tp, f=1.0,
                             hw=hw)
    ctx = req.prompt_len + req.output_len / 2
    t_d = cm.decode_latency(spec.cfg, 1, ctx, tp=tp, f=1.0, hw=hw)
    return t_p + req.output_len * t_d


def simulate(placement: Placement, workload: Workload, mode: str,
             policy: str = "adbs", hw: Hardware = A100,
             slo_scales: Sequence[float] = (2, 4, 6, 8, 12, 16),
             max_batch: int = 64, equal_quota: bool = False) -> SimReport:
    per_model = workload.per_model()
    units: List[UnitSim] = []
    for mesh in placement.meshes:
        if not mesh.specs:
            continue
        u = UnitSim(mesh.specs, mesh.n_devices, mode=mode, policy=policy,
                    hw=hw, max_batch=max_batch, equal_quota=equal_quota)
        reqs = [r for s in mesh.specs for r in per_model.get(s.name, [])]
        u.load(reqs)
        units.append(u)
    for u in units:
        u.run(workload.horizon)

    spec_of: Dict[str, LLMSpec] = {
        s.name: s for m in placement.meshes for s in m.specs}
    done: List[Tuple[SimRequest, LLMSpec]] = []
    kv_util: Dict[str, float] = {}
    for u in units:
        for name, st in u.llms.items():
            kv_util[name] = st.quota / u.kv_capacity
        for r in u.results():
            done.append((r, spec_of[r.spec.model]))

    horizon = max((r.finish for r, _ in done), default=workload.horizon)
    horizon = max(horizon, workload.horizon)
    tpt = len(done) / horizon

    # rate-weighted average of per-model throughput (paper §4.1)
    per_tpt: Dict[str, float] = {}
    for name in workload.rates:
        n = sum(1 for r, _ in done if r.spec.model == name)
        per_tpt[name] = n / horizon
    rsum = sum(workload.rates.values()) or 1.0
    weighted = sum(workload.rates[m] * per_tpt.get(m, 0.0)
                   for m in workload.rates) / rsum

    att: Dict[float, float] = {}
    lats, ttfts, tpots = [], [], []
    for r, _spec in done:
        lats.append(r.latency)
        ttfts.append(r.prefill_end - r.spec.arrival)
        tpots.append((r.finish - r.prefill_end)
                     / max(r.spec.output_len - 1, 1))
    for scale in slo_scales:
        ok = 0
        for r, spec in done:
            ref = _slo_reference_latency(spec, r.spec, hw)
            if r.latency <= scale * ref:
                ok += 1
        att[scale] = ok / max(len(done), 1)

    def p99(xs):
        return float(np.percentile(xs, 99)) if xs else float("nan")

    return SimReport(
        throughput=tpt, rate_weighted_tpt=weighted, slo_attainment=att,
        p99_latency=p99(lats), p99_ttft=p99(ttfts), p99_tpot=p99(tpots),
        finished=len(done), submitted=len(workload.requests),
        kv_util_by_llm=kv_util, per_llm_tpt=per_tpt)
