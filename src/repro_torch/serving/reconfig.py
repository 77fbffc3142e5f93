"""Live reconfiguration — drift detection, online re-placement and
zero-downtime engine/KV migration (port of ``repro/serving/reconfig.py``;
host code, the JAX package's line for line).

LLM popularity varies, yet a placement solved once at startup freezes
the spatial layout: a popularity flip mid-trace strands quota, pool
blocks and mesh capacity on yesterday's hot model.  This module is the
control plane that closes the loop at runtime:

  * **WorkloadMonitor** — EWMA per-LLM arrival/token-rate estimates
    over fixed windows of the serving clock, with a hysteresis trigger:
    re-plan only when estimated rates diverge from the planned rates by
    more than a configurable ratio for ``sustain`` consecutive windows.
  * **Online re-planner** — re-runs the placement optimizer's greedy
    assignment (``core/placement.place_onto_meshes``) over the FIXED
    physical meshes on the live estimates, then diffs old and new plans
    into a minimal migration schedule: engine moves between meshes, and
    per-unit quota rebalances and compute-share (``sm_frac``)
    re-assignments, which execute even when no engine moves.
  * **MigrationExecutor** — executes the schedule without dropping a
    request: in-flight decodes *carry* their KV (pages copied into the
    destination pool, ``kvcache.migrate_view``), prefill-phase requests
    are evicted and requeued (restart is exact under greedy decoding),
    queued requests change queues.  Fused groups dissolve and rebuild
    through ``MuxScheduler.remove_engine`` / ``add_engine``.

Time never enters this module on its own: the serving loop pushes its
clock into ``ReconfigController.step(now)``, so under the deterministic
``LogicalClock`` the whole control plane — window boundaries, triggers,
migration costs (``MigrationCostModel``) — is reproducible, and equal to
the JAX package's on the same trace.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.costmodel import A100, Hardware
from repro_torch.core.placement import Placement, place_onto_meshes
from repro_torch.serving.kvcache import migrate_view
from repro_torch.serving.mux import MuxScheduler


# ---------------------------------------------------------------------------
# drift detection
# ---------------------------------------------------------------------------
class WorkloadMonitor:
    """EWMA per-LLM arrival/token-rate estimator with hysteresis.

    Observation is push-based: the serving loop reports every arrival
    (``observe``) and closes windows against its own clock
    (``advance(now)``) — the monitor never reads time itself, so
    deterministic runs stay bit-reproducible.  Each closed
    ``interval``-second window folds the windowed rates into EWMAs:

        r̂ ← (1−α)·r̂ + α·(count / interval)

    Drift for one LLM is ``max(r̂/plan, plan/r̂)`` (symmetric — a model
    going cold strands resources as a model going hot starves), with
    ``eps`` an additive req/s floor on both sides of the ratio, so
    sparse-Poisson noise around near-zero rates cannot arm the trigger.
    The trigger arms only after ``sustain`` consecutive windows whose
    max drift reaches ``threshold``; ``rebase`` adopts a new plan's
    rates as the baseline and disarms.
    """

    def __init__(self, planned_rates: Dict[str, float],
                 interval: float = 1.0, alpha: float = 0.5,
                 threshold: float = 2.0, sustain: int = 2,
                 eps: float = 1.0):
        if not (interval > 0 and 0 < alpha <= 1 and threshold >= 1):
            raise ValueError(f"bad monitor window {interval}, alpha "
                             f"{alpha} or threshold {threshold}")
        self.planned = dict(planned_rates)
        self.interval = float(interval)
        self.alpha = float(alpha)
        self.threshold = float(threshold)
        self.sustain = int(sustain)
        self.eps = float(eps)
        # EWMAs start AT the plan: an undisturbed workload shows zero
        # drift from the first window instead of a cold-start spike
        self.rate_ewma: Dict[str, float] = dict(planned_rates)
        self.token_ewma: Dict[str, float] = {m: 0.0 for m in planned_rates}
        self._counts: Dict[str, int] = {m: 0 for m in planned_rates}
        self._tokens: Dict[str, int] = {m: 0 for m in planned_rates}
        self._window_end = self.interval
        self._above = 0
        self.windows_closed = 0

    def observe(self, model: str, tokens: int = 0) -> None:
        """Record one arrival (and its lifetime token count) in the
        current window."""
        if model not in self._counts:
            self._counts[model] = 0
            self._tokens[model] = 0
            self.rate_ewma.setdefault(model, 0.0)
            self.token_ewma.setdefault(model, 0.0)
            self.planned.setdefault(model, 0.0)
        self._counts[model] += 1
        self._tokens[model] += int(tokens)

    def advance(self, now: float) -> int:
        """Close every window that ends at or before ``now``; returns
        the number closed (0 = still inside the current window).

        A window with NO arrivals at all is closed but frozen: no EWMA
        fold, no trigger evaluation.  Totally idle windows mean a trace
        gap or the end-of-trace drain, and letting every EWMA decay
        there would fire a migration with no future arrivals to benefit.
        A single LLM going cold while others still arrive does decay —
        that is real drift.
        """
        closed = 0
        while now >= self._window_end:
            if any(self._counts.values()):
                a = self.alpha
                for m in self._counts:
                    self.rate_ewma[m] = (
                        (1 - a) * self.rate_ewma[m]
                        + a * self._counts[m] / self.interval)
                    self.token_ewma[m] = (
                        (1 - a) * self.token_ewma[m]
                        + a * self._tokens[m] / self.interval)
                    self._counts[m] = 0
                    self._tokens[m] = 0
                self._above = (self._above + 1
                               if self.max_drift() >= self.threshold
                               else 0)
            self._window_end += self.interval
            self.windows_closed += 1
            closed += 1
        return closed

    def drift(self, model: str) -> float:
        est = self.rate_ewma.get(model, 0.0) + self.eps
        plan = self.planned.get(model, 0.0) + self.eps
        return max(est / plan, plan / est)

    def max_drift(self) -> float:
        return max((self.drift(m) for m in self.rate_ewma), default=1.0)

    def triggered(self) -> bool:
        return self._above >= self.sustain

    def rebase(self, planned_rates: Dict[str, float]) -> None:
        """Adopt new planned rates as the drift baseline and disarm the
        trigger (called after a reconfiguration lands)."""
        self.planned.update(planned_rates)
        self._above = 0


# ---------------------------------------------------------------------------
# migration cost (deterministic clock)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class MigrationCostModel:
    """Logical seconds one reconfiguration charges in deterministic
    mode — the modeled stall of a real migration, priced like
    ``TickCostModel`` prices a tick:

        dt = base + migrated_head_blocks · per_block

    ``base`` is the control-plane cost (re-plan, group rebuild, table
    swap), ``per_block`` the page-copy cost.  Requeued prefills charge
    nothing here — their cost reappears as recomputation ticks.
    Realtime runs skip this model: the copy's wall time is already on
    the clock.
    """
    base: float = 20e-3
    per_block: float = 5e-6

    def dt(self, migrated_blocks: int) -> float:
        return self.base + migrated_blocks * self.per_block


# ---------------------------------------------------------------------------
# plan diffing
# ---------------------------------------------------------------------------
def assignment_of(pl: Placement) -> Dict[str, int]:
    """LLM name → mesh_id of its unit."""
    return {s.name: m.mesh_id for m in pl.meshes for s in m.specs}


def _return_spec(pl: Placement, name: str, mesh_id: int) -> None:
    """Move ``name``'s spec back onto ``mesh_id`` inside ``pl`` (a
    skipped migration must keep the stored plan matching reality)."""
    spec = None
    for m in pl.meshes:
        for s in list(m.specs):
            if s.name == name:
                m.specs.remove(s)
                spec = s
    for m in pl.meshes:
        if m.mesh_id == mesh_id and spec is not None:
            m.specs.append(spec)


def shares_of(pl: Placement) -> Dict[str, float]:
    """LLM name → planned compute share (sm_frac)."""
    return {s.name: float(s.sm_frac) for m in pl.meshes for s in m.specs}


def diff_placements(old: Placement, new: Placement
                    ) -> List[Tuple[str, int, int]]:
    """Minimal migration schedule between two plans over the same
    meshes: one ``(name, src_mesh, dst_mesh)`` move per LLM whose
    assignment changed.  A re-plan that changes only quotas or
    ``sm_frac`` diffs to an EMPTY schedule, which is not a no-op: the
    executor always rebalances every unit's quotas and applies the new
    compute shares, and the controller records an event whenever either
    changed.  Fused-group membership changes stay implied by the
    moves."""
    a0, a1 = assignment_of(old), assignment_of(new)
    return [(n, a0[n], a1[n])
            for n in a0 if n in a1 and a1[n] != a0[n]]


# ---------------------------------------------------------------------------
# reconfiguration events (report section)
# ---------------------------------------------------------------------------
@dataclass
class ReconfigEvent:
    """One executed reconfiguration, as recorded in ``ServeReport``."""
    t: float                               # clock time of execution
    drift: float                           # max drift that triggered it
    moves: List[Tuple[str, int, int]]      # (llm, src_mesh, dst_mesh)
    migrated_blocks: int                   # KV head-blocks copied
    requeued: int                          # prefill-phase restarts
    quota_moved: int                       # |Δquota| summed over views
    shrunk_blocks: int                     # pool blocks returned by
                                           # dissolved groups' grants
    dt_charged: float                      # modeled stall (logical s)
    stall_ticks: int                       # dt in base-tick units
    share_moved: float = 0.0               # Σ|Δsm_frac| applied
    rate_estimates: Dict[str, float] = field(default_factory=dict)
    token_estimates: Dict[str, float] = field(default_factory=dict)

    def to_json(self) -> dict:
        return {"t": self.t, "drift": self.drift,
                "moves": [list(m) for m in self.moves],
                "migrated_blocks": self.migrated_blocks,
                "requeued": self.requeued,
                "quota_moved": self.quota_moved,
                "share_moved": self.share_moved,
                "shrunk_blocks": self.shrunk_blocks,
                "dt_charged": self.dt_charged,
                "stall_ticks": self.stall_ticks,
                "rate_estimates": dict(self.rate_estimates),
                "token_estimates": dict(self.token_estimates)}


# ---------------------------------------------------------------------------
# migration execution
# ---------------------------------------------------------------------------
class MigrationExecutor:
    """Executes a migration schedule against live units without
    dropping requests (drain-or-carry per request):

      * **decode-phase** sequences carry their KV — pages are copied
        into the destination pool and the engine continues off them
        (``kvcache.migrate_view``);
      * **prefill-phase** requests are evicted and requeued at the
        destination (``Engine.evict_prefilling``; restart is exact
        under greedy decoding);
      * **queued** requests change queues with their engine.

    Fused-group membership changes ride on ``remove_engine`` /
    ``add_engine`` (dissolve → ``pool.shrink`` the old zero-copy grant →
    re-stack → ``pool.grow`` the new one).
    """

    def __init__(self, units: Dict[int, MuxScheduler]):
        self.units = units
        # fault injection (serving/faults.py): when the serving driver
        # threads an injector through, every scheduled move asks it for
        # a due ``migration_abort`` before the page copy
        self.injector = None

    def execute(self, moves: Sequence[Tuple[str, int, int]],
                new_pl: Placement, now: float = 0.0) -> Dict[str, object]:
        """Apply the schedule.  A move whose destination pool cannot
        hold the live KV (too few free blocks, or no contiguous run
        under fragmentation) is SKIPPED, never half-applied: the
        capacity pre-check runs before the engine detaches, and a
        fragmentation abort inside ``migrate_view`` leaves the source
        intact, so the engine is re-homed where it was.  Skipped moves
        are reflected back into ``new_pl`` (the spec returns to its
        source mesh), so the stored plan keeps matching reality and a
        later window can retry once space frees."""
        migrated = requeued = shrunk = 0
        new_shares = shares_of(new_pl)
        executed: List[Tuple[str, int, int]] = []
        skipped: List[Tuple[str, int, int]] = []
        for name, src_id, dst_id in moves:
            src, dst = self.units[src_id], self.units[dst_id]
            eng = src.engines[name]
            # physical need counts DISTINCT block groups — a prefix
            # block shared by several sequences migrates as one copy
            uniq = {b for sc in eng.view.seqs.values() for b in sc.bases}
            need = len(uniq) * eng.view.group_size
            # available_blocks, not free_blocks: the destination's
            # prefix-cache inventory is evictable on demand
            if need > dst.pool.available_blocks():
                skipped.append((name, src_id, dst_id))
                _return_spec(new_pl, name, src_id)
                continue
            blocks_before = src.pool.n_head_blocks
            eng, queued = src.remove_engine(name)
            shrunk += max(blocks_before - src.pool.n_head_blocks, 0)
            evicted = eng.evict_prefilling()
            carried = list(evicted) + list(queued)
            if self.injector is not None \
                    and self.injector.take_migration_abort(now):
                # injected mid-copy abort: the destination holds nothing
                # yet and the source view is untouched, so the re-home
                # path of a fragmentation abort accounts for every
                # request (prefill evictions requeue with the queue)
                for r in evicted:
                    r.requeues += 1
                src.add_engine(name, eng, carried)
                skipped.append((name, src_id, dst_id))
                _return_spec(new_pl, name, src_id)
                continue
            try:
                # quota starts at live usage; the rebalance pass below
                # sets the popularity-proportional target
                view, blocks = migrate_view(eng.view, dst.pool,
                                            quota=eng.view.used)
            except RuntimeError:
                # fragmentation abort: source view untouched — re-home
                # the engine (and its carried queue) where it was
                src.add_engine(name, eng, carried)
                skipped.append((name, src_id, dst_id))
                _return_spec(new_pl, name, src_id)
                continue
            eng.rebind_view(view)
            # the share travels with the engine; apply_shares below
            # overwrites it with the new plan's candidate
            dst.add_engine(name, eng, carried,
                           sm_frac=new_shares.get(name, 1.0))
            executed.append((name, src_id, dst_id))
            migrated += blocks
            requeued += len(evicted)
        quota_moved = self.rebalance_quotas(new_pl)
        share_moved = self.apply_shares(new_pl)
        return {"migrated_blocks": migrated, "requeued": requeued,
                "quota_moved": quota_moved, "share_moved": share_moved,
                "shrunk_blocks": shrunk,
                "executed": executed, "skipped": skipped}

    def rebalance_quotas(self, pl: Placement) -> int:
        """Re-split every unit's head-block quota ∝ the new plan's
        arrival rates (the popularity-proportional grant
        ``build_unit_from_specs`` makes at startup), clamped so no view
        drops below its live usage.  fcfs units keep their
        full-capacity quota.  Returns the total |Δquota| applied."""
        moved = 0
        for m in pl.meshes:
            unit = self.units.get(m.mesh_id)
            if unit is None or not m.specs or unit.policy == "fcfs":
                continue
            specs = [s for s in m.specs if s.name in unit.engines]
            if not specs:
                continue
            rate_sum = sum(max(s.rate, 0.0) for s in specs)
            n_blocks = unit.pool.n_head_blocks
            min_quota = max(n_blocks // (8 * len(specs)), 1)
            for s in specs:
                share = (max(s.rate, 0.0) / rate_sum) if rate_sum \
                    else 1 / len(specs)
                view = unit.engines[s.name].view
                target = max(int(n_blocks * share), min_quota, view.used)
                moved += abs(target - view.quota)
                view.quota = target
        return moved

    def apply_shares(self, pl: Placement) -> float:
        """Apply the new plan's per-LLM compute shares (``sm_frac``) to
        every share-enforcing unit — scheduler state only, so a re-plan
        that changes ONLY shares executes right here.  Units built
        without enforcement keep their temporal accounting (flipping the
        charging model mid-run would split one run across two cost
        semantics).  Returns Σ|Δsm_frac| applied."""
        moved = 0.0
        for m in pl.meshes:
            unit = self.units.get(m.mesh_id)
            if unit is None or not unit.enforce_shares:
                continue
            for s in m.specs:
                if s.name not in unit.engines:
                    continue
                old = unit.sm_frac.get(s.name, 1.0)
                if abs(float(s.sm_frac) - old) > 1e-12:
                    moved += abs(float(s.sm_frac) - old)
                    unit.sm_frac[s.name] = float(s.sm_frac)
        return moved


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------
class ReconfigController:
    """Monitor → trigger → re-plan → diff → migrate, driven by the
    serving loop (``serving/driver.serve_requests(reconfig=...)``).

    The loop reports arrivals (through ``monitor.observe``) and calls
    ``step(now)`` once per iteration; window bookkeeping, hysteresis,
    cooldown, plan diffing and migration are internal.  ``step``
    returns the executed ``ReconfigEvent`` (or None); in deterministic
    mode the driver charges the event's ``dt_charged`` to the logical
    clock, so reconfiguration stalls show up in every downstream
    latency like any other cost.  ``hw`` prices the re-plan (the JAX
    package's A100 by default, so plans stay equal to its).
    """

    def __init__(self, placement: Placement,
                 units: Sequence[MuxScheduler],
                 interval: float = 1.0, drift_threshold: float = 2.0,
                 sustain: int = 2, ewma_alpha: float = 0.5,
                 cooldown: Optional[float] = None,
                 hw: Hardware = A100,
                 migration_cost: Optional[MigrationCostModel] = None,
                 tick_base: float = 4e-3):
        self.placement = placement
        self.units: Dict[int, MuxScheduler] = {}
        for i, u in enumerate(units):
            mid = u.mesh_id if u.mesh_id >= 0 else i
            u.mesh_id = mid
            if mid in self.units:
                raise ValueError(f"duplicate mesh_id {mid} across units")
            self.units[mid] = u
        planned = {s.name: s.rate for m in placement.meshes
                   for s in m.specs}
        self.monitor = WorkloadMonitor(planned, interval=interval,
                                       alpha=ewma_alpha,
                                       threshold=drift_threshold,
                                       sustain=sustain)
        self.executor = MigrationExecutor(self.units)
        self.migration_cost = (migration_cost if migration_cost
                               is not None else MigrationCostModel())
        self.cooldown = (2 * interval) if cooldown is None else cooldown
        self.hw = hw
        self.tick_base = tick_base
        self.events: List[ReconfigEvent] = []
        self._last_t = -math.inf

    def replan(self, rates: Dict[str, float]) -> Placement:
        """Re-run the placement optimizer's greedy assignment on the
        live rate estimates, over the FIXED physical meshes (the online
        move set is LLM↔mesh assignment, sm_frac/tp and quotas)."""
        specs = [s for m in self.placement.meshes for s in m.specs]
        if not specs:
            raise ValueError("cannot replan an empty placement")
        models = [(s.cfg, max(rates.get(s.name, s.rate), 1e-6))
                  for s in specs]
        archs = {s.name: s.arch_id for s in specs}
        mesh_sizes = [(m.mesh_id, m.n_devices)
                      for m in self.placement.meshes]
        return place_onto_meshes(models, mesh_sizes, hw=self.hw,
                                 mean_prompt=specs[0].mean_prompt,
                                 mean_output=specs[0].mean_output,
                                 archs=archs)

    def step(self, now: float) -> Optional[ReconfigEvent]:
        """Advance monitor windows to ``now``; when the hysteresis
        trigger is armed (and the cooldown has passed), re-plan on the
        EWMA estimates, diff, migrate, and return the event."""
        if not self.monitor.advance(now):
            return None
        if not self.monitor.triggered():
            return None
        if now - self._last_t < self.cooldown:
            return None
        drift = self.monitor.max_drift()
        est = dict(self.monitor.rate_ewma)
        try:
            new_pl = self.replan(est)
        except AssertionError:
            # the greedy assignment found no feasible layout for the
            # estimates (``place_onto_meshes`` asserts; online
            # replanning has no group backtracking) — keep the current
            # placement; the cooldown stamp stops a hot retry loop
            self._last_t = now
            return None
        moves = diff_placements(self.placement, new_pl)
        stats = self.executor.execute(moves, new_pl, now=now)
        self.placement = new_pl
        self.monitor.rebase(est)
        self._last_t = now
        if not stats["executed"] and stats["quota_moved"] == 0 \
                and stats["share_moved"] < 1e-9:
            # the estimates re-derive the current layout (or every move
            # was skipped for lack of destination space): the rebase
            # absorbs the drift, nothing executed
            return None
        dt = self.migration_cost.dt(stats["migrated_blocks"])
        ev = ReconfigEvent(
            t=now, drift=drift, moves=list(stats["executed"]),
            migrated_blocks=stats["migrated_blocks"],
            requeued=stats["requeued"],
            quota_moved=stats["quota_moved"],
            share_moved=stats["share_moved"],
            shrunk_blocks=stats["shrunk_blocks"],
            dt_charged=dt,
            stall_ticks=int(math.ceil(dt / max(self.tick_base, 1e-9))),
            rate_estimates=est,
            token_estimates=dict(self.monitor.token_ewma))
        self.events.append(ev)
        return ev

    def owner_map(self) -> Dict[str, MuxScheduler]:
        """Current LLM → unit routing (changes after moves; the driver
        refreshes its submit table from this after every event)."""
        return {name: u for u in self.units.values()
                for name in u.engines}
