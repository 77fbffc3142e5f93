"""Fault injection and graceful degradation (port of
``repro/serving/faults.py``; host code, the JAX package's line for line).

The multiplexed runtime must degrade instead of collapse: a crashed
engine, a bad HBM region eating KV blocks or a transiently failing step
must each leave the unit in a consistent, serving state, and sustained
overload must shed work deliberately (recorded, SLO-missed) rather than
carry it on an unbounded queue.  This module is the *injection* half:

  * **FaultEvent / FaultPlan** — a deterministic, seedable schedule of
    faults on the serving clock.  Four fault classes:

      - ``engine_crash``    — engine ``target`` dies at time ``at``;
        its device state (slots, SSM carries, KV view) is lost and the
        scheduler rebuilds it (``MuxScheduler.recover_engine``);
      - ``block_loss``      — the pool backing ``target``'s unit loses
        ``magnitude`` head-blocks off the arena tail at ``at``:
        sequences with pages there are torn down and requeued, the
        arena shrinks;
      - ``transient_step``  — ``target``'s steps fail for ``magnitude``
        consecutive ticks starting at ``at``: the scheduler retries the
        same work next tick, and escalates to a crash recovery past its
        retry budget;
      - ``migration_abort`` — the next reconfiguration move at or after
        ``at`` aborts mid-copy.  It parses, is counted, and is offered
        through ``take_migration_abort``; the port has no migration
        executor yet to ask for it (live reconfiguration), so such an
        event stays unfired.

  * **FaultInjector** — the runtime hook.  ``MuxScheduler.tick`` polls
    it once per tick (``poll`` fires due crash/block-loss events for
    the engines that unit owns, ``consume_transient`` burns one failed
    tick).  The injector never reads a clock or an RNG at runtime — the
    plan is fixed up front — so a faulted run under the deterministic
    clock is bit-reproducible.

  * **RecoveryCostModel** — logical seconds a recovery stalls the unit
    in deterministic mode (``serving/driver.py`` charges it when it
    drains a unit's ``fault_events``).

The *survival* half — bounded admission queues, deadline-aware
shedding, retry budgets, crash recovery, the serving-loop watchdog —
lives in ``serving/mux.py`` and ``serving/driver.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

FAULT_KINDS = ("engine_crash", "block_loss", "transient_step",
               "migration_abort")

# CLI spelling of each kind (launch/serve.py --faults)
_PARSE_KINDS = {"crash": "engine_crash", "block_loss": "block_loss",
                "transient": "transient_step",
                "migration_abort": "migration_abort"}


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault on the serving clock."""
    kind: str                       # one of FAULT_KINDS
    at: float                       # clock seconds (logical/wall)
    target: Optional[str] = None    # engine/LLM name (None: migration_abort)
    magnitude: int = 0              # blocks lost / consecutive failed ticks

    def __post_init__(self):
        assert self.kind in FAULT_KINDS, self.kind
        assert self.at >= 0, "fault time must be non-negative"
        if self.kind == "migration_abort":
            assert self.target is None or isinstance(self.target, str)
        else:
            assert self.target, f"{self.kind} needs a target engine name"
        if self.kind in ("block_loss", "transient_step"):
            assert self.magnitude > 0, f"{self.kind} needs magnitude > 0"

    def to_json(self) -> dict:
        return {"kind": self.kind, "at": self.at, "target": self.target,
                "magnitude": self.magnitude}


@dataclass
class FaultPlan:
    """A deterministic fault schedule (sorted by time)."""
    events: List[FaultEvent] = field(default_factory=list)

    def __post_init__(self):
        self.events = sorted(self.events, key=lambda e: (e.at, e.kind,
                                                         e.target or ""))

    def __len__(self) -> int:
        return len(self.events)

    def targets(self) -> List[str]:
        return sorted({e.target for e in self.events if e.target})

    def to_json(self) -> List[dict]:
        return [e.to_json() for e in self.events]

    # ------------------------------------------------------------------
    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse the ``--faults`` CLI syntax: a comma list of

            crash:<name>@<t>
            block_loss:<name>:<blocks>@<t>
            transient:<name>:<ticks>@<t>
            migration_abort@<t>

        e.g. ``crash:llm0@2.0,block_loss:llm1:256@1.5``.  Raises
        ``ValueError`` with the offending token on malformed input.
        """
        events: List[FaultEvent] = []
        for tok in filter(None, (t.strip() for t in spec.split(","))):
            head, sep, t_str = tok.partition("@")
            if not sep:
                raise ValueError(f"fault {tok!r}: missing '@<time>'")
            try:
                at = float(t_str)
            except ValueError:
                raise ValueError(
                    f"fault {tok!r}: bad time {t_str!r}") from None
            parts = head.split(":")
            kind = _PARSE_KINDS.get(parts[0])
            if kind is None:
                raise ValueError(
                    f"fault {tok!r}: unknown kind {parts[0]!r} "
                    f"(known: {', '.join(_PARSE_KINDS)})")
            try:
                if kind == "migration_abort":
                    if len(parts) != 1:
                        raise ValueError
                    events.append(FaultEvent(kind, at))
                elif kind == "engine_crash":
                    if len(parts) != 2 or not parts[1]:
                        raise ValueError
                    events.append(FaultEvent(kind, at, parts[1]))
                else:                     # block_loss / transient_step
                    if len(parts) != 3 or not parts[1]:
                        raise ValueError
                    events.append(FaultEvent(kind, at, parts[1],
                                             int(parts[2])))
            except (ValueError, AssertionError):
                raise ValueError(
                    f"fault {tok!r}: expected "
                    f"crash:<name>@<t>, block_loss:<name>:<blocks>@<t>, "
                    f"transient:<name>:<ticks>@<t> or "
                    f"migration_abort@<t>") from None
        return cls(events)

    @classmethod
    def random(cls, names: Sequence[str], horizon: float,
               severity: float, seed: int = 0,
               pool_blocks: int = 4096) -> "FaultPlan":
        """Seeded severity-scaled plan for chaos sweeps.

        A master event list for severity 1.0 is drawn once from
        ``seed`` (per LLM: one crash, one block loss of 1/8 of the
        pool, one 2-tick transient window, all in the middle 60% of
        the horizon, plus one migration abort); ``severity`` ∈ [0, 1]
        takes a *prefix* of that list.  Plans at increasing severity
        are therefore **nested** — more severity strictly adds faults,
        never reshuffles them — which is what lets a
        chaos sweep assert that attainment degrades monotonically.
        Severity 0 is the empty plan.
        """
        assert 0.0 <= severity <= 1.0, severity
        rng = np.random.default_rng(seed)

        def t() -> float:
            return float(rng.uniform(0.2 * horizon, 0.8 * horizon))

        master: List[FaultEvent] = []
        for n in names:
            master.append(FaultEvent("engine_crash", t(), n))
        for n in names:
            master.append(FaultEvent("block_loss", t(), n,
                                     max(pool_blocks // 8, 1)))
        for n in names:
            master.append(FaultEvent("transient_step", t(), n, 2))
        master.append(FaultEvent("migration_abort", t()))
        k = int(round(severity * len(master)))
        return cls(master[:k])


class FaultInjector:
    """Runtime half of the fault plan: polled by the scheduler tick and
    the migration executor, records every fired fault.

    One injector serves every unit of a run (the driver threads it
    through ``serve_requests(faults=...)``): an event fires on the
    first ``poll`` whose unit owns the event's target engine and whose
    clock has reached ``at``.  Events whose target never exists simply
    never fire (reported in ``unfired``).  The injector holds no RNG
    and never reads a clock — determinism is the plan's.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._fired = [False] * len(plan.events)
        self._transient_left: Dict[str, int] = {}
        self.records: List[dict] = []

    # ------------------------------------------------------------------
    def poll(self, unit, now: float) -> List[FaultEvent]:
        """Fire every due crash/block-loss event owned by ``unit`` and
        arm due transient windows; returns the crash/block-loss events
        for the scheduler to apply (in plan order)."""
        out: List[FaultEvent] = []
        for i, ev in enumerate(self.plan.events):
            if self._fired[i] or ev.at > now:
                continue
            if ev.kind == "migration_abort" or ev.target not in unit.engines:
                continue
            self._fired[i] = True
            self.records.append({**ev.to_json(), "fired_t": now})
            if ev.kind == "transient_step":
                self._transient_left[ev.target] = (
                    self._transient_left.get(ev.target, 0) + ev.magnitude)
            else:
                out.append(ev)
        return out

    def consume_transient(self, name: str) -> bool:
        """One engine-tick of an armed transient window: returns True
        (and burns one failed tick) while the window is open."""
        left = self._transient_left.get(name, 0)
        if left <= 0:
            return False
        self._transient_left[name] = left - 1
        return True

    def clear_transient(self, name: str) -> None:
        """Drop any remaining transient window for ``name`` — a crash
        recovery rebuilt the engine, which clears the wedged state the
        window modeled."""
        self._transient_left.pop(name, None)

    def take_migration_abort(self, now: float) -> bool:
        """Consume one due ``migration_abort`` event (the executor asks
        once per scheduled move, before the page copy)."""
        for i, ev in enumerate(self.plan.events):
            if self._fired[i] or ev.kind != "migration_abort" \
                    or ev.at > now:
                continue
            self._fired[i] = True
            self.records.append({**ev.to_json(), "fired_t": now})
            return True
        return False

    def unfired(self) -> List[FaultEvent]:
        """Plan events that never fired (target absent, or the run
        ended first) — surfaced so a typo'd target is visible."""
        return [ev for i, ev in enumerate(self.plan.events)
                if not self._fired[i]]


@dataclass(frozen=True)
class RecoveryCostModel:
    """Logical seconds one recovery/degradation event stalls the unit
    in deterministic mode (the driver charges it to the
    ``LogicalClock`` when it drains ``MuxScheduler.fault_events`` —
    the fault-handling twin of the migration cost of live
    reconfiguration):

        dt = base + requeued · per_requeue + blocks · per_block

    ``base`` is the teardown/rebuild control-plane cost, ``per_requeue``
    the re-dispatch cost per torn-down request, ``per_block`` the scrub
    cost per freed/lost head-block.  Shed requests charge nothing —
    shedding is the cheap path by design.
    """
    base: float = 20e-3
    per_requeue: float = 1e-3
    per_block: float = 5e-6

    def dt(self, requeued: int = 0, blocks: int = 0) -> float:
        return (self.base + requeued * self.per_requeue
                + blocks * self.per_block)
