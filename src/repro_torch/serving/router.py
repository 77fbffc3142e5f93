"""Cross-LLM request routing for the live serving front end (port of
``repro/serving/router.py``; host code, the JAX package's line for line).

Engines hosted by :class:`~repro_torch.serving.mux.MuxScheduler` units are
addressed by exact name (``"llm-a@0"``).  A live client usually doesn't
know — or care — which replica serves it: it names a *model family*
(``"llm-a"``) and the router picks an engine.  By convention a replica
name is ``<family>@<k>``; a name without ``@`` is its own family, so
single-replica deployments route transparently.

Strategies (strategy pattern, one ``choose`` method each):

- :class:`ExplicitTarget` — requests must name an exact engine; family
  names only resolve when the family has exactly one replica.
- :class:`RoundRobin` — static per-family rotation, ignores load.  The
  baseline the benchmark gate measures against.
- :class:`WeightedByRate` — deterministic smooth weighted round-robin
  (nginx's algorithm) over planned per-engine rates, so the long-run
  split matches the placement optimizer's traffic plan.
- :class:`LeastLoaded` — picks the replica with the lowest instantaneous
  load score: admission-queue depth + resident sequences + KV pool
  pressure (used/quota).  Name-order tie-break keeps it deterministic.

The router's view (engine → unit, family → replicas) is rebuilt by
:meth:`Router.refresh` — the serving session's ``on_topology_change``
hook, for the moves of live reconfiguration once the port has it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.serving.metrics import ServingMetrics
    from repro_torch.serving.mux import MuxScheduler

__all__ = [
    "family_of",
    "RoutingStrategy",
    "ExplicitTarget",
    "RoundRobin",
    "WeightedByRate",
    "LeastLoaded",
    "Router",
    "make_strategy",
    "ROUTER_STRATEGIES",
]


def family_of(name: str) -> str:
    """``"llm-a@1"`` → ``"llm-a"``; a name without ``@`` is its own family."""
    return name.split("@", 1)[0]


class RoutingStrategy:
    """Picks one engine name out of a family's replica set."""

    name = "base"

    def choose(self, family: str, candidates: List[str], router: "Router") -> str:
        raise NotImplementedError


class ExplicitTarget(RoutingStrategy):
    """Clients must address engines directly; no replica fan-out."""

    name = "explicit"

    def choose(self, family: str, candidates: List[str], router: "Router") -> str:
        if len(candidates) == 1:
            return candidates[0]
        raise KeyError(
            f"explicit routing: '{family}' names {len(candidates)} replicas "
            f"({candidates}); address one directly"
        )


class RoundRobin(RoutingStrategy):
    """Static rotation per family, blind to load — the routing baseline."""

    name = "round_robin"

    def __init__(self) -> None:
        self._next: Dict[str, int] = {}

    def choose(self, family: str, candidates: List[str], router: "Router") -> str:
        i = self._next.get(family, 0) % len(candidates)
        self._next[family] = i + 1
        return candidates[i]


class WeightedByRate(RoutingStrategy):
    """Smooth weighted round-robin over planned per-engine rates.

    Each pick adds every candidate's weight to its running current-weight,
    selects the max, then subtracts the weight total from the winner —
    nginx's interleaving variant, deterministic and starvation-free.
    Unknown engines weigh 1.0 so a fresh replica still receives traffic.
    """

    name = "weighted"

    def __init__(self, planned_rates: Optional[Dict[str, float]] = None):
        self.planned_rates = dict(planned_rates or {})
        self._current: Dict[str, float] = {}

    def weight(self, name: str) -> float:
        w = self.planned_rates.get(name)
        if w is None:
            w = self.planned_rates.get(family_of(name))
        return max(float(w), 1e-9) if w is not None else 1.0

    def choose(self, family: str, candidates: List[str], router: "Router") -> str:
        total = 0.0
        best: Optional[str] = None
        for name in candidates:
            w = self.weight(name)
            total += w
            self._current[name] = self._current.get(name, 0.0) + w
            if best is None or self._current[name] > self._current[best]:
                best = name
        assert best is not None
        self._current[best] -= total
        return best


class LeastLoaded(RoutingStrategy):
    """Route to the replica with the lowest instantaneous load score."""

    name = "least_loaded"

    def choose(self, family: str, candidates: List[str], router: "Router") -> str:
        return min(candidates, key=lambda n: (router.load_score(n), n))


class Router:
    """Maps request model names to engines across one or more units."""

    def __init__(
        self,
        units: Sequence["MuxScheduler"],
        strategy: Optional[RoutingStrategy] = None,
        metrics: Optional["ServingMetrics"] = None,
    ):
        self.units = list(units)
        self.strategy = strategy if strategy is not None else RoundRobin()
        self.metrics = metrics
        self.engine_unit: Dict[str, "MuxScheduler"] = {}
        self.families: Dict[str, List[str]] = {}
        self.refresh()

    def refresh(self) -> None:
        """Rebuild the engine→unit and family→replicas view.

        Cheap (a dict walk over hosted engines); called after reconfig
        moves and crash recoveries so routing follows the live topology.
        """
        engine_unit: Dict[str, "MuxScheduler"] = {}
        families: Dict[str, List[str]] = {}
        for u in self.units:
            for name in u.engines:
                if name in engine_unit:
                    raise ValueError(f"engine '{name}' hosted by two units")
                engine_unit[name] = u
                families.setdefault(family_of(name), []).append(name)
        for reps in families.values():
            reps.sort()
        self.engine_unit = engine_unit
        self.families = families

    # -- load inspection (used by LeastLoaded, exposed for metrics) --------

    def queue_depth(self, name: str) -> int:
        u = self.engine_unit[name]
        return len(u.queues[name])

    def load_score(self, name: str) -> float:
        """Queue depth + resident sequences + KV pool pressure.

        Queue/slot occupancy dominates; pool pressure (0..1) breaks ties
        between equally-queued replicas toward the one with KV headroom.
        """
        u = self.engine_unit[name]
        eng = u.engines[name]
        depth = len(u.queues[name])
        resident = len(eng.active_slots())
        view = eng.view
        pressure = view.used / max(float(view.quota), 1.0)
        return depth + resident + pressure

    # -- resolution --------------------------------------------------------

    def resolve(self, model: str) -> str:
        """Return the engine name that should serve ``model``.

        Exact engine names short-circuit (explicit target always wins);
        family names go through the strategy.  Unknown names raise
        ``KeyError`` so the front end can reject before submit.
        """
        if model in self.engine_unit:
            chosen = model
        else:
            candidates = self.families.get(model)
            if not candidates:
                raise KeyError(f"no engine or family named '{model}'")
            chosen = self.strategy.choose(model, list(candidates), self)
        if self.metrics is not None:
            self.metrics.router_decisions.inc(
                strategy=self.strategy.name, llm=chosen
            )
        return chosen

    def unit_for(self, name: str) -> "MuxScheduler":
        return self.engine_unit[name]


ROUTER_STRATEGIES = ("explicit", "round_robin", "weighted", "least_loaded")


def make_strategy(
    name: str, planned_rates: Optional[Dict[str, float]] = None
) -> RoutingStrategy:
    """CLI-facing factory: strategy name → instance."""
    if name == "explicit":
        return ExplicitTarget()
    if name == "round_robin":
        return RoundRobin()
    if name == "weighted":
        return WeightedByRate(planned_rates)
    if name == "least_loaded":
        return LeastLoaded()
    raise ValueError(f"unknown router strategy '{name}' (choose from {ROUTER_STRATEGIES})")
