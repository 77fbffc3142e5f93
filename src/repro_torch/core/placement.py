"""Placement optimization — paper Alg. 1 + Alg. 2 (copy of
``repro/core/placement.py``; same plan JSON, so a plan written by either
package loads in the other).

``parallel_candidates`` (Alg. 2): per LLM, for each feasible
intra-operator (TP) degree find the *smallest* compute fraction that
meets the LLM's arrival rate — one candidate per TP degree.

``place`` (Alg. 1): enumerate device-mesh groups (partitions of the
cluster into power-of-two meshes, pruned by node size and workload),
greedily place computation-hungry LLMs first onto the mesh with maximal
throughput delta, keep the best group.

``place_memory_greedy``: the Fig.-8 ablation baseline — prioritize by
arrival rate, place on the mesh with most free memory.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.config import ModelConfig
from repro_torch.core import costmodel as cm
from repro_torch.core.costmodel import A100, Hardware
from repro_torch.core.estimator import LLMSpec, solve_batch, unit_throughput

SM_FRACTIONS = [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0]


@dataclass
class Candidate:
    tp: int
    sm_frac: float
    batch: int
    tpt: float


@dataclass
class Mesh:
    mesh_id: int
    n_devices: int
    specs: List[LLMSpec] = field(default_factory=list)

    def throughput(self, hw: Hardware) -> float:
        t = unit_throughput(self.specs, self.n_devices, hw)
        return 0.0 if not self.specs else t


@dataclass
class Placement:
    meshes: List[Mesh]
    total_tpt: float

    def describe(self) -> str:
        lines = []
        for m in self.meshes:
            names = ", ".join(f"{s.name}(tp={s.tp},f={s.sm_frac:.1f})"
                              for s in m.specs)
            lines.append(f"  mesh[{m.mesh_id}] x{m.n_devices}: {names or '—'}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# plan serialization — the placement → runtime bridge's wire format
# ---------------------------------------------------------------------------
# A plan JSON captures everything the runtime needs to instantiate real
# colocated units from an optimizer output (serving/driver.py builds
# one MuxScheduler per mesh): mesh sizes and, per LLM, its unit-unique
# name, base architecture (``name`` minus any ``#i`` colocation tag),
# arrival rate (quota split ∝ rate, like the simulator's initial
# quotas) and the planned tp / sm_frac.  Model geometry is NOT
# serialized — the loader resolves the architecture by name, so a plan
# stays valid across config edits and the runtime is free to
# substitute REDUCED variants for CPU-scale serving.

def placement_to_json(pl: Placement) -> dict:
    return {
        "total_tpt": pl.total_tpt,
        "meshes": [{
            "mesh_id": m.mesh_id,
            "n_devices": m.n_devices,
            "specs": [{
                "name": s.name,
                "arch": s.arch_id,
                "rate": s.rate,
                "tp": s.tp,
                "sm_frac": s.sm_frac,
                "mean_prompt": s.mean_prompt,
                "mean_output": s.mean_output,
            } for s in m.specs],
        } for m in pl.meshes],
    }


def placement_from_json(data: dict,
                        resolve_cfg: Callable[[str], ModelConfig]
                        ) -> Placement:
    """Rebuild a ``Placement`` from its plan JSON.

    ``resolve_cfg(arch)`` supplies the ``ModelConfig`` for each spec's
    base architecture (e.g. ``repro_torch.configs.get`` for paper-scale
    geometry or ``configs.get_reduced`` for the CPU runtime); the
    config is renamed to the spec's unit-unique ``name`` so colocated
    instances of one architecture stay distinct.
    """
    meshes = []
    for m in data["meshes"]:
        specs = [LLMSpec(replace(resolve_cfg(s["arch"]), name=s["name"]),
                         s["rate"],
                         # optional in hand-written plans (ShareGPT
                         # defaults, matching LLMSpec's)
                         mean_prompt=int(s.get("mean_prompt", 161)),
                         mean_output=int(s.get("mean_output", 338)),
                         tp=int(s["tp"]),
                         sm_frac=float(s["sm_frac"]), arch=s["arch"])
                 for s in m["specs"]]
        meshes.append(Mesh(int(m["mesh_id"]), int(m["n_devices"]), specs))
    return Placement(meshes, float(data["total_tpt"]))


def save_placement(pl: Placement, path: str) -> None:
    with open(path, "w") as f:
        json.dump(placement_to_json(pl), f, indent=1)


def load_placement(path: str,
                   resolve_cfg: Callable[[str], ModelConfig]) -> Placement:
    with open(path) as f:
        return placement_from_json(json.load(f), resolve_cfg)


# ---------------------------------------------------------------------------
# Alg. 2 — parallel candidate generation
# ---------------------------------------------------------------------------
def parallel_candidates(cfg: ModelConfig, rate: float, hw: Hardware = A100,
                        max_tp: int = 8, mean_prompt: int = 161,
                        mean_output: int = 338) -> List[Candidate]:
    cands: List[Candidate] = []
    min_tp = cm.weight_devices_needed(cfg, hw)
    tp = 1
    while tp <= max_tp:
        if tp >= min_tp:
            for f in SM_FRACTIONS:     # sorted ascending: fewest SMs first
                spec = LLMSpec(cfg, rate, mean_prompt, mean_output,
                               tp=tp, sm_frac=f)
                b, tpt = solve_batch(spec, [spec], hw)
                if tpt >= rate - 1e-9:
                    cands.append(Candidate(tp, f, b, tpt))
                    break
            else:
                # even f=1.0 cannot meet the rate: keep the best-effort
                spec = LLMSpec(cfg, rate, mean_prompt, mean_output,
                               tp=tp, sm_frac=1.0)
                b, tpt = solve_batch(spec, [spec], hw)
                cands.append(Candidate(tp, 1.0, b, tpt))
        tp *= 2
    return cands


# ---------------------------------------------------------------------------
# mesh-group enumeration (pruned)
# ---------------------------------------------------------------------------
def mesh_groups(n_devices: int, node_size: int = 8,
                min_mesh: int = 1, limit: int = 512) -> List[Tuple[int, ...]]:
    """Partitions of n_devices into power-of-two meshes ≤ node_size
    (intra-op within a node — paper §3.2 pruning heuristic)."""
    sizes = [s for s in (1, 2, 4, 8, 16, 32) if min_mesh <= s <= node_size]
    sizes = sizes[::-1]
    out: List[Tuple[int, ...]] = []

    def rec(remaining: int, max_size: int, acc: List[int]):
        if len(out) >= limit:
            return
        if remaining == 0:
            out.append(tuple(acc))
            return
        for s in sizes:
            if s <= max_size and s <= remaining:
                acc.append(s)
                rec(remaining - s, s, acc)
                acc.pop()

    rec(n_devices, max(sizes), [])
    return out


def _computation_requirement(cfg: ModelConfig, rate: float) -> float:
    """Sort key of Alg. 1: model scale × popularity."""
    return cfg.active_param_count() * rate


# ---------------------------------------------------------------------------
# Alg. 1 — enumeration-based greedy placement
# ---------------------------------------------------------------------------
def place(models: Sequence[Tuple[ModelConfig, float]], n_devices: int,
          hw: Hardware = A100, node_size: int = 8,
          group_limit: int = 128, mean_prompt: int = 161,
          mean_output: int = 338) -> Placement:
    cands: Dict[str, List[Candidate]] = {
        cfg.name: parallel_candidates(cfg, rate, hw, max_tp=node_size,
                                      mean_prompt=mean_prompt,
                                      mean_output=mean_output)
        for cfg, rate in models}

    # prune mesh groups: a mesh must be able to host the largest model
    min_mesh = max(cm.weight_devices_needed(cfg, hw) for cfg, _ in models)
    groups = mesh_groups(n_devices, node_size, limit=group_limit)
    groups = [g for g in groups if max(g) >= min_mesh]
    order = sorted(models,
                   key=lambda mr: _computation_requirement(*mr), reverse=True)

    best: Optional[Placement] = None
    for g in groups:
        meshes = [Mesh(i, s) for i, s in enumerate(g)]
        feasible = True
        for cfg, rate in order:
            best_mesh, best_delta, best_spec = None, -math.inf, None
            for mesh in meshes:
                cand = _fit_candidate(cands[cfg.name], mesh.n_devices)
                if cand is None:
                    continue
                spec = LLMSpec(cfg, rate, mean_prompt, mean_output,
                               tp=cand.tp, sm_frac=cand.sm_frac)
                before = unit_throughput(mesh.specs, mesh.n_devices, hw)
                after = unit_throughput(mesh.specs + [spec],
                                        mesh.n_devices, hw)
                if not math.isfinite(after):
                    continue
                delta = after - (before if math.isfinite(before) else 0.0)
                if delta > best_delta:
                    best_mesh, best_delta, best_spec = mesh, delta, spec
            if best_mesh is None:
                feasible = False
                break
            best_mesh.specs.append(best_spec)
        if not feasible:
            continue
        tpt = sum(max(m.throughput(hw), 0.0) for m in meshes)
        if best is None or tpt > best.total_tpt:
            best = Placement([Mesh(m.mesh_id, m.n_devices, list(m.specs))
                              for m in meshes], tpt)
    # the dedicated-mesh layout is also a member of the search space
    # (units of one LLM); keep it when colocation does not pay — this
    # matters for near-uniform popularity (small α), where the paper's
    # gains come from elsewhere and forcing colocation only adds
    # prefill serialization
    try:
        spatial = place_spatial(models, n_devices, hw, node_size,
                                mean_prompt, mean_output)
        if best is None or spatial.total_tpt > best.total_tpt:
            best = spatial
    except AssertionError:
        pass
    assert best is not None, "no feasible placement"
    return best


def place_onto_meshes(models: Sequence[Tuple[ModelConfig, float]],
                      mesh_sizes: Sequence[Tuple[int, int]],
                      hw: Hardware = A100, mean_prompt: int = 161,
                      mean_output: int = 338,
                      archs: Optional[Dict[str, str]] = None) -> Placement:
    """Alg. 1's greedy inner loop over a FIXED mesh structure.

    ``place`` enumerates mesh groups because at planning time the
    cluster partition is free; *online* re-placement (the live
    reconfiguration subsystem, ``serving/reconfig.py``) operates on
    physical units that already hold weights and KV, so only the
    LLM → mesh assignment (plus each LLM's tp / sm_frac candidate)
    re-solves — re-partitioning meshes would mean cross-node weight
    reloads.  ``mesh_sizes`` is ``[(mesh_id, n_devices), ...]``;
    ``archs`` optionally maps unit-unique names to base architecture
    ids (propagated onto the specs so the placement → runtime bridge
    keeps resolving configs).  Greedy order and the throughput-delta
    mesh choice are identical to ``place``.
    """
    assert models and mesh_sizes
    archs = archs or {}
    max_mesh = max(n for _, n in mesh_sizes)
    cands = {cfg.name: parallel_candidates(cfg, rate, hw, max_tp=max_mesh,
                                           mean_prompt=mean_prompt,
                                           mean_output=mean_output)
             for cfg, rate in models}
    meshes = [Mesh(mid, n) for mid, n in mesh_sizes]
    order = sorted(models,
                   key=lambda mr: _computation_requirement(*mr), reverse=True)
    for cfg, rate in order:
        best_mesh, best_delta, best_spec = None, -math.inf, None
        for mesh in meshes:
            cand = _fit_candidate(cands[cfg.name], mesh.n_devices)
            if cand is None:
                continue
            spec = LLMSpec(cfg, rate, mean_prompt, mean_output,
                           tp=cand.tp, sm_frac=cand.sm_frac,
                           arch=archs.get(cfg.name))
            before = unit_throughput(mesh.specs, mesh.n_devices, hw)
            after = unit_throughput(mesh.specs + [spec],
                                    mesh.n_devices, hw)
            if not math.isfinite(after):
                continue
            delta = after - (before if math.isfinite(before) else 0.0)
            if delta > best_delta:
                best_mesh, best_delta, best_spec = mesh, delta, spec
        assert best_mesh is not None,\
            f"no mesh can host {cfg.name} at rate {rate}"
        best_mesh.specs.append(best_spec)
    tpt = sum(max(m.throughput(hw), 0.0) for m in meshes)
    return Placement(meshes, tpt)


def _fit_candidate(cands: List[Candidate], mesh_size: int
                   ) -> Optional[Candidate]:
    """Largest-TP candidate that fits the mesh (more TP → lower latency,
    paper §2.2), falling back to smaller TP."""
    fitting = [c for c in cands if c.tp <= mesh_size]
    if not fitting:
        return None
    return max(fitting, key=lambda c: c.tp)


# ---------------------------------------------------------------------------
# Fig.-8 baseline: memory-greedy placement
# ---------------------------------------------------------------------------
def place_memory_greedy(models: Sequence[Tuple[ModelConfig, float]],
                        n_devices: int, hw: Hardware = A100,
                        node_size: int = 8, mean_prompt: int = 161,
                        mean_output: int = 338) -> Placement:
    """Prioritize high-rate LLMs, place each on the mesh with the most
    free memory (the paper's ablation baseline, §4.4)."""
    # fixed balanced group: split into node-size meshes
    g = []
    rem = n_devices
    while rem > 0:
        s = min(node_size, rem)
        g.append(s)
        rem -= s
    meshes = [Mesh(i, s) for i, s in enumerate(g)]
    free = {m.mesh_id: m.n_devices * hw.hbm_bytes for m in meshes}
    order = sorted(models, key=lambda mr: mr[1], reverse=True)  # by rate
    for cfg, rate in order:
        need = cfg.weight_bytes()
        mesh = max(meshes, key=lambda m: free[m.mesh_id])
        tp = min(cm.weight_devices_needed(cfg, hw), mesh.n_devices)
        mesh.specs.append(LLMSpec(cfg, rate, mean_prompt, mean_output,
                                  tp=tp, sm_frac=1.0))
        free[mesh.mesh_id] -= need
    tpt = sum(max(m.throughput(hw), 0.0) for m in meshes)
    return Placement(meshes, tpt)


# ---------------------------------------------------------------------------
# spatial-partitioning baseline: one LLM per dedicated mesh
# ---------------------------------------------------------------------------
def place_spatial(models: Sequence[Tuple[ModelConfig, float]],
                  n_devices: int, hw: Hardware = A100,
                  node_size: int = 8, mean_prompt: int = 161,
                  mean_output: int = 338) -> Placement:
    """Dedicated GPUs per LLM, sized by weight need then rate-weighted
    share of the remainder (the vLLM-per-model baseline, §4.1)."""
    base = {cfg.name: cm.weight_devices_needed(cfg, hw)
            for cfg, _ in models}
    used = sum(base.values())
    assert used <= n_devices, "cluster too small for spatial partitioning"
    spare = n_devices - used
    total_need = sum(rate * cfg.active_param_count()
                     for cfg, rate in models) or 1.0
    extra: Dict[str, int] = {}
    for cfg, rate in models:
        share = rate * cfg.active_param_count() / total_need
        extra[cfg.name] = int(spare * share)
    # distribute leftovers to the highest-rate models
    leftover = spare - sum(extra.values())
    for cfg, _rate in sorted(models, key=lambda mr: mr[1], reverse=True):
        if leftover <= 0:
            break
        extra[cfg.name] += 1
        leftover -= 1
    meshes = []
    for i, (cfg, rate) in enumerate(models):
        n = base[cfg.name] + extra[cfg.name]
        tp = 1
        while tp * 2 <= min(n, node_size):
            tp *= 2
        tp = max(tp, cm.weight_devices_needed(cfg, hw))
        meshes.append(Mesh(i, n, [LLMSpec(cfg, rate, mean_prompt,
                                          mean_output, tp=tp, sm_frac=1.0)]))
    tpt = sum(max(m.throughput(hw), 0.0) for m in meshes)
    return Placement(meshes, tpt)
