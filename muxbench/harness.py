"""The harness: a cell's unit built from the port's classes, warmed on
the cell's own buckets, served open loop under the wall clock for the
window, and its served tokens held against the float32 reference.

Nothing here belongs to one cell: the configuration, the traffic and
the metrics are files found by the names in ``BENCHMARK.json``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import sys
import time
import typing
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from muxbench import weights
from muxbench.traffic.generator import make_arrivals, power_law_shares

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# whole top-level module names the benchmark's process may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


# ---------------------------------------------------------------------------
# the cell, from files
# ---------------------------------------------------------------------------
@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json"
              ) -> Cell:
    bench = read_json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def applies(metric: dict) -> bool:
        return name in metric.get("workloads", [name])
    return Cell(name=name, chips=int(w["chips"]),
                config=read_json(ROOT / conf["file"]),
                traffic=read_json(HERE / "traffic" / f"{w['traffic']}.json"),
                end_to_end=[m for m in bench["end_to_end"] if applies(m)],
                per_layer=[m for m in bench["per_layer"] if applies(m)])


def engine_models(config: dict) -> Dict[str, dict]:
    """Engine name -> its model entry, in the configuration's order
    (the first engine is the most popular)."""
    return {e["name"]: config["models"][e["model"]]
            for e in config["engines"]}


def forbidden_modules() -> List[str]:
    return sorted({k.split(".")[0] for k in list(sys.modules)}
                  & set(FORBIDDEN))


def port():
    """The program under test, from the checkout's ``src``."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import repro_torch.serving.driver as driver
    return driver


# ---------------------------------------------------------------------------
# the unit
# ---------------------------------------------------------------------------
# a model entry's keys that are the benchmark's, not the port's
ENTRY_KEYS = ("source", "reference", "max_logit_gap")


def _fields(cls, values: dict, allowed=()) -> dict:
    """``values`` as keyword arguments of dataclass ``cls``, each group
    of keys as the dataclass its field's type names.  A key that is no
    field (``name`` aside: the engine names the model) and not one of
    ``allowed`` is refused; the ``allowed`` keys are left out."""
    fields = {f.name for f in dataclasses.fields(cls)} - {"name"}
    unknown = set(values) - fields - set(allowed)
    if unknown:
        raise ValueError(f"{cls.__name__} has no field {sorted(unknown)}")
    hints = typing.get_type_hints(cls)
    return {k: _group(hints[k], v) if isinstance(v, dict) else v
            for k, v in values.items() if k in fields}


def _group(hint, value: dict):
    for cls in typing.get_args(hint) or (hint,):
        if dataclasses.is_dataclass(cls):
            return cls(**_fields(cls, value))
    raise ValueError(f"a field of type {hint} takes no group of keys")


def model_config(m: dict, name: str):
    """The port's ``ModelConfig`` of model entry ``m``, named ``name``:
    every key a field of it, each group of keys (``ssm``, ``moe``, ...)
    the dataclass its field names; a key that is neither a field nor one
    of ``ENTRY_KEYS`` is refused."""
    from repro_torch.config import ModelConfig
    return ModelConfig(name=name, **_fields(ModelConfig, m, ENTRY_KEYS))


def arrivals(config: dict, traffic: dict, seed: int, seconds: float):
    """The traffic file's arrivals for this configuration's engines."""
    models = engine_models(config)
    return make_arrivals(
        traffic, list(models), {n: m["vocab_size"] for n, m in models.items()},
        int(config["unit"]["max_blocks_per_seq"]) * 16, seed, seconds)


def build_unit(config: dict, traffic: dict, seed: int, device, dtype):
    """One colocated unit as the port's ``build_unit_from_specs`` makes
    it: a ``UnifiedKVPool``, one ``Engine`` an entry with its head-block
    quota in proportion to its share of the traffic, and a
    ``MuxScheduler``; the weights drawn from the seed and handed over
    with no other reference kept, so a fused group's stacking frees
    each member's tree as it goes."""
    port()
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.kvcache import UnifiedKVPool
    from repro_torch.serving.mux import MuxScheduler
    u = config["unit"]
    models = engine_models(config)
    shares = power_law_shares(len(models), float(traffic["alpha"]))
    cfgs = {n: model_config(m, n) for n, m in models.items()}
    head_dims = {c.hd for c in cfgs.values() if not c.attn_free}
    if len(head_dims) != 1:
        raise ValueError(f"one pool, one head_dim: {sorted(head_dims)}")
    blocks = int(u["pool_blocks"])
    pool = UnifiedKVPool(blocks, head_dims.pop(), dtype=dtype,
                         device=device)
    min_quota = max(blocks // (8 * len(cfgs)), 1)
    engines = {}
    for i, (name, share) in enumerate(zip(cfgs, shares)):
        quota = max(int(blocks * float(share)), min_quota)
        engines[name] = Engine(
            cfgs[name],
            weights.make_tree(models[name], seed, i, dtype, device),
            pool.register_model(cfgs[name], quota),
            max_slots=int(u["max_slots"]),
            max_blocks_per_seq=int(u["max_blocks_per_seq"]),
            chunk_tokens=int(u["chunk_tokens"]) or None)
    return MuxScheduler(engines, pool, policy=u["policy"],
                        fused=bool(u["fused"]))


def _probe_rows(eng) -> List[int]:
    """The row counts the engine's steps take: powers of two for the
    attention steps (padded buckets), every count for the SSM steps
    (exact rows)."""
    if eng.cfg.ssm:
        return list(range(1, eng.max_slots + 1))
    return [1 << k for k in range(eng.max_slots.bit_length())
            if 1 << k <= eng.max_slots]


def _prefill_buckets(eng, traffic: dict) -> List[tuple]:
    """``(rows, prompt length)`` of a probe for every whole-prompt bucket
    the traffic can reach on an engine without chunked prefill: the
    rows' power-of-two buckets at every padded length of the traffic's
    prompt range (clipped to the sequence envelope, as ``arrivals``
    clips it), then the decode's exact row counts (``_probe_rows``) at
    the shortest."""
    block = eng.pool.block_tokens
    spec = traffic["prompt"]
    lo = max(1, int(spec["min"]))
    hi = min(int(spec["max"]), eng.max_blocks * block - 2)
    padded = sorted({-(-n // block) * block for n in range(lo, hi + 1)})
    rows = sorted({min(1 << (b - 1).bit_length(), eng.max_slots)
                   for b in range(1, eng.max_slots + 1)})
    out = [(r, min(s, hi)) for s in padded for r in rows]
    return out + [(b, min(padded[0], hi)) for b in _probe_rows(eng)
                  if b not in rows]


def warm(unit, seed: int, traffic: dict) -> dict:
    """Capture every step this unit's traffic can take before the wall
    clock starts: each engine's lone chunk and decode steps at every
    row bucket (with chunked prefill), or its whole-prompt prefill at
    every bucket of rows and padded length ``traffic`` reaches and its
    decode at every row bucket (without), then, through the scheduler,
    the fused groups' sweeps.  Probes have two output tokens; they
    finish and free what they held."""
    from repro_torch.serving.engine import Request
    from repro_torch.serving import graphs
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    before = sum(graphs.GRAPH_CAPTURES.values())

    def probes(name, eng, n, length):
        return [Request(-1, name, rng.integers(
            1, eng.cfg.vocab_size, length).tolist(), 2)
                for _ in range(n)]

    def serve(eng, reqs):
        eng.prefill(reqs)
        while eng.has_prefill_work():
            eng.prefill([])
        while eng.has_decode_work():
            eng.decode()
        eng.finished.clear()
    whole = 0
    for name, eng in unit.engines.items():
        if eng.chunk_tokens:
            for b in _probe_rows(eng):
                serve(eng, probes(name, eng, b, eng.chunk_tokens))
            continue
        for b, length in _prefill_buckets(eng, traffic):
            serve(eng, probes(name, eng, b, length))
            whole += 1
    if unit.fused_groups:
        for grp in unit.fused_groups:
            for name, eng in zip(grp.names, grp.engines):
                for r in probes(name, eng, eng.max_slots,
                                eng.chunk_tokens or eng.pool.block_tokens):
                    unit.submit(r)
        while unit.pending():
            unit.tick()
        unit.stats.finished.clear()
    if unit.pool.device.type == "cuda":
        torch.cuda.synchronize()
    return dict(seconds=time.perf_counter() - t0,
                captures=sum(graphs.GRAPH_CAPTURES.values()) - before,
                whole_prompt_probes=whole)


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------
@dataclass
class Served:
    """What one request saw, on the session's clock (seconds)."""
    req_id: int
    engine: str
    due: float
    window: bool
    prompt: List[int] = field(repr=False)
    tokens: int = 0
    first: float = -1.0
    last: float = -1.0
    resets: int = 0
    shed: bool = False
    finished: bool = False
    output: List[int] = field(default_factory=list, repr=False)


@dataclass
class Window:
    t0: float                 # window start, session clock (s)
    t1: float                 # window end, session clock (s)
    clock0: float             # the session clock's origin, perf_counter
    requests: List[Served]
    tokens: int               # tokens committed in [t0, t1)
    ticks: int                # unit ticks in [t0, t1)
    lateness: List[float]     # submit time - due time of window requests
    captures: int             # graph captures during fill and window


def serve(unit, arrivals, fill: float, seconds: float, probe=None,
          watch=None) -> Window:
    """Drive ``ServeSession.step`` under the wall clock from the start of
    the fill period to the end of the window, sleeping up to the next
    due arrival when idle.  Token times come from the scheduler's
    emission hook; tokens committed after the window's end are not
    counted.  ``probe`` instruments a traced run (``probe.Probe``);
    ``watch(now)`` is called at every iteration."""
    driver = port()
    from repro_torch.serving import graphs
    from repro_torch.serving.engine import Request
    reqs = [Request(a.req_id, a.engine, list(a.prompt), a.max_new,
                    arrival=a.due) for a in arrivals]
    served = {a.req_id: Served(a.req_id, a.engine, a.due, a.window,
                               a.prompt) for a in arrivals}
    t0, t1 = fill, fill + seconds
    counts = dict(tokens=0)
    session = None

    def emit(event, r, tok):
        if r.req_id < 0:
            return
        s = served[r.req_id]
        if event == "token":
            now = session.clock()
            if now >= t1:
                return
            if s.first < 0:
                s.first = now
            s.last = now
            s.tokens += 1
            if now >= t0:
                counts["tokens"] += 1
        elif event == "reset":
            s.resets += 1
    unit.set_emit(emit)
    late: List[float] = []
    submit = unit.submit

    def timed_submit(r):
        if served[r.req_id].window:
            late.append(session.clock() - r.arrival)
        submit(r)
    unit.submit = timed_submit
    refs = {n: driver.SLORef(0.0, 0.0) for n in unit.engines}
    captures0 = sum(graphs.GRAPH_CAPTURES.values())
    session = driver.ServeSession([unit], reqs, refs=refs, warm=False)
    ticks0 = None
    while True:
        now = session.clock()
        if ticks0 is None and now >= t0:
            ticks0 = session.ticks
        if probe is not None:
            probe.at(now, t0, t1)
        if watch is not None:
            watch(now)
        if now >= t1:
            break
        if probe is not None:
            status, wait = probe.session_step(session.step)
        else:
            status, wait = session.step()
        if status == "done":
            time.sleep(max(0.0, t1 - session.clock()))
        elif status == "idle":
            time.sleep(max(0.0, min(wait, t1 - session.clock())))
    if unit.pool.device.type == "cuda":
        torch.cuda.synchronize()
    ticks = session.ticks - (ticks0 or 0)
    del unit.submit
    for r in reqs:
        s = served[r.req_id]
        s.shed = r.shed
        s.finished = r.finish >= 0
        if s.finished:
            s.output = list(r.output)
    return Window(t0=t0, t1=t1, clock0=session.clock.t0,
                  requests=list(served.values()), tokens=counts["tokens"],
                  ticks=ticks, lateness=late,
                  captures=sum(graphs.GRAPH_CAPTURES.values()) - captures0)


# ---------------------------------------------------------------------------
# correctness
# ---------------------------------------------------------------------------
MIN_SAMPLE_TOKENS = 1024
MIN_SAMPLE_REQUESTS = 3


def sample(w: Window, seed: int) -> Dict[str, List[Served]]:
    """Per engine, the finished requests that are checked: the one that
    served the most tokens, then others drawn from the seed until the
    sample holds ``MIN_SAMPLE_TOKENS`` served tokens and
    ``MIN_SAMPLE_REQUESTS`` requests."""
    rng = np.random.default_rng(seed)
    by: Dict[str, List[Served]] = {}
    for s in w.requests:
        if s.finished and s.resets == 0 and s.output:
            by.setdefault(s.engine, []).append(s)
    out: Dict[str, List[Served]] = {}
    for name, done in by.items():
        done.sort(key=lambda s: s.req_id)
        longest = max(done, key=lambda s: len(s.output))
        rest = [done[i] for i in rng.permutation(len(done))
                if done[i] is not longest]
        pick, n = [longest], len(longest.output)
        for s in rest:
            if n >= MIN_SAMPLE_TOKENS and len(pick) >= MIN_SAMPLE_REQUESTS:
                break
            pick.append(s)
            n += len(s.output)
        out[name] = pick
    return out


def check(config: dict, picked: Dict[str, List[Served]], seed: int,
          device, dtype, control: bool = False) -> dict:
    """Hold each engine's sampled sequences against the float32
    reference, one model at a time, with its weights made again from
    the seed.  Returns per engine its widest gap (``gap``), its limit,
    the tokens checked and, with ``control``, the control's gap."""
    from muxbench.reference.common import served_gaps
    models = engine_models(config)
    out = {}
    for i, (name, m) in enumerate(models.items()):
        seqs = [(s.prompt, s.output) for s in picked.get(name, [])]
        row = dict(limit=m.get("max_logit_gap"), sequences=len(seqs),
                   tokens=sum(len(o) for _, o in seqs))
        if seqs:
            tree = weights.make_tree(m, seed, i, dtype, device)
            g = served_gaps(m, tree, seqs, control=control)
            del tree
            row["gap"] = max(g["program"])
            if control:
                row["control_gap"] = max(g["control"])
            free(device)
        out[name] = row
    return out


def verdict(checks: dict, gap: str = "gap") -> bool:
    """Correct: every engine has checked sequences, and each widest gap
    is within its limit.  ``gap="control_gap"`` judges the control's
    readings (``check(..., control=True)``) by the same rule."""
    return all(r["sequences"] > 0 and r.get(gap) is not None
               and r["limit"] is not None and r[gap] <= r["limit"]
               for r in checks.values())


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def release(unit) -> None:
    """Drop every captured graph and the unit's references, so the
    reference runs on a card that holds nothing of the program."""
    port()
    from repro_torch.serving import graphs
    graphs.REGISTRY.clear()
    unit.fused_groups.clear()
    unit.engines.clear()
    unit.queues.clear()
    unit.pool = None
