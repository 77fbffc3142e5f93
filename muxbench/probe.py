"""The traced run's instruments, all on the benchmark's side of the
program's calls (no span is added inside the program).

* host clock around ``ServeSession.step``, ``MuxScheduler.tick``, every
  step function of every engine and fused group (the host plan and the
  graph replay's launch: decodes, chunked prefills and whole-prompt
  prefills), and ``greedy_tokens`` (the argmax read back, where the host
  waits for the card);
* the shapes of every profiled step call's real rows, read from the
  step's host arguments (token counts, offsets, context lengths) before
  it runs, and the step's bound from the family module of each model in
  it (``muxbench/families/``);
* ``torch.profiler`` (CUPTI) over the window's last ``PROFILE_S``
  seconds, with the host spans above as annotations, for each step's
  device time (the union of the device operations launched under its
  ``step.<kind>`` annotation, graph replays included), the kernels'
  device time by name, the device's busy time and what the host did
  while the card idled.  CUPTI is started once at set-up, and the
  profiler is stopped (and its events read) after the window, so
  neither lands inside it.
"""
from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from muxbench import bounds, families

PROFILE_S = 2.0
# kernel groups by CUDA function name: kernel 1 (paged split-KV decode
# and its combine), kernel 2 (paged chunk prefill: the tensor-core
# attention with paged addressing), kernel 4 (the SSD scan), and the
# groups the family modules add
KERNELS = families.kernel_groups(
    {"k1": "splitkv_", "k2": "PagedAddr", "k4": "ssd_scan"})
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# host events that launch device work (their correlation ids mark it)
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
LAUNCH_SLACK_US = 100.0


@dataclass
class Step:
    kind: str                         # "decode", "chunk" or "prefill"
    parts: List[Tuple[str, dict]]     # (engine, real rows' shapes)
    bound_s: float = 0.0
    kernel_bound_s: Dict[str, float] = field(default_factory=dict)
    host_s: float = 0.0               # the call on the host clock


def _fused_decode(names):
    def parse(args, kw):
        _, _, lens, _, tables = args
        return [(n, dict(lens=lens[m][tables[m, :, 0] >= 0].tolist()))
                for m, n in enumerate(names)
                if (tables[m, :, 0] >= 0).any()]
    return parse


def _fused_chunk(names):
    def parse(args, kw):
        _, _, offs, clens, _, _ = args
        return [(n, dict(offs=offs[m][clens[m] > 0].tolist(),
                         clens=clens[m][clens[m] > 0].tolist()))
                for m, n in enumerate(names) if (clens[m] > 0).any()]
    return parse


def _decode(name, state):
    def parse(args, kw):
        if state:
            rows = len(kw["slots"])
            return [(name, dict(rows=rows,
                                lens=np.asarray(args[3])[:rows].tolist()))]
        lens, table = args[3], args[5]
        return [(name, dict(lens=lens[table[:, 0] >= 0].tolist()))]
    return parse


def _chunk(name, state):
    def parse(args, kw):
        if state:
            return [(name, dict(clens=np.asarray(args[3]).tolist(),
                                fresh=np.asarray(kw["fresh"]).tolist()))]
        offs, clens = args[3], args[4]
        real = clens > 0
        return [(name, dict(offs=offs[real].tolist(),
                            clens=clens[real].tolist()))]
    return parse


def _prefill(name, state):
    """A whole-prompt prefill: toks [B, S], lens [B] (0 on padded rows),
    in either form."""
    def parse(args, kw):
        lens = np.asarray(args[3])
        return [(name, dict(lens=lens[lens > 0].tolist()))]
    return parse


# each engine's step functions: (attribute, kind, parser); an engine
# whose model carries a state (``cfg.ssm``) takes the state form
ENGINE_STEPS = (("_decode_fn", "decode", _decode),
                ("_chunk_fn", "chunk", _chunk),
                ("_prefill_fn", "prefill", _prefill))
# a fused group's: its decode sweep and its chunk sweep
GROUP_STEPS = (("_decode_fn", "decode", _fused_decode),
               ("_prefill_fn", "chunk", _fused_chunk))


def step_bound(kind: str, parts, models: Dict[str, dict]
               ) -> Tuple[float, Dict[str, float]]:
    """A step's bound seconds and its kernels' bound seconds: the bytes
    and FLOPs of every model's rows in it, each from its family's step
    of ``kind`` over that model's engines."""
    by: Dict[int, Tuple[dict, list]] = {}
    for name, shp in parts:
        m = models[name]
        by.setdefault(id(m), (m, []))[1].append(shp)
    n_bytes = flops = 0
    kernels: Dict[str, float] = {}
    for m, shps in by.values():
        b, f, k = getattr(families.of(m), kind)(m, shps)
        n_bytes, flops = n_bytes + b, flops + f
        for key, v in k.items():
            kernels[key] = kernels[key] + v if key in kernels else v
    return bounds.bound_s(n_bytes, flops), kernels


class Probe:
    def __init__(self, unit, models: Dict[str, dict],
                 profile_s: float = PROFILE_S):
        self.unit = unit
        self.models = models
        self.profile_s = profile_s
        self.cuda = unit.pool.device.type == "cuda"
        self.host: Counter = Counter()
        self.ticks = 0
        self.steps: List[Step] = []
        self.in_window = False
        self.prof = None
        self.profiling = False
        self._profiled_range = None
        self.trace: Optional[dict] = None
        self._undo: List[Callable[[], None]] = []

    # -- instruments ------------------------------------------------------
    def _label(self, label: str, fn, key: Optional[str] = None):
        from torch.profiler import record_function

        def call(*args, **kw):
            t = time.perf_counter()
            with record_function(label):
                out = fn(*args, **kw)
            if self.in_window and key is not None:
                self.host[key] += time.perf_counter() - t
            return out
        return call

    def _step(self, fn, kind: str, parse):
        from torch.profiler import record_function

        def call(*args, **kw):
            rec, prof = self.in_window, self.profiling
            if prof:
                parts = parse(args, kw)
            t = time.perf_counter()
            with record_function(f"step.{kind}"):
                out = fn(*args, **kw)
            dt = time.perf_counter() - t
            if rec:
                self.host["steps"] += dt
            if prof:
                self.steps.append(Step(kind, parts, host_s=dt))
            return out
        return call

    def _patch(self, obj, attr, new) -> None:
        old = obj.__dict__.get(attr, None)
        setattr(obj, attr, new)
        if old is None:
            self._undo.append(lambda: delattr(obj, attr))
        else:
            self._undo.append(lambda: setattr(obj, attr, old))

    def install(self) -> None:
        from repro_torch.serving import engine as engine_mod
        from repro_torch.serving import mux as mux_mod
        u = self.unit
        tick = self._label("tick", u.tick, "tick")

        def timed_tick():
            if self.in_window:
                self.ticks += 1
            return tick()
        self._patch(u, "tick", timed_tick)
        for grp in u.fused_groups:
            for attr, kind, parse in GROUP_STEPS:
                fn = getattr(grp, attr, None)
                if fn is not None:
                    self._patch(grp, attr,
                                self._step(fn, kind, parse(grp.names)))
        for name, eng in u.engines.items():
            state = eng.cfg.ssm is not None
            for attr, kind, parse in ENGINE_STEPS:
                fn = getattr(eng, attr, None)
                if fn is not None:
                    self._patch(eng, attr,
                                self._step(fn, kind, parse(name, state)))
        if self.cuda:
            # CUPTI's first start takes seconds: pay it at set-up
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                torch.ones(1, device=u.pool.device).add_(1)
                torch.cuda.synchronize()
        greedy = engine_mod.greedy_tokens
        timed = self._label("argmax", greedy, "argmax")
        for mod in (engine_mod, mux_mod):
            mod.greedy_tokens = timed
            self._undo.append(lambda mod=mod: setattr(mod, "greedy_tokens",
                                                      greedy))

    def uninstall(self) -> None:
        while self._undo:
            self._undo.pop()()

    def session_step(self, step):
        from torch.profiler import record_function
        t = time.perf_counter()
        with record_function("session"):
            out = step()
        if self.in_window:
            self.host["session"] += time.perf_counter() - t
        return out

    # -- the profiled span --------------------------------------------------
    def at(self, now: float, t0: float, t1: float) -> None:
        """Called by the serving loop at each iteration (session clock):
        marks the window and starts the profiler ``profile_s`` before
        its end (``finish`` stops it)."""
        self.in_window = t0 <= now < t1
        start = max(t0, t1 - self.profile_s)
        if (self.cuda and self.prof is None and self.in_window
                and now >= start):
            from torch.profiler import (ProfilerActivity, profile,
                                        record_function)
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self._profiled_range = record_function("profiled")
            self._profiled_range.__enter__()
            self.profiling = True

    # -- after the window ---------------------------------------------------
    def finish(self) -> None:
        """Read the trace, and work out each profiled step's bound time
        and kernel bounds (``step_bound``)."""
        if self.profiling:
            torch.cuda.synchronize()
            self._profiled_range.__exit__(None, None, None)
            self.prof.stop()
            self.profiling = False
        if self.cuda:
            torch.cuda.synchronize()
        for s in self.steps:
            s.bound_s, s.kernel_bound_s = step_bound(s.kind, s.parts,
                                                     self.models)
        if self.prof is not None:
            self.trace = read_trace(self.prof)
            self.trace["steps"] = step_reads(
                self.steps, self.trace.pop("step_times"))
            self.trace["info"]["steps"] = {
                k: {n: r[n] for n in ("read", "unread")}
                for k, r in self.trace["steps"].items()}
            self.prof = None
        self.unit = None


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _clip(iv, lo: float, hi: float):
    return [(max(a, lo), min(b, hi)) for a, b in iv if b > lo and a < hi]


def _total(iv) -> float:
    return sum(b - a for a, b in iv)


def short_name(name: str) -> str:
    """A kernel's CUDA name without its return type, arguments and
    namespaces; template arguments kept short."""
    name = re.sub(r"^void ", "", name)
    name = re.sub(r"\((?!anonymous).*$", "", name)
    name = re.sub(r"\b[A-Za-z_]\w*::", "", name)
    return name[:120]


def _cat(e) -> str:
    return str(e.get("cat", "")).lower()


def step_device_s(events, lo: float, hi: float) -> list:
    """The device work of every ``step.<kind>`` annotation, in time
    order: ``(kind, seconds, kernels)``, the seconds the union of its
    device operations covers inside the profiled span [lo, hi] (trace
    microseconds).  A device operation is a step's when its launch (a
    runtime or driver call, matched by correlation id; a graph replay's
    kernels carry its launch's) falls in the step's annotation, or up to
    ``LAUNCH_SLACK_US`` past its end while no other of the loop's leaf
    annotations (a step, the argmax read-back) has begun: the host clock
    of the annotations and CUPTI's of the launches differ by some
    microseconds."""
    leaves = sorted(((e["ts"], e["ts"] + e["dur"], str(e.get("name", "")))
                     for e in events if e.get("ph") == "X"
                     and _cat(e) == "user_annotation"
                     and (str(e.get("name", "")).startswith("step.")
                          or e.get("name") == "argmax")),
                    key=lambda a: a[0])
    starts = [a for a, _, _ in leaves]
    kinds: List[str] = []
    step_of: Dict[int, int] = {}
    for i, (_, _, name) in enumerate(leaves):
        if name.startswith("step."):
            step_of[i] = len(kinds)
            kinds.append(name[len("step."):])
    owner: Dict[int, int] = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("ph") != "X" or _cat(e) not in LAUNCH_CATS or corr is None:
            continue
        i = bisect.bisect_right(starts, e["ts"]) - 1
        if i in step_of and e["ts"] <= leaves[i][1] + LAUNCH_SLACK_US:
            owner[corr] = step_of[i]
    iv: Dict[int, list] = defaultdict(list)
    kernels: Counter = Counter()
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if (e.get("ph") == "X" and _cat(e) in DEVICE_CATS
                and corr in owner):
            iv[owner[corr]].append((e["ts"], e["ts"] + e["dur"]))
            kernels[owner[corr]] += _cat(e) == "kernel"
    return [(kind, _total(_clip(_union(iv[k]), lo, hi)) / 1e6, kernels[k])
            for k, kind in enumerate(kinds)]


def step_reads(steps: List[Step], times: list) -> dict:
    """Per step kind, the bound and device seconds of the profiled steps
    whose kernels the trace shows (``times`` from ``step_device_s``, in
    the order of ``steps``), and how many showed none (``unread``: such
    a step's device time would read short, so it is left out of both
    sums).  Empty where the two lists do not line up step for step."""
    if [s.kind for s in steps] != [kind for kind, _, _ in times]:
        return {}
    out: Dict[str, dict] = {}
    for s, (kind, dev, kernels) in zip(steps, times):
        r = out.setdefault(kind, dict(bound_s=0.0, device_s=0.0, read=0,
                                      unread=0))
        if kernels:
            r["bound_s"] += s.bound_s
            r["device_s"] += dev
            r["read"] += 1
        else:
            r["unread"] += 1
    return out


def read_trace(prof) -> dict:
    """The profiled span's device intervals (seconds): every device
    operation, each kernel group of ``KERNELS``, the top operations by
    time, and the idle gaps by the innermost host span open at their
    middle."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    span = [e for e in events if e.get("name") == "profiled"
            and e.get("ph") == "X"]
    dev = [e for e in events if _cat(e) in DEVICE_CATS
           and e.get("ph") == "X"]
    info = dict(device_events=len(dev), annotated_span=bool(span))
    if span:
        lo, hi = span[0]["ts"], span[0]["ts"] + span[0]["dur"]
    elif dev:
        lo = min(e["ts"] for e in dev)
        hi = max(e["ts"] + e["dur"] for e in dev)
    else:
        return dict(window_s=0.0, busy_s=0.0, groups={}, step_times=[],
                    device_ops=[], idle_gaps=[], kernels=0, info=info)
    busy = _clip(_union([(e["ts"], e["ts"] + e["dur"]) for e in dev]),
                 lo, hi)
    groups = {}
    for key, pat in KERNELS.items():
        iv = [(e["ts"], e["ts"] + e["dur"]) for e in dev
              if _cat(e) == "kernel" and pat in e.get("name", "")]
        if iv:
            groups[key] = _total(_clip(_union(iv), lo, hi)) / 1e6
    by_op: Counter = Counter()
    for e in dev:
        by_op[short_name(e.get("name", "?"))] += e["dur"] / 1e6
    ann = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if _cat(e) == "user_annotation" and e.get("ph") == "X"
                  and e.get("name") != "profiled"),
                 key=lambda a: a[0])
    gaps: Counter = Counter()
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        open_ = [x for x in ann if x[0] <= mid <= x[1]]
        label = (min(open_, key=lambda x: x[1] - x[0])[2] if open_
                 else "outside the session's step (loop, sleep)")
        gaps[label] += (b - a) / 1e6
    return dict(window_s=(hi - lo) / 1e6, busy_s=_total(busy) / 1e6,
                groups=groups, step_times=step_device_s(events, lo, hi),
                device_ops=[[n, s] for n, s in by_op.most_common(10)],
                idle_gaps=[[n, s] for n, s in gaps.most_common(10)],
                kernels=sum(1 for e in dev if _cat(e) == "kernel"),
                info=dict(info, device_extent_s=(
                    max(e["ts"] + e["dur"] for e in dev)
                    - min(e["ts"] for e in dev)) / 1e6 if dev else 0.0))
