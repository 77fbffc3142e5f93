"""The port's span recorder (``serving/metrics.py``: ``RECORDER``,
``traced``, ``SpanRecord``) and the spans and counters of the serving
loop, on the CPU: reduced units built from the port's own classes (a
fused pair of one model, and a Mamba2 beside a Qwen2, as the
benchmark's two configurations), and for the profiler's clock a reduced
copy of the benchmark's ``pair-chat`` cell.

* disarmed, nothing is recorded and no profiler function is called;
* armed, spans nest under the span open around them, and a span's self
  time is its duration less its children's;
* each request's ``request.queue`` span carries its id;
* a fused decode step counts M x rows computed against its live rows, a
  padded serial step its power-of-two bucket, a chunk sweep its rows x
  chunk tokens against the true chunk lengths;
* no program span takes a name the benchmark's probe gives its own;
* under ``torch.profiler`` each span is an annotation of its name, in
  order, and the record's offset puts each start on the trace's clock
  within 20 us, or half the distance of the start's own two stamps
  where that is wider;
* ``ServingMetrics.snapshot()`` still equals the JAX package's.
"""
from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.serving import graphs
from repro_torch.serving import metrics as M
from repro_torch.serving.driver import (ServeSession, TickCostModel,
                                        build_unit_from_specs)
from repro_torch.serving.engine import Request
from repro_torch.serving.metrics import RECORDER, traced

ROOT = Path(__file__).resolve().parents[1]


def reserved_span_name(name: str) -> bool:
    """The names the benchmark's probe (``muxbench/probe.py``) gives its
    own spans around the program's calls, and attributes steps by."""
    return name in ("tick", "session", "argmax", "profiled") \
        or name.startswith("step.")


@pytest.fixture
def recorder():
    RECORDER.disarm()
    RECORDER.reset()
    try:
        yield RECORDER
    finally:
        RECORDER.disarm()
        RECORDER.reset()


UNITS = {
    # two fine-tunes of one model, fused into one group
    "pair": [("qwen2-7b.a", "qwen2-7b", 0.65),
             ("qwen2-7b.b", "qwen2-7b", 0.35)],
    # a Mamba2 beside a Qwen2: serial steps, the SSM's exact rows
    "dense-ssm": [("mamba2-2.7b", "mamba2-2.7b", 0.65),
                  ("qwen2-7b", "qwen2-7b", 0.35)],
}


def _unit(kind: str, seed: int = 3):
    """A reduced float32 unit of ``UNITS[kind]``: 4 slots an engine,
    16-token chunks, ADBS, fused where the geometry allows."""
    return build_unit_from_specs(UNITS[kind], pool_blocks=4_000,
                                 max_slots=4, chunk_tokens=16, seed=seed,
                                 policy="adbs", fused=True,
                                 dtype=torch.float32, device="cpu")


def _pair_chat_cell(seed: int = 3):
    """The benchmark's ``pair-chat`` cell, reduced for the CPU."""
    from muxbench import harness
    from muxbench.tests.cells import reduced_cell
    c = reduced_cell("pair-chat")
    return harness.build_unit(c.config, c.traffic, seed, torch.device("cpu"),
                              torch.float32)


def _requests(unit, n_each, prompt, max_new, seed=0, rid=0):
    rng = np.random.default_rng(seed)
    out = []
    for name, eng in unit.engines.items():
        for _ in range(n_each):
            out.append(Request(rid, name, rng.integers(
                1, eng.cfg.vocab_size, prompt).tolist(), max_new))
            rid += 1
    return out


def _serve(unit, reqs) -> int:
    """Serve ``reqs`` to the end; the unit's ticks."""
    session = ServeSession([unit], reqs, cost=TickCostModel(), warm=False)
    ticks = 0
    while True:
        status = session.step()[0]
        if status == "done":
            return ticks
        ticks += status == "tick"


# ---------------------------------------------------------------------------
# the recorder alone
# ---------------------------------------------------------------------------
def test_spans_nest_and_self_time_is_the_span_less_its_children(recorder):
    @traced("outer.call")
    def outer():
        inner()
        block()

    @traced("inner.block")
    def block():
        inner()

    @traced("inner.call")
    def inner():
        return sum(range(2000))

    recorder.arm(capacity=64)
    outer()
    recorder.disarm()
    rec = recorder.record()
    assert rec.names == ["outer.call", "inner.call", "inner.block",
                         "inner.call"]
    assert list(rec.parent) == [-1, 0, 0, 2]
    assert list(rec.req) == [-1] * 4
    dur = [b - a for a, b in zip(rec.t0, rec.t1)]
    assert all(d > 0 for d in dur)
    own = rec.self_ns()
    assert own == [dur[0] - dur[1] - dur[2], dur[1], dur[2] - dur[3], dur[3]]
    assert rec.self_total_ns("inner.") == own[1] + own[2] + own[3]
    assert rec.total_ns("inner.call") == dur[1] + dur[3]
    # children lie within their parents
    for i, p in enumerate(rec.parent):
        if p >= 0:
            assert rec.t0[p] <= rec.t0[i] <= rec.t1[i] <= rec.t1[p]


def test_store_is_bounded_and_counts_what_it_drops(recorder):
    @traced("a.span")
    def a():
        b()

    @traced("b.span")
    def b():
        pass

    recorder.arm(capacity=3)
    for _ in range(5):
        a()
    recorder.disarm()
    rec = recorder.record()
    assert rec.names == ["a.span", "b.span", "a.span"]
    assert rec.dropped == 7
    assert list(rec.parent) == [-1, 0, -1]
    assert recorder._stack == []


def test_disarmed_records_nothing_and_calls_no_profiler(recorder,
                                                        monkeypatch):
    import torch.autograd.profiler as ap

    def refuse(*a, **kw):
        raise AssertionError("a profiler function was called")
    monkeypatch.setattr(ap, "record_function", refuse)
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        refuse)
    unit = _unit("pair")
    _serve(unit, _requests(unit, 2, 20, 3))
    rec = recorder.record()
    assert len(rec) == 0 and rec.counters == {} and rec.dropped == 0
    # armed outside a profiler session: spans, and still no profiler call
    recorder.arm(capacity=1 << 14)
    unit = _unit("pair")
    _serve(unit, _requests(unit, 2, 20, 3))
    recorder.disarm()
    rec = recorder.record()
    assert len(rec) > 0 and not any(rec.annotated)


# ---------------------------------------------------------------------------
# the serving loop's spans and counters
# ---------------------------------------------------------------------------
def test_served_trace_spans_nest_by_layer(recorder):
    unit = _unit("pair")
    reqs = _requests(unit, 3, 40, 4)
    recorder.arm(capacity=1 << 14)
    ticks = _serve(unit, reqs)
    recorder.disarm()
    rec = recorder.record()
    names = set(rec.names)
    assert {"sched.tick", "plan.batch", "plan.inputs", "readback.finite",
            "readback.tokens", "engine.commit", "pool.table",
            "pool.append", "pool.free", "request.queue"} <= names
    parent_of = {}
    for i, p in enumerate(rec.parent):
        parent_of.setdefault(rec.names[i], set()).add(
            rec.names[p] if p >= 0 else None)
    assert parent_of["sched.tick"] == {None}
    assert parent_of["request.queue"] == {None}
    for n in ("plan.batch", "plan.inputs", "readback.finite",
              "readback.tokens", "engine.commit"):
        assert parent_of[n] == {"sched.tick"}, n
    assert parent_of["pool.append"] <= {"sched.tick", "engine.commit"}
    assert parent_of["pool.table"] <= {"plan.batch", "pool.table"}
    assert parent_of["pool.free"] <= {"engine.commit"}
    # the CPU path replays no graph
    assert not any(n.startswith("graph.") for n in names)
    assert rec.count("sched.tick") == ticks > 0


def test_request_queue_spans_carry_the_request_ids(recorder):
    unit = _unit("dense-ssm")
    reqs = _requests(unit, 5, 12, 2, rid=100)
    recorder.arm(capacity=1 << 14)
    _serve(unit, reqs)
    recorder.disarm()
    rec = recorder.record()
    queued = [i for i, n in enumerate(rec.names) if n == "request.queue"]
    assert sorted(rec.req[i] for i in queued) == [r.req_id for r in reqs]
    for i in queued:
        assert rec.t1[i] >= rec.t0[i] and not rec.annotated[i]
    assert all(not hasattr(r, "_queued_ns") for r in reqs)
    assert len(rec.durations_ns("request.queue")) == len(reqs)


def _reach_decode(unit, reqs):
    for r in reqs:
        unit.submit(r)
    while any(e.has_prefill_work() for e in unit.engines.values()) \
            or any(unit.queues.values()):
        unit.tick()


def test_fused_sweeps_count_computed_against_real(recorder):
    unit = _unit("pair")
    (grp,) = unit.fused_groups
    a, b = grp.names
    reqs = [Request(i, a, list(range(1, 11 + 6 * i)), 6) for i in range(3)] \
        + [Request(3, b, list(range(1, 21)), 6)]
    for r in reqs:
        unit.submit(r)
    recorder.arm(capacity=1 << 14)
    unit.tick()          # admits all four, runs the first chunk sweep
    clens = [min(len(r.prompt), 16) for r in reqs]
    assert recorder.counters["tokens.chunk.real"] == sum(clens)
    assert recorder.counters["tokens.chunk.computed"] == 2 * grp.rows * 16
    while any(e.has_prefill_work() for e in unit.engines.values()):
        unit.tick()
    recorder.reset()
    unit.tick()          # one fused decode sweep over 3 + 1 live rows
    recorder.disarm()
    assert recorder.counters == {"rows.decode.real": 4,
                                 "rows.decode.computed": 2 * grp.rows}


def test_padded_serial_steps_count_their_bucket(recorder):
    unit = _unit("dense-ssm")
    (ssm,) = [n for n, e in unit.engines.items() if e.cfg.ssm]
    (dense,) = [n for n, e in unit.engines.items() if not e.cfg.ssm]
    reqs = [Request(i, dense, list(range(1, 9)), 5) for i in range(3)] \
        + [Request(3 + i, ssm, list(range(1, 9)), 5) for i in range(3)]
    recorder.arm(capacity=1 << 14)
    _reach_decode(unit, reqs)
    # each engine prefilled its three 8-token prompts in one chunk step:
    # the attention engine's bucket of four rows, the SSM's exact rows
    assert recorder.counters["tokens.chunk.real"] == 6 * 8
    assert recorder.counters["tokens.chunk.computed"] == (4 + 3) * 16
    recorder.reset()
    unit.tick()          # one serial decode step a model
    recorder.disarm()
    assert recorder.counters == {"rows.decode.real": 3 + 3,
                                 "rows.decode.computed": 4 + 3}


class _CpuCapture:
    """A capture of CPU operands, as ``test_torch_step_graphs``' stub: a
    replay runs the body into the static output."""

    device_types = ("cpu",)

    def eager(self, fn, device):
        self._last = fn()
        return self._last

    def record(self, key, fn, device):
        out = torch.empty_like(self._last)
        return (lambda body: out.copy_(body())), out


def test_replayed_steps_record_the_graph_spans(recorder):
    """Through a capture stub on the CPU: a replay is its load, replay
    and clone; a capture (counted in ``GRAPH_CAPTURES``) loads its
    static input once and replays nothing."""
    saved = graphs.REGISTRY.capture
    graphs.REGISTRY.clear()
    graphs.REGISTRY.capture = _CpuCapture()
    try:
        unit = _unit("pair")
        captures = sum(graphs.GRAPH_CAPTURES.values())
        replays = sum(graphs.GRAPH_REPLAYS.values())
        recorder.arm(capacity=1 << 14)
        _serve(unit, _requests(unit, 2, 20, 4))
        recorder.disarm()
        rec = recorder.record()
        captured = sum(graphs.GRAPH_CAPTURES.values()) - captures
        n = sum(graphs.GRAPH_REPLAYS.values()) - replays
        assert captured > 0 and n > 0
        assert rec.count("graph.replay") == rec.count("graph.clone") == n
        # a replay's load, a capture's static input's first load
        assert rec.count("graph.load") == n + captured
        parents = {rec.names[rec.parent[i]] for i, x in enumerate(rec.names)
                   if x == "graph.load"}
        assert parents == {"sched.tick"}
    finally:
        graphs.REGISTRY.capture = saved
        graphs.REGISTRY.clear()


def test_no_program_span_takes_a_reserved_name(recorder):
    used = set()
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        text = path.read_text()
        used |= set(re.findall(r'traced\("([^"]+)"\)', text))
    assert {"plan.batch", "graph.replay", "pool.append"} <= used
    unit = _unit("dense-ssm")
    recorder.arm(capacity=1 << 14)
    _serve(unit, _requests(unit, 2, 20, 3))
    recorder.disarm()
    used |= set(recorder.record().names)
    assert not [n for n in used if reserved_span_name(n)]
    for n in ("step.decode", "argmax", "tick", "session", "profiled"):
        assert reserved_span_name(n)


def test_snapshot_still_equals_the_reference(recorder):
    from repro.serving import metrics as ref

    def fill(m):
        m.requests_submitted.inc(llm="a")
        m.ttft_seconds.observe(0.03, llm="a")
        m.queue_depth.set(2, llm="a")
        return m.snapshot()
    recorder.arm(capacity=16)
    assert fill(M.ServingMetrics()) == fill(ref.ServingMetrics())
    recorder.disarm()
    assert set(ref.__all__) <= set(M.__all__)


# ---------------------------------------------------------------------------
# the profiler's clock
# ---------------------------------------------------------------------------
def test_spans_are_annotations_on_the_trace_clock(recorder, tmp_path):
    """As in a traced run, the profiler's session opens with an
    annotation of its own (the probe's ``profiled``: a session's first
    annotation pays its set-up), and the collector is held off while
    the steps run, so its pauses do not fall between two stamps."""
    import gc
    from torch.profiler import ProfilerActivity, profile, record_function
    unit = _pair_chat_cell()
    reqs = _requests(unit, 2, 24, 3)
    session = ServeSession([unit], reqs, cost=TickCostModel(), warm=False)
    session.step()                         # spans outside the profiler
    recorder.arm(capacity=1 << 14)
    session.step()
    before = recorder.n
    gc.disable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("profiled"):
                for _ in range(2):
                    session.step()
    finally:
        gc.enable()
    after = recorder.n
    session.step()
    recorder.disarm()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    rec = recorder.record()
    mine = [i for i in range(len(rec)) if rec.annotated[i]]
    assert mine == [i for i in range(before, after)
                    if rec.names[i] != "request.queue"]
    names = set(rec.names)
    theirs = sorted((e["ts"], e["name"]) for e in events
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e["name"] in names)
    assert [n for _, n in theirs] == [rec.names[i] for i in mine]
    assert rec.align(events) is not None
    # a start is the middle of two stamps around the profiler's own, so
    # it lies within half their distance of it, and within 20 us where
    # that is less (their distance grows where the profiler takes a slow
    # path or the thread loses the processor between them)
    off = [abs(rec.on_trace(i)[0] - ts) for (ts, _), i in zip(theirs, mine)]
    for d, i in zip(off, mine):
        assert d < max(20.0, rec.annotated[i] / 2e3), rec.names[i]
    assert sum(d < 20.0 for d in off) >= 0.9 * len(off)
