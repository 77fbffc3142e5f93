"""The readers of the program's own spans and counters
(``muxbench/program.py``): exact values from a planted record, None
without one, and a CPU rehearsal of a cell through ``ProgramProbe``."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from muxbench import metrics, program
from muxbench.program import PROGRAM_METRICS
from muxbench.tests.cells import limited

SEED = 2 ** 31 + 91

# (name, start us, end us, parent): one tick of 10 planted ticks
PLANTED = [
    ("sched.tick", 0, 10_000, -1),
    ("plan.batch", 100, 300, 0),
    ("pool.table", 150, 250, 1),
    ("plan.inputs", 300, 400, 0),
    ("graph.load", 400, 450, 0),
    ("graph.replay", 450, 470, 0),
    ("graph.clone", 470, 480, 0),
    ("readback.finite", 500, 8_500, 0),
    ("readback.tokens", 8_500, 8_600, 0),
    ("engine.commit", 8_600, 8_900, 0),
    ("pool.append", 8_700, 8_760, 9),
    ("pool.table", 160, 200, 2),
    ("request.queue", 0, 2_000, -1),
    ("request.queue", 0, 4_000, -1),
]


def _record(rows=PLANTED, counters=None):
    from repro_torch.serving.metrics import SpanRecord
    return SpanRecord(
        names=[r[0] for r in rows], t0=[r[1] * 1000 for r in rows],
        t1=[r[2] * 1000 for r in rows], parent=[r[3] for r in rows],
        req=[-1] * len(rows), annotated=[0] * len(rows),
        counters=dict(counters if counters is not None else {
            "rows.decode.real": 30, "rows.decode.computed": 64,
            "tokens.chunk.real": 100, "tokens.chunk.computed": 400}))


def _run(rec, ticks=10):
    return SimpleNamespace(probe=SimpleNamespace(program=rec, ticks=ticks))


def test_planted_record_reads_exactly():
    run = _run(_record())
    want = dict(plan_host_us=30.0, launch_host_us=8.0, finite_wait_us=800.0,
                token_copy_us=10.0, alloc_host_us=16.0,
                decode_row_fill=100 * 30 / 64, chunk_token_fill=25.0,
                queue_wait_ms=3.0)
    assert set(want) == set(PROGRAM_METRICS)
    for name, v in want.items():
        assert metrics.read(name, run) == pytest.approx(v), name


def test_without_a_record_every_reader_is_silent():
    for run in (SimpleNamespace(probe=None),
                SimpleNamespace(probe=SimpleNamespace(ticks=10)),
                _run(None)):
        for name in PROGRAM_METRICS:
            assert metrics.read(name, run) is None, name
    # a record without the spans or counters a reader wants
    bare = _run(_record([("sched.tick", 0, 10, -1)], counters={}))
    for name in PROGRAM_METRICS:
        assert metrics.read(name, bare) is None, name
    assert metrics.read("plan_host_us", _run(_record(), ticks=0)) is None


def test_cpu_rehearsal_reads_the_program(monkeypatch):
    """A CPU rehearsal of a traced run whose probe is a ``ProgramProbe``
    (``run_cell`` makes its probe from ``probe.Probe``, stood in for
    here)."""
    import time
    from muxbench import probe as probe_mod
    from muxbench import run
    from repro_torch.serving.metrics import RECORDER
    made = []

    class Kept(program.ProgramProbe):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)
    monkeypatch.setattr(probe_mod, "Probe", Kept)
    out = run.run_cell(limited("pair-chat"), SEED, 2.0, True, device="cpu",
                       t_start=time.perf_counter())
    assert out["correct"], out["checks"]
    (probe,) = made
    rec = probe.program
    read = {n: metrics.read(n, SimpleNamespace(probe=probe))
            for n in PROGRAM_METRICS}
    # no graph replays on the CPU
    assert {n for n, v in read.items() if v is not None} \
        == set(PROGRAM_METRICS) - {"launch_host_us"}
    assert 0 < read["decode_row_fill"] <= 100
    assert 0 < read["chunk_token_fill"] <= 100
    # the window's ticks only, no profiler annotation on the CPU
    assert rec.count("sched.tick") == probe.ticks > 0
    assert not any(rec.annotated) and rec.dropped == 0
    assert not RECORDER.on
