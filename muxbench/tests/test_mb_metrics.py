"""Each metric reader's arithmetic on synthetic timelines."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from muxbench import metrics
from muxbench.harness import Served, Window
from muxbench.probe import Step, step_device_s, step_reads


def _window(stall_at=None, stall=0.0, n=40):
    """``n`` requests due every 0.25 s from t=1 in a window [1, 11);
    each gets its first token 50 ms after it is due and then a token
    every 20 ms, 60 tokens; from ``stall_at`` on, every token comes
    ``stall`` seconds later."""
    reqs, tokens = [], 0
    for i in range(n):
        due = 1.0 + 0.25 * i
        times = [due + 0.05 + 0.02 * k for k in range(60)]
        if stall_at is not None:
            times = [t + stall if t >= stall_at else t for t in times]
        times = [t for t in times if t < 11.0]
        tokens += len(times)
        s = Served(i, "m", due, True, [1])
        if times:
            s.first, s.last, s.tokens = times[0], times[-1], len(times)
        reqs.append(s)
    return Window(t0=1.0, t1=11.0, clock0=0.0, requests=reqs,
                  tokens=tokens, ticks=100, lateness=[], captures=0)


def _run(w, probe=None):
    return SimpleNamespace(window=w, setup_s=12.5, probe=probe)


def test_steady_timeline_reads_its_construction():
    run = _run(_window())
    assert metrics.read("ttft_p95_ms", run) == pytest.approx(50.0)
    assert metrics.read("tpot_p90_ms", run) == pytest.approx(20.0)
    assert metrics.read("out_tok_s", run) == pytest.approx(
        run.window.tokens / 10.0)
    assert metrics.read("setup_s", run) == 12.5


def test_planted_stall_moves_both_tails():
    calm = _run(_window())
    stalled = _run(_window(stall_at=5.0, stall=2.0))
    assert metrics.read("ttft_p95_ms", stalled) > \
        metrics.read("ttft_p95_ms", calm) + 100
    assert metrics.read("tpot_p90_ms", stalled) > \
        metrics.read("tpot_p90_ms", calm) + 20
    assert metrics.read("out_tok_s", stalled) < \
        metrics.read("out_tok_s", calm)


def test_request_without_first_token_counts_to_window_end():
    w = _window(n=20)
    for s in w.requests:
        s.first = s.last = -1.0
        s.tokens = 0
    # every request waits from its due time to the window's end
    dues = np.array([s.due for s in w.requests])
    want = np.percentile(11.0 - dues, 95) * 1e3
    assert metrics.read("ttft_p95_ms", _run(w)) == pytest.approx(want)
    assert metrics.read("tpot_p90_ms", _run(w)) is None


def test_requests_due_before_the_window_are_not_attempted():
    w = _window()
    w.requests[0].window = False
    w.requests[0].first = 100.0          # would dominate the tail
    assert metrics.read("ttft_p95_ms", _run(w)) == pytest.approx(50.0)


def _probe(trace=None):
    p = SimpleNamespace(cuda=True, ticks=10, trace=trace,
                        host={"session": 0.05, "tick": 0.04,
                              "steps": 0.01, "argmax": 0.02})
    p.steps = [Step("decode", [], bound_s=0.006,
                    kernel_bound_s={"k1": 0.0004}),
               Step("chunk", [], bound_s=0.020,
                    kernel_bound_s={"k2": 0.001})]
    return p


def test_host_spans_split_by_layer():
    run = _run(_window(), _probe())
    assert metrics.read("session_host_us", run) == pytest.approx(1000.0)
    assert metrics.read("sched_host_us", run) == pytest.approx(1000.0)
    assert metrics.read("step_host_us", run) == pytest.approx(1000.0)
    assert metrics.read("argmax_wait_us", run) == pytest.approx(2000.0)


def test_step_and_kernel_shares():
    trace = dict(window_s=4.0, busy_s=3.0, kernels=10,
                 groups={"k1": 0.002, "k2": 0.004},
                 steps={"decode": dict(bound_s=0.006, device_s=0.012),
                        "chunk": dict(bound_s=0.020, device_s=0.040)})
    run = _run(_window(), _probe(trace))
    assert metrics.read("mfu.decode", run) == pytest.approx(50.0)
    assert metrics.read("mfu.prefill", run) == pytest.approx(50.0)
    assert metrics.read("k1_decode_roofline", run) == pytest.approx(20.0)
    assert metrics.read("k2_chunk_roofline", run) == pytest.approx(25.0)
    assert metrics.read("k4_ssd_roofline", run) is None
    assert metrics.read("idle_share", run) == pytest.approx(25.0)


def test_device_metrics_are_silent_without_a_card():
    probe = _probe()
    probe.cuda = False
    run = _run(_window(), probe)
    for name in ("mfu.decode", "mfu.prefill", "k1_decode_roofline",
                 "idle_share"):
        assert metrics.read(name, run) is None
    assert metrics.read("mfu.decode", _run(_window())) is None


def test_every_named_metric_has_a_reader():
    import json
    from muxbench.harness import ROOT
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(metrics.reader(m["name"]))


def _ev(name, cat, ts, dur, corr=None):
    e = dict(name=name, cat=cat, ph="X", ts=ts, dur=dur, tid=1)
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _steps_trace():
    """A tick: a decode step (its inputs' copy, then a graph replay
    whose launch the host clock puts 2 us past the step's end), the
    argmax read-back, then a chunk step."""
    return [
        _ev("tick", "user_annotation", 90, 400),
        _ev("step.decode", "user_annotation", 100, 50),
        _ev("cudaMemcpyAsync", "cuda_runtime", 130, 2, corr=1),
        _ev("cudaGraphLaunch", "cuda_runtime", 152, 5, corr=2),
        _ev("Memcpy HtoD", "gpu_memcpy", 135, 3, corr=1),
        _ev("gemm", "kernel", 160, 40, corr=2),            # graph replay
        _ev("splitkv_attn", "kernel", 195, 20, corr=2),    # overlaps
        _ev("argmax", "user_annotation", 158, 60),
        _ev("cudaLaunchKernel", "cuda_runtime", 160, 2, corr=3),
        _ev("argmax_kernel", "kernel", 216, 10, corr=3),
        _ev("step.chunk", "user_annotation", 300, 20),
        _ev("cudaGraphLaunch", "cuda_runtime", 310, 5, corr=4),
        _ev("chunk_gemm", "kernel", 315, 100, corr=4),
    ]


def test_step_device_time_is_its_own_launches_union():
    """A step's device time is the union of what it launched, graph
    replays included; the host's plan before the launch and the argmax
    kernel after the step are not in it."""
    got = step_device_s(_steps_trace(), 0, 1000)
    assert [k for k, _, _ in got] == ["decode", "chunk"]
    assert got[0][1] == pytest.approx((3 + 55) / 1e6)
    assert got[0][2] == 2
    assert got[1][1] == pytest.approx(100 / 1e6)
    clipped = step_device_s(_steps_trace(), 0, 365)
    assert clipped[1][1] == pytest.approx(50 / 1e6)
    # a launch long past its step's end, with no read-back begun, is not
    # the step's: the scheduler's work between steps
    late = _steps_trace() + [
        _ev("cudaLaunchKernel", "cuda_runtime", 450, 2, corr=5),
        _ev("pool_copy", "kernel", 452, 30, corr=5)]
    assert step_device_s(late, 0, 1000)[1][1] == pytest.approx(100 / 1e6)


def test_steps_without_kernels_are_left_out_of_both_sums():
    events = _steps_trace()
    events = [e for e in events if e.get("args", {}).get("correlation")
              != 4]                     # the chunk step's replay unseen
    steps = [Step("decode", [], bound_s=0.00002),
             Step("chunk", [], bound_s=0.00005)]
    reads = step_reads(steps, step_device_s(events, 0, 1000))
    assert reads["decode"]["device_s"] == pytest.approx(58 / 1e6)
    assert reads["decode"]["bound_s"] == pytest.approx(0.00002)
    assert reads["chunk"] == dict(bound_s=0.0, device_s=0.0, read=0,
                                  unread=1)
    run = _run(_window(), SimpleNamespace(trace=dict(steps=reads)))
    assert metrics.read("mfu.decode", run) == pytest.approx(100 * 20 / 58)
    assert metrics.read("mfu.prefill", run) is None
    # steps that do not line up with the trace's annotations read nothing
    assert step_reads(steps[:1], step_device_s(events, 0, 1000)) == {}
