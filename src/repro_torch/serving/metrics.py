"""Dependency-free Prometheus-style metrics for the serving stack (port
of ``repro/serving/metrics.py``; host code, the JAX package's line for
line, so the two packages' snapshots compare with ``==``).

The live front end (``serving/frontend.py``) and the closed-loop driver
(``serving/driver.py``) both need the same observability surface: per-LLM
throughput, latency histograms, queue/pool gauges, and labeled event
counters for sheds, faults, recoveries and reconfigurations.  This module
provides that surface with zero third-party dependencies:

- :class:`Counter`, :class:`Gauge`, :class:`Histogram` — labeled metric
  families with Prometheus text exposition (``render()``) and a JSON-able
  snapshot (``snapshot()``).
- :class:`MetricsRegistry` — ordered collection of families; one registry
  per serving session.
- :class:`ServingMetrics` — the concrete metric taxonomy wired through
  engine/scheduler/driver/reconfig/faults, so call sites share one schema.
- :class:`StructuredLog` — request-ID-correlated event records (bounded
  ring) for tracing a single request across submit/route/stream/finish.
- :class:`MetricsServer` — optional stdlib-only HTTP endpoint serving the
  text exposition at ``/metrics``, the JSON snapshot at ``/metrics.json``,
  and a server-sent-events stream of structured-log records at ``/events``.

Determinism note: metric *values* are derived from the serving clock and
request outcomes, so under the deterministic tick-cost clock two runs of
the same trace produce identical snapshots.  Only the HTTP server (a
daemon thread) touches wall time, and it is opt-in.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "ServingMetrics",
    "StructuredLog",
    "MetricsServer",
    "DEFAULT_LATENCY_BUCKETS",
]

LabelKey = Tuple[str, ...]

# Seconds; spans sub-tick latencies in the deterministic clock up to long
# wall-clock E2E times.  Mirrors the default Prometheus client buckets with
# a couple of fine low-end bins for the virtual clock's small dt values.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 25.0, 60.0, 120.0,
)


def _fmt_value(v: float) -> str:
    """Prometheus-style number formatting: integers without a trailing .0."""
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _label_str(names: Sequence[str], values: LabelKey, extra: str = "") -> str:
    parts = [f'{n}="{v}"' for n, v in zip(names, values)]
    if extra:
        parts.append(extra)
    return ("{" + ",".join(parts) + "}") if parts else ""


class _Family:
    """Base class: a named metric family with a fixed label schema."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()

    def _key(self, labels: Dict[str, str]) -> LabelKey:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got {tuple(labels)}"
            )
        return tuple(str(labels[n]) for n in self.labelnames)

    def header(self) -> List[str]:
        return [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.kind}"]

    def render(self) -> List[str]:  # pragma: no cover - overridden
        raise NotImplementedError

    def snapshot(self) -> Dict[str, object]:  # pragma: no cover - overridden
        raise NotImplementedError


class Counter(_Family):
    """Monotonically increasing labeled counter."""

    kind = "counter"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._values: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up (got {amount})")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def total(self) -> float:
        with self._lock:
            return sum(self._values.values())

    def render(self) -> List[str]:
        out = self.header()
        with self._lock:
            for key in sorted(self._values):
                out.append(
                    f"{self.name}{_label_str(self.labelnames, key)} "
                    f"{_fmt_value(self._values[key])}"
                )
        return out

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            series = [
                {"labels": dict(zip(self.labelnames, k)), "value": v}
                for k, v in sorted(self._values.items())
            ]
        return {"name": self.name, "type": self.kind, "series": series}


class Gauge(_Family):
    """Labeled gauge: set to the latest sampled value."""

    kind = "gauge"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._values: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def render(self) -> List[str]:
        out = self.header()
        with self._lock:
            for key in sorted(self._values):
                out.append(
                    f"{self.name}{_label_str(self.labelnames, key)} "
                    f"{_fmt_value(self._values[key])}"
                )
        return out

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            series = [
                {"labels": dict(zip(self.labelnames, k)), "value": v}
                for k, v in sorted(self._values.items())
            ]
        return {"name": self.name, "type": self.kind, "series": series}


@dataclass
class _HistSeries:
    buckets: List[float]
    sum: float = 0.0
    count: int = 0


class Histogram(_Family):
    """Labeled histogram with cumulative buckets, Prometheus semantics."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
    ):
        super().__init__(name, help, labelnames)
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError(f"{self.name}: need at least one bucket")
        self.buckets = tuple(bs)
        self._series: Dict[LabelKey, _HistSeries] = {}

    def observe(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _HistSeries(buckets=[0.0] * len(self.buckets))
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    s.buckets[i] += 1
            s.sum += float(value)
            s.count += 1

    def count(self, **labels: str) -> int:
        with self._lock:
            s = self._series.get(self._key(labels))
            return s.count if s else 0

    def sum(self, **labels: str) -> float:
        with self._lock:
            s = self._series.get(self._key(labels))
            return s.sum if s else 0.0

    def render(self) -> List[str]:
        out = self.header()
        with self._lock:
            for key in sorted(self._series):
                s = self._series[key]
                for ub, cum in zip(self.buckets, s.buckets):
                    le = _label_str(self.labelnames, key, f'le="{_fmt_value(ub)}"')
                    out.append(f"{self.name}_bucket{le} {_fmt_value(cum)}")
                le_inf = _label_str(self.labelnames, key, 'le="+Inf"')
                out.append(f"{self.name}_bucket{le_inf} {_fmt_value(s.count)}")
                lab = _label_str(self.labelnames, key)
                out.append(f"{self.name}_sum{lab} {_fmt_value(s.sum)}")
                out.append(f"{self.name}_count{lab} {_fmt_value(s.count)}")
        return out

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            series = []
            for key in sorted(self._series):
                s = self._series[key]
                series.append(
                    {
                        "labels": dict(zip(self.labelnames, key)),
                        "buckets": dict(
                            zip((_fmt_value(b) for b in self.buckets), s.buckets)
                        ),
                        "sum": s.sum,
                        "count": s.count,
                    }
                )
        return {
            "name": self.name,
            "type": self.kind,
            "bucket_bounds": list(self.buckets),
            "series": series,
        }


class MetricsRegistry:
    """Ordered collection of metric families with shared exposition."""

    def __init__(self) -> None:
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()

    def register(self, fam: _Family) -> _Family:
        with self._lock:
            if fam.name in self._families:
                raise ValueError(f"duplicate metric family: {fam.name}")
            self._families[fam.name] = fam
        return fam

    def counter(self, name: str, help: str, labelnames: Sequence[str] = ()) -> Counter:
        return self.register(Counter(name, help, labelnames))  # type: ignore[return-value]

    def gauge(self, name: str, help: str, labelnames: Sequence[str] = ()) -> Gauge:
        return self.register(Gauge(name, help, labelnames))  # type: ignore[return-value]

    def histogram(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
    ) -> Histogram:
        return self.register(Histogram(name, help, labelnames, buckets))  # type: ignore[return-value]

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def families(self) -> List[_Family]:
        with self._lock:
            return list(self._families.values())

    def render(self) -> str:
        """Prometheus text exposition (format version 0.0.4)."""
        lines: List[str] = []
        for fam in self.families():
            lines.extend(fam.render())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, object]:
        """JSON-able snapshot of every family."""
        return {"families": [f.snapshot() for f in self.families()]}


@dataclass
class LogRecord:
    """One structured, request-correlated event."""

    ts: float
    event: str
    req_id: str
    fields: Dict[str, object] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, object]:
        d = {"ts": self.ts, "event": self.event, "req_id": self.req_id}
        d.update(self.fields)
        return d


class StructuredLog:
    """Bounded ring of request-ID-correlated structured events.

    Call sites log with ``log.emit(now, "route", req_id, llm="a@0")``;
    readers filter by request with :meth:`for_request` or drain for the
    SSE endpoint with :meth:`tail`.
    """

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._records: Deque[LogRecord] = deque(maxlen=self.capacity)
        self._seq = 0
        self._lock = threading.Lock()

    def emit(self, ts: float, event: str, req_id: str, **fields: object) -> LogRecord:
        rec = LogRecord(ts=float(ts), event=event, req_id=str(req_id), fields=fields)
        with self._lock:
            self._records.append(rec)
            self._seq += 1
        return rec

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    @property
    def seq(self) -> int:
        """Total records ever emitted (monotonic, survives ring eviction)."""
        with self._lock:
            return self._seq

    def tail(self, n: int = 100) -> List[LogRecord]:
        with self._lock:
            return list(self._records)[-n:]

    def for_request(self, req_id: str) -> List[LogRecord]:
        with self._lock:
            return [r for r in self._records if r.req_id == str(req_id)]

    def to_jsonl(self, n: Optional[int] = None) -> str:
        recs = self.tail(n) if n is not None else self.tail(self.capacity)
        return "\n".join(json.dumps(r.to_dict(), sort_keys=True) for r in recs)


class ServingMetrics:
    """The serving stack's concrete metric taxonomy.

    One instance per session; every layer (frontend, router, scheduler,
    driver, reconfig controller, fault injector) records into the same
    registry so a single exposition covers the whole request lifecycle.
    """

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        latency_buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
    ):
        r = registry if registry is not None else MetricsRegistry()
        self.registry = r
        self.log = StructuredLog()

        # Request lifecycle counters (labels: llm = engine/unit name).
        self.requests_submitted = r.counter(
            "mux_requests_submitted_total", "Requests submitted to a unit", ("llm",)
        )
        self.requests_finished = r.counter(
            "mux_requests_finished_total", "Requests finished", ("llm",)
        )
        self.requests_shed = r.counter(
            "mux_requests_shed_total", "Requests shed", ("llm", "reason")
        )
        self.requests_cancelled = r.counter(
            "mux_requests_cancelled_total", "Requests cancelled by the client", ("llm",)
        )
        self.requests_retried = r.counter(
            "mux_requests_retried_total", "Requeues after crash recovery", ("llm",)
        )
        self.tokens_total = r.counter(
            "mux_tokens_total", "Tokens processed per phase", ("llm", "phase")
        )

        # Latency histograms (seconds on the session clock).
        self.ttft_seconds = r.histogram(
            "mux_ttft_seconds", "Time to first token", ("llm",), latency_buckets
        )
        self.tpot_seconds = r.histogram(
            "mux_tpot_seconds", "Time per output token", ("llm",), latency_buckets
        )
        self.e2e_seconds = r.histogram(
            "mux_e2e_seconds", "End-to-end request latency", ("llm",), latency_buckets
        )

        # Live state gauges.
        self.llm_qps = r.gauge(
            "mux_llm_qps", "Arrival rate over the session so far", ("llm",)
        )
        self.queue_depth = r.gauge(
            "mux_queue_depth", "Admission queue depth", ("llm",)
        )
        self.running_seqs = r.gauge(
            "mux_running_seqs", "Sequences resident in engine slots", ("llm",)
        )
        self.pool_used_blocks = r.gauge(
            "mux_pool_used_blocks", "KV blocks charged to the LLM", ("llm",)
        )
        self.pool_available_blocks = r.gauge(
            "mux_pool_available_blocks", "Free blocks in the unified pool", ("unit",)
        )

        # Events (reconfig / faults / degradation).
        self.reconfig_events = r.counter(
            "mux_reconfig_events_total", "Reconfiguration events", ("kind",)
        )
        self.migrated_blocks = r.counter(
            "mux_migrated_blocks_total", "KV blocks moved by migrations"
        )
        self.fault_events = r.counter(
            "mux_fault_events_total", "Injected fault events", ("kind",)
        )
        self.recoveries = r.counter(
            "mux_recoveries_total", "Engine crash recoveries", ("llm",)
        )
        self.watchdog_trips = r.counter(
            "mux_watchdog_trips_total", "Serving-loop watchdog trips"
        )

        # Router decisions (labels: strategy + chosen engine).
        self.router_decisions = r.counter(
            "mux_router_decisions_total", "Routing decisions", ("strategy", "llm")
        )
        self.stream_errors = r.counter(
            "mux_stream_errors_total", "Streams terminated with an error", ("reason",)
        )

    def render(self) -> str:
        return self.registry.render()

    def snapshot(self) -> Dict[str, object]:
        return self.registry.snapshot()


class MetricsServer:
    """Stdlib-only HTTP endpoint for a :class:`ServingMetrics` instance.

    Routes:
      - ``GET /metrics``       Prometheus text exposition
      - ``GET /metrics.json``  JSON snapshot
      - ``GET /events``        last structured-log records as SSE frames

    Runs a ``ThreadingHTTPServer`` on a daemon thread; ``port=0`` binds an
    ephemeral port (read it back from :attr:`port`).  This is the only
    wall-clock-touching component in the module and is opt-in.
    """

    def __init__(self, metrics: ServingMetrics, host: str = "127.0.0.1", port: int = 0):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        metrics_ref = metrics

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a: object) -> None:  # silence stderr
                pass

            def _send(self, code: int, ctype: str, body: bytes) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:  # noqa: N802 (http.server API)
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    self._send(
                        200,
                        "text/plain; version=0.0.4; charset=utf-8",
                        metrics_ref.render().encode(),
                    )
                elif path == "/metrics.json":
                    self._send(
                        200,
                        "application/json",
                        json.dumps(metrics_ref.snapshot(), sort_keys=True).encode(),
                    )
                elif path == "/events":
                    frames = [
                        f"data: {json.dumps(rec.to_dict(), sort_keys=True)}\n\n"
                        for rec in metrics_ref.log.tail(200)
                    ]
                    self._send(
                        200, "text/event-stream", "".join(frames).encode()
                    )
                else:
                    self._send(404, "text/plain", b"not found\n")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-http", daemon=True
        )

    def start(self) -> "MetricsServer":
        self._thread.start()
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        # shutdown() blocks on serve_forever's acknowledgement, which
        # never comes if start() was never called — guard on the thread
        if self._thread.is_alive():
            self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2.0)


def percentile_from_histogram(
    hist: Histogram, q: float, **labels: str
) -> Optional[float]:
    """Estimate a quantile from cumulative buckets (upper-bound estimate).

    Used by dashboards / the benchmark for coarse checks; exact latency
    percentiles still come from the driver's LatencyStats.
    """
    with hist._lock:
        s = hist._series.get(hist._key(labels))
        if s is None or s.count == 0:
            return None
        rank = q * s.count
        for ub, cum in zip(hist.buckets, s.buckets):
            if cum >= rank:
                return ub
        return float("inf")
