"""Live serving front end: async ingestion + per-request token streams
(port of ``repro/serving/frontend.py``; host code over the port's
session, stdlib asyncio).

``ServingFrontend`` wraps a :class:`~repro_torch.serving.driver.ServeSession`
in an asyncio loop.  Clients hold a :class:`TokenStream` per request and
consume tokens as the engines commit them; the frontend drives the SAME
session stepper as the closed-loop driver (``serve_requests``), so under
the deterministic clock the streamed token sequences are bit-identical
to the driver's ``Request.output`` timelines *by construction* — there
is one scheduling loop, not a reimplementation.

Token events originate at the engines' COMMIT points (the emit hook
installed via ``MuxScheduler.set_emit``): a token is pushed only after
its KV reservation validated, so a rolled-back overcommit never reaches
a stream.  Preemption/eviction pushes a ``reset`` event — previously
streamed tokens for that request are void and ``collect`` drops them,
mirroring the engine clearing the request's progress.  Backpressure is
surfaced, not hidden: a request shed by a bounded admission queue (or
deadline/watchdog policy) terminates its stream with :class:`StreamShed`
carrying the shed reason, and client cancellation terminates it with
:class:`StreamCancelled` after the session frees the request's slot and
KV blocks.  The streams run on the host between ticks: a token reaches
a stream as the host int the engine committed, with no device read of
its own.

Cross-LLM routing (serving/router.py) plugs in as the session's
``route_fn``: family-named requests resolve to an engine at SUBMIT time,
so load-aware strategies see live queue/pool state.

Everything here is stdlib asyncio — no server framework.  The metrics
HTTP endpoint lives in serving/metrics.py.
"""

from __future__ import annotations

import asyncio
from typing import Dict, List, Optional, Sequence, Union

from repro_torch.serving.driver import ServeSession
from repro_torch.serving.engine import Request
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.mux import MuxScheduler
from repro_torch.serving.router import Router, RoutingStrategy

__all__ = [
    "StreamError",
    "StreamShed",
    "StreamCancelled",
    "TokenStream",
    "ServingFrontend",
    "serve_and_collect",
]


class StreamError(RuntimeError):
    """A token stream terminated without finishing."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class StreamShed(StreamError):
    """The request was shed (backpressure / deadline / watchdog) — the
    bounded-queue drop surfaces to the client instead of hanging."""


class StreamCancelled(StreamError):
    """The client cancelled the request; resources were freed."""


# terminal stream events and the exception each raises from ``collect``
_TERMINAL = {"shed": StreamShed, "cancelled": StreamCancelled,
             "error": StreamError}


class TokenStream:
    """Per-request async stream of committed tokens.

    ``events()`` iterates raw ``(kind, payload)`` pairs — kinds are
    ``token`` (payload = token id), ``reset`` (drop accumulated tokens),
    and the terminals ``finish`` / ``shed`` (payload = reason) /
    ``cancelled``.  ``collect()`` folds that protocol for the common
    client: accumulate tokens, restart on reset, return the final token
    list on finish, raise :class:`StreamShed` / :class:`StreamCancelled`
    on the error terminals.  Async-iterating the stream yields tokens
    and raises the same errors (resets clear nothing visible mid-flight,
    so iteration is only lossless for requests that are never evicted —
    use ``collect`` when preemption is possible).
    """

    def __init__(self, req: Request):
        self.req = req
        self._q: asyncio.Queue = asyncio.Queue()
        self._closed = False

    def _push(self, kind: str, payload) -> None:
        if self._closed:
            return          # late duplicate terminal (e.g. cancel race)
        if kind in _TERMINAL or kind == "finish":
            self._closed = True
        self._q.put_nowait((kind, payload))

    async def events(self):
        """Yield raw ``(kind, payload)`` events through the terminal."""
        while True:
            kind, payload = await self._q.get()
            yield kind, payload
            if kind == "finish" or kind in _TERMINAL:
                return

    async def collect(self) -> List[int]:
        """Consume the stream to its terminal; return the token list."""
        toks: List[int] = []
        async for kind, payload in self.events():
            if kind == "token":
                toks.append(payload)
            elif kind == "reset":
                toks.clear()
            elif kind == "finish":
                return toks
            else:
                raise _TERMINAL[kind](str(payload))
        raise StreamError("stream closed without terminal event")

    def __aiter__(self):
        return self._tokens()

    async def _tokens(self):
        async for kind, payload in self.events():
            if kind == "token":
                yield payload
            elif kind in _TERMINAL:
                raise _TERMINAL[kind](str(payload))


class ServingFrontend:
    """Async serving loop over a ``ServeSession`` with token streaming.

    ``strategy`` (a :class:`~repro_torch.serving.router.RoutingStrategy` or a
    name from ``ROUTER_STRATEGIES``) arms cross-LLM routing: requests
    may then name a model *family* and the router picks the replica at
    submit time.  Without it, requests must name exact engines — the
    closed-loop driver's convention.

    The frontend owns the emit hook on every unit: engine/scheduler
    commit points fan out to the registered per-request streams.
    Requests without a registered stream serve normally (streaming is
    opt-in per request).  All session keyword arguments pass through,
    so open-loop streamed serving supports the full feature surface —
    deterministic or wall clock, faults, shedding, metrics, sanitizer.
    """

    def __init__(self, units: Sequence[MuxScheduler],
                 requests: List[Request],
                 strategy: Optional[Union[str, RoutingStrategy]] = None,
                 metrics: Optional[ServingMetrics] = None,
                 planned_rates: Optional[Dict[str, float]] = None,
                 **session_kwargs):
        self.metrics = metrics
        self.router: Optional[Router] = None
        route_fn = None
        on_topology_change = None
        if strategy is not None:
            if isinstance(strategy, str):
                from repro_torch.serving.router import make_strategy
                strategy = make_strategy(strategy, planned_rates)
            self.router = Router(units, strategy=strategy, metrics=metrics)
            route_fn = lambda r: self.router.resolve(r.model)
            on_topology_change = self.router.refresh
        self.session = ServeSession(
            units, requests, metrics=metrics, route_fn=route_fn,
            planned_rates=planned_rates,
            on_topology_change=on_topology_change, **session_kwargs)
        self._streams: Dict[int, TokenStream] = {}
        for u in units:
            u.set_emit(self._on_emit)

    # -- streaming ------------------------------------------------------
    def stream(self, req: Request) -> TokenStream:
        """Register (or fetch) the token stream for ``req``."""
        s = self._streams.get(id(req))
        if s is None:
            s = self._streams[id(req)] = TokenStream(req)
        return s

    def _on_emit(self, kind: str, req: Request, tok: int) -> None:
        s = self._streams.get(id(req))
        if kind == "shed" and self.metrics is not None:
            self.metrics.stream_errors.inc(
                reason=req.shed_reason or "shed")
        if s is None:
            return
        if kind == "token":
            s._push("token", tok)
        elif kind == "shed":
            s._push("shed", req.shed_reason or "shed")
        else:                       # finish / reset / cancelled
            s._push(kind, None)

    def cancel(self, req: Request) -> bool:
        """Client abandonment: free the request's resources now and
        terminate its stream.  Safe between ``step`` calls (i.e. from
        any task on the serving loop's thread)."""
        ok = self.session.cancel(req)
        if ok:
            s = self._streams.get(id(req))
            if s is not None:
                # pre-submit cancels never reach a unit, so no emit
                # fired; _push drops the duplicate otherwise
                s._push("cancelled", None)
        return ok

    # -- the serving loop ----------------------------------------------
    async def serve(self):
        """Drive the session to completion, yielding to stream
        consumers after every tick.  Returns the ``ServeReport``."""
        session = self.session
        while True:
            status, wait = session.step()
            if status == "done":
                break
            if status == "idle" and not session.deterministic:
                # nap until the next arrival (≤ 5 ms so ad-hoc
                # cancellations stay responsive), like the driver
                await asyncio.sleep(min(wait, 0.005))
            else:
                # cooperative yield: consumers drain the tokens this
                # tick committed before the next tick runs
                await asyncio.sleep(0)
        # terminate any stream whose request never reached a unit
        # (e.g. cancelled before arrival): collectors must not hang
        for s in self._streams.values():
            if not s._closed:
                r = s.req
                if r.cancelled:
                    s._push("cancelled", None)
                elif r.shed:
                    s._push("shed", r.shed_reason or "shed")
                elif r.finish >= 0:
                    s._push("finish", None)
                else:
                    # still pending at loop exit (max_ticks): close the
                    # stream with an explicit error, never hang clients
                    s._push("error", "serving loop ended before "
                                     "request completed")
        return session.report()

    def report(self):
        return self.session.report()


def serve_and_collect(frontend: ServingFrontend,
                      requests: Optional[List[Request]] = None):
    """Synchronous convenience: stream every request, run the loop,
    return ``(report, outputs)`` where ``outputs[req_id]`` is the
    collected token list or the terminal :class:`StreamError`.

    This is the bit-reproducibility harness: under the deterministic
    clock the collected streams equal the closed-loop driver's
    ``Request.output`` exactly — and it is also how a trace is replayed
    through the router.
    """
    reqs = requests if requests is not None else frontend.session.requests

    async def _main():
        streams = [frontend.stream(r) for r in reqs]
        serve_task = asyncio.ensure_future(frontend.serve())
        outs = await asyncio.gather(*(s.collect() for s in streams),
                                    return_exceptions=True)
        report = await serve_task
        for o in outs:
            if isinstance(o, Exception) and not isinstance(o, StreamError):
                raise o
        return report, {r.req_id: o for r, o in zip(reqs, outs)}

    return asyncio.run(_main())
