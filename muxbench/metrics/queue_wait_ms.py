"""The mean time a request admitted in the window waited in its queue,
from ``MuxScheduler.submit`` to leaving the queue for an engine's slot
(the program's ``request.queue`` spans), in ms."""
from muxbench.program import program


def read(run):
    rec = program(run)
    waits = rec.durations_ns("request.queue") if rec is not None else []
    if not waits:
        return None
    return sum(waits) / len(waits) / 1e6
