"""95th percentile, over every request due in the window, of its first
token's time minus its due time (a late generator counts).  A request
with no first token by the window's end counts as the window's end minus
its due time, so a stall moves it."""
from muxbench.metrics import percentile, window_requests


def per_request(run):
    """Each window request's time to first token, in seconds."""
    t1 = run.window.t1
    return [(s.first if s.first >= 0 else t1) - s.due
            for s in window_requests(run)]


def read(run):
    p = percentile(per_request(run), 95)
    return None if p is None else p * 1e3
