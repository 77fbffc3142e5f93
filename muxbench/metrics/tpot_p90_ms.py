"""90th percentile, over every request due in the window with two or
more tokens committed in it, of (last token - first token) / (tokens -
1): the time per output token each such user saw."""
from muxbench.metrics import percentile, window_requests


def per_request(run):
    """Each window request's time per output token, in seconds."""
    return [(s.last - s.first) / (s.tokens - 1)
            for s in window_requests(run) if s.tokens >= 2]


def read(run):
    p = percentile(per_request(run), 90)
    return None if p is None else p * 1e3
