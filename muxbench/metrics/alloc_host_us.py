"""Host time a tick in the pool's host allocator (``serving/kvcache.py``:
the self time of the ``pool.table``, ``pool.append``, ``pool.free`` and
``pool.quota`` spans), in us."""
from muxbench.metrics import per_tick_us
from muxbench.program import program


def read(run):
    rec = program(run)
    if rec is None or not any(n.startswith("pool.") for n in rec.names):
        return None
    return per_tick_us(run, rec.self_total_ns("pool.") / 1e9)
