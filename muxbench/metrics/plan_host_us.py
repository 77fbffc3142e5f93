"""Host time a tick in the step's plan, from the program's own spans
(``muxbench.program``): ``plan.batch`` (the scheduler's and the engine's
host arrays: the jobs, block tables, lengths and padding, before the
step function is called) and ``plan.inputs`` (inside the step function:
the write plan and the packed inputs), in us."""
from muxbench.program import spans_per_tick_us


def read(run):
    return spans_per_tick_us(run, "plan.batch", "plan.inputs")
