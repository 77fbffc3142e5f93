"""The decode steps' real rows over the rows they compute (a fused
sweep's M x rows, a serial step's power-of-two bucket, an SSM step's
exact rows), over the window, in %."""
from muxbench.program import fill_percent


def read(run):
    return fill_percent(run, "rows.decode")
