"""From the process's start to the first due request of the window:
imports, weights, the unit, every graph captured, and the fill period
that brings the slots to a steady state."""


def read(run):
    return run.setup_s
