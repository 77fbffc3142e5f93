"""The chunk steps' real prompt tokens (the true chunk lengths) over the
tokens they compute (rows x ``chunk_tokens``), over the window, in %.
None where the window ran no chunk step."""
from muxbench.program import fill_percent


def read(run):
    return fill_percent(run, "tokens.chunk")
