"""Host time a tick launching the steps' CUDA graphs, from the
program's own spans (``muxbench.program``): ``graph.load`` (the packed
inputs through the pinned buffer, the wait for its previous copy
included), ``graph.replay`` and ``graph.clone`` (the logits' copy), in
us.  None where no graph replays (the CPU)."""
from muxbench.program import spans_per_tick_us


def read(run):
    return spans_per_tick_us(run, "graph.load", "graph.replay", "graph.clone")
