"""The float32 reference against the port's own forward, at reduced
width on the CPU, from the same weight trees."""
from __future__ import annotations

import copy

import pytest
import torch

from muxbench import harness, weights
from muxbench.reference.common import served_gaps
from muxbench.tests.cells import reduce


def _model(cell: str, key: str) -> dict:
    m = harness.load_cell(cell).config["models"][key]
    return reduce(copy.deepcopy(m))


@pytest.mark.parametrize("cell,key", [("pair-chat", "qwen2-7b"),
                                      ("dense-ssm-chat", "mamba2-2.7b")])
def test_reference_logits_equal_the_ports_forward(cell, key):
    harness.port()
    from repro_torch.models.transformer import forward
    m = _model(cell, key)
    tree = weights.make_tree(m, 1234, 0, torch.float32, "cpu")
    toks = torch.randint(1, m["vocab_size"], (1, 150),
                         generator=torch.Generator().manual_seed(0))
    want, _ = forward(tree, harness.model_config(m, key), toks,
                      remat=False)
    from muxbench.reference.common import exact_float32, family
    exact_float32()
    ref = family(m["reference"])
    h = ref.final_hidden(m, tree, [toks[0]], control=False)[0]
    got = (h @ ref.output_matrix(m, tree, control=False))[:, :m["vocab_size"]]
    scale = want.abs().max().item()
    assert (got - want[0]).abs().max().item() <= 1e-4 * scale


@pytest.mark.parametrize("cell,key", [("pair-chat", "qwen2-7b"),
                                      ("dense-ssm-chat", "mamba2-2.7b")])
def test_gaps_read_zero_on_the_references_own_tokens(cell, key):
    """Tokens that are the reference's argmax read a gap of 0; a token
    that is not reads its distance below the best."""
    from muxbench.reference.common import exact_float32, family
    m = _model(cell, key)
    tree = weights.make_tree(m, 7, 1, torch.float32, "cpu")
    exact_float32()
    ref = family(m["reference"])
    prompt = torch.randint(1, m["vocab_size"], (20,),
                           generator=torch.Generator().manual_seed(1)
                           ).tolist()
    seq = list(prompt)
    for _ in range(12):                       # greedy under the reference
        h = ref.final_hidden(m, tree, [torch.tensor(seq)], False)[0]
        lg = (h[-1] @ ref.output_matrix(m, tree, False))[:m["vocab_size"]]
        seq.append(int(lg.argmax()))
    served = seq[len(prompt):]
    g = served_gaps(m, tree, [(prompt, served)], control=True)
    assert g["program"][0] == pytest.approx(0.0, abs=1e-5)
    bad = list(served)
    bad[5] = (bad[5] + 1) % m["vocab_size"]
    assert served_gaps(m, tree, [(prompt, bad)])["program"][0] > 1e-3
