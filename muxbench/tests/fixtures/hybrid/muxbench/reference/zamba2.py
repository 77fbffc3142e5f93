"""Plain float32 reference of a Zamba2-style hybrid (arXiv:2411.15242):
Mamba2 blocks (``mamba2.layer``) and, after every ``attn_every`` of
them, the one shared block of attention and SwiGLU MLP (``dense.layer``:
RoPE, no bias) that every use reads; a final RMS norm and the output
matrix (the embedding where it is tied)."""
from __future__ import annotations

from typing import List

import torch

from muxbench.reference import dense, mamba2
from muxbench.reference.common import matrix, rms_norm


def final_hidden(m: dict, tree, toks: List[torch.Tensor], control: bool
                 ) -> List[torch.Tensor]:
    lay = tree["layers"]
    shared = {k: (matrix(v[0], control) if k in dense.MATRICES
                  else v[0].float())
              for k, v in tree["shared_attn"].items()}
    xs = [tree["tok"]["embed"][t].float() for t in toks]
    for li in range(m["n_layers"]):
        w = {k: (matrix(v[li], control) if k in mamba2.MATRICES
                 else v[li].float()) for k, v in lay.items()}
        xs = [mamba2.layer(x, w, m) for x in xs]
        del w
        if (li + 1) % m["attn_every"] == 0:
            xs = [dense.layer(x, shared, m) for x in xs]
    norm = tree["tok"]["out_norm"].float()
    return [rms_norm(x, norm, m["rms_eps"]) for x in xs]


def output_matrix(m: dict, tree, control: bool) -> torch.Tensor:
    if "lm_head" in tree["tok"]:
        return matrix(tree["tok"]["lm_head"], control)
    return matrix(tree["tok"]["embed"].t(), control)
