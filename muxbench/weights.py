"""Random weights from the run's seed, in the port's tree layout, made
on the device in the type they are served in.

Each leaf is one call on a ``torch.Generator`` of its own, seeded from
(run seed, engine index, ``group.leaf``): the program gets the whole
tree at set-up, and the reference makes the same tree again after the
window, one model at a time.
Layout (the port's, ``repro_torch/models/transformer.py``): per-layer
leaves stacked ``[L, ...]``, matrices ``[d_in, d_out]`` applied as
``x @ w``.  Which leaves a tree has, their shapes, kinds and scales are
its family's (``muxbench/families/<name>.leaves``); this module draws
them.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch

# leaves kept in float32 whatever the serving type (the port's
# ``models/mamba2.FLOAT32_LEAVES``)
FLOAT32_LEAVES = ("a_log", "dt_bias", "d_skip")

# (group, leaf, shape, kind, scale)
Spec = Tuple[str, str, tuple, str, float]


def padded_vocab(v: int, multiple: int = 256) -> int:
    return -(-v // multiple) * multiple


def leaf_seed(seed: int, engine: int, leaf: str) -> int:
    h = hashlib.sha256(f"{seed}:{engine}:{leaf}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def token_leaves(m: dict) -> List[Spec]:
    """The ``tok`` group every family has: the embedding over the padded
    vocabulary, the final norm and, untied, the output matrix."""
    d, V = m["d_model"], padded_vocab(m["vocab_size"])
    tok = [("tok", "embed", (V, d), "normal", 0.02),
           ("tok", "out_norm", (d,), "norm", 0.1)]
    if not m.get("tie_embeddings", False):
        tok.append(("tok", "lm_head", (d, V), "normal", 1 / math.sqrt(d)))
    return tok


def specs(m: dict) -> List[Spec]:
    """``(group, leaf, shape, kind, scale)`` of every leaf of model entry
    ``m`` (a configuration file's ``models`` entry), from its family's
    ``leaves``.  Kinds: ``normal`` N(0, scale), ``norm`` 1 + N(0,
    scale), ``a_log``, ``dt_bias``."""
    from muxbench import families
    return families.of(m).leaves(m)


def _draw(spec: Spec, seed: int, engine: int, dtype, device
          ) -> torch.Tensor:
    """One leaf of engine ``engine``'s tree, the same on every call."""
    group, leaf, shape, kind, scale = spec
    gen = torch.Generator(device=device).manual_seed(
        leaf_seed(seed, engine, f"{group}.{leaf}"))
    if leaf in FLOAT32_LEAVES:
        dtype = torch.float32
    if kind == "a_log":          # A = -exp(a_log), |A| in U(1, 16)
        u = torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=device)
        return torch.log1p(u.mul_(15.0))
    if kind == "dt_bias":        # softplus(dt_bias) in log U(1e-3, 0.1)
        u = torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=device)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                       + math.log(1e-3))
        return dt + torch.log(-torch.expm1(-dt))
    t = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    t.mul_(scale)
    if kind == "norm":
        t.add_(1.0)
    return t


def make_tree(m: dict, seed: int, engine: int, dtype, device
              ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The whole tree of engine ``engine`` (nothing else holds it)."""
    tree: Dict[str, Dict[str, torch.Tensor]] = {}
    for spec in specs(m):
        tree.setdefault(spec[0], {})[spec[1]] = _draw(spec, seed, engine,
                                                      dtype, device)
    return tree
