"""Random weights from the run's seed, in the port's tree layout, made
on the device in the type they are served in.

Each leaf is one call on a ``torch.Generator`` of its own, seeded from
(run seed, engine index, leaf name): the program gets the whole tree at
set-up, and the reference makes the same tree again after the window,
one model at a time.
Layout (the port's, ``repro_torch/models/transformer.py``): per-layer
leaves stacked ``[L, ...]``, matrices ``[d_in, d_out]`` applied as
``x @ w``; dense ``{"tok": {embed, out_norm, lm_head}, "layers": {wq,
wk, wv, wo, bq, bk, bv, w_gate, w_up, w_down, ln1, ln2}}``; Mamba2
``{"tok": {embed, out_norm}, "layers": {in_proj, conv_w, conv_b, a_log,
dt_bias, d_skip, gnorm, out_proj, ln1}}`` with ``a_log``, ``dt_bias``
and ``d_skip`` in float32.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch

# leaves kept in float32 whatever the serving type (the port's
# ``models/mamba2.FLOAT32_LEAVES``)
FLOAT32_LEAVES = ("a_log", "dt_bias", "d_skip")


def padded_vocab(v: int, multiple: int = 256) -> int:
    return -(-v // multiple) * multiple


def leaf_seed(seed: int, engine: int, leaf: str) -> int:
    h = hashlib.sha256(f"{seed}:{engine}:{leaf}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def _specs(m: dict) -> List[Tuple[str, str, tuple, str, float]]:
    """``(group, leaf, shape, kind, scale)`` of every leaf of model
    entry ``m`` (a configuration file's ``models`` entry).  Kinds:
    ``normal`` N(0, scale), ``norm`` 1 + N(0, scale), ``a_log``,
    ``dt_bias``."""
    L, d, V = m["n_layers"], m["d_model"], padded_vocab(m["vocab_size"])
    tok = [("tok", "embed", (V, d), "normal", 0.02),
           ("tok", "out_norm", (d,), "norm", 0.1)]
    if not m.get("tie_embeddings", False):
        tok.append(("tok", "lm_head", (d, V), "normal", 1 / math.sqrt(d)))
    if m["family"] == "ssm":
        s = m["ssm"]
        di = s["expand"] * d
        H, N, G, K = di // s["head_dim"], s["d_state"], s["n_groups"], \
            s["conv_kernel"]
        conv = di + 2 * G * N
        return tok + [
            ("layers", "in_proj", (L, d, 2 * di + 2 * G * N + H), "normal",
             1 / math.sqrt(d)),
            ("layers", "conv_w", (L, K, conv), "normal", 0.2),
            ("layers", "conv_b", (L, conv), "normal", 0.1),
            ("layers", "a_log", (L, H), "a_log", 0.0),
            ("layers", "dt_bias", (L, H), "dt_bias", 0.0),
            ("layers", "d_skip", (L, H), "norm", 0.1),
            ("layers", "gnorm", (L, di), "norm", 0.1),
            ("layers", "out_proj", (L, di, d), "normal", 1 / math.sqrt(di)),
            ("layers", "ln1", (L, d), "norm", 0.1)]
    H, KV, hd, f = m["n_heads"], m["n_kv_heads"], m["head_dim"], m["d_ff"]
    leaves = [("layers", "wq", (L, d, H * hd), "normal", 1 / math.sqrt(d)),
              ("layers", "wk", (L, d, KV * hd), "normal", 1 / math.sqrt(d)),
              ("layers", "wv", (L, d, KV * hd), "normal", 1 / math.sqrt(d)),
              ("layers", "wo", (L, H * hd, d), "normal",
               1 / math.sqrt(H * hd))]
    if m.get("qkv_bias", False):
        leaves += [("layers", "bq", (L, H * hd), "normal", 0.1),
                   ("layers", "bk", (L, KV * hd), "normal", 0.1),
                   ("layers", "bv", (L, KV * hd), "normal", 0.1)]
    leaves += [("layers", "w_gate", (L, d, f), "normal", 1 / math.sqrt(d)),
               ("layers", "w_up", (L, d, f), "normal", 1 / math.sqrt(d)),
               ("layers", "w_down", (L, f, d), "normal", 1 / math.sqrt(f)),
               ("layers", "ln1", (L, d), "norm", 0.1),
               ("layers", "ln2", (L, d), "norm", 0.1)]
    return tok + leaves


def make_leaf(m: dict, seed: int, engine: int, name: str, dtype,
              device) -> torch.Tensor:
    """One leaf of engine ``engine``'s tree, the same on every call."""
    for group, leaf, shape, kind, scale in _specs(m):
        if leaf == name:
            break
    else:
        raise KeyError(f"no leaf {name!r} in a {m['family']} tree")
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


def leaf_names(m: dict) -> List[Tuple[str, str]]:
    return [(group, leaf) for group, leaf, *_ in _specs(m)]


def make_tree(m: dict, seed: int, engine: int, dtype, device
              ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The whole tree of engine ``engine`` (nothing else holds it)."""
    tree: Dict[str, Dict[str, torch.Tensor]] = {}
    for group, leaf in leaf_names(m):
        tree.setdefault(group, {})[leaf] = make_leaf(
            m, seed, engine, leaf, dtype, device)
    return tree

