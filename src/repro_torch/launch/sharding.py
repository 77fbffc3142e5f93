"""Partition-spec rules for every architecture family (port of
``repro/launch/sharding.py``).

Weight layout:
  * tensor-parallel dims (heads, d_ff, experts, vocab) on ``model``;
  * the d_model dim of matrices additionally on ``data`` (FSDP-style:
    weights are gathered per layer; for a 104B model this is what makes
    16 GiB a device feasible);
  * replicated across ``pod`` (data parallelism over the pods).

Attention-head geometry is padded first (``physical_config``) so the
head dims divide the ``model`` axis exactly: kv heads are replicated
``tp/gcd(kv,tp)``× and q heads padded to a multiple.

Optimizer state (AdamW m/v) shards exactly like its parameter.

A spec is a ``P``: a tuple of entries, each an axis name, a tuple of
names (one tensor dim over several mesh dims, major first) or None, as
``jax.sharding.PartitionSpec`` — the port's specs compare with the
reference's entry by entry.  ``named`` is where a spec tree becomes
DTensor placements on a mesh (``models/layers.placements``), and
``distribute`` where abstract arguments become DTensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.config import ModelConfig, tp_geometry
from repro_torch.launch.mesh import mesh_shape
from repro_torch.models.layers import placements
from repro_torch.train.pytree import flatten_with_path, path_str, unflatten

Pytree = Any


class P(tuple):
    """A partition spec: ``P("model", None)``, ``P(("pod", "data"))``,
    ``P()`` (a scalar, replicated).  A one-axis tuple entry is that axis
    (``P(("data",)) == P("data")``), as ``PartitionSpec`` has it."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, tuple):
                return e[0] if len(e) == 1 else (e or None)
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def physical_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """Pad head counts so attention shards exactly ``tp`` ways."""
    if cfg.family == "ssm" or cfg.n_heads == 0:
        return cfg
    hd = cfg.hd
    g = tp_geometry(cfg.n_heads, cfg.n_kv_heads, tp)
    if g.h_padded == cfg.n_heads and g.kv_padded == cfg.n_kv_heads:
        return cfg
    return dataclasses.replace(cfg, n_heads=g.h_padded,
                               n_kv_heads=g.kv_padded, head_dim=hd)


# ---------------------------------------------------------------------------
# per-leaf rules
# ---------------------------------------------------------------------------
def _leaf_spec(path: str, leaf, *, fsdp: bool) -> P:
    """Partition spec for one param leaf, keyed by name + rank."""
    d = "data" if fsdp else None
    name = path.split("/")[-1]
    nd = leaf.ndim

    # quantized serving tree (serving/quantize.py): int8 weights keep
    # the base weight's spec; scales have singleton middle dims
    if name.endswith("_q"):
        name = name[:-2]
        if name == "embed":
            return P("model", d)
        if name == "lm_head":
            return P(d, "model")
    elif name.endswith("_s"):
        base = _leaf_spec(path[:-2], leaf, fsdp=fsdp)
        return P(*[a if leaf.shape[i] > 1 else None
                   for i, a in enumerate(base)])

    if name == "embed":                       # [V, d]
        return P("model", d)
    if name == "lm_head":                     # [d, V]
        return P(d, "model")
    if name in ("out_norm",):
        return P(None)

    if name in ("wq", "wk", "wv"):            # [L, d, heads*hd]
        return P(None, d, "model")
    if name == "wo":                          # [L, heads*hd, d]
        return P(None, "model", d)
    if name in ("bq", "bk", "bv"):            # [L, heads*hd]
        return P(None, "model")
    if name in ("q_norm", "k_norm"):          # [L, hd]
        return P(None, None)

    if name in ("w_gate", "w_up"):
        if nd == 4:                           # MoE [L, E, d, fe]
            return P(None, "model", d, None)
        return P(None, d, "model")            # dense [L, d, f]
    if name == "w_down":
        if nd == 4:                           # MoE [L, E, fe, d]
            return P(None, "model", None, d)
        return P(None, "model", d)            # dense [L, f, d]
    if name == "router":                      # [L, d, E]
        return P(None, d, None)

    # Mamba2: the scan runs head-parallel on the model axis; out_proj
    # rows follow the head-sharded d_inner, in_proj's output dim stays
    # unsharded (mixed z/x/B/C/dt segments)
    if name == "in_proj":                     # [L, d, d_in_proj]
        return P(None, d, None)
    if name == "out_proj":                    # [L, di, d]
        return P(None, "model", d)
    if name in ("conv_w", "conv_b", "a_log", "dt_bias", "d_skip", "gnorm"):
        return P(*([None] * nd))

    if name in ("ln1", "ln2"):                # [L, d]
        return P(None, None)
    # fallback: replicate
    return P(*([None] * nd))


def param_specs(params_shape: Pytree, *, fsdp: bool = True,
                attn_tp: bool = True) -> Pytree:
    """Partition-spec tree matching a params (shape) tree; leaf paths
    are ``train/pytree``'s, as the reference's ``_path_str`` writes
    them.  ``attn_tp=False`` drops the model axis from attention
    weights (data-parallel attention for MoE-EP layouts)."""
    attn_names = {"wq", "wk", "wv", "wo", "bq", "bk", "bv"}
    specs = []
    for path, leaf in flatten_with_path(params_shape):
        ps = path_str(path)
        spec = _leaf_spec(ps, leaf, fsdp=fsdp)
        name = ps.split("/")[-1]
        if name.endswith(("_q", "_s")):
            name = name[:-2]
        if not attn_tp and name in attn_names:
            spec = P(*[a if a != "model" else None for a in spec])
        specs.append(spec)
    return unflatten(params_shape, specs)


def opt_state_specs(pspecs: Pytree, opt_state_shape=None) -> Any:
    """AdamWState specs: step replicated, m/v like params."""
    from repro_torch.train.optimizer import AdamWState
    return AdamWState(step=P(), m=pspecs, v=pspecs)


def _map_specs(fn, spec_tree):
    """``fn`` over the ``P`` leaves of a spec tree (dicts, lists,
    tuples and NamedTuples of specs; None stays None)."""
    if spec_tree is None or isinstance(spec_tree, P):
        return None if spec_tree is None else fn(spec_tree)
    if isinstance(spec_tree, dict):
        return {k: _map_specs(fn, v) for k, v in spec_tree.items()}
    kids = [_map_specs(fn, v) for v in spec_tree]
    if hasattr(spec_tree, "_fields"):
        return type(spec_tree)(*kids)
    return type(spec_tree)(kids)


def named(mesh, spec_tree: Pytree) -> Pytree:
    """The tree of DTensor placements of a spec tree on ``mesh``."""
    return _map_specs(lambda s: placements(mesh, s), spec_tree)


def local_shape(shape, mesh, places) -> tuple:
    """The local shape of a tensor of global ``shape`` at mesh
    coordinate 0 under ``places`` (``torch.chunk``'s split, the largest
    shard when a dim does not divide)."""
    out = list(shape)
    sizes = [mesh.size(i) for i in range(mesh.ndim)]
    for n, pl in zip(sizes, places):
        if pl.is_shard():
            out[pl.dim] = -(-out[pl.dim] // n)
    return tuple(out)


def distribute(mesh, args: Pytree, spec_tree: Pytree) -> Pytree:
    """Abstract arguments (``meta`` tensors of global shape) as DTensors
    on ``mesh`` whose local tensors lie on ``meta`` at the specs'
    placements.  The spec tree has the arguments' structure (a ``P``
    per tensor; None for an argument that is None)."""
    from torch.distributed.tensor import DTensor

    def one(t, spec):
        if t is None:
            return None
        pl = placements(mesh, spec)
        local = torch.empty(local_shape(t.shape, mesh, pl), dtype=t.dtype,
                            device="meta")
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())

    def walk(a, s):
        if isinstance(a, torch.Tensor) or a is None:
            return one(a, s)
        if isinstance(a, dict):
            return {k: walk(a[k], s[k]) for k in a}
        kids = [walk(x, y) for x, y in zip(a, s)]
        if hasattr(a, "_fields"):
            return type(a)(*kids)
        return type(a)(kids)
    return walk(args, spec_tree)


# ---------------------------------------------------------------------------
# activation / cache specs
# ---------------------------------------------------------------------------
def batch_spec(mesh, batch: int) -> P:
    """Shard the batch dim over (pod, data) when divisible (long_500k's
    batch=1 stays replicated: the data axis is idle)."""
    shape = mesh_shape(mesh)
    axes = [a for a in ("pod", "data") if a in shape]
    ways = 1
    for a in axes:
        ways *= shape[a]
    if axes and batch % ways == 0:
        return P(tuple(axes))
    return P(None)


def token_specs(mesh, batch: int):
    return P(*batch_spec(mesh, batch)), None


def kv_cache_spec(mesh, batch: int) -> P:
    """[L, B, S, KV, hd]: batch over (pod,data), kv heads over model."""
    b = batch_spec(mesh, batch)
    return P(None, b[0] if len(b) else None, None, "model", None)


def ssm_state_spec(mesh, batch: int) -> P:
    """[L, B, H, P, N]: batch over (pod,data), heads over model."""
    b = batch_spec(mesh, batch)
    return P(None, b[0] if len(b) else None, "model", None, None)


def conv_tail_spec(mesh, batch: int) -> P:
    """[L, B, K-1, conv_dim]: batch over (pod,data)."""
    b = batch_spec(mesh, batch)
    return P(None, b[0] if len(b) else None, None, None)
