"""Helpers of the lowering tests: the placeholder world, and the spec
and argument trees of both packages flattened alike (JAX's leaf order:
dict keys sorted, a NamedTuple's fields in order)."""
import math

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, PartitionSpec

from repro_torch.launch.mesh import make_production_mesh


@pytest.fixture(scope="module")
def meshes():
    """Both production meshes of the port, and the reference's abstract
    meshes of the same shapes; the world goes down with the module
    (another test file may run in this worker next)."""
    port = {False: make_production_mesh(),
            True: make_production_mesh(multi_pod=True)}
    ref = {False: AbstractMesh((16, 16), ("data", "model")),
           True: AbstractMesh((2, 16, 16), ("pod", "data", "model"))}
    yield port, ref
    if dist.is_initialized():
        dist.destroy_process_group()


def _walk(tree, is_leaf, path=()):
    if is_leaf(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _walk(tree[k], is_leaf, path + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields
                for x in _walk(getattr(tree, f), is_leaf, path + (f".{f}",))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _walk(v, is_leaf, path + (str(i),))]
    return [(path, tree)]


def port_specs(tree):
    """[(path, spec tuple)] of a port spec tree (leaves ``P``, None)."""
    from repro_torch.launch.sharding import P
    return [("/".join(p), None if s is None else tuple(s))
            for p, s in _walk(tree, lambda x: isinstance(x, P))]


def ref_specs(tree):
    """[(path, spec tuple)] of a reference spec tree."""
    return [("/".join(p), None if s is None else tuple(s))
            for p, s in _walk(tree,
                              lambda x: isinstance(x, PartitionSpec))]


def port_args(tree):
    """[(path, shape, dtype name)] of the port's abstract arguments."""
    return [("/".join(p), tuple(t.shape), str(t.dtype).split(".")[-1])
            for p, t in _walk(tree, lambda x: isinstance(x, torch.Tensor))
            if t is not None]


def ref_args(tree):
    """[(path, shape, dtype name)] of the reference's ShapeDtypeStructs."""
    return [("/".join(p), tuple(t.shape), str(np.dtype(t.dtype)))
            for p, t in _walk(tree, lambda x: isinstance(
                x, jax.ShapeDtypeStruct)) if t is not None]


def ref_local_bytes(args, specs, mesh) -> int:
    """Per-device bytes of the reference's arguments from their shapes
    and specs: each dim split by the product of its axes' sizes (the
    largest shard where it does not divide)."""
    total = 0
    pairs = zip(ref_args(args), ref_specs(specs))
    for (_, shape, dtype), (_, spec) in pairs:
        n = np.dtype(dtype).itemsize
        spec = spec or ()
        for i, d in enumerate(shape):
            entry = spec[i] if i < len(spec) else None
            ways = 1
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    ways *= mesh.shape[a]
            n *= math.ceil(d / ways)
        total += n
    return total
