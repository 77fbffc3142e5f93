"""Production and host meshes (port of ``repro/launch/mesh.py``).

The reference lowers on 256 or 512 placeholder CPU devices standing in
for TPU v5e pods.  Here the placeholders are ranks of one world on
PyTorch's ``fake`` process-group backend, all in this one process: a
``DeviceMesh`` over them carries ``DTensor``s whose local tensors lie on
``meta`` (shapes, no data), which is what the dry-run
(``launch/dryrun.py``) runs.  One world of 512 ranks serves every mesh:
the 16×16 mesh takes ranks 0–255, the 2×16×16 mesh all 512, the 1×1
host mesh rank 0.  The world comes up on the first call that needs a
mesh, never at import; ``torch.distributed.destroy_process_group()``
takes it down.

The production meshes name ``"cuda"`` as their device type, the
platform they stand for: DTensor then redistributes with the GPU's
collectives (an all-to-all for a shard-dim change, where a CPU mesh
falls back to an all-gather).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.config import MeshConfig

WORLD = 512          # ranks of the placeholder world (two 16×16 pods)


def _world() -> None:
    """Bring up the placeholder world unless one is up already."""
    if dist.is_initialized():
        if dist.get_world_size() < WORLD:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks is up; "
                f"the meshes need the placeholder world of {WORLD}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=WORLD)


def _mesh(device_type: str, shape: Tuple[int, ...], axes: Tuple[str, ...]):
    from torch.distributed.device_mesh import DeviceMesh
    _world()
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) ``("data", "model")`` mesh, or with ``multi_pod`` the
    (2, 16, 16) ``("pod", "data", "model")`` one, of placeholder ranks
    (the geometry of ``config.MeshConfig``)."""
    m = MeshConfig(multi_pod)
    return _mesh("cuda", m.shape, m.axes)


def make_host_mesh(device="cuda"):
    """The trivial 1×1 ``("data", "model")`` mesh on the caller's device
    (``"cuda"`` by default; raises where there is no GPU, as every entry
    point of the port)."""
    return _mesh(resolve_device(device).type, (1, 1), ("data", "model"))


def mesh_shape(mesh) -> dict:
    """``{axis: size}``, as ``jax``'s ``mesh.shape``."""
    return {a: mesh.size(i) for i, a in enumerate(mesh.mesh_dim_names)}


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes the global batch is sharded over."""
    names = mesh.mesh_dim_names
    return tuple(a for a in ("pod", "data") if a in names)


def dp_ways(mesh) -> int:
    n = 1
    shape = mesh_shape(mesh)
    for a in batch_axes(mesh):
        n *= shape[a]
    return n


def tp_ways(mesh) -> int:
    return mesh_shape(mesh).get("model", 1)
