"""The mesh-only model paths, run with data on a real world.

Four CPU processes form a ``gloo`` world and its 2×2 ``("data",
"model")`` mesh (``tests/_torch_mesh_worker.py``).  Each case lowers a
pair on its reduced config at a short context, runs the step on
DTensors at the lowering's specs, and holds every compared leaf to the
same step run off the mesh on the same float32 arguments, at 1e-4 of
the leaf's largest magnitude.  Between them the cases drive the MoE
dispatch and combine on a mesh (partial sums over tokens and experts),
the label pick of ``cross_entropy`` by an iota, the attention and the
SSD scan shard by shard (kernel wrappers on local tensors only), the
sequence-parallel SSD and slabbed conv of a prefill and of a training
forward, the decode attention shard by shard with its cache and ring
writes on local shards, the int8 decode attention, and a batch of one
that leaves the data axis idle.
"""
import json
import socket

import pytest
import torch.multiprocessing as mp

from tests import _torch_mesh_worker as worker

CASES = {
    "moe train": ("granite-moe-3b-a800m", "train_4k", 4, "baseline"),
    "hybrid train": ("zamba2-1.2b", "train_4k", 2, "baseline"),
    "dense prefill": ("qwen2-7b", "prefill_32k", 2, "baseline"),
    "ssm prefill": ("mamba2-2.7b", "prefill_32k", 2, "baseline"),
    "dense decode": ("qwen2-7b", "decode_32k", 4, "baseline"),
    "w8kv8 decode": ("qwen2-7b", "decode_32k", 4, "w8kv8"),
    "ssm decode": ("mamba2-2.7b", "decode_32k", 2, "baseline"),
    "hybrid windowed decode": ("zamba2-1.2b", "long_500k", None,
                               "baseline"),
}
TOL = 1e-4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh") / "rows.json"
    mp.start_processes(worker.run, args=(4, _free_port(), CASES, str(out)),
                       nprocs=4, start_method="spawn")
    return json.loads(out.read_text())


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_step_matches_the_off_mesh_step(mesh_run, case):
    rows = mesh_run[case]
    assert rows
    for path, same_shape, err, scale in rows:
        assert same_shape, path
        assert err <= TOL * max(scale, 1e-30), (path, err, scale)
