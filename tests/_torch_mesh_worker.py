"""One rank of the mesh run of ``tests/test_torch_mesh_run.py``.

Every rank of a ``gloo`` world of four CPU processes builds the 2×2
``("data", "model")`` mesh, and for each case lowers the pair on the
reduced config at a short context, materializes its arguments in
float32 from a seeded generator (the same on every rank), distributes
them at the lowering's specs and runs the step on the mesh.  Rank 0
also runs the same step off the mesh on the same arguments and writes,
per leaf, the largest difference and the leaf's largest magnitude.
"""
import contextlib
import dataclasses
import json
from datetime import timedelta
from unittest import mock

import torch
import torch.distributed as dist

# the cases' contexts at the reduced widths: the residual stream's
# sequence shards (a multiple of 16) and two SSD slabs of whole chunks
SEQ = {"train_4k": 64, "prefill_32k": 64, "decode_32k": 64,
       "long_500k": 128}


@contextlib.contextmanager
def _reduced():
    from repro_torch import configs
    from repro_torch.launch import specs
    shapes = {k: dataclasses.replace(v, seq_len=SEQ[k])
              for k, v in specs.SHAPES.items()}
    with mock.patch.object(specs, "SHAPES", shapes), \
            mock.patch.object(configs, "get", configs.get_reduced):
        yield


def _materialize(low, gen):
    """``low``'s arguments on the CPU in float32 (int8 and integer
    leaves at their dtypes): weights from ``init_params`` (quantized for
    the W8/KV8 step), AdamW state from ``init_state``, caches and
    embeddings normal × 0.1, the int8 caches' scales |normal| × 0.1,
    integer leaves uniform, ``lens`` the context."""
    from repro_torch.launch import specs
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.quantize import quantize_params
    from repro_torch.train.optimizer import init_state
    cfg = low.cfg
    params = init_params(cfg, gen, dtype=torch.float32, device="cpu")

    def like(t, positive=False):
        if t.dtype.is_floating_point:
            x = torch.randn(t.shape, generator=gen).mul_(0.1)
            return x.abs_() if positive else x
        if t.dtype == torch.int8:
            return torch.randint(-127, 128, t.shape, generator=gen,
                                 dtype=t.dtype)
        return torch.randint(0, cfg.vocab_size, t.shape, generator=gen,
                             dtype=t.dtype)

    if low.kind == "train":
        return [params, init_state(params)] + [like(t) for t in low.args[2:]]
    seq = specs.SHAPES[low.shape].seq_len
    if low.kind == "prefill":
        toks = like(low.args[1])
        return [params, toks, torch.full(low.args[2].shape, toks.shape[1],
                                         dtype=torch.int32)] + \
            [like(t) for t in low.args[3:]]
    int8 = low.args[1].dtype == torch.int8     # int8 caches, f32 scales
    if int8:
        params = quantize_params(params)
    *caches, last, lens = low.args[1:]
    return [params] + [like(c, positive=int8) for c in caches] + \
        [like(last), torch.full(lens.shape, seq, dtype=torch.int32)]


def _clone(tree):
    from repro_torch.train.pytree import tree_map
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                    else t, tree)


def _full(tree):
    from torch.distributed.tensor import DTensor
    from repro_torch.train.pytree import tree_map
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)


def _compared(low, out, args):
    """The leaves a case holds to the off-mesh run: a train step's loss,
    gradient norm and first moments (linear in the gradients; a
    parameter's first AdamW step is lr·sign(g), which a rounding of a
    near-zero gradient flips); a serve step's outputs and arguments
    (the caches it writes in place)."""
    if low.kind == "train":
        return {"info": out[2], "m": out[1].m}
    return {"out": out, "args": args}


def _case(mesh, arch, shape, batch, variant, rank):
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import specs
    from repro_torch.models.layers import use_mesh
    from repro_torch.train.pytree import flatten_with_path, path_str
    build = specs.build_quantized_decode if variant == "w8kv8" else \
        specs.build_lowering
    low = build(arch, shape, mesh, batch=batch)
    args = _materialize(low, torch.Generator().manual_seed(0))
    plain = _clone(args)
    dargs = _distribute(mesh, args, low.in_specs)
    with use_mesh(mesh), implicit_replication():
        out = low.step_fn(*dargs)
    got = _compared(low, _full(out), _full(dargs))
    if rank:
        return None
    want = _compared(low, low.step_fn(*plain), plain)
    rows = []
    for (p, a), (_, b) in zip(flatten_with_path(got),
                              flatten_with_path(want)):
        if not isinstance(b, torch.Tensor):
            continue
        a, b = a.double(), b.double()
        rows.append([path_str(p), list(a.shape) == list(b.shape),
                     float((a - b).abs().max()) if a.numel() else 0.0,
                     float(b.abs().max()) if b.numel() else 0.0])
    return rows


def _distribute(mesh, args, specs):
    """``args`` as DTensors of ``mesh`` at ``specs`` (each rank keeps
    its shards of the full tensor)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models.layers import placements

    def walk(a, s):
        if a is None:
            return None
        if isinstance(a, torch.Tensor):
            return distribute_tensor(a, mesh, placements(mesh, s))
        if isinstance(a, dict):
            return {k: walk(a[k], s[k]) for k in a}
        kids = [walk(x, y) for x, y in zip(a, s)]
        return type(a)(*kids) if hasattr(a, "_fields") else type(a)(kids)
    return walk(args, specs)


def run(rank, world, port, cases, out_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=300))
    try:
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        res = {}
        with _reduced():
            for name, (arch, shape, batch, variant) in cases.items():
                res[name] = _case(mesh, arch, shape, batch, variant, rank)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()
