"""Per-device FLOP / byte / collective / memory counts of a step run on
DTensors: the port's counterpart of ``repro/launch/hlo_analysis.py``.

The reference re-derives its counts from the optimized HLO text.
PyTorch has no HLO: the step runs eagerly on ``DTensor``s whose local
tensors lie on ``meta`` (``launch/dryrun.py``), and a dispatch mode
reads every op as it runs.  A DTensor op is seen once at its global
shapes (its placements and its outputs' local shapes known), and the
local ops it runs and the collectives its redistribution issues are
seen on the local tensors.
Per device:

  * FLOPs: ``torch.utils.flop_counter``'s formulas on the local ops a
    DTensor op runs, at their local shapes (the placeholder device at
    coordinate 0, which holds the largest shard when a dim does not
    divide): a sharded op counts its share, replicated work counts
    whole on every device, as in post-SPMD HLO, and so does an op on a
    ``Partial`` operand (each device computes on a whole-shape addend).
    Only the formulas' ops (the matmul family) count, as the reference
    counts dots.
  * bytes: the local operand and result bytes of each op (views move
    nothing), as the reference counts top-level instructions;
  * collectives: each functional collective, by kind, with the
    reference's ring formulas (per-device result bytes R, group size n:
    all-gather (n−1)/n·R, all-reduce 2(n−1)/n·R, reduce-scatter (n−1)·R,
    all-to-all (n−1)/n·R, permute R);
  * peak live bytes: each local storage counted once, from the op that
    creates it to the drop of its last tensor.  Buffers a DTensor op
    allocates and frees inside itself are not seen, except collectives'
    results.

Trip counts have no counterpart (the step is a Python loop that runs
every layer); ``launch/dryrun.py`` extrapolates from two depths instead.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.train.pytree import flatten_with_path, path_str

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_KIND = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
    "_c10d_functional.broadcast": "collective-permute",
}

WHALE_BYTES = 2 ** 27       # the reference's threshold for --whales


def ring_traffic(kind: str, r: int, n: int) -> int:
    """Per-device bytes a ring moves for a collective of per-device
    result bytes ``r`` over ``n`` devices."""
    if kind == "all-gather" or kind == "all-to-all":
        return r * (n - 1) // n
    if kind == "all-reduce":
        return 2 * r * (n - 1) // n
    if kind == "reduce-scatter":
        return r * (n - 1)
    return r


@dataclass
class Costs:
    flops: int = 0
    bytes: int = 0
    coll_bytes: int = 0
    coll_by_kind: Dict[str, int] = field(default_factory=dict)
    coll_counts: Dict[str, int] = field(default_factory=dict)

    def add(self, other: "Costs", mult: int = 1):
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        self.coll_bytes += other.coll_bytes * mult
        for k, v in other.coll_by_kind.items():
            self.coll_by_kind[k] = self.coll_by_kind.get(k, 0) + v * mult
        for k, v in other.coll_counts.items():
            self.coll_counts[k] = self.coll_counts.get(k, 0) + v * mult


@dataclass
class Analysis:
    """What ``analyze`` read from one run of a step.  Shapes of
    ``outputs`` are global; every byte count is per device."""
    costs: Costs
    argument_bytes: int
    output_bytes: int
    alias_bytes: int          # output bytes that alias an argument
    peak_bytes: int
    outputs: List[Tuple[str, Tuple[int, ...], str]]   # JAX-order paths
    whales: Dict[str, List[int]] = field(default_factory=dict)
    ops: Dict[str, List[int]] = field(default_factory=dict)

    @property
    def temp_bytes(self) -> int:
        """Peak bytes beyond the arguments and the fresh outputs."""
        return max(0, self.peak_bytes - self.argument_bytes
                   - (self.output_bytes - self.alias_bytes))


def _local(t):
    return getattr(t, "_local_tensor", t)


def _nbytes(t) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


class _Live:
    """Live local storages, each counted once while any tensor of it
    lives."""

    def __init__(self):
        self.count: Dict[int, int] = {}
        self.size: Dict[int, int] = {}
        self.seen: Dict[int, int] = {}
        self.live = 0
        self.peak = 0
        self.whales: Dict[str, List[int]] = {}

    def add(self, t) -> int:
        """Track local tensor ``t``; returns its storage's key."""
        tid = id(t)
        if tid in self.seen:
            return self.seen[tid]
        st = t.untyped_storage()
        key = st._cdata
        self.seen[tid] = key
        if key in self.count:
            self.count[key] += 1
        else:
            self.count[key] = 1
            nb = st.nbytes()
            self.size[key] = nb
            self.live += nb
            self.peak = max(self.peak, self.live)
            if nb >= WHALE_BYTES:
                w = self.whales.setdefault(
                    f"{str(t.dtype).split('.')[-1]}{list(t.shape)}", [nb, 0])
                w[1] += 1
        weakref.finalize(t, self._drop, tid, key).atexit = False
        return key

    def _drop(self, tid: int, key: int) -> None:
        self.seen.pop(tid, None)
        self.count[key] -= 1
        if not self.count[key]:
            del self.count[key]
            self.live -= self.size.pop(key)


def _flops(func, args, kwargs, out) -> int:
    """``flop_counter``'s formula for ``func`` at its arguments' shapes
    (0 for an op it has no formula for)."""
    from torch.utils.flop_counter import flop_registry
    formula = flop_registry.get(func._overloadpacket)
    if formula is None:
        return 0
    return int(formula(*args, **kwargs, out_val=out))


class _Counter(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self, mesh, keep_ops: bool):
        super().__init__()
        self.groups = {mesh.get_group(i).group_name: mesh.size(i)
                       for i in range(mesh.ndim)}
        self.keep_ops = keep_ops
        self.costs = Costs()
        self.live = _Live()
        self.ops: Dict[str, List[int]] = {}
        self._inside = False
        self._local_flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            if self._inside:
                return NotImplemented      # let DTensor run it
            self._inside, self._local_flops = True, 0
            try:
                with self:                 # see its local ops, collectives
                    out = func(*args, **kwargs)
            finally:
                self._inside = False
            self._account(func, args, kwargs, out, self._local_flops)
            return out
        out = func(*args, **kwargs)
        kind = _KIND.get(str(func._overloadpacket))
        if kind is not None:
            out = self._collective(kind, args, out)
        elif self._inside:
            # a DTensor op's local compute; its sharding propagation's
            # run at the global shapes (fake tensors, cached per op
            # signature) computes nothing on a device
            if not any(issubclass(t, FakeTensor) for t in types):
                self._local_flops += _flops(func, args, kwargs, out)
        else:                               # a plain tensor's own op
            self._account(func, args, kwargs, out,
                          _flops(func, args, kwargs, out))
        return out

    def _account(self, func, args, kwargs, out, flops: int):
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        nbytes = 0
        if not func.is_view:
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            nbytes = sum(_nbytes(t) for t in ins + outs)
        self.costs.flops += flops
        self.costs.bytes += nbytes
        for t in outs:
            self.live.add(_local(t))
        if self.keep_ops:
            key = (f"{func} -> "
                   f"{[list(_local(t).shape) for t in outs]}")
            row = self.ops.setdefault(key, [0, 0, 0])
            row[0] += 1
            row[1] += flops
            row[2] += nbytes

    def _collective(self, kind: str, args, out):
        # a collective's meta kernel may return a view of a group-sized
        # buffer (the all-to-all's concatenation): its result is its own
        # bytes, a compact copy
        out = tree_map(lambda o: o.clone() if isinstance(o, torch.Tensor)
                       and o.untyped_storage().nbytes() > _nbytes(o)
                       else o, out)
        n = next((self.groups[a] for a in tree_leaves(args)
                  if isinstance(a, str) and a in self.groups), None)
        if n is None:       # a group size given as an int argument
            n = next((a for a in args if isinstance(a, int) and a > 1), 2)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        r = sum(_nbytes(t) for t in outs)
        t = ring_traffic(kind, r, n)
        c = self.costs
        c.coll_bytes += t
        c.coll_by_kind[kind] = c.coll_by_kind.get(kind, 0) + t
        c.coll_counts[kind] = c.coll_counts.get(kind, 0) + 1
        c.bytes += r + sum(_nbytes(a) for a in tree_leaves(args)
                           if isinstance(a, torch.Tensor))
        for o in outs:
            self.live.add(o)
        if self.keep_ops:
            key = f"{kind} over {n} -> {[list(o.shape) for o in outs]}"
            row = self.ops.setdefault(key, [0, 0, 0])
            row[0] += 1
            row[2] += t
        return out


def analyze(fn: Callable, args: Tuple, mesh, *,
            keep_ops: bool = False) -> Analysis:
    """Run ``fn(*args)`` once under the counter and return what it read
    per device of ``mesh``.  ``args`` are DTensors on ``mesh`` (or plain
    tensors); the caller sets the current mesh.  ``keep_ops`` keeps the
    table of op × local output shapes the counts came from (rows of
    count, FLOPs, bytes; a collective's row holds its ring bytes)."""
    counter = _Counter(mesh, keep_ops)
    live = counter.live
    arg_keys = {live.add(_local(t)) for t in tree_leaves(args)
                if isinstance(t, torch.Tensor)}
    argument_bytes = live.live
    with counter:
        out = fn(*args)
    outputs, out_bytes, alias, counted = [], 0, 0, set()
    for path, t in flatten_with_path(out):
        path = path_str(path)
        if not isinstance(t, torch.Tensor):
            continue
        outputs.append((path, tuple(t.shape), str(t.dtype).split(".")[-1]))
        key = live.add(_local(t))
        if key not in counted:
            counted.add(key)
            nb = live.size[key]
            out_bytes += nb
            alias += nb if key in arg_keys else 0
    return Analysis(counter.costs, argument_bytes, out_bytes, alias,
                    live.peak, outputs, dict(live.whales),
                    dict(counter.ops))
