"""Compiled serving steps: one CUDA graph per step kind, geometry and
shape bucket — the port's counterpart of the JAX package's
``jitted_step`` (``repro/serving/engine.py``), whose steps each run as
one ``jax.jit`` program with the KV pool donated.

Every family's steps run this way, the MoE family's too: its dropless FFN sorts the slots by expert on the card
and runs kernel 6 over a grid fixed by shapes, so no host sync (which a
capture refuses) is left in a step.  The kinds: ``prefill`` (whole
prompts of the dense and MoE families), ``decode`` / ``chunk`` and
their fused forms, and the SSM and hybrid ``prefill_ssm`` /
``chunk_ssm`` / ``decode_ssm``.

A step is split in two (``serving/engine.py``): a host part plans the
step into fixed-shape numpy arrays, packed here into one int64 array
(one copy to the card a step), and a device part takes device tensors
only: ``body(params, bufs, inputs)``, where ``bufs`` are the buffers
the step reads and writes in place — the arena's (``UnifiedKVPool.arena``)
where it reads the pool, then an SSM engine's ``ssm_state`` /
``conv_tail`` (and, for its decode, the rows' pre-step copies that a
rollback reads).  On the card the device part is captured once per key
and replayed:

* key: the step kind, the geometry (``Engine.cfg_key``), the packed
  inputs' layout (the bucket's shapes), the model index of a serial
  step, the storage identity of the weight leaves, and that of
  ``bufs``.  A graph holds raw pointers, so every buffer it reads is in
  its key — and only those: a pure-SSM step keys on no arena, so an
  arena grow keeps it.
* first sight: the body runs once eagerly on a side stream (kernel
  builds, ctypes binding and ``cudaFuncSetAttribute`` happen there,
  outside capture; its output is the call's result), then it is
  captured with ``torch.cuda.graph`` into one memory pool shared by
  every graph (``GRAPH_CAPTURES`` counts the captures by kind).  A
  whole-prompt key (rows and padded prompt length) is captured on its
  first sight too, as every other.  On varied prompts most such keys
  are met once in a pass over a trace and replayed when the traffic
  returns to them; a capture on the second sight would skip the keys
  met only once, at one replay fewer for every key met again.
* later calls: the packed inputs go through a pinned buffer into the
  graph's static input (non-blocking), the graph replays, and the
  caller gets a clone of the static logits (callers keep logits across
  steps; the next replay overwrites the static ones).  A step's graph
  outputs its logits only: SSM state goes into the engine's buffers
  inside the graph, so nothing of it is cloned out.
* stale graphs: a graph is dropped as soon as a weight leaf or a buffer
  of its key dies (``adopt_stacked``, ``materialize_private``, a
  ``grow`` that reallocates, the engine that crash recovery replaces),
  and when the same step of the same weights is captured on other
  buffers (``rebind_view`` / ``migrate_view``, crash recovery's
  re-registered view).  A ``shrink`` or a ``grow`` into the slack keeps
  the buffers, and so the graphs.
* launch counts: a kernel wrapper counts a launch when Python calls it;
  a capture's calls launch nothing and are taken back, and each replay
  adds them again, so ``kernels.ops.launch_counts()`` stays true.

The trainer's step (``train/graphs.py``) goes through the same
registry, capture and pool, as the kind ``train``.

``disable_graphs()`` runs every step eagerly on the card, for
comparison (the reference's ``jax.disable_jit()``).  Operands on the
CPU always run eagerly.  A failed capture or replay raises: there is no
quiet retreat to the eager step.
"""
from __future__ import annotations

import contextlib
import time
import weakref
from collections import Counter
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch

from repro_torch.serving.metrics import traced

# captures by step kind, the seconds they took (the eager first run
# included), and replays by step kind
GRAPH_CAPTURES: Counter = Counter()
CAPTURE_SECONDS: Counter = Counter()
GRAPH_REPLAYS: Counter = Counter()

_DISABLED = [0]


@contextlib.contextmanager
def disable_graphs() -> Iterator[None]:
    """Run every step eagerly inside the block, on the card too."""
    _DISABLED[0] += 1
    try:
        yield
    finally:
        _DISABLED[0] -= 1


# ---------------------------------------------------------------------------
# packed step inputs
# ---------------------------------------------------------------------------
@traced("plan.inputs")
def pack(arrays: Dict[str, np.ndarray]) -> Tuple[np.ndarray, tuple]:
    """One int64 array holding every host input of a step, and the layout
    ``((name, shape, numpy dtype), ...)`` that ``unpack`` reads."""
    layout = tuple((k, a.shape, a.dtype.str) for k, a in arrays.items())
    flat = np.concatenate([np.asarray(a, np.int64).reshape(-1)
                           for a in arrays.values()])
    return flat, layout


def unpack(buf: torch.Tensor, layout: tuple) -> Dict[str, torch.Tensor]:
    """The step's inputs as tensors read from ``buf`` (views of it where
    the type is int64, casts otherwise): inside a capture they read the
    static input at every replay."""
    out, o = {}, 0
    for name, shape, dt in layout:
        n = int(np.prod(shape, dtype=np.int64))
        out[name] = buf[o:o + n].reshape(shape).to(_TORCH_TYPES[dt])
        o += n
    return out


_TORCH_TYPES = {np.dtype(t).str: torch.from_numpy(np.zeros(0, t)).dtype
                for t in (np.int64, np.int32, np.bool_)}


# ---------------------------------------------------------------------------
# capture
# ---------------------------------------------------------------------------
class CudaGraphCapture:
    """Captures a step as a CUDA graph on the card of its operands.  The
    graphs share one memory pool while any of them lives; the first
    capture after the last one died opens a new pool (the allocator
    frees a pool no graph uses, and refuses to share it again)."""

    device_types = ("cuda",)

    def __init__(self):
        self.pool = None
        self.stream = None
        self.live = 0

    def eager(self, fn: Callable[[], torch.Tensor], device) -> torch.Tensor:
        """Run ``fn`` once on a side stream (first-use work stays out of
        the capture); returns its output, usable on the current
        stream."""
        with torch.cuda.device(device):
            if self.stream is None:
                self.stream = torch.cuda.Stream()
            cur = torch.cuda.current_stream()
            self.stream.wait_stream(cur)
            with torch.cuda.stream(self.stream):
                out = fn()
            cur.wait_stream(self.stream)
            out.record_stream(cur)
        return out

    def record(self, key, fn: Callable[[], torch.Tensor], device):
        """Capture ``fn``.  Returns ``(replay, static output)``;
        ``replay(fn)`` replays the graph (``fn`` is ignored: the graph
        is the program)."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device):
            if self.live == 0:
                self.pool = torch.cuda.graph_pool_handle()
            with torch.cuda.graph(graph, pool=self.pool):
                out = fn()
        self.live += 1
        weakref.finalize(graph, self._died)
        return (lambda _fn: graph.replay()), out

    def _died(self) -> None:
        self.live -= 1


class StaticInput:
    """A graph's static input and the pinned buffer that feeds it from
    the host: each ``load`` from the host waits until the previous copy
    out of the pinned buffer is done, fills it, and copies it into the
    static tensor without blocking the host.  A source on the static
    tensor's device, or a static tensor on the CPU, takes a plain
    copy."""

    def __init__(self, src: torch.Tensor, device):
        self.tensor = torch.empty(src.shape, dtype=src.dtype, device=device)
        self.pinned = self.copied = None
        self.load(src)

    @traced("graph.load")
    def load(self, src: torch.Tensor) -> None:
        if self.tensor.device.type != "cuda" or src.device.type != "cpu":
            self.tensor.copy_(src)
            return
        if self.pinned is None:
            self.pinned = torch.empty(src.shape, dtype=src.dtype,
                                      pin_memory=True)
            self.copied = torch.cuda.Event()
        else:
            # the pinned buffer may still feed the previous step's copy
            self.copied.synchronize()
        self.pinned.copy_(src)
        self.tensor.copy_(self.pinned, non_blocking=True)
        self.copied.record()


class _StepGraph:
    """One captured step: its static inputs, the replay, the static
    output, the kernel launches one replay makes and the replays so
    far."""

    def __init__(self, kind, inputs, replay, out, launches):
        self.kind = kind
        self.inputs = inputs
        self.replay = replay
        self.out = out
        self.launches = launches
        self.replays = 0
        self.refs: List[weakref.ref] = []

    def run(self, srcs, fn) -> torch.Tensor:
        for s, src in zip(self.inputs, srcs):
            s.load(src)
        self._replay(fn)
        for k, n in self.launches:
            k.launches += n
        self.replays += 1
        GRAPH_REPLAYS[self.kind] += 1
        return self._clone()

    @traced("graph.replay")
    def _replay(self, fn) -> None:
        self.replay(fn)

    @traced("graph.clone")
    def _clone(self) -> torch.Tensor:
        return self.out.clone()


class GraphRegistry:
    """The captured steps, by key (see the module's header)."""

    def __init__(self, capture=None):
        self.capture = capture if capture is not None else CudaGraphCapture()
        self.graphs: Dict[tuple, _StepGraph] = {}
        self._by_slot: Dict[tuple, tuple] = {}
        self.log: List[tuple] = []      # every captured key, in order
        # drops that fall inside a capture (a weakref callback run by the
        # collector) wait for its end: no graph is destroyed mid-capture
        self._capturing = False
        self._pending: List[tuple] = []

    def enabled(self, device: torch.device) -> bool:
        return not _DISABLED[0] and device.type in self.capture.device_types

    def clear(self) -> None:
        self.graphs.clear()
        self._by_slot.clear()
        self.log.clear()

    def _drop(self, key) -> None:
        if self._capturing:
            self._pending.append(key)
            return
        if self.graphs.pop(key, None) is not None:
            if self._by_slot.get(key[0]) == key:
                del self._by_slot[key[0]]

    def run(self, kind: str, cfg_key, midx, params, bufs, packed, layout,
            body) -> torch.Tensor:
        """``body(params, bufs, inputs)`` for this call's ``packed``
        inputs: replayed, or captured on first sight."""
        key, held, src = self._key(kind, cfg_key, midx, params, bufs,
                                   packed, layout)
        return self.step(kind, key, held, bufs[0].device, (src,),
                         lambda buf: body(params, bufs, unpack(buf, layout)))

    @traced("plan.inputs")
    def _key(self, kind: str, cfg_key, midx, params, bufs, packed,
             layout) -> tuple:
        """A step's key (see the header), the objects it names and its
        packed inputs as a tensor."""
        from repro_torch.serving.engine import tree_leaves
        leaves = tree_leaves(params)
        slot = (kind, cfg_key, layout, midx,
                tuple(t.data_ptr() for t in leaves))
        key = (slot, tuple(t.data_ptr() for t in bufs)
               + tuple(t.shape[0] for t in bufs))
        return key, leaves + list(bufs), torch.from_numpy(packed)

    def step(self, kind: str, key: tuple, held, device, srcs,
             body) -> torch.Tensor:
        """``body(*inputs)`` on static copies of the tensors ``srcs``, as
        the graph of ``key`` (``(slot, buffers)``, see the header):
        replayed, or captured on first sight.  ``held`` are the objects
        the key names (tensors by their storage): the graph goes when one
        dies.
        ``body`` returns one tensor, the graph's static output."""
        g = self.graphs.get(key)
        if g is not None:
            return g.run(srcs, lambda: body(*(s.tensor for s in g.inputs)))
        from repro_torch.kernels import ops
        t0 = time.perf_counter()
        old = self._by_slot.get(key[0])
        if old is not None:
            self._drop(old)              # the same step on other buffers
        inputs = tuple(StaticInput(src, device) for src in srcs)

        def fn():
            return body(*(s.tensor for s in inputs))
        result = self.capture.eager(fn, device)
        # a capture's kernel calls launch nothing: count them per replay
        kernels = ops.path_kernels()
        before = [k.launches for k in kernels]
        self._capturing = True
        try:
            replay, out = self.capture.record(key, fn, device)
        finally:
            self._capturing = False
            launches = tuple((k, k.launches - n)
                             for k, n in zip(kernels, before))
            for k, n in launches:
                k.launches -= n
            pending, self._pending = self._pending, []
            for dead in pending:
                self._drop(dead)
        g = _StepGraph(kind, inputs, replay, out,
                       tuple((k, n) for k, n in launches if n))
        for t in held:
            g.refs.append(weakref.ref(t, lambda _r, key=key: self._drop(key)))
        self.graphs[key] = g
        self._by_slot[key[0]] = key
        self.log.append(key)
        GRAPH_CAPTURES[kind] += 1
        CAPTURE_SECONDS[kind] += time.perf_counter() - t0
        return result


REGISTRY = GraphRegistry()


def run_step(kind: str, cfg_key, midx, params, bufs: tuple,
             host: Dict[str, np.ndarray], body,
             capturable: bool = True) -> torch.Tensor:
    """Run a step's device part ``body(params, bufs, inputs)`` on the
    host part's arrays ``host``: through the registry where ``bufs`` (the
    buffers the step reads besides its weights, see the header) lie on
    the card, the kind is ``capturable`` and graphs are not disabled,
    else eagerly."""
    packed, layout = pack(host)
    dev = bufs[0].device
    if capturable and REGISTRY.enabled(dev):
        return REGISTRY.run(kind, cfg_key, midx, params, bufs, packed,
                            layout, body)
    return body(params, bufs, unpack(torch.from_numpy(packed).to(dev),
                                     layout))
