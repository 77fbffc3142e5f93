"""Core transformer building blocks in PyTorch (port of
``repro/models/layers.py``).

Parameters are plain nested dicts of tensors, per-layer weights stacked
on a leading layer axis ``[L, ...]`` exactly as in the JAX package, and
applied as ``x @ w`` (``[d_in, d_out]`` layout, no transposes).

A tree may also carry a leading *model* axis ``[M, L, ...]`` (the
stacked weights of a fused group, ``serving/mux.FusedGroup``).  The
projection helpers accept both: with a model axis the activations carry
``M`` as their leading dim too, and every matmul becomes a batched
product over it — the explicit-batch form of the JAX engine's ``vmap``
over the stacked tree.

The mesh helpers (``use_mesh``, ``constrain``, ``shard_activation``)
are the port of ``jax.set_mesh`` and ``with_sharding_constraint``: on
``DTensor`` activations inside ``use_mesh(mesh)`` they redistribute to
the placements a spec names; outside a mesh, or on a plain tensor,
they return their argument itself.  The lowering tools
(``launch/specs.py``, ``launch/dryrun.py``) run the model under a mesh.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# activation-sharding hygiene (the current mesh)
# ---------------------------------------------------------------------------
# the mesh ``use_mesh`` entered (None outside one: every constraint is
# then the identity, and the serving path pays one check per call)
_MESH = None


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator:
    """Make ``mesh`` (a ``DeviceMesh`` with named dims) the current mesh
    for the body, as ``jax.set_mesh`` does; the previous one comes back
    on exit."""
    global _MESH
    old, _MESH = _MESH, mesh
    try:
        yield mesh
    finally:
        _MESH = old


def current_mesh():
    return _MESH


def _mesh_axes():
    if _MESH is None or not _MESH.mesh_dim_names:
        return ()
    return tuple(_MESH.mesh_dim_names)


def model_axis_size() -> int:
    """Size of the 'model' mesh axis of the current mesh (1 outside a
    mesh)."""
    if "model" not in _mesh_axes():
        return 1
    return int(_MESH.size(_MESH.mesh_dim_names.index("model")))


def placements(mesh, spec: Sequence) -> List:
    """DTensor placements of a partition spec on ``mesh``: entry ``i``
    of ``spec`` (an axis name, a tuple of names, or None) shards tensor
    dim ``i`` over those mesh dims; a mesh dim no entry names
    replicates, and so does a mesh dim of size 1 (the same local
    shapes; DTensor's views mishandle a size-1 tensor dim sharded over
    one).  A tuple shards one tensor dim over several mesh dims, in the
    mesh's dim order (the order every spec of the port names them in)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis in names and mesh.size(names.index(axis)) > 1:
                out[names.index(axis)] = Shard(dim)
    return out


def _redistribute(x, spec):
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    want = placements(_MESH, spec)
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(_MESH, want)


def constrain(x: torch.Tensor, *axes) -> torch.Tensor:
    """``with_sharding_constraint`` filtered to the axes of the current
    mesh (the identity outside a mesh or on a plain tensor).  Each entry
    is an axis name, a tuple of names, or None."""
    if _MESH is None:
        return x
    present = set(_mesh_axes())

    def keep(a):
        if a is None:
            return None
        if isinstance(a, tuple):
            t = tuple(x_ for x_ in a if x_ in present)
            return t if t else None
        return a if a in present else None

    spec = [keep(a) for a in axes]
    if all(s is None for s in spec):
        return x
    return _redistribute(x, spec)


def _axes(entry) -> tuple:
    return () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))


def _region(args, in_specs):
    """The placements of a shard-by-shard region's specs on the current
    mesh: an axis that does not divide the dim it would shard in some
    DTensor argument (a batch of 1 over (pod, data)) shards nothing in
    the region, for every argument alike.  Returns a map from a spec to
    its placements."""
    from torch.distributed.tensor import DTensor
    mesh = _MESH
    size = dict(zip(mesh.mesh_dim_names,
                    (mesh.size(i) for i in range(mesh.ndim))))
    idle = set()
    for a, spec in zip(args, in_specs):
        if spec is None or not isinstance(a, DTensor):
            continue
        for dim, entry in enumerate(spec):
            ways = 1
            for ax in _axes(entry):
                ways *= size.get(ax, 1)
                if a.shape[dim] % ways:
                    idle.add(ax)

    def pl(spec):
        if spec is None:
            return None
        return placements(mesh, [tuple(x for x in _axes(e)
                                       if x not in idle) or None
                                 for e in spec])
    return pl


def local_region(fn, in_specs: Sequence, out_specs):
    """``fn`` as a shard-by-shard region of the current mesh: each
    DTensor argument is redistributed to its entry of ``in_specs`` (None
    for an argument that is not a tensor) and ``fn`` runs on the local
    shards; its outputs become DTensors at ``out_specs`` (a spec, or a
    list of specs for a tuple of outputs).  ``fn`` must be local along
    every dim the specs shard.  An axis that does not divide the dim it
    would shard in some argument (a batch of 1 over (pod, data)) shards
    nothing in the region.  Outside a mesh ``fn`` itself."""
    if _MESH is None:
        return fn
    from torch.distributed.tensor.experimental import local_map
    mesh = _MESH

    def run(*args):
        pl = _region(args, in_specs)
        outs = (tuple(pl(s) for s in out_specs)
                if isinstance(out_specs, list) else pl(out_specs))
        ins = tuple(pl(s) for s in in_specs)
        return local_map(fn, out_placements=outs, in_placements=ins,
                         in_grad_placements=grad_placements(ins, outs),
                         device_mesh=mesh, redistribute_inputs=True)(*args)
    return run


def grad_placements(ins: Sequence, outs) -> tuple:
    """The placements of the gradients a shard-by-shard region hands
    back for its inputs (``ins``, a placement list or None each;
    ``outs``, one placement list or a tuple of them).  A mesh dim the
    region splits (some input or output not replicated along it) gives
    an input replicated along it a partial gradient: each rank's local
    gradient is its own shard's share of the sum.  Along a dim the
    region does not split every rank computes the same, and the
    gradient stays replicated."""
    from torch.distributed.tensor import Partial
    groups = [p for p in ins if p is not None] + (
        [p for p in outs if p is not None] if isinstance(outs, tuple)
        else [outs])
    split = [any(not p[j].is_replicate() for p in groups)
             for j in range(len(groups[0]))]
    return tuple(None if p is None else
                 [Partial() if cut and pj.is_replicate() else pj
                  for cut, pj in zip(split, p)] for p in ins)


def on_local_shards(fn, in_specs: Sequence, *args, written: int = 1):
    """``fn(*args)`` for in-place row writes (a cache row's write at its
    batch row's position), which DTensor has no in-place rule for:
    inside a mesh each DTensor argument is brought to its entry of
    ``in_specs`` (as ``local_region`` places them) and replaced by its
    local shard, so that every argument's rows meet on the same rank.
    The first ``written`` arguments are written in place and must
    already lie at their specs (a redistribution would write a copy).
    Outside a mesh ``fn(*args)`` itself."""
    if _MESH is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor
    pl = _region(args, in_specs)
    local = []
    for i, (a, spec) in enumerate(zip(args, in_specs)):
        if isinstance(a, DTensor):
            want = pl(spec)
            if tuple(want) != tuple(a.placements):
                if i < written:
                    raise ValueError(
                        f"on_local_shards: argument {i} is written in "
                        f"place at {a.placements}, not at its spec {want}")
                a = a.redistribute(_MESH, want)
            a = a.to_local()
        local.append(a)
    return fn(*local)


def distributed(t: torch.Tensor, *axes) -> torch.Tensor:
    """A tensor the step makes itself (an iota, a mask) as a DTensor of
    the current mesh sharded at ``axes`` (each device keeps its slice of
    the replicated tensor: no communication).  Outside a mesh ``t``
    itself."""
    if _MESH is None:
        return t
    from torch.distributed.tensor import DTensor, Replicate
    rep = DTensor.from_local(t, _MESH, [Replicate()] * _MESH.ndim,
                             run_check=False)
    return constrain(rep, *axes)


def gathered(w: torch.Tensor) -> torch.Tensor:
    """A weight as a matmul reads it: on a mesh its (pod, data) shards
    gathered (FSDP: weights are gathered per layer, the model axis's
    tensor-parallel shards kept; the gradient flows back
    reduce-scattered), so DTensor never trades a weight's data shards
    against the batch's.  Outside a mesh ``w`` itself."""
    if _MESH is None:
        return w
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(w, DTensor):
        return w
    names = _MESH.mesh_dim_names
    want = [Replicate() if names[i] in ("pod", "data") else pl
            for i, pl in enumerate(w.placements)]
    if want == list(w.placements):
        return w
    return w.redistribute(_MESH, want)


def _gather_seq(x: torch.Tensor) -> torch.Tensor:
    """On a mesh, the input of a projection with its batch on (pod, data)
    and every other dim whole: the all-gather of a sequence-sharded
    residual stream before the matmul (Megatron-SP), which keeps
    DTensor from merging a sharded sequence dim into the matmul's rows
    (a strided shard whose redistribution plans take minutes on the
    2×16×16 mesh)."""
    if _MESH is None:
        return x
    return constrain(x, ("pod", "data"), *([None] * (x.dim() - 1)))


def shard_activation(x: torch.Tensor, *, last: Optional[str] = None,
                     seq: Optional[str] = None) -> torch.Tensor:
    """Constrain an activation to batch-on-(pod,data) [+ seq/last dims].
    ``seq="model"`` additionally shards dim 1 (sequence parallelism for
    the residual stream between layers, Megatron-SP); ``last`` shards
    the last dim.  The identity outside a mesh or on a plain tensor."""
    if _MESH is None:
        return x
    axes = _mesh_axes()
    batch = tuple(a for a in ("pod", "data") if a in axes)
    if not batch:
        return x
    spec = [batch] + [None] * (x.ndim - 1)
    if seq is not None and seq in axes and x.ndim >= 3 \
            and x.shape[1] % 16 == 0:
        spec[1] = seq
    if last is not None and last in axes:
        spec[-1] = last
    return _redistribute(x, spec)


# ---------------------------------------------------------------------------
# leading model axis
# ---------------------------------------------------------------------------
def _per_model(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """View a vector weight (``[n]``, or ``[M, n]`` with a model axis)
    so it broadcasts against activations ``x`` (``[..., n]``, or
    ``[M, ..., n]``)."""
    if w.dim() == 1:
        return w
    return w.reshape(w.shape[0], *([1] * (x.dim() - 2)), w.shape[-1])


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with ``w`` of shape ``[d_in, d_out]`` or ``[M, d_in,
    d_out]`` (then ``x`` is ``[M, ..., d_in]``).  Operands of two
    float types meet in the wider one, as ``jnp.matmul`` promotes them
    (the W8/KV8 step multiplies f32 activations by bf16 weights)."""
    w = gathered(w)
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    if w.dim() == 2:
        return x @ w
    m, d_in, d_out = w.shape
    y = torch.bmm(x.reshape(m, -1, d_in), w)
    return y.reshape(*x.shape[:-1], d_out)


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    w = _per_model(w, x).float()
    return (x * torch.rsqrt(var + eps) * w).to(dtype)


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq].  The
    half-split form (first and second halves of the head rotate
    together), as the JAX package."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # [hd/2]
    angles = positions[..., None].float() * freqs           # [..., seq, hd/2]
    cos = torch.cos(angles)[..., None, :]                   # [..., seq, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (plain version of kernels/flash_prefill.flash_prefill)
# ---------------------------------------------------------------------------
def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, KV, hd] -> [B, S, KV*n_rep, hd] (GQA broadcast)."""
    if n_rep == 1:
        return x
    b, s, kv, hd = x.shape
    x = x[:, :, :, None, :].expand(b, s, kv, n_rep, hd)
    return x.reshape(b, s, kv * n_rep, hd)


def causal_attention(q, k, v, *, window: Optional[int] = None,
                     q_offset: int = 0) -> torch.Tensor:
    """Plain causal attention.  q: [B,Sq,H,hd], k/v: [B,Sk,KV,hd].

    ``q_offset`` positions q tokens at ``q_offset + arange(Sq)`` in the
    kv timeline.  ``window``: sliding window.  On a mesh it runs shard by
    shard, as ``blocked_causal_attention``."""
    return attention_on_shards(
        lambda q_, k_, v_: _causal_attention(q_, k_, v_, window, q_offset),
        q, k, v)


def _attention_spec() -> tuple:
    """The spec ``attn_qkv`` constrains q, k and v to: batch on (pod,
    data), heads on model (Megatron TP), the sequence whole."""
    return (("pod", "data"), None, "model", None)


def attention_on_shards(fn, q, k, v):
    """``fn(q, k, v)`` (an attention over ``[B, S, H, hd]`` operands),
    shard by shard on a mesh at the spec ``attn_qkv`` constrains them
    to: a kernel's wrapper then only ever sees local tensors.  Outside a
    mesh ``fn(q, k, v)`` itself."""
    if _MESH is None:
        return fn(q, k, v)
    spec = _attention_spec()
    return local_region(fn, [spec, spec, spec], spec)(q, k, v)


def _causal_attention(q, k, v, window: Optional[int], q_offset: int):
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    k = repeat_kv(k, h // kvh)
    v = repeat_kv(v, h // kvh)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    scores = torch.where(mask[None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _online_block(q_blk, k_blk, v_blk, m, l, acc, q0: int, k0: int,
                  scale: float, window: Optional[int]):
    """One kv block of the online softmax.  q_blk [b,h,bq,hd], k_blk /
    v_blk [b,h,bk,hd]; the running max ``m``, sum ``l`` [b,h,bq] and
    accumulator ``acc`` [b,h,bq,hd] in float32."""
    bq, bk = q_blk.shape[2], k_blk.shape[2]
    s_ij = torch.matmul(q_blk, k_blk.transpose(-1, -2)).float() * scale
    inside = k0 + bk - 1 <= q0 and (window is None
                                    or k0 - (q0 + bq - 1) > -window)
    if not inside:                       # the mask cuts this block
        q_pos = q0 + torch.arange(bq, device=q_blk.device)[:, None]
        k_pos = k0 + torch.arange(bk, device=q_blk.device)[None, :]
        mask = k_pos <= q_pos
        if window is not None:
            mask &= k_pos > q_pos - window
        s_ij = torch.where(mask, s_ij, -1e30)
    m_new = torch.maximum(m, s_ij.amax(-1))
    p = torch.exp(s_ij - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(-1)
    acc_new = acc * corr[..., None] + torch.matmul(p, v_blk.float())
    return m_new, l_new, acc_new


def blocked_causal_attention(q, k, v, *, block_q: int = 512,
                             block_k: int = 1024,
                             window: Optional[int] = None) -> torch.Tensor:
    """Memory-bounded causal attention: online softmax over kv blocks.
    q: [B,S,H,hd], k/v: [B,S,KV,hd] → [B,S,H,hd].

    The plain path of the dry-run (``launch/dryrun.py``): it keeps the
    S×S score matrix out of the memory count.  A ``block_q`` query block
    meets one ``block_k`` kv block at a time, in an explicit
    ``[b, h, q, d]`` layout of matmuls.  The reference scans every kv
    block (masked) for a static shape; here only the blocks that meet
    the causal / window mask are visited (a wholly masked block adds
    nothing), as kernel 3 does.  Under autograd each block is
    checkpointed, as the reference's ``jax.checkpoint``: the backward
    recomputes a block's probabilities instead of saving them.  Falls
    back to ``causal_attention`` when S is not a multiple of both
    blocks.  On a mesh it runs shard by shard (``local_region``) at the
    spec ``attn_qkv`` constrains q, k and v to: batch on (pod, data),
    heads on model, the sequence whole."""
    return attention_on_shards(
        lambda q_, k_, v_: _blocked_attention(q_, k_, v_, block_q, block_k,
                                              window),
        q, k, v)


def _blocked_attention(q, k, v, block_q: int, block_k: int,
                       window: Optional[int]) -> torch.Tensor:
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    if s % block_q != 0 or s % block_k != 0:
        return _causal_attention(q, k, v, window, 0)
    n_rep = h // kvh
    scale = 1.0 / math.sqrt(hd)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    qt = q.transpose(1, 2)                                  # [b,h,s,hd]
    outs = []
    for q0 in range(0, s, block_q):
        q_blk = qt[:, :, q0:q0 + block_q]
        m = torch.full((b, h, block_q), -1e30, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, block_q), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((b, h, block_q, hd), dtype=torch.float32,
                          device=q.device)
        for k0 in range(0, s, block_k):
            if k0 > q0 + block_q - 1 or (
                    window is not None
                    and k0 + block_k - 1 <= q0 - window):
                continue                      # wholly masked
            k_blk = repeat_kv(k[:, k0:k0 + block_k], n_rep).transpose(1, 2)
            v_blk = repeat_kv(v[:, k0:k0 + block_k], n_rep).transpose(1, 2)
            args = (q_blk, k_blk, v_blk, m, l, acc, q0, k0, scale, window)
            if grad:
                m, l, acc = checkpoint(_online_block, *args,
                                       use_reentrant=False)
            else:
                m, l, acc = _online_block(*args)
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=2).transpose(1, 2)           # [b,s,h,hd]


# ---------------------------------------------------------------------------
# attention block params
# ---------------------------------------------------------------------------
def _normal(shape, scale: float, gen: torch.Generator, dtype,
            device) -> torch.Tensor:
    # scaled in place: a full-width leaf is gigabytes, a temporary copy
    # would double the peak
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=device).mul_(scale)


def init_attn(cfg: ModelConfig, n_layers: int, gen: torch.Generator,
              dtype=torch.bfloat16, device="cuda") -> Params:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    sc = 1.0 / math.sqrt(d)
    sco = 1.0 / math.sqrt(h * hd)
    L = n_layers
    p = {
        "wq": _normal((L, d, h * hd), sc, gen, dtype, device),
        "wk": _normal((L, d, kv * hd), sc, gen, dtype, device),
        "wv": _normal((L, d, kv * hd), sc, gen, dtype, device),
        "wo": _normal((L, h * hd, d), sco, gen, dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((L, h * hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((L, kv * hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((L, kv * hd), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((L, hd), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((L, hd), dtype=dtype, device=device)
    return p


def attn_qkv(x, p, li, cfg: ModelConfig, positions):
    """Project to q/k/v (+bias, qk_norm, rope).  x: [B,S,d] (or
    [M,B,S,d] with a model axis on every leaf of ``p``)."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    x = _gather_seq(x)
    lead = x.shape[:-1]
    sel = (slice(None),) * (p["wq"].dim() - 3) + (li,)
    q = linear(x, p["wq"][sel])
    k = linear(x, p["wk"][sel])
    v = linear(x, p["wv"][sel])
    if cfg.qkv_bias:
        q = q + _per_model(p["bq"][sel], q)
        k = k + _per_model(p["bk"][sel], k)
        v = v + _per_model(p["bv"][sel], v)
    bd = ("pod", "data")
    q = constrain(q.reshape(*lead, h, hd), bd, None, "model", None)
    k = constrain(k.reshape(*lead, kv, hd), bd, None, "model", None)
    v = constrain(v.reshape(*lead, kv, hd), bd, None, "model", None)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"][sel], cfg.rms_eps)
        k = rms_norm(k, p["k_norm"][sel], cfg.rms_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


# ---------------------------------------------------------------------------
# dense SwiGLU MLP
# ---------------------------------------------------------------------------
def init_mlp(d: int, f: int, n_layers: int, gen: torch.Generator,
             dtype=torch.bfloat16, device="cuda") -> Params:
    return {
        "w_gate": _normal((n_layers, d, f), 1 / math.sqrt(d), gen, dtype,
                          device),
        "w_up": _normal((n_layers, d, f), 1 / math.sqrt(d), gen, dtype,
                        device),
        "w_down": _normal((n_layers, f, d), 1 / math.sqrt(f), gen, dtype,
                          device),
    }


def mlp(x, p, li):
    x = _gather_seq(x)
    sel = (slice(None),) * (p["w_gate"].dim() - 3) + (li,)
    h = F.silu(linear(x, p["w_gate"][sel])) * linear(x, p["w_up"][sel])
    # Megatron TP: the hidden dim rides the model axis with the batch
    # on (pod,data)
    h = constrain(h, ("pod", "data"), *([None] * (h.dim() - 2)), "model")
    return linear(h, p["w_down"][sel])


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------
def init_embed(cfg: ModelConfig, v_padded: int, gen: torch.Generator,
               dtype=torch.bfloat16, device="cuda") -> Params:
    d = cfg.d_model
    p = {
        "embed": _normal((v_padded, d), 0.02, gen, dtype, device),
        "out_norm": torch.ones((d,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = _normal((d, v_padded), 1 / math.sqrt(d), gen, dtype,
                               device)
    return p


def embed_tokens(embed: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """Look tokens up in ``embed`` ``[V, d]`` or, with a model axis,
    ``[M, V, d]`` (then ``toks`` is ``[M, ...]``, model m's tokens
    reading model m's table)."""
    if embed.dim() == 2:
        return embed[toks]
    m = torch.arange(embed.shape[0], device=toks.device)
    return embed[m.reshape(-1, *([1] * (toks.dim() - 1))), toks]


def lm_logits(x, p, cfg: ModelConfig):
    x = _gather_seq(rms_norm(x, p["out_norm"], cfg.rms_eps))
    if cfg.tie_embeddings:
        return linear(x, p["embed"].transpose(-1, -2))
    return linear(x, p["lm_head"])
