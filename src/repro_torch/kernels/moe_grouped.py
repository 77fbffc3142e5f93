"""Grouped-expert SwiGLU of the dropless MoE FFN: the CUDA kernel
``csrc/moe_grouped.cu`` (kernel 6) and its plain PyTorch version.

No TPU counterpart: the JAX package's ``moe_ffn_dropless`` computes the
expert products with XLA einsums over each token's gathered expert
weights (``src/repro/models/moe.py:70-75``), O(T·k·d·f_e) bytes.  Here
the T·k (token, slot) pairs of one layer are sorted by expert on the
device (``sort_slots``: ``order``, the slots by expert, and ``offsets``,
expert e's sorted rows ``[offsets[e], offsets[e+1])``), and
``grouped_swiglu`` computes, for each sorted row i of expert e,

    y[order[i]] = (silu(x[t] @ w_gate[e]) * (x[t] @ w_up[e])) @ w_down[e],
    t = order[i] // k,

the slot outputs in slot order ``[T·k, d]`` (the gate-weighted sum over
the k slots is the caller's).  Nothing reads the routing on the host on
CUDA tensors: the kernel's grid is fixed by shapes (``m_tiles`` × the N
tiles of the tile plan, ``plan``) and each CTA finds its (expert, M
tile) in ``offsets`` (see the source), so a serving step that runs it
captures as a CUDA graph.  In bf16 the tiles are 64 or 128 rows on
``wgmma`` with the weights by TMA; in float32, 16 rows on CUDA cores.

CPU tensors run ``grouped_swiglu_plain`` (the grouped loop the engine
ran before the kernel: it reads the offsets on the host); CUDA tensors
launch the kernel or raise.  On CUDA tensors where an operand wants a
gradient the kernel runs inside ``_GroupedSwiGLU``, whose backward is
``grouped_swiglu_vjp``, the plain version's VJP.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import (CudaKernel, check_operands,
                                      dtype_code, library)
from repro_torch.kernels.ops import runs_kernel

MOE_KERNEL = CudaKernel(
    "repro_moe_grouped", "moe_grouped.cu", "ppppppppiiiiii",
    replaces="none (the reference's XLA einsums, "
             "src/repro/models/moe.py:73-75)")
MAX_EXPERTS = 128       # experts the CTA's lookup scans (MG_MAX_E)
CTA_TARGET = 2 * 132    # two waves of the H100's SMs (WG_CTA_TARGET)
F32_PLAN = (16, 64, 64)  # float32: 16-row M tiles, 64-column N tiles


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(n_slots: int, n_experts: int, d: int, f: int,
         dtype: torch.dtype) -> Tuple[int, int, int]:
    """The kernel's tile plan for ``n_slots`` slots over ``n_experts``
    experts of width ``d`` and ``f``: (BM, the gate/up launch's BN, the
    down launch's BN), from the shapes alone (the source's ``mg_plan``).
    bf16: 128-row M tiles (two ``wgmma`` warpgroups) where a non-empty
    expert averages more than 48 rows, else 64; 128-column N tiles where
    the expected busy CTAs (non-empty experts × their M tiles × N tiles)
    still reach ``CTA_TARGET``, else 64.  float32: ``F32_PLAN``."""
    if dtype != torch.bfloat16:
        return F32_PLAN
    m = min(n_slots, n_experts)
    bm = 128 if n_slots * 4 > m * 3 * 64 else 64
    tiles = m * _cdiv(_cdiv(n_slots, m), bm)

    def bn(N: int) -> int:
        return 128 if N > 64 and tiles * _cdiv(N, 128) >= CTA_TARGET else 64
    return bm, bn(f), bn(d)


def m_tiles(n_slots: int, n_experts: int, bm: int) -> int:
    """The kernel grid's M tiles for ``n_slots`` slots over
    ``n_experts`` experts at ``bm`` rows a tile: the most any routing
    can take, Σₑ ⌈nₑ / bm⌉ ≤ (n + min(E, n)·(bm − 1)) / bm (at most
    min(E, n) experts are non-empty)."""
    m = min(n_slots, n_experts)
    return (n_slots + m * (bm - 1)) // bm


def source_m_tiles(n_slots: int, n_experts: int, bm: int) -> int:
    """``m_tiles`` as the built source computes it (the card tests hold
    the two equal).  Builds the kernel's library if needed."""
    fn = library(MOE_KERNEL.source).repro_moe_m_tiles
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return fn(n_slots, n_experts, bm)


def source_plan(n_slots: int, n_experts: int, d: int, f: int,
                dtype: torch.dtype) -> Tuple[int, int, int]:
    """``plan`` as the built source computes it."""
    fn = library(MOE_KERNEL.source).repro_moe_plan
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = None
    out = (ctypes.c_int * 3)()
    fn(n_slots, n_experts, d, f, dtype_code(dtype), ctypes.addressof(out))
    return tuple(out)


def sort_slots(idx: torch.Tensor, n_experts: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routing of one layer, on ``idx``'s device with no host read:
    ``idx`` [T, k] expert indices → (``order`` [T·k] int32, the flat
    slots sorted by expert, stable; ``offsets`` [E+1] int32, the first
    sorted row of each expert and T·k)."""
    flat = idx.reshape(-1)
    sorted_e, order = torch.sort(flat, stable=True)
    bounds = torch.arange(n_experts + 1, device=flat.device,
                          dtype=sorted_e.dtype)
    offsets = torch.searchsorted(sorted_e, bounds)
    return order.to(torch.int32), offsets.to(torch.int32)


def swiglu(x, wg, wu, wd):
    """SwiGLU of tokens ``x`` through one expert (``[n, d]``) or every
    expert (``[E, n, d]`` against ``[E, d, f]``): operands meet in the
    wider float type, as ``jnp.einsum`` promotes them."""
    dt = torch.promote_types(x.dtype, wg.dtype)
    x = x.to(dt)
    h = F.silu(x @ wg.to(dt)) * (x @ wu.to(dt))
    return h @ wd.to(dt)


def grouped_swiglu_plain(x, order, offsets, w_gate, w_up, w_down,
                         top_k: int) -> torch.Tensor:
    """The plain version: each non-empty expert's sorted rows through
    ``swiglu``, the outputs scattered back to slot order.  Reads
    ``offsets`` on the host."""
    o = order.long()
    xs = x[o // top_k]                                    # [T*k, d]
    bounds = offsets.tolist()
    outs = [swiglu(xs[lo:hi], w_gate[e], w_up[e], w_down[e])
            for e, (lo, hi) in enumerate(zip(bounds, bounds[1:])) if hi > lo]
    y_sorted = torch.cat(outs)
    y = torch.empty_like(y_sorted)
    y[o] = y_sorted                                       # slot order
    return y


def grouped_swiglu(x, order, offsets, w_gate, w_up, w_down,
                   top_k: int) -> torch.Tensor:
    """Slot outputs [T·k, d] of x [T, d] through each slot's expert; the
    routing as ``sort_slots`` gives it.  On CUDA tensors the kernel takes
    x and the weights in one dtype, float32 or bfloat16, contiguous and
    16-byte aligned, d and f multiples of 8, at most ``MAX_EXPERTS``
    experts, ``order`` / ``offsets`` int32; anything else raises
    ``ValueError``."""
    if not runs_kernel("grouped_swiglu", x, order, offsets, w_gate, w_up,
                       w_down):
        return grouped_swiglu_plain(x, order, offsets, w_gate, w_up, w_down,
                                    top_k)
    _check(x, order, offsets, w_gate, w_up, w_down, top_k)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w_gate, w_up, w_down)):
        return _GroupedSwiGLU.apply(x, order, offsets, w_gate, w_up, w_down,
                                    top_k)
    return _launch(x, order, offsets, w_gate, w_up, w_down, top_k)


def _check(x, order, offsets, w_gate, w_up, w_down, top_k) -> None:
    if x.dim() != 2 or w_gate.dim() != 3:
        raise ValueError(f"grouped_swiglu: x {tuple(x.shape)} must be "
                         f"[T, d], w_gate {tuple(w_gate.shape)} [E, d, f]")
    T, d = x.shape
    E, f = w_gate.shape[0], w_gate.shape[2]
    if (w_gate.shape != (E, d, f) or w_up.shape != (E, d, f)
            or w_down.shape != (E, f, d) or order.shape != (T * top_k,)
            or offsets.shape != (E + 1,)):
        raise ValueError("grouped_swiglu: w_up / w_down / order / offsets "
                         "do not match x and w_gate")
    if x.dtype not in (torch.float32, torch.bfloat16) or any(
            w.dtype != x.dtype for w in (w_gate, w_up, w_down)):
        raise ValueError(f"grouped_swiglu: x and the weights must share one "
                         f"dtype, float32 or bfloat16 (got {x.dtype}, "
                         f"{w_gate.dtype}, {w_up.dtype}, {w_down.dtype})")
    if order.dtype != torch.int32 or offsets.dtype != torch.int32:
        raise ValueError("grouped_swiglu: order and offsets must be int32")
    if not 0 < E <= MAX_EXPERTS or d % 8 or f % 8:
        raise ValueError(f"grouped_swiglu: the kernel takes at most "
                         f"{MAX_EXPERTS} experts and d, f multiples of 8 "
                         f"(got E={E}, d={d}, f={f})")
    check_operands("grouped_swiglu", x.device, x=x, w_gate=w_gate,
                   w_up=w_up, w_down=w_down)
    check_operands("grouped_swiglu", x.device, align=4, order=order,
                   offsets=offsets)


def _launch(x, order, offsets, w_gate, w_up, w_down, top_k):
    T, d = x.shape
    E, f = w_gate.shape[0], w_gate.shape[2]
    act = torch.empty((T * top_k, f), dtype=x.dtype, device=x.device)
    y = torch.empty((T * top_k, d), dtype=x.dtype, device=x.device)
    MOE_KERNEL(x.data_ptr(), order.data_ptr(), offsets.data_ptr(),
               w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
               act.data_ptr(), y.data_ptr(), T, top_k, E, d, f,
               dtype_code(x.dtype), device=x.device)
    return y


def grouped_swiglu_vjp(x, order, offsets, w_gate, w_up, w_down, top_k: int,
                       grad_y: torch.Tensor) -> Tuple:
    """The backward of ``grouped_swiglu``: the VJP of the plain version
    at its inputs (recomputed), the gradients of (x, w_gate, w_up,
    w_down)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (x, w_gate, w_up, w_down)]
        y = grouped_swiglu_plain(ins[0], order, offsets, *ins[1:], top_k)
        return torch.autograd.grad(y, ins, grad_y)


class _GroupedSwiGLU(torch.autograd.Function):
    """Kernel 6 as an autograd node: the forward launches the kernel,
    the backward is ``grouped_swiglu_vjp`` on the saved inputs."""

    @staticmethod
    def forward(ctx, x, order, offsets, w_gate, w_up, w_down, top_k):
        ctx.save_for_backward(x, order, offsets, w_gate, w_up, w_down)
        ctx.top_k = top_k
        return _launch(x, order, offsets, w_gate, w_up, w_down, top_k)

    @staticmethod
    def backward(ctx, grad_y):
        x, order, offsets, wg, wu, wd = ctx.saved_tensors
        gx, gg, gu, gd = grouped_swiglu_vjp(x, order, offsets, wg, wu, wd,
                                            ctx.top_k, grad_y)
        return gx, None, None, gg, gu, gd, None
