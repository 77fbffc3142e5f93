"""Mamba2 SSD chunked scan: the CUDA kernel ``csrc/ssd_scan.cu`` and its
plain PyTorch version.

Port of ``repro/kernels/ssd_scan.py`` (the Pallas kernel) and of its
oracle ``repro.models.mamba2.ssd_chunked``, with the serving path's
carried state: ``init_state`` (None = zeros) is the SSM state the scan
starts from.  CPU tensors run ``ssd_plain``; CUDA tensors launch the
kernel (see the source for the design and what bounds it): for bf16,
the tensor-core body, one CTA per (batch row, head, P-slice), the slice
and the CTA's warps planned by ``plan_launch`` from shapes alone; for
float32, the CUDA-core body, one CTA per (batch row, head).

Both accept any sequence length: where ``S > chunk`` is not a multiple
of the chunk, the plain version pads the time axis with ``dt = 0`` and
zero x/B/C and cuts ``y`` back, and the kernel masks the ragged last
chunk the same way.  A step with ``dt = 0`` neither decays nor feeds the
state, so both are exact.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import (CudaKernel, check_operands,
                                      dtype_code, library, sm_count)
from repro_torch.kernels.ops import runs_kernel

SSD_KERNEL = CudaKernel(
    "repro_ssd_scan", "ssd_scan.cu", "pppppppppiiiiiiiiii",
    replaces="src/repro/kernels/ssd_scan.py:79")
HEAD_DIM = 64           # P: channels per SSM head the kernel takes
MAX_CHUNK = 256         # longest chunk the kernel keeps in shared memory
MAX_STATE = 128         # largest d_state (N), a multiple of 16
MAX_SMEM = 232448       # shared memory one CTA may use on an H100
F32_PLAN = (HEAD_DIM, 8)        # the CUDA-core body: whole heads, 8 warps


class SsdPlan(NamedTuple):
    p_slice: int        # state rows (of a head's 64) one CTA owns
    warps: int          # warps of a CTA


def tc_smem_bytes(chunk: int, d_state: int, p_slice: int) -> int:
    """Shared memory of one CTA of the bf16 body (``ssd_tc_smem_bytes``
    in the source)."""
    qp = -(-chunk // 16) * 16
    return (p_slice * (d_state + 4) * 4 + 4 * qp * 4 + 64
            + (2 * qp * (d_state + 8) + 2 * qp * (p_slice + 8)
               + p_slice * (d_state + 8)) * 2)


def source_smem(chunk: int, d_state: int, p_slice: int) -> int:
    """``tc_smem_bytes`` as the built source computes it, or (``chunk``
    0) the source's ``MAX_SMEM``: the card tests hold the two copies of
    the layout equal.  Builds the kernel's library if needed."""
    fn = library(SSD_KERNEL.source).repro_ssd_tc_smem
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return fn(chunk, d_state, p_slice)


def plan_launch(batch: int, heads: int, chunk: int, d_state: int,
                sms: int) -> SsdPlan:
    """The bf16 body's launch on a card of ``sms`` SMs, from shapes alone.

    A CTA of 8 warps takes one SM (its registers); the grid has
    ``batch * heads`` CTAs of whole heads.  Where that fills at most half
    the SMs, each head splits into two 32-row slices (twice the CTAs,
    each recomputing C.B^T); where it is more than one CTA an SM but at
    most two, CTAs of 4 warps (two fit an SM) run the grid in one wave;
    otherwise whole heads on 8 warps.  A whole head that does not fit in
    shared memory (chunk 256 with d_state 128) takes two slices.  (On an
    H100 these were the fastest of slices 16, 32, 64 by 4 or 8 warps at
    the mamba2-2.7b chunk step, b 1, 2, 4, and the zamba2-1.2b bucket,
    b 1, 2; PERF.md.)"""
    pairs = batch * heads
    if 2 * pairs <= sms or tc_smem_bytes(chunk, d_state, HEAD_DIM) > MAX_SMEM:
        return SsdPlan(32, 8)
    if pairs <= sms or pairs > 2 * sms:
        return SsdPlan(HEAD_DIM, 8)
    return SsdPlan(HEAD_DIM, 4)


def grid_ctas(batch: int, heads: int, p_slice: int) -> int:
    """CTAs of one launch."""
    return batch * heads * (HEAD_DIM // p_slice)


def ssd_plain(x, dt, a_log, B, C, d_skip, chunk: int,
              init_state: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan (the JAX package's ``ssd_chunked``).

    x:  [b, S, H, P]   inputs per head
    dt: [b, S, H]      softplus-activated step sizes (float32)
    a_log, d_skip: [H] float32
    B, C: [b, S, G, N] input / output projections (G groups over H)
    init_state: [b, H, P, N] float32, or None for zeros
    Returns (y [b, S, H, P] in x's dtype, final state [b, H, P, N] f32).
    """
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    pad = -S % chunk
    if pad:
        # dt = 0 rows neither decay nor feed the state: exact padding
        x, B, C = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, B, C))
        dt = F.pad(dt, (0, 0, 0, pad))
    Sp = S + pad
    nc = Sp // chunk
    rep = H // G
    f32 = torch.float32

    a = -torch.exp(a_log.to(f32))                             # [H]
    dA = dt.to(f32) * a                                       # [b,S,H]
    xdt = x.to(f32) * dt.to(f32)[..., None]

    xc = xdt.reshape(b, nc, chunk, H, P)
    dAc = dA.reshape(b, nc, chunk, H)
    Bh = B.to(f32).reshape(b, nc, chunk, G, N).repeat_interleave(rep, dim=3)
    Ch = C.to(f32).reshape(b, nc, chunk, G, N).repeat_interleave(rep, dim=3)

    # cumulative decay within a chunk: l[i] = sum_{j<=i} dA[j]
    l = torch.cumsum(dAc, dim=2)                              # [b,nc,Q,H]
    total = l[:, :, -1]                                       # [b,nc,H]

    # intra-chunk: (C_i . B_j) exp(l_i - l_j), masked before the exp
    cb = torch.einsum("bnihN,bnjhN->bnhij", Ch, Bh)           # [b,nc,H,Q,Q]
    seg = (l[:, :, :, None, :] - l[:, :, None, :, :]).permute(0, 1, 4, 2, 3)
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                   device=x.device))
    decay = torch.exp(torch.where(causal, seg, -1e30))
    y_intra = torch.einsum("bnhij,bnjhp->bnihp", cb * decay, xc)

    # chunk states: sum_j exp(total - l_j) B_j (x) x_j
    w = torch.exp(total[:, :, None] - l)                      # [b,nc,Q,H]
    states = torch.einsum("bnjhN,bnjhp,bnjh->bnhpN", Bh, xc, w)

    # inter-chunk recurrence from the carried state
    state = (torch.zeros((b, H, P, N), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    decay_chunk = torch.exp(total)                            # [b,nc,H]
    prev = []
    for n in range(nc):
        prev.append(state)
        state = state * decay_chunk[:, n, :, None, None] + states[:, n]
    prev_states = torch.stack(prev, dim=1)                    # [b,nc,H,P,N]

    y_inter = torch.einsum("bnihN,bnhpN,bnih->bnihp", Ch, prev_states,
                           torch.exp(l))
    y = (y_intra + y_inter).reshape(b, Sp, H, P)[:, :S]
    y = y + d_skip.to(f32)[None, None, :, None] * x[:, :S].to(f32)
    return y.to(x.dtype), state


def ssd_scan(x, dt, a_log, B, C, d_skip, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan; arguments and result as ``ssd_plain``.  On CUDA
    tensors the kernel takes P = 64, d_state N a multiple of 16 up to
    128, a chunk of at most 256, x/B/C in float32 or bfloat16 (one
    dtype) and dt, a_log, d_skip, init_state in float32."""
    operands = [x, dt, a_log, B, C, d_skip]
    if init_state is not None:
        operands.append(init_state)
    if not runs_kernel("ssd_scan", *operands):
        return ssd_plain(x, dt, a_log, B, C, d_skip, chunk, init_state)
    if x.dim() != 4 or B.dim() != 4:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)} and B "
                         f"{tuple(B.shape)} must be 4-d")
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if P != HEAD_DIM or N % 16 or not 0 < N <= MAX_STATE:
        raise ValueError(f"ssd_scan: the kernel takes head_dim {HEAD_DIM} "
                         f"and d_state a multiple of 16 up to {MAX_STATE} "
                         f"(got P={P}, N={N})")
    if not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {chunk} not in 1..{MAX_CHUNK}")
    if (B.shape != (b, S, G, N) or C.shape != B.shape or H % G
            or dt.shape != (b, S, H) or a_log.shape != (H,)
            or d_skip.shape != (H,)):
        raise ValueError("ssd_scan: dt / a_log / B / C / d_skip do not "
                         "match x")
    if B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError("ssd_scan: x, B and C must share one dtype")
    for name, t in (("dt", dt), ("a_log", a_log), ("d_skip", d_skip),
                    ("init_state", init_state)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"ssd_scan: {name} must be float32")
    if init_state is not None and init_state.shape != (b, H, P, N):
        raise ValueError(f"ssd_scan: init_state {tuple(init_state.shape)} "
                         f"is not {(b, H, P, N)}")
    extra = {} if init_state is None else {"init_state": init_state}
    # x, B, C and the state move in 16-byte units; dt, a_log and d_skip
    # are read one element at a time
    check_operands("ssd_scan", x.device, x=x, B=B, C=C, **extra)
    check_operands("ssd_scan", x.device, align=4, dt=dt, a_log=a_log,
                   d_skip=d_skip)
    plan = (plan_launch(b, H, chunk, N, sm_count(x.device))
            if x.dtype == torch.bfloat16 else F32_PLAN)
    return launch(x, dt, a_log, B, C, d_skip, chunk, init_state, *plan)


def launch(x, dt, a_log, B, C, d_skip, chunk: int,
           init_state: Optional[torch.Tensor], p_slice: int, warps: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel on operands ``ssd_scan`` has checked, at
    a given plan (``ssd_scan`` makes it: bf16 one of ``plan_launch``'s,
    float32 ``F32_PLAN``; the kernel refuses any other)."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    y = torch.empty_like(x)
    final = torch.empty((b, H, P, N), dtype=torch.float32, device=x.device)
    SSD_KERNEL(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), B.data_ptr(),
               C.data_ptr(), d_skip.data_ptr(),
               None if init_state is None else init_state.data_ptr(),
               y.data_ptr(), final.data_ptr(), b, S, H, G, N, P, chunk,
               dtype_code(x.dtype), p_slice, warps, device=x.device)
    return y, final
