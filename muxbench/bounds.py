"""The yardstick's arithmetic: published peaks of one H100, the sizes
every family shares, and the bytes and FLOPs of one call of each kernel
at its shapes.  A whole step's bytes and FLOPs, and which layers call
which kernel, are the family's (``muxbench/families/``).

Copied from the repository's card script (``chip_smoke.bound_ms`` and
the byte and FLOP counts of ``check_kernels`` and ``check_ssd``) and
frozen here.  Every input byte is counted once and every output byte
once, whatever a kernel reads again; the work is what the real rows and
tokens need, not what padded rows cost.  Sizes come from a
configuration file's model entry, never from the program.
"""
from __future__ import annotations

from typing import Sequence, Tuple

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, HBM3 rate
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12

BF16 = 2
F32 = 4
INT32 = 4


def bound_s(n_bytes: float, flops: float) -> float:
    """The least time the chip could take: bytes or FLOPs at its peak,
    whichever is longer."""
    return max(n_bytes / PEAK_BYTES, flops / PEAK_FLOPS)


# ---------------------------------------------------------------------------
# sizes every family shares
# ---------------------------------------------------------------------------
def token_weight_bytes(m: dict, rows: int, es: int = BF16) -> int:
    """The weights outside the layers that one step reads: the final
    norm, the output matrix over the vocabulary and the embedding rows
    it looks up (the whole table when the output is tied to it)."""
    d, V = m["d_model"], m["vocab_size"]
    out = d * V * es
    embed = 0 if m.get("tie_embeddings", False) else rows * d * es
    return d * es + out + embed


def ssm_sizes(m: dict) -> Tuple[int, int, int, int, int, int]:
    """(d_inner, heads, head_dim P, d_state N, groups G, conv_dim) of a
    model entry's ``ssm`` group."""
    s = m["ssm"]
    di = s["expand"] * m["d_model"]
    G, N = s["n_groups"], s["d_state"]
    return di, di // s["head_dim"], s["head_dim"], N, G, di + 2 * G * N


# ---------------------------------------------------------------------------
# kernels, one call (one layer)
# ---------------------------------------------------------------------------
def k1_decode_call(m: dict, lens: Sequence[int], es: int = BF16
                   ) -> Tuple[int, int]:
    """Kernel 1 (paged split-KV decode) over rows of ``lens`` cached
    tokens each (the current token included): q in, out, the rows'
    K/V, the block tables and lengths."""
    H, KV, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    rows, tok = len(lens), int(sum(lens))
    blocks = sum(-(-n // 16) for n in lens)
    n_bytes = 2 * rows * H * hd * es + 2 * tok * KV * hd * es \
        + blocks * INT32 + rows * INT32
    return n_bytes, 4 * tok * H * hd


def k2_chunk_call(m: dict, offs: Sequence[int], clens: Sequence[int],
                  es: int = BF16) -> Tuple[int, int]:
    """Kernel 2 (paged chunk prefill): each row's ``clens`` queries at
    offset ``offs`` attend to the ``offs + clens`` cached keys before
    and in the chunk."""
    H, KV, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q = int(sum(clens))
    keys = int(sum(o + c for o, c in zip(offs, clens)))
    pairs = int(sum(c * o + c * (c + 1) // 2 for o, c in zip(offs, clens)))
    blocks = sum(-(-(o + c) // 16) for o, c in zip(offs, clens))
    n_bytes = 2 * q * H * hd * es + 2 * keys * KV * hd * es \
        + blocks * INT32 + len(offs) * INT32
    return n_bytes, 4 * pairs * H * hd


def k3_prefill_call(m: dict, lens: Sequence[int], es: int = BF16
                    ) -> Tuple[int, int]:
    """Kernel 3 (flash prefill over whole prompts): each row's ``lens``
    queries attend causally to its own ``lens`` keys; q, K and V in,
    out."""
    H, KV, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    tok = int(sum(lens))
    pairs = int(sum(c * (c + 1) // 2 for c in lens))
    n_bytes = 2 * tok * H * hd * es + 2 * tok * KV * hd * es
    return n_bytes, 4 * pairs * H * hd


def k4_ssd_call(m: dict, clens: Sequence[int], fresh: Sequence[bool],
                es: int = BF16) -> Tuple[int, int]:
    """Kernel 4 (chunked SSD scan) over rows of ``clens`` tokens, one
    chunk each: x and y, dt, B and C, A and D, the initial state of
    the rows that carry one and every row's final state."""
    _, H, P, N, G, _ = ssm_sizes(m)
    Q = m["ssm"]["chunk_size"]
    tok = int(sum(clens))
    carried = sum(1 for f in fresh if not f)
    n_bytes = 2 * tok * H * P * es + tok * H * F32 + 2 * H * F32 \
        + 2 * tok * G * N * es + (carried + len(clens)) * H * P * N * F32
    flops = 0
    for c in clens:
        for c0 in range(0, c, Q):
            q = min(Q, c - c0)
            flops += (q * (q + 1) // 2) * (2 * N + 2 * P) + 4 * q * P * N
    return n_bytes, flops * H
