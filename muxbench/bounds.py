"""The yardstick's arithmetic: published peaks of one H100 and the bytes
and FLOPs that a step, or one kernel call, needs at its shapes.

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
# sizes of one model entry
# ---------------------------------------------------------------------------
def ssm_sizes(m: dict) -> Tuple[int, int, int, int, int, int]:
    """(d_inner, heads, head_dim P, d_state N, groups G, conv_dim)."""
    s = m["ssm"]
    di = s["expand"] * m["d_model"]
    G, N = s["n_groups"], s["d_state"]
    return di, di // s["head_dim"], s["head_dim"], N, G, di + 2 * G * N


def layer_matmul_params(m: dict) -> int:
    """Weights one token is multiplied by in one layer (matmuls only)."""
    d = m["d_model"]
    if m["family"] == "ssm":
        di, H, _, N, G, _ = ssm_sizes(m)
        return d * (2 * di + 2 * G * N + H) + di * d
    H, KV, hd, f = m["n_heads"], m["n_kv_heads"], m["head_dim"], m["d_ff"]
    return d * (H + 2 * KV) * hd + H * hd * d + 3 * d * f


def layer_weight_bytes(m: dict, es: int = BF16) -> int:
    """Every weight byte of one layer (norms, biases and the float32
    Mamba2 vectors included)."""
    d = m["d_model"]
    if m["family"] == "ssm":
        di, H, _, _, _, conv = ssm_sizes(m)
        K = m["ssm"]["conv_kernel"]
        return (layer_matmul_params(m) + K * conv + conv + di + d) * es \
            + 3 * H * F32
    n = layer_matmul_params(m) + 2 * d
    if m.get("qkv_bias", False):
        n += (m["n_heads"] + 2 * m["n_kv_heads"]) * m["head_dim"]
    return n * es


def weight_bytes(m: dict, rows: int, es: int = BF16) -> int:
    """Weights one step reads: every layer, the final norm, the output
    matrix over the vocabulary and the embedding rows it looks up (the
    whole table when the output is tied to it)."""
    d, V = m["d_model"], m["vocab_size"]
    out = d * V * es
    embed = 0 if m.get("tie_embeddings", False) else rows * d * es
    return m["n_layers"] * layer_weight_bytes(m, es) + d * es + out + embed


def kv_token_bytes(m: dict, es: int = BF16) -> int:
    """K and V of one token over every layer."""
    if m["family"] == "ssm":
        return 0
    return 2 * m["n_layers"] * m["n_kv_heads"] * m["head_dim"] * es


def ssm_state_bytes(m: dict, es: int = BF16) -> int:
    """One sequence's carried state: the float32 SSM state and the conv
    tail, over every layer."""
    if m["family"] != "ssm":
        return 0
    _, H, P, N, _, conv = ssm_sizes(m)
    K = m["ssm"]["conv_kernel"]
    return m["n_layers"] * (H * P * N * F32 + (K - 1) * conv * es)


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


# ---------------------------------------------------------------------------
# whole steps (one model's rows)
# ---------------------------------------------------------------------------
def decode_step(m: dict, lens: Sequence[int], es: int = BF16
                ) -> Tuple[int, int]:
    """One decode step of one model over rows of ``lens`` tokens (the
    current one included): weights once, the rows' cache read, each
    row's new K/V or state written, logits out."""
    rows, d, V = len(lens), m["d_model"], m["vocab_size"]
    L = m["n_layers"]
    ctx = int(sum(lens))
    n_bytes = weight_bytes(m, rows, es) + rows * V * es
    flops = 2 * rows * (L * layer_matmul_params(m) + d * V)
    if m["family"] == "ssm":
        _, H, P, N, _, conv = ssm_sizes(m)
        K = m["ssm"]["conv_kernel"]
        n_bytes += 2 * rows * ssm_state_bytes(m, es)
        flops += rows * L * (4 * H * P * N + 2 * K * conv)
    else:
        n_bytes += (ctx - rows) * kv_token_bytes(m, es) \
            + rows * kv_token_bytes(m, es)
        flops += L * k1_decode_call(m, lens, es)[1]
    return n_bytes, flops


def chunk_step(m: dict, offs: Sequence[int], clens: Sequence[int],
               fresh: Sequence[bool] = (), es: int = BF16
               ) -> Tuple[int, int]:
    """One chunked-prefill step of one model: row i's ``clens[i]``
    prompt tokens from offset ``offs[i]``; weights once, the cache
    before the chunk read, the chunk's K/V or the state written, the
    logits of each row's last token out."""
    rows, d, V = len(clens), m["d_model"], m["vocab_size"]
    L = m["n_layers"]
    tok = int(sum(clens))
    n_bytes = weight_bytes(m, tok, es) + rows * V * es
    flops = 2 * tok * L * layer_matmul_params(m) + 2 * rows * d * V
    if m["family"] == "ssm":
        _, _, _, _, _, conv = ssm_sizes(m)
        K = m["ssm"]["conv_kernel"]
        carried = sum(1 for f in fresh if not f)
        n_bytes += (carried + rows) * ssm_state_bytes(m, es)
        flops += L * (k4_ssd_call(m, clens, fresh, es)[1]
                      + 2 * K * conv * tok)
    else:
        n_bytes += int(sum(offs)) * kv_token_bytes(m, es) \
            + tok * kv_token_bytes(m, es)
        flops += L * k2_chunk_call(m, offs, clens, es)[1]
    return n_bytes, flops
