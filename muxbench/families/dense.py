"""Dense GQA decoders (Qwen2): attention with optional QKV bias and a
SwiGLU MLP in every layer.  Decode calls kernel 1 and a chunked prefill
kernel 2 in every layer; a whole-prompt prefill calls kernel 3."""
from __future__ import annotations

import math
from typing import List

from muxbench import bounds
from muxbench.bounds import BF16, bound_s
from muxbench.weights import Spec, token_leaves

# kernel 3 (``flash_prefill.cu``: the tensor-core attention with dense
# addressing)
KERNELS = {"k3": "FlashAddr"}

REDUCED = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
               head_dim=64, d_ff=256, vocab_size=512)


def leaves(m: dict) -> List[Spec]:
    L, d = m["n_layers"], m["d_model"]
    H, KV, hd, f = m["n_heads"], m["n_kv_heads"], m["head_dim"], m["d_ff"]
    out = [("layers", "wq", (L, d, H * hd), "normal", 1 / math.sqrt(d)),
           ("layers", "wk", (L, d, KV * hd), "normal", 1 / math.sqrt(d)),
           ("layers", "wv", (L, d, KV * hd), "normal", 1 / math.sqrt(d)),
           ("layers", "wo", (L, H * hd, d), "normal", 1 / math.sqrt(H * hd))]
    if m.get("qkv_bias", False):
        out += [("layers", "bq", (L, H * hd), "normal", 0.1),
                ("layers", "bk", (L, KV * hd), "normal", 0.1),
                ("layers", "bv", (L, KV * hd), "normal", 0.1)]
    out += [("layers", "w_gate", (L, d, f), "normal", 1 / math.sqrt(d)),
            ("layers", "w_up", (L, d, f), "normal", 1 / math.sqrt(d)),
            ("layers", "w_down", (L, f, d), "normal", 1 / math.sqrt(f)),
            ("layers", "ln1", (L, d), "norm", 0.1),
            ("layers", "ln2", (L, d), "norm", 0.1)]
    return token_leaves(m) + out


# ---------------------------------------------------------------------------
# sizes
# ---------------------------------------------------------------------------
def layer_matmul_params(m: dict) -> int:
    """Weights one token is multiplied by in one layer (matmuls only)."""
    d = m["d_model"]
    H, KV, hd, f = m["n_heads"], m["n_kv_heads"], m["head_dim"], m["d_ff"]
    return d * (H + 2 * KV) * hd + H * hd * d + 3 * d * f


def layer_weight_bytes(m: dict, es: int = BF16) -> int:
    """Every weight byte of one layer (norms and biases included)."""
    n = layer_matmul_params(m) + 2 * m["d_model"]
    if m.get("qkv_bias", False):
        n += (m["n_heads"] + 2 * m["n_kv_heads"]) * m["head_dim"]
    return n * es


def weight_bytes(m: dict, rows: int, es: int = BF16) -> int:
    """Weights one step reads: every layer and the token weights."""
    return m["n_layers"] * layer_weight_bytes(m, es) \
        + bounds.token_weight_bytes(m, rows, es)


def kv_token_bytes(m: dict, es: int = BF16) -> int:
    """K and V of one token over every layer."""
    return 2 * m["n_layers"] * m["n_kv_heads"] * m["head_dim"] * es


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------
def decode_rows(m: dict, lens, es: int = BF16):
    """One engine's decode rows of ``lens`` tokens (the current one
    included): weights once, the rows' cache read, each row's new K/V
    written, logits out."""
    rows, d, V = len(lens), m["d_model"], m["vocab_size"]
    L = m["n_layers"]
    ctx = int(sum(lens))
    n_bytes = weight_bytes(m, rows, es) + rows * V * es
    flops = 2 * rows * (L * layer_matmul_params(m) + d * V)
    n_bytes += (ctx - rows) * kv_token_bytes(m, es) \
        + rows * kv_token_bytes(m, es)
    flops += L * bounds.k1_decode_call(m, lens, es)[1]
    return n_bytes, flops


def chunk_rows(m: dict, offs, clens, es: int = BF16):
    """One engine's chunk rows: row i's ``clens[i]`` prompt tokens from
    offset ``offs[i]``; weights once, the cache before the chunk read,
    the chunk's K/V written, the logits of each row's last token out."""
    rows, d, V = len(clens), m["d_model"], m["vocab_size"]
    L = m["n_layers"]
    tok = int(sum(clens))
    n_bytes = weight_bytes(m, tok, es) + rows * V * es
    flops = 2 * tok * L * layer_matmul_params(m) + 2 * rows * d * V
    n_bytes += int(sum(offs)) * kv_token_bytes(m, es) \
        + tok * kv_token_bytes(m, es)
    flops += L * bounds.k2_chunk_call(m, offs, clens, es)[1]
    return n_bytes, flops


def decode(m: dict, parts):
    n_bytes = flops = 0
    lens = []
    for p in parts:
        b, f = decode_rows(m, p["lens"])
        n_bytes, flops = n_bytes + b, flops + f
        lens += p["lens"]
    kernels = {"k1": m["n_layers"] * bound_s(
        *bounds.k1_decode_call(m, lens))} if lens else {}
    return n_bytes, flops, kernels


def chunk(m: dict, parts):
    n_bytes = flops = 0
    offs, clens = [], []
    for p in parts:
        b, f = chunk_rows(m, p["offs"], p["clens"])
        n_bytes, flops = n_bytes + b, flops + f
        offs += p["offs"]
        clens += p["clens"]
    kernels = {"k2": m["n_layers"] * bound_s(
        *bounds.k2_chunk_call(m, offs, clens))} if clens else {}
    return n_bytes, flops, kernels


def prefill(m: dict, parts):
    """Whole prompts from position 0: a chunk at offset 0 in bytes and
    FLOPs, through kernel 3."""
    n_bytes = flops = 0
    lens = []
    for p in parts:
        b, f = chunk_rows(m, [0] * len(p["lens"]), p["lens"])
        n_bytes, flops = n_bytes + b, flops + f
        lens += p["lens"]
    kernels = {"k3": m["n_layers"] * bound_s(
        *bounds.k3_prefill_call(m, lens))} if lens else {}
    return n_bytes, flops, kernels
