"""Mamba2 (arXiv:2405.21060): the SSD mixer in every layer, the output
tied to the embedding.  A chunked or whole-prompt prefill calls kernel 4
in every layer; a decode steps the float32 state with no kernel of the
port's own."""
from __future__ import annotations

import math
from typing import List

from muxbench import bounds
from muxbench.bounds import BF16, F32, bound_s
from muxbench.weights import Spec, token_leaves

KERNELS: dict = {}

REDUCED = dict(n_layers=2, d_model=128, vocab_size=512,
               ssm=dict(d_state=16, head_dim=64, expand=2, conv_kernel=4,
                        chunk_size=32, n_groups=1))


def layer_leaves(m: dict) -> List[Spec]:
    """The mixer's leaves of every layer, and its pre-norm."""
    L, d = m["n_layers"], m["d_model"]
    s = m["ssm"]
    di = s["expand"] * d
    H, N, G, K = di // s["head_dim"], s["d_state"], s["n_groups"], \
        s["conv_kernel"]
    conv = di + 2 * G * N
    return [("layers", "in_proj", (L, d, 2 * di + 2 * G * N + H), "normal",
             1 / math.sqrt(d)),
            ("layers", "conv_w", (L, K, conv), "normal", 0.2),
            ("layers", "conv_b", (L, conv), "normal", 0.1),
            ("layers", "a_log", (L, H), "a_log", 0.0),
            ("layers", "dt_bias", (L, H), "dt_bias", 0.0),
            ("layers", "d_skip", (L, H), "norm", 0.1),
            ("layers", "gnorm", (L, di), "norm", 0.1),
            ("layers", "out_proj", (L, di, d), "normal", 1 / math.sqrt(di)),
            ("layers", "ln1", (L, d), "norm", 0.1)]


def leaves(m: dict) -> List[Spec]:
    return token_leaves(m) + layer_leaves(m)


# ---------------------------------------------------------------------------
# sizes (one mixer layer)
# ---------------------------------------------------------------------------
def layer_matmul_params(m: dict) -> int:
    """Weights one token is multiplied by in one layer (matmuls only)."""
    d = m["d_model"]
    di, H, _, N, G, _ = bounds.ssm_sizes(m)
    return d * (2 * di + 2 * G * N + H) + di * d


def layer_weight_bytes(m: dict, es: int = BF16) -> int:
    """Every weight byte of one layer (the norms and the float32 vectors
    included)."""
    d = m["d_model"]
    di, H, _, _, _, conv = bounds.ssm_sizes(m)
    K = m["ssm"]["conv_kernel"]
    return (layer_matmul_params(m) + K * conv + conv + di + d) * es \
        + 3 * H * F32


def weight_bytes(m: dict, rows: int, es: int = BF16) -> int:
    """Weights one step reads: every layer and the token weights."""
    return m["n_layers"] * layer_weight_bytes(m, es) \
        + bounds.token_weight_bytes(m, rows, es)


def layer_state_bytes(m: dict, es: int = BF16) -> int:
    """One sequence's carried state in one layer: the float32 SSM state
    and the conv tail."""
    _, H, P, N, _, conv = bounds.ssm_sizes(m)
    K = m["ssm"]["conv_kernel"]
    return H * P * N * F32 + (K - 1) * conv * es


def state_bytes(m: dict, es: int = BF16) -> int:
    """One sequence's carried state over every layer."""
    return m["n_layers"] * layer_state_bytes(m, es)


def decode_flops(m: dict, rows: int, layers: int) -> int:
    """The state update and the conv of ``rows`` tokens in ``layers``
    mixer layers (no weights)."""
    _, H, P, N, _, conv = bounds.ssm_sizes(m)
    K = m["ssm"]["conv_kernel"]
    return rows * layers * (4 * H * P * N + 2 * K * conv)


def scan_flops(m: dict, clens, fresh, layers: int) -> int:
    """The SSD scan and the conv of rows of ``clens`` tokens in
    ``layers`` mixer layers (no weights)."""
    _, _, _, _, _, conv = bounds.ssm_sizes(m)
    K = m["ssm"]["conv_kernel"]
    return layers * (bounds.k4_ssd_call(m, clens, fresh)[1]
                     + 2 * K * conv * int(sum(clens)))


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------
def decode_rows(m: dict, rows: int, es: int = BF16):
    """One engine's ``rows`` decode rows: weights once, each row's state
    read and written, logits out."""
    d, V, L = m["d_model"], m["vocab_size"], m["n_layers"]
    n_bytes = weight_bytes(m, rows, es) + rows * V * es \
        + 2 * rows * state_bytes(m, es)
    flops = 2 * rows * (L * layer_matmul_params(m) + d * V) \
        + decode_flops(m, rows, L)
    return n_bytes, flops


def chunk_rows(m: dict, clens, fresh, es: int = BF16):
    """One engine's chunk rows of ``clens`` tokens: weights once, the
    carried state read (rows not ``fresh``) and every row's written, the
    logits of each row's last token out."""
    rows, d, V = len(clens), m["d_model"], m["vocab_size"]
    L = m["n_layers"]
    tok = int(sum(clens))
    carried = sum(1 for f in fresh if not f)
    n_bytes = weight_bytes(m, tok, es) + rows * V * es \
        + (carried + rows) * state_bytes(m, es)
    flops = 2 * tok * L * layer_matmul_params(m) + 2 * rows * d * V \
        + scan_flops(m, clens, fresh, L)
    return n_bytes, flops


def _scan(m: dict, parts, clens_key: str, fresh_of):
    n_bytes = flops = 0
    clens, fresh = [], []
    for p in parts:
        b, f = chunk_rows(m, p[clens_key], fresh_of(p))
        n_bytes, flops = n_bytes + b, flops + f
        clens += p[clens_key]
        fresh += fresh_of(p)
    kernels = {"k4": m["n_layers"] * bound_s(
        *bounds.k4_ssd_call(m, clens, fresh))} if clens else {}
    return n_bytes, flops, kernels


def decode(m: dict, parts):
    n_bytes = flops = 0
    for p in parts:
        b, f = decode_rows(m, p["rows"])
        n_bytes, flops = n_bytes + b, flops + f
    return n_bytes, flops, {}


def chunk(m: dict, parts):
    return _scan(m, parts, "clens", lambda p: list(p["fresh"]))


def prefill(m: dict, parts):
    """Whole prompts: a chunk of every row from a zero state."""
    return _scan(m, parts, "lens", lambda p: [True] * len(p["lens"]))
