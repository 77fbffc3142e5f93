"""Zamba2-style hybrids (arXiv:2411.15242): the Mamba2 mixer in every
layer and, after every ``attn_every`` of them, one shared block of
attention (RoPE, no bias) and a SwiGLU MLP whose single copy of weights
every use reads.  A decode calls kernel 1 in the shared block's uses
only; a whole-prompt prefill calls kernel 4 in every layer and kernel 3
in the shared block's uses.  The port's hybrids prefill whole prompts,
never in chunks."""
from __future__ import annotations

from typing import List

from muxbench import bounds
from muxbench.bounds import BF16, bound_s
from muxbench.families import dense, mamba2
from muxbench.weights import Spec, token_leaves

KERNELS = {"k3": "FlashAddr"}

# the port's ``configs/zamba2_1p2b.REDUCED`` without its sliding window
REDUCED = dict(n_layers=4, d_model=256, n_heads=4, n_kv_heads=4,
               head_dim=64, d_ff=512, vocab_size=512, attn_every=2,
               shared_attn=True,
               ssm=dict(d_state=16, head_dim=64, expand=2, conv_kernel=4,
                        chunk_size=32, n_groups=1))


def leaves(m: dict) -> List[Spec]:
    shared = [("shared_attn", leaf, shape, kind, scale)
              for group, leaf, shape, kind, scale
              in dense.leaves(dict(m, n_layers=1)) if group == "layers"]
    return token_leaves(m) + mamba2.layer_leaves(m) + shared


def n_attn_layers(m: dict) -> int:
    """The shared block's uses: the layers that attend."""
    return m["n_layers"] // m["attn_every"]


def weight_bytes(m: dict, rows: int, es: int = BF16) -> int:
    """Every mixer layer, the shared block once and the token weights."""
    return m["n_layers"] * mamba2.layer_weight_bytes(m, es) \
        + dense.layer_weight_bytes(m, es) \
        + bounds.token_weight_bytes(m, rows, es)


def kv_token_bytes(m: dict, es: int = BF16) -> int:
    """K and V of one token over the layers that attend."""
    return 2 * n_attn_layers(m) * m["n_kv_heads"] * m["head_dim"] * es


def matmul_params(m: dict) -> int:
    """Weights one token is multiplied by in the layers and the shared
    block's uses (the output matrix aside)."""
    return m["n_layers"] * mamba2.layer_matmul_params(m) \
        + n_attn_layers(m) * dense.layer_matmul_params(m)


def decode_rows(m: dict, lens, es: int = BF16):
    rows, d, V = len(lens), m["d_model"], m["vocab_size"]
    A = n_attn_layers(m)
    ctx = int(sum(lens))
    n_bytes = weight_bytes(m, rows, es) + rows * V * es \
        + 2 * rows * mamba2.state_bytes(m, es) \
        + (ctx - rows) * kv_token_bytes(m, es) + rows * kv_token_bytes(m, es)
    flops = 2 * rows * (matmul_params(m) + d * V) \
        + mamba2.decode_flops(m, rows, m["n_layers"]) \
        + A * bounds.k1_decode_call(m, lens, es)[1]
    return n_bytes, flops


def prefill_rows(m: dict, lens, es: int = BF16):
    rows, d, V = len(lens), m["d_model"], m["vocab_size"]
    tok = int(sum(lens))
    n_bytes = weight_bytes(m, tok, es) + rows * V * es \
        + rows * mamba2.state_bytes(m, es) + tok * kv_token_bytes(m, es)
    flops = 2 * tok * matmul_params(m) + 2 * rows * d * V \
        + mamba2.scan_flops(m, lens, [True] * rows, m["n_layers"]) \
        + n_attn_layers(m) * bounds.k3_prefill_call(m, lens, es)[1]
    return n_bytes, flops


def decode(m: dict, parts):
    n_bytes = flops = 0
    lens = []
    for p in parts:
        b, f = decode_rows(m, p["lens"])
        n_bytes, flops = n_bytes + b, flops + f
        lens += p["lens"]
    return n_bytes, flops, {"k1": n_attn_layers(m) * bound_s(
        *bounds.k1_decode_call(m, lens))}


def prefill(m: dict, parts):
    n_bytes = flops = 0
    lens = []
    for p in parts:
        b, f = prefill_rows(m, p["lens"])
        n_bytes, flops = n_bytes + b, flops + f
        lens += p["lens"]
    return n_bytes, flops, {
        "k4": m["n_layers"] * bound_s(
            *bounds.k4_ssd_call(m, lens, [True] * len(lens))),
        "k3": n_attn_layers(m) * bound_s(*bounds.k3_prefill_call(m, lens))}
