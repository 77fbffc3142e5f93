"""The byte and FLOP counts against hand counts at one shape each, and
each family's weight bytes against the trees the benchmark makes."""
from __future__ import annotations

import json
import math

import pytest

from muxbench import bounds, families, weights
from muxbench.families import dense
from muxbench.harness import HERE

QWEN = json.loads((HERE / "configs" / "qwen2-7b-pair.json").read_text()
                  )["models"]["qwen2-7b"]
MAMBA = json.loads((HERE / "configs" / "qwen2-7b-mamba2.json").read_text()
                   )["models"]["mamba2-2.7b"]


def test_kernel1_decode_call():
    # two rows of 16 and 33 cached tokens, 28 heads of 128 over 4 KV heads
    b, f = bounds.k1_decode_call(QWEN, [16, 33])
    assert b == 2 * 2 * 28 * 128 * 2 + 2 * 49 * 4 * 128 * 2 \
        + (1 + 3) * 4 + 2 * 4
    assert f == 4 * 49 * 28 * 128


def test_kernel2_chunk_call():
    # a 64-token chunk at offset 0 and a 10-token one at offset 128
    b, f = bounds.k2_chunk_call(QWEN, [0, 128], [64, 10])
    keys, pairs = 64 + 138, 64 * 65 // 2 + (10 * 128 + 10 * 11 // 2)
    assert b == 2 * 74 * 28 * 128 * 2 + 2 * keys * 4 * 128 * 2 \
        + (4 + 9) * 4 + 2 * 4
    assert f == 4 * pairs * 28 * 128


def test_kernel3_prefill_call():
    # whole prompts of 64 and 10 tokens from position 0
    b, f = bounds.k3_prefill_call(QWEN, [64, 10])
    assert b == 2 * 74 * 28 * 128 * 2 + 2 * 74 * 4 * 128 * 2
    assert f == 4 * (64 * 65 // 2 + 10 * 11 // 2) * 28 * 128


def test_kernel4_ssd_call():
    # Mamba2-2.7B: 80 heads of 64, d_state 128, one group; a fresh
    # 64-token row and a carried 5-token row
    H, P, N = 80, 64, 128
    b, f = bounds.k4_ssd_call(MAMBA, [64, 5], [True, False])
    assert b == 2 * 69 * H * P * 2 + 69 * H * 4 + 2 * H * 4 \
        + 2 * 69 * N * 2 + 3 * H * P * N * 4
    assert f == H * ((64 * 65 // 2) * (2 * N + 2 * P) + 4 * 64 * P * N
                     + (5 * 6 // 2) * (2 * N + 2 * P) + 4 * 5 * P * N)


@pytest.mark.parametrize("m", [QWEN, MAMBA], ids=["qwen2-7b", "mamba2"])
def test_weight_bytes_match_the_made_tree(m):
    """A step reads every leaf of the tree the benchmark makes, but the
    embedding's unlooked rows and the padded vocabulary's columns."""
    size = {leaf: math.prod(shape) * (4 if leaf in weights.FLOAT32_LEAVES
                                      else 2)
            for _, leaf, shape, _, _ in weights.specs(m)}
    V, d, rows = m["vocab_size"], m["d_model"], 3
    pad = (weights.padded_vocab(V) - V) * d * 2
    want = sum(size.values()) - pad
    if not m.get("tie_embeddings"):
        want += rows * d * 2 - size["embed"]
    assert families.of(m).weight_bytes(m, rows) == want


def test_decode_step_of_the_pair_is_bytes_bound():
    b, f = dense.decode_rows(QWEN, [512] * 16)
    assert b / bounds.PEAK_BYTES > f / bounds.PEAK_FLOPS
    # 14.15 GB of weights (the embedding table aside) and 0.47 GB of cache
    assert 14.0e9 < b < 15.0e9
