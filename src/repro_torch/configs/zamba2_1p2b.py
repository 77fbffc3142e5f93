"""zamba2-1.2b — hybrid Mamba2 backbone + shared attention block.

[arXiv:2411.15242] Zamba2-1.2B: 38 Mamba2 layers, d_model 2048, with a
*shared* transformer block (32 heads MHA, d_ff 8192) applied every 6
layers; ssm_state 64.  We model the shared block with tied weights
(Zamba2's per-use LoRA deltas are omitted — noted in DESIGN.md §4).
The attention blocks use a sliding-window KV cache (window 4096) in the
``long_500k`` shape so the cache stays bounded.
"""
from repro_torch.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm=SSMConfig(d_state=64),
    attn_every=6,
    shared_attn=True,
    sliding_window=4096,
    source="arXiv:2411.15242 (Zamba2-1.2B)",
)

REDUCED = ModelConfig(
    name="zamba2-reduced",
    family="hybrid",
    n_layers=4,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    d_ff=512,
    vocab_size=512,
    ssm=SSMConfig(d_state=16, chunk_size=32),
    attn_every=2,
    shared_attn=True,
    sliding_window=64,
    source="reduced smoke variant",
)
