"""qwen2-7b — dense GQA decoder with QKV bias.

[arXiv:2407.10671] Qwen2-7B: 28L, d_model 3584, 28 heads, 4 kv heads,
d_ff 18944, vocab 152064.  QKV bias on.  A sliding-window decode
variant (window 4096) is provided so this dense arch also exercises
``long_500k`` (DESIGN.md §4).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    sliding_window=4096,            # long_500k windowed-decode variant
    source="arXiv:2407.10671 (Qwen2-7B)",
)

REDUCED = ModelConfig(
    name="qwen2-7b-reduced",
    family="dense",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    qkv_bias=True,
    sliding_window=64,
    source="reduced smoke variant",
)
