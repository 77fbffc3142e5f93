"""deepseek-coder-33b — dense llama-architecture decoder.

[arXiv:2401.14196] DeepSeek-Coder-33B: 62L, d_model 7168, 56 heads,
8 kv heads (GQA), d_ff 19200, vocab 32256.  Full attention only →
``long_500k`` skipped (DESIGN.md §4).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
    rope_theta=1e5,
    source="arXiv:2401.14196 (DeepSeek-Coder-33B)",
)

REDUCED = ModelConfig(
    name="deepseek-coder-reduced",
    family="dense",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    source="reduced smoke variant",
)
