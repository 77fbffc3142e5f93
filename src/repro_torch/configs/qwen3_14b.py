"""qwen3-14b — dense GQA decoder with QK-norm.

[hf:Qwen/Qwen3-8B family] Qwen3-14B: 40L, d_model 5120, 40 heads,
8 kv heads, d_ff 17408, vocab 151936, qk_norm, no attention bias.
Full attention only → ``long_500k`` skipped (DESIGN.md §4).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B (Qwen3 family, 14B point)",
)

REDUCED = ModelConfig(
    name="qwen3-14b-reduced",
    family="dense",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    qk_norm=True,
    source="reduced smoke variant",
)
