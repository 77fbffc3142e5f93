"""qwen3-moe-235b-a22b — large MoE, 128 experts top-8.

[hf:Qwen/Qwen3-30B-A3B family, 235B-A22B point] 94L, d_model 4096,
64 heads, 4 kv heads, per-expert d_ff 1536, vocab 151936, 128 experts
top-8, qk_norm.  Full attention only → ``long_500k`` skipped
(DESIGN.md §4).
"""
from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,                     # per-expert hidden size
    vocab_size=151936,
    qk_norm=True,
    head_dim=128,
    rope_theta=1e6,
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=1536),
    source="hf:Qwen/Qwen3-30B-A3B (Qwen3-MoE family, 235B-A22B point)",
)

REDUCED = ModelConfig(
    name="qwen3-moe-reduced",
    family="moe",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    qk_norm=True,
    head_dim=64,
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=128),
    source="reduced smoke variant",
)
