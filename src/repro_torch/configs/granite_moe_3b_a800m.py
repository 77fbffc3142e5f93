"""granite-moe-3b-a800m — MoE decoder, 32 experts top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base family] 32L, d_model 1536,
24 heads, 8 kv heads, per-expert d_ff 512, vocab 49155, 32 experts
top-8.  (The assignment header says "40e"; the explicit note and the
granite model card family say 32 experts — we follow the note, recorded
in DESIGN.md §4.)
"""
from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,                      # per-expert hidden size
    vocab_size=49155,
    moe=MoEConfig(n_experts=32, top_k=8, d_expert=512),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)

REDUCED = ModelConfig(
    name="granite-moe-reduced",
    family="moe",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=128),
    source="reduced smoke variant",
)
