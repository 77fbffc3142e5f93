"""mamba2-2.7b — pure SSM (SSD, state-space duality), attention-free.

[arXiv:2405.21060] Mamba2-2.7B: 64 layers, d_model 2560, d_inner 5120,
SSM head_dim 64 (80 heads), d_state 128, vocab 50280.  No attention →
the paper's paged-KV machinery is replaced by the fixed-size SSM state
cache in the unified pool (DESIGN.md §4); ``long_500k`` runs natively
(O(1) decode state).
"""
from repro_torch.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128),
    tie_embeddings=True,
    source="arXiv:2405.21060 (Mamba2-2.7B)",
)

REDUCED = ModelConfig(
    name="mamba2-reduced",
    family="ssm",
    n_layers=2,
    d_model=256,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=512,
    ssm=SSMConfig(d_state=16, chunk_size=32),
    tie_embeddings=True,
    source="reduced smoke variant",
)
