"""phi-3-vision-4.2b — VLM: phi3-mini backbone + CLIP frontend (stub).

[hf:microsoft/Phi-3-vision-128k-instruct] Backbone: 32L, d_model 3072,
32 heads (kv=32, MHA), d_ff 8192, vocab 32064.  The CLIP/ViT vision
encoder + projector is a STUB — ``input_specs`` provides precomputed
patch embeddings [batch, n_patches, d_model] consumed as prefix tokens.
Full attention only → ``long_500k`` skipped (DESIGN.md §4).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=1e4,
    frontend_dim=3072,             # projected CLIP patch embeddings (stub)
    n_prefix_tokens=576,           # 24×24 patches
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)

REDUCED = ModelConfig(
    name="phi-3-vision-reduced",
    family="vlm",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    d_ff=512,
    vocab_size=512,
    frontend_dim=256,
    n_prefix_tokens=16,
    source="reduced smoke variant",
)
