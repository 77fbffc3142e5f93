"""musicgen-medium — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284] MusicGen medium: 48L, d_model 1536, 24 heads
(kv=24, i.e. MHA), d_ff 6144, vocab 2048 (one EnCodec codebook; the
delay-pattern interleave of the 4 codebooks happens upstream of the
backbone).  The audio frontend (EnCodec conv codec) is a STUB —
``input_specs`` provides precomputed frame embeddings.  A sliding-window
decode variant (window 4096) provides the sub-quadratic path for
``long_500k`` (DESIGN.md §4).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    rope_theta=1e4,
    sliding_window=4096,            # used only by the long_500k shape
    frontend_dim=1536,              # EnCodec frame embeddings (stub)
    n_prefix_tokens=256,
    source="arXiv:2306.05284 (MusicGen medium)",
)

REDUCED = ModelConfig(
    name="musicgen-medium-reduced",
    family="audio",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    d_ff=512,
    vocab_size=512,
    sliding_window=64,
    frontend_dim=256,
    n_prefix_tokens=8,
    source="reduced smoke variant",
)
