"""command-r-plus-104b — large dense GQA decoder, no biases.

[hf:CohereForAI/c4ai-command-r-v01 family] 64L, d_model 12288, 96 heads,
8 kv heads, d_ff 33792, vocab 256000, no bias, tied embeddings
(Cohere ties input/output embeddings).  Full attention only →
``long_500k`` skipped (DESIGN.md §4).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    tie_embeddings=True,
    rope_theta=75e4,
    source="hf:CohereForAI/c4ai-command-r-v01 (R+ 104B point)",
)

REDUCED = ModelConfig(
    name="command-r-plus-reduced",
    family="dense",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    tie_embeddings=True,
    source="reduced smoke variant",
)
