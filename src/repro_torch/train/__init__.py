"""Training (port of ``repro/train``): AdamW, the synthetic data
pipeline, the train and eval steps, and checkpoints in the JAX
package's on-disk format."""
from repro_torch.train import checkpoint, data, optimizer, train_step  # noqa: F401
