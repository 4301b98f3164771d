"""Ops of the PyTorch port. Counterpart of ray_tpu/ops/__init__.py.

Exports only what is ported: rmsnorm (a hand-written CUDA kernel on a
CUDA tensor, its plain version on a CPU tensor) and the rotary
embeddings. Flash attention and cross-entropy come with the training
slice.
"""

from ray_tpu_torch.ops.rmsnorm import rmsnorm
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies

__all__ = ["rmsnorm", "apply_rope", "rope_frequencies"]
