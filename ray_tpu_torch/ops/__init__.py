"""Ops of the PyTorch port. Counterpart of ray_tpu/ops/__init__.py.

rmsnorm (forward and backward) and flash attention (forward, dq and
dk/dv) run hand-written CUDA kernels on a CUDA tensor and their plain
versions on a CPU tensor; the rotary embeddings and the softmax
cross-entropy are plain PyTorch, as they are plain jnp in the reference.
"""

from ray_tpu_torch.ops.cross_entropy import softmax_cross_entropy
from ray_tpu_torch.ops.flash_attention import flash_attention
from ray_tpu_torch.ops.rmsnorm import rmsnorm
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies

__all__ = ["rmsnorm", "flash_attention", "softmax_cross_entropy",
           "apply_rope", "rope_frequencies"]
