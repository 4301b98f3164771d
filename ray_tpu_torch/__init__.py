"""ray_tpu_torch: the PyTorch and CUDA port of ray_tpu, for NVIDIA Hopper.

It mirrors ray_tpu's module paths and names so each piece has a findable
counterpart, and imports neither JAX nor anything of ray_tpu. This slice
serves Llama-family decoders through the continuous-batching engine
(`ray_tpu_torch.serve.llm`); every RMSNorm on a CUDA tensor runs the
hand-written kernel in `csrc/rmsnorm.cu`, built on first use by `_build`.

Entry points run on the card unless the caller passes `device="cpu"`;
with no device given and no card present they raise.
"""

from ray_tpu_torch import exceptions  # noqa: F401
