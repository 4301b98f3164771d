"""Models of the PyTorch port: the Llama-family decoder's configuration,
parameters and KV-cache generation. Counterpart of ray_tpu/models."""

from ray_tpu_torch.models import configs
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.generate import decode_step, generate, init_kv_cache, prefill
from ray_tpu_torch.models.transformer import TransformerConfig, init_params

__all__ = [
    "TransformerConfig",
    "init_params",
    "params_from_jax",
    "configs",
    "generate",
    "prefill",
    "decode_step",
    "init_kv_cache",
]
