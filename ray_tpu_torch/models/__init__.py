"""Models of the PyTorch port: the Llama-family decoder's configuration,
parameters, training forward and loss, and KV-cache generation.
Counterpart of ray_tpu/models."""

from ray_tpu_torch.models import configs
from ray_tpu_torch.models.convert import params_from_jax, params_to_numpy
from ray_tpu_torch.models.generate import decode_step, generate, init_kv_cache, prefill
from ray_tpu_torch.models.transformer import (TransformerConfig, forward,
                                              forward_pipelined, init_params,
                                              loss_fn, param_logical_axes)

__all__ = [
    "TransformerConfig",
    "init_params",
    "forward",
    "loss_fn",
    "forward_pipelined",
    "param_logical_axes",
    "params_from_jax",
    "params_to_numpy",
    "configs",
    "generate",
    "prefill",
    "decode_step",
    "init_kv_cache",
]
