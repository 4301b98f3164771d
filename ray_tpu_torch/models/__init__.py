"""Models of the PyTorch port: the Llama-family decoder's configuration,
parameters, training forward and loss, and KV-cache generation; the
conv family (CNN torsos, ResNet) and the MLP of the RL modules.
Counterpart of ray_tpu/models."""

from ray_tpu_torch.models import configs
from ray_tpu_torch.models.conv import (ATARI_FILTERS, RESNET_CONFIGS,
                                       TINY_FILTERS, ResNetConfig,
                                       cnn_torso_forward, init_cnn_torso,
                                       init_resnet, resnet_forward,
                                       resnet_loss, resnet_param_logical_axes)
from ray_tpu_torch.models.convert import params_from_jax, params_to_numpy
from ray_tpu_torch.models.generate import decode_step, generate, init_kv_cache, prefill
from ray_tpu_torch.models.transformer import (TransformerConfig, forward,
                                              forward_pipelined, init_params,
                                              loss_fn, param_logical_axes)

__all__ = [
    "ResNetConfig",
    "RESNET_CONFIGS",
    "init_resnet",
    "resnet_forward",
    "resnet_loss",
    "resnet_param_logical_axes",
    "init_cnn_torso",
    "cnn_torso_forward",
    "ATARI_FILTERS",
    "TINY_FILTERS",
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
