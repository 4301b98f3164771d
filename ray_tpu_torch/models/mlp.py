"""Small models for trainer/RL tests: MLP classifier and policy/value nets
(the port of ray_tpu/models/mlp.py).

A parameter tree is a list of {"w": (fan_in, fan_out), "b": (fan_out,)}
layers, the JAX package's layout, so `x @ w + b` is the same product in
both and a JAX tree converts leaf by leaf.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F


def generator(seed_or_gen: Union[int, torch.Generator]) -> torch.Generator:
    """A CPU generator: `seed_or_gen` itself, or a new one seeded with it."""
    if isinstance(seed_or_gen, torch.Generator):
        return seed_or_gen
    return torch.Generator().manual_seed(int(seed_or_gen))


def init_mlp(gen, sizes: Sequence[int], dtype=torch.float32):
    """He-initialized dense layers, drawn on the CPU from `gen` (a
    torch.Generator or a seed)."""
    gen = generator(gen)
    params = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((fan_in, fan_out), generator=gen, dtype=torch.float32)
        params.append({
            "w": (w * (2.0 / fan_in) ** 0.5).to(dtype),
            "b": torch.zeros((fan_out,), dtype=dtype),
        })
    return params


def mlp_forward(params, x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = torch.relu(x)
    return x


def mlp_classifier_loss(params, batch):
    logits = mlp_forward(params, batch["x"])
    labels = batch["y"].long()
    logp = F.log_softmax(logits, dim=-1)
    loss = -logp.gather(-1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"loss": loss, "accuracy": acc}
