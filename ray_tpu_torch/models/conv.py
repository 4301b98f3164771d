"""Conv model family: CNN torsos and ResNet classifiers (the port of
ray_tpu/models/conv.py).

Activations enter and leave every function in NHWC, as in the JAX
package. A convolution views its NHWC input as NCHW (a channels-last
tensor, no copy), runs `F.conv2d` and views the result back, so the
layout between layers is the card's preferred channels-last one and the
flatten of the torso reads (h, w, c) as the JAX package's does: `proj_w`
keeps its rows in the JAX order.

Conv kernels are OIHW (torch's layout); `rl.core.convert` maps the JAX
package's HWIO kernels to it. Dense weights are (fan_in, fan_out) as in
the JAX package. SAME padding is XLA's: a total of
max((ceil(n/s) - 1) * s + k - n, 0), total // 2 before and the rest
after, so a stride-2 layer may pad one more row after than before
(`F.conv2d(padding="same")` refuses a stride above 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.models.mlp import generator


def init_conv(gen, kh: int, kw: int, cin: int, cout: int,
              dtype=torch.float32) -> Dict:
    """He-initialized conv kernel (OIHW) + bias."""
    fan_in = kh * kw * cin
    w = torch.randn((cout, cin, kh, kw), generator=generator(gen),
                    dtype=torch.float32)
    return {
        "w": (w * (2.0 / fan_in) ** 0.5).to(dtype),
        "b": torch.zeros((cout,), dtype=dtype),
    }


def same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of one spatial dimension under XLA's SAME."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv_forward(p: Dict, x: torch.Tensor, stride: int = 1,
                 padding: str = "SAME") -> torch.Tensor:
    """(B, H, W, Cin) -> (B, H', W', Cout)."""
    w = p["w"]
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        top, bottom = same_pads(x.shape[1], w.shape[2], stride)
        left, right = same_pads(x.shape[2], w.shape[3], stride)
        if top or bottom or left or right:
            xc = F.pad(xc, (left, right, top, bottom))
    elif padding != "VALID":
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    out = F.conv2d(xc, w, p["b"], stride=stride)
    return out.permute(0, 2, 3, 1)


def init_group_norm(c: int, dtype=torch.float32) -> Dict:
    return {"scale": torch.ones((c,), dtype=dtype),
            "bias": torch.zeros((c,), dtype=dtype)}


def group_norm(p: Dict, x: torch.Tensor, groups: int = 8,
               eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over NHWC (groups divide C; falls back to the largest
    divisor <= groups so narrow stems still normalize); the variance is
    the biased one over (H, W, the group's channels)."""
    c = x.shape[-1]
    g = groups
    while c % g:
        g -= 1
    xg = x.reshape(*x.shape[:-1], g, c // g)
    dims = (-4, -3, -1)
    mean = xg.mean(dim=dims, keepdim=True)
    var = xg.var(dim=dims, keepdim=True, correction=0)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    return xg.reshape(x.shape) * p["scale"] + p["bias"]


# ---------------------------------------------------------------------------
# CNN torso (the catalog's conv_filters model)
# ---------------------------------------------------------------------------

# (out_channels, kernel, stride) per layer: the Nature CNN for 84x84
# Atari frames, and a small family for tiny test envs.
ATARI_FILTERS: Tuple[Tuple[int, int, int], ...] = (
    (32, 8, 4), (64, 4, 2), (64, 3, 1),
)
TINY_FILTERS: Tuple[Tuple[int, int, int], ...] = ((16, 3, 2), (32, 3, 2))


def torso_out_hw(obs_shape, conv_filters) -> Tuple[int, int, int]:
    """(h, w, c) of the last conv's output under SAME padding."""
    h, w, c = obs_shape
    for cout, _, stride in conv_filters:
        h, w, c = -(-h // stride), -(-w // stride), cout
    return h, w, c


def init_cnn_torso(gen, obs_shape: Tuple[int, int, int],
                   conv_filters: Sequence[Tuple[int, int, int]],
                   out_dim: int = 256, dtype=torch.float32) -> Dict:
    """Conv stack + flatten + dense projection to a feature vector."""
    gen = generator(gen)
    cin = obs_shape[2]
    convs = []
    for cout, kern, _ in conv_filters:
        convs.append(init_conv(gen, kern, kern, cin, cout, dtype))
        cin = cout
    h, w, c = torso_out_hw(obs_shape, conv_filters)
    flat = h * w * c
    proj = torch.randn((flat, out_dim), generator=gen, dtype=torch.float32)
    return {
        "convs": convs,
        "proj_w": (proj * (2.0 / flat) ** 0.5).to(dtype),
        "proj_b": torch.zeros((out_dim,), dtype=dtype),
    }


def cnn_torso_forward(params: Dict, x: torch.Tensor,
                      conv_filters: Sequence[Tuple[int, int, int]]
                      ) -> torch.Tensor:
    """(B, H, W, C) float obs -> (B, out_dim) features."""
    for p, (_, _, stride) in zip(params["convs"], conv_filters):
        x = torch.relu(conv_forward(p, x, stride=stride))
    x = x.reshape(x.shape[0], -1)  # (h, w, c) order, as the JAX flatten
    return torch.relu(x @ params["proj_w"] + params["proj_b"])


# ---------------------------------------------------------------------------
# ResNet (v2 pre-activation, GroupNorm) classifier
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ResNetConfig:
    """Stage layout. resnet18-style: stage_sizes=(2, 2, 2, 2); cifar
    tests shrink width/stages. num_groups is the GroupNorm group count."""

    num_classes: int = 10
    stage_sizes: Tuple[int, ...] = (2, 2, 2, 2)
    width: int = 64
    stem_kernel: int = 3  # 7 for ImageNet-scale inputs
    stem_stride: int = 1  # 2 for ImageNet-scale inputs
    num_groups: int = 8
    dtype: torch.dtype = torch.float32


# Named presets, as the JAX package's (resnet50 is the 2-conv-per-block
# layout at resnet50's stage depths, as there).
RESNET_CONFIGS = {
    "resnet18-cifar": ResNetConfig(stage_sizes=(2, 2, 2, 2), width=64),
    "resnet18": ResNetConfig(
        num_classes=1000, stage_sizes=(2, 2, 2, 2), width=64,
        stem_kernel=7, stem_stride=2, dtype=torch.bfloat16,
    ),
    "resnet50": ResNetConfig(
        num_classes=1000, stage_sizes=(3, 4, 6, 3), width=64,
        stem_kernel=7, stem_stride=2, dtype=torch.bfloat16,
    ),
}


def _init_block(gen, cin: int, cout: int, cfg: ResNetConfig) -> Dict:
    block = {
        "norm1": init_group_norm(cin, cfg.dtype),
        "conv1": init_conv(gen, 3, 3, cin, cout, cfg.dtype),
        "norm2": init_group_norm(cout, cfg.dtype),
        "conv2": init_conv(gen, 3, 3, cout, cout, cfg.dtype),
    }
    if cin != cout:
        block["proj"] = init_conv(gen, 1, 1, cin, cout, cfg.dtype)
    return block


def init_resnet(gen, cfg: ResNetConfig) -> Dict:
    gen = generator(gen)
    cin = cfg.width
    params: Dict = {
        "stem": init_conv(gen, cfg.stem_kernel, cfg.stem_kernel, 3,
                          cfg.width, cfg.dtype),
        "stages": [],
    }
    for s, n_blocks in enumerate(cfg.stage_sizes):
        cout = cfg.width * (2 ** s)
        stage = []
        for _ in range(n_blocks):
            stage.append(_init_block(gen, cin, cout, cfg))
            cin = cout
        params["stages"].append(stage)
    params["final_norm"] = init_group_norm(cin, cfg.dtype)
    head = torch.randn((cin, cfg.num_classes), generator=gen,
                       dtype=torch.float32)
    params["head_w"] = (head * cin ** -0.5).to(cfg.dtype)
    params["head_b"] = torch.zeros((cfg.num_classes,), dtype=cfg.dtype)
    return params


def _block_forward(p: Dict, x: torch.Tensor, stride: int,
                   cfg: ResNetConfig) -> torch.Tensor:
    """Pre-activation residual block (norm-relu-conv x2)."""
    h = torch.relu(group_norm(p["norm1"], x, cfg.num_groups))
    shortcut = x
    if "proj" in p:
        shortcut = conv_forward(p["proj"], h, stride=stride)
    elif stride != 1:
        shortcut = x[:, ::stride, ::stride, :]
    h = conv_forward(p["conv1"], h, stride=stride)
    h = torch.relu(group_norm(p["norm2"], h, cfg.num_groups))
    h = conv_forward(p["conv2"], h, stride=1)
    return shortcut + h


def resnet_forward(params: Dict, x: torch.Tensor,
                   cfg: ResNetConfig) -> torch.Tensor:
    """(B, H, W, 3) images -> (B, num_classes) logits."""
    x = x.to(cfg.dtype)
    h = conv_forward(params["stem"], x, stride=cfg.stem_stride)
    for s, stage in enumerate(params["stages"]):
        for b, block in enumerate(stage):
            stride = 2 if (b == 0 and s > 0) else 1
            h = _block_forward(block, h, stride, cfg)
    h = torch.relu(group_norm(params["final_norm"], h, cfg.num_groups))
    h = h.mean(dim=(1, 2))  # global average pool
    return h @ params["head_w"] + params["head_b"]


def resnet_loss(params: Dict, batch: Dict, cfg: ResNetConfig):
    """Cross-entropy + accuracy over {"x": images NHWC, "y": labels}."""
    logits = resnet_forward(params, batch["x"], cfg)
    labels = batch["y"].long()
    logp = F.log_softmax(logits.float(), dim=-1)
    loss = -logp.gather(-1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"loss": loss, "accuracy": acc}


def resnet_param_logical_axes(cfg: ResNetConfig) -> Dict:
    """Logical sharding axes mirroring init_resnet's tree: conv kernels
    (OIHW) shard output channels on "heads" (tp) and input channels on
    "embed" (fsdp), the dense head shards classes on "vocab", GroupNorm
    scales replicate: the names parallel.mesh.DEFAULT_RULES maps."""

    def conv_axes():
        return {"w": ("heads", "embed", None, None), "b": ("heads",)}

    def norm_axes():
        return {"scale": (None,), "bias": (None,)}

    stages = []
    cin = cfg.width
    for s, n_blocks in enumerate(cfg.stage_sizes):
        cout = cfg.width * (2 ** s)
        stage = []
        for _ in range(n_blocks):
            block = {"norm1": norm_axes(), "conv1": conv_axes(),
                     "norm2": norm_axes(), "conv2": conv_axes()}
            if cin != cout:
                block["proj"] = conv_axes()
            stage.append(block)
            cin = cout
        stages.append(stage)
    return {
        # RGB input channels (3) are unshardable: the stem shards only
        # its output channels.
        "stem": {"w": ("heads", None, None, None), "b": ("heads",)},
        "stages": stages,
        "final_norm": norm_axes(),
        "head_w": ("embed", "vocab"),
        "head_b": ("vocab",),
    }
