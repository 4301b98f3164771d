"""Weights from the seed, made on the device in the port's stacked-leaf
layout: one normal draw per leaf (ones for the norm weights), each from a
generator of its own, so any leaf can be made again alone and the same
seed always gives the same tensors. The program and the reference are
handed the same draws."""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.yardstick import leaf_shapes


def leaf_seed(seed: int, index: int) -> int:
    return (int(seed) * 1_000_003 + 7919 * (index + 1)) % (2 ** 63)


def make_leaf(dims: Dict, seed: int, name: str, device,
              dtype=torch.bfloat16) -> torch.Tensor:
    shapes = leaf_shapes(dims)
    shape, std = shapes[name]
    if std is None:
        return torch.ones(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, list(shapes).index(name)))
    out = torch.empty(shape, dtype=dtype, device=device)
    return out.normal_(0.0, std, generator=gen)


def make_weights(dims: Dict, seed: int, device,
                 dtype=torch.bfloat16) -> Dict:
    """{"embed", "lm_head", "final_norm", "layers": {...}}, as the port's
    parameter tree."""
    tree: Dict = {"layers": {}}
    for name in leaf_shapes(dims):
        t = make_leaf(dims, seed, name, device, dtype)
        if name.startswith("layers."):
            tree["layers"][name.split(".", 1)[1]] = t
        else:
            tree[name] = t
    return tree


def leaf_names(dims: Dict):
    return list(leaf_shapes(dims))


def get_leaf(tree: Dict, name: str) -> torch.Tensor:
    if name.startswith("layers."):
        return tree["layers"][name.split(".", 1)[1]]
    return tree[name]


def diff_norm(a: torch.Tensor, b: torch.Tensor, chunk: int = 1 << 26) -> float:
    """||a - b|| in float32 arithmetic, a chunk of the flattened leaves at
    a time (no float32 copy of a whole leaf)."""
    a, b = a.detach().reshape(-1), b.detach().reshape(-1)
    total = 0.0
    for s in range(0, a.numel(), chunk):
        total += float((a[s:s + chunk].float() - b[s:s + chunk].float())
                       .double().square().sum())
    return total ** 0.5


def sample_index(dims: Dict, seed: int, name: str, device,
                 k: int = 1 << 16) -> torch.Tensor:
    """k element indices into each layer's slice of a leaf (into the whole
    leaf when it has no layer axis), drawn from the seed: where the check
    compares the program's first gradient with the reference's element by
    element."""
    shape, _ = leaf_shapes(dims)[name]
    numel = math.prod(shape[1:]) if name.startswith("layers.") else \
        math.prod(shape)
    gen = torch.Generator().manual_seed(leaf_seed(seed, 1000 + list(
        leaf_shapes(dims)).index(name)))
    return torch.randint(0, numel, (k,), generator=gen).to(device)


def slices(t: torch.Tensor, name: str):
    """A leaf's per-layer slices (the leaf itself when it has none)."""
    return list(t) if name.startswith("layers.") else [t]
