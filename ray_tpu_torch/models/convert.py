"""Convert a JAX parameter tree (as numpy arrays) to the port's layout.

Both packages keep the same keys and the layer-stacked `[L, ...]` layout,
so conversion is leaf by leaf. JAX bfloat16 arrays reach numpy as
`ml_dtypes.bfloat16`, which torch.from_numpy does not take: they pass
through an int16 view of the same bits instead, so every weight lands
bit for bit.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.transformer import TransformerConfig, param_shapes


def _leaf(name: str, arr, shape, dtype: torch.dtype, device) -> torch.Tensor:
    arr = np.array(arr)  # a writable copy: the tensor may share its memory
    if arr.shape != tuple(shape):
        raise ValueError(f"{name} has shape {arr.shape}, the config says "
                         f"{tuple(shape)}")
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, the config says "
                        f"{dtype}")
    return t.to(device)


def params_from_jax(tree: Dict, cfg: TransformerConfig, device=None) -> Dict:
    """`tree`: the JAX `init_params` tree with numpy leaves (e.g. via
    `jax.tree_util.tree_map(np.asarray, params)`). Returns the port's
    parameter dictionary on `device` (the card when none is given)."""
    device = resolve_device(device)
    shapes = param_shapes(cfg)
    top = {k for k in tree if k != "layers"}
    want_top = {k for k in shapes if k != "layers"}
    if top != want_top or set(tree["layers"]) != set(shapes["layers"]):
        raise ValueError(f"tree keys {sorted(top)} / "
                         f"{sorted(tree['layers'])} do not match the config")
    out = {k: _leaf(k, tree[k], shapes[k][0], cfg.dtype, device)
           for k in top}
    out["layers"] = {
        k: _leaf(f"layers/{k}", v, shapes["layers"][k][0], cfg.dtype, device)
        for k, v in tree["layers"].items()}
    return out
