"""Weight trees between the JAX package's layout and the port's.

A JAX RL module's parameters are a tree of dicts and lists with numpy
(or jax) leaves; that tree, as numpy arrays, is what `get_weights` and
`set_weights` exchange in both packages, so env runners, learners and
checkpoints move plain arrays. The port keeps the same tree with torch
leaves; the one layout that differs is a conv kernel, HWIO in the JAX
package and OIHW here (every 4-D leaf of these trees is a conv kernel).
Dense weights are (fan_in, fan_out) in both, and the CNN torso flattens
(h, w, c) in both, so `proj_w` needs no permutation.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

_HWIO_TO_OIHW = (3, 2, 0, 1)
_OIHW_TO_HWIO = (2, 3, 1, 0)


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{"a.0.w": leaf, ...}: dict keys and list indices joined by dots."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def unflatten(flat: Dict[str, Any]):
    """The inverse of `flatten`: a level whose keys are all indices is a
    list; a lone "" path is a bare leaf."""
    if set(flat) == {""}:
        return flat[""]
    root: Dict = {}
    for path, leaf in flat.items():
        node = root
        *parents, last = path.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [fix(node[str(i)]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def leaf_from_jax(arr, device=None) -> torch.Tensor:
    """One JAX leaf (numpy, jax or ml_dtypes bf16) as a torch tensor in
    the port's layout."""
    a = np.array(arr)  # a writable copy: the tensor shares its memory
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if t.dim() == 4:
        t = t.permute(*_HWIO_TO_OIHW).contiguous()
    return t if device is None else t.to(device)


def leaf_to_jax(t: torch.Tensor) -> np.ndarray:
    """One port leaf as a numpy array in the JAX layout (bf16 as
    ml_dtypes.bfloat16 with the same bits)."""
    t = t.detach()
    if t.dim() == 4:
        t = t.permute(*_OIHW_TO_HWIO)
    t = t.to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16).copy()
    return t.numpy().copy()


def tree_from_jax(tree, device=None):
    """A JAX weight tree as the port's tree of torch tensors."""
    return unflatten({k: leaf_from_jax(v, device)
                      for k, v in flatten(tree).items()})


def tree_to_jax(tree):
    """The port's tree of tensors as the JAX layout's numpy tree."""
    return unflatten({k: leaf_to_jax(v) for k, v in flatten(tree).items()})


def matched_leaves(ours, theirs) -> List[Tuple[torch.Tensor, Any]]:
    """Pairs of leaves of two trees of one structure; raises where the
    paths or the shapes differ."""
    a, b = flatten(ours), flatten(theirs)
    if set(a) != set(b):
        raise ValueError(f"weight trees differ: {sorted(set(a) ^ set(b))}")
    pairs = []
    for k, t in a.items():
        if tuple(t.shape) != tuple(b[k].shape):
            raise ValueError(f"{k} has shape {tuple(b[k].shape)}, the "
                             f"module holds {tuple(t.shape)}")
        pairs.append((t, b[k]))
    return pairs



def find_adam(opt_state):
    """The Adam moments of an optimizer state as {"count", "mu", "nu"}:
    optax's ScaleByAdamState anywhere in the JAX package's chain (a
    clip ahead of Adam, the learning-rate scale after it), or the
    port's own dict of those keys. None where there is none."""
    if isinstance(opt_state, dict):
        return opt_state if {"count", "mu", "nu"} <= set(opt_state) else None
    if all(hasattr(opt_state, k) for k in ("count", "mu", "nu")):
        return {"count": opt_state.count, "mu": opt_state.mu,
                "nu": opt_state.nu}
    if isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            found = find_adam(part)
            if found is not None:
                return found
    return None


def load_adam(optimizer: torch.optim.Optimizer, params: Dict[str, Any],
              opt_state) -> None:
    """Load Adam's moments into a `torch.optim.Adam` over `params` (flat
    path -> parameter, the paths of the moments' tree): mu is exp_avg,
    nu exp_avg_sq and count the step, as optax counts it."""
    adam = find_adam(opt_state)
    if adam is None:
        raise ValueError("the optimizer state holds no Adam moments")
    mu, nu = flatten(adam["mu"]), flatten(adam["nu"])
    if set(mu) != set(params) or set(nu) != set(params):
        raise ValueError(f"Adam's moments {sorted(mu)} do not match the "
                         f"parameters {sorted(params)}")
    step = torch.tensor(float(np.asarray(adam["count"])))
    on_device = optimizer.defaults.get("capturable", False)
    for k, p in params.items():
        optimizer.state[p] = {
            "step": step.to(p.device) if on_device else step.clone(),
            "exp_avg": leaf_from_jax(mu[k], p.device).to(p.dtype),
            "exp_avg_sq": leaf_from_jax(nu[k], p.device).to(p.dtype)}


def adam_to_jax(optimizer: torch.optim.Optimizer,
                params: Dict[str, Any]) -> Dict[str, Any]:
    """A `torch.optim.Adam`'s state over `params` as {"count", "mu",
    "nu"} in the JAX layout (zeros before the first step, as optax's
    init)."""
    mu, nu, count = {}, {}, 0
    for k, p in params.items():
        st = optimizer.state.get(p) or {}
        if st:
            count = int(float(st["step"]))
        mu[k] = leaf_to_jax(st["exp_avg"]) if st else \
            np.zeros(tuple(p.shape), np.float32)
        nu[k] = leaf_to_jax(st["exp_avg_sq"]) if st else \
            np.zeros(tuple(p.shape), np.float32)
    return {"count": np.asarray(count, np.int32), "mu": unflatten(mu),
            "nu": unflatten(nu)}
