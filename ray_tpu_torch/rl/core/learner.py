"""Learner: gradient-based policy improvement (the port of
ray_tpu/rl/core/learner.py).

The module lives on one device (the card unless the caller asks for
another) and the update is one backward pass, a clip by global norm
and an Adam step: `optax.chain(clip_by_global_norm(grad_clip),
adam(lr))` in the JAX package. The clip is optax's: every gradient is
scaled by max / norm when the norm is not below max (no epsilon, unlike
`clip_grad_norm_`), and `grad_norm` is the norm before the clip. A loss
is `loss_fn(module, batch) -> (loss, metrics)` over a batch of tensors
on the learner's device; the JAX package's passes (params, module,
batch) because its module holds no parameters.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device


def global_norm(grads) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of every leaf's squares."""
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


def clip_by_global_norm_(grads, max_norm: float, norm: torch.Tensor) -> None:
    """optax.clip_by_global_norm in place: g / norm * max where
    norm >= max, without a host sync."""
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))


def adam(params, lr: float, capturable: bool = False) -> torch.optim.Adam:
    """`optax.adam(lr)`: b1 0.9, b2 0.999, eps 1e-8 (`capturable` keeps
    the step count on the parameters' device, for CUDA graphs)."""
    return torch.optim.Adam(list(params), lr=lr, eps=1e-8,
                            capturable=capturable)


def step(optimizer: torch.optim.Optimizer, params, loss,
         max_norm: Optional[float] = None) -> None:
    """One optimizer step on d loss / d params alone (other leaves the
    loss reaches take no gradient); with `max_norm`, optax's
    clip_by_global_norm ahead of it."""
    params = list(params)
    grads = list(torch.autograd.grad(loss, params))
    if max_norm is not None:
        clip_by_global_norm_(grads, max_norm, global_norm(grads))
    for p, g in zip(params, grads):
        p.grad = g
    optimizer.step()
    for p in params:
        p.grad = None


def readback(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Metric tensors as floats, in one copy to the host."""
    keys = list(metrics)
    vals = torch.stack([metrics[k].float().reshape(()) for k in keys])
    return dict(zip(keys, vals.tolist()))


def to_tensors(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors) on `device`. Arrays read from
    the object store are read-only views; the tensors over them are only
    read (or copied to the card), never written."""
    out = {}
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable.*")
        for k, v in batch.items():
            t = (v if isinstance(v, torch.Tensor)
                 else torch.as_tensor(np.asarray(v)))
            out[k] = t.to(device)
    return out


class Learner:
    def __init__(
        self,
        module,
        loss_fn: Callable,
        optimizer: Optional[Callable] = None,
        seed: int = 0,
        grad_clip: Optional[float] = 0.5,
        lr: float = 3e-4,
        device=None,
    ):
        """optimizer: a factory over the module's parameters (default
        torch.optim.Adam at `lr`, eps 1e-8 as optax.adam's)."""
        self.device = resolve_device(device)
        self.module = module.init(seed).to(self.device)
        self.loss_fn = loss_fn
        self.grad_clip = grad_clip
        self._params = list(self.module.parameters())
        self.optimizer = (optimizer(self._params) if optimizer is not None
                          else torch.optim.Adam(self._params, lr=lr,
                                                eps=1e-8))
        # Optional flight recorder (train.StepProfiler): when set,
        # update_from_batch records each update as one profiled step
        # with its phases: "h2d" (the batch onto the device), "compute"
        # (forward, backward, clip, Adam, fenced) and "readback".
        self.profiler = None

    def _grads(self, batch) -> Tuple[list, Dict]:
        loss, metrics = self.loss_fn(self.module, batch)
        grads = torch.autograd.grad(loss, self._params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self._params, grads)]
        return grads, {k: v.detach() for k, v in metrics.items()}

    def _apply(self, grads) -> None:
        for p, g in zip(self._params, grads):
            p.grad = g
        self.optimizer.step()
        for p in self._params:
            p.grad = None

    def _update(self, batch) -> Dict[str, torch.Tensor]:
        grads, metrics = self._grads(batch)
        gnorm = global_norm(grads)
        if self.grad_clip:
            clip_by_global_norm_(grads, self.grad_clip, gnorm)
        self._apply(grads)
        metrics["grad_norm"] = gnorm
        return metrics

    _readback = staticmethod(readback)

    # -- reference API shape ---------------------------------------------
    def update_from_batch(self, batch: Dict) -> Dict[str, float]:
        prof = self.profiler
        if prof is None:
            return self._readback(
                self._update(to_tensors(batch, self.device)))
        n = len(next(iter(batch.values()))) if batch else None
        with prof.step(samples=n) as s:
            with prof.phase("h2d"):
                tensors = to_tensors(batch, self.device)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            with prof.phase("compute"):
                metrics = self._update(tensors)
            s.fence(metrics)  # the card's remaining work, into "compute"
            with prof.phase("readback"):
                return self._readback(metrics)

    def compute_gradients(self, batch) -> Tuple[list, Dict]:
        grads, metrics = self._grads(to_tensors(batch, self.device))
        return grads, self._readback(metrics)

    def apply_gradients(self, grads) -> None:
        """The optimizer chain (clip, then Adam) over given gradients."""
        grads = [g.to(self.device) for g in grads]
        if self.grad_clip:
            clip_by_global_norm_(grads, self.grad_clip, global_norm(grads))
        self._apply(grads)

    def get_weights(self):
        return self.module.get_weights()

    def set_weights(self, weights):
        self.module.set_weights(weights)

    def get_state(self) -> Dict:
        """Weights (the JAX layout) and Adam's state as numpy arrays."""
        opt = self.optimizer.state_dict()
        return {
            "params": self.get_weights(),
            "opt_state": {
                "state": {i: {k: (v.detach().cpu().numpy().copy()
                                  if isinstance(v, torch.Tensor) else v)
                              for k, v in st.items()}
                          for i, st in opt["state"].items()},
                "param_groups": opt["param_groups"],
            },
        }

    def set_state(self, state: Dict):
        self.set_weights(state["params"])
        opt = state["opt_state"]
        self.optimizer.load_state_dict({
            "state": {int(i): {k: (torch.as_tensor(v)
                                   if isinstance(v, np.ndarray) else v)
                               for k, v in st.items()}
                      for i, st in opt["state"].items()},
            "param_groups": opt["param_groups"],
        })


def minibatch_epochs(update_fn, batch, num_epochs: int, minibatch_size: int,
                     rng) -> Dict:
    """Shuffled minibatch-SGD epochs over a flat batch dict; returns the
    last update's metrics. The shared epoch loop for PPO (and, in the JAX
    package, multi-agent PPO and BC)."""
    n = len(next(iter(batch.values())))
    mb = min(minibatch_size, n)
    metrics: Dict = {}
    for _ in range(num_epochs):
        perm = rng.permutation(n)
        for start in range(0, n - mb + 1, mb):
            idx = perm[start: start + mb]
            metrics = update_fn({k: v[idx] for k, v in batch.items()})
    return metrics
