"""Training backends: how a worker group becomes a distributed group
(the port of ray_tpu/train/backend.py).

Analog of the reference's Backend/BackendConfig ABC (train/backend.py:15,27
with on_start/on_shutdown/on_training_start hooks). The port's backend is
torch.distributed (`train.torch.TorchConfig`, the counterpart of the JAX
package's JaxConfig): a process group over the worker group, NCCL when
the workers hold GPUs and gloo otherwise. `allreduce_gradients` is the
eager data-parallel gradient sync over that group, where the JAX package
uses its "dcn" collective group.
"""

from __future__ import annotations

import time
from dataclasses import dataclass


class Backend:
    def on_start(self, worker_group, backend_config):
        pass

    def on_training_start(self, worker_group, backend_config):
        pass

    def on_shutdown(self, worker_group, backend_config):
        pass

    def on_resize(self, worker_group, backend_config):
        """Rebuild the backend's collective state after an elastic
        resize: the worker group already holds the new ranks/world size
        and a bumped gang epoch."""
        pass


@dataclass
class BackendConfig:
    def backend_cls(self):
        return Backend


def allreduce_gradients(grads, group=None):
    """Mean-allreduce a gradient tree (a tensor, or nested dicts/lists/
    tuples of tensors) across the trainer's torch process group; returns
    a new tree and leaves `grads` as it was. The wall time lands in the
    active step's "collective" phase of the flight recorder."""
    import torch.distributed as dist

    from ray_tpu_torch.train import flight_recorder
    from ray_tpu_torch.train.checkpoint import flatten_tree, unflatten_tree

    t0 = time.perf_counter()
    n = dist.get_world_size(group)
    leaves, spec = flatten_tree(grads)
    out = []
    for leaf in leaves:
        reduced = leaf.detach().clone()
        dist.all_reduce(reduced, op=dist.ReduceOp.SUM, group=group)
        out.append(reduced.div_(n))
    flight_recorder.note_phase("collective", time.perf_counter() - t0)
    return unflatten_tree(spec, out)
