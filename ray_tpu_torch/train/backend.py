"""Training backends: how a worker group becomes a distributed group
(the port of ray_tpu/train/backend.py).

Analog of the reference's Backend/BackendConfig ABC (train/backend.py:15,27
with on_start/on_shutdown/on_training_start hooks). The port's backend is
torch.distributed (`train.torch.TorchConfig`, the counterpart of the JAX
package's JaxConfig): a process group over the worker group, NCCL when
the workers hold GPUs and gloo otherwise, and with `dp_sync="dcn"` (the
default, as the JAX package's) the "train_dp" DCN collective group of
util.collective beside it, rendezvoused under the gang epoch.
`allreduce_gradients` is the eager data-parallel gradient sync: over the
DCN group when given its name (the JAX package's signature), else over
the torch process group.
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


def _init_dcn_group(rank: int, world_size: int, epoch: int = 0):
    """Join the gang's "train_dp" DCN group (rendezvous keys and ident
    frames stamped with the gang epoch)."""
    from ray_tpu_torch.util import collective as col

    col.init_collective_group(world_size, rank, backend="dcn",
                              group_name="train_dp", epoch=epoch)
    return True


def _destroy_dcn_group():
    from ray_tpu_torch.util import collective as col

    col.destroy_collective_group("train_dp")
    return True


def allreduce_gradients(grads, group=None, group_name=None):
    """Mean-allreduce a gradient tree (a tensor, or nested dicts/lists/
    tuples of tensors); returns a new tree, each leaf on its own device,
    and leaves `grads` as it was.

    With a DCN group's name (`allreduce_gradients(grads, "train_dp")`, the
    JAX package's call) each leaf crosses that group, and the op observer
    puts the wall time in the active step's "collective" phase. Otherwise
    the leaves reduce over the torch process group `group` (None: the
    default group), and the function notes the phase itself."""
    if isinstance(group, str):
        group, group_name = None, group
    if group_name is not None:
        return _allreduce_dcn(grads, group_name)
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


def _allreduce_dcn(grads, group_name: str):
    from ray_tpu_torch.train.checkpoint import flatten_tree, unflatten_tree
    from ray_tpu_torch.util import collective as col

    n = col.get_collective_group_size(group_name)
    leaves, spec = flatten_tree(grads)
    return unflatten_tree(spec, [col.allreduce(leaf, group_name) / n
                                 for leaf in leaves])
