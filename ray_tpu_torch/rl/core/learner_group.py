"""LearnerGroup: one or more learner actors updating in data parallel
(the port of ray_tpu/rl/core/learner_group.py).

Learner actors are placed like Train workers: on the card (the default)
each holds 1/num_learners of one GPU through the raylet, which confines
it with CUDA_VISIBLE_DEVICES, and computes on `_device.resolve_device`;
with device="cpu" a learner holds no GPU. With N learners each takes
1/N of the batch and the gradients cross the port's DCN group
("learner_group") leaf by leaf; card tensors are staged through pinned
host memory there.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch as rt


@rt.remote
class _LearnerActor:
    def __init__(self, module_factory, loss_fn, seed, rank, world_size,
                 lr=3e-4, device=None):
        # The Learner, and with it the card's context, is made on the
        # first call: the actor reports ready at once, and the caller's
        # own timeout bounds that call (a runtime waits 30 s at most for
        # an actor's __init__).
        self._make = (module_factory, loss_fn, seed, lr, device)
        self._learner = None
        self.rank = rank
        self.world_size = world_size

    def _get(self):
        if self._learner is None:
            from ray_tpu_torch.rl.core.learner import Learner

            module_factory, loss_fn, seed, lr, device = self._make
            self._learner = Learner(module_factory(), loss_fn, seed=seed,
                                    lr=lr, device=device)
        return self._learner

    def init_collective(self, world_size, rank, backend, group_name,
                        epoch=0):
        from ray_tpu_torch.util import collective as col

        col.init_collective_group(world_size, rank, backend, group_name,
                                  epoch=epoch)
        self._group = group_name
        return True

    def update(self, batch_shard) -> Dict:
        if self.world_size == 1:
            return self._get().update_from_batch(batch_shard)
        from ray_tpu_torch.util import collective as col

        learner = self._get()
        prof = learner.profiler
        n = len(next(iter(batch_shard.values())))
        with (prof.step(samples=n) if prof is not None
              else contextlib.nullcontext()):
            grads, metrics = learner.compute_gradients(batch_shard)
            # Collective time reaches the profiler's "collective" phase
            # through its op observer.
            reduced = [col.allreduce(g, self._group) / self.world_size
                       for g in grads]
            learner.apply_gradients(reduced)
            if prof is not None and learner.device.type == "cuda":
                torch.cuda.synchronize(learner.device)
        return metrics

    def apply(self, fn):
        """fn(learner) in this actor's process; returns its result."""
        return fn(self._get())

    def get_weights(self):
        return self._get().get_weights()

    def set_weights(self, weights):
        self._get().set_weights(weights)
        return True

    def get_state(self):
        return self._get().get_state()

    def set_state(self, state):
        self._get().set_state(state)
        return True


def _on_card(device) -> bool:
    return device is None or torch.device(device).type == "cuda"


class LearnerGroup:
    def __init__(
        self,
        module_factory,
        loss_fn,
        num_learners: int = 1,
        resources_per_learner: Optional[Dict[str, float]] = None,
        seed: int = 0,
        lr: float = 3e-4,
        device=None,
    ):
        """device: where the learners compute (None: the card, each
        learner holding 1/num_learners of it)."""
        self.num_learners = max(1, num_learners)
        res = dict(resources_per_learner or {"CPU": 1})
        num_cpus = res.pop("CPU", 1)
        num_gpus = res.pop("GPU", 1.0 / self.num_learners
                           if _on_card(device) else 0)
        self.actors = [
            _LearnerActor.options(
                num_cpus=num_cpus, num_gpus=num_gpus, resources=res,
            ).remote(module_factory, loss_fn, seed, i, self.num_learners, lr,
                     device)
            for i in range(self.num_learners)
        ]
        if self.num_learners > 1:
            from ray_tpu_torch.util import collective as col

            # epoch=0: learner gangs are never rebuilt in place — a
            # failed LearnerGroup is recreated wholesale (fresh actors,
            # fresh group name registrations), so no stale rank exists.
            col.create_collective_group(
                self.actors,
                self.num_learners,
                list(range(self.num_learners)),
                backend="dcn",
                group_name="learner_group",
                epoch=0,
            )

    def update_from_batch(self, batch: Dict[str, np.ndarray]) -> Dict:
        """Split the batch across learners; return averaged metrics."""
        if self.num_learners == 1:
            return rt.get(self.actors[0].update.remote(batch), timeout=300)
        shards = _split_batch(batch, self.num_learners)
        all_metrics = rt.get(
            [a.update.remote(s) for a, s in zip(self.actors, shards)],
            timeout=300,
        )
        out: Dict = {}
        for k in all_metrics[0]:
            out[k] = float(np.mean([m[k] for m in all_metrics]))
        return out

    def foreach_learner(self, fn) -> List:
        """fn(learner) on every learner, in its actor's process (the
        reference's foreach_learner): each result, by rank."""
        return rt.get([a.apply.remote(fn) for a in self.actors], timeout=300)

    def get_weights(self):
        return rt.get(self.actors[0].get_weights.remote(), timeout=300)

    def set_weights(self, weights):
        rt.get([a.set_weights.remote(weights) for a in self.actors],
               timeout=300)

    def get_state(self):
        """Optimizer-inclusive learner state (rank 0; replicas are
        identical under data-parallel updates)."""
        return rt.get(self.actors[0].get_state.remote(), timeout=300)

    def set_state(self, state):
        rt.get([a.set_state.remote(state) for a in self.actors], timeout=300)

    def shutdown(self):
        for a in self.actors:
            try:
                rt.kill(a)
            except Exception:  # noqa: BLE001 — already gone
                pass


# Batch entries that are shared per-update state rather than per-sample
# rows (NoisyNet's factorized noise vectors): replicated to every learner
# shard instead of sliced. Explicit by name — a length heuristic would
# misfire when a vector width coincides with the batch size.
SHARED_BATCH_KEYS = frozenset({"eps_in", "eps_out"})


def _split_batch(batch: Dict[str, np.ndarray], n: int) -> List[Dict]:
    size = len(next(
        v for k, v in batch.items() if k not in SHARED_BATCH_KEYS
    ))
    per = size // n
    return [
        {
            k: (v if k in SHARED_BATCH_KEYS
                else v[i * per: (i + 1) * per])
            for k, v in batch.items()
        }
        for i in range(n)
    ]
