"""Torch training backend: a torch.distributed process group over the
worker group (the port of ray_tpu/train/torch.py, and the counterpart of
the JAX package's JaxConfig and JaxTrainer).

Analog of the reference's TorchConfig/_TorchBackend
(train/torch/config.py:22,148 — pick a master addr/port, run
dist.init_process_group on every worker) and the prepare_model/
prepare_data_loader helpers (train/torch/train_loop_utils.py:74).

The backend is NCCL when the workers hold GPUs and gloo otherwise. Each
gang epoch rendezvouses at its own `tcp://<rank-0 address>:<port>`, a
port rank 0 picks afresh: a rank left over from a torn-down attempt, or
one resized out, knows only the old address and can never join the new
group. With `dp_sync="dcn"` (the JAX package's JaxConfig default) the
workers also join the "train_dp" DCN collective group, whose rendezvous
keys and ident frames carry the gang epoch (the JAX package's fence,
backend.py:70-92), and whose every op has a deadline; a resize tears it
down and rebuilds it at the new epoch.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

from ray_tpu_torch.train.backend import (Backend, BackendConfig,
                                         _destroy_dcn_group, _init_dcn_group)
from ray_tpu_torch.train.trainer import DataParallelTrainer

logger = logging.getLogger("ray_tpu_torch.train.torch")

# The card index this worker process's NCCL rank is bound to.
_NCCL_DEVICE = [0]


@dataclass
class TorchConfig(BackendConfig):
    """backend: "nccl" or "gloo"; None picks NCCL when each worker holds
    a GPU and gloo otherwise. init_timeout_s bounds the rendezvous and
    every collective of the group. dp_sync: "dcn" (the default) also
    joins a gang of more than one worker to the "train_dp" DCN group
    that `train.allreduce_gradients(grads, "train_dp")` reduces over;
    "none" leaves gradient sync to the process group alone."""

    backend: Optional[str] = None
    init_timeout_s: float = 120.0
    dp_sync: str = "dcn"

    def backend_cls(self):
        return _TorchBackend

    def resolved_backend(self, worker_group) -> str:
        if self.backend:
            return self.backend
        gpus = float(worker_group.resources_per_worker.get("GPU", 0.0))
        return "nccl" if gpus > 0 else "gloo"


class _TorchBackend(Backend):
    def on_start(self, worker_group, backend_config: TorchConfig):
        if len(worker_group) < 1:
            return
        _init_group(worker_group, backend_config)

    def on_shutdown(self, worker_group, backend_config: TorchConfig):
        try:
            worker_group.execute(_torch_process_group_destroy)
        except Exception:  # noqa: BLE001 — workers may already be gone
            logger.debug("torch process-group destroy failed on "
                         "shutdown (workers may already be dead)",
                         exc_info=True)

    def on_resize(self, worker_group, backend_config: TorchConfig):
        """Destroy the groups on every surviving rank, then re-create them
        at the new world size under the bumped gang epoch (a new port, and
        "train_dp" keys of the new epoch), so a departed rank still
        holding the old address can never join (reference:
        _JaxBackend.on_resize, backend.py:99-127)."""
        worker_group.execute(_torch_process_group_destroy)
        _init_group(worker_group, backend_config)


def _init_group(worker_group, cfg: TorchConfig) -> None:
    n = len(worker_group)
    nodes = worker_group.node_ids()
    if len(set(nodes)) <= 1:
        addr = "127.0.0.1"
    else:
        addr = worker_group.execute_single(0, _get_host_ip)
    port = worker_group.execute_single(0, _pick_free_port)
    local_ranks = [nodes[:r].count(nodes[r]) for r in range(n)]
    if cfg.dp_sync not in ("dcn", "none"):
        raise ValueError(f"dp_sync must be 'dcn' or 'none', got "
                         f"{cfg.dp_sync!r}")
    worker_group.execute_with_rank(
        _torch_process_group_init,
        init_method=f"tcp://{addr}:{port}",
        world_size=n,
        backend=cfg.resolved_backend(worker_group),
        timeout_s=cfg.init_timeout_s,
        local_ranks=local_ranks,
        dcn_epoch=(getattr(worker_group, "epoch", 0)
                   if cfg.dp_sync == "dcn" and n > 1 else None),
    )


def _get_host_ip():
    import socket

    return socket.gethostbyname(socket.gethostname())


def _pick_free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _torch_process_group_init(rank: int, init_method: str, world_size: int,
                              backend: str, timeout_s: float,
                              local_ranks, dcn_epoch: Optional[int] = None):
    """Join the process group; with a `dcn_epoch`, the "train_dp" DCN
    group of that gang epoch too."""
    import datetime

    import torch
    import torch.distributed as dist

    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the NCCL process group needs a CUDA device and this worker "
                "sees none; train on the CPU with ScalingConfig(use_gpu="
                "False) or TorchConfig(backend='gloo')")
        # The raylet confines each worker to the cards it holds
        # (CUDA_VISIBLE_DEVICES), so a one-card worker binds cuda:0; a
        # worker that sees the whole host binds its local rank's card.
        _NCCL_DEVICE[0] = local_ranks[rank] % torch.cuda.device_count()
        torch.cuda.set_device(_NCCL_DEVICE[0])
    dist.init_process_group(
        backend=backend,
        init_method=init_method,
        rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    if dcn_epoch is not None:
        _init_dcn_group(rank, world_size, epoch=dcn_epoch)
    return True


def get_device():
    """The device this worker's loop computes on (reference:
    ray.train.torch.get_device): the card the NCCL backend bound the rank
    to; else, whatever the backend, the first card the worker holds when
    it holds one and CUDA sees it; else the CPU (ScalingConfig(use_gpu=
    False), or a GPU faked by init(num_gpus=...) on a host with no
    card)."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch._private.accelerators.gpu import granted_gpu_ids

    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", _NCCL_DEVICE[0])
    if granted_gpu_ids() and torch.cuda.is_available():
        return torch.device("cuda", 0)
    return torch.device("cpu")


def _torch_process_group_destroy():
    """Leave the process group and, where this worker joined it, the
    "train_dp" DCN group."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _destroy_dcn_group()
    return True


def prepare_model(model):
    """Wrap a torch module for data-parallel training (reference:
    train.torch.prepare_model — DDP when world_size > 1)."""
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    if dist.is_initialized() and dist.get_world_size() > 1:
        return DistributedDataParallel(model)
    return model


def prepare_data_loader(loader):
    """Shard a DataLoader across the training workers (reference:
    train.torch.prepare_data_loader — DistributedSampler insertion)."""
    import torch.distributed as dist
    from torch.utils.data import DataLoader
    from torch.utils.data.distributed import DistributedSampler

    if not (dist.is_initialized() and dist.get_world_size() > 1):
        return loader
    sampler = DistributedSampler(loader.dataset)
    return DataLoader(
        loader.dataset,
        batch_size=loader.batch_size,
        sampler=sampler,
        num_workers=0,
        collate_fn=loader.collate_fn,
        drop_last=loader.drop_last,
    )


class TorchTrainer(DataParallelTrainer):
    """DataParallelTrainer on a torch.distributed process group: NCCL
    when ScalingConfig(use_gpu=True), gloo otherwise (reference:
    train/torch/torch_trainer.py TorchTrainer; the JAX package's
    JaxTrainer)."""

    def __init__(self, train_loop_per_worker, *, backend_config=None,
                 **kwargs):
        super().__init__(
            train_loop_per_worker,
            backend_config=backend_config or TorchConfig(),
            **kwargs,
        )
