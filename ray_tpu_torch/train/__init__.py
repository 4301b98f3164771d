"""ray_tpu_torch.train: distributed training on GPU gangs (the port of
ray_tpu/train/).

Public surface mirrors the reference's ray.train/ray.air:
ScalingConfig/RunConfig/FailureConfig/CheckpointConfig/Result,
Checkpoint, TorchTrainer and TorchConfig (where the JAX package has
JaxTrainer and JaxConfig), DataParallelTrainer, and the session API
(report / get_checkpoint / get_dataset_shard / get_world_rank ...).
Importing it loads no torch: the loops and backends import it where they
run, in the training workers.
"""

from ray_tpu_torch.train.backend import Backend, BackendConfig, allreduce_gradients
from ray_tpu_torch.train.checkpoint import (
    AsyncCheckpointer,
    Checkpoint,
    CheckpointManager,
    ShardRemapPlan,
    ShardedState,
)
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    ResizePolicy,
    Result,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.session import (
    ResizeEvent,
    get_checkpoint,
    get_dataset_shard,
    get_local_rank,
    get_session,
    get_trial_dir,
    get_context,
    get_world_rank,
    get_world_size,
    report,
    shard_state,
    should_stop,
    sync_resize,
)
from ray_tpu_torch.train.backend_executor import ResizeError, TrainingFailedError
from ray_tpu_torch.train.flight_recorder import StepProfiler, compute_skew
from ray_tpu_torch.train.trainer import BaseTrainer, DataParallelTrainer
from ray_tpu_torch.train.data_config import DataConfig
from ray_tpu_torch.train import torch  # noqa: F401 — train.torch.TorchTrainer
from ray_tpu_torch.train.torch import TorchConfig, TorchTrainer
from ray_tpu_torch.train.sklearn import SklearnTrainer

__all__ = [
    "Backend",
    "BackendConfig",
    "TorchConfig",
    "allreduce_gradients",
    "AsyncCheckpointer",
    "Checkpoint",
    "CheckpointManager",
    "CheckpointConfig",
    "FailureConfig",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "BaseTrainer",
    "DataParallelTrainer",
    "TorchTrainer",
    "SklearnTrainer",
    "DataConfig",
    "torch",
    "report",
    "get_checkpoint",
    "get_dataset_shard",
    "get_context",
    "get_world_rank",
    "get_world_size",
    "get_local_rank",
    "get_trial_dir",
    "get_session",
    "should_stop",
    "StepProfiler",
    "compute_skew",
    "TrainingFailedError",
    "ResizeError",
    "ResizeEvent",
    "ResizePolicy",
    "ShardRemapPlan",
    "ShardedState",
    "shard_state",
    "sync_resize",
]
