"""Shared training configuration objects (the port of
ray_tpu/train/config.py).

Analogs of the reference's ray.air config surface (python/ray/air/config.py):
ScalingConfig (:101), FailureConfig (:377), CheckpointConfig (:427),
RunConfig (:576). ScalingConfig speaks in GPUs: a worker that asks for
them holds its bundle's `GPU` resource.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class ResizePolicy:
    """Bounds on elastic gang resizing (no reference analog — the
    reference restarts; ray_tpu_torch resizes).

    min_world_size: never shrink below this many workers; a reclamation
      that would need more chips falls back to checkpoint-and-restart
      (full eviction).
    resize_cooldown_s: minimum wall seconds between resizes, bounding
      thrash when reclamation pressure flaps.
    grow_back: poll the GCS fence-lift signal after a shrink and grow
      back to the original world size once the claimant releases.
    """

    min_world_size: int = 1
    resize_cooldown_s: float = 0.0
    grow_back: bool = True


@dataclass
class ScalingConfig:
    """How to scale training (reference: air/config.py:101).

    num_workers: worker processes.
    use_gpu / gpus_per_worker: the GPUs each worker holds (resource
      "GPU"; a fraction shares one card).
    mesh: optional parallel.MeshConfig describing the global mesh the
      workers jointly build (parallel.build_mesh over the gang's group).
    elastic: opt into resize-instead-of-restart under partial
      reclamation (requires an elastic-aware loop calling
      train.sync_resize at step boundaries).
    """

    num_workers: int = 1
    use_gpu: bool = False
    gpus_per_worker: float = 1.0
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    mesh: Optional[Any] = None  # parallel.MeshConfig
    # Preemption tier of the gang's placement group: lower-priority gangs
    # are the first evicted when higher-priority demand cannot place.
    priority: int = 0
    elastic: Optional[ResizePolicy] = None

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        if self.use_gpu:
            res.setdefault("GPU", self.gpus_per_worker)
            res.setdefault("CPU", 1.0)
        else:
            res.setdefault("CPU", 1.0)
        return res


@dataclass
class FailureConfig:
    """Trial-level failure handling (reference: air/config.py:377).

    max_failures: gang restarts allowed before fit() gives up.
    fail_fast: never retry, surface the first failure.
    backoff_s / backoff_max_s: exponential backoff between restart
      attempts (attempt k sleeps min(backoff_s * 2**k, backoff_max_s)) —
      a crash-looping gang must not hammer the scheduler. The first
      restart after a clean failure is immediate when backoff_s == 0.
      fit() counts consecutive *no-progress* failures: an attempt that
      reported metrics or registered a checkpoint resets the doubling,
      so a later unrelated failure starts from backoff_s again.
    """

    max_failures: int = 0
    fail_fast: bool = False
    backoff_s: float = 1.0
    backoff_max_s: float = 30.0

    def backoff_for_attempt(self, attempt: int) -> float:
        """Seconds to wait before restart attempt `attempt` (0-based)."""
        if self.backoff_s <= 0:
            return 0.0
        return min(self.backoff_s * (2 ** attempt), self.backoff_max_s)


@dataclass
class CheckpointConfig:
    """Checkpoint retention (reference: air/config.py:427)."""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    checkpoint_frequency: int = 0


@dataclass
class RunConfig:
    """Run-level config (reference: air/config.py:576)."""

    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    verbose: int = 1

    def resolved_storage_path(self) -> str:
        """Local working directory for the run. A URI storage_path
        (file://, s3://, ...) persists through StorageContext instead;
        local scratch still lives under ~/ray_tpu_torch_results."""
        base = self.storage_path or os.path.expanduser("~/ray_tpu_torch_results")
        if "://" in base:
            base = os.path.expanduser("~/ray_tpu_torch_results")
        name = self.name or "run"
        return os.path.join(base, name)

    def storage_context(self):
        """StorageContext for a URI storage_path, else None (reference:
        StorageContext resolution in train/_internal/storage.py:348)."""
        if self.storage_path and "://" in self.storage_path:
            from ray_tpu_torch.train.storage import StorageContext

            return StorageContext(self.storage_path, self.name or "run")
        return None


@dataclass
class Result:
    """Outcome of a training run (reference: ray.air.Result)."""

    metrics: Dict[str, Any]
    checkpoint: Optional["Checkpoint"]  # noqa: F821
    error: Optional[Exception]
    path: Optional[str] = None
    metrics_history: list = field(default_factory=list)
