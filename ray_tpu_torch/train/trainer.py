"""Trainers: BaseTrainer → DataParallelTrainer (the port of
ray_tpu/train/trainer.py; `train.torch.TorchTrainer` takes the place of
the JAX package's JaxTrainer).

Analogs of the reference's BaseTrainer (train/base_trainer.py:74, fit()
:579) and DataParallelTrainer (train/data_parallel_trainer.py:26,
training_loop :432). Differences by design:

  * fit() drives the BackendExecutor directly with an inline result loop;
    `as_trainable()` adapts the trainer for the Tune controller instead of
    the reference's always-through-Tune layering (base_trainer.py:839).
  * TorchTrainer (train/torch.py) runs the loop on a torch.distributed
    process group: NCCL when the workers hold GPUs, gloo otherwise.
  * `datasets=` takes datasets of ray_tpu_torch.data: each split one
    reaches the workers as streaming_split DataIterators (DataConfig),
    re-split when an elastic resize changes the gang, and a worker feeds
    its card with `get_dataset_shard(name).iter_torch_batches()`.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.train.backend import BackendConfig
from ray_tpu_torch.train.backend_executor import (
    BackendExecutor,
    ResizeError,
    TrainingFailedError,
)
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    ResizePolicy,
    Result,
    RunConfig,
    ScalingConfig,
)

logger = logging.getLogger("ray_tpu_torch.train")


def _fault_metrics():
    """train_restarts_total / train_worker_deaths_total /
    train_recovery_seconds — created on first fit() (not import) so
    merely importing the trainer doesn't start the metrics flusher."""
    from ray_tpu_torch.util import metrics as rt_metrics

    return (
        rt_metrics.get_or_create(
            rt_metrics.Counter, "train_restarts_total",
            "Gang restarts performed by fit() after retryable failures.",
        ),
        rt_metrics.get_or_create(
            rt_metrics.Counter, "train_worker_deaths_total",
            "Training worker ranks observed dead or unreachable.",
        ),
        rt_metrics.get_or_create(
            rt_metrics.Histogram, "train_recovery_seconds",
            "Seconds from gang teardown to the rebuilt gang being ready.",
        ),
    )


def _skew_metrics():
    """Flight-recorder driver-side metrics: cross-rank step skew and the
    current straggler rank (lazy, same reason as _fault_metrics)."""
    from ray_tpu_torch.util import metrics as rt_metrics

    return (
        rt_metrics.get_or_create(
            rt_metrics.Histogram, "train_step_skew_seconds",
            "Cross-rank skew: slowest minus fastest rank's mean step "
            "wall time, per trainer poll.",
            boundaries=rt_metrics.LATENCY_BOUNDARIES,
        ),
        rt_metrics.get_or_create(
            rt_metrics.Gauge, "train_straggler_rank",
            "Rank with the highest mean step wall time right now.",
        ),
    )


class _ResizeGovernor:
    """Applies a ResizePolicy to resize decisions: floors the shrink at
    min_world_size, spaces resizes by resize_cooldown_s (thrash bound
    when reclamation pressure flaps), and drives grow-back toward the
    configured world size. The clock is injectable for deterministic
    tests."""

    def __init__(self, policy: ResizePolicy, baseline_world: int,
                 clock: Callable[[], float] = time.monotonic):
        self.policy = policy
        self.baseline = baseline_world
        self.clock = clock
        self._last_resize_t: Optional[float] = None

    def shrink_target(self, world: int, draining_count: int) -> Optional[int]:
        """World size to shrink to, or None when the policy forbids it
        (caller falls back to checkpoint-and-restart migration)."""
        target = world - draining_count
        if target < max(1, self.policy.min_world_size):
            return None
        if not self._cooled_down():
            return None
        return target

    def want_grow(self, world: int) -> bool:
        return (self.policy.grow_back and world < self.baseline
                and self._cooled_down())

    def note_resized(self):
        self._last_resize_t = self.clock()

    def _cooled_down(self) -> bool:
        if self._last_resize_t is None:
            return True
        return (self.clock() - self._last_resize_t
                >= self.policy.resize_cooldown_s)


def _mean_breakdown(records: List[Dict]) -> Dict[str, float]:
    """Average the per-phase seconds over a batch of step records."""
    out: Dict[str, float] = {}
    for rec in records:
        for k, v in rec.items():
            if (k.endswith("_s") and k != "tokens_per_s"
                    and isinstance(v, (int, float))):
                out[k] = out.get(k, 0.0) + v
    n = len(records)
    return {k: round(v / n, 6) for k, v in out.items()}


class BaseTrainer:
    def __init__(
        self,
        *,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
    ):
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.resume_from_checkpoint = resume_from_checkpoint

    def fit(self) -> Result:
        raise NotImplementedError

    def as_trainable(self):
        """Adapt this trainer into a Tune trainable (reference:
        base_trainer.py:839)."""
        trainer = self

        def trainable(config, session):
            import copy

            t = copy.copy(trainer)
            merged = dict(getattr(t, "train_loop_config", None) or {})
            merged.update(config)
            t.train_loop_config = merged
            result = t.fit()
            if result.error:
                raise result.error
            session.report(result.metrics, checkpoint=result.checkpoint)

        if hasattr(trainer, "_tune_resources"):
            # tune.with_resources pinned per-trial resources on the
            # trainer; carry them onto the closure the Tuner consumes.
            trainable._tune_resources = trainer._tune_resources
        return trainable


class DataParallelTrainer(BaseTrainer):
    """SPMD training: the same loop on every worker of the gang."""

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict] = None,
        backend_config: Optional[BackendConfig] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        dataset_config: Optional["DataConfig"] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
    ):
        super().__init__(
            scaling_config=scaling_config,
            run_config=run_config,
            resume_from_checkpoint=resume_from_checkpoint,
        )
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config or {}
        self.backend_config = backend_config or BackendConfig()
        self.datasets = datasets or {}
        from ray_tpu_torch.train.data_config import DataConfig

        self.dataset_config = dataset_config or DataConfig()

    def fit(self) -> Result:
        """Run training with gang fault tolerance.

        ONE executor lives for the whole fit: a retryable failure
        (worker death, collective timeout, drain preemption) tears the
        gang down and rebuilds it via executor.restart() at the next
        gang epoch, resuming from the newest checkpoint with exponential
        backoff between attempts (reference: TrainingIterator retry +
        _restart backend_executor.py:701).
        """
        failure_config = self.run_config.failure_config
        attempts = max(1, failure_config.max_failures + 1)
        restarts, deaths, recovery = _fault_metrics()
        last_error: Optional[Exception] = None
        checkpoint = self.resume_from_checkpoint

        trial_dir = self.run_config.resolved_storage_path()
        os.makedirs(trial_dir, exist_ok=True)
        self._trial_dir = trial_dir
        ckpt_config = self.run_config.checkpoint_config
        # One manager across attempts: restarts must find (and keep
        # scoring against) the checkpoints earlier attempts registered.
        manager = CheckpointManager(
            os.path.join(trial_dir, "checkpoints"),
            num_to_keep=ckpt_config.num_to_keep,
            score_attribute=ckpt_config.checkpoint_score_attribute,
            score_order=ckpt_config.checkpoint_score_order,
            storage=self.run_config.storage_context(),
        )
        self._latest_checkpoint = None
        # Survive across attempts so an exhausted-retries Result still
        # carries everything that was reported before the last failure.
        self._final_metrics: Dict = {}
        self._metrics_history: List[Dict] = []
        # Flight recorder: latest cumulative step stats per rank (from
        # poll) and the skew/straggler view computed from them.
        self._rank_step_stats: List[Optional[Dict]] = []
        self._step_skew: Optional[Dict] = None

        executor = BackendExecutor(self.backend_config, self.scaling_config)
        # Backoff counter is decoupled from the retry budget: an attempt
        # that made progress (new reports or a fresh checkpoint) proves
        # the cluster recovered, so a later unrelated failure backs off
        # from backoff_s again instead of the doubled-up tail.
        backoff_attempt = 0
        try:
            executor.start()
            for attempt in range(attempts):
                hist_before = len(self._metrics_history)
                ckpt_before = self._latest_checkpoint
                try:
                    return self._run_attempt(
                        executor, manager, checkpoint, trial_dir
                    )
                except TrainingFailedError as e:
                    last_error = e
                    if e.failed_ranks:
                        deaths.inc(len(e.failed_ranks))
                    if (failure_config.fail_fast or not e.retryable
                            or attempt + 1 >= attempts):
                        break
                    if (len(self._metrics_history) > hist_before
                            or self._latest_checkpoint is not ckpt_before):
                        backoff_attempt = 0
                    # Resume from the newest checkpoint (reference:
                    # _restart backend_executor.py:701).
                    checkpoint = self._latest_checkpoint or checkpoint
                    backoff = failure_config.backoff_for_attempt(
                        backoff_attempt)
                    backoff_attempt += 1
                    if backoff:
                        time.sleep(backoff)
                    t0 = time.monotonic()
                    try:
                        executor.restart()
                    except TrainingFailedError as e2:
                        # Restart itself failed (e.g. the old placement
                        # group's release could not be confirmed —
                        # respawning would leak a gang of chips).
                        last_error = e2
                        break
                    restarts.inc()
                    recovery.observe(time.monotonic() - t0)
        finally:
            executor.shutdown()
        return Result(
            metrics=self._final_metrics,
            checkpoint=manager.best_checkpoint() or self._latest_checkpoint,
            error=last_error,
            path=self._trial_dir,
            metrics_history=self._metrics_history,
        )

    def _ingest(self, statuses, manager: CheckpointManager):
        """Fold polled worker reports into metrics/checkpoint state.
        Rank-0 reports carry the canonical metrics (reference:
        first-worker results in TrainingIterator); every rank's
        checkpoints are registered (the drain path checkpoints on
        whichever ranks got the stop request first)."""
        from ray_tpu_torch.train import flight_recorder

        for rank, st in enumerate(statuses):
            for rep in st["reports"]:
                if rank == 0:
                    entry = dict(rep["metrics"])
                    recs = rep.get("step_records")
                    if recs:
                        # Per-phase step breakdown (mean over the steps
                        # this report covers) lands in metrics_history.
                        entry["train_step_breakdown"] = _mean_breakdown(recs)
                    self._final_metrics = entry
                    self._metrics_history.append(entry)
                if rep["checkpoint_path"]:
                    ckpt = Checkpoint.from_directory(rep["checkpoint_path"])
                    manager.register(ckpt, rep["metrics"])
                    self._latest_checkpoint = ckpt
        # Cross-rank straggler attribution from the per-rank cumulative
        # step stats each poll carries.
        stats = [st.get("step_stats") for st in statuses]
        if any(s for s in stats):
            self._rank_step_stats = stats
            skew = flight_recorder.compute_skew(stats)
            if skew is not None:
                self._step_skew = skew
                skew_hist, straggler_gauge = _skew_metrics()
                skew_hist.observe(skew["skew_s"])
                straggler_gauge.set(float(skew["straggler_rank"]))
        if self._metrics_history and self._step_skew is not None:
            # Enrich the newest history entry (same dict object as
            # _final_metrics) so Result names the straggler. Refreshed
            # every poll, not just on appends: a fast rank can drain all
            # its reports before the straggler completes a single step,
            # and the skew only becomes computable on a LATER poll.
            self._metrics_history[-1].update({
                "train_step_skew_s": round(self._step_skew["skew_s"], 6),
                "train_straggler_rank": self._step_skew["straggler_rank"],
                "train_step_wall_by_rank":
                    self._step_skew["mean_step_s_by_rank"],
                "train_straggler_breakdown":
                    self._step_skew["straggler_breakdown"],
            })

    def _run_attempt(
        self,
        executor: BackendExecutor,
        manager: CheckpointManager,
        checkpoint: Optional[Checkpoint],
        trial_dir: str,
    ) -> Result:
        dataset_shards = self._shard_datasets(self.scaling_config.num_workers)
        policy = self.scaling_config.elastic
        governor = (
            _ResizeGovernor(policy, self.scaling_config.num_workers)
            if policy is not None else None
        )
        try:
            executor.start_training(
                self.train_loop_per_worker,
                self.train_loop_config,
                checkpoint,
                trial_dir,
                dataset_shards,
            )
            while True:
                statuses = executor.poll()
                self._ingest(statuses, manager)
                for rank, st in enumerate(statuses):
                    if st["error"]:
                        raise TrainingFailedError(
                            st["error"], failed_ranks=[rank], retryable=True
                        )
                if all(st["done"] for st in statuses):
                    self._ingest(executor.poll(), manager)  # final drain
                    break
                draining = executor.draining_ranks()
                draining &= set(range(executor.world_size))
                if draining:
                    # Elastic-first: shed exactly the claimed ranks and
                    # keep training; checkpoint-and-restart only when
                    # the policy forbids the shrink or the gang's loop
                    # turns out not to be elastic-aware.
                    target = (
                        governor.shrink_target(executor.world_size,
                                               len(draining))
                        if governor is not None else None
                    )
                    new_shards = (
                        self._elastic_resize(executor, target,
                                             sorted(draining))
                        if target is not None else None
                    )
                    if new_shards is not None:
                        governor.note_resized()
                        self._stop_shards(dataset_shards)
                        dataset_shards = (new_shards
                                          if new_shards != [] else None)
                    else:
                        self._migrate_before_preemption(
                            executor, manager, draining
                        )
                elif (governor is not None
                      and governor.want_grow(executor.world_size)
                      and executor.fence_lifted()):
                    # The partial-reclamation claimant released the
                    # chips: grow back without a restart.
                    new_shards = self._elastic_resize(
                        executor, governor.baseline)
                    if new_shards is not None:
                        governor.note_resized()
                        self._stop_shards(dataset_shards)
                        dataset_shards = (new_shards
                                          if new_shards != [] else None)
                time.sleep(0.05)
        finally:
            self._stop_shards(dataset_shards)
        return Result(
            metrics=self._final_metrics,
            checkpoint=manager.best_checkpoint() or self._latest_checkpoint,
            error=None,
            path=trial_dir,
            metrics_history=self._metrics_history,
        )

    def _elastic_resize(self, executor, target: int,
                        departing: Optional[List[int]] = None):
        """Resize the gang in place, rebalancing data shards at the
        boundary. Returns the new shard list on success ([] when the run
        has no datasets), or None when the resize could not complete —
        the gang is unchanged and the caller falls back to the
        checkpoint-and-restart path."""
        new_shards = self._shard_datasets(target)
        try:
            executor.resize(target, departing_ranks=departing,
                            dataset_shards=new_shards)
        except ResizeError as e:
            logger.warning(
                "elastic resize to %d worker(s) failed (%s); falling "
                "back to checkpoint-and-restart", target, e,
            )
            self._stop_shards(new_shards)
            return None
        return new_shards if new_shards is not None else []

    def _migrate_before_preemption(self, executor, manager, draining):
        """A node hosting part of the gang is draining: ask every rank to
        checkpoint and stop NOW, harvest what they save within the grace
        window, then fail the attempt as preempted+retryable so the gang
        restarts elsewhere — ahead of the kill instead of after it."""
        from ray_tpu_torch._private.config import get_config

        executor.request_stop_all()
        deadline = time.monotonic() + get_config().train_drain_grace_s
        while time.monotonic() < deadline:
            try:
                statuses = executor.poll()
            except TrainingFailedError:
                break  # preemption beat the grace window
            self._ingest(statuses, manager)
            if all(st["done"] for st in statuses):
                break
            time.sleep(0.05)
        raise TrainingFailedError(
            f"node drain: rank(s) {sorted(draining)} are on draining "
            f"node(s); gang migrating",
            failed_ranks=draining,
            retryable=True,
            preempted=True,
        )

    @staticmethod
    def _stop_shards(dataset_shards):
        """Kill streaming_split coordinator actors once training ends —
        they hold the dataset's input block refs and nothing else ever
        reclaims them (one coordinator per split dataset per fit)."""
        seen = set()
        for entry in dataset_shards or []:
            shards = entry.values() if isinstance(entry, dict) else [entry]
            for shard in shards:
                coord = getattr(shard, "_coord", None)
                stop = getattr(shard, "stop", None)
                if coord is not None and callable(stop):
                    key = getattr(coord, "_actor_id", id(coord))
                    if key in seen:
                        continue
                    seen.add(key)
                    stop()

    def _shard_datasets(self, num_workers: int):
        """Per-worker {name: shard} dicts via DataConfig: split datasets
        become coordinated streaming_split DataIterators (one shared
        streaming execution per epoch), others broadcast (reference:
        train/_internal/data_config.py DataConfig.configure)."""
        if not self.datasets:
            return None
        return self.dataset_config.configure(self.datasets, num_workers)
