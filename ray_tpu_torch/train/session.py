"""Per-worker training session (the port of ray_tpu/train/session.py).

Analog of the reference's _TrainSession (train/_internal/session.py:109):
the user's train loop calls session.report(metrics, checkpoint=...)
(reference :393/:653) which streams results back to the trainer; rank info
and dataset shards are exposed the same way.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint, ShardedState

_session: Optional["TrainSession"] = None


class ResizeEvent:
    """What train.sync_resize reports back to the loop.

    resized: a resize happened at this boundary.
    exiting: THIS rank was resized out — checkpoint and return.
    world_rank / world_size: the (possibly new) rank and gang size.
    state: replicated state — unchanged for survivors, adopted from the
      donor rank for joiners.
    shards: {name: ShardedState} rebuilt under the new world size.
    """

    __slots__ = ("resized", "exiting", "world_rank", "world_size",
                 "state", "shards")

    def __init__(self, resized, exiting, world_rank, world_size, state,
                 shards):
        self.resized = resized
        self.exiting = exiting
        self.world_rank = world_rank
        self.world_size = world_size
        self.state = state
        self.shards = shards


class TrainSession:
    def __init__(
        self,
        world_rank: int,
        world_size: int,
        local_rank: int = 0,
        config: Optional[Dict] = None,
        checkpoint: Optional[Checkpoint] = None,
        dataset_shards: Optional[Dict[str, Any]] = None,
        trial_dir: str = "",
        resize_join: Optional[Dict] = None,
    ):
        self.world_rank = world_rank
        self.world_size = world_size
        self.local_rank = local_rank
        self.config = config or {}
        self._start_checkpoint = checkpoint
        self._dataset_shards = dataset_shards or {}
        self.trial_dir = trial_dir
        self._lock = threading.Lock()
        self._reports: List[Dict] = []
        self._finished = False
        self._error: Optional[BaseException] = None
        self._stop_requested = threading.Event()
        # Flight recorder: StepProfiler self-registers here on
        # construction so its records ride report()/poll() untouched by
        # the user's loop code.
        self._profiler = None
        # Elastic resize plumbing. The executor arms a ticket
        # (begin_resize); the loop's next sync_resize publishes this
        # rank's shard slices to the object store and blocks until the
        # executor delivers everyone's refs (deliver_resize) or aborts.
        # A joiner starts with a pre-armed ticket (resize_join) so its
        # FIRST sync_resize adopts the live gang state instead of its
        # own cold init.
        self._resize_spec: Optional[Dict] = resize_join
        self._resize_armed = threading.Event()
        if resize_join is not None:
            self._resize_armed.set()
        self._resize_outbox: Optional[Dict] = None
        self._resize_inbox: Optional[Dict] = None
        self._resize_inbox_ready = threading.Event()
        self._resize_applied = threading.Event()

    # -- user API --------------------------------------------------------
    def report(self, metrics: Dict, checkpoint: Optional[Checkpoint] = None):
        import time as _time

        from ray_tpu_torch.train import flight_recorder as _fr

        t0 = _time.perf_counter()
        prof = self._profiler
        rec = {"metrics": dict(metrics), "checkpoint": checkpoint}
        if prof is not None:
            # Ship the steps completed since the last report with this
            # one, so the trainer sees per-step records in order.
            rec["step_records"] = prof.drain_records()
        with self._lock:
            self._reports.append(rec)
        # A report carrying a checkpoint is the checkpoint handoff — its
        # wall time is checkpoint time of the step it happened inside.
        if checkpoint is not None:
            _fr.note_phase("checkpoint", _time.perf_counter() - t0)

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return self._start_checkpoint

    def get_dataset_shard(self, name: str = "train"):
        return self._dataset_shards.get(name)

    def should_stop(self) -> bool:
        """True once the trainer asked this worker to stop early (its
        node is draining ahead of preemption). Loops that check this each
        step and report a checkpoint before returning migrate with zero
        lost work; loops that don't are restarted from their last
        checkpoint like any crash."""
        return self._stop_requested.is_set()

    def sync_resize(self, state: Any = None,
                    shards: Optional[Dict[str, ShardedState]] = None
                    ) -> ResizeEvent:
        """Cooperative elastic-resize barrier: call at step boundaries.

        Fast path (no resize pending) is one Event check. When the
        executor has armed a resize, this rank publishes its shard
        slices (and replicated state) to the object store, then either
        exits (it was resized out — the event's `exiting` is True;
        checkpoint and return) or blocks until the executor delivers
        every rank's refs and rebuilds its shards under the new world
        size via the deterministic ShardRemapPlan. Survivors never touch
        disk: re-sharding moves bytes through the object store only.
        """
        shards = shards or {}
        if not self._resize_armed.is_set():
            return ResizeEvent(False, False, self.world_rank,
                               self.world_size, state, shards)
        import os
        import time as _time

        import ray_tpu_torch as rt
        from ray_tpu_torch.train import flight_recorder as _fr
        from ray_tpu_torch.train.checkpoint import ShardRemapPlan

        t0 = _time.perf_counter()
        spec = dict(self._resize_spec or {})
        joining = bool(spec.get("joining"))
        departing = self.world_rank in set(spec.get("departing") or ())
        if joining:
            outbox = {"rank": self.world_rank, "shards": {},
                      "state_ref": None}
        else:
            outbox = {
                "rank": self.world_rank,
                "shards": {name: rt.put(ss.slices)
                           for name, ss in shards.items()},
                "state_ref": rt.put(state),
            }
        with self._lock:
            self._resize_outbox = outbox
        if departing:
            # Exit through the drain plane: persist this rank's slices
            # (a cold restore can still assemble the full tree from
            # disk) and return; the executor reaps the actor once the
            # loop finishes.
            if self.trial_dir:
                for name, ss in shards.items():
                    try:
                        ss.save(os.path.join(self.trial_dir,
                                             f"shards_{name}"))
                    except OSError:
                        pass
            self._resize_armed.clear()
            self._resize_spec = None
            _fr.note_phase("resize", _time.perf_counter() - t0)
            return ResizeEvent(True, True, self.world_rank,
                               self.world_size, state, shards)
        timeout = float(spec.get("timeout_s") or 120.0)
        delivered = self._resize_inbox_ready.wait(timeout)
        inbox = self._resize_inbox
        self._resize_inbox = None
        self._resize_inbox_ready.clear()
        self._resize_armed.clear()
        self._resize_spec = None
        if not delivered or inbox is None or inbox.get("aborted"):
            # Executor abandoned the resize; carry on at the old size.
            with self._lock:
                self._resize_outbox = None
            self._resize_applied.set()
            _fr.note_phase("resize", _time.perf_counter() - t0)
            return ResizeEvent(False, False, self.world_rank,
                               self.world_size, state, shards)
        old_world = int(inbox["old_world"])
        new_world = int(inbox["new_world"])
        rank_map = inbox.get("rank_map") or {}
        new_rank = int(rank_map.get(self.world_rank, self.world_rank))
        new_shards: Dict[str, ShardedState] = {}
        for name, ss in shards.items():
            from ray_tpu_torch.train.checkpoint import ShardedState as _SS

            plan = ShardRemapPlan(old_world, new_world, ss.meta["sizes"],
                                  ss.meta["dtypes"])
            refs = inbox["shards"].get(name) or {}
            old_slices = {
                r: rt.get(refs[r], timeout=timeout)
                for r in plan.sources_for(new_rank)
            }
            new_shards[name] = _SS(ss.meta, new_rank, new_world,
                                   plan.remap(new_rank, old_slices))
        if joining and inbox.get("state_ref") is not None:
            state = rt.get(inbox["state_ref"], timeout=timeout)
        if "dataset_shards" in inbox and inbox["dataset_shards"] is not None:
            ds = inbox["dataset_shards"]
            self._dataset_shards = (
                ds if isinstance(ds, dict) else {"train": ds}
            )
        self.world_rank = new_rank
        self.world_size = new_world
        self._resize_applied.set()
        _fr.note_phase("resize", _time.perf_counter() - t0)
        return ResizeEvent(True, False, new_rank, new_world, state,
                           new_shards)

    def attach_profiler(self, profiler) -> None:
        """Register this worker's StepProfiler (called by the profiler's
        own constructor). The latest attached profiler wins."""
        self._profiler = profiler

    @property
    def profiler(self):
        return self._profiler

    # -- trainer side ----------------------------------------------------
    def request_stop(self):
        self._stop_requested.set()

    def begin_resize(self, spec: Dict):
        """Arm a resize ticket: the loop's next sync_resize publishes
        its shard refs and parks until deliver_resize/abort_resize."""
        with self._lock:
            self._resize_outbox = None
        self._resize_inbox = None
        self._resize_inbox_ready.clear()
        self._resize_applied.clear()
        self._resize_spec = dict(spec)
        self._resize_armed.set()

    def poll_resize(self) -> Dict:
        with self._lock:
            outbox = self._resize_outbox
        return {
            "armed": self._resize_armed.is_set(),
            "outbox": outbox,
            "applied": self._resize_applied.is_set(),
        }

    def deliver_resize(self, payload: Dict):
        self._resize_inbox = dict(payload)
        self._resize_inbox_ready.set()

    def abort_resize(self):
        """Unwind an armed resize: a parked loop consumes the abort and
        continues at the old size; a loop that never reached the barrier
        is simply disarmed."""
        if self._resize_armed.is_set():
            self._resize_inbox = {"aborted": True}
            self._resize_inbox_ready.set()

    def drain(self) -> List[Dict]:
        with self._lock:
            out = self._reports
            self._reports = []
            return out


def init_session(**kwargs) -> TrainSession:
    global _session
    _session = TrainSession(**kwargs)
    return _session


def shutdown_session():
    global _session
    _session = None


def get_session() -> TrainSession:
    if _session is None:
        raise RuntimeError(
            "No train session active — this API must be called inside a "
            "train_loop_per_worker"
        )
    return _session


# Public module-level API mirroring `ray.train` usage.
def report(metrics: Dict, checkpoint: Optional[Checkpoint] = None):
    get_session().report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    return get_session().get_checkpoint()


def get_dataset_shard(name: str = "train"):
    return get_session().get_dataset_shard(name)


def get_world_rank() -> int:
    return get_session().world_rank


def get_world_size() -> int:
    return get_session().world_size


def get_local_rank() -> int:
    return get_session().local_rank


def get_trial_dir() -> str:
    return get_session().trial_dir


def should_stop() -> bool:
    return get_session().should_stop()


def sync_resize(state: Any = None,
                shards: Optional[Dict[str, ShardedState]] = None
                ) -> ResizeEvent:
    """Elastic-resize barrier for loops that shrink/grow instead of
    dying — see TrainSession.sync_resize."""
    return get_session().sync_resize(state, shards)


def shard_state(tree: Any, name: str = "opt") -> Dict[str, ShardedState]:
    """Shard a pytree across the current gang (ZeRO-style): this rank
    keeps only its slice. The result feeds sync_resize, which re-shards
    it whenever the gang resizes."""
    s = get_session()
    return {name: ShardedState.create(tree, s.world_rank, s.world_size)}


class TrainContext:
    """Per-worker training context (reference: ray.train.get_context() ->
    TrainContext, train/context.py) — the method-style facade over the
    session's rank/size/dir accessors."""

    def get_world_rank(self) -> int:
        return get_world_rank()

    def get_world_size(self) -> int:
        return get_world_size()

    def get_local_rank(self) -> int:
        return get_local_rank()

    def get_trial_dir(self) -> str:
        return get_trial_dir()

    def get_node_rank(self) -> int:
        # Worker groups never set local_rank today: node rank == world
        # rank, as in the JAX package.
        return get_session().world_rank


def get_context() -> TrainContext:
    """The reference's accessor: usable only inside a training worker."""
    get_session()  # raises outside a worker, matching the reference
    return TrainContext()
