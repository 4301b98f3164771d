"""BackendExecutor: orchestrates the worker group through one training run
(the port of ray_tpu/train/backend_executor.py).

Analog of the reference's BackendExecutor
(train/_internal/backend_executor.py:65): start() creates the WorkerGroup
in a placement group and runs backend.on_start; start_training launches
the user loop on every worker; poll() gathers reports and converts actor
deaths into a classified TrainingFailedError; restart() tears the whole
gang down and rebuilds it at the next gang epoch (:701 _restart).

Fault model: a gang fails as a unit. Any rank dying (preemption, OOM,
segfault) or wedging (network partition mid-collective) invalidates the
collective state of every survivor, so recovery is always
kill-everything → rebuild → resume-from-checkpoint. Each gang `epoch`
rendezvouses its process group at a new address (train/torch.py), so a
zombie rank from attempt N can never join the group of attempt N+1. On
one card the rebuilt gang is placed once the dead rank's GPU is back
with the raylet and the old placement group is REMOVED, which restart()
waits for.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, Optional, Set

import ray_tpu_torch as rt
from ray_tpu_torch._private import chaos
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch.util import journal
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    ActorError,
    ActorUnavailableError,
    GetTimeoutError,
    PlacementGroupSchedulingError,
    WorkerCrashedError,
)
from ray_tpu_torch.train.backend import BackendConfig
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import ScalingConfig
from ray_tpu_torch.train.worker_group import WorkerGroup

logger = logging.getLogger("ray_tpu_torch.train")

# Exceptions on a worker call that mean "this rank's process is gone (or
# unreachable for longer than we are willing to wait)" — the gang must be
# torn down and rebuilt.
_GANG_FATAL = (
    ActorDiedError,
    ActorUnavailableError,
    WorkerCrashedError,
    GetTimeoutError,
)


class TrainingFailedError(RuntimeError):
    """A training attempt failed (reference: TrainingFailedError in
    train/base_trainer.py).

    failed_ranks: world ranks whose workers died/wedged (empty when the
      failure wasn't attributable to specific ranks, e.g. user-code error
      surfaced through the report channel).
    retryable: whether a gang restart can plausibly recover (actor death,
      preemption, collective timeout → True; infeasible placement → False).
    preempted: the failure was a proactive drain, not a crash — workers
      were asked to checkpoint before the gang went down.
    """

    def __init__(self, message: str, *, failed_ranks=None,
                 retryable: bool = True, preempted: bool = False,
                 cause: Optional[BaseException] = None):
        self.failed_ranks: List[int] = sorted(failed_ranks or [])
        self.retryable = retryable
        self.preempted = preempted
        self.cause = cause
        super().__init__(message)


class ResizeError(RuntimeError):
    """An elastic resize could not complete (loop not elastic-aware,
    worker died mid-handoff, bundles still fenced). The gang is left
    running at its old size; the caller falls back to the
    checkpoint-and-restart path."""


def _classify(rank: int, exc: Exception) -> str:
    return f"rank {rank}: {type(exc).__name__}: {exc}"


def _resize_metrics():
    """train_resize_total{direction} / train_gang_size /
    train_resize_seconds — lazy for the same reason as the trainer's
    fault metrics (importing must not start the flusher)."""
    from ray_tpu_torch.util import metrics as rt_metrics

    return (
        rt_metrics.get_or_create(
            rt_metrics.Counter, "train_resize_total",
            "Elastic gang resizes completed, by direction (shrink/grow).",
            tag_keys=("direction",),
        ),
        rt_metrics.get_or_create(
            rt_metrics.Gauge, "train_gang_size",
            "Current world size of the training gang.",
        ),
        rt_metrics.get_or_create(
            rt_metrics.Histogram, "train_resize_seconds",
            "Wall seconds from resize start to the gang running at the "
            "new world size.",
            boundaries=rt_metrics.LATENCY_BOUNDARIES_WIDE,
        ),
    )


class BackendExecutor:
    def __init__(
        self,
        backend_config: BackendConfig,
        scaling_config: ScalingConfig,
    ):
        self.backend_config = backend_config
        self.scaling_config = scaling_config
        self.backend = backend_config.backend_cls()()
        self.worker_group: Optional[WorkerGroup] = None
        # Gang attempt number; bumped by restart() and threaded into the
        # DCN rendezvous so stale ranks can't join the new ring.
        self.epoch = 0
        self._last_drain_check = 0.0
        # (train_fn, config, checkpoint, trial_dir) from start_training —
        # replayed for joiner workers on elastic grow.
        self._train_args = None
        self._last_fence_check = 0.0
        self._fence_lifted_cache = False

    # -- lifecycle -------------------------------------------------------
    def start(self):
        try:
            self.worker_group = WorkerGroup(
                self.scaling_config.num_workers,
                self.scaling_config.worker_resources(),
                self.scaling_config.placement_strategy,
                epoch=self.epoch,
                priority=getattr(self.scaling_config, "priority", 0),
                name="train",
            )
        except PlacementGroupSchedulingError as e:
            # Infeasible bundles won't become feasible by retrying the
            # same request against the same cluster.
            raise TrainingFailedError(
                f"worker group placement failed: {e}",
                retryable=False, cause=e,
            ) from e
        self.backend.on_start(self.worker_group, self.backend_config)

    def restart(self):
        """Tear the whole gang down and rebuild it one epoch later
        (reference: _restart backend_executor.py:701). Survivor actors
        are killed — after one rank dies the others' collective state is
        garbage — and the placement group release is VERIFIED before the
        respawn: a silently surviving group keeps a gang's worth of
        chips reserved on every repeated restart."""
        if self.worker_group is not None:
            try:
                self.backend.on_shutdown(self.worker_group, self.backend_config)
            except Exception:  # noqa: BLE001 — gang is dead; teardown is best-effort
                logger.warning(
                    "backend on_shutdown failed during gang restart "
                    "(epoch %d); proceeding with kill-and-rebuild",
                    self.epoch, exc_info=True,
                )
            try:
                self.worker_group.shutdown(verify=True)
            except PlacementGroupSchedulingError as e:
                self.worker_group = None
                raise TrainingFailedError(
                    f"gang restart blocked: {e}", retryable=True, cause=e
                ) from e
            self.worker_group = None
        self.epoch += 1
        journal.emit("train.gang_restart", epoch=self.epoch)
        journal.trigger_postmortem("gang_restart", epoch=self.epoch)
        self.start()

    def shutdown(self):
        if self.worker_group is not None:
            self.backend.on_shutdown(self.worker_group, self.backend_config)
            self.worker_group.shutdown()
            self.worker_group = None

    # -- training --------------------------------------------------------
    def start_training(
        self,
        train_fn: Callable,
        config: Dict,
        checkpoint: Optional[Checkpoint],
        trial_dir: str,
        dataset_shards: Optional[List[Any]] = None,
    ):
        self.backend.on_training_start(self.worker_group, self.backend_config)
        # Remembered for elastic grow: joiner workers run the same loop
        # (they adopt live state through their pre-armed resize ticket).
        self._train_args = (train_fn, config, checkpoint, trial_dir)
        refs = []
        for i, w in enumerate(self.worker_group.workers):
            shard = dataset_shards[i] if dataset_shards else None
            refs.append(
                w.start_training.remote(train_fn, config, checkpoint, trial_dir,
                                        shard)
            )
        self._get_per_rank(refs, get_config().train_start_timeout_s,
                           what="start_training")

    # -- elastic resize --------------------------------------------------
    @property
    def world_size(self) -> int:
        return self.worker_group.num_workers if self.worker_group else 0

    def resize(self, target_world_size: int,
               departing_ranks: Optional[List[int]] = None,
               dataset_shards: Optional[List[Any]] = None):
        """Resize the live gang instead of restarting it.

        Shrink: departing ranks publish their state slices, checkpoint
        their shards, and exit through the drain plane; their bundles
        are released back to the GCS (completing a partial-reclamation
        drain); survivors renumber, rebuild DCN collectives at the new
        size under a bumped gang epoch (the epoch fence keeps the
        departed ranks out of the new rendezvous), and re-shard state
        through the object store via the deterministic ShardRemapPlan.

        Grow: previously released bundles are re-reserved (fails while
        the claimant's fence holds — raise ResizeError, retry later),
        joiners spawn into them with pre-armed resize tickets, and every
        rank re-shards to the new world size.

        Raises ResizeError with the gang still running at the OLD size;
        the caller falls back to checkpoint-and-restart.
        """
        wg = self.worker_group
        if wg is None:
            raise ResizeError("no worker group to resize")
        old_n, new_n = wg.num_workers, int(target_world_size)
        if new_n < 1:
            raise ResizeError(f"cannot resize to world size {new_n}")
        if new_n == old_n:
            return
        t0 = time.monotonic()
        direction = "shrink" if new_n < old_n else "grow"
        old_epoch = self.epoch
        self.epoch += 1
        wg.epoch = self.epoch
        try:
            if new_n < old_n:
                self._resize_shrink(new_n, departing_ranks, dataset_shards)
            else:
                self._resize_grow(new_n, dataset_shards)
        except ResizeError:
            self.epoch = old_epoch
            wg.epoch = old_epoch
            self._abort_resize_all()
            raise
        except Exception as e:  # noqa: BLE001 — normalize for the caller
            self.epoch = old_epoch
            wg.epoch = old_epoch
            self._abort_resize_all()
            raise ResizeError(f"resize {old_n}→{new_n} failed: {e}") from e
        total, gang_gauge, seconds = _resize_metrics()
        total.inc(1.0, tags={"direction": direction})
        gang_gauge.set(float(new_n))
        seconds.observe(time.monotonic() - t0)
        journal.emit("train.resize", direction=direction,
                     old_world=old_n, new_world=new_n, epoch=self.epoch,
                     seconds=round(time.monotonic() - t0, 3))
        logger.info("gang resized %d→%d (%s) in %.3fs, epoch %d",
                    old_n, new_n, direction, time.monotonic() - t0,
                    self.epoch)

    def _resize_shrink(self, new_n: int,
                       departing_ranks: Optional[List[int]],
                       dataset_shards: Optional[List[Any]]):
        wg = self.worker_group
        old_n = wg.num_workers
        cfg = get_config()
        timeout = cfg.train_resize_timeout_s
        departing = sorted(set(departing_ranks or []))[: old_n - new_n]
        if len(departing) < old_n - new_n:
            # Default victims: highest ranks first (they hold the
            # trailing data shards — the cheapest to rebalance).
            pool = [r for r in range(old_n - 1, -1, -1)
                    if r not in departing]
            departing += pool[: old_n - new_n - len(departing)]
            departing = sorted(departing)
        spec = {"old_world": old_n, "new_world": new_n,
                "departing": departing, "timeout_s": timeout,
                "epoch": self.epoch}
        self._arm_resize(wg.workers, spec)
        outboxes = self._collect_outboxes(
            {r: wg.workers[r] for r in range(old_n)}, timeout)
        survivors_old = [r for r in range(old_n) if r not in set(departing)]
        payload_shards = self._merge_shard_refs(outboxes)
        state_ref = outboxes[survivors_old[0]]["state_ref"]
        # Departing loops have published; reap them and hand their
        # bundles back (this is the moment a partial reclamation's
        # claimant has been waiting for).
        rank_map = wg.shrink(departing)
        for old_rank in survivors_old:
            w = wg.workers[rank_map[old_rank]]
            rt.get(w.set_rank.remote(rank_map[old_rank], new_n),
                   timeout=cfg.train_probe_timeout_s)
        # DCN groups die and rebuild at the new size — the topology
        # model re-selects ring/rd/hier per op for the new world.
        self.backend.on_resize(wg, self.backend_config)
        base = {"old_world": old_n, "new_world": new_n,
                "rank_map": rank_map, "shards": payload_shards,
                "state_ref": state_ref}
        self._deliver_resize(wg, base, dataset_shards, timeout)

    def _resize_grow(self, new_n: int,
                     dataset_shards: Optional[List[Any]]):
        wg = self.worker_group
        old_n = wg.num_workers
        cfg = get_config()
        timeout = cfg.train_resize_timeout_s
        spec = {"old_world": old_n, "new_world": new_n, "departing": [],
                "timeout_s": timeout, "epoch": self.epoch}
        # Re-reserve freed bundles FIRST: while the claimant's fence
        # holds this fails cleanly and nothing was disturbed.
        try:
            wg.grow(new_n)
        except PlacementGroupSchedulingError as e:
            raise ResizeError(f"grow blocked: {e}") from e
        self._arm_resize(wg.workers[:old_n], spec)
        for r in range(old_n):
            rt.get(wg.workers[r].set_rank.remote(r, new_n),
                   timeout=cfg.train_probe_timeout_s)
        # Joiners run the same loop with a pre-armed ticket: their first
        # sync_resize adopts the live replicated state and builds their
        # slice of the sharded state from the survivors' refs.
        if self._train_args is None:
            raise ResizeError("cannot grow before start_training")
        train_fn, config, checkpoint, trial_dir = self._train_args
        join_spec = dict(spec, joining=True)
        start_refs = []
        for rank in range(old_n, new_n):
            shard = dataset_shards[rank] if dataset_shards else None
            start_refs.append(wg.workers[rank].start_training.remote(
                train_fn, config, checkpoint, trial_dir, shard,
                resize_join=join_spec,
            ))
        self._get_per_rank(start_refs, cfg.train_start_timeout_s,
                           what="resize_grow start_training")
        outboxes = self._collect_outboxes(
            {r: wg.workers[r] for r in range(old_n)}, timeout)
        payload_shards = self._merge_shard_refs(outboxes)
        state_ref = outboxes[0]["state_ref"]
        self.backend.on_resize(wg, self.backend_config)
        base = {"old_world": old_n, "new_world": new_n,
                "rank_map": {r: r for r in range(old_n)},
                "shards": payload_shards, "state_ref": state_ref}
        self._deliver_resize(wg, base, dataset_shards, timeout)

    def _arm_resize(self, workers, spec):
        refs = [w.begin_resize.remote(spec) for w in workers]
        self._get_per_rank(refs, get_config().train_probe_timeout_s,
                           what="begin_resize")

    def _collect_outboxes(self, workers: Dict[int, Any],
                          timeout: float) -> Dict[int, Dict]:
        """Wait until every listed rank's loop has hit the resize
        barrier and published its shard refs. A loop that finishes (or
        errors, or dies) without reaching sync_resize aborts the resize."""
        deadline = time.monotonic() + timeout
        out: Dict[int, Dict] = {}
        probe = get_config().train_probe_timeout_s
        while True:
            missing = [r for r in workers if r not in out]
            if not missing:
                return out
            if time.monotonic() >= deadline:
                raise ResizeError(
                    f"rank(s) {missing} did not reach the resize barrier "
                    f"within {timeout:.0f}s (loop not elastic-aware?)"
                )
            for r in missing:
                try:
                    st = rt.get(workers[r].poll_resize.remote(),
                                timeout=probe)
                except _GANG_FATAL as e:
                    raise ResizeError(
                        f"rank {r} died mid-resize: {e}") from e
                if st.get("outbox") is not None:
                    out[r] = st["outbox"]
                elif st.get("loop_done"):
                    raise ResizeError(
                        f"rank {r}'s loop finished before the resize "
                        f"barrier")
            time.sleep(0.05)

    @staticmethod
    def _merge_shard_refs(outboxes: Dict[int, Dict]) -> Dict[str, Dict]:
        merged: Dict[str, Dict] = {}
        for rank, ob in outboxes.items():
            for name, ref in (ob.get("shards") or {}).items():
                merged.setdefault(name, {})[rank] = ref
        return merged

    def _deliver_resize(self, wg, base: Dict,
                        dataset_shards: Optional[List[Any]],
                        timeout: float):
        refs = []
        for rank, w in enumerate(wg.workers):
            payload = dict(base)
            if dataset_shards is not None:
                payload["dataset_shards"] = dataset_shards[rank]
            refs.append(w.complete_resize.remote(payload))
        self._get_per_rank(refs, get_config().train_probe_timeout_s,
                           what="complete_resize")
        # Confirm application: the gang must be consistent at the new
        # size before the executor reports the resize done.
        deadline = time.monotonic() + timeout
        pending = set(range(len(wg.workers)))
        while pending and time.monotonic() < deadline:
            for r in list(pending):
                st = rt.get(wg.workers[r].poll_resize.remote(),
                            timeout=get_config().train_probe_timeout_s)
                if st.get("applied") or st.get("loop_done"):
                    pending.discard(r)
            if pending:
                time.sleep(0.05)
        if pending:
            raise ResizeError(
                f"rank(s) {sorted(pending)} did not apply the resize "
                f"within {timeout:.0f}s")

    def _abort_resize_all(self):
        if self.worker_group is None:
            return
        for rank, w in enumerate(self.worker_group.workers):
            try:
                rt.get(w.abort_resize.remote(),
                       timeout=get_config().train_probe_timeout_s)
            except Exception as e:  # noqa: BLE001 — best-effort unwind
                logger.warning("resize abort not delivered to rank %d "
                               "(%s); the rank unblocks via its own "
                               "resize timeout", rank, e)

    def poll(self) -> List[Dict]:
        """One poll of every worker: list of per-rank status dicts.

        Dead/unreachable ranks raise TrainingFailedError carrying every
        failed rank, not just the first — the trainer logs them all and
        the metrics count them all. The timeout is train_poll_timeout_s
        (dead actors surface immediately on the call; the timeout only
        bounds hung-but-alive workers), NOT an unbounded get.
        """
        delay = chaos.take_poll_delay()
        if delay:
            time.sleep(delay)
        refs = [w.poll.remote() for w in self.worker_group.workers]
        return self._get_per_rank(refs, get_config().train_poll_timeout_s,
                                  what="poll")

    def _get_per_rank(self, refs, timeout: float, what: str) -> List:
        results: List = [None] * len(refs)
        failures: Dict[int, Exception] = {}
        deadline = time.monotonic() + timeout
        for i, ref in enumerate(refs):
            remaining = max(0.1, deadline - time.monotonic())
            try:
                results[i] = rt.get(ref, timeout=remaining)
            except _GANG_FATAL as e:
                failures[i] = e
        if failures:
            detail = "; ".join(
                _classify(r, e) for r, e in sorted(failures.items())
            )
            raise TrainingFailedError(
                f"{len(failures)}/{len(refs)} worker(s) failed during "
                f"{what} (gang epoch {self.epoch}): {detail}",
                failed_ranks=failures.keys(),
                retryable=True,
                cause=next(iter(failures.values())),
            )
        return results

    # -- liveness / drain ------------------------------------------------
    def ping(self, timeout: Optional[float] = None) -> Set[int]:
        """Low-cost liveness probe: returns the set of unresponsive
        ranks. Unlike poll() this never raises — it's the cheap periodic
        check that bounds detection latency for wedged workers."""
        if self.worker_group is None:
            return set()
        timeout = timeout or get_config().train_probe_timeout_s
        refs = [w.ping.remote() for w in self.worker_group.workers]
        bad: Set[int] = set()
        for i, ref in enumerate(refs):
            try:
                rt.get(ref, timeout=timeout)
            except (ActorError, WorkerCrashedError, GetTimeoutError):
                bad.add(i)
        return bad

    def draining_ranks(self) -> Set[int]:
        """Ranks whose nodes are draining (cordoned ahead of preemption).

        Merges chaos-injected drains (deterministic tests) with the GCS
        node table's `draining` flag, mapped to ranks through the
        placement group's bundle→node assignment. The GCS lookup is
        throttled to train_drain_poll_interval_s; injected drains are
        process-local and always checked.
        """
        ranks = set(chaos.take_injected_drain_ranks())
        cfg = get_config()
        now = time.monotonic()
        if now - self._last_drain_check >= cfg.train_drain_poll_interval_s:
            self._last_drain_check = now
            try:
                ranks |= self._gcs_draining_ranks()
            except Exception:  # noqa: BLE001
                # Control-plane hiccup must not fail training; the next
                # poll retries.
                logger.warning("GCS drain poll failed; retrying in %.1fs",
                               cfg.train_drain_poll_interval_s,
                               exc_info=True)
        return ranks

    def _gcs_draining_ranks(self) -> Set[int]:
        if self.worker_group is None:
            return set()
        ranks: Set[int] = set()
        # Partial-reclamation records name the exact bundles being
        # drained — map those to ranks directly, and keep their nodes
        # out of the node-scope sweep below so co-located ranks (PACK)
        # aren't swept up with the claimed ones.
        partial_nodes: Set = set()
        pg_id = self.worker_group.pg_id
        from ray_tpu_torch._private import worker as worker_mod

        client = worker_mod.get_client()
        resp = client._run(client._gcs_call("get_preemptions", {}))
        for rec in resp.get("preemptions", []):
            if rec.get("state") != "draining":
                continue
            if rec.get("victim_pg_id") != pg_id:
                continue
            if rec.get("partial"):
                idxs = rec.get("bundle_indices") or []
                ranks |= set(self.worker_group.ranks_for_bundles(idxs))
                partial_nodes |= set(rec.get("nodes") or [])
        draining_nodes = {
            n["node_id"]
            for n in rt.nodes()
            if n.get("draining") and n["state"] == "ALIVE"
        } - partial_nodes
        ranks |= {
            i
            for i, nid in enumerate(self.worker_group.node_ids())
            if nid in draining_nodes
        }
        return ranks

    def fence_lifted(self) -> bool:
        """True once every resize obligation recorded against this gang
        is lifted (the partial-reclamation claimant released the chips)
        and there are released bundles to grow back into. This is the
        trainer's grow-back signal; throttled like the drain poll."""
        wg = self.worker_group
        if wg is None or not wg._released_bundles:
            return False
        now = time.monotonic()
        if now - self._last_fence_check < get_config().train_drain_poll_interval_s:
            return self._fence_lifted_cache
        self._last_fence_check = now
        lifted = False
        try:
            from ray_tpu_torch.util.placement_group import (
                placement_group_resize_state,
            )

            st = placement_group_resize_state(wg._pg)
            obligations = st.get("obligations") or []
            if obligations:
                lifted = all(o.get("state") == "lifted"
                             for o in obligations)
            else:
                # Voluntary shrink (no claimant holds the chips): free
                # to grow back whenever capacity allows.
                lifted = True
        except Exception:  # noqa: BLE001 — control-plane hiccup; retry
            logger.warning("resize-state poll failed; retrying",
                           exc_info=True)
        self._fence_lifted_cache = lifted
        return lifted

    def request_stop_all(self):
        """Ask every rank to checkpoint and return at the next
        should_stop() check (proactive migration). Best-effort: a rank
        already dead just stays dead."""
        if self.worker_group is None:
            return
        refs = [w.request_stop.remote() for w in self.worker_group.workers]
        for rank, ref in enumerate(refs):
            try:
                rt.get(ref, timeout=get_config().train_probe_timeout_s)
            except _GANG_FATAL:
                # A rank that is already dead (or unreachable) cannot
                # checkpoint; the coming restart handles it.
                logger.warning(
                    "rank %d unreachable during stop-all request; it "
                    "will be replaced at the next gang epoch", rank,
                )
