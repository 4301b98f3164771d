"""Worker group: the actor gang that runs training (the port of
ray_tpu/train/worker_group.py).

Analog of the reference's WorkerGroup (train/_internal/worker_group.py) +
the placement/rank parts of BackendExecutor
(train/_internal/backend_executor.py:124-358): N actors created inside a
placement group, rank/world mappings computed, functions executed on all
workers in parallel.

Each worker holds its bundle's GPUs as an actor (`num_gpus`), so the
raylet counts the card as held while the rank lives and frees it when
the rank dies; the JAX package's workers hold no chip of their own and
see the whole host (its worker_group.py:212-219).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch as rt
from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch.exceptions import PlacementGroupSchedulingError
from ray_tpu_torch.train.session import TrainSession, get_session, init_session, shutdown_session
from ray_tpu_torch.util.placement_group import (
    PlacementGroup,
    placement_group,
    placement_group_state,
    release_placement_group_bundles,
    remove_placement_group,
    reserve_placement_group_bundles,
)
from ray_tpu_torch.util.scheduling_strategies import PlacementGroupSchedulingStrategy

logger = logging.getLogger("ray_tpu_torch.train.worker_group")


@rt.remote
class TrainWorker:
    """Hosts one rank's training loop (reference: per-worker _TrainSession)."""

    def __init__(self, rank: int, world_size: int):
        self.rank = rank
        self.world_size = world_size
        self.session: Optional[TrainSession] = None
        self._thread = None
        self._error = None
        self._done = False

    def execute(self, fn, *args, **kwargs):
        return fn(*args, **kwargs)

    def execute_with_rank(self, fn, *args, **kwargs):
        return fn(self.rank, *args, **kwargs)

    def start_training(self, train_fn, config, checkpoint, trial_dir,
                       dataset_shard=None, resize_join=None):
        import threading

        self.session = init_session(
            world_rank=self.rank,
            world_size=self.world_size,
            config=config,
            checkpoint=checkpoint,
            # DataConfig hands a {name: shard} dict per worker; legacy
            # callers may still pass a bare train shard.
            dataset_shards=(
                dataset_shard if isinstance(dataset_shard, dict)
                else {"train": dataset_shard} if dataset_shard is not None
                else {}
            ),
            trial_dir=trial_dir,
            # Joiners of a grow resize start with a pre-armed ticket so
            # their first sync_resize adopts the live gang state.
            resize_join=resize_join,
        )
        self._done = False
        self._error = None

        self._error_type = None

        def run():
            try:
                train_fn(config) if _wants_arg(train_fn) else train_fn()
            except BaseException as e:  # noqa: BLE001
                import traceback

                self._error = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
                self._error_type = type(e).__name__
            finally:
                self._done = True

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return True

    def poll(self):
        """Drain queued reports (reference: get_next_results
        backend_executor.py:552)."""
        reports = self.session.drain() if self.session else []
        out = []
        for r in reports:
            ckpt = r["checkpoint"]
            entry = {
                "metrics": r["metrics"],
                "checkpoint_path": ckpt.path if ckpt else None,
            }
            if r.get("step_records"):
                entry["step_records"] = r["step_records"]
            out.append(entry)
        # Flight recorder: cumulative per-rank step stats ride every poll
        # (not just reports), so the trainer's skew/straggler view stays
        # current even for loops that report rarely.
        prof = self.session.profiler if self.session else None
        return {
            "reports": out,
            "done": self._done,
            "error": self._error,
            "error_type": getattr(self, "_error_type", None),
            "step_stats": prof.summary() if prof is not None else None,
        }

    def ping(self):
        """Liveness probe. Training runs in a daemon thread, so this
        answers promptly even mid-step — a non-answer means the process
        is gone or the actor event loop is wedged."""
        return True

    def request_stop(self):
        """Ask the training loop to checkpoint and return at its next
        train.should_stop() check (proactive drain migration)."""
        if self.session is not None:
            self.session.request_stop()
        return True

    # -- elastic resize (driven by BackendExecutor.resize) ---------------
    def begin_resize(self, spec):
        if self.session is None:
            return False
        self.session.begin_resize(spec)
        return True

    def poll_resize(self):
        if self.session is None:
            return {"armed": False, "outbox": None, "applied": False,
                    "loop_done": self._done}
        out = self.session.poll_resize()
        # A loop that finished (or died) before reaching the barrier can
        # never publish; the executor aborts instead of timing out.
        out["loop_done"] = self._done
        return out

    def complete_resize(self, payload):
        if self.session is not None:
            self.session.deliver_resize(payload)
        return True

    def abort_resize(self):
        if self.session is not None:
            self.session.abort_resize()
        return True

    def set_rank(self, rank: int, world_size: int):
        """Renumber this worker after a resize (the session's own view
        updates when its sync_resize consumes the delivery; this keeps
        execute_with_rank — e.g. the DCN group rebuild — consistent)."""
        self.rank = rank
        self.world_size = world_size
        return True

    def shutdown(self):
        shutdown_session()
        return True


def _wants_arg(fn) -> bool:
    import inspect

    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    return len(sig.parameters) >= 1


class WorkerGroup:
    def __init__(
        self,
        num_workers: int,
        resources_per_worker: Dict[str, float],
        placement_strategy: str = "PACK",
        epoch: int = 0,
        priority: int = 0,
        name: str = "",
    ):
        self.num_workers = num_workers
        self.resources_per_worker = dict(resources_per_worker)
        # Gang attempt number — read by the backend's on_start to stamp
        # DCN rendezvous keys so stale ranks can't join a rebuilt ring.
        self.epoch = epoch
        self._pg: Optional[PlacementGroup] = None
        bundles = [dict(resources_per_worker) for _ in range(num_workers)]
        self._pg = placement_group(
            bundles, strategy=placement_strategy, name=name, priority=priority
        )
        # ready() raises PlacementGroupSchedulingError on INFEASIBLE /
        # REMOVED; a False return is a still-pending reservation.
        if not self._pg.ready(timeout=120):
            remove_placement_group(self._pg)
            raise PlacementGroupSchedulingError(
                f"worker group placement group not ready within 120s "
                f"(bundles={bundles}, strategy={placement_strategy})"
            )
        self.workers = [
            self._worker_cls(i).remote(i, num_workers)
            for i in range(num_workers)
        ]
        # Elastic resize bookkeeping: rank i lives in bundle
        # bundle_for_rank[i] (identity at birth; shrink/grow make it
        # sparse — survivors keep their original bundles, joiners take
        # the freed indices).
        self.bundle_for_rank: List[int] = list(range(num_workers))
        self._released_bundles: List[int] = []

    def _worker_cls(self, bundle_index: int):
        """TrainWorker placed in bundle `bundle_index`, holding the
        bundle's GPUs."""
        return TrainWorker.options(
            num_cpus=0,
            num_gpus=self.resources_per_worker.get("GPU", 0),
            scheduling_strategy=PlacementGroupSchedulingStrategy(
                placement_group=self._pg,
                placement_group_bundle_index=bundle_index,
            ),
        )

    def __len__(self):
        return self.num_workers

    @property
    def pg_id(self) -> bytes:
        return self._pg.id.binary() if self._pg else b""

    def node_ids(self) -> List:
        """Per-rank node ids via the placement group's bundle→node map
        (rank i lives in bundle bundle_for_rank[i])."""
        if self._pg is None:
            return []
        by_bundle = self._pg.bundle_node_ids()
        return [
            by_bundle[b] if b < len(by_bundle) else None
            for b in self.bundle_for_rank
        ]

    def ranks_for_bundles(self, indices) -> List[int]:
        """Ranks currently living in the given bundle indices."""
        want = set(indices)
        return [r for r, b in enumerate(self.bundle_for_rank) if b in want]

    def shrink(self, departing_ranks: List[int]) -> Dict[int, int]:
        """Drop the departing ranks' workers, release their bundles back
        to the GCS (crediting the chips — this is what the claimant of a
        partial reclamation is waiting for), and renumber survivors to
        0..k-1 preserving order. Returns the old→new rank map."""
        departing = set(departing_ranks)
        released = [self.bundle_for_rank[r] for r in sorted(departing)]
        for r in sorted(departing):
            try:
                rt.kill(self.workers[r])
            except Exception:  # rtlint: disable=RT007 — a departing rank that already exited through the drain plane is the happy path
                pass
        rank_map: Dict[int, int] = {}
        new_workers, new_bundles = [], []
        for old_rank in range(self.num_workers):
            if old_rank in departing:
                continue
            rank_map[old_rank] = len(new_workers)
            new_workers.append(self.workers[old_rank])
            new_bundles.append(self.bundle_for_rank[old_rank])
        self.workers = new_workers
        self.bundle_for_rank = new_bundles
        self.num_workers = len(new_workers)
        self._released_bundles.extend(released)
        release_placement_group_bundles(self._pg, released)
        return rank_map

    def grow(self, target: int) -> List[int]:
        """Re-reserve previously released bundles and spawn joiner
        workers into them (rank k..target-1). Raises
        PlacementGroupSchedulingError while the chips are still fenced
        or occupied. Returns the new ranks."""
        need = target - self.num_workers
        if need <= 0:
            return []
        if need > len(self._released_bundles):
            raise PlacementGroupSchedulingError(
                f"cannot grow to {target}: only "
                f"{len(self._released_bundles)} released bundle(s) to "
                f"re-reserve"
            )
        indices = sorted(self._released_bundles)[:need]
        reserve_placement_group_bundles(self._pg, indices)
        self._released_bundles = [
            b for b in self._released_bundles if b not in set(indices)
        ]
        new_ranks = []
        for j, bundle_index in enumerate(indices):
            rank = self.num_workers + j
            self.workers.append(
                self._worker_cls(bundle_index).remote(rank, target)
            )
            self.bundle_for_rank.append(bundle_index)
            new_ranks.append(rank)
        self.num_workers = len(self.workers)
        return new_ranks

    def execute(self, fn: Callable, *args, **kwargs) -> List[Any]:
        """Run fn on every worker; returns per-rank results."""
        return rt.get(
            [w.execute.remote(fn, *args, **kwargs) for w in self.workers],
            timeout=600,
        )

    def execute_single(self, rank: int, fn: Callable, *args, **kwargs) -> Any:
        """Run fn on one worker."""
        return rt.get(self.workers[rank].execute.remote(fn, *args, **kwargs),
                      timeout=600)

    def execute_with_rank(self, fn: Callable, *args, **kwargs) -> List[Any]:
        return rt.get(
            [w.execute_with_rank.remote(fn, *args, **kwargs) for w in self.workers],
            timeout=600,
        )

    def shutdown(self, verify: bool = False):
        """Kill the gang and release its placement group.

        verify=True (the restart path) confirms the GCS actually marked
        the group REMOVED — retrying the removal once — and raises if
        the release cannot be confirmed. A silently surviving group
        would keep its bundles reserved forever, leaking a gang's worth
        of chips on every restart.
        """
        for w in self.workers:
            try:
                rt.kill(w)
            except Exception:  # noqa: BLE001 — already-dead is expected
                logger.debug("kill of train worker failed (already "
                             "dead?)", exc_info=True)
        if self._pg is None:
            return
        pg, self._pg = self._pg, None
        last_error: Optional[Exception] = None
        for _ in range(2):
            try:
                remove_placement_group(pg)
                last_error = None
            except Exception as e:  # rtlint: disable=RT007 — carried into the PlacementGroupSchedulingError raised below
                last_error = e
            if not verify:
                return
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                try:
                    state = placement_group_state(pg)
                except Exception as e:  # rtlint: disable=RT007 — carried into the PlacementGroupSchedulingError raised below
                    last_error = e
                    break
                if state in (None, "REMOVED"):
                    return
                time.sleep(0.05)
        raise PlacementGroupSchedulingError(
            f"placement group {pg.id.hex()} still reserved after "
            f"shutdown (remove not confirmed"
            + (f"; last error: {last_error}" if last_error else "")
            + ") — refusing to respawn on top of a leaked gang"
        )
