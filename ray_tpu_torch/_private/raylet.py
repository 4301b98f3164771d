"""Raylet: the per-node daemon.

Analog of the reference raylet (src/ray/raylet/main.cc:119,
NodeManager at raylet/node_manager.h:125). Collapses into one asyncio
process:

  * cluster + local task scheduling  (ClusterTaskManager::QueueAndScheduleTask
                                      cluster_task_manager.cc:44,
                                      LocalTaskManager::Dispatch...
                                      local_task_manager.cc:105; hybrid policy
                                      policy/hybrid_scheduling_policy.cc:186)
  * worker pool                      (WorkerPool, raylet/worker_pool.h — here
                                      sized for a few GPU workers per host,
                                      not hundreds)
  * dependency management            (raylet/dependency_manager.h — waits for
                                      arg objects to land in the local store
                                      before dispatch)
  * object transfer                  (ObjectManager::Push/Pull,
                                      object_manager.cc:339 — chunked pulls
                                      over the raylet RPC connection)
  * placement group bundles          (raylet/placement_group_resource_manager.h)

The shared-memory store is created and owned here (the reference runs plasma
in-process in the raylet: object_manager/plasma/store_runner.h).
"""

from __future__ import annotations

import asyncio
import heapq
import os
import subprocess
import sys
import time
from collections import defaultdict, deque
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.accelerators.gpu import (
    GPUAcceleratorManager,
    GPUInstances,
)
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.ids import NodeID, ObjectID
from ray_tpu_torch._private.object_store import ObjectStore
from ray_tpu_torch.exceptions import ObjectStoreFullError
from ray_tpu_torch._private.protocol import Connection, RpcServer, ServerConnection, connect, spawn
from ray_tpu_torch.util import journal, lifecycle


class _PullByteBudget:
    """Admission control for pull transfers, by bytes, smallest-first.

    The reference's PullManager activates pulls under a memory quota in
    priority order (pull_manager.h:52). Here: a transfer is admitted when
    it fits the byte budget (or the budget is idle — one oversized object
    may always proceed alone); contended waiters are woken smallest-first
    so bulk restores can't starve cheap ready objects.
    """

    def __init__(self, budget_bytes: int):
        self.budget = budget_bytes
        self.in_use = 0
        self._seq = 0
        self._waiters: list = []  # heap of (size, seq, future)

    def _admissible(self, size: int) -> bool:
        return self.in_use == 0 or self.in_use + size <= self.budget

    async def acquire(self, size: int):
        if not self._waiters and self._admissible(size):
            self.in_use += size
            return
        fut = asyncio.get_event_loop().create_future()
        self._seq += 1
        heapq.heappush(self._waiters, (size, self._seq, fut))
        try:
            await fut
        except asyncio.CancelledError:
            # Cancelled after release() already charged our bytes: give
            # them back or the budget shrinks permanently (the
            # asyncio.Semaphore cancellation-window pattern).
            if fut.done() and not fut.cancelled() and fut.exception() is None:
                self.release(size)
            raise

    def release(self, size: int):
        self.in_use = max(0, self.in_use - size)
        while self._waiters:
            wsize, _, fut = self._waiters[0]
            if fut.cancelled():
                heapq.heappop(self._waiters)
                continue
            if not self._admissible(wsize):
                break
            heapq.heappop(self._waiters)
            self.in_use += wsize
            fut.set_result(None)


import functools


@functools.lru_cache(maxsize=1)
def _machine_id() -> str:
    """Identity of the physical host (hostname + kernel boot id): two
    raylets with equal machine ids share /dev/shm and can move objects by
    direct store-to-store memcpy instead of TCP. Immutable for the
    process lifetime — cached (the pull hot path compares it per
    candidate holder)."""
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            boot = f.read().strip()
    except OSError:
        boot = ""
    import socket as _socket

    return f"{_socket.gethostname()}:{boot}"


class WorkerHandle:
    def __init__(self, proc: subprocess.Popen, worker_id: bytes,
                 runtime_env_hash: Optional[str] = None):
        self.proc = proc
        self.worker_id = worker_id
        self.conn: Optional[ServerConnection] = None  # worker -> raylet conn
        self.port: Optional[int] = None  # worker's own RPC port
        self.idle = True
        self.actor_id: Optional[bytes] = None
        self.actor_resources: Dict[str, float] = {}  # held while actor alive
        self.current_task: Optional[bytes] = None
        self.last_idle_time = time.monotonic()
        # Workers are cached per runtime-env hash (worker_pool.h); a task
        # only dispatches to a worker started with its env.
        self.runtime_env_hash = runtime_env_hash
        # Direct-transport lease: resources held by an owner pushing tasks
        # straight to this worker (direct_task_transport.cc OnWorkerIdle).
        self.lease_resources: Optional[Dict[str, float]] = None
        self.leased_by = None  # owner ServerConnection while leased
        # max_calls retirement: excluded from dispatch/leases, killed
        # shortly after (the worker announced it is done).
        self.retired = False
        # Set when the worker registers (or is forgotten): actor creation
        # waits on this instead of a 50ms poll.
        self.registered = asyncio.Event()
        # Cached raylet->worker dial (the worker's own RPC port); lazily
        # opened for request/response ops like release_actor.
        self.dial: Optional[Connection] = None
        # Per-process stats sampled from /proc each heartbeat.
        self.cpu_percent: float = 0.0
        self.rss_bytes: int = 0
        # Card ids granted to the actor, lease or task this worker runs,
        # and the last ones it was given (offered again first: a worker's
        # CUDA context cannot move to other cards).
        self.actor_gpu_ids: List[str] = []
        self.lease_gpu_ids: List[str] = []
        self.last_gpu_ids: Optional[List[str]] = None


class Raylet:
    def __init__(
        self,
        gcs_host: str,
        gcs_port: int,
        resources: Dict[str, float],
        labels: Dict[str, str] | None = None,
        object_store_memory: int | None = None,
        is_head: bool = False,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        cfg = get_config()
        self.node_id = NodeID.from_random()
        self.gcs_host, self.gcs_port = gcs_host, gcs_port
        self.host = host
        self.resources_total = dict(resources)
        self.resources_available = dict(resources)
        # Which cards are granted: each GPU actor, lease and task is
        # confined to its own through CUDA_VISIBLE_DEVICES.
        self.gpus = GPUInstances(
            self.resources_total.get("GPU", 0),
            GPUAcceleratorManager.get_current_process_visible_accelerator_ids(),
        )
        self.labels = labels or {}
        self.is_head = is_head
        self.store_name = f"/rttorch_{self.node_id.hex()[:12]}"
        self.store = ObjectStore(
            self.store_name,
            object_store_memory or cfg.object_store_memory,
            create=True,
        )
        self.rpc = RpcServer(host, port)
        self.gcs: Optional[Connection] = None
        self.workers: Dict[bytes, WorkerHandle] = {}
        # True once the node has spawned any worker: gates the warm-pool
        # replenisher so idle nodes never fork spares.
        self._pool_demand_seen = False
        self._replenish_timer: Optional[asyncio.Task] = None
        # Queues keyed by scheduling class (resource shape + runtime-env
        # hash + pg bundle) — the reference queues per scheduling class
        # (cluster_task_manager.cc) so one blocked shape never forces a
        # rescan of every queued task: dispatch cost is O(classes +
        # dispatched), not O(queued), per wake-up. A single global deque
        # made a 10k-task drain O(n^2) (~100 tasks/s sustained).
        self.task_queues: Dict[tuple, deque] = {}  # class -> (spec, fut)
        # Resources demanded by queued-but-undispatched tasks; makes the
        # submit-time spillover decision aware of committed local work
        # (ClusterResourceScheduler accounts for queued demand the same way).
        self.queued_demand: Dict[str, float] = {}
        self.inflight: Dict[bytes, dict] = {}  # task_id -> {spec, fut, worker}
        self.bundles: Dict[tuple, Dict[str, float]] = {}  # (pg_id, idx) -> resources
        self.peer_conns: Dict[bytes, Connection] = {}
        self._peer_locks: Dict[bytes, asyncio.Lock] = {}
        self.node_cache: Dict[bytes, dict] = {}
        self._dispatch_event = asyncio.Event()
        self._zygote = None  # lazy ZygoteManager (worker fork server)
        self._proc_samples: Dict[int, tuple] = {}  # pid -> (jiffies, t)
        self._stopping = False
        self._bg: List[asyncio.Task] = []
        # Task state-transition events, batched to the GCS task-event sink
        # (TaskEventBuffer -> GcsTaskManager, task_event_buffer.h:206).
        self._task_events: List[dict] = []
        self._jobs: Dict[str, subprocess.Popen] = {}  # submission_id -> driver
        self._job_stops: set = set()  # submission_ids with a stop requested
        # runtime_env hash -> (error, ts): envs whose setup failed recently;
        # tasks targeting them fail fast instead of crash-looping workers.
        self._bad_runtime_envs: Dict[Optional[str], tuple] = {}
        # Primary-copy pinning + spill bookkeeping (LocalObjectManager:
        # primary copies are pinned in plasma and spilled — never silently
        # evicted; raylet/local_object_manager.h:41).
        self._primary_pins: Dict[bytes, int] = {}  # oid -> size (pin order)
        self._last_infeasible_check = 0.0
        # task_id -> resources for every queued-undispatched task; stable
        # across a dispatch pass (items in the pass-local requeue list are
        # still here), so heartbeats report true demand.
        self._queued_specs: Dict[bytes, Dict[str, float]] = {}
        # Graceful drain: set from heartbeat replies once the GCS cordons
        # this node (h_cordon_node); new work then spills remote.
        self._draining = False
        # ray_syncer-style delta sync state (_sync_resources).
        self._sync_version = 0
        self._synced_resources: Optional[Dict[str, float]] = None
        self._synced_demand_sig: Optional[int] = None
        self._infeasible_warned: set = set()
        self._queued_since: Dict[bytes, float] = {}
        self._spilled: Dict[bytes, str] = {}  # oid -> restore uri
        self._storage = None  # lazy external storage
        self._spill_lock = asyncio.Lock()
        self._object_waiters: Dict[bytes, List[asyncio.Event]] = defaultdict(list)
        # Pull admission control (PullManager analog, pull_manager.h:52):
        # bound concurrent inbound transfers so a burst of dependency
        # fetches can't thrash the store/network; single-flight per object.
        self._pull_slots = asyncio.Semaphore(cfg.pull_max_concurrent)
        # Flow control (VERDICT r2 item 7):
        #  * pull admission by BYTES with smallest-first priority under
        #    contention (PullManager's memory-quota + prioritized queue,
        #    object_manager/pull_manager.h:52) — a storm of large pulls
        #    cannot overcommit the store while small ready objects wait;
        #  * push-side in-flight chunk cap (PushManager throttling,
        #    push_manager.h:30) — a popular node bounds concurrent chunk
        #    reads it serves so one broadcast can't monopolize its loop.
        self._pull_budget = _PullByteBudget(
            max(int((object_store_memory or cfg.object_store_memory)
                    * cfg.pull_budget_fraction), 64 * 1024 * 1024)
        )
        self._push_chunk_slots = asyncio.Semaphore(cfg.push_chunk_slots)
        self._active_pulls: Dict[bytes, asyncio.Future] = {}
        # In-progress pulls exposing their contiguous filled prefix for
        # chained pullers: oid -> {buf, filled, total, event, failed}.
        self._partial_pulls: Dict[bytes, dict] = {}
        # Attached same-host peer stores (store_name -> ObjectStore).
        self._peer_stores: Dict[str, Any] = {}
        self._proc_stats_cursor = 0  # round-robin /proc sampling window
        # Bounds concurrent worker interpreter boots (actor creation
        # bursts) so the raylet loop keeps heartbeating under fork storms.
        self._boot_gate = asyncio.Semaphore(
            max(1, get_config().worker_boot_concurrency)
        )
        # Open chunked remote-client puts: oid -> (buffer, abort deadline).
        self._client_creates: Dict[bytes, tuple] = {}
        # Runtime metric counters (reported as deltas on the heartbeat).
        self._metrics_seq = 0
        self._metric_tasks_dispatched = 0
        self._metric_tasks_failed = 0
        self._metric_objects_spilled = 0
        self._metric_bytes_spilled = 0
        # Scheduler queue instrumentation (control-plane profiler): how
        # many dispatch passes ran, how many head-of-queue scans they
        # did, how many leases were granted — plus last-pass gauges, so
        # "queue scans per dispatched task" is a reported number.
        self._metric_dispatch_passes = 0
        self._metric_dispatch_scans = 0
        self._metric_lease_grants = 0
        self._last_dispatch_batch = 0
        self._last_dispatch_scan = 0
        self._metric_reported: Dict[str, int] = {}
        # Control-plane profiler: enqueue stamps for sampled specs
        # (task_id -> (monotonic, epoch)), closed into queue_wait at
        # dispatch; bounded against leaks from forwarded/failed tasks.
        self._lc_enqueue: Dict[bytes, tuple] = {}

        r = self.rpc.register
        r("register_worker", self.h_register_worker)
        r("worker_env_failed", self.h_worker_env_failed)
        r("submit_task", self.h_submit_task)
        r("task_done", self.h_task_done)
        r("pull_object", self.h_pull_object)
        r("fetch_chunk", self.h_fetch_chunk)
        r("fetch_chunk_raw", self.h_fetch_chunk_raw)
        r("wait_object_local", self.h_wait_object_local)
        r("object_created", self.h_object_created)
        r("objects_created", self.h_objects_created)
        r("spill_objects", self.h_spill_objects)
        r("restore_spilled", self.h_restore_spilled)
        r("free_objects", self.h_free_objects)
        r("client_put", self.h_client_put)
        r("client_create", self.h_client_create)
        r("client_put_chunk", self.h_client_put_chunk)
        r("client_seal", self.h_client_seal)
        r("client_get_info", self.h_client_get_info)
        r("get_info", self.h_get_info)
        r("prestart_workers", self.h_prestart_workers)
        r("worker_stacks", self.h_worker_stacks)
        r("lease_worker", self.h_lease_worker)
        r("release_lease", self.h_release_lease)
        r("retire_worker", self.h_retire_worker)
        r("list_logs", self.h_list_logs)
        r("read_log", self.h_read_log)
        # A crashed owner must not leak its leased workers' resources.
        self.rpc.on_disconnect = self._on_client_disconnect

    # ------------------------------------------------------------------
    _GCS_CHANNELS = ("create_actor", "kill_actor_worker", "reserve_bundle",
                     "cancel_bundle", "node_dead", "node_added", "run_job",
                     "stop_job", "free_objects")

    async def _register_with_gcs(self, gcs):
        await gcs.call(
            "register_node",
            {
                "node_id": self.node_id.binary(),
                "address": self.host,
                "port": self.port,
                "object_store_name": self.store_name,
                "machine_id": _machine_id(),
                "resources": self.resources_total,
                "labels": self.labels,
                "is_head": self.is_head,
            },
        )
        for ch in self._GCS_CHANNELS:
            await gcs.call("subscribe", {"channel": ch})

    async def _reconnect_gcs(self):
        """The GCS died: redial until it (or its restarted successor) is
        back, then re-register this node and its subscriptions. This is the
        raylet half of GCS fault tolerance — live cluster state is rebuilt
        from re-registration, durable tables from the GCS snapshot
        (gcs_redis_failure_detector analog with roles reversed: raylets
        outlive the GCS instead of suiciding)."""
        while not self._stopping:
            try:
                gcs = await connect(
                    self.gcs_host, self.gcs_port,
                    push_handler=self._on_gcs_push,
                    timeout=get_config().gcs_reconnect_dial_timeout_s,
                )
                await self._register_with_gcs(gcs)
                self.gcs = gcs
                return
            except Exception:  # noqa: BLE001
                await asyncio.sleep(0.5)

    async def start(self) -> int:
        journal.set_process_label("raylet", weak=True)
        port = await self.rpc.start()
        self.port = port
        self.gcs = await connect(
            self.gcs_host, self.gcs_port, push_handler=self._on_gcs_push
        )
        await self._register_with_gcs(self.gcs)
        self._bg.append(asyncio.ensure_future(self._dispatch_loop()))
        self._bg.append(asyncio.ensure_future(self._heartbeat_loop()))
        self._bg.append(asyncio.ensure_future(self._reap_loop()))
        self._bg.append(asyncio.ensure_future(self._spill_loop()))
        self._bg.append(asyncio.ensure_future(self._memory_monitor_loop()))
        return port

    async def stop(self):
        self._stopping = True
        for t in self._bg:
            t.cancel()
        for w in self.workers.values():
            try:
                w.proc.terminate()
            except Exception:
                pass
        # One shared grace period, polled asynchronously: blocking per-worker
        # wait() would stall the event loop that delivers zygote-fork death
        # notices (2s per worker instead of 2s total).
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            if all(
                w.proc is None or w.proc.poll() is not None
                for w in self.workers.values()
            ):
                break
            await asyncio.sleep(0.05)
        for w in self.workers.values():
            try:
                if w.proc is not None and w.proc.poll() is None:
                    w.proc.kill()
            except Exception:
                pass
        # The zygote is process-shared (atexit-owned): not stopped here.
        await self.rpc.stop()
        if self.gcs:
            await self.gcs.close()
        self.store.destroy()

    async def kill(self):
        """Abrupt death for fault injection: SIGKILL the workers, drop every
        connection, no draining, no GCS goodbye — the in-process equivalent
        of `kill -9` on a raylet (chaos tests; RayletKiller analog)."""
        self._stopping = True
        for t in self._bg:
            t.cancel()
        for w in self.workers.values():
            try:
                w.proc.kill()
            except Exception:  # noqa: BLE001
                pass
        await self.rpc.stop()
        if self.gcs:
            await self.gcs.close()
        for c in self.peer_conns.values():
            try:
                await c.close()
            except Exception:  # noqa: BLE001
                pass
        self.peer_conns.clear()

    # -- GCS pushes ------------------------------------------------------
    def _on_gcs_push(self, channel: str, payload: Any):
        spawn(self._handle_gcs_push(channel, payload))

    async def _handle_gcs_push(self, channel: str, payload: Any):
        if channel == "create_actor":
            await self._create_actor_worker(payload)
        elif channel == "kill_actor_worker":
            aid = payload["actor_id"]
            for w in list(self.workers.values()):
                if w.actor_id == aid:
                    await self._report_worker_dead(w, intended=True, reason="rt.kill")
                    if payload.get("will_restart") or not (
                        await self._try_recycle_actor_worker(w, aid)
                    ):
                        w.proc.kill()
                        self._forget_worker(w)
        elif channel == "reserve_bundle":
            # Prepare phase: deduct from local availability so heartbeats
            # reflect the reservation and plain tasks cannot steal the
            # gang-reserved resources (placement_group_resource_manager.h).
            key = (payload["pg_id"], payload["bundle_index"])
            if key not in self.bundles:
                self.bundles[key] = {
                    "resources": dict(payload["resources"]),
                    "available": dict(payload["resources"]),
                }
                self._acquire(payload["resources"])
        elif channel == "cancel_bundle":
            bundle = self.bundles.pop(
                (payload["pg_id"], payload["bundle_index"]), None
            )
            if bundle is not None:
                # Credit only the bundle's *unused* share back: tasks still
                # running inside the bundle physically hold the rest, and
                # their completion release falls through to
                # resources_available once the bundle is gone. Crediting
                # the full reservation here would transiently oversubscribe
                # the node — routine under preemption, where bundles are
                # cancelled mid-flight all the time.
                for k, v in bundle["available"].items():
                    self.resources_available[k] = (
                        self.resources_available.get(k, 0) + v
                    )
                self._dispatch_event.set()
        elif channel == "run_job":
            await self._run_job(payload)
        elif channel == "stop_job":
            proc = self._jobs.get(payload["submission_id"])
            self._job_stops.add(payload["submission_id"])
            if proc is not None and proc.poll() is None:
                # The entrypoint runs under a shell: signal the whole
                # process group so the driver (and its children) die too,
                # not just the shell — otherwise the inherited stdout pipe
                # keeps the log stream (and job state) alive.
                import signal

                try:
                    os.killpg(proc.pid, signal.SIGTERM)
                except (ProcessLookupError, PermissionError):
                    proc.terminate()
        elif channel == "free_objects":
            for oid in payload["object_ids"]:
                self._free_local(oid)
        elif channel == "node_added":
            # A new node may satisfy queued-infeasible tasks: re-check now.
            self.node_cache.pop(payload.get("node_id"), None)
            self._last_infeasible_check = 0.0
            self._dispatch_event.set()
        elif channel == "node_dead":
            nid = payload["node_id"]
            conn = self.peer_conns.pop(nid, None)
            if conn:
                await conn.close()
            self.node_cache.pop(nid, None)
            self._peer_locks.pop(nid, None)

    # -- worker pool -----------------------------------------------------
    def _spawn_worker(self, runtime_env: Optional[dict] = None) -> WorkerHandle:
        """Fork a worker process (WorkerPool::StartWorkerProcess analog)."""
        self._pool_demand_seen = True
        worker_id = os.urandom(16)
        env = dict(os.environ)
        if runtime_env:
            import json as _json

            env["RT_RUNTIME_ENV"] = _json.dumps(runtime_env)
            for k, v in (runtime_env.get("env_vars") or {}).items():
                env[k] = str(v)
        # Propagate this process's import paths so by-reference cloudpickle
        # functions (modules outside site-packages, e.g. the driver's
        # project) resolve in workers — the role the reference's
        # working_dir runtime env plays for the common co-located case.
        # (Standalone raylet daemons on other machines still need proper
        # code shipping via the GCS — future runtime-env work.)
        # Keep zipimport entries (files); drop empties so no implicit-cwd
        # component is ever synthesized by a trailing separator.
        env["PYTHONPATH"] = self._propagated_pythonpath(env.get("PYTHONPATH", ""))
        env.update(getattr(self, "spawn_env_overrides", None) or {})
        env["RT_WORKER_ID"] = worker_id.hex()
        env["RT_NODE_ID"] = self.node_id.hex()
        env["RT_RAYLET_PORT"] = str(self.port)
        env["RT_GCS_ADDR"] = f"{self.gcs_host}:{self.gcs_port}"
        env["RT_STORE_NAME"] = self.store_name
        # Fast path: fork from the zygote (one warm interpreter, see
        # _private/zygote.py) instead of booting a fresh interpreter +
        # imports (~300ms) per worker. Falls back to Popen while the
        # zygote warms up or if it keeps dying.
        proc = None
        if get_config().zygote_enabled and not env.get("RT_DISABLE_ZYGOTE"):
            if self._zygote is None:
                from ray_tpu_torch._private.zygote_client import get_shared_manager

                self._zygote = get_shared_manager()
            proc = self._zygote.spawn(env)
        if proc is None:
            proc = subprocess.Popen(  # rtlint: disable=RT008 — fork+exec is bounded; worker spawn is a rare control-plane op and stdout is drained off-loop
                [sys.executable, "-m", "ray_tpu_torch._private.worker_main"],
                env=env,
                stdout=None,
                stderr=None,
            )
        handle = WorkerHandle(
            proc, worker_id,
            runtime_env_hash=runtime_env.get("hash") if runtime_env else None,
        )
        self.workers[worker_id] = handle
        return handle

    async def h_register_worker(self, d, conn: ServerConnection):
        w = self.workers.get(d["worker_id"])
        if w is None:  # externally started (tests)
            w = WorkerHandle(None, d["worker_id"])
            self.workers[d["worker_id"]] = w
        w.conn = conn
        w.port = d["port"]
        w.registered.set()
        conn.meta["worker_id"] = d["worker_id"]
        # A successful start clears any recorded env failure for this hash.
        self._bad_runtime_envs.pop(w.runtime_env_hash, None)
        self._dispatch_event.set()
        return {"node_id": self.node_id.binary()}

    async def h_worker_env_failed(self, d, conn):
        """A starting worker could not materialize its runtime env: fail
        queued tasks with that env instead of crash-looping spawns."""
        renv_hash = d.get("runtime_env_hash")
        error = d.get("error", "runtime_env setup failed")
        self._bad_runtime_envs[renv_hash] = (error, time.monotonic())
        w = self.workers.get(d.get("worker_id"))
        if w is not None:
            self._forget_worker(w)
        self._dispatch_event.set()
        return {"ok": True}

    async def _try_recycle_actor_worker(self, w: WorkerHandle, aid: bytes) -> bool:
        """Return a cleanly-killed actor's worker to the pool instead of
        forking its replacement from scratch. The worker refuses (and the
        process dies, the reference semantics) when any call is still
        running — a thread mid-call cannot be stopped. Workers are already
        reused across tasks of a job; a torn-down actor has the same
        contamination surface."""
        cfg = get_config()
        if not cfg.actor_worker_recycle or w.port is None:
            return False
        # Only recycle while the pool is below the node's worker cap: a
        # 1000-actor teardown must not strand 1000 idle interpreters (and
        # their per-worker release RPCs) — beyond the cap the process
        # just dies. Up to the cap, recycled workers are exactly the pool
        # the next creation burst adopts from.
        n_pooled = sum(
            1 for x in self.workers.values()
            if x.actor_id is None and x.runtime_env_hash is None
            and x.lease_resources is None and x.idle
        )
        if n_pooled >= cfg.max_workers_per_node:
            return False
        try:
            # w.conn is the worker->raylet push channel (ServerConnection,
            # no request/response); dial the worker's own RPC port (cached
            # across recycles).
            if w.dial is None or w.dial._closed:
                w.dial = await connect(
                    "127.0.0.1", w.port,
                    timeout=cfg.worker_dial_timeout_s,
                )
            r = await asyncio.wait_for(
                w.dial.call("release_actor", {"actor_id": aid}),
                cfg.release_actor_timeout_s,
            )
        except Exception:  # noqa: BLE001 — worker wedged; kill it
            return False
        if not r.get("recycled"):
            return False
        # Return the actor's held resources (the _forget_worker accounting,
        # without forgetting the worker).
        bundle_key = getattr(w, "actor_bundle", None)
        bundle = self.bundles.get(bundle_key) if bundle_key else None
        if bundle is not None:
            for k, v in w.actor_resources.items():
                bundle["available"][k] = bundle["available"].get(k, 0) + v
        else:
            for k, v in w.actor_resources.items():
                self.resources_available[k] = (
                    self.resources_available.get(k, 0) + v
                )
        self._give_gpus(w.actor_gpu_ids, w.actor_resources)
        w.actor_gpu_ids = []
        w.actor_resources = {}
        w.actor_id = None
        w.actor_bundle = None
        w.idle = True
        w.last_idle_time = time.monotonic()
        self._dispatch_event.set()
        return True

    def _replenish_idle_pool(self):
        """Keep a few registered default-env workers warm so actor creation
        and lease grants skip the fork+boot on their critical path (the
        reference's worker-pool prestart role, worker_pool.h:347 — here
        demand-triggered: nothing forks until the node first spawns).

        Debounced: the fork happens a beat later, off the creation/kill
        critical path, and not at all if a recycled worker returns to the
        pool in the meantime."""
        if not get_config().worker_pool_min_idle or not self._pool_demand_seen:
            return
        if self._replenish_timer is None or self._replenish_timer.done():
            self._replenish_timer = spawn(self._replenish_after_debounce())

    async def _replenish_after_debounce(self):
        await asyncio.sleep(get_config().worker_pool_replenish_debounce_s)
        cfg = get_config()
        n_pooled = sum(
            1 for w in self.workers.values()
            if w.actor_id is None and w.runtime_env_hash is None
            and w.lease_resources is None and (w.idle or w.conn is None)
        )
        n_spawn = min(
            cfg.worker_pool_min_idle - n_pooled,
            cfg.max_workers_per_node - len(self.workers),
        )
        for _ in range(max(0, n_spawn)):
            self._spawn_worker(None)

    def _forget_worker(self, w: WorkerHandle):
        self.workers.pop(w.worker_id, None)
        w.registered.set()  # wake creation waiters; they re-check liveness
        if w.actor_id is not None:
            # An actor worker died: top the pool back up so the next
            # creation burst adopts instead of forking.
            self._replenish_idle_pool()
        # Return a direct-transport lease's held resources.
        if w.lease_resources is not None:
            for k, v in w.lease_resources.items():
                self.resources_available[k] = (
                    self.resources_available.get(k, 0) + v
                )
            self._give_gpus(w.lease_gpu_ids, w.lease_resources)
            w.lease_gpu_ids = []
            w.lease_resources = None
        # Return an actor worker's held resources.
        if w.actor_id is not None and w.actor_resources:
            self._give_gpus(w.actor_gpu_ids, w.actor_resources)
            w.actor_gpu_ids = []
            bundle_key = getattr(w, "actor_bundle", None)
            bundle = self.bundles.get(bundle_key) if bundle_key else None
            if bundle is not None:
                for k, v in w.actor_resources.items():
                    bundle["available"][k] = bundle["available"].get(k, 0) + v
            else:
                for k, v in w.actor_resources.items():
                    self.resources_available[k] = (
                        self.resources_available.get(k, 0) + v
                    )
            w.actor_resources = {}

    async def _report_worker_dead(self, w: WorkerHandle, intended=False, reason=""):
        # The raylet death notice: first link after an injected kill in
        # the postmortem causal chain (it sees the process exit before
        # the GCS or any serve-layer observer).
        journal.emit(
            "raylet.worker_dead",
            actor_id=w.actor_id.hex() if w.actor_id else "",
            intended=bool(intended), reason=reason,
        )
        if not intended:
            from ray_tpu_torch.util.event import record_event

            record_event(
                "raylet", f"worker died unexpectedly: {reason}",
                severity="WARNING",
                node_id=self.node_id.hex(),
                worker_id=w.worker_id.hex()
                if isinstance(w.worker_id, bytes) else str(w.worker_id),
                actor_id=w.actor_id.hex() if w.actor_id else None,
            )
        if w.actor_id is not None:
            await self.gcs.call(
                "worker_dead",
                {
                    "actor_id": w.actor_id,
                    "intended": intended,
                    "reason": reason,
                    "no_restart": False,
                },
            )

    async def _reap_loop(self):
        """Detect dead worker processes; fail their tasks/actors."""
        cfg = get_config()
        while True:
            await asyncio.sleep(cfg.reap_interval_s)
            # Abort chunked remote-client puts whose client vanished.
            now = time.monotonic()
            for oid, (buf, deadline) in list(self._client_creates.items()):
                if now > deadline:
                    self._client_creates.pop(oid, None)
                    del buf
                    try:
                        self.store.abort(ObjectID(oid))
                    except Exception:  # noqa: BLE001
                        pass
            for w in list(self.workers.values()):
                if w.proc is not None and w.proc.poll() is not None:
                    self._forget_worker(w)
                    # fail in-flight task
                    if w.current_task is not None:
                        entry = self.inflight.pop(w.current_task, None)
                        if entry and not entry["fut"].done():
                            entry["fut"].set_result(
                                {"status": "worker_crashed",
                                 "error": f"worker exited with code {w.proc.returncode}"}
                            )
                        if entry:
                            self._metric_tasks_failed += 1
                            self._release_task_resources(entry["spec"])
                            self._record_task_event(
                                entry["spec"], "FAILED", worker_id=w.worker_id
                            )
                    await self._report_worker_dead(
                        w, intended=False,
                        reason=f"worker process exited ({w.proc.returncode})",
                    )
                    self._dispatch_event.set()

    # -- memory monitor / OOM policy --------------------------------------
    def _sample_proc_stats(self):
        """Per-worker CPU%% + RSS from /proc (the reference's per-process
        native stats role, src/ray/stats/; sampled each heartbeat).
        Bounded per tick: at most proc_stats_sample_max workers are read
        per pass (round-robin), so observability cost stays O(1) per tick
        however many workers the node hosts."""
        page = os.sysconf("SC_PAGE_SIZE")
        hz = os.sysconf("SC_CLK_TCK")
        now = time.monotonic()
        workers = list(self.workers.values())
        cap = get_config().proc_stats_sample_max
        if len(workers) > cap:
            start = self._proc_stats_cursor % len(workers)
            self._proc_stats_cursor = (start + cap) % len(workers)
            workers = (workers + workers)[start:start + cap]
        for w in workers:
            pid = getattr(w.proc, "pid", None)
            if pid is None:
                continue
            try:
                with open(f"/proc/{pid}/stat") as f:
                    parts = f.read().rsplit(") ", 1)[-1].split()
                utime, stime = int(parts[11]), int(parts[12])
                with open(f"/proc/{pid}/statm") as f:
                    rss_pages = int(f.read().split()[1])
            except (OSError, IndexError, ValueError):
                continue
            jiffies = utime + stime
            prev = self._proc_samples.get(pid)
            cpu = 0.0
            if prev is not None and now > prev[1]:
                cpu = 100.0 * (jiffies - prev[0]) / hz / (now - prev[1])
            self._proc_samples[pid] = (jiffies, now)
            w.cpu_percent = round(max(cpu, 0.0), 1)
            w.rss_bytes = rss_pages * page
        # Prune exited workers: a recycled pid must not inherit a stale
        # jiffies baseline (wrong first sample), nor may the dict grow
        # with worker churn.
        live = {
            getattr(w.proc, "pid", None) for w in self.workers.values()
        }
        for pid in [p for p in self._proc_samples if p not in live]:
            del self._proc_samples[pid]

    def _memory_usage_fraction(self) -> float:
        """Node memory usage (tests override this).

        Prefers the memory cgroup when limited — in a container the cgroup
        OOM killer fires long before host MemAvailable moves, so reading
        /proc/meminfo alone would never trip the policy (the reference's
        MemoryMonitor reads cgroup usage the same way)."""
        try:
            # cgroup v2, then v1; a limit of "max"/huge means unlimited.
            for cur_p, max_p in (
                ("/sys/fs/cgroup/memory.current", "/sys/fs/cgroup/memory.max"),
                ("/sys/fs/cgroup/memory/memory.usage_in_bytes",
                 "/sys/fs/cgroup/memory/memory.limit_in_bytes"),
            ):
                try:
                    with open(max_p) as f:
                        raw = f.read().strip()
                    if raw == "max":
                        continue
                    limit = int(raw)
                    if limit <= 0 or limit > 1 << 60:
                        continue
                    with open(cur_p) as f:
                        current = int(f.read().strip())
                    return current / limit
                except (FileNotFoundError, ValueError):
                    continue
            info = {}
            with open("/proc/meminfo") as f:
                for line in f:
                    key, _, rest = line.partition(":")
                    info[key] = int(rest.strip().split()[0])
            total = info.get("MemTotal", 0)
            if total <= 0 or "MemAvailable" not in info:
                return 0.0  # can't measure: never report pressure
            return 1.0 - info["MemAvailable"] / total
        except Exception:  # noqa: BLE001 — non-Linux or restricted /proc
            return 0.0

    def _pick_oom_victim(self):
        """Newest retriable task first, newest task as fallback — the
        reference's retriable-FIFO killing policy
        (raylet/worker_killing_policy.cc)."""
        candidates = []
        for entry in self.inflight.values():
            w = entry.get("worker")
            if w is None or w.proc is None:
                continue
            candidates.append(
                (bool(entry["spec"].get("retriable", True)),
                 entry.get("start", 0.0), w, entry)
            )
        if not candidates:
            return None
        retriable = [c for c in candidates if c[0]]
        pool = retriable or candidates
        pool.sort(key=lambda c: c[1])
        _, _, w, entry = pool[-1]
        return w, entry

    async def _memory_monitor_loop(self):
        """Kill a task's worker before the OS OOM-killer takes the raylet
        (reference: MemoryMonitor + worker_killing_policy.cc; threshold
        memory_usage_threshold, ray_config_def.h:77)."""
        cfg = get_config()
        if not cfg.memory_monitor_enabled or cfg.memory_monitor_interval_s <= 0:
            return
        while True:
            await asyncio.sleep(cfg.memory_monitor_interval_s)
            try:
                frac = self._memory_usage_fraction()
                if frac < cfg.memory_usage_threshold:
                    continue
                victim = self._pick_oom_victim()
                if victim is None:
                    continue
                w, entry = victim
                spec = entry["spec"]
                print(
                    f"[ray_tpu_torch] memory monitor: node at "
                    f"{frac:.0%} >= {cfg.memory_usage_threshold:.0%}; "
                    f"killing worker of task "
                    f"{spec.get('name') or spec['task_id'].hex()[:8]} "
                    f"(newest retriable) — it will be retried.",
                    file=sys.stderr, flush=True,
                )
                self._record_task_event(
                    spec, "OOM_KILLED", worker_id=w.worker_id,
                    memory_fraction=frac,
                )
                try:
                    w.proc.kill()  # reap loop fails the task as retriable
                    from ray_tpu_torch.util.event import record_event

                    record_event(
                        "raylet", "OOM policy killed a worker",
                        severity="ERROR",
                        node_id=self.node_id.hex(),
                        task=(entry["spec"].get("name") or ""),
                        memory_fraction=round(frac, 3),
                    )
                except Exception:  # noqa: BLE001
                    pass
            except Exception:  # noqa: BLE001
                pass

    @staticmethod
    def _set_actor_fields(w: WorkerHandle, payload, resources, sched, bundle):
        w.actor_id = payload["actor_id"]
        w.actor_resources = dict(resources)
        w.actor_bundle = (
            (sched["pg_id"], sched.get("bundle_index") or 0)
            if bundle is not None else None
        )

    async def _create_actor_worker(self, payload):
        """Spawn a dedicated worker for an actor and hand it the create spec.

        The actor's resources are held for the worker's lifetime (the
        reference acquires them through the lease protocol; tasks here
        release per-call, actors release on death)."""
        resources = payload.get("resources", {})
        sched = payload.get("scheduling") or {}
        bundle = None
        if sched.get("type") == "placement_group":
            bundle = self.bundles.get(
                (sched["pg_id"], sched.get("bundle_index") or 0)
            )
        if bundle is not None:
            for k, v in resources.items():
                bundle["available"][k] = bundle["available"].get(k, 0) - v
        else:
            if resources and not self._available_locally(resources):
                # The GCS placed against a stale advisory view (its
                # deduction raced a heartbeat overwrite). Acquiring anyway
                # would oversubscribe chips a placement group already
                # reserved — bounce the actor back to the pending queue,
                # where the retry loop re-places it (or arms preemption).
                await self.gcs.call(
                    "actor_unplaceable",
                    {"actor_id": payload["actor_id"],
                     "node_id": self.node_id.binary()},
                )
                return
            self._acquire(resources)
        renv = payload["create_spec"].get("runtime_env")
        # A registered idle pool worker with the right env adopts the actor
        # — the whole fork+boot disappears from the creation critical path
        # (the reference pops actors from the shared worker pool the same
        # way, worker_pool.cc PopWorker). A background replacement fork
        # keeps the pool warm for the next creation burst.
        w = self._idle_worker(renv.get("hash") if renv else None)
        if w is not None:
            w.idle = False
            self._replenish_idle_pool()
            self._set_actor_fields(w, payload, resources, sched, bundle)
        else:
            # Fork under the boot gate: a 1000-actor burst must not start
            # 1000 interpreter boots at once — unbounded boots starve the
            # raylet loop long enough for the GCS to declare the NODE dead
            # (health check timeout). K boots in flight keeps heartbeats
            # flowing; queued creations wait their turn.
            async with self._boot_gate:
                w = self._spawn_worker(renv)
                w.idle = False
                self._set_actor_fields(w, payload, resources, sched, bundle)
                self._replenish_idle_pool()
                # Wait for registration INSIDE the gate (the boot is the
                # resource being bounded; a second wait outside would
                # double the stall for a worker that never registers).
                # Budget covers runtime-env download/extraction in the
                # starting worker.
                try:
                    await asyncio.wait_for(
                        w.registered.wait(),
                        get_config().worker_register_timeout_s,
                    )
                except asyncio.TimeoutError:
                    pass
        if w.conn is None:
            await self.gcs.call(
                "worker_dead",
                {"actor_id": w.actor_id, "reason": "actor worker failed to start"},
            )
            return
        create_spec = dict(payload["create_spec"])
        create_spec.setdefault("resources", resources)
        if resources.get("GPU", 0) > 0:
            w.actor_gpu_ids = self._take_gpus(w, resources)
            create_spec["gpu_ids"] = w.actor_gpu_ids
        await w.conn.push("create_actor", create_spec)

    @staticmethod
    def _propagated_pythonpath(existing: str = "") -> str:
        """This process's import paths, for child processes (workers, job
        drivers) so by-reference code and ray_tpu_torch itself resolve."""
        import ray_tpu_torch

        pkg_root = os.path.dirname(
            os.path.dirname(os.path.abspath(ray_tpu_torch.__file__))
        )
        extra = [p for p in sys.path if p and os.path.exists(p)]
        return os.pathsep.join(p for p in [pkg_root, *extra, existing] if p)

    # -- job supervision -------------------------------------------------
    async def _run_job(self, payload):
        """Spawn a detached driver subprocess for a submitted job and
        stream its output + exit state to the GCS (JobSupervisor analog,
        dashboard/modules/job/job_manager.py:140)."""
        submission_id = payload["submission_id"]
        env = dict(os.environ)
        env["RT_GCS_ADDR"] = f"{self.gcs_host}:{self.gcs_port}"
        env["RT_JOB_SUBMISSION_ID"] = submission_id
        renv = payload.get("runtime_env") or {}
        for k, v in (renv.get("env_vars") or {}).items():
            env[k] = str(v)
        cwd = None
        pkg_uris = list(renv.get("py_module_uris") or ())
        wd_uri = renv.get("working_dir_uri")
        if wd_uri or pkg_uris:
            from ray_tpu_torch.runtime_env.runtime_env import (GcsKvAdapter,
                                                               _materialize)

            kv = GcsKvAdapter(self.gcs, asyncio.get_event_loop())
            loop = asyncio.get_event_loop()
            try:
                extra_paths = []
                for uri in pkg_uris:
                    extra_paths.append(
                        await loop.run_in_executor(None, _materialize, kv, uri)
                    )
                if wd_uri:
                    cwd = await loop.run_in_executor(None, _materialize, kv, wd_uri)
                    extra_paths.insert(0, cwd)
                env["PYTHONPATH"] = os.pathsep.join(
                    [*extra_paths, env.get("PYTHONPATH", "")]
                ).rstrip(os.pathsep)
            except Exception as e:  # noqa: BLE001
                await self.gcs.call(
                    "job_update",
                    {"submission_id": submission_id, "state": "FAILED",
                     "message": f"runtime_env setup failed: {e}"},
                )
                return
        env["PYTHONPATH"] = self._propagated_pythonpath(env.get("PYTHONPATH", ""))
        if renv:
            import json as _json

            # The driver's ray_tpu_torch.init() picks this up so the job's own
            # tasks/actors inherit the job runtime env.
            env["RT_JOB_RUNTIME_ENV"] = _json.dumps(renv)
        if submission_id in self._job_stops:
            # A stop arrived while the runtime env was materializing (the
            # proc was not in self._jobs yet): honor it instead of running
            # the driver to completion and reporting SUCCEEDED.
            self._job_stops.discard(submission_id)
            await self.gcs.call(
                "job_update",
                {"submission_id": submission_id, "state": "STOPPED",
                 "message": "stopped before start"},
            )
            return
        try:
            proc = subprocess.Popen(  # rtlint: disable=RT008 — fork+exec is bounded; job launch is rare and the streaming reads below are executor-shipped
                payload["entrypoint"],
                shell=True,
                env=env,
                cwd=cwd,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                start_new_session=True,
            )
        except OSError as e:
            await self.gcs.call(
                "job_update",
                {"submission_id": submission_id, "state": "FAILED",
                 "message": f"failed to start: {e}"},
            )
            return
        self._jobs[submission_id] = proc
        if submission_id in self._job_stops:
            # Stop raced the Popen window: kill the fresh process group now;
            # _stream_job reports STOPPED when it reaps the signal exit.
            import signal

            try:
                os.killpg(proc.pid, signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                proc.terminate()
        await self.gcs.call(
            "job_update", {"submission_id": submission_id, "state": "RUNNING"}
        )
        spawn(self._stream_job(submission_id, proc))

    async def _stream_job(self, submission_id: str, proc: subprocess.Popen):
        import codecs

        loop = asyncio.get_event_loop()
        fd = proc.stdout.fileno()
        # Incremental decoder: a multibyte UTF-8 character split across a
        # read boundary carries over instead of becoming U+FFFD garbage.
        decoder = codecs.getincrementaldecoder("utf-8")(errors="replace")
        while True:
            # Raw fd read: returns as soon as ANY bytes arrive, so sparse
            # driver output streams live instead of waiting for a full
            # 64 KB buffered-read quantum.
            chunk = await loop.run_in_executor(None, os.read, fd, 65536)
            text = decoder.decode(chunk, final=not chunk)
            if not chunk and not text:
                break
            try:
                await self.gcs.call(
                    "job_log_append",
                    {"submission_id": submission_id, "data": text},
                )
            except Exception:
                pass
            if not chunk:
                break
        rc = await loop.run_in_executor(None, proc.wait)
        self._jobs.pop(submission_id, None)
        stop_requested = submission_id in self._job_stops
        self._job_stops.discard(submission_id)
        # A signal exit counts as STOPPED only when a stop was actually
        # requested; an OOM-kill or external SIGKILL is a failure.
        state = "SUCCEEDED" if rc == 0 else (
            "STOPPED" if rc < 0 and stop_requested else "FAILED"
        )
        try:
            await self.gcs.call(
                "job_update",
                {"submission_id": submission_id, "state": state,
                 "message": f"driver exited with code {rc}"},
            )
        except Exception:
            pass

    async def h_prestart_workers(self, d, conn):
        n = d.get("num", 1)
        for _ in range(n):
            self._spawn_worker()
        return {"ok": True}

    # -- task events -----------------------------------------------------
    def _record_task_event(self, spec: dict, state: str, **extra):
        ev = {
            "task_id": spec.get("task_id", b""),
            "name": spec.get("name") or "",
            "job_id": spec.get("job_id", b""),
            "node_id": self.node_id.binary(),
            "type": "NORMAL_TASK",
            "state": state,
            "ts": time.time(),
        }
        ev.update(extra)
        self._task_events.append(ev)

    # -- scheduling ------------------------------------------------------
    def _feasible_locally(self, resources: Dict[str, float]) -> bool:
        return all(
            self.resources_total.get(k, 0) + 1e-9 >= v for k, v in resources.items()
        )

    def _available_locally(self, resources: Dict[str, float]) -> bool:
        return all(
            self.resources_available.get(k, 0) + 1e-9 >= v
            for k, v in resources.items()
        )

    def _available_for_new_work(self, resources: Dict[str, float]) -> bool:
        """Availability minus demand already committed to the local queue."""
        return all(
            self.resources_available.get(k, 0) - self.queued_demand.get(k, 0) + 1e-9
            >= v
            for k, v in resources.items()
        )

    def _queued_demand_add(self, resources: Dict[str, float], sign: float,
                           spec: Optional[dict] = None):
        for k, v in resources.items():
            self.queued_demand[k] = self.queued_demand.get(k, 0) + sign * v
        # Mirror the queue in a pass-stable map so the heartbeat's demand
        # snapshot never observes the transient mid-dispatch empty queue.
        if spec is not None:
            if sign > 0:
                self._queued_specs[spec["task_id"]] = resources
            else:
                self._queued_specs.pop(spec["task_id"], None)
                self._queued_since.pop(spec["task_id"], None)
                self._infeasible_warned.discard(spec["task_id"])

    def _acquire(self, resources: Dict[str, float]):
        for k, v in resources.items():
            self.resources_available[k] = self.resources_available.get(k, 0) - v

    def _take_gpus(self, w: WorkerHandle, resources) -> List[str]:
        ids = self.gpus.take(resources.get("GPU", 0), prefer=w.last_gpu_ids)
        w.last_gpu_ids = ids
        return ids

    def _give_gpus(self, ids: List[str], resources) -> None:
        if ids:
            self.gpus.give(ids, resources.get("GPU", 0))

    def _bundle_for(self, spec) -> Optional[dict]:
        pb = spec.get("pg_bundle")
        if not pb:
            return None
        return self.bundles.get((pb[0], pb[1]))

    def _could_acquire(self, spec) -> bool:
        """Non-mutating twin of _try_acquire_for: would this task's
        resources be acquirable right now? Used by the worker-spawn gate."""
        resources = spec.get("resources", {})
        if spec.get("pg_bundle") is not None:
            bundle = self._bundle_for(spec)
            return bundle is not None and all(
                bundle["available"].get(k, 0) + 1e-9 >= v
                for k, v in resources.items()
            )
        return self._available_locally(resources)

    def _try_acquire_for(self, spec) -> bool:
        """Acquire task resources — from its placement-group bundle if the
        task targets one, else from node availability."""
        resources = spec.get("resources", {})
        bundle = self._bundle_for(spec)
        if spec.get("pg_bundle") is not None:
            if bundle is None:
                return False  # bundle cancelled; caller errors the task
            avail = bundle["available"]
            if not all(avail.get(k, 0) + 1e-9 >= v for k, v in resources.items()):
                return False
            for k, v in resources.items():
                avail[k] = avail.get(k, 0) - v
            return True
        if not self._available_locally(resources):
            return False
        self._acquire(resources)
        return True

    def _release_task_resources(self, spec):
        resources = spec.get("resources", {})
        self._give_gpus(spec.pop("gpu_ids", None), resources)
        bundle = self._bundle_for(spec)
        if spec.get("pg_bundle") is not None:
            if bundle is not None:
                for k, v in resources.items():
                    bundle["available"][k] = bundle["available"].get(k, 0) + v
                return
            # Bundle cancelled while the task ran (preemption's normal
            # case): cancel_bundle credited only the bundle's unused
            # share, so this task's share goes straight back to the node
            # — dropping it would leak the resources for good.
        for k, v in resources.items():
            self.resources_available[k] = self.resources_available.get(k, 0) + v

    def _critical_utilization(self) -> float:
        util = 0.0
        for k, total in self.resources_total.items():
            if total > 0:
                util = max(
                    util, 1.0 - self.resources_available.get(k, 0) / total
                )
        return util

    async def _pick_node_by_labels(self, hard: Dict[str, str],
                                   soft: Dict[str, str]) -> Optional[bytes]:
        """NodeLabelSchedulingStrategy (util/scheduling_strategies.py:135
        in the reference): hard labels must all match; soft labels break
        ties."""
        resp = await self.gcs.call("get_nodes", {})
        best, best_soft = None, -1
        for n in resp["nodes"]:
            if n["state"] != "ALIVE" or n.get("draining"):
                continue
            labels = n.get("labels") or {}
            if not all(labels.get(k) == v for k, v in hard.items()):
                continue
            nsoft = sum(1 for k, v in soft.items() if labels.get(k) == v)
            if nsoft > best_soft:
                best, best_soft = n["node_id"], nsoft
        return best

    def _pick_remote_node_from(self, nodes, resources) -> Optional[dict]:
        """Best remote node by lowest utilization (hybrid policy tail)."""
        best, best_util = None, None
        for n in nodes:
            if (n["state"] != "ALIVE" or n.get("draining")
                    or n["node_id"] == self.node_id.binary()):
                continue
            avail, total = n["resources_available"], n["resources_total"]
            if not all(avail.get(k, 0) + 1e-9 >= v for k, v in resources.items()):
                continue
            util = 0.0
            for k, t in total.items():
                if t > 0:
                    util = max(util, 1.0 - avail.get(k, 0) / t)
            if best_util is None or util < best_util:
                best, best_util = n, util
        return best

    async def _pick_remote_node(self, resources) -> Optional[dict]:
        resp = await self.gcs.call("get_nodes", {})
        return self._pick_remote_node_from(resp["nodes"], resources)

    async def h_submit_task(self, d, conn):
        """Queue a task; the response resolves when the task completes.

        This fuses the reference's RequestWorkerLease
        (node_manager.cc:1722) + PushTask into a single call: the driver's
        submit RPC stays open (pipelined with others on the connection) and
        its response carries the result or its location.
        """
        spec = d
        fut = asyncio.get_event_loop().create_future()

        sched = spec.get("scheduling") or {}
        resources = spec.get("resources", {})
        target_node: Optional[bytes] = None

        hard_here = spec.get("hard_affinity") or (
            sched.get("type") == "node_affinity"
            and sched.get("node_id") == self.node_id.binary()
            and not sched.get("soft", False)
        )
        if self._draining and hard_here:
            # Hard affinity to a draining node can never be honored
            # (PG-scheduled work is exempt: its bundle holds resources
            # and the drain waits for the group's removal).
            return {
                "status": "error",
                "error": "node is draining: hard node affinity cannot "
                         "be honored",
            }

        if sched.get("type") == "node_affinity":
            target_node = sched["node_id"]
            if not sched.get("soft", False):
                # Survives the forward's scheduling strip so a draining
                # target can tell pinned-affinity work (reject) from
                # ordinary spillover (accept: it pre-dates the cordon).
                spec["hard_affinity"] = True
        elif sched.get("type") == "placement_group":
            pg = await self.gcs.call("get_placement_group", {"pg_id": sched["pg_id"]})
            if not pg["pg"] or pg["pg"]["state"] != "CREATED":
                return {"status": "error", "error": "placement group not ready"}
            idx = sched.get("bundle_index") or 0
            target_node = pg["pg"]["bundle_nodes"][idx]
            spec["pg_bundle"] = [sched["pg_id"], idx]
        elif sched.get("type") == "node_label":
            target_node = await self._pick_node_by_labels(
                sched.get("hard", {}), sched.get("soft", {})
            )
            if target_node is None:
                return {
                    "status": "error",
                    "error": f"no node matches hard labels {sched.get('hard')}",
                }
        elif sched.get("type") == "spread":
            node = await self._pick_remote_node(resources)
            if node is not None and self._critical_utilization() > 0:
                target_node = node["node_id"]

        if target_node is not None and target_node != self.node_id.binary():
            return await self._forward_task(spec, target_node)

        if target_node is None and not spec.get("forwarded"):
            # Hybrid policy (hybrid_scheduling_policy.cc:186): prefer local
            # until the critical resource passes the spread threshold, then
            # pick the least-utilized feasible remote node. Queued-but-
            # undispatched demand counts as local load. Forwarded tasks are
            # pinned here (single spillback, like the reference's lease
            # spillback counting).
            cfg = get_config()
            if (self._draining or not self._feasible_locally(resources)
                    or not self._available_for_new_work(resources)):
                node = await self._pick_remote_node(resources)
                if node is not None:
                    result = await self._forward_task(spec, node["node_id"])
                    if not (
                        result.get("status") == "error"
                        and "target node unavailable"
                        in str(result.get("error", ""))
                    ):
                        return result
                    # The chosen peer died mid-handoff: fall through and
                    # queue locally — retries/rescheduling own it from here.
                # No node fits today: stay queued — the dispatch loop
                # re-evaluates remote placement as nodes join (the
                # reference keeps infeasible tasks pending for the
                # autoscaler to satisfy).

        self._enqueue_task(spec, fut)
        self._queued_demand_add(resources, +1, spec)
        self._record_task_event(spec, "PENDING_SCHEDULING")
        if spec.get("sampled"):
            self._lc_enqueue[spec["task_id"]] = (time.monotonic(), time.time())
            if len(self._lc_enqueue) > 16384:
                # Entries for forwarded/cancelled tasks never close;
                # drop oldest rather than grow without bound.
                self._lc_enqueue.pop(next(iter(self._lc_enqueue)), None)
        self._dispatch_event.set()
        return await fut

    @staticmethod
    def _sched_class(spec) -> tuple:
        """Scheduling class: tasks in one class are interchangeable for
        dispatch (same resource shape, runtime env, bundle, and priority),
        so a blocked head task blocks only its own class. Priority leads
        the tuple: the dispatch loop walks classes highest-first, so a
        high-priority class never waits behind best-effort work for the
        same resources."""
        pg = spec.get("pg_bundle")
        return (
            int(spec.get("priority") or 0),
            spec.get("runtime_env_hash"),
            tuple(sorted((spec.get("resources") or {}).items())),
            tuple(pg) if pg else None,
        )

    def _enqueue_task(self, spec, fut):
        self.task_queues.setdefault(self._sched_class(spec), deque()).append(
            (spec, fut)
        )

    def _queued_task_count(self) -> int:
        return sum(len(q) for q in self.task_queues.values())

    async def h_lease_worker(self, d, conn):
        """Grant an idle worker to the calling owner for direct task
        pushes (RequestWorkerLease, direct_task_transport.cc:409). The
        lease holds the requested resources until release_lease, worker
        death, or owner disconnect; the owner streams run_task_direct
        calls straight to the worker, skipping this raylet per task."""
        if self._draining:
            # A cordoned node must not grant NEW leases: the lease path
            # bypasses h_submit's drain spill, so a colocated driver
            # would keep streaming work here and rt drain could only
            # time out. "none" pushes owners onto the submit path,
            # which spills remote.
            return {"status": "none"}
        resources = d.get("resources") or {}
        renv_hash = d.get("runtime_env_hash")
        worker = self._idle_worker(renv_hash)
        if worker is None or not self._available_locally(resources):
            # Opportunistically grow the pool so a later lease lands.
            if self._available_for_new_work(resources):
                cfg = get_config()
                n_live = sum(
                    1 for w in self.workers.values() if w.actor_id is None
                )
                n_starting = sum(
                    1 for w in self.workers.values()
                    if w.actor_id is None and w.conn is None
                    and w.runtime_env_hash == renv_hash
                )
                if n_live < cfg.max_workers_per_node and n_starting < 4:
                    self._spawn_worker(d.get("runtime_env"))
            return {"status": "none"}
        self._acquire(resources)
        worker.idle = False
        worker.lease_resources = dict(resources)
        worker.lease_gpu_ids = self._take_gpus(worker, resources)
        worker.leased_by = conn  # released if this owner disconnects
        self._metric_lease_grants += 1
        return {
            "status": "ok",
            "worker_id": worker.worker_id,
            "host": self.host,
            "port": worker.port,
            "gpu_ids": worker.lease_gpu_ids or None,
        }

    def _revoke_direct_leases(self):
        """Drain must also cover leases granted BEFORE the cordon: tell
        each lease's owner to stop streaming direct tasks here and hand
        the worker back (in-flight calls finish first, owner-side).
        Without this a colocated driver keeps the node busy via the
        lease path — which bypasses h_submit's drain spill — and
        rt drain can only time out."""
        for w in self.workers.values():
            conn = getattr(w, "leased_by", None)
            if w.lease_resources is not None and conn is not None \
                    and not conn.closed:
                spawn(conn.push("lease_revoked",
                                {"worker_id": w.worker_id}))

    def _release_lease_of(self, w: WorkerHandle):
        if w.lease_resources is None:
            return
        for k, v in w.lease_resources.items():
            self.resources_available[k] = (
                self.resources_available.get(k, 0) + v
            )
        self._give_gpus(w.lease_gpu_ids, w.lease_resources)
        w.lease_gpu_ids = []
        w.lease_resources = None
        w.leased_by = None
        w.idle = True
        w.last_idle_time = time.monotonic()
        self._dispatch_event.set()

    async def h_release_lease(self, d, conn):
        w = self.workers.get(d["worker_id"])
        if w is not None:
            self._release_lease_of(w)
        return {"ok": True}

    @staticmethod
    def _log_dir() -> str:
        from ray_tpu_torch._private.config import session_log_dir

        return session_log_dir()

    async def h_list_logs(self, d, conn):
        """This node's session log files (reference: the `ray logs` list
        served by per-node log agents, dashboard/modules/log)."""
        out = []
        base = self._log_dir()
        try:
            names = sorted(os.listdir(base))
        except FileNotFoundError:
            names = []
        for name in names:
            path = os.path.join(base, name)
            try:
                st = os.stat(path)
            except OSError:
                continue  # rotated/deleted mid-listing: skip just it
            if os.path.isfile(path):
                out.append({"name": name, "size": st.st_size,
                            "mtime": st.st_mtime})
        return {"logs": out}

    async def h_read_log(self, d, conn):
        """Tail of one named log file; the name is basename-sanitized so
        callers cannot escape the log directory."""
        name = os.path.basename(d.get("name", ""))
        if not name:
            return {"ok": False, "error": "missing log name"}
        path = os.path.join(self._log_dir(), name)  # basename: no escape
        n = int(d.get("tail_bytes", 64 * 1024))
        try:
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - n))
                data = f.read(n)
        except OSError as e:
            return {"ok": False, "error": str(e)}
        return {"ok": True, "data": data, "size": size}

    async def h_retire_worker(self, d, conn):
        """A worker crossed its max_calls threshold: stop dispatching to
        it and kill it shortly (reference: the worker exits after the
        task when @ray.remote(max_calls=N) is hit; here the raylet owns
        the removal so there is no window where a doomed worker still
        receives work)."""
        w = self.workers.get(d["worker_id"])
        if w is None:
            return {"ok": False}
        w.retired = True
        w.idle = False

        async def _kill_late():
            # Late fallback only: the worker flushes its in-flight
            # replies and self-exits (worker_main._retire). SIGTERM
            # here must not race the threshold-crossing task's reply
            # onto the worker->owner connection, so the grace period
            # is generous.
            await asyncio.sleep(3.0)
            try:
                if w.proc is not None and w.proc.poll() is None:
                    w.proc.terminate()
            except Exception:  # noqa: BLE001
                pass

        spawn(_kill_late())
        return {"ok": True}

    async def _on_client_disconnect(self, conn):
        """An owner connection died: return every lease it held (the
        reference's lease lifetime is likewise bounded by the owner,
        direct_task_transport.cc ReturnWorker on disconnect)."""
        for w in list(self.workers.values()):
            if getattr(w, "leased_by", None) is conn:
                self._release_lease_of(w)

    async def _forward_and_resolve(self, spec, fut, node_id: bytes):
        """Forward a queued task; on transport failure put it back in the
        queue (the task was promised to wait for capacity, not to fail on
        a flaky handoff)."""
        try:
            result = await self._forward_task(spec, node_id)
        except Exception as e:  # noqa: BLE001 — peer died mid-call
            result = {"status": "error",
                      "error": f"target node unavailable: {e}"}
        if (
            result.get("status") == "error"
            and "target node unavailable" in str(result.get("error", ""))
        ):
            if not fut.done():
                self._enqueue_task(spec, fut)
                self._queued_demand_add(spec.get("resources", {}), +1, spec)
                self._dispatch_event.set()
            return
        if not fut.done():
            fut.set_result(result)

    async def _forward_task(self, spec, node_id: bytes):
        conn = await self._peer(node_id)
        if conn is None:
            return {"status": "error", "error": "target node unavailable"}
        spec = dict(spec)
        spec["scheduling"] = None  # already routed
        spec["forwarded"] = True
        try:
            return await conn.call("submit_task", spec, timeout=None)
        except Exception as e:  # noqa: BLE001 — peer died mid-call
            return {
                "status": "error",
                "error": f"target node unavailable: {e}",
            }

    async def _peer(self, node_id: bytes) -> Optional[Connection]:
        # Single-flight per node: concurrent forwards must share one
        # connection (racing connects leaked Connections whose GC closed
        # sockets under pending calls).
        lock = self._peer_locks.setdefault(node_id, asyncio.Lock())
        async with lock:
            conn = self.peer_conns.get(node_id)
            if conn is not None and not conn._closed:
                return conn
            info = self.node_cache.get(node_id)
            if info is None:
                resp = await self.gcs.call("get_nodes", {})
                for n in resp["nodes"]:
                    self.node_cache[n["node_id"]] = n
                info = self.node_cache.get(node_id)
            if info is None or info["state"] != "ALIVE":
                return None
            try:
                # Short dial timeout: waiters queue behind this lock, so a
                # blackholed peer must fail fast, not serialize 10s stalls.
                conn = await connect(
                    info["address"], info["port"],
                    timeout=get_config().peer_dial_timeout_s,
                )
            except OSError:
                return None
            self.peer_conns[node_id] = conn
            return conn

    async def _dispatch_loop(self):
        """LocalTaskManager::DispatchScheduledTasksToWorkers analog.

        Per wake-up, each scheduling class dispatches from its own queue
        until that class blocks (no worker / no resources / infeasible).
        A blocked class costs O(1) per pass, so draining N homogeneous
        queued tasks is O(N) total, not O(N^2)."""
        cfg = get_config()
        while True:
            await self._dispatch_event.wait()
            self._dispatch_event.clear()
            ctx = {"nodes": None}  # one get_nodes snapshot per pass
            blocked = False
            self._metric_dispatch_passes += 1
            scans0 = self._metric_dispatch_scans
            dispatched0 = self._metric_tasks_dispatched
            # Highest priority class first (priority leads the class
            # tuple): a spike's tasks dispatch before best-effort work
            # contending for the same freed resources.
            for key in sorted(self.task_queues.keys(),
                              key=lambda k: -k[0]):
                q = self.task_queues.get(key)
                if not q:
                    self.task_queues.pop(key, None)
                    continue
                blocked |= await self._dispatch_class(q, ctx, cfg)
            self._last_dispatch_batch = self._metric_tasks_dispatched - dispatched0
            self._last_dispatch_scan = self._metric_dispatch_scans - scans0
            if self._last_dispatch_batch:
                # Per-PASS summary, never per task: dispatch decisions
                # reach the journal at wake-up granularity so a million-
                # task drain costs journal appends proportional to passes.
                journal.emit(
                    "raylet.dispatch",
                    granted=self._last_dispatch_batch,
                    scanned=self._last_dispatch_scan,
                    queued=sum(len(q) for q in self.task_queues.values()),
                )
            if blocked:
                # Blocked on resources/workers: rescan the moment anything
                # completes (h_task_done sets the event) instead of a fixed
                # sleep — the sleep gated every wave of a large batch to
                # 20ms and capped batched throughput at ~200 tasks/s. The
                # timeout keeps infeasible tasks re-checking for new nodes.
                try:
                    await asyncio.wait_for(
                        self._dispatch_event.wait(),
                        cfg.dispatch_rescan_interval_s,
                    )
                except asyncio.TimeoutError:
                    self._dispatch_event.set()

    async def _dispatch_class(self, q: deque, ctx: dict, cfg) -> bool:
        """Dispatch one scheduling class until it empties or blocks.
        Returns True if tasks remain queued (class is blocked)."""
        while q:
            spec, fut = q[0]
            self._metric_dispatch_scans += 1
            if fut.done():
                q.popleft()
                self._queued_demand_add(spec.get("resources", {}), -1, spec)
                continue
            resources = spec.get("resources", {})
            if spec.get("pg_bundle") is not None and self._bundle_for(spec) is None:
                q.popleft()
                self._queued_demand_add(resources, -1, spec)
                if not fut.done():
                    fut.set_result(
                        {"status": "error",
                         "error": "placement group bundle was removed"}
                    )
                continue
            if (self._draining or not self._feasible_locally(resources)) \
                    and not spec.get("forwarded"):
                # Infeasible here (or this node is draining): hand off
                # once a feasible node joins (autoscaled nodes register
                # with the GCS). One cluster snapshot per 0.5s pass
                # serves ALL infeasible classes — a poison class must not
                # starve placeable ones. While draining, queued demand
                # keeps the node's drain_status non-idle, so the drain
                # waits rather than stranding these tasks.
                now = time.monotonic()
                if ctx["nodes"] is None and now - self._last_infeasible_check >= 0.5:
                    self._last_infeasible_check = now
                    try:
                        ctx["nodes"] = (await self.gcs.call("get_nodes", {}))["nodes"]
                    except Exception:
                        ctx["nodes"] = []
                node = (
                    self._pick_remote_node_from(ctx["nodes"], resources)
                    if ctx["nodes"] is not None
                    else None
                )
                if node is not None:
                    node["resources_available"] = {
                        k: node["resources_available"].get(k, 0) - v
                        for k, v in resources.items()
                    } | {
                        k: v
                        for k, v in node["resources_available"].items()
                        if k not in resources
                    }
                    q.popleft()
                    self._queued_demand_add(resources, -1, spec)
                    spawn(
                        self._forward_and_resolve(spec, fut, node["node_id"])
                    )
                    continue
                tid = spec["task_id"]
                first = self._queued_since.setdefault(tid, now)
                if now - first > cfg.infeasible_warn_s and tid not in self._infeasible_warned:
                    self._infeasible_warned.add(tid)
                    print(
                        f"[ray_tpu_torch] WARNING: task {spec.get('name') or tid.hex()[:8]} "
                        f"has been infeasible for 30s (needs {resources}); "
                        "no node in the cluster can satisfy it — waiting "
                        "for the autoscaler or a new node.",
                        file=sys.stderr, flush=True,
                    )
                return True
            deps = spec.get("deps") or []
            missing = [d for d in deps if not self.store.contains_raw(d)]
            if missing:
                q.popleft()
                spawn(self._fetch_then_requeue(spec, fut, missing))
                continue
            renv_hash = spec.get("runtime_env_hash")
            bad = self._bad_runtime_envs.get(renv_hash)
            if bad is not None and time.monotonic() - bad[1] < cfg.bad_runtime_env_ttl_s:
                q.popleft()
                self._queued_demand_add(resources, -1, spec)
                if not fut.done():
                    fut.set_result(
                        {"status": "error",
                         "error": f"runtime_env setup failed: {bad[0]}"}
                    )
                continue
            worker = self._idle_worker(renv_hash)
            if worker is None:
                if not self._could_acquire(spec):
                    # Every matching resource is already acquired by
                    # running tasks — a fresh worker could not take this
                    # task either. Spawning here is the storm that burns
                    # CPU on worker startup instead of task execution.
                    # (Bundle-targeted tasks check their bundle's share:
                    # a bundle reserving the whole node zeroes node
                    # availability, yet its own tasks must still spawn.)
                    return True
                # Spawn only as many workers as there is queued work,
                # counting ones still starting up (WorkerPool prestart
                # logic, worker_pool.h:347) — never a spawn storm.
                n_live = sum(
                    1 for w in self.workers.values() if w.actor_id is None
                )
                n_starting = sum(
                    1
                    for w in self.workers.values()
                    if w.actor_id is None and w.conn is None
                    and w.runtime_env_hash == renv_hash
                )
                # Bound prestart by how many tasks of this footprint can
                # actually run at once — with 4 free CPUs and CPU:1
                # tasks, 4 workers saturate the node; the 5th..16th only
                # burn startup CPU the running tasks need.
                cap = None
                for k, v in resources.items():
                    if v > 0:
                        c = int(self.resources_available.get(k, 0) // v)
                        cap = c if cap is None else min(cap, c)
                wanted = len(q)
                if cap is not None:
                    wanted = min(wanted, max(cap, 1))
                if n_live >= cfg.max_workers_per_node and n_starting == 0:
                    # Pool full of other-env workers: replace an idle one
                    # so a new env hash can't starve (the reference kills
                    # idle workers to make room the same way).
                    victim = next(
                        (
                            w
                            for w in self.workers.values()
                            if w.idle and w.actor_id is None
                            and w.conn is not None
                            and w.runtime_env_hash != renv_hash
                        ),
                        None,
                    )
                    if victim is not None:
                        try:
                            victim.proc.kill()
                        except Exception:
                            pass
                        self._forget_worker(victim)
                        n_live -= 1
                if n_live < cfg.max_workers_per_node and n_starting < wanted:
                    self._spawn_worker(spec.get("runtime_env"))
                return True
            if not self._try_acquire_for(spec):
                # Preemption cancels bundles at arbitrary points: when
                # that is why acquisition failed, error the task now
                # rather than leaving the whole class blocked until the
                # next pass's head check notices.
                if spec.get("pg_bundle") is not None \
                        and self._bundle_for(spec) is None:
                    q.popleft()
                    self._queued_demand_add(resources, -1, spec)
                    if not fut.done():
                        fut.set_result(
                            {"status": "error",
                             "error": "placement group bundle was removed"}
                        )
                    continue
                return True
            lc = (
                self._lc_enqueue.pop(spec["task_id"], None)
                if spec.get("sampled")
                else None
            )
            if resources.get("GPU", 0) > 0:
                spec["gpu_ids"] = self._take_gpus(worker, resources)
            else:
                spec.pop("gpu_ids", None)
            t_disp = time.monotonic()
            q.popleft()
            self._queued_demand_add(resources, -1, spec)
            worker.idle = False
            worker.current_task = spec["task_id"]
            self.inflight[spec["task_id"]] = {
                "spec": spec,
                "fut": fut,
                "worker": worker,
                "start": time.monotonic(),
            }
            self._metric_tasks_dispatched += 1
            self._record_task_event(
                spec, "RUNNING", worker_id=worker.worker_id
            )
            await worker.conn.push("run_task", spec)
            if lc is not None:
                # queue_wait: submit-RPC arrival -> dispatch decision;
                # dispatch: decision -> run_task pushed to the worker.
                qw = max(0.0, t_disp - lc[0])
                self._task_events.append(lifecycle.event(
                    spec["task_id"], spec.get("name") or "",
                    spec.get("job_id", b""), self.node_id.binary(),
                    "raylet",
                    {"queue_wait": [lc[1], qw],
                     "dispatch": [lc[1] + qw,
                                  max(0.0, time.monotonic() - t_disp)]},
                    worker_id=worker.worker_id,
                ))
        return False

    def _idle_worker(self, renv_hash: Optional[str] = None) -> Optional[WorkerHandle]:
        for w in self.workers.values():
            if (
                w.idle
                and not w.retired
                and w.conn is not None
                and w.actor_id is None
                and w.runtime_env_hash == renv_hash
            ):
                return w
        return None

    async def _fetch_then_requeue(self, spec, fut, missing):
        """DependencyManager analog: pull remote deps then requeue."""
        try:
            await asyncio.gather(*[self._ensure_local(oid) for oid in missing])
        except Exception as e:  # noqa: BLE001
            self._queued_demand_add(spec.get("resources", {}), -1, spec)
            if not fut.done():
                fut.set_result({"status": "error", "error": f"dependency fetch failed: {e}"})
            return
        self._enqueue_task(spec, fut)
        self._dispatch_event.set()

    def _free_local(self, oid: bytes):
        """Drop this node's copies of a freed object: primary pin, store
        entry (best-effort: readers still mapping it defer to LRU eviction,
        which reclaims refcount-0 objects with zero IO), and spill file."""
        if oid in self._primary_pins:
            try:
                self.store.release(ObjectID(oid))
            except Exception:  # noqa: BLE001
                pass
            self._primary_pins.pop(oid, None)
        try:
            self.store.delete(ObjectID(oid))
        except Exception:  # noqa: BLE001
            pass
        uri = self._spilled.pop(oid, None)
        if uri:
            try:
                self._get_storage().delete([uri])
            except Exception:  # noqa: BLE001
                pass

    async def h_free_objects(self, d, conn):
        """Owner-driven free (the last ObjectRef died): reclaim local
        copies, then let the GCS fan the free out to every other node
        holding a copy or a spill file."""
        oids = list(d["object_ids"])
        for oid in oids:
            self._free_local(oid)
        try:
            await self.gcs.call("objects_freed", {"object_ids": oids})
        except Exception:  # noqa: BLE001
            pass
        return {"ok": True, "count": len(oids)}

    async def h_task_done(self, d, conn):
        """Worker reports task completion (the PushTask reply path)."""
        entry = self.inflight.pop(d["task_id"], None)
        if entry is None:
            return {"ok": False}
        w = entry["worker"]
        w.idle = True
        w.current_task = None
        w.last_idle_time = time.monotonic()
        self._release_task_resources(entry["spec"])
        if d["result"].get("status") != "ok":
            self._metric_tasks_failed += 1
        self._record_task_event(
            entry["spec"],
            "FINISHED" if d["result"].get("status") == "ok" else "FAILED",
            worker_id=w.worker_id,
        )
        if not entry["fut"].done():
            entry["fut"].set_result(d["result"])
        self._dispatch_event.set()
        return {"ok": True}

    # -- object transfer -------------------------------------------------
    async def _ensure_local(self, oid_bytes: bytes, timeout: float = 60.0):
        """Pull an object into the local store (PullManager analog):
        single-flight per object, bounded concurrent transfers; spilled
        objects are restored by their spill node first
        (AsyncRestoreSpilledObject, local_object_manager.h:122)."""
        if self.store.contains_raw(oid_bytes):
            return
        # Single-flight per object: loop (not a one-shot check) so waiters
        # that wake concurrently never register duplicate pulls over each
        # other; a failed pull propagates so waiters retry deliberately.
        while True:
            existing = self._active_pulls.get(oid_bytes)
            if existing is None:
                break
            try:
                await asyncio.shield(existing)
            except asyncio.CancelledError:
                if not existing.done():
                    raise  # WE were cancelled; the leader is still going
                # The LEADER was cancelled: fall through and retry.
            except Exception:  # noqa: BLE001 — leader failed; we may retry
                pass
            if self.store.contains_raw(oid_bytes):
                return
        fut = asyncio.get_event_loop().create_future()
        fut.add_done_callback(lambda f: f.exception())  # consumed by waiters
        self._active_pulls[oid_bytes] = fut
        try:
            await self._ensure_local_inner(oid_bytes, timeout)
        except BaseException as e:
            if not fut.done():
                fut.set_exception(e)
            raise
        finally:
            self._active_pulls.pop(oid_bytes, None)
            if not fut.done():
                fut.set_result(None)

    async def _ensure_local_inner(self, oid_bytes: bytes, timeout: float = 60.0):
        if self.store.contains_raw(oid_bytes):
            return
        resp = await self.gcs.call(
            "object_location_wait", {"object_id": oid_bytes, "timeout": timeout}
        )
        spilled = resp.get("spilled")
        if not resp["nodes"] and spilled:
            spill_node = spilled["node_id"]
            if spill_node == self.node_id.binary():
                r = await self.h_restore_spilled({"object_id": oid_bytes}, None)
                if not r.get("ok"):
                    raise KeyError(
                        f"restore of spilled object {oid_bytes.hex()} failed: "
                        f"{r.get('error')}"
                    )
                return
            peer = await self._peer(spill_node)
            if peer is None:
                raise KeyError(
                    f"spill node for {oid_bytes.hex()} is unreachable"
                )
            r = await peer.call("restore_spilled", {"object_id": oid_bytes})
            if not r.get("ok"):
                raise KeyError(f"remote restore failed: {r.get('error')}")
            resp = await self.gcs.call(
                "object_location_get", {"object_id": oid_bytes}
            )
        me = self.node_id.binary()
        if resp.get("timeout") or (
            not resp["nodes"] and not self.store.contains_raw(oid_bytes)
        ):
            if self.store.contains_raw(oid_bytes):
                return
            raise KeyError(f"object {oid_bytes.hex()} has no locations")
        if self.store.contains_raw(oid_bytes):
            return
        # Announce this pull as a PARTIAL location: once chunks land,
        # other pullers may chain off our filled prefix instead of all
        # fanning into the source (chain/tree replication; reference
        # object_manager.cc:339 any-holder pulls). seq keeps chains
        # acyclic: we only ever chain to partials senior to us.
        reg = await self.gcs.call(
            "object_location_add",
            {"object_id": oid_bytes, "node_id": me, "partial": True},
        )
        my_seq = reg.get("seq")
        progress = {
            "buf": None, "filled": 0, "total": None,
            "event": asyncio.Event(), "failed": False,
        }
        self._partial_pulls[oid_bytes] = progress
        ok = False
        try:
            last_err = None
            for attempt in range(3):
                full = [n for n in resp["nodes"] if n != me]
                partials = [
                    nid for nid, seq in resp.get("partial_nodes", [])
                    if nid != me and seq < my_seq
                ]
                # Same-host holders first: their store lives in the same
                # /dev/shm, so the object moves as ONE cross-store memcpy
                # (no TCP, no chunking) — the multi-raylet-per-host case
                # the test clusters and single-host pods hit.
                if get_config().same_host_shm_transfer:
                    for nid in full:
                        info = await self._node_info(nid)
                        if (
                            info
                            and info.get("machine_id")
                            and info.get("machine_id") == _machine_id()
                            and info.get("object_store_name")
                        ):
                            try:
                                if await self._shm_copy_from(
                                    info["object_store_name"], oid_bytes
                                ):
                                    await self.gcs.call(
                                        "object_location_add",
                                        {"object_id": oid_bytes, "node_id": me,
                                         "size": resp.get("size") or 0},
                                    )
                                    ok = True
                                    return
                            except Exception as e:  # noqa: BLE001
                                last_err = e
                for nid in full + partials:
                    peer = await self._peer(nid)
                    if peer is None:
                        continue
                    try:
                        async with self._pull_slots:
                            # Admission control bounds the TRANSFER only —
                            # holding a slot across object_location_wait
                            # would let 8 unproduced dependencies starve
                            # ready pulls for 60s. Byte budget on top:
                            # smallest-first under contention.
                            size = int(resp.get("size") or 0)
                            await self._pull_budget.acquire(size)
                            try:
                                await self._pull_from(
                                    peer, oid_bytes, size, progress
                                )
                            finally:
                                self._pull_budget.release(size)
                        await self.gcs.call(
                            "object_location_add",
                            {
                                "object_id": oid_bytes,
                                "node_id": me,
                                "size": resp["size"],
                            },
                        )
                        ok = True
                        return
                    except Exception as e:  # noqa: BLE001
                        last_err = e
                # Every candidate failed (e.g. our upstream partial
                # aborted): refresh the location view and retry.
                resp = await self.gcs.call(
                    "object_location_get", {"object_id": oid_bytes}
                )
                if self.store.contains_raw(oid_bytes):
                    ok = True
                    return
            raise KeyError(
                f"failed to pull object {oid_bytes.hex()}: {last_err}"
            )
        finally:
            self._partial_pulls.pop(oid_bytes, None)
            progress["failed"] = not ok
            progress["event"].set()  # wake chained servers either way
            if not ok:
                try:
                    await self.gcs.call(
                        "object_location_remove",
                        {"object_id": oid_bytes, "node_id": me,
                         "partial_only": True},
                    )
                except Exception:  # noqa: BLE001
                    pass

    async def _node_info(self, node_id: bytes) -> Optional[dict]:
        info = self.node_cache.get(node_id)
        if info is None:
            resp = await self.gcs.call("get_nodes", {})
            for n in resp["nodes"]:
                self.node_cache[n["node_id"]] = n
            info = self.node_cache.get(node_id)
        return info

    def _attach_peer_store(self, store_name: str):
        st = self._peer_stores.get(store_name)
        if st is None:
            try:
                st = ObjectStore(store_name)
            except Exception:  # noqa: BLE001 — peer store gone/unreachable
                return None
            self._peer_stores[store_name] = st
        return st

    async def _shm_copy_from(self, store_name: str, oid_bytes: bytes) -> bool:
        """Copy a sealed object straight out of a same-host peer's shared
        -memory store (cross-process get/release ride the store's robust
        shm mutex). Returns False if the peer doesn't hold it."""
        peer_store = self._attach_peer_store(store_name)
        if peer_store is None:
            return False
        from ray_tpu_torch._private.ids import ObjectID

        oid = ObjectID(oid_bytes)
        view = peer_store.get(oid)  # refcount pin against peer eviction
        if view is None:
            return False
        try:
            total = len(view)
            buf = await self._create_with_spill(oid, total)
            if buf is None:
                return True  # a concurrent pull materialized it
            try:
                # Same teardown guard as the chunk path: no await between
                # the check and the write into our (possibly unmapped on
                # stop) store.
                if self._stopping:
                    raise asyncio.CancelledError("raylet stopping")
                buf[:] = view
            except BaseException:
                del buf
                self.store.abort(oid)
                raise
            del buf
            self.store.seal(oid)
            self.store.release(oid)
            return True
        finally:
            del view
            peer_store.release(oid)

    async def _pull_from(self, peer: Connection, oid_bytes: bytes, size: int,
                         progress: Optional[dict] = None):
        """Chunked pull (ObjectManager::Push sends 5MiB chunks,
        object_manager.cc:325; chunk size ray_config_def.h:362).
        A WINDOW of chunk fetches rides the connection concurrently
        (request/response round trips hide behind each other), and the
        contiguous filled prefix is published through `progress` so
        chained pullers can consume it mid-transfer."""
        cfg = get_config()
        from ray_tpu_torch._private.ids import ObjectID

        oid = ObjectID(oid_bytes)
        meta = await peer.call("pull_object", {"object_id": oid_bytes})
        if not meta.get("ok"):
            raise KeyError(meta.get("error", "remote miss"))
        total = meta["size"]
        if self.store.contains(oid):
            return
        buf = await self._create_with_spill(oid, total)
        if buf is None:
            return  # concurrent pull is materializing it
        chunk = cfg.object_transfer_chunk_size
        offsets = list(range(0, total, chunk))
        received: set = set()
        if progress is not None:
            progress["buf"] = buf
            progress["total"] = total
        window = asyncio.Semaphore(max(1, cfg.pull_chunk_window))

        async def fetch(off: int):
            n = min(chunk, total - off)
            async with window:
                resp = await peer.call(
                    "fetch_chunk_raw",
                    {"object_id": oid_bytes, "offset": off, "size": n},
                )
            data = resp[1]  # (header, raw payload)
            if len(data) != n:
                raise KeyError(
                    f"short chunk at {off}: {len(data)} != {n}"
                )
            # No await between this check and the write: stop()/kill()
            # run on this same loop, so a raylet that began teardown (and
            # may have unmapped the store) can never interleave INSIDE
            # the write — writing after unmap is a segfault.
            if self._stopping:
                raise asyncio.CancelledError("raylet stopping")
            buf[off:off + n] = data
            received.add(off)
            if progress is not None:
                # Advance the contiguous prefix; wake chained servers.
                filled = progress["filled"]
                while filled < total and filled in received:
                    received.discard(filled)
                    filled = min(filled + chunk, total)
                progress["filled"] = filled
                progress["event"].set()
                progress["event"] = asyncio.Event()

        try:
            await asyncio.gather(*[fetch(off) for off in offsets])
        except BaseException:
            if progress is not None:
                progress["buf"] = None
            del buf
            if not self._stopping:  # teardown may have closed the store
                self.store.abort(oid)
            raise
        if self._stopping:
            del buf
            raise asyncio.CancelledError("raylet stopping")
        if progress is not None:
            progress["filled"] = total
            progress["buf"] = None
            progress["event"].set()
            progress["event"] = asyncio.Event()
        del buf
        self.store.seal(oid)
        self.store.release(oid)

    async def h_pull_object(self, d, conn):
        from ray_tpu_torch._private.ids import ObjectID

        oid = ObjectID(d["object_id"])
        view = self.store.get(oid)
        if view is not None:
            size = len(view)
            del view
            self.store.release(oid)
            return {"ok": True, "size": size}
        p = self._partial_pulls.get(d["object_id"])
        if p is not None and not p["failed"] and p["total"] is not None:
            return {"ok": True, "size": p["total"]}
        return {"ok": False, "error": "not found"}

    async def _read_chunk(self, oid_bytes: bytes, off: int, size: int) -> bytes:
        """One chunk from the sealed copy or an in-progress pull's filled
        prefix (chained replication), waiting briefly for the prefix to
        advance."""
        from ray_tpu_torch._private.ids import ObjectID

        oid = ObjectID(oid_bytes)
        deadline = time.monotonic() + get_config().chunk_serve_wait_s
        while True:
            view = self.store.get(oid)
            if view is not None:
                # Sealed copy: serve under the PushManager in-flight cap.
                try:
                    async with self._push_chunk_slots:
                        return bytes(view[off:off + size])
                finally:
                    del view
                    self.store.release(oid)
            p = self._partial_pulls.get(oid_bytes)
            if p is None or p["failed"]:
                raise KeyError("object evicted mid-transfer")
            if p["buf"] is not None and p["filled"] >= off + size:
                async with self._push_chunk_slots:
                    return bytes(p["buf"][off:off + size])
            if time.monotonic() > deadline:
                raise KeyError("upstream pull stalled")
            # Wait (OUTSIDE the chunk slots — a stalled upstream must not
            # starve other transfers) for the prefix to advance.
            ev = p["event"]
            try:
                await asyncio.wait_for(ev.wait(), timeout=1.0)
            except asyncio.TimeoutError:
                pass

    async def h_fetch_chunk(self, d, conn):
        return {"data": await self._read_chunk(
            d["object_id"], d["offset"], d["size"])}

    async def h_fetch_chunk_raw(self, d, conn):
        """Raw-payload variant: the chunk bytes follow the response frame
        without a msgpack pass (the raylet<->raylet bulk path)."""
        from ray_tpu_torch._private.protocol import BinResponse

        data = await self._read_chunk(d["object_id"], d["offset"], d["size"])
        return BinResponse({"n": len(data)}, data)

    # -- remote (rt://) clients -------------------------------------------
    # The reference's Ray Client (util/client/worker.py:81) proxies a
    # driver with no node-local runtime. Here a remote driver holds only
    # TCP connections: puts ship serialized bytes into this raylet's
    # store; gets read size here then stream chunks via fetch_chunk.

    async def h_worker_stacks(self, d, conn):
        """Collect live thread stacks from every registered worker on this
        node (the `rt stack` backend; reference: on-demand py-spy dumps
        via the dashboard reporter agent)."""
        from ray_tpu_torch._private.protocol import connect as _connect

        out = []
        for wid, w in list(self.workers.items()):
            if not w.port:
                continue
            try:
                wconn = await _connect("127.0.0.1", w.port, timeout=5)
                try:
                    dump = await asyncio.wait_for(
                        wconn.call("dump_stacks", {}), 10
                    )
                finally:
                    await wconn.close()
                out.append(dump)
            except Exception as e:  # noqa: BLE001 — dead/busy worker
                out.append({
                    "worker_id": wid, "error": f"{type(e).__name__}: {e}",
                })
        return {"node_id": self.node_id.binary(), "workers": out}

    async def h_client_put(self, d, conn):
        oid = ObjectID(d["object_id"])
        data = d["data"]
        if not self.store.contains_raw(d["object_id"]):
            buf = await self._create_with_spill(oid, len(data))
            if buf is not None:
                buf[:] = data
                self.store.seal(oid)
                self.store.release(oid)
            else:
                # Concurrent writer owns the buffer: wait until it seals so
                # the ok below really means "readable" (mirrors
                # h_restore_spilled's handling of the same race).
                if not await self._wait_sealed(d["object_id"]):
                    return {"ok": False, "error": "concurrent put never sealed"}
        r = await self.h_object_created(
            {"object_id": d["object_id"], "size": len(data)}, conn
        )
        return {"ok": bool(r.get("ok", True))}

    async def h_client_create(self, d, conn):
        """Begin a chunked remote put: allocate the buffer, hold it until
        client_seal (reaped if the client vanishes)."""
        oid = ObjectID(d["object_id"])
        if self.store.contains_raw(d["object_id"]):
            return {"ok": True, "exists": True}
        buf = await self._create_with_spill(oid, d["size"])
        if buf is None:
            if not await self._wait_sealed(d["object_id"]):
                return {"ok": False, "error": "concurrent put never sealed"}
            return {"ok": True, "exists": True}
        self._client_creates[d["object_id"]] = (
            buf, time.monotonic() + get_config().client_create_ttl_s
        )
        return {"ok": True, "exists": False}

    async def h_client_put_chunk(self, d, conn):
        entry = self._client_creates.get(d["object_id"])
        if entry is None:
            return {"ok": False, "error": "no open create for object"}
        buf, _ = entry
        off = d["offset"]
        buf[off:off + len(d["data"])] = d["data"]
        return {"ok": True}

    async def h_client_seal(self, d, conn):
        entry = self._client_creates.pop(d["object_id"], None)
        if entry is None:
            return {"ok": False, "error": "no open create for object"}
        oid = ObjectID(d["object_id"])
        self.store.seal(oid)
        self.store.release(oid)
        r = await self.h_object_created(
            {"object_id": d["object_id"], "size": d["size"]}, conn
        )
        return {"ok": bool(r.get("ok", True))}

    async def h_client_get_info(self, d, conn):
        """Ensure the object is local and return its size (the client then
        streams it out with fetch_chunk)."""
        oid = d["object_id"]
        await self._ensure_local(oid, timeout=d.get("timeout", 60.0))
        view = self.store.get(ObjectID(oid))
        if view is None:
            return {"ok": False, "error": "object not available"}
        try:
            size = len(view)
        finally:
            del view
            self.store.release(ObjectID(oid))
        return {"ok": True, "size": size}

    async def h_wait_object_local(self, d, conn):
        """Driver asks: make this object available in the local store."""
        from ray_tpu_torch._private import chaos

        delay = chaos.take_pull_delay()
        if delay is not None:  # chaos-only: modelled slow transfer
            await asyncio.sleep(delay)
        await self._ensure_local(d["object_id"], d.get("timeout", 60.0))
        return {"ok": True}

    # -- spilling (LocalObjectManager analog) ----------------------------
    def _get_storage(self):
        if self._storage is None:
            from ray_tpu_torch._private.external_storage import create_storage

            self._storage = create_storage(
                self.node_id.hex(), get_config().spill_dir or None
            )
        return self._storage

    def _pin_created(self, oid: bytes, size: int) -> bool:
        """Pin a freshly sealed primary copy so LRU eviction cannot drop
        the only copy."""
        if oid not in self._primary_pins:
            view = self.store.get(ObjectID(oid))
            if view is None:
                return False
            del view  # the store-side refcount holds the pin, not the view
            self._primary_pins[oid] = size
        self._spilled.pop(oid, None)
        return True

    async def h_object_created(self, d, conn):
        """A local client sealed a primary copy: pin + register location."""
        oid = d["object_id"]
        if not self._pin_created(oid, d.get("size", 0)):
            return {"ok": False, "error": "object not found at pin time"}
        await self.gcs.call(
            "object_location_add",
            {"object_id": oid, "node_id": self.node_id.binary(),
             "size": d.get("size", 0)},
        )
        return {"ok": True}

    async def h_objects_created(self, d, conn):
        """Batched seal notifications from one client flush: pin each and
        register every location with the GCS in a single frame."""
        registered = []
        for o in d["objects"]:
            if self._pin_created(o["object_id"], o.get("size", 0)):
                registered.append(
                    {"object_id": o["object_id"], "size": o.get("size", 0)}
                )
        if registered:
            await self.gcs.call(
                "object_locations_add",
                {"node_id": self.node_id.binary(), "objects": registered},
            )
        return {"ok": True}

    def _utilization(self) -> float:
        s = self.store.stats()
        return s["used_bytes"] / max(1, s["heap_size"])

    async def _create_with_spill(self, obj: ObjectID, size: int):
        """store.create with spill-and-retry under pressure. Returns the
        writable buffer, or None if the object already exists (concurrent
        writer). Raises ObjectStoreFullError when room cannot be made."""
        for attempt in range(6):
            try:
                return self.store.create(obj, size)
            except ObjectStoreFullError:
                n = await self._spill_until(
                    get_config().object_spilling_low_water, room_for=size
                )
                # A concurrent spill (shared _spill_lock) may have freed
                # room between our failed create and this pass — always
                # retry; back off only when nothing moved.
                if not n and attempt >= 2:
                    await asyncio.sleep(0.25)
            except ValueError:
                return None
        raise ObjectStoreFullError(f"no room for {size} bytes after spilling")

    async def _wait_sealed(self, oid: bytes, timeout: float = 30.0) -> bool:
        """Wait until a concurrently-written object is sealed (readable)."""
        deadline = time.monotonic() + timeout
        obj = ObjectID(oid)
        while time.monotonic() < deadline:
            view = self.store.get(obj)
            if view is not None:
                del view
                self.store.release(obj)
                return True
            if not self.store.contains_raw(oid):
                return False  # aborted/evicted mid-write
            await asyncio.sleep(0.02)
        return False

    async def _spill_until(self, target_utilization: float,
                           room_for: int = 0) -> int:
        """Spill pinned primaries (oldest first) until below the target
        and, for a put that found the store full, until `room_for` bytes
        are free: an object above 1 - target of the store never fits
        beside another one below the target."""
        async with self._spill_lock:
            spilled = 0
            storage = self._get_storage()
            loop = asyncio.get_event_loop()
            for oid in list(self._primary_pins):
                st = self.store.stats()
                if (st["used_bytes"] <= target_utilization * st["heap_size"]
                        and st["heap_size"] - st["used_bytes"] >= room_for):
                    break
                obj = ObjectID(oid)
                kept = self._spilled.get(oid)
                if kept is not None:
                    # A restored copy whose spill file is still there:
                    # drop it from memory without writing it again.
                    self.store.release(obj)
                    self._primary_pins.pop(oid, None)
                    if not self.store.delete(obj):
                        # A local client holds a live view: take the
                        # primary pin back, or the next pass releases
                        # the reader's reference and frees its block.
                        v = self.store.get(obj)
                        if v is not None:
                            del v
                            self._primary_pins[oid] = 0
                        continue
                    spilled += 1
                    await self.gcs.call(
                        "object_spilled",
                        {"object_id": oid, "node_id": self.node_id.binary(),
                         "uri": kept},
                    )
                    continue
                view = self.store.get(obj)
                if view is None:
                    self._primary_pins.pop(oid, None)
                    continue
                nbytes = memoryview(view).nbytes
                try:
                    uri = await loop.run_in_executor(
                        None, storage.spill, oid, view
                    )
                finally:
                    del view
                    self.store.release(obj)  # drop the read pin we just took
                self.store.release(obj)  # drop the primary pin
                self._primary_pins.pop(oid, None)
                if not self.store.delete(obj):
                    # A local client holds a live view: re-pin and keep it.
                    v = self.store.get(obj)
                    if v is not None:
                        del v
                        self._primary_pins[oid] = 0
                    storage.delete([uri])
                    continue
                self._spilled[oid] = uri
                self._metric_objects_spilled += 1
                self._metric_bytes_spilled += nbytes
                spilled += 1
                await self.gcs.call(
                    "object_spilled",
                    {"object_id": oid, "node_id": self.node_id.binary(),
                     "uri": uri},
                )
            return spilled

    async def h_spill_objects(self, d, conn):
        """A client's put hit ObjectStoreFull: make room."""
        cfg = get_config()
        n = await self._spill_until(cfg.object_spilling_low_water,
                                    room_for=d.get("size", 0))
        return {"ok": True, "spilled": n}

    async def h_restore_spilled(self, d, conn):
        """Restore a spilled object into the local store and re-register."""
        oid = d["object_id"]
        if self.store.contains_raw(oid):
            return {"ok": True}
        uri = self._spilled.get(oid)
        if uri is None:
            return {"ok": False, "error": "object was not spilled here"}
        storage = self._get_storage()
        data = await asyncio.get_event_loop().run_in_executor(
            None, storage.restore, uri
        )
        obj = ObjectID(oid)
        try:
            buf = await self._create_with_spill(obj, len(data))
        except ObjectStoreFullError:
            return {"ok": False,
                    "error": "store full; nothing left to spill"}
        if buf is None:
            # A concurrent restore is writing: only report ok once it has
            # sealed, or the requester may pull an unreadable object.
            ok = await self._wait_sealed(oid)
            return {"ok": ok} if ok else {
                "ok": False, "error": "concurrent restore did not complete"
            }
        buf[: len(data)] = data
        del buf
        self.store.seal(obj)
        # Keep the get-pin as the primary pin, and the spill file: the
        # next spill pass drops this copy without writing it again, and
        # the free deletes the file.
        self._primary_pins[oid] = len(data)
        await self.gcs.call(
            "object_location_add",
            {"object_id": oid, "node_id": self.node_id.binary(),
             "size": len(data), "restored": True},
        )
        return {"ok": True}

    async def _spill_loop(self):
        """Background pressure valve (SpillObjectsOfSize trigger)."""
        cfg = get_config()
        while True:
            await asyncio.sleep(0.25)
            try:
                if self._utilization() > cfg.object_spilling_threshold:
                    await self._spill_until(cfg.object_spilling_low_water)
            except Exception:
                if self._stopping:
                    return

    async def h_get_info(self, d, conn):
        return {
            "node_id": self.node_id.binary(),
            "store_name": self.store_name,
            "resources_total": self.resources_total,
            "resources_available": self.resources_available,
            "store_stats": self.store.stats(),
            "spilled": {"objects": self._metric_objects_spilled,
                        "bytes": self._metric_bytes_spilled},
            "workers": [
                {
                    "worker_id": w.worker_id,
                    "pid": w.proc.pid if w.proc is not None else None,
                    "idle": w.idle,
                    "actor_id": w.actor_id,
                    "current_task": w.current_task,
                    "cpu_percent": w.cpu_percent,
                    "rss_bytes": w.rss_bytes,
                }
                for w in self.workers.values()
            ],
        }

    # -- sync ------------------------------------------------------------
    def _runtime_metric_deltas(self):
        """Per-component runtime metrics (stats/metric_defs.h:46-61 analog:
        task/worker/store counters), reported as deltas so the GCS
        aggregate matches its Counter semantics."""
        stats = self.store.stats()
        node = self.node_id.hex()[:12]
        counters = {
            "rt_raylet_tasks_dispatched_total": self._metric_tasks_dispatched,
            "rt_raylet_tasks_failed_total": self._metric_tasks_failed,
            "rt_raylet_objects_spilled_total": self._metric_objects_spilled,
            "rt_raylet_bytes_spilled_total": self._metric_bytes_spilled,
            "rt_raylet_dispatch_passes_total": self._metric_dispatch_passes,
            "rt_raylet_dispatch_scans_total": self._metric_dispatch_scans,
            "rt_raylet_lease_grants_total": self._metric_lease_grants,
        }
        records = []
        commits = {}
        for name, value in counters.items():
            prev = self._metric_reported.get(name, 0)
            if value != prev:
                records.append(
                    {"name": name, "type": "counter",
                     "description": "raylet runtime counter",
                     "data": [[[["node", node]], value - prev]]}
                )
                commits[name] = value
        for name, value in (
            ("rt_raylet_store_used_bytes", stats.get("used_bytes", 0)),
            ("rt_raylet_store_objects", stats.get("num_objects", 0)),
            ("rt_raylet_workers", len(self.workers)),
            ("rt_raylet_tasks_queued", len(self._queued_specs)),
            ("rt_raylet_dispatch_batch_last", self._last_dispatch_batch),
            ("rt_raylet_dispatch_scan_last", self._last_dispatch_scan),
        ):
            records.append(
                {"name": name, "type": "gauge",
                 "description": "raylet runtime gauge",
                 "data": [[[["node", node]], value]]}
            )
        return records, commits

    async def _sync_resources(self, demand):
        """Versioned delta sync of this node's resource view
        (ray_syncer analog: common/ray_syncer/ray_syncer.h delta-syncs
        per-node views instead of broadcasting full state).

        Only resource entries that changed since the last acknowledged
        sync ride the wire, under a monotonically increasing version; the
        GCS detects gaps (its restart, a missed ack) and replies
        need_full, which resets the baseline so the next beat carries the
        whole view. Demand bundles ship only when they changed.
        """
        self._sync_version += 1
        payload = {
            "node_id": self.node_id.binary(),
            "version": self._sync_version,
            "proc_stats": {
                "workers": sum(
                    1 for w in self.workers.values() if w.conn is not None
                ),
                "rss_bytes": sum(w.rss_bytes for w in self.workers.values()),
                "cpu_percent": round(
                    sum(w.cpu_percent for w in self.workers.values()), 1
                ),
            },
        }
        avail = dict(self.resources_available)
        if self._synced_resources is None:
            payload["available"] = avail
        else:
            delta = {
                k: v for k, v in avail.items()
                if self._synced_resources.get(k) != v
            }
            removed = [k for k in self._synced_resources if k not in avail]
            if delta:
                payload["delta"] = delta
            if removed:
                payload["removed"] = removed
        demand_sig = hash(
            tuple(tuple(sorted(b.items())) for b in demand)
        )
        if demand_sig != self._synced_demand_sig:
            payload["demand_bundles"] = demand
        r = await self.gcs.call("resource_update", payload)
        if r.get("need_full"):
            # Gap on the GCS side (restart / lost state): resend the full
            # view on the next heartbeat.
            self._synced_resources = None
            self._synced_demand_sig = None
        else:
            self._synced_resources = avail
            self._synced_demand_sig = demand_sig
        # Graceful drain (cordon): once the GCS flags this node draining,
        # the hybrid policy stops keeping new work local (see h_submit's
        # draining check) and placement everywhere else skips us.
        was_draining = self._draining
        self._draining = bool(r.get("draining"))
        if self._draining and not was_draining:
            self._revoke_direct_leases()

    async def _heartbeat_loop(self):
        cfg = get_config()
        while True:
            await asyncio.sleep(cfg.health_check_period_s / 2)
            try:
                try:
                    self._sample_proc_stats()
                except Exception:  # noqa: BLE001 — stats are best-effort
                    pass
                try:
                    records, commits = self._runtime_metric_deltas()
                    self._metrics_seq += 1
                    await self.gcs.call(
                        "metrics_report",
                        {"records": records,
                         "reporter": self.node_id.binary(),
                         "seq": self._metrics_seq},
                    )
                    # Commit counter baselines only after a successful
                    # send; the (reporter, seq) pair makes a retried
                    # report idempotent if only the reply was lost.
                    self._metric_reported.update(commits)
                except Exception:  # noqa: BLE001 — observability is best-effort
                    pass
                # Demand bundles of queued-but-undispatched tasks feed the
                # autoscaler's binpacking (LoadMetrics / resource_demand_
                # scheduler in the reference). _queued_specs is stable
                # across a dispatch pass (unlike task_queue, whose items
                # sit in a pass-local requeue list during awaits).
                demand = list(self._queued_specs.values())[:64]
                await self._sync_resources(demand)
                if self._task_events:
                    events, self._task_events = self._task_events, []
                    try:
                        await self.gcs.call("add_task_events", {"events": events})
                    except Exception:
                        # Transient GCS hiccup: keep the batch for retry so
                        # tasks don't stick in stale states in the state API.
                        self._task_events = events + self._task_events
                        raise
            except Exception:
                if self._stopping:
                    return
                if self.gcs is not None and self.gcs._closed:
                    await self._reconnect_gcs()


def main():  # pragma: no cover - run as subprocess
    import argparse
    import signal

    p = argparse.ArgumentParser()
    p.add_argument("--gcs-host", default="127.0.0.1")
    p.add_argument("--gcs-port", type=int, required=True)
    p.add_argument("--num-cpus", type=float, default=None)
    p.add_argument("--num-gpus", type=float, default=None)
    p.add_argument("--resources", default="{}")
    p.add_argument("--object-store-memory", type=int, default=None)
    p.add_argument("--head", action="store_true")
    p.add_argument("--labels", default="{}")
    args = p.parse_args()

    import json

    from ray_tpu_torch._private.node import resolve_resources

    # Cards are detected as init() detects them (accelerators/gpu.py,
    # never torch.cuda: the zygote this raylet starts forks every worker).
    resources = json.loads(args.resources)
    resources = resolve_resources(
        args.num_cpus if args.num_cpus is not None else resources.get("CPU"),
        args.num_gpus, resources)

    async def run():
        raylet = Raylet(
            args.gcs_host,
            args.gcs_port,
            resources,
            object_store_memory=args.object_store_memory,
            is_head=args.head,
            labels=json.loads(args.labels),
        )
        port = await raylet.start()
        print(f"RAYLET_PORT={port}", flush=True)
        print(f"RAYLET_NODE_ID={raylet.node_id.hex()}", flush=True)
        print(f"RAYLET_STORE={raylet.store_name}", flush=True)
        # `rt stop` sends SIGTERM: stop the workers (each forked into a
        # session of its own, so no process-group signal reaches them)
        # and the store, then leave; the zygote stops at interpreter exit.
        stop = asyncio.Event()
        asyncio.get_running_loop().add_signal_handler(signal.SIGTERM,
                                                      stop.set)
        await stop.wait()
        await raylet.stop()

    asyncio.run(run())


if __name__ == "__main__":
    main()
