"""Runtime configuration flags.

Analog of the reference's RayConfig
(src/ray/common/ray_config.h:60; entries defined in
src/ray/common/ray_config_def.h — 220 RAY_CONFIG(type, name, default)
entries, each overridable via a `RAY_<name>` env var). We keep the same
pattern — a flat typed registry, env-overridable with an `RT_` prefix —
but only carry the entries this runtime actually consumes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields
from typing import Any


def _env(name: str, default: Any, typ: type) -> Any:
    # Documented form is upper-case (RT_GCS_WAL_FSYNC, matching the
    # reference's RAY_<NAME> convention); the verbatim field-name form is
    # accepted too so nothing silently ignores an operator's setting.
    raw = os.environ.get(f"RT_{name.upper()}")
    if raw is None:
        raw = os.environ.get(f"RT_{name}")
    if raw is None:
        return default
    if typ is bool:
        return raw.lower() in ("1", "true", "yes")
    return typ(raw)


@dataclass
class Config:
    # -- object store ---------------------------------------------------
    # Default shared-memory store size; reference sizes plasma from system
    # memory in _private/services.py (object_store_memory).
    object_store_memory: int = 256 * 1024 * 1024
    # Objects at or below this size are passed inline in RPC replies instead
    # of the shared-memory store (reference: max_direct_call_object_size,
    # ray_config_def.h — 100KB).
    max_inline_object_size: int = 100 * 1024
    # Chunk size for node-to-node object transfer (reference:
    # object_manager_default_chunk_size, ray_config_def.h:362 — 5 MiB).
    object_transfer_chunk_size: int = 5 * 1024 * 1024
    # Store utilization that triggers spilling of pinned primary copies
    # (reference: object_spilling_threshold, ray_config_def.h).
    object_spilling_threshold: float = 0.8
    # Spill down to this utilization once triggered.
    object_spilling_low_water: float = 0.6
    # Directory for spilled objects (RT_SPILL_DIR env; reference:
    # object_spilling_config).
    spill_dir: str = ""

    # -- scheduling -----------------------------------------------------
    # Prefer the local node until its critical resource utilization crosses
    # this threshold (reference: scheduler_spread_threshold,
    # ray_config_def.h:196).
    scheduler_spread_threshold: float = 0.5
    # Max worker processes per node per job (reference sizes the pool from
    # num_cpus; we keep an explicit cap for tests).
    max_workers_per_node: int = 16
    # Seconds an idle worker lives before the pool reaps it (reference:
    # idle_worker_killing_time_threshold_ms).
    idle_worker_timeout_s: float = 300.0
    # How long a spawned worker may take to register (runtime-env download
    # and extraction happen before registration; reference:
    # worker_register_timeout_seconds).
    worker_register_timeout_s: float = 120.0

    # -- memory monitor / OOM policy -------------------------------------
    # Node memory fraction above which the raylet kills the newest
    # retriable task's worker instead of letting the OS OOM-kill the node
    # (reference: memory_usage_threshold, ray_config_def.h:77 — 0.95).
    memory_usage_threshold: float = 0.95
    # Monitor poll period (reference: memory_monitor_refresh_ms — 250ms).
    memory_monitor_interval_s: float = 0.25
    # 0 disables the monitor (reference disables via refresh_ms=0).
    memory_monitor_enabled: bool = True

    # -- fault tolerance ------------------------------------------------
    # Default task retries (reference: max_retries default 3,
    # python/ray/remote_function.py).
    task_max_retries: int = 3
    # GCS → raylet health check period/timeout (reference:
    # GcsHealthCheckManager, gcs_health_check_manager.h:39).
    health_check_period_s: float = 1.0
    health_check_failure_threshold: int = 5

    # -- rpc ------------------------------------------------------------
    rpc_connect_timeout_s: float = 10.0
    rpc_max_message_size: int = 512 * 1024 * 1024
    # Dial timeout for raylet->raylet peer connections (short: waiters
    # queue behind the per-peer lock, so a blackholed peer must fail fast).
    peer_dial_timeout_s: float = 2.0
    # Dial timeout when reconnecting to a (possibly restarting) GCS.
    gcs_reconnect_dial_timeout_s: float = 2.0
    # Backoff between GCS redial attempts.
    gcs_reconnect_backoff_s: float = 0.5
    # Default timeout for ordinary GCS table/KV operations.
    gcs_op_timeout_s: float = 120.0
    # Dial timeout for raylet->local-worker control connections.
    worker_dial_timeout_s: float = 2.0

    # -- client ----------------------------------------------------------
    # Probe period for blocking gets on remote objects (reference:
    # fetch_warn_timeout_milliseconds family).
    get_probe_interval_s: float = 5.0
    # Cap on one background prefetch() pull: an advisory pull for a
    # never-produced object must not park a loop task forever (blocking
    # semantics belong to get(), which re-issues its own pull).
    prefetch_pull_timeout_s: float = 120.0
    # Timeout resolving a store-argument dependency inside a worker.
    arg_fetch_timeout_s: float = 60.0
    # Timeout for the owner's batched free_objects RPC.
    free_objects_timeout_s: float = 30.0
    # Timeout for spill_objects round trips under store pressure, and the
    # backoff when nothing was spillable.
    spill_rpc_timeout_s: float = 120.0
    spill_retry_backoff_s: float = 0.25
    # Worker-lease RPCs (grant/release; reference lease RPC deadline).
    lease_rpc_timeout_s: float = 10.0
    # Idle-lease reaper tick.
    lease_reap_interval_s: float = 0.5
    # Actor-call retry backoff (per attempt, capped).
    actor_retry_backoff_s: float = 0.2
    actor_retry_backoff_max_s: float = 2.0
    # How long the first call waits for a pipelined (unnamed-actor)
    # registration still in flight before declaring the actor unknown.
    actor_register_wait_s: float = 5.0
    # In-process memory store bound (memory_store.h analog).
    memory_store_max_entries: int = 8192
    # Owner-side lineage table bound (lineage eviction).
    lineage_max_entries: int = 10_000
    # Debounce for batching dropped-ref free RPCs.
    free_flush_debounce_s: float = 0.05

    # -- raylet loops -----------------------------------------------------
    # Dead-worker reap / stale-client-create sweep period.
    reap_interval_s: float = 0.2
    # Workers whose /proc stats are read per heartbeat tick (round-robin
    # window: observability stays O(1)/tick on many-worker nodes).
    proc_stats_sample_max: int = 64
    # Concurrent worker interpreter boots per node (actor-creation burst
    # throttle; an unbounded fork storm starves heartbeats).
    worker_boot_concurrency: int = 16
    # Forced dispatch rescan period while tasks wait on resources.
    dispatch_rescan_interval_s: float = 0.1
    # How long a failed runtime env is remembered before retrying builds.
    bad_runtime_env_ttl_s: float = 60.0
    # Warn when a task has been infeasible this long.
    infeasible_warn_s: float = 30.0
    # Abort an open chunked remote-client put after this long.
    client_create_ttl_s: float = 600.0
    # Per-RPC timeout for remote (rt://) client store operations.
    remote_client_op_timeout_s: float = 120.0

    # -- gcs --------------------------------------------------------------
    # Snapshot debounce for GCS persistence (RT_GCS_PERSIST_PATH).
    gcs_persist_debounce_s: float = 0.05
    # WAL compaction threshold: a snapshot rewrite is scheduled once the
    # write-ahead log passes this size (gcs_table_storage compaction role).
    gcs_wal_compact_bytes: int = 4 * 1024 * 1024
    # fsync each WAL record (strict durability; default flushes only).
    gcs_wal_fsync: bool = False

    # -- direct task transport (worker leases) ---------------------------
    # Max leased workers per scheduling class per owner (the reference
    # bounds leases by cluster capacity; direct_task_transport.cc).
    direct_lease_max_workers: int = 16
    # Outstanding direct tasks on the least-loaded lease that trigger
    # acquiring another worker.
    direct_lease_grow_outstanding: int = 2
    # Idle seconds before an owner returns a leased worker.
    direct_lease_idle_release_s: float = 1.0
    # Max task specs coalesced into one direct-transport batch frame.
    direct_submit_batch_max: int = 32
    # Max pipelined calls to one actor coalesced into one batch frame
    # (also bounds the receiver's per-executor-hop ordered run).
    actor_call_batch_max: int = 64
    # Worker fork server (zygote.py). Off -> every spawn is a fresh
    # interpreter (RT_DISABLE_ZYGOTE also works per-spawn).
    zygote_enabled: bool = True
    # Re-exec the zygote after this many forks. Linux rmap (anon_vma)
    # chains grow with the number of COW-faulted siblings forked from
    # one parent, making every later child's page faults tens of ms
    # slower (measured: ~5ms -> ~27ms sys/boot by ~900 live workers).
    # A fresh zygote resets the chains; the next generation pre-warms in
    # the background so rotation never stalls a spawn.
    zygote_respawn_after: int = 150
    # Registered default-env workers kept warm once the node has seen
    # demand; actor creations and leases adopt them instead of forking
    # on the critical path (worker_pool.h:347 prestart role).
    worker_pool_min_idle: int = 4
    # Recycle a cleanly-killed idle actor's worker back into the pool
    # (workers with running calls still die with the actor).
    actor_worker_recycle: bool = True
    # Delay before the pool replenisher forks, letting recycled workers
    # return first (and keeping forks off creation critical paths).
    worker_pool_replenish_debounce_s: float = 0.25

    # -- object-manager flow control -------------------------------------
    # Concurrent pull transfers per node (PullManager admission).
    pull_max_concurrent: int = 8
    # Fraction of the object store reservable by in-flight pulls.
    pull_budget_fraction: float = 0.25
    # Concurrent outbound chunk reads served (PushManager throttling).
    push_chunk_slots: int = 16
    # Chunk fetches in flight per pull (round trips hide behind each
    # other; reference keeps a per-object chunk pipeline the same way).
    pull_chunk_window: int = 4
    # Same-machine peers move objects by direct store-to-store memcpy
    # through /dev/shm instead of TCP chunks.
    same_host_shm_transfer: bool = True
    # How long a chunk server waits for an in-progress (partial) pull's
    # prefix to advance before failing the chained consumer over to
    # another holder.
    chunk_serve_wait_s: float = 30.0
    # Timeout for the recycle handshake with a killed actor's worker.
    release_actor_timeout_s: float = 2.0
    # Worker-side task-event flush period (batched to the GCS).
    task_event_flush_interval_s: float = 1.0
    # Control-plane profiler head-sampling rate (0 disables, 1 traces
    # every task). Also flippable cluster-wide at runtime via
    # `rt profile --on` (GCS profile_config broadcast).
    task_trace_sample: float = 0.0
    # Bounded delay before buffered trace/profiling spans flush to the
    # GCS (replaces the old one-RPC-per-span eager flush).
    trace_flush_delay_s: float = 0.25

    # -- event journal (cluster black box, util/journal.py) --------------
    # Always-on per-process event journal with HLC stamps. Disabling also
    # drops the HLC field from RPC frames.
    journal_enabled: bool = True
    # Per-process ring capacity (events); oldest overwritten first.
    journal_ring: int = 4096
    # Seconds of ring history a postmortem dump freezes per process.
    journal_window_s: float = 30.0
    # Postmortem bundle root ($TMPDIR/ray_tpu_torch/postmortem when empty).
    journal_dir: str = ""
    # Typed failure observers may publish cluster-wide dump triggers.
    journal_autodump: bool = True
    # Minimum spacing between dump triggers (per process AND GCS-wide):
    # a failure storm becomes one bundle, not a dump storm.
    journal_cooldown_s: float = 30.0

    # -- wire protocol ---------------------------------------------------
    # Frames at/above this size bypass coalescing and await drain.
    rpc_direct_write_threshold: int = 64 * 1024
    # Transport backlog that parks senders in drain() (backpressure).
    rpc_write_buffer_drain: int = 256 * 1024
    # StreamReader buffer limit: must comfortably exceed the transfer
    # chunk size or readexactly() of a bulk chunk thrashes the
    # transport's pause/resume flow control (asyncio default is 64KiB).
    rpc_stream_buffer_limit: int = 32 * 1024 * 1024

    # -- serve ------------------------------------------------------------
    # Controller reconcile tick (replica health, autoscaling, proxies).
    serve_reconcile_interval_s: float = 0.5
    # Consecutive failed health probes before a replica is replaced.
    serve_health_fail_threshold: int = 3
    # Data-plane replica call timeout (handle dispatch, streaming chunk
    # pulls, proxy-side gets).
    serve_rpc_timeout_s: float = 60.0
    # Replica/proxy readiness probes during deploys and reconciles.
    serve_ready_timeout_s: float = 30.0
    # serve.run() end-to-end deploy timeout (controller reports ready).
    serve_deploy_timeout_s: float = 300.0
    # serve.call()/.result() default completion timeout.
    serve_result_timeout_s: float = 120.0
    # Control-plane admin calls (status/delete/shutdown/proxy listing).
    serve_admin_timeout_s: float = 60.0
    # Short liveness/queue-length probes in the reconcile + autoscale loop.
    serve_probe_timeout_s: float = 5.0
    # Upper bound on each app's collective replica health-check wait per
    # reconcile pass (one rt.wait over all replicas' health probes).
    serve_health_wait_s: float = 10.0
    # Base/cap for the jittered backoff between replica re-dispatches on
    # ActorError (a flapping replica must not be hammered in a tight loop).
    serve_redispatch_backoff_s: float = 0.05
    serve_redispatch_backoff_max_s: float = 2.0
    # Request observatory: always-on per-request phase attribution,
    # per-tenant SLO accounting, and the ServeSignals autoscaling plane.
    serve_observatory: bool = True
    # Finished-request phase records retained per replica (ring buffer).
    serve_obs_ring: int = 256
    # Controller cadence for publishing the ServeSignals snapshot to the
    # GCS KV (rt serve / autoscalers read it).
    serve_signals_interval_s: float = 2.0
    # A prefill pass blocking active decode slots longer than this is
    # recorded as a head-of-line event (serve_hol_blocked_seconds_total).
    serve_hol_threshold_s: float = 0.05
    # Fast/slow sliding windows for per-tenant SLO burn-rate accounting
    # (multi-window burn alerting a la SRE workbook).
    serve_slo_fast_window_s: float = 60.0
    serve_slo_slow_window_s: float = 600.0
    # -- serve survival plane (overload/deadline/drain/failover) ----------
    # Bound on requests queued (admitted but unexecuted) per replica, on
    # top of the max_ongoing_requests executing; past it the replica
    # sheds with ServeOverloadedError instead of growing the queue.
    serve_max_queued_per_replica: int = 32
    # Bound on the engine admission queue (waiting for a decode slot);
    # past it submit() sheds instead of queueing unbounded.
    serve_max_queued_per_engine: int = 64
    # Handle-side per-replica circuit breaker: consecutive dispatch
    # failures that open the circuit, and how long it stays open before
    # a half-open trial request is allowed through.
    serve_cb_failure_threshold: int = 3
    serve_cb_reset_s: float = 5.0
    # Graceful drain: how long a drained replica may spend finishing its
    # in-flight requests before the controller hard-kills it.
    serve_drain_timeout_s: float = 10.0
    # Default request deadline when none is set on the handle/header.
    # 0 disables (requests then run under serve_result_timeout_s only).
    serve_default_deadline_s: float = 0.0
    # How many times the streaming generator resumes on a new replica
    # after replica death before giving up (resume-or-restart contract).
    serve_stream_resume_attempts: int = 2
    # Completed-request idempotency cache entries kept per replica (keyed
    # on the handle's idempotency key; redispatch/retry joins or reuses
    # the original execution instead of running it twice).
    serve_idem_cache_size: int = 1024
    # -- serve paged KV (engine memory plane, ray_tpu_torch/serve/paged_kv) -----
    # KV layout: "paged" (page pool + block tables + prefix cache, the
    # default) or "slotted" (the original one-row-per-request cache,
    # kept for bit-exactness baselines). RT_SERVE_KV=slotted flips it.
    serve_kv: str = "paged"
    # Tokens per KV page (clamped to max_len; bit-exactness with the
    # slotted path needs max_len % page_size == 0).
    serve_kv_page_size: int = 16
    # Total pages in the pool, INCLUDING the reserved NULL page. 0 =
    # auto: num_slots * ceil(max_len / page_size) + 1, i.e. the same
    # HBM as the slotted cache it replaces.
    serve_kv_pages: int = 0
    # Prefix cache over full prompt pages (shared prefixes skip their
    # prefill and share pages copy-on-write). Disable to force every
    # request cold.
    serve_prefix_cache: bool = True

    # -- data -------------------------------------------------------------
    # Undelivered blocks buffered per streaming_split consumer before the
    # producer stalls (per-split backpressure).
    data_split_queue_depth: int = 4
    # Streaming-executor concurrency budget = cluster CPUs x this factor.
    data_cpu_budget_factor: float = 2.0
    # Blocks a DataIterator asks its _SplitCoordinator for per round trip
    # (and prefetches ahead of consumption). Override per-trainer through
    # train.DataConfig(prefetch_blocks=...).
    data_iterator_prefetch_blocks: int = 2
    # Default depth of the background device-feed pipeline (batches
    # staged ahead of the step loop).
    data_feed_prefetch_batches: int = 2

    # -- collective -----------------------------------------------------
    collective_rendezvous_timeout_s: float = 60.0
    # Deadline on each blocking send/recv inside an eager DCN collective:
    # a dead peer raises CollectiveTimeoutError instead of wedging the
    # surviving ranks (The Big Send-off failure-path-first principle).
    collective_op_timeout_s: float = 60.0

    # -- train fault tolerance -------------------------------------------
    # Bound on one poll() round trip to a training worker (detection
    # latency for a hung rank; replaces the old blanket 600 s get).
    train_poll_timeout_s: float = 60.0
    # Bound on launching the training loop on the gang.
    train_start_timeout_s: float = 600.0
    # Low-cost liveness probe (ping) timeout per worker.
    train_probe_timeout_s: float = 10.0
    # How often the trainer's result loop checks for draining nodes.
    train_drain_poll_interval_s: float = 0.5
    # How long a drain-requested gang gets to checkpoint and exit before
    # the restart proceeds with whatever checkpoint is registered.
    train_drain_grace_s: float = 30.0
    # Bound on one elastic resize: every rank must reach the
    # sync_resize barrier, hand off shards, and apply the new world
    # size within this window or the resize aborts (gang unchanged,
    # caller falls back to checkpoint-and-restart).
    train_resize_timeout_s: float = 60.0
    # Partial reclamation: a claimant needing fewer chips than a whole
    # victim gang drains only the bundles it needs (the victim resizes
    # instead of dying). Off → whole-gang eviction always.
    preempt_partial_enabled: bool = True

    # -- preemption ------------------------------------------------------
    # Master switch for the GCS reclamation pass: infeasible higher-priority
    # demand may evict lower-priority placement groups (RT_PREEMPTION_ENABLED).
    preemption_enabled: bool = True
    # Per-victim graceful-eviction deadline: a preempted gang gets this long
    # to checkpoint/drain and release its placement group before the GCS
    # hard-kills its actors and force-removes the group (RT_PREEMPT_GRACE_S).
    preempt_grace_s: float = 30.0
    # How many completed preemption records the GCS keeps for `rt top` /
    # `get_preemptions` before pruning the oldest.
    preempt_history_limit: int = 256

    # -- core worker ------------------------------------------------------
    # Owner-side object-directory lookups (location gets during restart
    # waits and lineage probes).
    object_directory_rpc_timeout_s: float = 30.0

    def __post_init__(self):
        for f in fields(self):
            cur = getattr(self, f.name)
            setattr(self, f.name, _env(f.name, cur, type(cur)))


def session_log_dir() -> str:
    """The session's per-process log directory — single definition shared
    by `rt start` (writer) and the raylet's log-serving RPCs (reader)."""
    return os.path.join(
        os.environ.get("TMPDIR", "/tmp"), "ray_tpu_torch", "logs"
    )


_config: Config | None = None


def get_config() -> Config:
    global _config
    if _config is None:
        _config = Config()
    return _config
