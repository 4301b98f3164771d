"""Global Control Service: the cluster metadata authority.

Analog of the reference GCS server
(src/ray/gcs/gcs_server/gcs_server.h:78, entry gcs_server_main.cc:40) with
its managers collapsed into one asyncio process:

  * node table + health checks   (GcsNodeManager, GcsHealthCheckManager,
                                  gcs_health_check_manager.h:39)
  * resource views               (GcsResourceManager + ray_syncer — here the
                                  raylets push deltas over their persistent
                                  RPC connection instead of a separate
                                  bidi-stream service, ray_syncer.h:88)
  * actor table + scheduling     (GcsActorManager, gcs_actor_manager.cc:255,
                                  GcsActorScheduler::ScheduleByGcs,
                                  gcs_actor_scheduler.cc:60)
  * placement groups             (GcsPlacementGroupManager two-phase
                                  prepare/commit, gcs_placement_group_scheduler.h)
  * KV store                     (GcsKvManager / StoreClientInternalKV,
                                  store_client_kv.h; in-memory store client,
                                  in_memory_store_client.h:31)
  * object directory             (ownership_based_object_directory.h — here a
                                  GCS table since owners and the directory
                                  share a process boundary anyway on one host)
  * pubsub                       (src/ray/pubsub/publisher.h:307 — long-poll
                                  replaced by server-push frames)
  * job table + function exports (GcsJobManager, GcsFunctionManager)
  * task events                  (GcsTaskManager task-event sink, powers the
                                  state API)
"""

from __future__ import annotations

import asyncio
import os
import struct
import time
from bisect import bisect_left
from collections import defaultdict
from typing import Any, Dict, List, Optional, Set

from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.protocol import RpcServer, ServerConnection
from ray_tpu_torch.util import journal

#: Bucket boundaries (seconds) for the per-method server-side RPC latency
#: histograms — matches util.metrics.LATENCY_BOUNDARIES so gcs_rpc_*
#: series quantile the same way client-side metrics do. Kept as a local
#: copy: the GCS process must not import the client metrics registry.
_RPC_LATENCY_BOUNDS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

#: Bucket boundaries (seconds) for preempt_grace_seconds: how long a victim
#: gang actually took from eviction notice to releasing its bundles. Spans
#: sub-second cooperative drains up to multi-minute stragglers that hit the
#: hard-kill deadline.
_PREEMPT_GRACE_BOUNDS = (
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)

#: Task-event ring capacity (GcsTaskManager's task_events_max_num_task_
#: in_gcs analog). Evictions are counted so consumers can detect
#: truncation instead of silently missing history.
_TASK_EVENTS_CAP = 100_000


#: Handlers that mutate durable tables; each marks the snapshot dirty.
_WRITE_METHODS = {
    "kv_put", "kv_del",
    "register_actor", "actor_ready", "kill_actor", "worker_dead",
    "register_job", "submit_job", "job_update", "job_log_append", "stop_job",
    "create_placement_group", "remove_placement_group",
    "release_pg_bundles", "reserve_pg_bundles",
    "object_location_add", "object_location_remove", "object_spilled",
    "objects_freed",
}


class GcsServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 persist_path: Optional[str] = None):
        self.rpc = RpcServer(host, port)
        self.host = host
        # Fault tolerance: durable tables snapshot to persist_path (debounced
        # + atomic rename) and restore on restart; live state (nodes,
        # connections, waiters) is rebuilt as raylets reconnect within a
        # heartbeat. The role of the reference's Redis store client
        # (gcs/store_client/redis_store_client.h:33), file-backed.
        self.persist_path = persist_path
        self._persist_dirty = False
        self._persist_task: Optional[asyncio.Task] = None
        # Write-ahead log (gcs_table_storage.h / redis_store_client.h:33
        # role): every durable mutation appends a seq-numbered record
        # BEFORE its reply, so an abrupt GCS kill loses nothing that was
        # acknowledged — the debounced snapshot is only WAL compaction.
        self._wal_path = persist_path + ".wal" if persist_path else None
        self._wal_old_path = persist_path + ".wal.old" if persist_path else None
        self._wal_fh = None
        self._wal_seq = 0
        self._wal_bytes = 0
        self._wal_compact_bytes = get_config().gcs_wal_compact_bytes
        self._wal_fsync = get_config().gcs_wal_fsync
        self._base_handlers: Dict[str, Any] = {}
        # tables
        self.kv: Dict[str, Dict[bytes, bytes]] = defaultdict(dict)  # namespace -> k -> v
        self.nodes: Dict[bytes, dict] = {}  # node_id -> info
        self.node_conns: Dict[bytes, ServerConnection] = {}
        self.actors: Dict[bytes, dict] = {}  # actor_id -> info
        self.named_actors: Dict[tuple, bytes] = {}  # (namespace, name) -> actor_id
        self.jobs: Dict[bytes, dict] = {}
        self.placement_groups: Dict[bytes, dict] = {}
        self.object_dir: Dict[bytes, dict] = {}  # object_id -> {nodes: set, size}
        self._partial_seq = 0  # chain-seniority counter for partial pulls
        self.object_waiters: Dict[bytes, List[asyncio.Event]] = defaultdict(list)
        self.task_events: List[dict] = []  # ring buffer of task state events
        # Aggregated user metrics: name -> {type, description, boundaries?,
        #   series: {tags_tuple -> value | histogram-state}}
        self.metrics: Dict[str, dict] = {}
        self._metrics_seq: Dict[bytes, int] = {}  # reporter -> last seq
        self.subscribers: Dict[str, Set[ServerConnection]] = defaultdict(set)
        self.pending_actors: Set[bytes] = set()
        self.pending_pgs: Set[bytes] = set()
        self.pg_counter = 0
        # -- preemption (priority chip reclamation) ----------------------
        # victim_pg_id -> record. A record is born "draining" when the
        # reclamation pass marks the victim's nodes, flips to "released"
        # when the victim gives its placement group back (cooperatively or
        # via the hard-kill deadline), and is pruned from the tail of the
        # history once preempt_history_limit is exceeded. Live-only state:
        # fences and drains are re-derived after a GCS restart by the next
        # reclamation pass.
        self.preemptions: Dict[bytes, dict] = {}
        # Resize obligations: victim_pg_id -> record. Born "armed" when a
        # partially-reclaimed gang releases exactly the claimed bundles
        # (elastic shrink instead of eviction); flips to "lifted" when the
        # claimant releases — the fence-lift signal the trainer's
        # grow-back path polls via get_resize_state. Dropped once the
        # victim re-reserves the bundles (or is itself removed).
        self.resize_obligations: Dict[bytes, dict] = {}
        # Sentinel claimant ids minted by chaos.reclaim_chips: they hold
        # their reclamation fences (the fence sweep treats them as
        # forever-waiting) until chaos.lift_fence clears them.
        self.chaos_claims: Set[bytes] = set()
        # preempt_total{tenant,reason} counter state, exported as a
        # synthetic series from h_metrics_snapshot like gcs_rpc_*.
        self.preempt_counts: Dict[tuple, float] = {}
        # preempt_grace_seconds histogram state (notice -> release).
        self.preempt_grace = {
            "buckets": [0] * (len(_PREEMPT_GRACE_BOUNDS) + 1),
            "sum": 0.0, "count": 0,
        }
        self._started = asyncio.Event()
        self._stopping = False
        self._health_task: Optional[asyncio.Task] = None
        # Per-component runtime metrics (stats/metric_defs.h role): RPC
        # volume by method, exported through gcs_stats -> /metrics.
        self.rpc_counts: Dict[str, int] = defaultdict(int)
        self.rpc.on_request = (
            lambda method: self.rpc_counts.__setitem__(
                method, self.rpc_counts[method] + 1
            )
        )
        # Per-method handler-latency accounting (count/sum/max + fixed
        # buckets), feeding `rt rpc` and the gcs_rpc_server_seconds
        # series in metrics_snapshot. Makes "N GCS round-trips per actor
        # birth, at M µs each" a reported number.
        self.rpc_latency: Dict[str, dict] = {}
        self.rpc.on_complete = self._rpc_complete
        # Evicted-task-event count: lets list_task_events consumers warn
        # on truncated history instead of silently under-reporting.
        self._task_events_dropped = 0
        # Cluster-wide runtime profiling config (`rt profile --on`):
        # stored here, broadcast to every connected client over the
        # profile_config pubsub channel (server-originated; clients may
        # not publish to it).
        self.profile_config: Dict[str, Any] = {}
        # Postmortem bundles minted by journal_trigger (cluster black
        # box): the GCS is the single trigger authority so a cluster-wide
        # failure storm collapses into one bundle per cooldown window.
        self.postmortems: List[dict] = []
        self._pm_seq = 0
        self._pm_last_mono = 0.0
        self._pm_last_payload: Optional[dict] = None
        journal.set_process_label("gcs", weak=True)

        r = self.rpc.register
        # kv
        r("kv_put", self.h_kv_put)
        r("kv_get", self.h_kv_get)
        r("kv_del", self.h_kv_del)
        r("kv_keys", self.h_kv_keys)
        # nodes
        r("register_node", self.h_register_node)
        r("get_nodes", self.h_get_nodes)
        r("resource_update", self.h_resource_update)
        r("drain_node", self.h_drain_node)
        r("cordon_node", self.h_cordon_node)
        r("node_drain_status", self.h_node_drain_status)
        # actors
        r("register_actor", self.h_register_actor)
        r("actor_ready", self.h_actor_ready)
        r("get_actor", self.h_get_actor)
        r("get_named_actor", self.h_get_named_actor)
        r("list_actors", self.h_list_actors)
        r("kill_actor", self.h_kill_actor)
        r("worker_dead", self.h_worker_dead)
        # jobs
        r("register_job", self.h_register_job)
        r("list_jobs", self.h_list_jobs)
        # job submission (dashboard/modules/job analog)
        r("submit_job", self.h_submit_job)
        r("get_job", self.h_get_job)
        r("job_update", self.h_job_update)
        r("job_log_append", self.h_job_log_append)
        r("job_logs", self.h_job_logs)
        r("stop_job", self.h_stop_job)
        # objects
        r("object_location_add", self.h_object_location_add)
        r("object_locations_add", self.h_object_locations_add)
        r("object_location_get", self.h_object_location_get)
        r("object_location_wait", self.h_object_location_wait)
        r("object_location_remove", self.h_object_location_remove)
        r("object_spilled", self.h_object_spilled)
        r("objects_freed", self.h_objects_freed)
        r("list_objects", self.h_list_objects)
        # placement groups
        r("create_placement_group", self.h_create_pg)
        r("remove_placement_group", self.h_remove_pg)
        r("get_placement_group", self.h_get_pg)
        r("list_placement_groups", self.h_list_pgs)
        # elastic resize (partial bundle release / grow-back)
        r("release_pg_bundles", self.h_release_pg_bundles)
        r("reserve_pg_bundles", self.h_reserve_pg_bundles)
        r("get_resize_state", self.h_get_resize_state)
        # preemption
        r("get_preemptions", self.h_get_preemptions)
        r("preempt_node", self.h_preempt_node)
        r("chaos_reclaim_chips", self.h_chaos_reclaim_chips)
        r("chaos_lift_fence", self.h_chaos_lift_fence)
        # pubsub
        r("subscribe", self.h_subscribe)
        r("publish", self.h_publish)
        # task events / state API
        r("add_task_events", self.h_add_task_events)
        r("list_task_events", self.h_list_task_events)
        # metrics (stats agent + prometheus_exporter analog)
        r("metrics_report", self.h_metrics_report)
        r("metrics_snapshot", self.h_metrics_snapshot)
        r("gcs_stats", self.h_gcs_stats)
        # control-plane profiler (runtime sampling toggle)
        r("set_profile_config", self.h_set_profile_config)
        r("get_profile_config", self.h_get_profile_config)
        # cluster black box (util/journal.py): failure-triggered capture
        r("journal_trigger", self.h_journal_trigger)
        r("get_postmortems", self.h_get_postmortems)
        # misc
        r("ping", self.h_ping)

        self.rpc.on_disconnect = self._on_disconnect

        if self.persist_path:
            if os.path.exists(self.persist_path):
                self._restore(self.persist_path)
            for name in _WRITE_METHODS:
                self._base_handlers[name] = self.rpc.handlers[name]
                self.rpc.handlers[name] = self._wrap_durable(
                    name, self.rpc.handlers[name]
                )

    # -- persistence ----------------------------------------------------
    def _wrap_durable(self, name, handler):
        async def wrapped(d, conn):
            # True write-AHEAD, at handler entry: handlers that await
            # mid-mutation (e.g. placement-group creation pushing bundle
            # reservations) would otherwise log in completion order, and
            # replay could resurrect state a concurrent delete removed.
            # Entry order == mutation-start order on this single loop.
            # (A handler that then fails leaves a record whose replay
            # deterministically fails the same way — harmless.)
            self._wal_append(name, d)
            out = await handler(d, conn)
            self._mark_dirty()
            return out

        return wrapped

    def _mark_dirty(self):
        if not self.persist_path:
            return
        self._persist_dirty = True
        if self._persist_task is None or self._persist_task.done():
            self._persist_task = asyncio.ensure_future(self._persist_soon())

    # -- write-ahead log -------------------------------------------------
    def _wal_append(self, method: str, payload: Any):
        if not self._wal_path:
            return
        from ray_tpu_torch._vendor import msgpack

        if self._wal_fh is None:
            self._wal_fh = open(self._wal_path, "ab")
        self._wal_seq += 1
        body = msgpack.packb(
            {"s": self._wal_seq, "m": method, "d": payload}, use_bin_type=True
        )
        rec = struct.pack("<I", len(body)) + body
        self._wal_fh.write(rec)
        self._wal_fh.flush()
        if self._wal_fsync:
            os.fsync(self._wal_fh.fileno())
        self._wal_bytes += len(rec)
        if self._wal_bytes >= self._wal_compact_bytes:
            self._mark_dirty()  # snapshot write doubles as compaction

    def _rotate_wal(self) -> bool:
        """Move the live WAL aside before a snapshot lands; returns True
        if there is a .old file to delete once the snapshot succeeds. A
        previously-failed compaction's .old is folded together with the
        current file so at most two WAL files ever exist."""
        if not self._wal_path or not os.path.exists(self._wal_path):
            return os.path.exists(self._wal_old_path or "")
        if self._wal_fh is not None:
            self._wal_fh.close()
            self._wal_fh = None
        if os.path.exists(self._wal_old_path):
            with open(self._wal_old_path, "ab") as dst, \
                    open(self._wal_path, "rb") as src:
                dst.write(src.read())
            os.remove(self._wal_path)
        else:
            os.rename(self._wal_path, self._wal_old_path)
        self._wal_bytes = 0
        return True

    @staticmethod
    def _read_wal_records(path: str):
        """Yield (seq, method, payload); a torn tail record (crash mid-
        append) terminates the stream cleanly."""
        from ray_tpu_torch._vendor import msgpack

        with open(path, "rb") as f:
            data = f.read()
        pos = 0
        while pos + 4 <= len(data):
            (length,) = struct.unpack_from("<I", data, pos)
            if pos + 4 + length > len(data):
                break  # torn tail
            try:
                rec = msgpack.unpackb(
                    data[pos + 4:pos + 4 + length],
                    raw=False, strict_map_key=False,
                )
            except Exception:  # noqa: BLE001 — corrupt tail
                break
            yield rec["s"], rec["m"], rec["d"]
            pos += 4 + length

    async def _replay_wal(self):
        """Redo acknowledged mutations newer than the snapshot."""
        covered = self._wal_seq

        class _ReplayConn:
            closed = True
            meta: Dict[str, Any] = {}

            async def push(self, *_a, **_k):
                pass

            async def respond(self, *_a, **_k):
                pass

        conn = _ReplayConn()
        replayed = 0
        for path in (self._wal_old_path, self._wal_path):
            if not path or not os.path.exists(path):
                continue
            for seq, method, payload in self._read_wal_records(path):
                if seq <= covered:
                    continue
                handler = self._base_handlers.get(method)
                if handler is None:
                    continue
                try:
                    await handler(payload, conn)
                    replayed += 1
                except Exception:  # noqa: BLE001 — redo is best-effort per record
                    pass
                self._wal_seq = max(self._wal_seq, seq)
        if replayed:
            from ray_tpu_torch.util.event import record_event

            record_event("gcs", "recovered from write-ahead log",
                         severity="INFO", replayed_records=replayed)
            self._mark_dirty()

    def _snapshot_bytes(self) -> bytes:
        import pickle

        return pickle.dumps(
            {
                "kv": {ns: dict(kvs) for ns, kvs in self.kv.items()},
                "jobs": self.jobs,
                "actors": self.actors,
                "named_actors": self.named_actors,
                "placement_groups": self.placement_groups,
                "object_dir": self.object_dir,
                "pg_counter": self.pg_counter,
                "wal_seq": self._wal_seq,
            }
        )

    @staticmethod
    def _write_snapshot(path: str, data: bytes):
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    async def _persist_soon(self):
        while self._persist_dirty:
            self._persist_dirty = False
            await asyncio.sleep(get_config().gcs_persist_debounce_s)
            # Pickle on the loop (tables are mutated by handlers on this
            # loop, so a thread would race them) but write in an executor —
            # the disk I/O is the slow part and must not head-of-line-block
            # heartbeats and scheduling.
            data = self._snapshot_bytes()
            had_old = self._rotate_wal()
            try:
                await asyncio.get_event_loop().run_in_executor(
                    None, self._write_snapshot, self.persist_path, data
                )
            except Exception:  # noqa: BLE001 — .old stays; replay covers it
                continue
            # Snapshot covers every rotated record: compaction complete.
            if had_old:
                try:
                    os.remove(self._wal_old_path)
                except OSError:
                    pass

    def _restore(self, path: str):
        import pickle

        with open(path, "rb") as f:
            snap = pickle.load(f)
        for ns, kvs in snap.get("kv", {}).items():
            self.kv[ns].update(kvs)
        self.jobs.update(snap.get("jobs", {}))
        self.actors.update(snap.get("actors", {}))
        self.named_actors.update(snap.get("named_actors", {}))
        self.placement_groups.update(snap.get("placement_groups", {}))
        self.object_dir.update(snap.get("object_dir", {}))
        self.pg_counter = snap.get("pg_counter", self.pg_counter)
        self._wal_seq = snap.get("wal_seq", 0)

    # ------------------------------------------------------------------
    async def start(self) -> int:
        if self.persist_path:
            # Redo acknowledged-but-unsnapshotted mutations before the
            # listener opens — clients must never observe pre-replay state.
            await self._replay_wal()
        port = await self.rpc.start()
        self._health_task = asyncio.ensure_future(self._health_loop())
        self._started.set()
        return port

    async def stop(self):
        # Stop flag first: the connection teardown below triggers
        # _on_disconnect for every peer, which would otherwise mark nodes
        # (and their actors) dead and persist that into the snapshot a
        # restarted GCS restores from.
        self._stopping = True
        if self._health_task:
            self._health_task.cancel()
        persist_pending = (
            self._persist_task is not None and not self._persist_task.done()
        )
        if persist_pending:
            self._persist_task.cancel()
        if self.persist_path and (self._persist_dirty or persist_pending):
            # Flush acknowledged-but-debounced mutations synchronously: a
            # clean shutdown must not lose the last 50ms of writes (the
            # loop clears the dirty flag before its debounce sleep, so a
            # cancelled-in-flight task also means unflushed writes).
            self._persist_dirty = False
            data = self._snapshot_bytes()
            had_old = self._rotate_wal()
            self._write_snapshot(self.persist_path, data)
            # The final snapshot covers everything: drop compacted WALs.
            if had_old:
                try:
                    os.remove(self._wal_old_path)
                except OSError:
                    pass
        if self._wal_fh is not None:
            try:
                self._wal_fh.close()
            except OSError:
                pass
            self._wal_fh = None
        await self.rpc.stop()

    async def kill(self):
        """Abrupt death for fault injection: no final snapshot — only the
        per-write WAL flushes survive, which is the point: chaos tests
        validate WAL replay from exactly this state (the in-process
        equivalent of `kill -9` on the GCS)."""
        self._stopping = True
        if self._health_task:
            self._health_task.cancel()
        if self._persist_task is not None and not self._persist_task.done():
            self._persist_task.cancel()
        if self._wal_fh is not None:
            try:
                self._wal_fh.close()
            except OSError:
                pass
            self._wal_fh = None
        await self.rpc.stop()

    async def publish(self, channel: str, payload: Any):
        dead = []
        for conn in list(self.subscribers.get(channel, ())):
            if conn.closed:
                dead.append(conn)
            else:
                await conn.push(channel, payload)
        for c in dead:
            self.subscribers[channel].discard(c)

    async def _on_disconnect(self, conn: ServerConnection):
        if self._stopping:
            return  # our own teardown, not a peer death
        for subs in self.subscribers.values():
            subs.discard(conn)
        node_id = conn.meta.get("node_id")
        if node_id and node_id in self.nodes:
            await self._mark_node_dead(node_id, "connection lost")

    async def _health_loop(self):
        cfg = get_config()
        tick = 0
        sleep_s = min(0.25, cfg.health_check_period_s)
        last_wake = time.monotonic()
        while True:
            await asyncio.sleep(sleep_s)
            tick += 1
            # Suspend detection (the standard failure-detector guard, cf.
            # phi-accrual): if this loop itself just missed its deadline —
            # event-loop stall, GC pause, machine suspend — the monitor
            # was deaf for that window and cannot distinguish "node
            # silent" from "I wasn't listening". Forgive the pause
            # instead of charging it against every node's heartbeat.
            now = time.monotonic()
            pause = now - last_wake - sleep_s
            last_wake = now
            if pause > cfg.health_check_period_s:
                for info in self.nodes.values():
                    info["last_heartbeat"] = min(
                        now, info["last_heartbeat"] + pause
                    )
            # Retry pending actors as the resource view changes — highest
            # priority first, so a spike's demand is considered before the
            # best-effort tier it may be about to evict.
            for actor_id in sorted(
                self.pending_actors,
                key=lambda aid: -int(
                    (self.actors.get(aid) or {}).get("priority") or 0
                ),
            ):
                a = self.actors.get(actor_id)
                if a is None or a["state"] not in ("PENDING", "RESTARTING"):
                    self.pending_actors.discard(actor_id)
                    continue
                if await self._schedule_actor(actor_id):
                    self.pending_actors.discard(actor_id)
                else:
                    self._maybe_preempt(
                        actor_id,
                        a.get("name") or a.get("class_name") or "actor",
                        int(a.get("priority") or 0),
                        [a.get("resources") or {}],
                        "PACK",
                    )
            # Retry pending placement groups, priority first.
            for pg_id in sorted(
                self.pending_pgs,
                key=lambda pid: -int(
                    (self.placement_groups.get(pid) or {}).get("priority")
                    or 0
                ),
            ):
                pg = self.placement_groups.get(pg_id)
                if pg is None or pg["state"] != "PENDING":
                    self.pending_pgs.discard(pg_id)
                    continue
                result = await self._try_reserve_pg(pg)
                if result.get("ok"):
                    self.pending_pgs.discard(pg_id)
                else:
                    self._maybe_preempt(
                        pg_id,
                        self._pg_tenant(pg),
                        int(pg.get("priority") or 0),
                        pg["bundles"],
                        pg["strategy"],
                    )
            await self._preemption_tick()
            if tick * 0.25 < cfg.health_check_period_s:
                continue
            tick = 0
            now = time.monotonic()
            timeout = cfg.health_check_period_s * cfg.health_check_failure_threshold
            for node_id, info in list(self.nodes.items()):
                if info["state"] == "ALIVE" and now - info["last_heartbeat"] > timeout:
                    await self._mark_node_dead(node_id, "health check timeout")

    async def _mark_node_dead(self, node_id: bytes, reason: str):
        info = self.nodes.get(node_id)
        if not info or info["state"] == "DEAD":
            return
        info["state"] = "DEAD"
        info["death_reason"] = reason
        self.node_conns.pop(node_id, None)
        from ray_tpu_torch.util.event import record_event

        record_event("gcs", f"node marked DEAD: {reason}",
                     severity="ERROR", node_id=node_id.hex())
        journal.emit("gcs.node_dead", node_id=node_id.hex(), reason=reason)
        # Fail actors living on that node; restart if budget remains.
        for actor_id, a in list(self.actors.items()):
            if a.get("node_id") == node_id and a["state"] in ("ALIVE", "PENDING", "RESTARTING"):
                await self._on_actor_failure(actor_id, f"node died: {reason}")
        # Drop object locations on that node; spill copies on its local
        # disk died with it.
        for oid, entry in self.object_dir.items():
            entry["nodes"].discard(node_id)
            if entry.get("spilled", {}).get("node_id") == node_id:
                entry.pop("spilled", None)
        # Fail submitted jobs supervised by that node — their drivers died
        # with it, and no further state updates will ever arrive.
        for j in self.jobs.values():
            if (
                j.get("node_id") == node_id
                and j.get("state") in ("PENDING", "RUNNING")
            ):
                j["state"] = "FAILED"
                j["end_time"] = time.time()
                j["message"] = f"supervising node died: {reason}"
        await self.publish("node_dead", {"node_id": node_id, "reason": reason})
        self._mark_dirty()

    # -- kv -------------------------------------------------------------
    async def h_kv_put(self, d, conn):
        ns = d.get("ns", "")
        overwrite = d.get("overwrite", True)
        table = self.kv[ns]
        if not overwrite and d["key"] in table:
            return {"added": False}
        table[d["key"]] = d["value"]
        return {"added": True}

    async def h_kv_get(self, d, conn):
        return {"value": self.kv[d.get("ns", "")].get(d["key"])}

    async def h_kv_del(self, d, conn):
        return {"deleted": self.kv[d.get("ns", "")].pop(d["key"], None) is not None}

    async def h_kv_keys(self, d, conn):
        prefix = d.get("prefix", b"")
        return {"keys": [k for k in self.kv[d.get("ns", "")] if k.startswith(prefix)]}

    # -- nodes ----------------------------------------------------------
    async def h_register_node(self, d, conn):
        node_id = d["node_id"]
        self.nodes[node_id] = {
            "node_id": node_id,
            "address": d["address"],
            "port": d["port"],
            "object_store_name": d.get("object_store_name"),
            "machine_id": d.get("machine_id"),
            "resources_total": d["resources"],
            "resources_available": dict(d["resources"]),
            "labels": d.get("labels", {}),
            "state": "ALIVE",
            "last_heartbeat": time.monotonic(),
            "is_head": d.get("is_head", False),
        }
        conn.meta["node_id"] = node_id
        self.node_conns[node_id] = conn
        await self.publish("node_added", {"node_id": node_id})
        return {"ok": True}

    async def h_get_nodes(self, d, conn):
        out = []
        for info in self.nodes.values():
            out.append({k: v for k, v in info.items() if k != "last_heartbeat"})
        return {"nodes": out}

    def _rpc_complete(self, method: str, dur_s: float) -> None:
        """RpcServer on_complete hook: fold one served RPC's handler
        latency into the per-method accounting."""
        st = self.rpc_latency.get(method)
        if st is None:
            st = self.rpc_latency[method] = {
                "count": 0, "sum_s": 0.0, "max_s": 0.0,
                "buckets": [0] * (len(_RPC_LATENCY_BOUNDS) + 1),
            }
        st["count"] += 1
        st["sum_s"] += dur_s
        if dur_s > st["max_s"]:
            st["max_s"] = dur_s
        st["buckets"][bisect_left(_RPC_LATENCY_BOUNDS, dur_s)] += 1

    async def h_gcs_stats(self, d, conn):
        """GCS-internal runtime metrics (per-component stats, the
        stats/metric_defs.h role): rpc volume + per-method handler
        latency (count/sum/max/buckets over rpc_latency_boundaries) +
        table sizes. `rt rpc` renders the latency table."""
        return {
            "rpc_counts": dict(self.rpc_counts),
            "rpc_latency": {
                m: dict(st, buckets=list(st["buckets"]))
                for m, st in self.rpc_latency.items()
            },
            "rpc_latency_boundaries": list(_RPC_LATENCY_BOUNDS),
            "nodes_alive": sum(
                1 for n in self.nodes.values() if n["state"] == "ALIVE"
            ),
            "kv_entries": sum(len(t) for t in self.kv.values()),
            "task_events": len(self.task_events),
            "task_events_dropped": self._task_events_dropped,
            "subscriber_conns": sum(
                len(s) for s in self.subscribers.values()
            ),
            "object_dir_entries": len(self.object_dir),
            "placement_groups": len(self.placement_groups),
        }

    async def h_set_profile_config(self, d, conn):
        """Flip control-plane profiling at runtime (`rt profile --on`):
        persist the sampling rate in the GCS and broadcast it so every
        connected client (drivers AND workers) adjusts without restarts.
        Server-originated publish — profile_config is not a client-
        publishable channel."""
        updates = {
            k: d[k] for k in ("task_trace_sample",) if d.get(k) is not None
        }
        self.profile_config.update(updates)
        await self.publish("profile_config", dict(self.profile_config))
        return {"ok": True, "profile_config": dict(self.profile_config)}

    async def h_get_profile_config(self, d, conn):
        return {"profile_config": dict(self.profile_config)}

    async def h_resource_update(self, d, conn):
        """Raylet pushes its resource view (ray_syncer analog:
        versioned deltas with gap detection; full maps as fallback).

        A version gap — anything other than last+1 on a delta — means
        this GCS missed state (restart, dropped ack): reply need_full so
        the raylet rebases with its whole view. Version 1 with a full map
        establishes (or re-establishes) the baseline.
        """
        info = self.nodes.get(d["node_id"])
        if not info:
            # Unknown node (GCS restarted before re-registration): the
            # raylet must re-register; meanwhile ask for a full view.
            return {"ok": False, "need_full": True}
        if "proc_stats" in d:
            info["proc_stats"] = d["proc_stats"]
        ver = d.get("version")
        full = "available" in d
        # need_full replies still carry the draining flag — a version gap
        # must not silently un-cordon the raylet for a beat.
        drain_flag = (
            {"draining": True} if info.get("draining") else {}
        )
        if ver is not None and not full:
            expected = info.get("sync_version")
            if expected is None or ver != expected + 1:
                return {"ok": False, "need_full": True, **drain_flag}
        # The raylet's delta is against what it last sent, not against
        # the advisory view, which placements deduct from in between:
        # keep the reported view apart and rebase the advisory one on it.
        # Applying the delta to the advisory view instead kept a
        # deduction forever once the raylet acquired and released the
        # resources between two heartbeats (an actor killed within one
        # heartbeat period), and nothing could be placed there again.
        if full:
            info["resources_reported"] = dict(d["available"])
        else:
            avail = info.setdefault("resources_reported",
                                    dict(info["resources_available"]))
            avail.update(d.get("delta", {}))
            for k in d.get("removed", ()):
                avail.pop(k, None)
        info["resources_available"] = dict(info["resources_reported"])
        if ver is not None:
            info["sync_version"] = ver
        if "total" in d:
            info["resources_total"] = d["total"]
        if "demand_bundles" in d:
            info["demand_bundles"] = d["demand_bundles"]
        info["last_heartbeat"] = time.monotonic()
        return {"ok": True, **drain_flag}

    async def h_drain_node(self, d, conn):
        # Actors still pending on a hard affinity to this node can never
        # place once it is gone: fail them with a clear cause instead of
        # leaving their creators waiting forever.
        for actor_id in list(self.pending_actors):
            a = self.actors.get(actor_id)
            sched = (a or {}).get("scheduling") or {}
            if (
                sched.get("type") == "node_affinity"
                and sched.get("node_id") == d["node_id"]
                and not sched.get("soft", False)
            ):
                self.pending_actors.discard(actor_id)
                a["state"] = "DEAD"
                a["death_cause"] = "hard-affinity node was drained"
                await self.publish(
                    "actor_update:" + actor_id.hex(), self._actor_view(a)
                )
        await self._mark_node_dead(d["node_id"], "drained")
        return {"ok": True}

    async def h_cordon_node(self, d, conn):
        """Graceful drain step 1 (reference: `ray drain-node`,
        autoscaler.proto DrainNode): mark the node draining — every
        placement path skips it, its raylet stops keeping new work local
        (heartbeat replies carry the flag) — while running work finishes.
        Step 2 is polling drain_status until idle, then drain_node."""
        info = self.nodes.get(d["node_id"])
        if not info or info["state"] != "ALIVE":
            return {"ok": False, "error": "node not alive"}
        if info.get("is_head") and not d.get("undo"):
            # Draining the head would fail every supervised job and
            # leave the cluster headless; the reference's DrainNode is
            # a worker-node operation too.
            return {"ok": False, "error": "refusing to drain the head node"}
        info["draining"] = not d.get("undo", False)
        return {"ok": True}

    async def h_node_drain_status(self, d, conn):
        """idle = every resource fully available again (tasks done,
        actors gone, PG bundles returned) and no queued demand."""
        info = self.nodes.get(d["node_id"])
        if not info:
            return {"ok": False, "error": "unknown node"}
        avail, total = info["resources_available"], info["resources_total"]
        # GCS-pending actors hard-affined here block the drain: once the
        # node is removed they could never place (the operator must undo
        # the cordon, or the removal path fails them explicitly).
        blocked_actors = 0
        for actor_id in self.pending_actors:
            a = self.actors.get(actor_id)
            sched = (a or {}).get("scheduling") or {}
            if (
                sched.get("type") == "node_affinity"
                and sched.get("node_id") == d["node_id"]
                and not sched.get("soft", False)
            ):
                blocked_actors += 1
        idle = (
            all(avail.get(k, 0.0) + 1e-6 >= v for k, v in total.items())
            and not info.get("demand_bundles")
            and blocked_actors == 0
        )
        return {
            "ok": True,
            "draining": bool(info.get("draining")),
            "idle": idle,
            "state": info["state"],
            "pending_affinity_actors": blocked_actors,
        }

    # -- jobs -----------------------------------------------------------
    async def h_register_job(self, d, conn):
        self.jobs[d["job_id"]] = {
            "job_id": d["job_id"],
            "driver_pid": d.get("pid"),
            "start_time": time.time(),
            "state": "RUNNING",
            "entrypoint": d.get("entrypoint", ""),
        }
        return {"ok": True}

    async def h_list_jobs(self, d, conn):
        return {"jobs": [self._job_view(j) for j in self.jobs.values()]}

    # -- job submission ---------------------------------------------------
    # The head raylet plays JobSupervisor (dashboard/modules/job/
    # job_manager.py:525 + the per-job JobSupervisor actor :140): the GCS
    # pushes run_job to it, it spawns the detached driver subprocess and
    # streams state/logs back.
    @staticmethod
    def _job_view(j: dict) -> dict:
        return {k: v for k, v in j.items() if k != "logs"}

    def _find_supervisor_node(self) -> Optional[bytes]:
        for nid, info in self.nodes.items():
            if info["state"] == "ALIVE" and info.get("is_head"):
                return nid
        for nid, info in self.nodes.items():  # headless test clusters
            if info["state"] == "ALIVE":
                return nid
        return None

    async def h_submit_job(self, d, conn):
        submission_id = d.get("submission_id") or f"rtjob_{len(self.jobs):05d}_{int(time.time())}"
        job_key = submission_id.encode()
        if job_key in self.jobs:
            return {"ok": False, "error": f"job {submission_id} already exists"}
        node_id = self._find_supervisor_node()
        if node_id is None:
            return {"ok": False, "error": "no alive node to run the job"}
        self.jobs[job_key] = {
            "job_id": job_key,
            "submission_id": submission_id,
            "entrypoint": d["entrypoint"],
            "state": "PENDING",
            "start_time": time.time(),
            "end_time": None,
            "node_id": node_id,
            "runtime_env": d.get("runtime_env") or {},
            "metadata": d.get("metadata") or {},
            "logs": [],
        }
        try:
            await self.node_conns[node_id].push(
                "run_job",
                {
                    "submission_id": submission_id,
                    "entrypoint": d["entrypoint"],
                    "runtime_env": d.get("runtime_env") or {},
                },
            )
        except Exception as e:  # noqa: BLE001 — roll back the record
            self.jobs.pop(job_key, None)
            return {"ok": False, "error": f"failed to dispatch job: {e}"}
        return {"ok": True, "submission_id": submission_id}

    def _find_job(self, submission_id: str) -> Optional[dict]:
        return self.jobs.get(submission_id.encode())

    async def h_get_job(self, d, conn):
        j = self._find_job(d["submission_id"])
        return {"job": self._job_view(j) if j else None}

    async def h_job_update(self, d, conn):
        j = self._find_job(d["submission_id"])
        if j is None:
            return {"ok": False}
        j["state"] = d["state"]
        if d.get("message"):
            j["message"] = d["message"]
        if d["state"] in ("SUCCEEDED", "FAILED", "STOPPED"):
            j["end_time"] = time.time()
        return {"ok": True}

    async def h_job_log_append(self, d, conn):
        j = self._find_job(d["submission_id"])
        if j is None:
            return {"ok": False}
        logs = j["logs"]
        logs.append(d["data"])
        # Bound memory: keep the newest ~4 MB of log text.
        total = sum(len(c) for c in logs)
        while len(logs) > 1 and total > 4_000_000:
            total -= len(logs.pop(0))
        return {"ok": True}

    async def h_job_logs(self, d, conn):
        j = self._find_job(d["submission_id"])
        if j is None:
            return {"logs": None}
        return {"logs": "".join(j["logs"])}

    async def h_stop_job(self, d, conn):
        j = self._find_job(d["submission_id"])
        if j is None:
            return {"ok": False, "error": "no such job"}
        if j["state"] in ("SUCCEEDED", "FAILED", "STOPPED"):
            return {"ok": True}
        node_conn = self.node_conns.get(j.get("node_id"))
        if node_conn is None:
            return {"ok": False, "error": "supervising node is unreachable"}
        await node_conn.push("stop_job", {"submission_id": j["submission_id"]})
        return {"ok": True}

    # -- actor scheduling ------------------------------------------------
    def _pick_node_for_resources(self, resources: Dict[str, float],
                                 exclude: Set[bytes] = frozenset(),
                                 claimant: Optional[bytes] = None) -> Optional[bytes]:
        """Least-utilized feasible node (GcsActorScheduler::ScheduleByGcs).

        Feasibility is judged against the node's *current availability*
        (advisory view: deducted on placement, corrected by heartbeats).
        Judging by totals would double-book chips a placement group has
        reserved — and, worse, keep an infeasible high-priority actor out
        of the pending queue, which is what arms the reclamation pass.
        An actor nothing can hold right now stays PENDING and is retried
        as the view changes (GcsActorManager's pending queue does the
        same). Nodes fenced for a preemption claimant are invisible to
        everyone but that claimant — freed chips must not leak to
        bystanders.
        """
        best, best_score = None, None
        for node_id, info in self.nodes.items():
            if (info["state"] != "ALIVE" or node_id in exclude
                    or info.get("draining")):
                continue
            fence = info.get("fenced_for")
            if fence is not None and fence != claimant:
                continue
            avail, total = info["resources_available"], info["resources_total"]
            if not all(avail.get(k, 0.0) + 1e-9 >= v
                       for k, v in resources.items()):
                continue
            util = 0.0
            for k, t in total.items():
                if t > 0:
                    util = max(util, 1.0 - avail.get(k, 0.0) / t)
            if best_score is None or util < best_score:
                best, best_score = node_id, util
        return best

    async def h_register_actor(self, d, conn):
        actor_id = d["actor_id"]
        name, ns = d.get("name"), d.get("namespace", "")
        if name:
            key = (ns, name)
            if key in self.named_actors and \
               self.actors[self.named_actors[key]]["state"] != "DEAD":
                return {"ok": False, "error": f"actor name {name!r} already taken"}
            self.named_actors[key] = actor_id
        self.actors[actor_id] = {
            "actor_id": actor_id,
            "name": name,
            "namespace": ns,
            "class_name": d.get("class_name", ""),
            "job_id": d.get("job_id"),
            "state": "PENDING",
            "resources": d.get("resources", {}),
            "max_restarts": d.get("max_restarts", 0),
            "restarts_used": 0,
            "create_spec": d["create_spec"],  # opaque: replayed on restart
            "node_id": None,
            "address": None,
            "port": None,
            "death_cause": None,
            "detached": d.get("detached", False),
            "scheduling": d.get("scheduling"),
            "priority": int(d.get("priority") or 0),
        }
        if d.get("subscribe"):
            # Bundle the caller's actor_update subscription into the
            # registration (saves the separate subscribe round trip the
            # driver otherwise pays per actor).
            self.subscribers["actor_update:" + actor_id.hex()].add(conn)
        ok = await self._schedule_actor(actor_id)
        if not ok:
            # Stay PENDING and retry as the cluster view changes — actor
            # creation is asynchronous in the reference too
            # (GcsActorManager keeps pending actors, gcs_actor_manager.cc).
            self.pending_actors.add(actor_id)
        return {"ok": True}

    async def _schedule_actor(self, actor_id: bytes) -> bool:
        a = self.actors[actor_id]
        node_id = None
        sched = a.get("scheduling") or {}
        if sched.get("type") == "node_affinity":
            nid = sched["node_id"]
            info = self.nodes.get(nid)
            placeable = (
                info and info["state"] == "ALIVE"
                and not info.get("draining")
            )
            if placeable:
                node_id = nid
            elif not sched.get("soft", False):
                # Hard affinity to a dead/draining node: stay pending
                # (retried each reconcile; resolves when the drain is
                # undone or the node comes back).
                return False
        if node_id is None and sched.get("type") == "placement_group":
            pg = self.placement_groups.get(sched["pg_id"])
            if not pg or pg["state"] != "CREATED":
                return False
            node_id = pg["bundle_nodes"][sched.get("bundle_index") or 0]
        if node_id is None and sched.get("type") == "node_label":
            hard, soft = sched.get("hard", {}), sched.get("soft", {})
            best, best_soft = None, -1
            for nid, info in self.nodes.items():
                if info["state"] != "ALIVE" or info.get("draining"):
                    continue
                labels = info.get("labels") or {}
                if not all(labels.get(k) == v for k, v in hard.items()):
                    continue
                nsoft = sum(1 for k, v in soft.items() if labels.get(k) == v)
                if nsoft > best_soft:
                    best, best_soft = nid, nsoft
            node_id = best
            if node_id is None:
                return False
        if node_id is None:
            node_id = self._pick_node_for_resources(
                a["resources"], claimant=actor_id
            )
        if node_id is None:
            return False
        # Deduct from the advisory view so a burst of registrations spreads
        # correctly; the raylet heartbeat is the ground truth.
        if sched.get("type") != "placement_group":
            info = self.nodes.get(node_id)
            if info:
                for k, v in a["resources"].items():
                    info["resources_available"][k] = (
                        info["resources_available"].get(k, 0) - v
                    )
        a["node_id"] = node_id
        a["state"] = "PENDING"
        conn = self.node_conns.get(node_id)
        if conn is None:
            return False
        # Fire-and-forget: the raylet spawns a dedicated worker and the worker
        # reports back via actor_ready (gcs_actor_scheduler.cc lease flow).
        await conn.push(
            "create_actor",
            {"actor_id": actor_id, "create_spec": a["create_spec"],
             "resources": a["resources"], "scheduling": a.get("scheduling")},
        )
        # A placed claimant no longer needs its reclamation fences.
        self._clear_fences(actor_id)
        return True

    async def h_actor_unplaceable(self, d, conn):
        """A raylet refused a placement (the advisory view it was chosen
        under went stale before the create arrived): return the advisory
        deduction and re-queue the actor — the pending retry re-places it
        or, for a high-priority claimant, arms the reclamation pass."""
        a = self.actors.get(d["actor_id"])
        if a is None or a["state"] not in ("PENDING", "RESTARTING"):
            return {"ok": True}
        nid = a.get("node_id")
        if nid is not None and nid == d.get("node_id"):
            info = self.nodes.get(nid)
            if info is not None and \
                    (a.get("scheduling") or {}).get("type") != "placement_group":
                for k, v in (a.get("resources") or {}).items():
                    info["resources_available"][k] = (
                        info["resources_available"].get(k, 0) + v
                    )
            a["node_id"] = None
        self.pending_actors.add(d["actor_id"])
        return {"ok": True}

    async def h_actor_ready(self, d, conn):
        a = self.actors.get(d["actor_id"])
        if not a:
            return {"ok": False}
        if d.get("error"):
            a["state"] = "DEAD"
            a["death_cause"] = d["error"]
        else:
            a["state"] = "ALIVE"
            a["address"] = d["address"]
            a["port"] = d["port"]
            a["worker_id"] = d.get("worker_id")
            a["methods"] = d.get("methods") or []
        journal.emit("gcs.actor", actor_id=d["actor_id"].hex(),
                     state=a["state"], name=a.get("name") or "",
                     class_name=a.get("class_name", ""))
        await self.publish(
            "actor_update:" + d["actor_id"].hex(), self._actor_view(a)
        )
        return {"ok": True}

    def _actor_view(self, a: dict) -> dict:
        return {
            "actor_id": a["actor_id"],
            "state": a["state"],
            "address": a["address"],
            "port": a["port"],
            "node_id": a["node_id"],
            "name": a["name"],
            "namespace": a["namespace"],
            "class_name": a["class_name"],
            "death_cause": a["death_cause"],
            "restarts_used": a["restarts_used"],
            "methods": a.get("methods") or [],
        }

    async def h_get_actor(self, d, conn):
        a = self.actors.get(d["actor_id"])
        return {"actor": self._actor_view(a) if a else None}

    async def h_get_named_actor(self, d, conn):
        aid = self.named_actors.get((d.get("namespace", ""), d["name"]))
        a = self.actors.get(aid) if aid else None
        return {"actor": self._actor_view(a) if a else None}

    async def h_list_actors(self, d, conn):
        return {"actors": [self._actor_view(a) for a in self.actors.values()]}

    async def _on_actor_failure(self, actor_id: bytes, reason: str):
        a = self.actors[actor_id]
        if a["restarts_used"] < a["max_restarts"] or a["max_restarts"] == -1:
            a["restarts_used"] += 1
            a["state"] = "RESTARTING"
            from ray_tpu_torch.util.event import record_event

            record_event(
                "gcs", f"actor restarting ({reason})", severity="WARNING",
                actor_id=actor_id.hex(), class_name=a.get("class_name", ""),
                restarts_used=a["restarts_used"],
            )
            journal.emit("gcs.actor", actor_id=actor_id.hex(),
                         state="RESTARTING", reason=reason,
                         name=a.get("name") or "",
                         class_name=a.get("class_name", ""))
            await self.publish("actor_update:" + actor_id.hex(), self._actor_view(a))
            ok = await self._schedule_actor(actor_id)
            if not ok:
                self.pending_actors.add(actor_id)
            return
        a["state"] = "DEAD"
        a["death_cause"] = reason
        journal.emit("gcs.actor", actor_id=actor_id.hex(), state="DEAD",
                     reason=reason, name=a.get("name") or "",
                     class_name=a.get("class_name", ""))
        await self.publish("actor_update:" + actor_id.hex(), self._actor_view(a))

    async def h_worker_dead(self, d, conn):
        """Raylet reports a worker process exit; fail any actor it hosted."""
        actor_id = d.get("actor_id")
        journal.emit("gcs.worker_dead",
                     actor_id=actor_id.hex() if actor_id else "",
                     intended=bool(d.get("intended")),
                     reason=d.get("reason", ""))
        if actor_id and actor_id in self.actors:
            a = self.actors[actor_id]
            if a["state"] != "DEAD":
                if d.get("intended") and d.get("no_restart", True):
                    a["state"] = "DEAD"
                    a["death_cause"] = d.get("reason", "killed")
                    journal.emit("gcs.actor", actor_id=actor_id.hex(),
                                 state="DEAD",
                                 reason=d.get("reason", "killed"),
                                 name=a.get("name") or "")
                    await self.publish(
                        "actor_update:" + actor_id.hex(), self._actor_view(a)
                    )
                else:
                    await self._on_actor_failure(
                        actor_id, d.get("reason", "worker process died")
                    )
            # ActorDied capture: an UNINTENDED worker exit is a primary
            # failure — freeze every process's ring while the evidence of
            # why is still in the buffers (cooldown keeps crash loops to
            # one bundle per window).
            if not d.get("intended") and get_config().journal_autodump:
                await self._journal_postmortem(
                    f"worker_dead:{d.get('reason', 'unknown')}",
                    source="gcs",
                )
        return {"ok": True}

    async def h_kill_actor(self, d, conn):
        actor_id = d["actor_id"]
        a = self.actors.get(actor_id)
        if not a:
            return {"ok": False}
        if d.get("no_restart", True):
            a["max_restarts"] = 0
        will_restart = (
            a["max_restarts"] == -1
            or a["restarts_used"] < a["max_restarts"]
        )
        node = self.node_conns.get(a.get("node_id"))
        if node:
            # will_restart gates worker recycling: a restarted actor would
            # be adopted onto the same worker/port and the caller's cached
            # connection would resume stale seq counters (they reset only
            # with the connection). Restartable kills take a fresh process.
            await node.push(
                "kill_actor_worker",
                {"actor_id": actor_id, "will_restart": will_restart},
            )
        return {"ok": True}

    # -- object directory ------------------------------------------------
    async def h_object_location_add(self, d, conn):
        if d.get("partial"):
            # An in-progress pull: the node can serve its filled prefix
            # (chain/tree replication, reference object_manager.cc:339
            # any-holder pulls). seq gives chain seniority: a puller may
            # only chain to partials with a LOWER seq, which keeps the
            # replication graph acyclic.
            entry = self.object_dir.setdefault(
                oid := d["object_id"], {"nodes": set(), "size": 0}
            )
            partial = entry.setdefault("partial", {})
            if d["node_id"] not in partial:
                self._partial_seq += 1
                partial[d["node_id"]] = self._partial_seq
            return {"ok": True, "seq": partial[d["node_id"]]}
        self._location_add(d["object_id"], d["node_id"], d.get("size"))
        return {"ok": True}

    async def h_object_locations_add(self, d, conn):
        """Batched location registration (one frame per raylet flush)."""
        node_id = d["node_id"]
        for o in d["objects"]:
            self._location_add(o["object_id"], node_id, o.get("size"))
        return {"ok": True}

    def _location_add(self, oid: bytes, node_id: bytes, size):
        entry = self.object_dir.setdefault(oid, {"nodes": set(), "size": 0})
        entry["nodes"].add(node_id)
        entry.get("partial", {}).pop(node_id, None)
        if size is not None:
            entry["size"] = size
        for ev in self.object_waiters.pop(oid, []):
            ev.set()

    @staticmethod
    def _loc_view(entry) -> dict:
        out = {"nodes": list(entry["nodes"]), "size": entry["size"],
               "known": True}
        if entry.get("spilled"):
            out["spilled"] = entry["spilled"]
        partial = entry.get("partial")
        if partial:
            # [node_id, seq] sorted senior-first: pullers may chain only
            # to partials with seq lower than their own.
            out["partial_nodes"] = sorted(
                ([nid, seq] for nid, seq in partial.items()),
                key=lambda x: x[1],
            )
        return out

    async def h_object_location_get(self, d, conn):
        entry = self.object_dir.get(d["object_id"])
        if not entry:
            # known=False: never registered — may simply not be produced yet
            # (vs. known+empty = every copy is gone).
            return {"nodes": [], "size": 0, "known": False}
        return self._loc_view(entry)

    async def h_object_location_wait(self, d, conn):
        """Block until the object has a location or a spill copy (or
        timeout)."""
        oid = d["object_id"]
        timeout = d.get("timeout", 60.0)
        entry = self.object_dir.get(oid)
        if entry and (entry["nodes"] or entry.get("spilled")):
            return self._loc_view(entry)
        ev = asyncio.Event()
        self.object_waiters[oid].append(ev)
        try:
            await asyncio.wait_for(ev.wait(), timeout)
        except asyncio.TimeoutError:
            return {"nodes": [], "size": 0, "timeout": True}
        finally:
            # Clients probing a never-produced object every few seconds
            # would otherwise grow the waiter list without bound.
            waiters = self.object_waiters.get(oid)
            if waiters is not None:
                try:
                    waiters.remove(ev)
                except ValueError:
                    pass
                if not waiters:
                    self.object_waiters.pop(oid, None)
        entry = self.object_dir.get(oid, {"nodes": set(), "size": 0})
        return self._loc_view(entry)

    async def h_object_spilled(self, d, conn):
        """A raylet spilled its primary copy: record the restore URI and
        drop the in-memory location."""
        oid = d["object_id"]
        entry = self.object_dir.setdefault(oid, {"nodes": set(), "size": 0})
        entry["nodes"].discard(d["node_id"])
        entry["spilled"] = {"node_id": d["node_id"], "uri": d["uri"]}
        return {"ok": True}

    async def h_list_objects(self, d, conn):
        limit = d.get("limit", 10_000)
        out = []
        for oid, entry in self.object_dir.items():
            if len(out) >= limit:
                break
            out.append(
                {"object_id": oid, "nodes": list(entry["nodes"]),
                 "size": entry["size"]}
            )
        return {"objects": out}

    async def h_object_location_remove(self, d, conn):
        entry = self.object_dir.get(d["object_id"])
        if entry:
            entry.get("partial", {}).pop(d["node_id"], None)
            if not d.get("partial_only"):
                entry["nodes"].discard(d["node_id"])
            if d.get("clear_spilled"):
                # Loss injection / spill-file reclaim: the spilled copy
                # is gone too, so restores must not be offered.
                entry.pop("spilled", None)
        return {"ok": True}

    async def h_objects_freed(self, d, conn):
        """Owner freed these objects: drop the directory entries and tell
        every node still holding a copy (or a spill file) to reclaim it.
        The eviction-notification role of the reference's pubsub object
        channels (protobuf/pubsub.proto:30-48), owner-initiated."""
        for oid in d["object_ids"]:
            entry = self.object_dir.pop(oid, None)
            targets: set = set()
            if entry:
                targets |= set(entry["nodes"])
                sp = entry.get("spilled")
                if sp:
                    targets.add(sp["node_id"])
            for nid in targets:
                node_conn = self.node_conns.get(nid)
                if node_conn is not None and node_conn is not conn:
                    try:
                        await node_conn.push(
                            "free_objects", {"object_ids": [oid]}
                        )
                    except Exception:  # noqa: BLE001
                        pass
            # Wake location waiters: they observe the empty entry instead
            # of hanging until timeout.
            for ev in self.object_waiters.pop(oid, []):
                ev.set()
        return {"ok": True}

    # -- placement groups -------------------------------------------------
    async def h_create_pg(self, d, conn):
        """Two-phase reserve of bundles across raylets.

        Mirrors GcsPlacementGroupScheduler's prepare/commit
        (gcs/gcs_server/gcs_placement_group_scheduler.h): all bundles are
        prepared on their raylets first; any failure rolls back. Failed
        reservations stay PENDING and are retried from the health loop as
        the resource view changes.
        """
        pg_id = d["pg_id"]
        self.pg_counter += 1
        pg = {
            "pg_id": pg_id,
            "name": d.get("name", ""),
            "bundles": d["bundles"],
            "strategy": d.get("strategy", "PACK"),
            "state": "PENDING",
            "bundle_nodes": [None] * len(d["bundles"]),
            # Preemption tier: when this group cannot place, strictly
            # lower-priority CREATED groups are eviction candidates (and
            # this group is itself a candidate for higher tiers).
            "priority": int(d.get("priority") or 0),
            # Creation order: ties inside a priority tier evict the
            # youngest gang first (it has the least sunk work).
            "seq": self.pg_counter,
        }
        self.placement_groups[pg_id] = pg
        result = await self._try_reserve_pg(pg)
        if not result.get("ok"):
            self.pending_pgs.add(pg_id)
        return result

    async def _try_reserve_pg(self, pg: dict):
        pg_id = pg["pg_id"]
        bundles: List[Dict[str, float]] = pg["bundles"]
        strategy = pg["strategy"]
        nodes = self._place_bundles(bundles, strategy, claimant=pg_id)
        if nodes is None:
            return {"ok": False, "error": "infeasible placement group"}
        # Phase 1: prepare.
        prepared = []
        ok = True
        for i, node_id in enumerate(nodes):
            node_conn = self.node_conns.get(node_id)
            if node_conn is None:
                ok = False
                break
            try:
                # The GCS view is the source of truth for reservation; the
                # raylet is informed so its local dispatcher accounts for the
                # bundle (prepare). Resource deltas roll back on failure.
                info = self.nodes[node_id]
                avail = info["resources_available"]
                b = bundles[i]
                if not all(avail.get(k, 0) + 1e-9 >= v for k, v in b.items()):
                    ok = False
                    break
                for k, v in b.items():
                    avail[k] = avail.get(k, 0) - v
                await node_conn.push(
                    "reserve_bundle",
                    {"pg_id": pg_id, "bundle_index": i, "resources": b},
                )
                prepared.append((i, node_id))
            except Exception:
                ok = False
                break
        if not ok:
            for i, node_id in prepared:
                node_conn = self.node_conns.get(node_id)
                if node_conn:
                    await node_conn.push(
                        "cancel_bundle", {"pg_id": pg_id, "bundle_index": i}
                    )
                info = self.nodes.get(node_id)
                if info:
                    for k, v in bundles[i].items():
                        info["resources_available"][k] = (
                            info["resources_available"].get(k, 0) + v
                        )
            pg["state"] = "PENDING"
            return {"ok": False, "error": "placement group reservation failed"}
        pg["bundle_nodes"] = nodes
        pg["state"] = "CREATED"
        journal.emit("gcs.pg", pg_id=pg_id.hex(), state="CREATED",
                     bundles=len(nodes))
        # A placed claimant no longer needs its reclamation fences.
        self._clear_fences(pg_id)
        await self.publish("pg_update:" + pg_id.hex(), {"state": "CREATED"})
        return {"ok": True, "bundle_nodes": nodes}

    def _place_bundles(self, bundles, strategy, claimant=None,
                       avail_override=None) -> Optional[List[bytes]]:
        """Bundle placement policies (bundle_scheduling_policy.cc:
        PACK/SPREAD/STRICT_PACK/STRICT_SPREAD).

        Nodes fenced for a preemption claimant only admit that claimant.
        avail_override substitutes the availability map — the reclamation
        pass uses it to ask "would this demand fit if those victims were
        gone?" without touching live state.
        """
        if avail_override is not None:
            alive = {nid: dict(av) for nid, av in avail_override.items()}
        else:
            alive = {}
            for nid, info in self.nodes.items():
                if info["state"] != "ALIVE" or info.get("draining"):
                    continue
                fence = info.get("fenced_for")
                if fence is not None and fence != claimant:
                    continue
                alive[nid] = dict(info["resources_available"])

        def fits(avail, b):
            return all(avail.get(k, 0) + 1e-9 >= v for k, v in b.items())

        def take(avail, b):
            for k, v in b.items():
                avail[k] = avail.get(k, 0) - v

        if strategy in ("STRICT_PACK",):
            for nid, avail in alive.items():
                trial = dict(avail)
                good = True
                for b in bundles:
                    if not fits(trial, b):
                        good = False
                        break
                    take(trial, b)
                if good:
                    return [nid] * len(bundles)
            return None
        if strategy in ("STRICT_SPREAD",):
            result, used = [], set()
            for b in bundles:
                placed = False
                for nid, avail in alive.items():
                    if nid in used or not fits(avail, b):
                        continue
                    take(avail, b)
                    result.append(nid)
                    used.add(nid)
                    placed = True
                    break
                if not placed:
                    return None
            return result
        # PACK (soft): prefer fewest nodes; SPREAD (soft): prefer distinct.
        result = []
        order = list(alive.items())
        if strategy == "SPREAD":
            idx = 0
            for b in bundles:
                placed = False
                for j in range(len(order)):
                    nid, avail = order[(idx + j) % len(order)] if order else (None, None)
                    if nid is not None and fits(avail, b):
                        take(avail, b)
                        result.append(nid)
                        idx = (idx + j + 1) % len(order)
                        placed = True
                        break
                if not placed:
                    return None
            return result
        # PACK
        for b in bundles:
            placed = False
            for nid, avail in order:
                if fits(avail, b):
                    take(avail, b)
                    result.append(nid)
                    placed = True
                    break
            if not placed:
                return None
        return result

    async def h_remove_pg(self, d, conn):
        pg = self.placement_groups.get(d["pg_id"])
        if not pg:
            return {"ok": False}
        if pg["state"] == "CREATED":
            for i, node_id in enumerate(pg["bundle_nodes"]):
                info = self.nodes.get(node_id)
                if info and info["state"] == "ALIVE":
                    for k, v in pg["bundles"][i].items():
                        info["resources_available"][k] = (
                            info["resources_available"].get(k, 0) + v
                        )
                    node_conn = self.node_conns.get(node_id)
                    if node_conn:
                        await node_conn.push(
                            "cancel_bundle", {"pg_id": d["pg_id"], "bundle_index": i}
                        )
        pg["state"] = "REMOVED"
        journal.emit("gcs.pg", pg_id=d["pg_id"].hex(), state="REMOVED")
        # Preemption hooks: a removed group may be a draining victim
        # handing its chips back (finish the record, un-drain its nodes)
        # or a pending claimant giving up (cancel its eviction).
        rec = self.preemptions.get(d["pg_id"])
        if rec is not None and rec["state"] == "draining":
            self._finish_preemption(rec, outcome="graceful")
        self._cancel_preemptions_for_claimant(d["pg_id"])
        # Resize-obligation hooks: a removed claimant releases the chips
        # it partially reclaimed (the victim may now grow back); a
        # removed victim no longer has anything to grow back into.
        self._lift_resize_obligations(d["pg_id"])
        self.resize_obligations.pop(d["pg_id"], None)
        return {"ok": True}

    async def h_release_pg_bundles(self, d, conn):
        """Elastic shrink: a CREATED gang gives individual bundles back.

        The chips are credited to their nodes immediately. When the
        release satisfies a partial-reclamation drain (the record's
        bundle_indices are all released), the eviction record closes
        with outcome "resized" and a *resize obligation* is recorded so
        the victim can reclaim exactly these bundles after the claimant
        releases — the gang resized instead of dying.
        """
        pg = self.placement_groups.get(d["pg_id"])
        if not pg or pg["state"] != "CREATED":
            return {"ok": False, "error": "placement group not CREATED"}
        indices = sorted({int(i) for i in d.get("indices") or []})
        if not indices:
            return {"ok": False, "error": "no bundle indices"}
        released: List[int] = pg.setdefault("released_bundles", [])
        bad = [
            i for i in indices
            if i < 0 or i >= len(pg["bundles"]) or i in released
            or pg["bundle_nodes"][i] is None
        ]
        if bad:
            return {"ok": False, "error": f"invalid bundle index(es) {bad}"}
        homes: Dict[int, bytes] = pg.setdefault("released_nodes", {})
        for i in indices:
            nid = pg["bundle_nodes"][i]
            info = self.nodes.get(nid)
            if info and info["state"] == "ALIVE":
                for k, v in pg["bundles"][i].items():
                    info["resources_available"][k] = (
                        info["resources_available"].get(k, 0) + v
                    )
                node_conn = self.node_conns.get(nid)
                if node_conn:
                    await node_conn.push(
                        "cancel_bundle",
                        {"pg_id": d["pg_id"], "bundle_index": i},
                    )
            homes[i] = nid
            pg["bundle_nodes"][i] = None
            released.append(i)
        released.sort()
        rec = self.preemptions.get(d["pg_id"])
        if (
            rec is not None and rec["state"] == "draining"
            and rec.get("partial")
            and set(rec.get("bundle_indices") or []) <= set(released)
        ):
            self._finish_preemption(rec, outcome="resized")
            if rec.get("claimant") is not None:
                self.resize_obligations[d["pg_id"]] = {
                    "victim": d["pg_id"],
                    "claimant": rec["claimant"],
                    "claimant_tenant": rec.get("claimant_tenant") or "",
                    "bundle_indices": sorted(rec["bundle_indices"]),
                    "state": "armed",
                    "created": time.monotonic(),
                    "lifted_at": None,
                }
                journal.emit(
                    "gcs.resize", pg_id=d["pg_id"].hex(), state="armed",
                    bundles=len(rec["bundle_indices"]),
                )
            from ray_tpu_torch.util.event import record_event

            record_event(
                "gcs",
                f"tenant {rec['victim_tenant']!r} resized instead of "
                f"evicting: released bundle(s) {sorted(rec['bundle_indices'])} "
                f"to {rec.get('claimant_tenant') or 'claimant'!r}",
                pg_id=d["pg_id"].hex(),
            )
        return {"ok": True, "released": released}

    async def h_reserve_pg_bundles(self, d, conn):
        """Elastic grow-back: re-reserve previously released bundles.

        Refused while a resize obligation is still armed (the claimant
        holds the chips) or while the chips are fenced/occupied. Each
        bundle prefers its original node; STRICT_SPREAD groups keep
        node-distinctness."""
        pg = self.placement_groups.get(d["pg_id"])
        if not pg or pg["state"] != "CREATED":
            return {"ok": False, "error": "placement group not CREATED"}
        indices = sorted({int(i) for i in d.get("indices") or []})
        released = pg.get("released_bundles") or []
        bad = [i for i in indices if i not in released]
        if bad:
            return {"ok": False, "error": f"bundle(s) {bad} not released"}
        ob = self.resize_obligations.get(d["pg_id"])
        if (
            ob is not None and ob["state"] == "armed"
            and set(indices) & set(ob["bundle_indices"])
        ):
            return {
                "ok": False,
                "error": "resize obligation not lifted: claimant "
                         f"{ob['claimant_tenant'] or 'claimant'!r} still "
                         "holds the chips",
            }
        homes = pg.get("released_nodes") or {}
        distinct = pg["strategy"] == "STRICT_SPREAD"
        placed: List[tuple] = []

        async def rollback():
            for j, njd in placed:
                info = self.nodes.get(njd)
                if info:
                    for k, v in pg["bundles"][j].items():
                        info["resources_available"][k] = (
                            info["resources_available"].get(k, 0) + v
                        )
                node_conn = self.node_conns.get(njd)
                if node_conn:
                    await node_conn.push(
                        "cancel_bundle",
                        {"pg_id": d["pg_id"], "bundle_index": j},
                    )
                pg["bundle_nodes"][j] = None

        for i in indices:
            b = pg["bundles"][i]
            orig = homes.get(i)
            candidates = ([orig] if orig is not None else []) + [
                n for n in self.nodes if n != orig
            ]
            nid = None
            for cand in candidates:
                info = self.nodes.get(cand)
                if (not info or info["state"] != "ALIVE"
                        or info.get("draining")):
                    continue
                fence = info.get("fenced_for")
                if fence is not None and fence != d["pg_id"]:
                    continue
                if distinct and cand in pg["bundle_nodes"]:
                    continue
                avail = info["resources_available"]
                if all(avail.get(k, 0) + 1e-9 >= v for k, v in b.items()):
                    nid = cand
                    break
            if nid is None:
                await rollback()
                return {"ok": False,
                        "error": f"bundle {i} cannot place anywhere"}
            info = self.nodes[nid]
            for k, v in b.items():
                info["resources_available"][k] = (
                    info["resources_available"].get(k, 0) - v
                )
            node_conn = self.node_conns.get(nid)
            if node_conn:
                await node_conn.push(
                    "reserve_bundle",
                    {"pg_id": d["pg_id"], "bundle_index": i, "resources": b},
                )
            pg["bundle_nodes"][i] = nid
            homes.pop(i, None)
            placed.append((i, nid))
        pg["released_bundles"] = [x for x in released if x not in set(indices)]
        if ob is not None:
            remaining = sorted(set(ob["bundle_indices"]) - set(indices))
            if remaining:
                ob["bundle_indices"] = remaining
            else:
                self.resize_obligations.pop(d["pg_id"], None)
        return {"ok": True,
                "bundle_nodes": [pg["bundle_nodes"][i] for i in indices]}

    async def h_get_resize_state(self, d, conn):
        """Resize obligations + released bundles for one group — the
        trainer's grow-back path polls this for the fence-lift signal."""
        pg = self.placement_groups.get(d["pg_id"])
        ob = self.resize_obligations.get(d["pg_id"])
        out = []
        if ob is not None:
            now = time.monotonic()
            out.append({
                "claimant": ob["claimant"],
                "claimant_tenant": ob["claimant_tenant"],
                "bundle_indices": list(ob["bundle_indices"]),
                "state": ob["state"],
                "age_s": now - ob["created"],
            })
        return {
            "obligations": out,
            "released_bundles": sorted(pg.get("released_bundles") or [])
            if pg else [],
        }

    def _lift_resize_obligations(self, claimant_id: bytes):
        """The claimant released its chips (group removed or actor dead):
        flip its obligations to "lifted" — the victims' grow-back signal."""
        for ob in self.resize_obligations.values():
            if ob["state"] == "armed" and ob.get("claimant") == claimant_id:
                ob["state"] = "lifted"
                ob["lifted_at"] = time.monotonic()
                journal.emit("gcs.resize", pg_id=ob["victim"].hex()
                             if isinstance(ob.get("victim"), bytes) else "",
                             state="lifted")
                from ray_tpu_torch.util.event import record_event

                record_event(
                    "gcs",
                    f"resize obligation lifted: claimant "
                    f"{ob['claimant_tenant'] or 'claimant'!r} released "
                    f"bundle(s) {ob['bundle_indices']} back to tenant",
                    pg_id=ob["victim"].hex(),
                )

    async def h_get_pg(self, d, conn):
        pg = self.placement_groups.get(d["pg_id"])
        return {"pg": pg and {k: v for k, v in pg.items()}}

    async def h_list_pgs(self, d, conn):
        return {"pgs": list(self.placement_groups.values())}

    # -- preemption ------------------------------------------------------
    # The reclamation pass: when higher-priority demand (a pending
    # placement group or actor) cannot place, pick victim gangs from the
    # lowest-priority tier, mark their nodes draining (the PR 2 train
    # migration path and the serve controller's eviction both key off
    # that flag), fence the nodes for the claimant, and back the graceful
    # window with a hard-kill deadline (RT_PREEMPT_GRACE_S).

    def _pg_tenant(self, pg: dict) -> str:
        return pg.get("name") or ("pg:" + pg["pg_id"].hex()[:8])

    def _clear_fences(self, owner_id: bytes):
        for info in self.nodes.values():
            if info.get("fenced_for") == owner_id:
                info.pop("fenced_for", None)

    def _count_preempt(self, tenant: str, reason: str):
        key = (("reason", reason), ("tenant", tenant))
        self.preempt_counts[key] = self.preempt_counts.get(key, 0.0) + 1.0

    def _maybe_preempt(self, owner_id: bytes, tenant: str, priority: int,
                       bundles: List[Dict[str, float]], strategy: str) -> bool:
        """One reclamation attempt for an infeasible pending demand.

        Called from the health loop after a failed placement retry.
        Greedy victim selection: walk CREATED groups from the lowest
        priority tier up (youngest first inside a tier), hypothetically
        credit each victim's bundles back, and stop at the first set
        whose release makes the claimant feasible.
        """
        cfg = get_config()
        if not cfg.preemption_enabled:
            return False
        # One in-flight reclamation per claimant: while victims drain,
        # don't widen the blast radius — the retry loop re-enters here
        # only if the claimant is still infeasible after they release.
        for rec in self.preemptions.values():
            if rec["state"] == "draining" and rec.get("claimant") == owner_id:
                return False
        # Hypothetical availability: nodes this claimant could use today.
        hyp = {}
        for nid, info in self.nodes.items():
            if info["state"] != "ALIVE" or info.get("draining"):
                continue
            fence = info.get("fenced_for")
            if fence is not None and fence != owner_id:
                continue
            hyp[nid] = dict(info["resources_available"])
        cands = []
        for pg in self.placement_groups.values():
            if pg["state"] != "CREATED":
                continue
            if int(pg.get("priority") or 0) >= priority:
                continue
            vrec = self.preemptions.get(pg["pg_id"])
            if vrec is not None and vrec["state"] == "draining":
                continue
            # The head node cannot drain; a gang with a bundle there is
            # not evictable through the node-drain machinery.
            if any(
                (self.nodes.get(n) or {}).get("is_head")
                for n in pg["bundle_nodes"]
            ):
                continue
            cands.append(pg)
        cands.sort(
            key=lambda p: (int(p.get("priority") or 0), -p.get("seq", 0))
        )
        # Partial reclamation: credit victim bundles ONE at a time,
        # highest index first (trailing ranks hold the trailing data
        # shards — the cheapest for an elastic victim to shed), and stop
        # at the first bundle whose release makes the claimant feasible.
        # A victim losing k < gang_size bundles gets a partial record:
        # only those bundles' nodes drain, and releasing them counts as
        # honoring the eviction (the gang resizes instead of dying).
        partial_ok = cfg.preempt_partial_enabled
        chosen: List[tuple] = []  # (pg, [credited bundle indices])
        feasible = False
        for pg in cands:
            indices: List[int] = []
            for i in range(len(pg["bundle_nodes"]) - 1, -1, -1):
                nid = pg["bundle_nodes"][i]
                if nid not in hyp:
                    continue
                for k, v in pg["bundles"][i].items():
                    hyp[nid][k] = hyp[nid].get(k, 0) + v
                indices.append(i)
                if partial_ok and self._place_bundles(
                        bundles, strategy, avail_override=hyp) is not None:
                    feasible = True
                    break
            if not indices:
                continue
            chosen.append((pg, sorted(indices)))
            if not feasible and self._place_bundles(
                    bundles, strategy, avail_override=hyp) is not None:
                feasible = True
            if feasible:
                break
        if not feasible:
            return False  # no victim set makes the claimant feasible
        for pg, indices in chosen:
            partial = partial_ok and len(indices) < len(pg["bundles"])
            self._register_preemption(
                pg, reason="priority", claimant=owner_id,
                claimant_tenant=tenant, claimant_priority=priority,
                fence_for=owner_id,
                bundle_indices=indices if partial else None,
            )
        return True

    def _register_preemption(self, pg: dict, reason: str,
                             claimant: Optional[bytes] = None,
                             claimant_tenant: str = "",
                             claimant_priority: int = 0,
                             fence_for: Optional[bytes] = None,
                             only_node: Optional[bytes] = None,
                             bundle_indices: Optional[List[int]] = None):
        """Mark one victim gang draining and open its eviction record.

        bundle_indices (partial reclamation): only those bundles' nodes
        drain, and the victim honors the eviction by releasing exactly
        those bundles (release_pg_bundles) instead of its whole group —
        an elastic gang resizes; the hard-kill deadline still covers the
        whole gang if it does neither in time.
        """
        cfg = get_config()
        now = time.monotonic()
        wanted = (
            {pg["bundle_nodes"][i] for i in bundle_indices}
            if bundle_indices is not None else None
        )
        # Refcount semantics: the record lists every node it needs drained
        # (idempotently re-marking already-draining ones); a node is
        # un-drained only when no draining record still lists it.
        nodes_marked = []
        for nid in dict.fromkeys(pg["bundle_nodes"]):
            if only_node is not None and nid != only_node:
                continue
            if wanted is not None and nid not in wanted:
                continue
            info = self.nodes.get(nid)
            if not info or info["state"] != "ALIVE" or info.get("is_head"):
                continue
            info["draining"] = True
            nodes_marked.append(nid)
            if fence_for is not None:
                info["fenced_for"] = fence_for
        tenant = self._pg_tenant(pg)
        self.preemptions[pg["pg_id"]] = {
            "victim": pg["pg_id"],
            "victim_tenant": tenant,
            "victim_priority": int(pg.get("priority") or 0),
            "claimant": claimant,
            "claimant_tenant": claimant_tenant,
            "claimant_priority": claimant_priority,
            "nodes": nodes_marked,
            "started": now,
            "deadline": now + cfg.preempt_grace_s,
            "state": "draining",
            "reason": reason,
            "released_at": None,
            "outcome": None,
        }
        if bundle_indices is not None:
            rec = self.preemptions[pg["pg_id"]]
            rec["partial"] = True
            rec["bundle_indices"] = sorted(bundle_indices)
        self._count_preempt(tenant, reason)
        from ray_tpu_torch.util.event import record_event

        record_event(
            "gcs",
            f"preempting placement group ({reason}): tenant {tenant!r} "
            f"(priority {int(pg.get('priority') or 0)}) drains for "
            f"{claimant_tenant or 'node reclaim'!r} "
            f"(priority {claimant_priority}); grace {cfg.preempt_grace_s}s",
            severity="WARNING", pg_id=pg["pg_id"].hex(),
        )
        journal.emit("gcs.preemption", pg_id=pg["pg_id"].hex(),
                     state="draining", reason=reason, tenant=tenant,
                     claimant_tenant=claimant_tenant)

    def _finish_preemption(self, rec: dict, outcome: str):
        """Victim released its chips (or was hard-killed): close the
        record, observe the grace histogram, un-drain the nodes this
        preemption marked (the fence persists until the claimant places)."""
        rec["state"] = "released"
        rec["outcome"] = outcome
        rec["released_at"] = time.monotonic()
        journal.emit("gcs.preemption", pg_id=rec["victim"].hex()
                     if isinstance(rec.get("victim"), bytes) else "",
                     state="released", outcome=outcome)
        took = rec["released_at"] - rec["started"]
        h = self.preempt_grace
        h["buckets"][bisect_left(_PREEMPT_GRACE_BOUNDS, took)] += 1
        h["sum"] += took
        h["count"] += 1
        if outcome == "hard_kill":
            self._count_preempt(rec["victim_tenant"], "hard_kill")
        for nid in rec["nodes"]:
            if any(
                r is not rec and r["state"] == "draining"
                and nid in r["nodes"]
                for r in self.preemptions.values()
            ):
                continue  # another eviction still needs this node drained
            info = self.nodes.get(nid)
            if info is not None:
                info.pop("draining", None)
        self._prune_preemptions()

    def _cancel_preemptions_for_claimant(self, owner_id: bytes):
        """The claimant withdrew (its group was removed while pending):
        stand the victims back up — un-drain, un-fence, drop records."""
        for rec in list(self.preemptions.values()):
            if rec["state"] != "draining" or rec.get("claimant") != owner_id:
                continue
            rec["state"] = "released"
            rec["outcome"] = "cancelled"
            rec["released_at"] = time.monotonic()
            for nid in rec["nodes"]:
                if any(
                    r is not rec and r["state"] == "draining"
                    and nid in r["nodes"]
                    for r in self.preemptions.values()
                ):
                    continue
                info = self.nodes.get(nid)
                if info is not None:
                    info.pop("draining", None)
        self._clear_fences(owner_id)
        self._prune_preemptions()

    def _prune_preemptions(self):
        limit = get_config().preempt_history_limit
        released = [
            (rec["released_at"] or 0.0, vid)
            for vid, rec in self.preemptions.items()
            if rec["state"] == "released"
        ]
        if len(self.preemptions) <= limit:
            return
        released.sort()
        for _, vid in released[: len(self.preemptions) - limit]:
            self.preemptions.pop(vid, None)

    async def _preemption_tick(self):
        """Health-loop step: enforce hard-kill deadlines and sweep fences
        whose claimant is no longer waiting."""
        now = time.monotonic()
        for rec in list(self.preemptions.values()):
            if rec["state"] != "draining" or now < rec["deadline"]:
                continue
            victim_id = rec["victim"]
            from ray_tpu_torch.util.event import record_event

            record_event(
                "gcs",
                f"preemption grace expired: hard-killing tenant "
                f"{rec['victim_tenant']!r}",
                severity="ERROR", pg_id=victim_id.hex(),
            )
            # The deadline is the guarantee: kill every actor living in
            # the victim group, then force-release its bundles.
            rec["state"] = "hard_killing"
            journal.emit("gcs.preemption", pg_id=victim_id.hex(),
                         state="hard_killing")
            for actor_id, a in list(self.actors.items()):
                sched = a.get("scheduling") or {}
                if (
                    sched.get("type") == "placement_group"
                    and sched.get("pg_id") == victim_id
                    and a["state"] in ("ALIVE", "PENDING", "RESTARTING")
                ):
                    a["max_restarts"] = 0
                    node = self.node_conns.get(a.get("node_id"))
                    if node is not None:
                        try:
                            await node.push(
                                "kill_actor_worker",
                                {"actor_id": actor_id, "will_restart": False},
                            )
                        except Exception:
                            pass
            pg = self.placement_groups.get(victim_id)
            if pg is not None and pg["state"] == "CREATED":
                # state "hard_killing" makes h_remove_pg's graceful-release
                # hook skip this record; we close it ourselves below.
                await self.h_remove_pg({"pg_id": victim_id}, None)
                self._mark_dirty()
            self._finish_preemption(rec, outcome="hard_kill")
        # Fence sweep: a fence whose owner is neither pending nor waiting
        # on a drain is stale (owner died, was cancelled, or placed
        # through a path that missed the inline clear).
        owners = {
            info.get("fenced_for")
            for info in self.nodes.values()
            if info.get("fenced_for") is not None
        }
        for owner in owners:
            waiting = (
                owner in self.pending_pgs
                or owner in self.pending_actors
                # Chaos sentinel claimants hold their fences until
                # chaos.lift_fence releases them.
                or owner in self.chaos_claims
                or any(
                    r["state"] == "draining" and r.get("claimant") == owner
                    for r in self.preemptions.values()
                )
            )
            if not waiting:
                self._clear_fences(owner)
        # Obligation sweep: an armed resize obligation whose claimant is
        # gone (actor died, group removed through a path that missed the
        # inline lift) flips to lifted so the victim can grow back.
        for ob in list(self.resize_obligations.values()):
            if (ob["state"] == "armed"
                    and not self._claimant_active(ob["claimant"])):
                self._lift_resize_obligations(ob["claimant"])

    def _claimant_active(self, owner: Optional[bytes]) -> bool:
        """Does this claimant still hold (or await) the chips it
        reclaimed? Chaos sentinels count as active until lifted."""
        if owner is None:
            return False
        if owner in self.chaos_claims:
            return True
        pg = self.placement_groups.get(owner)
        if pg is not None and pg["state"] in ("PENDING", "CREATED"):
            return True
        a = self.actors.get(owner)
        if a is not None and a["state"] in ("PENDING", "ALIVE",
                                            "RESTARTING"):
            return True
        return False

    def _preemption_view(self, rec: dict) -> dict:
        now = time.monotonic()
        out = {
            "victim_pg_id": rec["victim"],
            "victim_tenant": rec["victim_tenant"],
            "victim_priority": rec["victim_priority"],
            "claimant": rec.get("claimant"),
            "claimant_tenant": rec.get("claimant_tenant") or "",
            "claimant_priority": rec.get("claimant_priority") or 0,
            "nodes": list(rec["nodes"]),
            "state": rec["state"],
            "reason": rec["reason"],
            "outcome": rec.get("outcome"),
            "age_s": now - rec["started"],
            "grace_remaining_s": (
                max(0.0, rec["deadline"] - now)
                if rec["state"] == "draining" and rec["deadline"] != float("inf")
                else 0.0
            ),
        }
        if rec.get("partial"):
            out["partial"] = True
            out["bundle_indices"] = list(rec.get("bundle_indices") or [])
        if rec["state"] == "draining":
            # Victim actors still alive mid-drain — chaos's
            # kill_victim_mid_drain picks from these.
            out["victim_actors"] = [
                aid for aid, a in self.actors.items()
                if (a.get("scheduling") or {}).get("type")
                == "placement_group"
                and (a.get("scheduling") or {}).get("pg_id") == rec["victim"]
                and a["state"] == "ALIVE"
            ]
        return out

    async def h_get_preemptions(self, d, conn):
        """Preemption records, active first (rt top's `preemptions`
        section and chaos.kill_victim_mid_drain read this)."""
        recs = sorted(
            self.preemptions.values(),
            key=lambda r: (r["state"] != "draining", -r["started"]),
        )
        return {"preemptions": [self._preemption_view(r) for r in recs]}

    async def h_preempt_node(self, d, conn):
        """Node-scope preemption (chaos.preempt_node / spot-reclaim
        model): cordon the node and open an eviction record — with the
        full grace-then-hard-kill guarantee — for every CREATED gang
        holding a bundle there."""
        info = self.nodes.get(d["node_id"])
        if not info or info["state"] != "ALIVE":
            return {"ok": False, "error": "node not alive"}
        if info.get("is_head"):
            return {"ok": False, "error": "refusing to preempt the head node"}
        victims = []
        for pg in self.placement_groups.values():
            if pg["state"] != "CREATED":
                continue
            if d["node_id"] not in pg["bundle_nodes"]:
                continue
            vrec = self.preemptions.get(pg["pg_id"])
            if vrec is not None and vrec["state"] == "draining":
                continue
            self._register_preemption(
                pg, reason=d.get("reason", "chaos"),
                only_node=d["node_id"],
            )
            victims.append(pg["pg_id"])
        # Cordon even when no gang lives there: new work must not land on
        # a node that is being reclaimed.
        info["draining"] = True
        return {"ok": True, "victims": victims}

    async def h_chaos_reclaim_chips(self, d, conn):
        """Chaos: reclaim `amount` chips through the real partial-
        reclamation pass under a synthetic top-priority claimant.

        The sentinel claimant never places, so its fences (and any armed
        resize obligations it produces) persist until chaos_lift_fence —
        a deterministic serve-spike stand-in for elastic-resize tests.
        """
        amount = float(d["amount"])
        resource = d.get("resource") or "GPU"
        per = float(d.get("bundle_chips") or amount)
        count = max(1, int(amount // per) + (1 if amount % per else 0))
        sentinel = b"chaos_claim:" + os.urandom(8)
        ok = self._maybe_preempt(
            sentinel, "chaos_reclaim",
            int(d.get("priority") or 1_000_000),
            [{resource: per} for _ in range(count)], "SPREAD",
        )
        if not ok:
            return {"ok": False,
                    "error": "no victim set frees the requested chips"}
        self.chaos_claims.add(sentinel)
        victims = [
            {
                "victim_pg_id": rec["victim"],
                "partial": bool(rec.get("partial")),
                "bundle_indices": list(rec.get("bundle_indices") or []),
            }
            for rec in self.preemptions.values()
            if rec["state"] == "draining"
            and rec.get("claimant") == sentinel
        ]
        return {"ok": True, "claim_id": sentinel, "victims": victims}

    async def h_chaos_lift_fence(self, d, conn):
        """Chaos: release every chaos reclamation claim — cancel
        still-draining chaos records, lift armed obligations, clear
        fences. The grow-back signal for elastic victims."""
        lifted = 0
        for sentinel in list(self.chaos_claims):
            self.chaos_claims.discard(sentinel)
            self._cancel_preemptions_for_claimant(sentinel)
            for ob in self.resize_obligations.values():
                if (ob["state"] == "armed"
                        and ob.get("claimant") == sentinel):
                    lifted += 1
            self._lift_resize_obligations(sentinel)
            self._clear_fences(sentinel)
        return {"ok": True, "lifted": lifted}

    # -- pubsub ----------------------------------------------------------
    #: Channels clients may publish to. System channels (actor_update:*,
    #: node_dead, ...) are GCS-originated only — a spoofed actor_update
    #: would poison every subscriber's actor cache.
    _CLIENT_PUBLISH_PREFIXES = ("serve_routes:", "user:")

    async def h_publish(self, d, conn):
        """Client-originated publish: fan a payload out to every subscriber
        of a namespaced channel (Publisher analog, pubsub/publisher.h:307 —
        used by e.g. the Serve controller to invalidate handle routing
        tables)."""
        channel = d["channel"]
        if not channel.startswith(self._CLIENT_PUBLISH_PREFIXES):
            return {
                "ok": False,
                "error": f"clients may not publish to {channel!r}; allowed "
                         f"prefixes: {list(self._CLIENT_PUBLISH_PREFIXES)}",
            }
        await self.publish(channel, d.get("payload"))
        return {"ok": True}

    async def h_subscribe(self, d, conn):
        self.subscribers[d["channel"]].add(conn)
        # Late joiners get a still-fresh dump trigger replayed: a
        # replacement replica spawned BECAUSE of the failure connects
        # after the publish, but its ring (spawn, first requests) is
        # exactly the recovery half of the postmortem story.
        if d["channel"] == "journal_dump" and self._pm_last_payload:
            age = time.time() - self._pm_last_payload.get("ts", 0)
            if age <= get_config().journal_window_s:
                try:
                    await conn.push("journal_dump", self._pm_last_payload)
                except Exception:  # noqa: BLE001 — replay is best-effort
                    pass
        return {"ok": True}

    # -- cluster black box (failure-triggered postmortem capture) --------
    async def _journal_postmortem(self, reason: str, source: str = "",
                                  force: bool = False,
                                  detail: Optional[dict] = None) -> Optional[str]:
        """Mint a postmortem bundle and fan the dump trigger out to every
        connected process over the journal_dump channel. Cooldown-gated
        (unless forced, the `rt timeline --cluster` path) so a failure
        storm produces one bundle, not a dump storm. Returns the bundle
        directory, or None when suppressed."""
        cfg = get_config()
        if not cfg.journal_enabled:
            return None
        now = time.monotonic()
        if not force and now - self._pm_last_mono < cfg.journal_cooldown_s:
            return None
        self._pm_last_mono = now
        self._pm_seq += 1
        slug = "".join(
            c if c.isalnum() else "-" for c in reason
        ).strip("-")[:48] or "trigger"
        trigger_id = f"pm-{int(time.time())}-{self._pm_seq:03d}-{slug}"
        bundle = os.path.join(journal.dump_dir(), trigger_id)
        try:
            os.makedirs(bundle, exist_ok=True)
        except OSError:
            return None
        journal.emit("journal.trigger", reason=reason, source=source,
                     bundle=trigger_id, **(detail or {}))
        payload = {
            "bundle": bundle, "trigger_id": trigger_id, "reason": reason,
            "source": source, "ts": time.time(),
            "window_s": cfg.journal_window_s, "hlc": journal.wire_stamp(),
        }
        self.postmortems.append({
            "bundle": bundle, "trigger_id": trigger_id, "reason": reason,
            "source": source, "ts": payload["ts"],
            "detail": dict(detail or {}),
        })
        self._pm_last_payload = payload
        del self.postmortems[:-64]
        await self.publish("journal_dump", payload)
        # This process's own ring (the GCS sees every state transition —
        # its file anchors the merged timeline).
        journal.on_dump_trigger(payload)
        return bundle

    async def h_journal_trigger(self, d, conn):
        """Client-requested dump trigger: typed failure observers
        (breaker-open, replica-death replacement, collective timeout,
        HOL, deadline storms, gang restart) and `rt timeline --cluster`
        land here."""
        bundle = await self._journal_postmortem(
            d.get("reason") or "manual", source=d.get("source") or "",
            force=bool(d.get("force")), detail=d.get("detail") or {},
        )
        return {"ok": True, "triggered": bundle is not None,
                "bundle": bundle or ""}

    async def h_get_postmortems(self, d, conn):
        return {"postmortems": list(self.postmortems)}

    # -- task events ------------------------------------------------------
    async def h_add_task_events(self, d, conn):
        self.task_events.extend(d["events"])
        overflow = len(self.task_events) - _TASK_EVENTS_CAP
        if overflow > 0:
            del self.task_events[:overflow]
            self._task_events_dropped += overflow
        return {"ok": True}

    async def h_list_task_events(self, d, conn):
        """Page through the task-event ring.

        With "offset": events[offset : offset+limit] from the ring's
        current start — consumers loop until offset reaches "total"
        (pages may shift if the ring evicts mid-pagination; "dropped"
        counts lifetime evictions so they can warn on truncated
        history). Without "offset": legacy tail slice of the newest
        `limit` events.
        """
        limit = d.get("limit", 1000)
        total = len(self.task_events)
        if "offset" in d:
            off = max(0, int(d["offset"]))
            events = self.task_events[off:off + limit]
        else:
            events = self.task_events[-limit:]
        return {
            "events": events,
            "total": total,
            "dropped": self._task_events_dropped,
        }

    # -- metrics ----------------------------------------------------------
    async def h_metrics_report(self, d, conn):
        """Merge a client's metric deltas into the cluster aggregate.

        Counters accumulate deltas; gauges are last-writer-wins per tag
        set; histogram bucket counts/sums accumulate. Reports carrying a
        (reporter, seq) pair are deduplicated so an at-least-once retry
        (reply lost after the report applied) cannot double-count.
        """
        reporter, seq = d.get("reporter"), d.get("seq")
        if reporter is not None and seq is not None:
            last = self._metrics_seq.get(reporter)
            if last is not None and seq <= last:
                return {"ok": True, "duplicate": True}
            self._metrics_seq[reporter] = seq
        for rec in d["records"]:
            m = self.metrics.setdefault(
                rec["name"],
                {
                    "type": rec["type"],
                    "description": rec.get("description", ""),
                    "boundaries": rec.get("boundaries"),
                    "series": {},
                },
            )
            if m["type"] != rec["type"] or (
                rec["type"] == "histogram"
                and m["boundaries"] != rec.get("boundaries")
            ):
                # Conflicting re-registration under the same name: skip this
                # record rather than corrupting (or aborting) the batch.
                continue
            series = m["series"]
            for tags_list, payload in rec["data"]:
                key = tuple(tuple(t) for t in tags_list)
                if rec["type"] == "counter":
                    series[key] = series.get(key, 0.0) + payload
                elif rec["type"] == "gauge":
                    series[key] = payload
                else:  # histogram
                    st = series.setdefault(
                        key,
                        {"buckets": [0] * len(payload["buckets"]),
                         "sum": 0.0, "count": 0},
                    )
                    for i, c in enumerate(payload["buckets"]):
                        st["buckets"][i] += c
                    st["sum"] += payload["sum"]
                    st["count"] += payload["count"]
        return {"ok": True}

    async def h_metrics_snapshot(self, d, conn):
        out = []
        # GCS-internal RPC accounting joins the cluster metric surface as
        # synthetic series (the GCS has no client-side flusher of its
        # own): counts as a counter, handler latency as a histogram, both
        # tagged by method — so Grafana's gcs_rpc_* panels and `rt top`
        # see them like any reported metric.
        if self.rpc_counts:
            out.append({
                "name": "gcs_rpc_calls_total",
                "type": "counter",
                "description": "GCS RPCs served, by method",
                "boundaries": None,
                "series": [
                    [[["method", m]], float(c)]
                    for m, c in self.rpc_counts.items()
                ],
            })
        if self.rpc_latency:
            out.append({
                "name": "gcs_rpc_server_seconds",
                "type": "histogram",
                "description": "GCS handler latency, by method",
                "boundaries": list(_RPC_LATENCY_BOUNDS),
                "series": [
                    [[["method", m]],
                     {"buckets": list(st["buckets"]), "sum": st["sum_s"],
                      "count": st["count"]}]
                    for m, st in self.rpc_latency.items()
                ],
            })
        # Preemption accounting (the reclamation pass lives in the GCS, so
        # these join the surface as synthetic series too).
        if self.preempt_counts:
            out.append({
                "name": "preempt_total",
                "type": "counter",
                "description": "placement groups preempted, by victim "
                               "tenant and reason",
                "boundaries": None,
                "series": [
                    [[list(t) for t in key], v]
                    for key, v in self.preempt_counts.items()
                ],
            })
        if self.preempt_grace["count"]:
            out.append({
                "name": "preempt_grace_seconds",
                "type": "histogram",
                "description": "eviction notice to bundle release, per "
                               "preempted gang",
                "boundaries": list(_PREEMPT_GRACE_BOUNDS),
                "series": [
                    [[],
                     {"buckets": list(self.preempt_grace["buckets"]),
                      "sum": self.preempt_grace["sum"],
                      "count": self.preempt_grace["count"]}],
                ],
            })
        active = sum(
            1 for r in self.preemptions.values() if r["state"] == "draining"
        )
        out.append({
            "name": "preempt_active",
            "type": "gauge",
            "description": "victim gangs currently draining",
            "boundaries": None,
            "series": [[[], float(active)]],
        })
        # Per-tenant GPU occupancy: GPUs reserved by CREATED gangs
        # (named by their placement group) and by bare actors holding
        # chips outside any group.
        occ: Dict[str, float] = {}
        for pg in self.placement_groups.values():
            if pg["state"] != "CREATED":
                continue
            chips = sum(float(b.get("GPU", 0.0)) for b in pg["bundles"])
            if chips:
                t = self._pg_tenant(pg)
                occ[t] = occ.get(t, 0.0) + chips
        for a in self.actors.values():
            if a["state"] != "ALIVE":
                continue
            if (a.get("scheduling") or {}).get("type") == "placement_group":
                continue  # counted through its group
            chips = float((a.get("resources") or {}).get("GPU", 0.0))
            if chips:
                t = a.get("name") or a.get("class_name") or "actor"
                occ[t] = occ.get(t, 0.0) + chips
        if occ:
            out.append({
                "name": "tenant_chip_occupancy",
                "type": "gauge",
                "description": "GPUs held, by tenant",
                "boundaries": None,
                "series": [
                    [[["tenant", t]], v] for t, v in occ.items()
                ],
            })
        for name, m in self.metrics.items():
            out.append(
                {
                    "name": name,
                    "type": m["type"],
                    "description": m["description"],
                    "boundaries": m.get("boundaries"),
                    "series": [
                        [[list(t) for t in key], val]
                        for key, val in m["series"].items()
                    ],
                }
            )
        return {"metrics": out}

    async def h_ping(self, d, conn):
        return {"pong": True, "time": time.time()}


def main():  # pragma: no cover - exercised as a subprocess
    """Entry point when GCS runs as its own process (gcs_server_main.cc:40)."""
    import argparse
    import sys

    p = argparse.ArgumentParser()
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    args = p.parse_args()

    async def run():
        server = GcsServer(args.host, args.port)
        port = await server.start()
        print(f"GCS_PORT={port}", flush=True)
        await asyncio.Event().wait()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        sys.exit(0)


if __name__ == "__main__":
    main()
