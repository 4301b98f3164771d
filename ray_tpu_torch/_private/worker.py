"""Client runtime shared by drivers and workers.

Analog of the reference CoreWorker (src/ray/core_worker/core_worker.h:290)
plus the driver plumbing in python/ray/_private/worker.py: object refs,
task submission (SubmitTask core_worker.cc:1935), actor calls
(SubmitActorTask core_worker.cc:2241), get/put (core_worker.cc:1406/:1168),
and the in-process memory store for small/inline objects
(store_provider/memory_store/memory_store.h:43).

Threading model: all I/O runs on one asyncio loop (a background thread in
drivers, the main loop in workers); the public API is synchronous and posts
coroutines to that loop. User task code executes on executor threads and can
reenter the API (e.g. rt.get inside a task).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import itertools
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._vendor import cloudpickle

from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.function_manager import FunctionManager
from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, TaskID, object_id_for_task
from ray_tpu_torch._private.object_store import ObjectStore
from ray_tpu_torch._private.protocol import (
    Connection,
    ConnectionLost,
    RpcError,
    connect,
    spawn,
)
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    ActorUnavailableError,
    GetTimeoutError,
    ObjectLostError,
    TaskError,
    WorkerCrashedError,
)

from ray_tpu_torch.util import journal, lifecycle

# Thread-local flag: serializing task args => promote refs to the shared store.
_ser_ctx = threading.local()
_EMPTY_ARGS_PAYLOAD: Optional[bytes] = None

# Lazily-created client-side GCS RPC metrics (module-level so every
# CoreClient in the process shares one series set).
_gcs_rpc_metric_pair = None


def _gcs_rpc_metrics():
    global _gcs_rpc_metric_pair
    if _gcs_rpc_metric_pair is None:
        from ray_tpu_torch.util import metrics as _metrics

        _gcs_rpc_metric_pair = (
            _metrics.get_or_create(
                _metrics.Counter, "gcs_rpc_client_calls_total",
                "Client-issued GCS RPCs, by method", tag_keys=("method",),
            ),
            _metrics.get_or_create(
                _metrics.Histogram, "gcs_rpc_client_seconds",
                "Client-observed GCS RPC round-trip latency, by method",
                boundaries=_metrics.LATENCY_BOUNDARIES,
                tag_keys=("method",),
            ),
        )
    return _gcs_rpc_metric_pair


class _InStoreSentinel:
    """Marks a completion future whose value lives in the shared store."""

    def __repr__(self):
        return "<in-store>"


_IN_STORE = _InStoreSentinel()
_MISSING = object()  # _read_store: the local store no longer holds it


class ObjectRef:
    """A reference to a (possibly pending) remote object.

    Reference analog: ObjectRef in python/ray/includes/object_ref.pxi; the
    completion future mirrors the owner's TaskManager bookkeeping.
    """

    __slots__ = ("id", "_future", "__weakref__")

    def __init__(self, id: ObjectID, future: Optional[concurrent.futures.Future] = None):
        self.id = id
        self._future = future

    def binary(self) -> bytes:
        return self.id.binary()

    def hex(self) -> str:
        return self.id.hex()

    def future(self) -> concurrent.futures.Future:
        """A concurrent future resolving to the object's value."""
        fut = concurrent.futures.Future()

        def fill():
            try:
                fut.set_result(get_client().get([self], timeout=None)[0])
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        threading.Thread(target=fill, daemon=True).start()
        return fut

    def __reduce__(self):
        if getattr(_ser_ctx, "promote", False):
            client = _global_client
            if client is not None:
                client.promote_ref(self)
                promoted = getattr(_ser_ctx, "promoted", None)
                if promoted is not None:
                    promoted.append(self.id.binary())
        return (_ref_from_binary, (self.id.binary(),))

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.id == self.id

    def __repr__(self):
        return f"ObjectRef({self.id.hex()})"


class ObjectRefGenerator:
    """Iterator over a dynamic-generator task's item refs
    (num_returns="dynamic"; reference: ObjectRefGenerator /
    streaming_generator). Items STREAM: ref i becomes available as soon
    as the running task yields item i and stores it — iteration does not
    wait for task completion. Item oids derive deterministically from
    (task_id, index), so retries regenerate the same refs."""

    def __init__(self, task_id: "TaskID", future, client):
        self._task_id = task_id
        self._future = future  # resolves to ("__gen__", n) / raises
        self._client = client
        self._i = 0
        self._n: Optional[int] = None

    def _read_n(self):
        val = self._future.result(0)
        if isinstance(val, tuple) and val and val[0] == "__gen__":
            self._n = val[1]
        else:  # non-generator value under dynamic: single item
            self._n = 1

    def _adopt(self, oid: bytes) -> ObjectRef:
        ref = ObjectRef(ObjectID(oid))
        c = self._client
        c._in_store.add(oid)
        c._owned_store_oids.add(oid)
        c.known_refs[oid] = ref
        c._track_owned_ref(ref)
        return ref

    def __iter__(self) -> "ObjectRefGenerator":
        return self

    def __next__(self) -> ObjectRef:
        c = self._client
        oid = object_id_for_task(self._task_id, self._i).binary()
        while True:
            if self._n is not None and self._i >= self._n:
                raise StopIteration
            # Item already visible? (local store, or known to the
            # directory after the producer's registration flush.)
            if c.store is not None and c.store.contains_raw(oid):
                break
            try:
                known = c._run(
                    c.gcs.call("object_location_get", {"object_id": oid}),
                    timeout=get_config().object_directory_rpc_timeout_s,
                )
                if known.get("nodes") or known.get("spilled"):
                    break
            except Exception:  # noqa: BLE001 — transient; retry below
                pass
            if self._future.done():
                if self._n is None:
                    self._read_n()  # raises the task's error if it failed
                    continue  # recheck i < n, then item visibility
                # Completed, i < n, but the item never appeared: the
                # store lost it; let get()'s recovery path deal with it.
                break
            time.sleep(0.01)
        self._i += 1
        return self._adopt(oid)

    def __repr__(self):
        return (f"ObjectRefGenerator(task={self._task_id.hex()[:12]}, "
                f"next={self._i})")


def _ref_from_binary(b: bytes) -> ObjectRef:
    client = _global_client
    if client is not None:
        existing = client.known_refs.get(b)
        if existing is not None:
            return existing
    return ObjectRef(ObjectID(b))


class ActorHandle:
    """Client-side handle to an actor (reference: python/ray/actor.py ActorHandle)."""

    def __init__(self, actor_id: ActorID, class_name: str, method_names: List[str],
                 max_task_retries: int = 0):
        self._actor_id = actor_id
        self._class_name = class_name
        self._method_names = list(method_names)
        self._max_task_retries = max_task_retries

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        # An empty method list means the handle was looked up before the
        # actor finished creation; defer validation to the receiving worker.
        if self._method_names and item not in self._method_names:
            raise AttributeError(
                f"actor {self._class_name} has no method {item!r}"
            )
        return ActorMethod(self, item)

    def _kill(self, no_restart: bool = True):
        get_client().kill_actor(self._actor_id, no_restart)

    def __reduce__(self):
        return (
            ActorHandle,
            (self._actor_id, self._class_name, self._method_names,
             self._max_task_retries),
        )

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:12]})"


class ActorMethod:
    def __init__(self, handle: ActorHandle, name: str, num_returns: int = 1,
                 max_task_retries: Optional[int] = None):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns
        self._max_task_retries = max_task_retries

    def options(self, num_returns: int = 1, max_task_retries: Optional[int] = None):
        return ActorMethod(self._handle, self._name, num_returns, max_task_retries)

    def remote(self, *args, **kwargs):
        retries = (
            self._max_task_retries
            if self._max_task_retries is not None
            else self._handle._max_task_retries
        )
        refs = get_client().submit_actor_call(
            self._handle._actor_id,
            self._name,
            args,
            kwargs,
            num_returns=self._num_returns,
            max_task_retries=retries,
        )
        return refs[0] if self._num_returns in (1, "dynamic") else refs

    def bind(self, *args, **kwargs):
        """Lazy DAG composition (reference: dag/class_node.py)."""
        from ray_tpu_torch.dag.dag_node import ClassMethodNode

        return ClassMethodNode(self, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor methods cannot be called directly; use "
            f".{self._name}.remote(...)"
        )


class _PinHolder:
    """Lives exactly as long as some zero-copy view of one stored object:
    every _StoreBuffer of the object refers to it, and its finalizer
    releases the object's pin."""

    __slots__ = ("__weakref__",)


class _StoreBuffer:
    """One out-of-band buffer of a stored object, exported through the
    buffer protocol (PEP 688): every array built over it keeps it, and so
    the object's _PinHolder, alive, whatever container holds the arrays."""

    __slots__ = ("_view", "_holder")

    def __init__(self, view: memoryview, holder: _PinHolder):
        self._view = view
        self._holder = holder

    def __buffer__(self, flags):
        return memoryview(self._view)


class _Pin:
    """Keeps a store object pinned while a deserialized value is alive."""

    __slots__ = ("store", "oid")

    def __init__(self, store: ObjectStore, oid: ObjectID):
        self.store = store
        self.oid = oid

    def release(self):
        if self.store is not None:
            try:
                # Safe until the mapping is actually gone; refcounts live in
                # shared memory, so skipping would leak them cluster-wide.
                if not self.store._unmapped:
                    self.store.release(self.oid)
            except Exception:
                pass
            self.store = None


class CoreClient:
    """Synchronous facade over the asyncio control plane."""

    def __init__(
        self,
        loop: asyncio.AbstractEventLoop,
        gcs_addr: Tuple[str, int],
        raylet_addr: Tuple[str, int],
        store_name: str,
        node_id: bytes,
        job_id: JobID,
        mode: str = "driver",
    ):
        import os as _os

        self.loop = loop
        self.gcs_addr = gcs_addr
        self.raylet_addr = raylet_addr
        self.node_id = node_id
        self.job_id = job_id
        self.mode = mode
        self.client_id = _os.urandom(16)
        # store_name=None => remote (rt://) driver: no node-local shared
        # memory; puts/gets proxy through the raylet over TCP (the
        # reference's Ray Client role, util/client/worker.py:81).
        self.store = ObjectStore(store_name) if store_name else None
        # LRU-bounded cache of inline results (the in-process memory store,
        # memory_store.h:43). Values remain recoverable from a live ref's
        # completion future after eviction, so the bound is safe.
        from collections import OrderedDict

        self.memory_store: "OrderedDict[bytes, Any]" = OrderedDict()
        self.memory_store_max_entries = get_config().memory_store_max_entries
        self.known_refs: "weakref.WeakValueDictionary[bytes, ObjectRef]" = (
            weakref.WeakValueDictionary()
        )
        self.fn_manager = FunctionManager(self)
        self.gcs: Optional[Connection] = None
        self.raylet: Optional[Connection] = None
        self._actor_cache: Dict[bytes, dict] = {}
        self._actor_conns: Dict[Tuple[str, int], Connection] = {}
        # Calls of batch frames in flight, by task id: the worker answers
        # each as it ends (an `actor_call_results` push) or in the reply.
        self._batch_calls: Dict[bytes, tuple] = {}
        self._actor_locks: Dict[bytes, asyncio.Lock] = {}
        self._actor_events: Dict[bytes, threading.Event] = {}
        self._value_finalizers: list = []  # value-lifetime pins (see _read_store)
        self._in_store: set = set()  # oids known to live in shared store
        self._push_handlers = {}
        self._connected = False
        self.default_runtime_env = None  # job-level env from init()
        self._runtime_env_cache: Dict[str, Optional[dict]] = {}
        # Direct task transport: leased workers per scheduling class
        # (direct_task_transport.cc OnWorkerIdle — keep a granted worker
        # hot and push queued tasks without re-contacting the raylet).
        self._leases: Dict[tuple, dict] = {}
        self._lease_reaper: Optional[asyncio.Task] = None
        # Submit batching: bursts of .remote() calls cross the
        # thread->loop boundary once, not once per task.
        self._submit_buf: list = []
        self._submit_scheduled = False
        self._submit_lock = threading.Lock()
        # Owner-side lineage: store-kind return oid -> creating task spec,
        # for reconstruction when every copy is lost (TaskManager lineage +
        # ObjectRecoveryManager, object_recovery_manager.h:41).
        from collections import OrderedDict as _OD

        self.lineage: "_OD[bytes, dict]" = _OD()
        self.lineage_max_entries = get_config().lineage_max_entries
        # Owner-side reference GC (ReferenceCounter analog,
        # reference_count.h:61, simplified): when the last local ObjectRef
        # to an object THIS process owns dies — and no in-flight task
        # borrows it as an argument — the owner frees the cluster copies.
        # Borrowers (processes that deserialized the ref) never free.
        self._owned_store_oids: set = set()
        # Owned oids serialized out through task results: a borrower holds
        # them now, so local ref death must not free the store copy.
        self._escaped_oids: set = set()
        self._task_borrows: Dict[bytes, int] = {}
        self._free_dropped: set = set()   # dropped refs awaiting borrow==0
        self._free_queue: List[bytes] = []
        self._free_lock = threading.Lock()
        self._free_flusher = None
        # Batched async primary-copy registration: put() returns after the
        # store write; object_created notifications coalesce into one
        # raylet RPC per loop tick (the reference's plasma-notification
        # socket is asynchronous the same way).
        self._obj_created_buf: list = []
        self._obj_created_lock = threading.Lock()
        self._obj_created_scheduled = False
        # Objects whose client-side pin is still held while their
        # registration is in flight, and those of them freed meanwhile:
        # the raylet's free cannot delete an object this client still
        # pins, so the client deletes it when it drops the pin.
        self._registering: set = set()
        self._freed_registering: set = set()
        # GCS-restart survival (client half): see _gcs_call.
        self._subscribed_channels: set = set()
        self._gcs_redial_lock = None
        # Client-side GCS RPC accounting (per-method count + wall sum):
        # cheap plain dicts read directly by benches/tests; the metric
        # registry mirrors them as gcs_rpc_client_* series.
        from collections import defaultdict as _dd

        self.gcs_rpc_counts: Dict[str, int] = _dd(int)
        self.gcs_rpc_time_s: Dict[str, float] = _dd(float)
        # Control-plane profiler (util/lifecycle): submit-side state for
        # sampled tasks — task_id -> {"t0", "t_buf", "phases", ...},
        # completed (popped + LIFECYCLE_SPAN emitted) in _complete_task;
        # return-oid -> task_id for driver-side get_wait stamps.
        self._lc_pending: Dict[bytes, dict] = {}
        self._lc_get_map: Dict[bytes, bytes] = {}
        # In-flight background pulls started by prefetch(): oid -> loop
        # task running _pull_object. get() joins an in-flight pull instead
        # of racing a second probe for the same object. Loop-side only.
        self._prefetch_pulls: Dict[bytes, asyncio.Task] = {}

    # -- bootstrap -------------------------------------------------------
    def connect(self):
        fut = asyncio.run_coroutine_threadsafe(self._connect(), self.loop)
        fut.result(timeout=get_config().rpc_connect_timeout_s * 3)
        self._connected = True

    async def _connect(self, raylet_conn: Optional[Connection] = None):
        # Name this process in journal dumps; weak so a more specific
        # label (replica/controller/proxy) set later is never clobbered,
        # and an in-process node's GCS never renames the driver.
        journal.set_process_label(self.mode or "proc", weak=True)
        self.gcs = await connect(*self.gcs_addr, push_handler=self._on_push)
        # Workers already hold a raylet connection (push channel); reuse it
        # rather than paying a second TCP connect on the boot path.
        if raylet_conn is not None:
            # Worker process: the conn belongs to worker_main, whose
            # push handler (run_task/create_actor) must stay installed;
            # it forwards lease_revoked here.
            self.raylet = raylet_conn
        else:
            # Driver: raylet-initiated notifications (drain-time lease
            # revocation) arrive as pushes on this connection.
            self.raylet = await connect(
                *self.raylet_addr, push_handler=self._on_raylet_push
            )
        # Control-plane profiler runtime toggle: adopt the cluster-wide
        # sampling rate (if one was set via `rt profile --on`) and follow
        # future changes over the profile_config broadcast channel —
        # drivers AND workers, so the sampled bit appears wherever tasks
        # are submitted from. Best-effort: profiling never gates connect.
        try:
            self._push_handlers.setdefault(
                "profile_config", []
            ).append(self._on_profile_config)
            self._subscribed_channels.add("profile_config")
            await self.gcs.call("subscribe", {"channel": "profile_config"})
            r = await self.gcs.call("get_profile_config", {})
            self._on_profile_config(r.get("profile_config") or {})
        except Exception:  # noqa: BLE001 — profiling is best-effort
            pass
        # Cluster black box: every connected process answers journal_dump
        # broadcasts by freezing its event ring into the named postmortem
        # bundle (util/journal.py). Best-effort, like profile_config.
        try:
            self._push_handlers.setdefault(
                "journal_dump", []
            ).append(journal.on_dump_trigger)
            self._subscribed_channels.add("journal_dump")
            await self.gcs.call("subscribe", {"channel": "journal_dump"})
        except Exception:  # noqa: BLE001 — the black box never gates connect
            pass

    @staticmethod
    def _on_profile_config(payload):
        rate = (payload or {}).get("task_trace_sample")
        if rate is not None:
            lifecycle.set_sample_rate(float(rate))

    async def _gcs_call(self, method, payload=None, timeout=None):
        """GCS call that survives a GCS restart: on a dead connection,
        redial once, replay channel subscriptions, and retry the call.

        Known limitation: if the GCS applied+persisted a non-idempotent
        write (register_actor, kv_put overwrite=False) and died before
        replying, the retry double-applies and may surface an
        'already exists' error for an operation that succeeded — the same
        at-least-once window every RPC-retry system has without
        idempotency tokens.
        """
        if method == "subscribe":
            self._subscribed_channels.add(payload["channel"])
        t0 = time.monotonic()
        try:
            try:
                return await self.gcs.call(method, payload, timeout=timeout)
            except ConnectionLost:
                await self._redial_gcs()
                return await self.gcs.call(method, payload, timeout=timeout)
        finally:
            # Per-method accounting, success or failure: "N GCS
            # round-trips per actor birth" must be a reported number.
            dur = time.monotonic() - t0
            self.gcs_rpc_counts[method] += 1
            self.gcs_rpc_time_s[method] += dur
            try:
                calls, lat = _gcs_rpc_metrics()
                tags = {"method": method}
                calls.inc(1.0, tags)
                lat.observe(dur, tags)
            except Exception:  # noqa: BLE001 — accounting must never break RPCs
                pass

    async def _redial_gcs(self):
        lock = self._gcs_redial_lock
        if lock is None:
            lock = self._gcs_redial_lock = asyncio.Lock()
        async with lock:
            if self.gcs is not None and not self.gcs._closed:
                return  # another caller already redialed
            deadline = time.monotonic() + 30.0
            while True:
                try:
                    gcs = await connect(
                        *self.gcs_addr, push_handler=self._on_push,
                        timeout=get_config().gcs_reconnect_dial_timeout_s
                    )
                    break
                except Exception:  # noqa: BLE001
                    if time.monotonic() > deadline:
                        raise ConnectionLost("GCS unreachable after restart")
                    await asyncio.sleep(get_config().gcs_reconnect_backoff_s)
            for ch in list(self._subscribed_channels):
                try:
                    await gcs.call("subscribe", {"channel": ch})
                except Exception:  # noqa: BLE001
                    pass
            self.gcs = gcs

    def _on_push(self, channel: str, payload):
        if channel.startswith("actor_update:"):
            aid = bytes.fromhex(channel.split(":", 1)[1])
            self._actor_cache[aid] = payload
            ev = self._actor_events.get(aid)
            if ev:
                ev.set()
        for handler in self._push_handlers.get(channel, ()):
            handler(payload)

    def subscribe_push(self, channel: str, handler):
        """Register a push handler + GCS subscription for a channel
        (client half of the pubsub long-poll replacement). Multiple
        handlers per channel fan out — a second subscriber must not evict
        the first."""
        self._push_handlers.setdefault(channel, []).append(handler)
        self._run(self._gcs_call("subscribe", {"channel": channel}))

    def publish(self, channel: str, payload=None):
        self._run(self._gcs_call("publish",
                                 {"channel": channel, "payload": payload}))

    def disconnect(self):
        # Quiesce the free flusher before teardown ("task destroyed but
        # pending" noise otherwise).
        self._connected = False
        flusher = self._free_flusher
        if flusher is not None and not flusher.done():
            try:
                self.loop.call_soon_threadsafe(flusher.cancel)
            except RuntimeError:
                pass
        # Unmap safety: a live finalizer means some zero-copy view of the
        # store is still alive.
        self._live_views_at_disconnect = any(
            f.alive for f in self._value_finalizers
        )

        async def _close():
            for t in list(self._prefetch_pulls.values()):
                t.cancel()
            self._prefetch_pulls.clear()
            if self._lease_reaper is not None:
                self._lease_reaper.cancel()
                self._lease_reaper = None
            try:
                await self._release_all_leases()
            except Exception:  # noqa: BLE001
                pass
            for c in list(self._actor_conns.values()):
                await c.close()
            if self.gcs:
                await self.gcs.close()
            if self.raylet:
                await self.raylet.close()

        try:
            asyncio.run_coroutine_threadsafe(_close(), self.loop).result(timeout=5)
        except Exception:
            pass
        # Leave the shared mapping in place if any fetched value might still
        # alias store memory — unmapping under a live numpy view is a
        # segfault. The mapping is reclaimed at process exit.
        if self.store is not None:
            self.store.close(unmap=not self._live_views_at_disconnect)
        self._connected = False

    def _run(self, coro, timeout=None):
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return fut.result(timeout)

    # -- reference GC -----------------------------------------------------
    def _track_owned_ref(self, ref: ObjectRef):
        """Fire the free protocol when this owned ref is garbage-collected."""
        weakref.finalize(ref, self._on_ref_dropped, ref.id.binary())

    def _on_ref_dropped(self, oid: bytes):
        # Runs from GC — any thread, possibly at interpreter shutdown.
        if not self._connected:
            return
        with self._free_lock:
            if self._task_borrows.get(oid, 0) > 0:
                self._free_dropped.add(oid)
                return
            self._free_queue.append(oid)
        try:
            self.loop.call_soon_threadsafe(self._ensure_free_flush)
        except RuntimeError:
            pass  # loop is shutting down; store is reclaimed with the node

    def _ensure_free_flush(self):
        if self._free_flusher is None or self._free_flusher.done():
            self._free_flusher = asyncio.ensure_future(self._flush_free())

    async def _flush_free(self):
        # Loop until the queue is drained: a ref dropped while the raylet
        # call below is in flight sees this task as not-done and schedules
        # nothing, so exiting with a non-empty queue would strand it.
        while True:
            await asyncio.sleep(get_config().free_flush_debounce_s)
            with self._free_lock:
                oids, self._free_queue = self._free_queue, []
            if not oids:
                return
            to_free = [
                o for o in oids
                if o in self._owned_store_oids and o not in self._escaped_oids
            ]
            for o in oids:
                self._owned_store_oids.discard(o)
                self.lineage.pop(o, None)
                self.memory_store.pop(o, None)
                self._in_store.discard(o)
            with self._obj_created_lock:
                self._freed_registering.update(
                    o for o in to_free if o in self._registering)
            if not self._connected:
                return
            if to_free:
                try:
                    await self.raylet.call(
                        "free_objects", {"object_ids": to_free},
                        timeout=get_config().free_objects_timeout_s
                    )
                except Exception:  # noqa: BLE001 — eviction backstops
                    pass

    def _borrow_deps(self, spec: dict, deps: List[bytes]):
        """Pin deps for the task's lifetime so an argument whose driver ref
        dies mid-flight is not freed under the running task."""
        if not deps:
            return
        spec["deps_borrowed"] = list(deps)
        with self._free_lock:
            for dep in deps:
                self._task_borrows[dep] = self._task_borrows.get(dep, 0) + 1

    async def _release_ctor_borrows_when_live(self, actor_id: ActorID,
                                              ctor_spec: dict,
                                              max_restarts: int = 0):
        """Release actor-constructor arg pins once no creation replay can
        read them again. Restartable actors keep their pins until DEAD:
        the GCS replays the stored create_spec on every restart, and a
        replayed __init__ must still be able to resolve nested refs the
        driver has long dropped. State arrives via the actor_update push
        channel (_on_push keeps _actor_cache fresh) — this loop only reads
        the cache, no per-tick GCS RPCs."""
        aid = actor_id.binary()
        try:
            await self._gcs_call(
                "subscribe", {"channel": "actor_update:" + actor_id.hex()}
            )
        except Exception:  # noqa: BLE001 — cache polls still progress below
            pass
        try:
            first_rpc_done = False
            while self._connected:
                info = self._actor_cache.get(aid)
                if info is None and not first_rpc_done:
                    first_rpc_done = True
                    try:
                        info = (await self._gcs_call(
                            "get_actor", {"actor_id": aid}
                        ))["actor"]
                        if info is not None:
                            self._actor_cache[aid] = info
                    except Exception:  # noqa: BLE001
                        info = None
                state = (info or {}).get("state")
                if state == "DEAD":
                    break
                if state == "ALIVE" and max_restarts == 0:
                    break  # no replay possible: creation consumed the args
                await asyncio.sleep(1.0)
        finally:
            self._release_borrows(ctor_spec)

    def _release_borrows(self, spec: dict):
        deps = spec.pop("deps_borrowed", None)
        if not deps:
            return
        enqueued = False
        with self._free_lock:
            for dep in deps:
                n = self._task_borrows.get(dep, 0) - 1
                if n > 0:
                    self._task_borrows[dep] = n
                    continue
                self._task_borrows.pop(dep, None)
                if dep in self._free_dropped:
                    self._free_dropped.discard(dep)
                    self._free_queue.append(dep)
                    enqueued = True
        if enqueued:
            try:
                self.loop.call_soon_threadsafe(self._ensure_free_flush)
            except RuntimeError:
                pass

    # -- kv --------------------------------------------------------------
    def kv_put(self, key: bytes, value: bytes, ns: str = "", overwrite=True) -> bool:
        r = self._run(
            self._gcs_call(
                "kv_put", {"ns": ns, "key": key, "value": value, "overwrite": overwrite}
            ),
            timeout=get_config().gcs_op_timeout_s,
        )
        return r["added"]

    def kv_get(self, key: bytes, ns: str = "") -> Optional[bytes]:
        return self._run(self._gcs_call("kv_get", {"ns": ns, "key": key}),
                         timeout=get_config().gcs_op_timeout_s)["value"]

    def kv_del(self, key: bytes, ns: str = "") -> bool:
        return self._run(self._gcs_call("kv_del", {"ns": ns, "key": key}),
                         timeout=get_config().gcs_op_timeout_s)["deleted"]

    def kv_keys(self, prefix: bytes = b"", ns: str = "") -> List[bytes]:
        return self._run(self._gcs_call("kv_keys", {"ns": ns, "prefix": prefix}),
                         timeout=get_config().gcs_op_timeout_s)["keys"]

    # -- serialization helpers -------------------------------------------
    def serialize_args(self, args, kwargs) -> Tuple[bytes, List[bytes], List[bytes]]:
        """Serialize (args, kwargs); top-level refs become _ArgRef markers,
        nested refs are promoted to the shared store.

        Returns (payload, deps, borrow_oids): `deps` is what the raylet
        prefetches (top-level store args only — it must stay empty for
        plain tasks so they keep the direct-transport fast path);
        `borrow_oids` additionally includes refs nested inside containers,
        which the caller pins for the call's lifetime
        (reference_count.h nested-ref tracking — without the pin, the
        driver dropping its handle mid-flight frees the object under the
        running task's rt.get).

        Mirrors the reference's plasma-promotion of serialized ObjectRefs
        and inline substitution of resolved top-level args
        (transport/dependency_resolver.cc).
        """
        if not args and not kwargs:
            # The common trivial-call shape: one cached payload, no
            # cloudpickle work on the per-submit path.
            global _EMPTY_ARGS_PAYLOAD
            if _EMPTY_ARGS_PAYLOAD is None:
                _EMPTY_ARGS_PAYLOAD = ser.serialize_to_bytes(([], {}))
            return _EMPTY_ARGS_PAYLOAD, [], []
        deps: List[bytes] = []
        processed_args = []
        for a in args:
            if isinstance(a, ObjectRef):
                a = self._arg_for_ref(a, deps)
            processed_args.append(a)
        processed_kwargs = {}
        for k, v in kwargs.items():
            if isinstance(v, ObjectRef):
                v = self._arg_for_ref(v, deps)
            processed_kwargs[k] = v
        _ser_ctx.promote = True
        _ser_ctx.promoted = []
        try:
            payload = ser.serialize_to_bytes((processed_args, processed_kwargs))
        finally:
            _ser_ctx.promote = False
            promoted, _ser_ctx.promoted = _ser_ctx.promoted, []
        borrow_oids = list(deps)
        for oid in promoted:
            if oid not in borrow_oids:
                borrow_oids.append(oid)
        return payload, deps, borrow_oids

    def _arg_for_ref(self, ref: ObjectRef, deps: List[bytes]):
        oid = ref.id.binary()
        if oid in self.memory_store and oid not in self._in_store:
            return _InlineArg(self.memory_store[oid])
        # Wait for pending local task results so the dep is materialized.
        if ref._future is not None:
            value = ref._future.result()
            if value is not _IN_STORE and oid not in self._in_store:
                return _InlineArg(value)
        deps.append(oid)
        return _StoreArg(oid)

    def serialize_result(self, value):
        """Serialize a task/actor return value. ObjectRefs inside escape to
        a borrower: promote them to the shared store and exempt them from
        this owner's local-ref-drop free — the recipient holds a handle the
        owner can no longer see (reference_count.h borrower rule; without
        this, the owner's GC frees the copy under the borrower).

        Escaped objects are never auto-freed by this owner (the full
        borrower-count protocol the reference runs is future work); they
        stay spillable, so sustained pressure degrades them to disk rather
        than occupying shm, and they are reclaimed with the job."""
        _ser_ctx.promote = True
        _ser_ctx.promoted = []
        try:
            so = ser.serialize(value)
        finally:
            _ser_ctx.promote = False
            promoted, _ser_ctx.promoted = _ser_ctx.promoted, []
        for oid in promoted:
            self._escaped_oids.add(oid)
        return so

    def deserialize_args(self, payload: bytes):
        args, kwargs = ser.deserialize_from_bytes(payload)
        args = tuple(self._resolve_arg(a) for a in args)
        kwargs = {k: self._resolve_arg(v) for k, v in kwargs.items()}
        return args, kwargs

    def _resolve_arg(self, a):
        if isinstance(a, _InlineArg):
            return a.value
        if isinstance(a, _StoreArg):
            # Store pull under the executing worker's deserialize window:
            # the lifecycle profiler splits this wait out as arg_fetch
            # (thread-local accumulator, armed only for sampled tasks).
            t0 = time.monotonic()
            try:
                return self.get(
                    [ObjectRef(ObjectID(a.oid))],
                    timeout=get_config().arg_fetch_timeout_s,
                )[0]
            finally:
                lifecycle.add_arg_fetch(time.monotonic() - t0)
        return a

    def promote_ref(self, ref: ObjectRef):
        """Ensure a ref's value is resolvable from the shared store."""
        oid = ref.id.binary()
        if oid in self._in_store or (
            self.store is not None and self.store.contains_raw(oid)
        ):
            return
        value = None
        have_value = False
        if oid in self.memory_store:
            value = self.memory_store[oid]
            have_value = True
        elif ref._future is not None:
            value = ref._future.result()
            have_value = value is not _IN_STORE
        if have_value:
            self._put_to_store(ObjectID(oid), value)
        # else: remote object; the directory resolves it

    def put_serialized_with_spill(self, oid: ObjectID, so) -> bool:
        """Write to the shared store, asking the raylet to spill under
        pressure; registers + pins the primary copy via the raylet
        (object_created), never silently evictable."""
        from ray_tpu_torch.exceptions import ObjectStoreFullError

        if self.store is None:  # remote driver: ship bytes to the raylet
            if not self._client_put_remote(oid, so):
                raise ObjectLostError(
                    f"remote put of {oid.hex()} was not stored"
                )
            return True

        wrote = False
        attempts = 8
        for attempt in range(attempts):
            try:
                wrote = self.store.put_serialized(oid, so)
                break
            except ObjectStoreFullError:
                if attempt == attempts - 1:
                    raise
                r = self._run(self.raylet.call(
                    "spill_objects", {"size": so.total_size}),
                    timeout=get_config().spill_rpc_timeout_s)
                if not r.get("spilled"):
                    # Nothing spillable right now — concurrent writers may
                    # finish (and become spillable) shortly.
                    time.sleep(get_config().spill_retry_backoff_s)
        if wrote:
            self._queue_object_created(oid.binary(), so.total_size)
        return wrote

    def _queue_object_created(self, oid: bytes, size: int):
        """Register + pin the sealed primary copy with the raylet — batched
        and asynchronous (any thread). The raylet pins and records the
        location in the GCS directory; readers that race the registration
        fall back to the directory's probe/wait path.

        Until the raylet's pin lands, the client holds its own store view:
        the store-side refcount keeps LRU eviction off the sole copy
        through the registration window (the old synchronous registration
        guaranteed this by blocking put())."""
        pinned = False
        if self.store is not None:
            try:
                pinned = self.store.get(ObjectID(oid)) is not None
            except Exception:  # noqa: BLE001 — registration still proceeds
                pinned = False
        with self._obj_created_lock:
            self._obj_created_buf.append(
                ({"object_id": oid, "size": size}, pinned)
            )
            if pinned:
                self._registering.add(oid)
            need = not self._obj_created_scheduled
            if need:
                self._obj_created_scheduled = True
        if need:
            try:
                self.loop.call_soon_threadsafe(self._flush_object_created)
            except RuntimeError:
                pass  # loop shutting down; node reclaims the store

    def _flush_object_created(self):
        with self._obj_created_lock:
            buf, self._obj_created_buf = self._obj_created_buf, []
            self._obj_created_scheduled = False
        if buf and self._connected:
            spawn(self._send_objects_created(buf))

    async def _send_objects_created(self, buf):
        try:
            await self.raylet.call(
                "objects_created", {"objects": [e for e, _ in buf]},
                timeout=60,
            )
        except Exception:  # noqa: BLE001 — directory probes re-resolve
            pass
        finally:
            # Drop the client-side pins now that the raylet holds its own
            # (store.get refcounts require an explicit paired release).
            if self.store is not None:
                for e, pinned in buf:
                    if not pinned:
                        continue
                    oid = ObjectID(e["object_id"])
                    with self._obj_created_lock:
                        self._registering.discard(oid.binary())
                        freed = oid.binary() in self._freed_registering
                        self._freed_registering.discard(oid.binary())
                    try:
                        self.store.release(oid)
                        if freed:
                            self.store.delete(oid)
                    except Exception:  # noqa: BLE001
                        pass

    def _put_to_store(self, oid: ObjectID, value) -> int:
        so = ser.serialize(value)
        self.put_serialized_with_spill(oid, so)
        self._in_store.add(oid.binary())
        return so.total_size

    # -- put / get / wait -------------------------------------------------
    def put(self, value) -> ObjectRef:
        oid = ObjectID.from_random()
        self._put_to_store(oid, value)
        ref = ObjectRef(oid)
        self.known_refs[oid.binary()] = ref
        self._owned_store_oids.add(oid.binary())
        self._track_owned_ref(ref)
        return ref

    def get(self, refs: List[ObjectRef], timeout: Optional[float]):
        lc_t0 = time.monotonic() if self._lc_get_map else None
        deadline = None if timeout is None else time.monotonic() + timeout
        out: List[Any] = [None] * len(refs)
        remote: List[Tuple[int, ObjectRef]] = []
        for i, ref in enumerate(refs):
            hit, value = self._resolve_local(ref, deadline)
            if hit:
                out[i] = value
            else:
                remote.append((i, ref))
        if remote:
            # One round of concurrent pulls: every remote ref probes in
            # parallel on the event loop under the shared deadline, instead
            # of N sequential blocking pulls. Per-ref lost-object detection
            # and lineage reconstruction live in _pull_object unchanged.
            results = self._run(
                self._pull_many([ref.id.binary() for _, ref in remote],
                                deadline)
            )
            for (i, ref), res in zip(remote, results):
                if isinstance(res, BaseException):
                    raise res  # first failing ref in list order
                out[i] = self._read_pulled(ref.id.binary(), deadline)
        if lc_t0 is not None:
            self._lc_note_get_wait(refs, time.monotonic() - lc_t0)
        return out

    def prefetch(self, refs: List[ObjectRef]) -> int:
        """Start background pulls for refs not yet local; never blocks.

        Each pull is a fire-and-forget event-loop task, deduplicated per
        object; a later get() joins the in-flight pull instead of racing a
        second probe. Failures are advisory — get() re-resolves the ref and
        surfaces errors with full reconstruction semantics. Returns the
        number of pulls started.
        """
        if not self._connected or self.store is None:
            return 0
        started: List[bytes] = []
        for ref in refs:
            oid = ref.id.binary()
            f = ref._future
            if f is not None:
                if not f.done():
                    continue  # still executing locally; nothing to pull yet
                try:
                    if f.result() is not _IN_STORE:
                        continue  # inline value — no store copy to pull
                except BaseException:
                    continue  # errored/cancelled; get() will surface it
            if oid in self.memory_store:
                continue
            if self.store.contains_raw(oid):
                continue
            started.append(oid)
        if started:
            self.loop.call_soon_threadsafe(self._start_prefetch_pulls, started)
        return len(started)

    def _start_prefetch_pulls(self, oids: List[bytes]) -> None:
        if not self._connected:
            return
        for oid in oids:
            existing = self._prefetch_pulls.get(oid)
            if existing is not None and not existing.done():
                continue
            self._prefetch_pulls[oid] = spawn(self._prefetch_pull(oid))

    async def _prefetch_pull(self, oid: bytes) -> None:
        # Bounded deadline: an advisory pull for a never-produced object
        # must not park a loop task forever (blocking-get semantics belong
        # to get(), which re-issues its own pull).
        deadline = time.monotonic() + get_config().prefetch_pull_timeout_s
        try:
            await self._pull_object(oid, deadline)
        except Exception:  # noqa: BLE001 — advisory; get() re-surfaces
            pass
        finally:
            self._prefetch_pulls.pop(oid, None)

    def _memory_store_put(self, oid: bytes, value):
        ms = self.memory_store
        ms[oid] = value
        ms.move_to_end(oid)
        while len(ms) > self.memory_store_max_entries:
            ms.popitem(last=False)

    def _resolve_local(self, ref: ObjectRef, deadline) -> Tuple[bool, Any]:
        """Resolve a ref from its completion future / memory store / local
        shm store without touching the network. Returns (hit, value)."""
        oid = ref.id.binary()
        if ref._future is not None:
            remaining = None if deadline is None else max(0, deadline - time.monotonic())
            try:
                completed = ref._future.result(remaining)
            except concurrent.futures.TimeoutError:
                raise GetTimeoutError(f"get() timed out waiting for {ref}")
            if completed is not _IN_STORE and oid not in self.memory_store:
                # Inline result evicted from the LRU cache; the completion
                # future still holds it.
                return True, completed
        if oid in self.memory_store:
            return True, self.memory_store[oid]
        if self.store is not None and self.store.contains_raw(oid):
            value = self._read_store(ObjectID(oid))
            if value is not _MISSING:  # else spilled since: pull it back
                return True, value
        return False, None

    async def _pull_many(self, oids: List[bytes], deadline):
        return await asyncio.gather(
            *(self._pull_or_join(oid, deadline) for oid in oids),
            return_exceptions=True,
        )

    async def _pull_or_join(self, oid: bytes, deadline) -> None:
        task = self._prefetch_pulls.get(oid)
        if task is not None and not task.done():
            remaining = (
                None if deadline is None
                else max(0.05, deadline - time.monotonic())
            )
            try:
                await asyncio.wait_for(asyncio.shield(task), remaining)
            except asyncio.TimeoutError:
                raise GetTimeoutError(
                    f"get() timed out waiting for "
                    f"ObjectRef({ObjectID(oid).hex()})"
                )
            except Exception:  # noqa: BLE001 — advisory; re-pull below
                pass
        if self.store is not None and self.store.contains_raw(oid):
            return
        await self._pull_object(oid, deadline)

    async def _pull_object(self, oid: bytes, deadline) -> None:
        """Pull one remote object into the local store (event-loop side).

        Ask our raylet to pull it locally. Probes are short so a vanished
        object is detected well before the caller's deadline; with lineage
        the creating task re-executes
        (ObjectRecoveryManager::RecoverObject), otherwise the object is
        declared lost after a grace probe.
        """
        recon_left = get_config().task_max_retries
        last_err: Optional[Exception] = None
        while True:
            remaining = (
                60.0 if deadline is None else max(0.1, deadline - time.monotonic())
            )
            probe = min(get_config().get_probe_interval_s, remaining * 0.4)
            try:
                await self.raylet.call(
                    "wait_object_local",
                    {"object_id": oid, "timeout": probe},
                    timeout=probe + 5,
                )
                return
            except Exception as e:  # noqa: BLE001
                last_err = e
                if deadline is not None and time.monotonic() >= deadline:
                    raise GetTimeoutError(
                        f"get() timed out waiting for "
                        f"ObjectRef({ObjectID(oid).hex()})"
                    )
                # A probe timeout can just mean a slow transfer. Consult the
                # object directory first: re-executing the (side-effectful)
                # creating task while a copy still exists would duplicate it.
                # "Known with zero copies" means every replica (memory +
                # spill) is gone — lost. Unknown means possibly not yet
                # produced: keep waiting (blocking get semantics).
                try:
                    loc = await self._gcs_call(
                        "object_location_get", {"object_id": oid},
                        timeout=10,
                    )
                except Exception:
                    continue
                lost = (
                    loc.get("known")
                    and not loc.get("nodes")
                    and not loc.get("spilled")
                )
                if not lost:
                    continue  # copy exists or not yet produced: keep pulling
                spec = self.lineage.get(oid)
                if spec is None:
                    break  # registered once, all copies lost, no lineage
                # Re-execute the creating task (bounded attempts).
                if recon_left <= 0:
                    break
                recon_left -= 1
                result = await asyncio.wait_for(
                    self.raylet.call("submit_task", dict(spec), timeout=None),
                    None if deadline is None else remaining,
                )
                if result.get("status") != "ok":
                    break
                continue
        raise ObjectLostError(
            f"object {ObjectID(oid).hex()} could not be retrieved: {last_err}"
        ) from None

    def _client_put_remote(self, oid: ObjectID, so) -> bool:
        """Ship a put to the raylet's store over TCP. Small objects go in
        one frame; large ones stream in transfer-sized chunks so neither
        side buffers (or stalls its event loop on) one giant message."""
        data = so.to_bytes()
        chunk = get_config().object_transfer_chunk_size
        if len(data) <= chunk:
            r = self._run(
                self.raylet.call(
                    "client_put", {"object_id": oid.binary(), "data": data},
                    timeout=get_config().remote_client_op_timeout_s,
                )
            )
            return bool(r.get("ok"))
        r = self._run(
            self.raylet.call(
                "client_create",
                {"object_id": oid.binary(), "size": len(data)},
                timeout=get_config().remote_client_op_timeout_s,
            )
        )
        if not r.get("ok"):
            raise ObjectLostError(f"remote put failed: {r.get('error')}")
        if r.get("exists"):
            return True
        view = memoryview(data)
        for off in range(0, len(data), chunk):
            r = self._run(
                self.raylet.call(
                    "client_put_chunk",
                    {"object_id": oid.binary(), "offset": off,
                     "data": bytes(view[off:off + chunk])},
                    timeout=get_config().remote_client_op_timeout_s,
                )
            )
            if not r.get("ok"):
                raise ObjectLostError(f"remote put failed: {r.get('error')}")
        r = self._run(
            self.raylet.call(
                "client_seal",
                {"object_id": oid.binary(), "size": len(data)},
                timeout=get_config().remote_client_op_timeout_s,
            )
        )
        return bool(r.get("ok"))

    def _read_remote(self, oid: ObjectID):
        """Remote (rt://) driver: stream the object out of the raylet's
        store over TCP in transfer-sized chunks.

        The chunk stream holds no pin on the raylet side, so a concurrent
        spill can evict the object mid-stream; each retry re-runs
        client_get_info, whose _ensure_local restores spilled copies."""
        from ray_tpu_torch._private.protocol import RpcError

        last_err = None
        for _attempt in range(3):
            try:
                info = self._run(
                    self.raylet.call(
                        "client_get_info", {"object_id": oid.binary()},
                        timeout=get_config().remote_client_op_timeout_s,
                    )
                )
                if not info.get("ok"):
                    raise ObjectLostError(
                        f"object {oid.hex()}: {info.get('error')}"
                    )
                size = info["size"]
                chunk = get_config().object_transfer_chunk_size
                parts = []
                off = 0
                while off < size:
                    n = min(chunk, size - off)
                    r = self._run(
                        self.raylet.call(
                            "fetch_chunk",
                            {"object_id": oid.binary(), "offset": off,
                             "size": n},
                            timeout=get_config().remote_client_op_timeout_s,
                        )
                    )
                    parts.append(r["data"])
                    off += n
                value = ser.deserialize(memoryview(b"".join(parts)))
                self._in_store.add(oid.binary())
                return value
            except RpcError as e:  # spilled/evicted mid-stream: retry
                last_err = e
        raise ObjectLostError(
            f"remote fetch of {oid.hex()} failed: {last_err}"
        ) from None

    def _read_pulled(self, oid: bytes, deadline):
        """Read an object just pulled into the local store. A spill pass
        may drop it before this reader pins it (a restored copy keeps its
        spill file, so the pass frees it without writing): pull again."""
        for _attempt in range(3):
            value = self._read_store(ObjectID(oid))
            if value is not _MISSING:
                return value
            self._run(self._pull_or_join(oid, deadline))
        raise ObjectLostError(
            f"object {ObjectID(oid).hex()} missing from local store"
        )

    def _read_store(self, oid: ObjectID):
        """The object's value, read zero-copy from the local store, or
        _MISSING when the store no longer holds it."""
        if self.store is None:
            return self._read_remote(oid)
        view = self.store.get(oid)
        if view is None:
            return _MISSING
        # The store-side refcount from get() is the pin protecting the
        # zero-copy buffers under `value`. It is released when the last of
        # them is gone, whatever holds them (a dict of arrays too), so
        # dropped results become spillable; a value with no out-of-band
        # buffer holds no store memory and releases it at once.
        holder = _PinHolder()
        fin = weakref.finalize(holder, _Pin(self.store, oid).release)
        value = ser.deserialize(view, lambda v: _StoreBuffer(v, holder))
        del holder
        if fin.alive:
            self._value_finalizers.append(fin)
            if len(self._value_finalizers) > 256:
                self._value_finalizers = [
                    f for f in self._value_finalizers if f.alive
                ]
        self._in_store.add(oid.binary())
        return value

    def wait(self, refs: List[ObjectRef], num_returns: int, timeout: Optional[float],
             fetch_local: bool = True):
        deadline = None if timeout is None else time.monotonic() + timeout
        ready: List[ObjectRef] = []
        pending = list(refs)
        while True:
            still = []
            for ref in pending:
                oid = ref.id.binary()
                done = (
                    (ref._future is not None and ref._future.done())
                    or oid in self.memory_store
                    or (self.store is not None
                        and self.store.contains_raw(oid))
                )
                if not done and ref._future is None:
                    # Check the cluster directory for remote completion; a
                    # spilled-only object is ready (restorable on get).
                    loc = self._run(
                        self._gcs_call("object_location_get", {"object_id": oid})
                    )
                    done = bool(loc["nodes"]) or bool(loc.get("spilled"))
                (ready if done else still).append(ref)
            pending = still
            if len(ready) >= num_returns or not pending:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            time.sleep(0.005)
        return ready[:num_returns], ready[num_returns:] + pending

    # -- task submission ---------------------------------------------------
    def _resolve_runtime_env(self, renv) -> Optional[dict]:
        """Resolve + cache a runtime env (upload working_dir/py_modules once
        per content); falls back to the job-level env from init()."""
        if renv is None:
            renv = self.default_runtime_env
        if not renv:
            return None
        if "hash" in renv:  # already resolved (job-inherited env)
            return dict(renv)
        import json as _json

        from ray_tpu_torch.runtime_env import prepare_runtime_env

        cache_key = _json.dumps(dict(renv), sort_keys=True, default=str)
        hit = self._runtime_env_cache.get(cache_key)
        if hit is None:
            hit = prepare_runtime_env(renv, self)
            self._runtime_env_cache[cache_key] = hit
        return hit

    def submit_task(
        self,
        fn,
        args,
        kwargs,
        name: str = "",
        num_returns: int = 1,
        resources: Optional[Dict[str, float]] = None,
        scheduling=None,
        max_retries: Optional[int] = None,
        runtime_env=None,
        max_calls: Optional[int] = None,
        priority: int = 0,
    ) -> List[ObjectRef]:
        cfg = get_config()
        # Control-plane profiler head sampling: one module-attr check per
        # task when off; a sampled task carries the bit in its spec and
        # every hop stamps phase marks (util/lifecycle).
        lc_sampled = lifecycle.enabled and lifecycle.sample()
        if lc_sampled:
            _lc_t0, _lc_ts0 = time.monotonic(), time.time()
        fn_key = self.fn_manager.export(fn)
        payload, deps, borrow_oids = self.serialize_args(args, kwargs)
        if lc_sampled:
            _lc_ser = time.monotonic() - _lc_t0
        task_id = TaskID.from_random()
        resolved_env = self._resolve_runtime_env(runtime_env)
        spec = {
            "task_id": task_id.binary(),
            "job_id": self.job_id.binary(),
            "name": name,
            "fn_key": fn_key,
            "args": payload,
            "deps": deps,
            "num_returns": num_returns,
            "resources": resources if resources is not None else {"CPU": 1.0},
            "scheduling": scheduling,
            "runtime_env": resolved_env,
            "runtime_env_hash": resolved_env["hash"] if resolved_env else None,
        }
        if priority:
            # Priority class: orders raylet dispatch and makes the demand
            # eligible to reclaim chips from lower-priority gangs.
            spec["priority"] = int(priority)
        if max_calls:
            # Worker retires after this many executions of the function
            # (reference: @ray.remote(max_calls=N), remote_function.py —
            # the leak mitigation for tasks wrapping leaky native code).
            spec["max_calls"] = int(max_calls)
        retries = cfg.task_max_retries if max_retries is None else max_retries
        # The raylet's OOM policy prefers killing retriable tasks
        # (worker_killing_policy.cc retriable-FIFO). max_retries=-1 means
        # infinite retries — very much retriable.
        spec["retriable"] = retries != 0
        from ray_tpu_torch.util import tracing

        trace_ctx = tracing.inject()
        if trace_ctx:
            spec["trace_ctx"] = trace_ctx
        if num_returns == "dynamic":
            # Streaming generator task: ONE future carries completion +
            # item count; item refs materialize through the
            # ObjectRefGenerator as the task yields.
            fut = concurrent.futures.Future()
            refs = [ObjectRefGenerator(task_id, fut, self)]
            futures = [fut]
        else:
            refs = []
            futures = []
            for i in range(num_returns):
                oid = object_id_for_task(task_id, i)
                fut = concurrent.futures.Future()
                ref = ObjectRef(oid, fut)
                self.known_refs[oid.binary()] = ref
                self._track_owned_ref(ref)
                refs.append(ref)
                futures.append(fut)
        self._borrow_deps(spec, borrow_oids)
        if lc_sampled:
            spec["sampled"] = True
            self._lc_track(task_id.binary(), name, _lc_t0, _lc_ts0,
                           _lc_ser, refs)
        with self._submit_lock:
            self._submit_buf.append((spec, futures, retries))
            need_schedule = not self._submit_scheduled
            if need_schedule:
                self._submit_scheduled = True
        if need_schedule:
            self.loop.call_soon_threadsafe(self._drain_submits)
        return refs

    # -- control-plane profiler (submit side) ---------------------------
    def _lc_track(self, task_id, name, t0, ts0, serialize_s, refs):
        """Register a sampled submission: phase accumulator keyed by task
        id (finished in _complete_task) + return-oid map for get_wait."""
        self._lc_pending[task_id] = {
            "t0": t0,
            "t_buf": time.monotonic(),
            "name": name,
            "phases": {"serialize": [ts0, serialize_s]},
        }
        for ref in refs:
            if isinstance(ref, ObjectRef):
                self._lc_get_map[ref.id.binary()] = task_id
        # Bound both maps: tasks whose completion we miss (client-side
        # crash paths) and refs never passed to get() must not leak.
        for m in (self._lc_pending, self._lc_get_map):
            while len(m) > 16384:
                m.pop(next(iter(m)), None)

    def _lc_emit(self, ev):
        """Queue one LIFECYCLE_SPAN event on the shared profiling buffer
        (bounded-delay batched flush to the GCS)."""
        from ray_tpu_torch.util import profiling

        with profiling._lock:
            profiling._buffer.append(ev)
        profiling.request_flush()

    def _lc_close_submit_buffer(self, spec):
        """Close a sampled task's submit_buffer phase: .remote() → the
        task reaching its sender coroutine (burst-buffer wait + drain
        routing + the event-loop hop into the sender), so the client-side
        phases tile the submit window with no unattributed gap."""
        pend = self._lc_pending.get(spec["task_id"])
        if pend is not None and "t_buf" in pend:
            dur = max(0.0, time.monotonic() - pend.pop("t_buf"))
            pend["phases"]["submit_buffer"] = [time.time() - dur, dur]  # rtlint: disable=RT011 — deliberate wall anchor: [start_wall, dur] stitches this phase onto cross-process timelines

    def _lc_stamp_rpc_wait(self, task_id, t0_m):
        """Close a sampled task's rpc_wait mark: the submit RPC's full
        round-trip, stamped only on single-spec frames (a batch frame's
        wall spans its siblings' execution, so per-task attribution
        would lie). The stitcher subtracts the remote-attributed phases
        to derive the ``transport`` (wire + event-loop) residual."""
        pend = self._lc_pending.get(task_id)
        if pend is not None:
            dur = max(0.0, time.monotonic() - t0_m)
            pend["phases"]["rpc_wait"] = [time.time() - dur, dur]  # rtlint: disable=RT011 — deliberate wall anchor for cross-process phase stitching

    def _lc_complete(self, spec):
        """_complete_task: emit the client-hop LIFECYCLE_SPAN carrying
        the submit-side phases and the authoritative e2e wall."""
        pend = self._lc_pending.pop(spec["task_id"], None)
        if pend is None:
            return
        self._lc_emit(lifecycle.event(
            spec["task_id"], pend["name"], self.job_id.binary(),
            self.node_id, "client", pend["phases"],
            e2e_s=max(0.0, time.monotonic() - pend["t0"]),
        ))

    def _lc_note_get_wait(self, refs, dur_s):
        """get(): attribute one blocking-get wall to each sampled task
        whose return ref was fetched (overlaps remote phases; kept out
        of the phase sum — see lifecycle.SUM_PHASES)."""
        now = time.time()
        for ref in refs:
            tid = self._lc_get_map.pop(ref.id.binary(), None)
            if tid is None:
                continue
            self._lc_emit(lifecycle.event(
                tid, "", self.job_id.binary(), self.node_id, "client",
                {"get_wait": [now - dur_s, dur_s]},
            ))

    def _drain_submits(self):
        """Runs on the loop: route a burst of queued submissions.

        Direct-eligible tasks sharing a lease key and pipelined calls to
        the same actor are grouped into batch frames — one RPC (and one
        worker-side executor hop) covers the whole run instead of one per
        task, which is where the per-op interpreter cost lives on the
        10k-tasks/s path."""
        with self._submit_lock:
            buf, self._submit_buf = self._submit_buf, []
            self._submit_scheduled = False
        direct_groups: Dict[tuple, list] = {}
        actor_groups: Dict[bytes, list] = {}
        for item in buf:
            if item[0] == "actor":
                _, actor_id, request, spec, futures, retries = item
                actor_groups.setdefault(actor_id.binary(), []).append(
                    (actor_id, request, spec, futures, retries)
                )
            elif self._direct_eligible(item[0]):
                key = self._lease_key(item[0])
                direct_groups.setdefault(key, []).append(item)
            else:
                spawn(self._submit_with_retries(*item))
        for group in direct_groups.values():
            spawn(self._submit_direct_group(group))
        for calls in actor_groups.values():
            if len(calls) == 1:
                spawn(self._actor_call_with_retries(*calls[0]))
            else:
                spawn(self._actor_call_group(calls))

    @staticmethod
    def _direct_eligible(spec) -> bool:
        """Direct transport handles the plain case: no object deps (the
        raylet owns dependency fetching), default scheduling, single
        return. Everything else takes the classic submit path."""
        return (
            not spec.get("deps")
            and spec.get("scheduling") is None
            and spec.get("num_returns", 1) in (1, "dynamic")
        )

    async def _submit_direct(self, spec, futures, retries):
        return await self._submit_direct_group([(spec, futures, retries)])

    async def _submit_direct_group(self, items):
        """Submit a burst of same-lease-key tasks as batch frames.

        Chunks spread across the lease pool (least-outstanding first, the
        pool growing while chunks stack up) so a big burst still fans out
        over every leased worker; each chunk costs one RPC and one
        worker-side executor hop regardless of size."""
        # Only plain CPU shapes may share a lease (pipelining depth — see
        # _lease_for): a batch of resource-bearing tasks on one worker
        # would serialize a gang the raylet should spread across hosts.
        cpu_only = all(
            k == "CPU" for k in (items[0][0].get("resources") or {})
        )
        batch_max = get_config().direct_submit_batch_max if cpu_only else 1
        i = 0
        while i < len(items):
            chunk = items[i:i + batch_max]
            i += batch_max
            entry = None
            lc_t = time.monotonic() if self._lc_pending else None
            if lc_t is not None:
                for _spec, _f, _r in chunk:
                    self._lc_close_submit_buffer(_spec)
            try:
                entry = await self._lease_for(chunk[0][0])
            except Exception:  # noqa: BLE001 — lease loss must never lose a task
                entry = None
            if lc_t is not None:
                # Lease acquisition (usually a pool hit, ~0; a raylet
                # round-trip when the pool grows) charged to every
                # sampled task in the chunk that shared it.
                dur = time.monotonic() - lc_t
                wall = time.time() - dur  # rtlint: disable=RT011 — deliberate wall anchor for cross-process phase stitching
                for _spec, _f, _r in chunk:
                    pend = self._lc_pending.get(_spec["task_id"])
                    if pend is not None:
                        pend["phases"]["lease"] = [wall, dur]
            if entry is None:
                for spec, futures, retries in chunk:
                    spawn(self._submit_with_retries(spec, futures, retries))
                continue
            # Count the chunk against the worker NOW (not inside the spawned
            # sender): _lease_for often returns without yielding, so the next
            # loop iteration must already see this load or every chunk in the
            # burst lands on the same worker.
            entry["outstanding"] += len(chunk)
            entry["last_used"] = time.monotonic()
            # rpc_wait anchors here (not inside the spawned sender) so the
            # event-loop hop into the sender coroutine is attributed too.
            spawn(self._send_direct_batch(entry, chunk, time.monotonic()))

    async def _send_direct_batch(self, entry, chunk, rpc_t0=None):
        try:
            if len(chunk) == 1:
                spec0 = chunk[0][0]
                if entry.get("gpu_ids"):
                    spec0 = dict(spec0, gpu_ids=entry["gpu_ids"])
                rpc_t = (
                    (rpc_t0 or time.monotonic())
                    if spec0.get("sampled") and self._lc_pending else None
                )
                results = [await entry["conn"].call(
                    "run_task_direct", spec0, timeout=None)]
                if rpc_t is not None:
                    self._lc_stamp_rpc_wait(spec0["task_id"], rpc_t)
            else:
                resp = await entry["conn"].call(
                    "run_tasks_batch",
                    {"specs": [c[0] for c in chunk]},
                    timeout=None,
                )
                results = resp["results"]
        except (ConnectionLost, RpcError):
            # Leased worker died mid-batch. Any task may have executed
            # before the reply was lost, so max_retries=0 (at-most-once)
            # must NOT re-run it — same contract as the classic path.
            for spec, futures, retries in chunk:
                if retries == 0:
                    self._complete_task(
                        spec,
                        {"status": "worker_crashed",
                         "error": "leased worker connection lost"},
                        futures,
                    )
                else:
                    remaining = retries if retries < 0 else retries - 1
                    spawn(self._submit_with_retries(spec, futures, remaining))
            return
        finally:
            entry["outstanding"] -= len(chunk)
            entry["last_used"] = time.monotonic()
        for (spec, futures, retries), result in zip(chunk, results):
            if result.get("status") == "worker_crashed" and result.get(
                "not_executed"
            ):
                # The worker refused before running (retiring under
                # max_calls): safe to resubmit even at max_retries=0 —
                # nothing executed.
                spawn(self._submit_with_retries(spec, futures, retries))
                continue
            self._complete_task(spec, result, futures)

    @staticmethod
    def _lease_key(spec) -> tuple:
        return (
            spec.get("runtime_env_hash"),
            tuple(sorted((spec.get("resources") or {}).items())),
        )

    async def _lease_for(self, spec):
        key = self._lease_key(spec)
        pool = self._leases.setdefault(
            key, {"workers": [], "acquiring": False}
        )
        live = [w for w in pool["workers"] if not w["conn"]._closed]
        pool["workers"] = live
        best = min(live, key=lambda w: w["outstanding"], default=None)
        # Pipelining DEPTH (queueing a second task behind a running one on
        # the same leased worker) is only sound for plain CPU shapes. A
        # resource-bearing task (GPU gangs, custom resources) queued deep
        # on a held worker would serialize on one node while the raylet
        # could have spilled it to idle capacity elsewhere — the reference
        # keeps leases 1:1 with running tasks for exactly this reason
        # (direct_task_transport.cc). So: non-CPU shapes take an idle
        # lease or fall back to the raylet's scheduler.
        cpu_only = all(
            k == "CPU" for k in (spec.get("resources") or {})
        )
        if not cpu_only and best is not None and best["outstanding"] > 0:
            best = None
        # Grow while tasks are stacking up (up to the node's CPU-ish cap);
        # single-flight so a burst requests one lease at a time.
        cfg = get_config()
        if (
            (best is None
             or best["outstanding"] >= cfg.direct_lease_grow_outstanding)
            and len(live) < cfg.direct_lease_max_workers
            and not pool["acquiring"]
        ):
            pool["acquiring"] = True
            try:
                resp = await self.raylet.call(
                    "lease_worker",
                    {
                        "resources": spec.get("resources") or {},
                        "runtime_env_hash": spec.get("runtime_env_hash"),
                        "runtime_env": spec.get("runtime_env"),
                    },
                    timeout=cfg.lease_rpc_timeout_s,
                )
                if resp.get("status") == "ok":
                    try:
                        conn = await connect(resp["host"], resp["port"])
                    except Exception:
                        # Granted but unreachable: return it or the
                        # raylet's resources leak until our conn dies.
                        await self.raylet.call(
                            "release_lease",
                            {"worker_id": resp["worker_id"]},
                            timeout=cfg.lease_rpc_timeout_s,
                        )
                        raise
                    w = {
                        "conn": conn,
                        "worker_id": resp["worker_id"],
                        "outstanding": 0,
                        "last_used": time.monotonic(),
                        "key": key,
                        # The cards the raylet granted with the lease.
                        "gpu_ids": resp.get("gpu_ids"),
                    }
                    pool["workers"].append(w)
                    if best is None:
                        best = w
            except Exception:  # noqa: BLE001 — lease is opportunistic
                pass
            finally:
                pool["acquiring"] = False
        if best is not None and self._lease_reaper is None:
            self._lease_reaper = spawn(self._reap_leases_loop())
        return best

    async def _reap_leases_loop(self):
        """Return idle leases so the raylet can schedule other work."""
        try:
            while self._connected:
                await asyncio.sleep(get_config().lease_reap_interval_s)
                now = time.monotonic()
                for pool in self._leases.values():
                    # Partition synchronously FIRST: once an idle worker
                    # leaves pool["workers"], _lease_for can no longer
                    # hand it to a new task — only then is it safe to
                    # await the release RPC (an await here with the
                    # worker still visible let a fresh direct task race
                    # the connection close).
                    keep, to_release = [], []
                    for w in pool["workers"]:
                        if w["conn"]._closed:
                            continue
                        if (w["outstanding"] == 0 and now - w["last_used"]
                                > get_config().direct_lease_idle_release_s):
                            to_release.append(w)
                        else:
                            keep.append(w)
                    pool["workers"] = keep
                    for w in to_release:
                        await self._release_lease(w)
        except asyncio.CancelledError:
            pass

    def _on_raylet_push(self, channel: str, payload):
        if channel == "lease_revoked":
            wid = (payload or {}).get("worker_id")
            for pool in self._leases.values():
                for w in list(pool["workers"]):
                    if w["worker_id"] == wid:
                        # Out of the pool first so no new task can pick
                        # it; in-flight calls on it finish normally.
                        pool["workers"].remove(w)
                        spawn(self._return_revoked_lease(w))

    async def _return_revoked_lease(self, w):
        """A draining raylet revoked this lease: the worker is already
        out of the pool (no new tasks route to it); wait out its
        outstanding direct calls, then hand it back so the node can
        empty. Resubmissions go through the raylet submit path, which
        spills off the draining node."""
        deadline = time.monotonic() + 60.0
        while (w["outstanding"] > 0 and not w["conn"]._closed
               and time.monotonic() < deadline):
            await asyncio.sleep(0.05)
        await self._release_lease(w)

    async def _release_lease(self, w):
        try:
            await self.raylet.call(
                "release_lease", {"worker_id": w["worker_id"]},
                timeout=get_config().lease_rpc_timeout_s
            )
        except Exception:  # noqa: BLE001
            pass
        try:
            await w["conn"].close()
        except Exception:  # noqa: BLE001
            pass

    async def _release_all_leases(self):
        for pool in self._leases.values():
            for w in pool["workers"]:
                await self._release_lease(w)
            pool["workers"] = []

    async def _submit_with_retries(self, spec, futures, retries):
        attempt = 0
        refusals = 0
        if spec.get("sampled") and self._lc_pending:
            self._lc_close_submit_buffer(spec)
        while True:
            rpc_t = (
                time.monotonic()
                if spec.get("sampled") and self._lc_pending else None
            )
            try:
                result = await self.raylet.call("submit_task", spec, timeout=None)
            except ConnectionLost:
                result = {"status": "worker_crashed", "error": "raylet connection lost"}
            if rpc_t is not None:
                self._lc_stamp_rpc_wait(spec["task_id"], rpc_t)
            status = result.get("status")
            if result.get("not_executed") and refusals < 100:
                # Refused before running (a worker retiring under
                # max_calls): resubmission is free — nothing executed —
                # so it does not consume a retry (separate counter; the
                # cap only bounds a pathological refuse-forever loop).
                refusals += 1
                await asyncio.sleep(min(0.05 * refusals, 0.5))
                continue
            # max_retries=-1 = retry worker crashes forever (reference
            # semantics; data tasks are idempotent and use it).
            if status == "worker_crashed" and (
                retries < 0 or attempt < retries
            ):
                attempt += 1
                await asyncio.sleep(min(0.1 * attempt, 1.0))
                continue
            self._complete_task(spec, result, futures)
            return

    def _complete_task(self, spec, result, futures):
        self._release_borrows(spec)
        if spec.get("sampled") and self._lc_pending:
            self._lc_complete(spec)
        status = result.get("status")
        if status == "ok" and result.get("generator"):
            # Dynamic-generator task: items already live in the store
            # under (task_id, i) oids; the future resolves to the count.
            futures[0].set_result(("__gen__", result["num_items"]))
            return
        if status == "ok":
            for i, entry in enumerate(result["returns"]):
                oid = object_id_for_task(TaskID(spec["task_id"]), i).binary()
                if entry["kind"] == "inline":
                    try:
                        value = ser.deserialize_from_bytes(entry["data"])
                    except Exception as e:  # noqa: BLE001
                        futures[i].set_exception(
                            TaskError(type(e).__name__, f"result deserialization failed: {e}")
                        )
                        continue
                    self._memory_store_put(oid, value)
                    futures[i].set_result(value)
                else:  # in the shared store
                    self._in_store.add(oid)
                    self._owned_store_oids.add(oid)
                    self.lineage[oid] = spec
                    while len(self.lineage) > self.lineage_max_entries:
                        self.lineage.popitem(last=False)
                    futures[i].set_result(_IN_STORE)
                    if oid not in self.known_refs:
                        # The caller dropped the ref before completion: the
                        # finalizer already fired, so free the result now.
                        with self._free_lock:
                            self._free_queue.append(oid)
                        self._ensure_free_flush()
        elif status == "error":
            err = _rebuild_task_error(result)
            for f in futures:
                if not f.done():
                    f.set_exception(err)
        else:
            err = WorkerCrashedError(result.get("error", "worker crashed"))
            for f in futures:
                if not f.done():
                    f.set_exception(err)

    # -- actors ------------------------------------------------------------
    def create_actor(
        self,
        cls,
        args,
        kwargs,
        name: Optional[str] = None,
        namespace: str = "",
        resources: Optional[Dict[str, float]] = None,
        max_restarts: int = 0,
        max_task_retries: int = 0,
        max_concurrency: int = 1,
        scheduling=None,
        detached: bool = False,
        runtime_env=None,
        priority: int = 0,
    ) -> ActorHandle:
        cls_key = self.fn_manager.export(cls)
        payload, deps, borrow_oids = self.serialize_args(args, kwargs)
        actor_id = ActorID.from_random()
        # Constructor args (top-level AND nested refs) stay pinned until
        # the actor leaves PENDING/RESTARTING — creation may start long
        # after the driver dropped its handles.
        ctor_spec = {"task_id": actor_id.binary()}
        self._borrow_deps(ctor_spec, borrow_oids)
        if borrow_oids:
            asyncio.run_coroutine_threadsafe(
                self._release_ctor_borrows_when_live(
                    actor_id, ctor_spec, max_restarts
                ),
                self.loop,
            )
        resolved_env = self._resolve_runtime_env(runtime_env)
        create_spec = {
            "actor_id": actor_id.binary(),
            "cls_key": cls_key,
            "args": payload,
            "deps": deps,
            "max_concurrency": max_concurrency,
            "runtime_env": resolved_env,
        }
        reg_payload = {
            "actor_id": actor_id.binary(),
            "name": name,
            "namespace": namespace,
            "class_name": getattr(cls, "__name__", str(cls)),
            "job_id": self.job_id.binary(),
            "resources": resources if resources is not None else {"CPU": 1.0},
            "max_restarts": max_restarts,
            "create_spec": create_spec,
            "detached": detached,
            "scheduling": scheduling,
            "priority": int(priority),
            "subscribe": True,  # bundle the actor_update sub
        }
        if name:
            # Named actors keep the synchronous duplicate-name check
            # (reference: .remote() raises ValueError on a taken name).
            resp = self._run(self._gcs_call("register_actor", reg_payload))
            if not resp.get("ok"):
                raise ValueError(resp.get("error", "actor registration failed"))
        else:
            # Unnamed: registration pipelines — the handle returns
            # immediately and a burst of creations overlaps GCS
            # scheduling/forking with the driver's loop (reference: actor
            # creation is asynchronous, gcs_actor_manager.cc). Failures
            # surface as DEAD on the first call.
            async def _register():
                try:
                    resp = await self._gcs_call("register_actor", reg_payload)
                    err = None if resp.get("ok") else resp.get(
                        "error", "actor registration failed")
                except Exception as e:  # noqa: BLE001
                    err = f"{type(e).__name__}: {e}"
                if err is not None:
                    self._actor_cache[actor_id.binary()] = {
                        "actor_id": actor_id.binary(),
                        "state": "DEAD",
                        "address": None, "port": None, "node_id": None,
                        "name": None, "namespace": namespace,
                        "class_name": reg_payload["class_name"],
                        "death_cause": err, "restarts_used": 0,
                        "methods": [],
                    }
                    ev = self._actor_events.get(actor_id.binary())
                    if ev is not None:
                        ev.set()

            asyncio.run_coroutine_threadsafe(_register(), self.loop)
        self._subscribed_channels.add("actor_update:" + actor_id.hex())
        method_names = [
            m
            for m in dir(cls)
            if callable(getattr(cls, m, None)) and not m.startswith("__")
        ]
        return ActorHandle(
            actor_id,
            getattr(cls, "__name__", str(cls)),
            method_names,
            max_task_retries,
        )

    def _actor_info(self, actor_id: ActorID, wait_alive_timeout: float = 30.0) -> dict:
        aid = actor_id.binary()
        info = self._actor_cache.get(aid)
        if info is None or info["state"] not in ("ALIVE", "DEAD"):
            info = self._run(self._gcs_call("get_actor", {"actor_id": aid}))["actor"]
            if info is not None:
                self._actor_cache[aid] = info
        if info is None:
            # Pipelined (unnamed) registration may still be in flight:
            # poll briefly before declaring the actor unknown.
            reg_deadline = time.monotonic() + get_config().actor_register_wait_s
            while info is None and time.monotonic() < reg_deadline:
                time.sleep(0.02)
                info = self._actor_cache.get(aid) or self._run(
                    self._gcs_call("get_actor", {"actor_id": aid})
                )["actor"]
            if info is not None:
                self._actor_cache[aid] = info
        if info is None:
            raise ActorDiedError(f"unknown actor {actor_id.hex()}")
        deadline = time.monotonic() + wait_alive_timeout
        while info["state"] in ("PENDING", "RESTARTING"):
            ev = self._actor_events.setdefault(aid, threading.Event())
            ev.clear()
            self._run(
                self._gcs_call("subscribe", {"channel": "actor_update:" + actor_id.hex()})
            )
            info = self._run(self._gcs_call("get_actor", {"actor_id": aid}))["actor"]
            self._actor_cache[aid] = info
            if info["state"] not in ("PENDING", "RESTARTING"):
                break
            if not ev.wait(timeout=max(0.05, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise ActorUnavailableError(
                        f"actor {actor_id.hex()} not ready after {wait_alive_timeout}s"
                    )
            info = self._actor_cache.get(aid) or info
        if info["state"] == "DEAD":
            raise ActorDiedError(
                f"actor {actor_id.hex()} is dead: {info.get('death_cause')}"
            )
        return info

    def actor_raw_call(self, actor_id, method: str, payload,
                       timeout: float = 30.0):
        """Low-level RPC to the worker hosting an actor (compiled-DAG
        control: dag_start/dag_stop)."""
        if isinstance(actor_id, (bytes, bytearray)):
            actor_id = ActorID(actor_id)
        info = self._actor_info(actor_id)
        conn = self._actor_conn(info)
        return self._run(conn.call(method, payload, timeout=None), timeout=timeout)

    def _actor_conn(self, info) -> Connection:
        key = (info["address"], info["port"])
        conn = self._actor_conns.get(key)
        if conn is None or conn._closed:
            conn = self._run(connect(info["address"], info["port"],
                                     push_handler=self._on_actor_push))
            self._actor_conns[key] = conn
        return conn

    def submit_actor_call(
        self,
        actor_id: ActorID,
        method: str,
        args,
        kwargs,
        num_returns: int = 1,
        max_task_retries: int = 0,
    ) -> List[ObjectRef]:
        lc_sampled = lifecycle.enabled and lifecycle.sample()
        if lc_sampled:
            _lc_t0, _lc_ts0 = time.monotonic(), time.time()
        payload, deps, borrow_oids = self.serialize_args(args, kwargs)
        if lc_sampled:
            _lc_ser = time.monotonic() - _lc_t0
        task_id = TaskID.from_random()
        request = {
            "actor_id": actor_id.binary(),
            "task_id": task_id.binary(),
            "method": method,
            "args": payload,
            "deps": deps,
            "caller": self.client_id,
            "num_returns": num_returns,
        }
        if lc_sampled:
            request["sampled"] = True
        from ray_tpu_torch.util import tracing

        trace_ctx = tracing.inject()
        if trace_ctx:
            request["trace_ctx"] = trace_ctx
        if num_returns == "dynamic":
            # Streaming generator actor method (same contract as dynamic
            # tasks: items store under (task_id, i) as yielded).
            fut = concurrent.futures.Future()
            refs, futures = [ObjectRefGenerator(task_id, fut, self)], [fut]
        else:
            refs, futures = [], []
            for i in range(num_returns):
                oid = object_id_for_task(task_id, i)
                fut = concurrent.futures.Future()
                ref = ObjectRef(oid, fut)
                self.known_refs[oid.binary()] = ref
                self._track_owned_ref(ref)
                refs.append(ref)
                futures.append(fut)
        spec = {"task_id": task_id.binary()}
        self._borrow_deps(spec, borrow_oids)
        if lc_sampled:
            spec["sampled"] = True
            self._lc_track(task_id.binary(), f"{method}()", _lc_t0,
                           _lc_ts0, _lc_ser, refs)
        # Same burst batching as plain tasks: one thread->loop crossing
        # per burst of .remote() calls, not one per call.
        with self._submit_lock:
            self._submit_buf.append(
                ("actor", actor_id, request, spec, futures, max_task_retries)
            )
            need_schedule = not self._submit_scheduled
            if need_schedule:
                self._submit_scheduled = True
        if need_schedule:
            self.loop.call_soon_threadsafe(self._drain_submits)
        return refs

    async def _actor_conn_for_call(self, actor_id) -> Connection:
        """Resolve the connection to an actor's worker. Cached-ALIVE is the
        hot path and stays on the loop; only the blocking wait-for-ALIVE
        resolution hops to a thread."""
        info = self._actor_cache.get(actor_id.binary())
        if info is None or info["state"] != "ALIVE":
            info = await asyncio.get_event_loop().run_in_executor(
                None, self._actor_info, actor_id
            )
        key = (info["address"], info["port"])
        conn = self._actor_conns.get(key)
        if conn is None or conn._closed:
            conn = await connect(info["address"], info["port"],
                                 push_handler=self._on_actor_push)
            self._actor_conns[key] = conn
        return conn

    def _on_actor_push(self, channel: str, payload) -> None:
        """Results of batch-frame calls that ended before their frame."""
        if channel != "actor_call_results":
            return
        for task_id, result in payload["results"]:
            entry = self._batch_calls.pop(task_id, None)
            if entry is not None:
                self._complete_task(entry[0], result, entry[1])

    @staticmethod
    def _conn_actor_seqs(conn, actor_id_b: bytes):
        # Counters live on the Connection object itself: their lifetime is
        # exactly the connection's, so a restarted actor (new connection)
        # always restarts seq at 0 and a recycled id() can never resurrect
        # a stale counter.
        seqs = getattr(conn, "_rt_actor_seq", None)
        if seqs is None:
            seqs = conn._rt_actor_seq = {}
        return seqs.setdefault(actor_id_b, itertools.count())

    async def _actor_call_group(self, calls):
        """Send a burst of pipelined calls to one actor as batch frames:
        seqs are assigned contiguously under the actor lock, the receiver
        executes the run in order with one executor hop per batch and
        answers each call as it ends (`_on_actor_push`)."""
        batch_max = get_config().actor_call_batch_max
        actor_id = calls[0][0]
        lock = self._actor_locks.setdefault(actor_id.binary(), asyncio.Lock())
        i = 0
        while i < len(calls):
            chunk = calls[i:i + batch_max]
            i += batch_max
            if self._lc_pending:
                for _, _, _spec, _, _ in chunk:
                    self._lc_close_submit_buffer(_spec)
            for _, request, spec, futures, _ in chunk:
                self._batch_calls[request["task_id"]] = (spec, futures)
            try:
                async with lock:
                    conn = await self._actor_conn_for_call(actor_id)
                    counter = self._conn_actor_seqs(conn, actor_id.binary())
                    for _, request, _, _, _ in chunk:
                        request["seq"] = next(counter)
                    call_task = asyncio.ensure_future(conn.call(
                        "actor_call_batch",
                        {"calls": [c[1] for c in chunk]},
                        timeout=None,
                    ))
                resp = await call_task
            except BaseException as e:  # noqa: BLE001 — to each call
                # Calls a push already answered are done.
                chunk = [c for c in chunk
                         if self._batch_calls.pop(c[1]["task_id"], None)]
                self._fail_actor_chunk(actor_id, chunk, e)
                continue
            for (_, request, spec, futures, _), result in zip(
                    chunk, resp["results"]):
                if self._batch_calls.pop(request["task_id"], None):
                    self._complete_task(spec, result, futures)

    def _fail_actor_chunk(self, actor_id, chunk, e: BaseException) -> None:
        if isinstance(e, (ConnectionLost, OSError)):
            # Actor may be restarting: fall back to the per-call retry
            # machinery, which re-resolves the actor and burns one
            # attempt for the loss we just observed. retries==0 calls
            # may already have executed — at-most-once forbids a resend.
            self._actor_cache.pop(actor_id.binary(), None)
            err = ActorUnavailableError(
                f"actor {actor_id.hex()} connection lost"
            )
            for aid, request, spec, futures, retries in chunk:
                if retries == 0:
                    self._release_borrows(spec)
                    for f in futures:
                        if not f.done():
                            f.set_exception(err)
                    continue
                request.pop("seq", None)
                spawn(self._actor_call_with_retries(
                    aid, request, spec, futures,
                    retries - 1 if retries > 0 else retries))
            return
        for _, _, spec, futures, _ in chunk:
            self._release_borrows(spec)
            for f in futures:
                if not f.done():
                    f.set_exception(e)

    async def _actor_call_with_retries(self, actor_id, request, spec, futures, retries):
        """Send an ordered actor call, retrying across restarts.

        Sequence numbers are assigned at *send* time under a per-actor lock
        and keyed by the connection instance, so a restarted actor (fresh
        receiver queue) sees a fresh sequence starting at 0 — the client
        side of the reference's SequentialActorSubmitQueue contract.
        """
        attempt = 0
        lock = self._actor_locks.setdefault(actor_id.binary(), asyncio.Lock())
        if request.get("sampled") and self._lc_pending:
            self._lc_close_submit_buffer(spec)
        while True:
            rpc_t = (
                time.monotonic()
                if request.get("sampled") and self._lc_pending else None
            )
            try:
                async with lock:
                    conn = await self._actor_conn_for_call(actor_id)
                    counter = self._conn_actor_seqs(conn, actor_id.binary())
                    request["seq"] = next(counter)
                    # Start the call inside the lock so the write order on
                    # the connection matches seq order; await outside.
                    call_task = asyncio.ensure_future(
                        conn.call("actor_call", request, timeout=None)
                    )
                result = await call_task
                if rpc_t is not None:
                    self._lc_stamp_rpc_wait(request["task_id"], rpc_t)
            except (ConnectionLost, OSError):
                self._actor_cache.pop(actor_id.binary(), None)
                if attempt < retries:
                    attempt += 1
                    cfg = get_config()
                    await asyncio.sleep(min(
                        cfg.actor_retry_backoff_s * attempt,
                        cfg.actor_retry_backoff_max_s,
                    ))
                    continue
                self._release_borrows(spec)
                err = ActorUnavailableError(
                    f"actor {actor_id.hex()} connection lost"
                )
                for f in futures:
                    if not f.done():
                        f.set_exception(err)
                return
            except (ActorDiedError, ActorUnavailableError) as e:
                self._release_borrows(spec)
                for f in futures:
                    if not f.done():
                        f.set_exception(e)
                return
            except BaseException as e:  # noqa: BLE001
                self._release_borrows(spec)
                for f in futures:
                    if not f.done():
                        f.set_exception(e)
                return
            self._complete_task(spec, result, futures)
            return

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        self._run(
            self._gcs_call(
                "kill_actor",
                {"actor_id": actor_id.binary(), "no_restart": no_restart},
            )
        )

    def get_actor_by_name(self, name: str, namespace: str = "") -> ActorHandle:
        info = self._run(
            self._gcs_call("get_named_actor", {"name": name, "namespace": namespace})
        )["actor"]
        if info is None or info["state"] == "DEAD":
            raise ValueError(f"no live actor named {name!r}")
        aid = ActorID(info["actor_id"])
        self._actor_cache[aid.binary()] = info
        self._run(self._gcs_call("subscribe", {"channel": "actor_update:" + aid.hex()}))
        # Method names ride the GCS actor record (reported by the hosting
        # worker at actor_ready).
        return ActorHandle(aid, info["class_name"], info.get("methods") or [])

    # -- cluster introspection --------------------------------------------
    def nodes(self) -> List[dict]:
        return self._run(self._gcs_call("get_nodes", {}))["nodes"]

    def cluster_resources(self) -> Dict[str, float]:
        total: Dict[str, float] = {}
        for n in self.nodes():
            if n["state"] != "ALIVE":
                continue
            for k, v in n["resources_total"].items():
                total[k] = total.get(k, 0) + v
        return total

    def available_resources(self) -> Dict[str, float]:
        total: Dict[str, float] = {}
        for n in self.nodes():
            if n["state"] != "ALIVE":
                continue
            for k, v in n["resources_available"].items():
                total[k] = total.get(k, 0) + v
        return total


class _InlineArg:
    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value

    def __reduce__(self):
        return (_InlineArg, (self.value,))


class _StoreArg:
    __slots__ = ("oid",)

    def __init__(self, oid: bytes):
        self.oid = oid

    def __reduce__(self):
        return (_StoreArg, (self.oid,))


def _rebuild_task_error(result) -> TaskError:
    cause = None
    if result.get("data"):
        try:
            cause = cloudpickle.loads(result["data"])
        except Exception:  # noqa: BLE001
            cause = None
    # Raylet-originated errors carry a plain "error" string rather than a
    # worker traceback — surface it instead of an empty message.
    return TaskError(
        result.get("cls", "Exception"),
        result.get("tb") or result.get("error", ""),
        cause,
    )


def make_task_error(exc: BaseException) -> dict:
    import traceback

    try:
        data = cloudpickle.dumps(exc)
    except Exception:  # noqa: BLE001
        data = None
    return {
        "status": "error",
        "cls": type(exc).__name__,
        "tb": "".join(traceback.format_exception(type(exc), exc, exc.__traceback__)),
        "data": data,
    }


# ---------------------------------------------------------------------------
# Global state (reference: python/ray/_private/worker.py global_worker)
# ---------------------------------------------------------------------------

_global_client: Optional[CoreClient] = None
_global_node = None  # the in-process Node when this process started the cluster
_mode: Optional[str] = None  # "driver" | "worker" | "local"
_local_state = None


def get_client() -> CoreClient:
    if _global_client is None:
        raise RuntimeError("ray_tpu_torch is not initialized; call ray_tpu_torch.init() first")
    return _global_client


def get_client_or_none() -> Optional[CoreClient]:
    return _global_client


def set_client(client: Optional[CoreClient], mode: Optional[str], node=None):
    global _global_client, _mode, _global_node
    _global_client = client
    _mode = mode
    _global_node = node


def is_initialized() -> bool:
    return _global_client is not None or _mode == "local"


def get_mode() -> Optional[str]:
    return _mode
