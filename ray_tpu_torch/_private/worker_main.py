"""Worker process entry point.

Analog of the reference's default_worker.py + the task-execution callback in
the Cython layer (_raylet.pyx:2177 task_execution_handler,
execute_task_with_cancellation_handler :2009): registers with the raylet,
receives task pushes, executes user code on executor threads, and serves
direct actor calls from other processes
(CoreWorkerDirectTaskReceiver::HandleTask,
transport/direct_actor_transport.cc:37).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import heapq
import inspect
import os
import threading
import time
import traceback
from typing import Any, Dict, Optional

from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.accelerators.gpu import confine_process_to_gpus
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.ids import JobID, ObjectID, TaskID, object_id_for_task
from ray_tpu_torch._private.protocol import RpcServer, connect, spawn
from ray_tpu_torch._private.worker import CoreClient, make_task_error
from ray_tpu_torch.exceptions import ActorDiedError
from ray_tpu_torch.util import lifecycle

def _retired_result() -> dict:
    return {"status": "worker_crashed", "not_executed": True,
            "error": "worker retired (max_calls)"}


class _RawObject:
    """Pre-framed bytes (RTX1 cross-language objects) presented with the
    SerializedObject store interface (total_size / write_into / to_bytes)."""

    def __init__(self, raw: bytes):
        self.raw = raw

    @property
    def total_size(self) -> int:
        return len(self.raw)

    def write_into(self, dest) -> int:
        dest[: len(self.raw)] = self.raw
        return len(self.raw)

    def to_bytes(self) -> bytes:
        return self.raw


class _CallerQueue:
    """Ordered execution state for one caller (SequentialActorSubmitQueue
    receiver side, transport/sequential_actor_submit_queue.cc)."""

    def __init__(self):
        self.next_seq = 0
        self.pending: list = []  # heap of (seq, tiebreak, request, future)
        self.draining = False


class _BatchReplies:
    """Answers each call of an `actor_call_batch` frame when that call
    ends. Results that end while calls of the frame still run go to the
    caller at once, in one `actor_call_results` push per loop tick; the
    frame's reply carries the rest, with None where a push carried the
    result. A burst stays one request and, on an ordered actor, one
    executor hop."""

    def __init__(self, conn, calls, futs):
        self._conn = conn
        self._task_ids = [c["task_id"] for c in calls]
        self._futs = futs
        self._running = len(futs)
        self._ended: list = []
        self._pushed: set = set()
        self._sends: list = []
        for i, fut in enumerate(futs):
            fut.add_done_callback(lambda _f, i=i: self._on_end(i))

    def _on_end(self, i: int) -> None:
        self._running -= 1
        if self._running == 0:
            return  # the reply carries it, and any not pushed yet
        self._ended.append(i)
        if len(self._ended) == 1:
            asyncio.get_event_loop().call_soon(self._push)

    def _push(self) -> None:
        ended, self._ended = self._ended, []
        if self._running == 0:
            return
        self._pushed.update(ended)
        self._sends.append(spawn(self._conn.push("actor_call_results", {
            "results": [[self._task_ids[i], self._futs[i].result()]
                        for i in ended]})))

    async def rest(self) -> list:
        """The reply's results, once every push has been written ahead
        of it on the connection."""
        await asyncio.gather(*self._sends)
        return [None if i in self._pushed else f.result()
                for i, f in enumerate(self._futs)]


class ActorState:
    def __init__(self, actor_id: bytes, instance: Any, max_concurrency: int):
        self.actor_id = actor_id
        self.instance = instance
        self.max_concurrency = max_concurrency
        self.lock = threading.Lock()
        self.queues: Dict[bytes, _CallerQueue] = {}
        self.sema = asyncio.Semaphore(max(1, max_concurrency))


class WorkerProcess:
    def __init__(self):
        self._boot_stamp("init0")
        self.worker_id = bytes.fromhex(os.environ["RT_WORKER_ID"])
        self.node_id = bytes.fromhex(os.environ["RT_NODE_ID"])
        gcs_host, gcs_port = os.environ["RT_GCS_ADDR"].rsplit(":", 1)
        self.gcs_addr = (gcs_host, int(gcs_port))
        self.raylet_port = int(os.environ["RT_RAYLET_PORT"])
        self.store_name = os.environ["RT_STORE_NAME"]
        self._boot_stamp("init_env")
        self.rpc = RpcServer("127.0.0.1", 0)
        self.rpc.register("actor_call", self.h_actor_call)
        self.rpc.register("actor_call_batch", self.h_actor_call_batch)
        self.rpc.register("release_actor", self.h_release_actor)
        self.rpc.register("run_task_direct", self.h_run_task_direct)
        self.rpc.register("run_tasks_batch", self.h_run_tasks_batch)
        self.rpc.register("dag_start", self.h_dag_start)
        self.rpc.register("dag_stop", self.h_dag_stop)
        self.rpc.register("ping", self.h_ping)
        self.rpc.register("dump_stacks", self.h_dump_stacks)
        self._dag_loops: list = []  # (thread, stop_event)
        self.client: Optional[CoreClient] = None
        self.raylet_conn = None
        self.actor: Optional[ActorState] = None
        self._boot_stamp("init_rpc")
        _n_exec = max(4, get_config().max_workers_per_node)
        self._boot_stamp("init_config")
        self.executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=_n_exec, thread_name_prefix="rt-exec"
        )
        # Threads alive before the hosted actor's creation: any other
        # thread not named "rt-" (the runtime's own, some started lazily
        # inside the actor's calls) is the actor's.
        self._threads_before_actor: set = set()
        self._boot_stamp("init_executor")
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self._direct_lock = asyncio.Lock()  # one leased task runs at a time
        # Actor-call state events (normal-task events are recorded by the
        # raylet; actor calls bypass it, so the receiving worker reports).
        self._task_events: list = []
        # In-flight actor calls (running or queued): a kill can only
        # recycle this worker back into the pool when zero — a thread
        # mid-call cannot be stopped, only the process can.
        self._active_actor_calls = 0
        # max_calls (reference: @ray.remote(max_calls=N), the leak
        # mitigation for tasks wrapping leaky native code): per-function
        # execution counts; crossing a task's threshold retires this
        # worker — later pushes are refused (the owner retries on a
        # fresh worker) and the process exits once replies flush.
        self._fn_calls: Dict[bytes, int] = {}
        self._retiring = False

    async def h_dump_stacks(self, d, conn):
        """Live thread stacks of this worker (the on-demand profiling
        role of the reference's dashboard py-spy integration,
        dashboard/modules/reporter/profile_manager.py — in-process
        cooperative sampling instead of an external native profiler)."""
        import sys
        import traceback

        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        threads = []
        for ident, frame in frames.items():
            threads.append({
                "thread": names.get(ident, str(ident)),
                "stack": "".join(traceback.format_stack(frame)),
            })
        return {
            "pid": os.getpid(),
            "worker_id": self.worker_id,
            "actor": bool(self.actor),
            "threads": threads,
        }

    def _boot_stamp(self, stage: str):
        log_path = os.environ.get("RT_WORKER_BOOT_LOG")
        if log_path:
            import time

            with open(log_path, "a") as f:
                f.write(f"{os.getpid()} {stage} {time.time()}\n")

    async def run(self):
        self.loop = asyncio.get_event_loop()
        # The runtime's blocking lookups (an actor's address) run here.
        self.loop.set_default_executor(concurrent.futures.ThreadPoolExecutor(
            thread_name_prefix="rt-loop"))
        port = await self.rpc.start()
        self._boot_stamp("rpc_up")
        self.raylet_conn = await connect(
            "127.0.0.1", self.raylet_port, push_handler=self._on_raylet_push
        )
        self._boot_stamp("raylet_conn")
        self.client = CoreClient(
            self.loop,
            self.gcs_addr,
            ("127.0.0.1", self.raylet_port),
            self.store_name,
            self.node_id,
            JobID.nil(),
            mode="worker",
        )
        self._boot_stamp("client_ctor")
        await self.client._connect(raylet_conn=self.raylet_conn)
        self.client._connected = True
        self._boot_stamp("client_up")
        worker_mod.set_client(self.client, "worker")
        # Materialize the runtime env (working_dir/py_modules download from
        # the GCS KV) before any task runs. Blocking KV reads must not run
        # on the event loop.
        renv_json = os.environ.get("RT_RUNTIME_ENV")
        if renv_json:
            import json

            from ray_tpu_torch.runtime_env import apply_runtime_env

            try:
                await self.loop.run_in_executor(
                    self.executor, apply_runtime_env, json.loads(renv_json),
                    self.client,
                )
            except Exception as e:  # noqa: BLE001
                # Report so the raylet fails queued tasks for this env
                # instead of respawning us in a crash loop.
                try:
                    await self.raylet_conn.call(
                        "worker_env_failed",
                        {
                            "worker_id": self.worker_id,
                            "runtime_env_hash": json.loads(renv_json).get("hash"),
                            "error": f"{type(e).__name__}: {e}",
                        },
                    )
                finally:
                    raise SystemExit(1)
        resp = await self.raylet_conn.call(
            "register_worker", {"worker_id": self.worker_id, "port": port}
        )
        assert resp["node_id"] == self.node_id
        self._boot_stamp("registered")
        spawn(self._flush_events_loop())
        await asyncio.Event().wait()

    def _record_task_event(self, task_id: bytes, name: str, state: str,
                           type: str = "ACTOR_TASK", job_id: bytes = b""):
        """Queue one task state event for the flush loop (one dict; no
        RPC per task)."""
        self._task_events.append(
            {
                "task_id": task_id,
                "name": name,
                "job_id": job_id,
                "node_id": self.node_id,
                "worker_id": self.worker_id,
                "type": type,
                "state": state,
                "ts": time.time(),
            }
        )

    def _lc_emit(self, task_id: bytes, name: str, phases: Dict[str, list],
                 job_id: bytes = b""):
        """Queue a worker-hop lifecycle span for a sampled task; rides the
        existing task-event flush loop (no extra RPC)."""
        self._task_events.append(lifecycle.event(
            task_id, name, job_id, self.node_id, "worker", phases,
            worker_id=self.worker_id,
        ))

    async def _flush_events_loop(self):
        while True:
            await asyncio.sleep(get_config().task_event_flush_interval_s)
            if self._task_events:
                events, self._task_events = self._task_events, []
                try:
                    await self.client._gcs_call("add_task_events", {"events": events})
                except Exception:
                    pass

    # -- raylet pushes ----------------------------------------------------
    def _on_raylet_push(self, channel: str, payload):
        if channel == "run_task":
            spawn(self._run_task(payload))
        elif channel == "create_actor":
            spawn(self._create_actor(payload))
        elif channel == "lease_revoked" and self.client is not None:
            # Workers own leases too (nested tasks): forward drain-time
            # revocations to the embedded client.
            self.client._on_raylet_push(channel, payload)

    async def _run_task(self, spec):
        if self._retiring:
            await self.raylet_conn.call(
                "task_done",
                {"task_id": spec["task_id"], "result": _retired_result()},
            )
            return
        result = await self.loop.run_in_executor(
            self.executor, self._execute_accounted, spec
        )
        await self.raylet_conn.call(
            "task_done", {"task_id": spec["task_id"], "result": result}
        )

    async def h_run_task_direct(self, d, conn):
        """Leased-worker fast path: the owner pushes the task spec straight
        to this worker and the result rides the RPC response — the raylet
        is not on the per-task path (direct_task_transport.cc PushTask).

        Execution is serialized: the lease holds resources for ONE task
        shape, so pipelined pushes queue here rather than running
        concurrently in the executor (which would oversubscribe the
        node's accounting)."""
        if self._retiring:
            return _retired_result()
        t0 = time.monotonic() if d.get("sampled") else None
        async with self._direct_lock:
            # Sampled: the wait for earlier pipelined pushes on this
            # lease IS the task's queue time (the raylet never sees
            # direct tasks, so the worker owns the queue_wait phase).
            if t0 is not None:
                d["_lc_queue_wait"] = time.monotonic() - t0
            # _execute_accounted re-checks _retiring inside (a push may
            # have queued on the lock behind the call that crossed the
            # threshold — it must refuse, not run-and-be-killed).
            return await self.loop.run_in_executor(
                self.executor, self._execute_accounted, d, True
            )

    async def h_run_tasks_batch(self, d, conn):
        """Batched direct transport: a burst of leased tasks executes in
        ONE executor hop, serially (the lease holds resources for one task
        shape — same contract as run_task_direct)."""
        if self._retiring:
            return {"results": [_retired_result() for _ in d["specs"]]}
        specs = d["specs"]
        t_recv = time.monotonic()

        def run_all():
            # Per-spec accounting: once the threshold is crossed the
            # REST of the batch is refused (not_executed -> the owner
            # resubmits it on a fresh worker), so the worker never
            # exceeds max_calls by the batch size.
            out = []
            for s in specs:
                # Sampled: batch-arrival -> this spec's turn is its
                # queue time (predecessors in the run + lock wait).
                if s.get("sampled"):
                    s["_lc_queue_wait"] = time.monotonic() - t_recv
                out.append(self._execute_accounted(s, True))
            return out

        async with self._direct_lock:
            results = await self.loop.run_in_executor(self.executor, run_all)
        return {"results": results}


    def _execute_accounted(self, spec, direct: bool = False) -> dict:
        """Execute a task with max_calls bookkeeping. Runs on an
        executor thread; the GIL covers the counter dict, and the retire
        coroutine is handed to the event loop thread-safely.

        `direct`: the spec came straight from its owner on a leased
        worker, so the raylet never saw it and this worker records its
        RUNNING and FINISHED/FAILED events (the raylet records the ones
        it dispatches itself)."""
        if self._retiring:
            return _retired_result()
        if direct:
            ev = (spec["task_id"], spec.get("name") or "")
            job = spec.get("job_id", b"")
            self._record_task_event(*ev, "RUNNING", "NORMAL_TASK", job)
        result = self._execute_task(spec)
        if direct:
            state = "FINISHED" if result.get("status") == "ok" else "FAILED"
            self._record_task_event(*ev, state, "NORMAL_TASK", job)
        limit = spec.get("max_calls") or 0
        key = spec.get("fn_key")
        if limit and key is not None:
            n = self._fn_calls.get(key, 0) + 1
            self._fn_calls[key] = n
            if n >= limit and not self._retiring:
                self._retiring = True
                self.loop.call_soon_threadsafe(
                    lambda: asyncio.ensure_future(self._retire())
                )
        return result

    async def _retire(self):
        # Tell the raylet first so it stops dispatching here; it only
        # terminate()s as a late fallback — this worker owns its exit
        # once every in-flight reply is on the wire.
        try:
            await self.raylet_conn.call(
                "retire_worker", {"worker_id": self.worker_id}, timeout=5
            )
        except Exception:  # noqa: BLE001
            pass
        # The threshold-crossing task's reply travels on a direct
        # worker->owner connection; exiting before it flushes would
        # surface as worker_crashed on an already-executed task. Wait
        # out any running batch, give its respond() coroutine a tick to
        # write, then drain every server connection.
        try:
            async with self._direct_lock:
                pass
            await asyncio.sleep(0.05)
            for conn in list(self.rpc.connections):
                try:
                    conn._sender.flush()
                    await conn.writer.drain()
                except Exception:  # noqa: BLE001
                    pass
        except Exception:  # noqa: BLE001
            pass
        os._exit(0)

    def _execute_task(self, spec) -> dict:
        from ray_tpu_torch.util import tracing

        with tracing.activate(
            spec.get("trace_ctx"), spec.get("name") or "task"
        ):
            return self._execute_task_body(spec)

    def _execute_task_body(self, spec) -> dict:
        # Control-plane profiler (worker hop): sampled specs carry
        # "sampled"; stamp fn_fetch / arg_fetch / deserialize / exec /
        # result_store from monotonic deltas. Unsampled tasks pay one
        # dict miss.
        lc: Optional[Dict[str, list]] = {} if spec.get("sampled") else None
        if lc is not None:
            qw = spec.get("_lc_queue_wait")
            if qw:
                # Direct-transport queue time stamped by the push handler
                # (the raylet is off the per-task path for leased tasks).
                lc["queue_wait"] = [time.time() - qw, qw]  # rtlint: disable=RT011 — deliberate wall anchor: [start_wall, dur] lets the client stitch queue-wait onto its timeline
        try:
            confine_process_to_gpus(spec.get("gpu_ids") or [])
            if spec.get("fn_name"):
                # Cross-language task (reference: cross_language.py /
                # function-descriptor calls from java/cpp frontends): the
                # function is named "module:attr", args are plain msgpack
                # values, and the result serializes as RTX1 so the foreign
                # caller can decode it.
                import importlib

                mod_name, _, attr = spec["fn_name"].partition(":")
                fn = getattr(importlib.import_module(mod_name), attr)
                value = fn(*(spec.get("plain_args") or []))
                return self._package_returns(spec, value, xlang=True)
            if lc is not None:
                t0, w0 = time.monotonic(), time.time()
            fn = self.client.fn_manager.fetch(spec["fn_key"])
            if lc is not None:
                now = time.monotonic()
                lc["fn_fetch"] = [w0, max(0.0, now - t0)]
                t0, w0 = now, time.time()
                lifecycle.begin_arg_capture()
            args, kwargs = self.client.deserialize_args(spec["args"])
            if lc is not None:
                total = max(0.0, time.monotonic() - t0)
                arg_s = min(lifecycle.end_arg_capture(), total)
                lc["arg_fetch"] = [w0, arg_s]
                lc["deserialize"] = [w0, max(0.0, total - arg_s)]
                t0, w0 = time.monotonic(), time.time()
            value = fn(*args, **kwargs)
            if lc is not None:
                lc["exec"] = [w0, max(0.0, time.monotonic() - t0)]
                t0, w0 = time.monotonic(), time.time()
            out = self._package_returns(spec, value)
            if lc is not None:
                lc["result_store"] = [w0, max(0.0, time.monotonic() - t0)]
                self._lc_emit(spec["task_id"], spec.get("name") or "", lc,
                              spec.get("job_id", b""))
            return out
        except BaseException as e:  # noqa: BLE001 — shipped to the caller
            return make_task_error(e)

    def _package_returns(self, spec, value, xlang: bool = False) -> dict:
        cfg = get_config()
        num_returns = spec.get("num_returns", 1)
        if num_returns == "dynamic":
            # Streaming generator task (reference: streaming_generator /
            # num_returns="dynamic"): each yielded item is serialized and
            # stored under (task_id, i) AS PRODUCED, so consumers holding
            # the ObjectRefGenerator read item i while the generator is
            # still running. The final count rides the task result.
            items = value if inspect.isgenerator(value) else iter([value])
            task_id = TaskID(spec["task_id"])
            n = 0
            for i, v in enumerate(items):
                so = ser.serialize(v)
                self.client.put_serialized_with_spill(
                    object_id_for_task(task_id, i), so
                )
                n += 1
            return {"status": "ok", "generator": True, "num_items": n}
        if num_returns == 1:
            values = [value]
        else:
            values = list(value)
            if len(values) != num_returns:
                raise ValueError(
                    f"task declared num_returns={num_returns} but returned "
                    f"{len(values)} values"
                )
        returns = []
        task_id = TaskID(spec["task_id"])
        for i, v in enumerate(values):
            so = (_RawObject(ser.serialize_xlang(v)) if xlang
                  else self.client.serialize_result(v))
            if so.total_size <= cfg.max_inline_object_size:
                returns.append({"kind": "inline", "data": so.to_bytes()})
            else:
                oid = object_id_for_task(task_id, i)
                self.client.put_serialized_with_spill(oid, so)
                returns.append({
                    "kind": "store", "size": so.total_size,
                    "object_id": oid.binary(),
                })
        return {"status": "ok", "returns": returns}

    # -- actor lifecycle --------------------------------------------------
    async def _create_actor(self, payload):
        self._threads_before_actor = set(threading.enumerate())

        def do_create():
            confine_process_to_gpus(payload.get("gpu_ids") or [])
            cls = self.client.fn_manager.fetch(payload["cls_key"])
            args, kwargs = self.client.deserialize_args(payload["args"])
            return cls(*args, **kwargs)

        try:
            self._boot_stamp("create_recv")
            instance = await self.loop.run_in_executor(self.executor, do_create)
            self._boot_stamp("instantiated")
            self.actor = ActorState(
                payload["actor_id"], instance, payload.get("max_concurrency", 1)
            )
            methods = [
                m
                for m in dir(instance)
                if callable(getattr(instance, m, None)) and not m.startswith("__")
            ]
            # Method names ride the actor_ready report and live in the GCS
            # actor record (one RPC, not a separate per-actor KV write) —
            # get_actor() callers read them from the actor view.
            await self.client._gcs_call(
                "actor_ready",
                {
                    "actor_id": payload["actor_id"],
                    "address": "127.0.0.1",
                    "port": self.rpc.port,
                    "worker_id": self.worker_id,
                    "methods": methods,
                },
            )
        except BaseException as e:  # noqa: BLE001
            await self.client._gcs_call(
                "actor_ready",
                {
                    "actor_id": payload["actor_id"],
                    "error": f"{type(e).__name__}: {e}\n{traceback.format_exc()}",
                },
            )

    # -- actor calls -------------------------------------------------------
    async def h_actor_call(self, d, conn):
        actor = self.actor
        if actor is None or actor.actor_id != d["actor_id"]:
            return make_task_error(
                ActorDiedError("actor not hosted by this worker")
            )
        self._active_actor_calls += 1
        try:
            if d.get("xlang"):
                # Cross-language caller (C++ client): plain msgpack args,
                # RTX1 result, no per-caller sequence protocol — foreign
                # clients are synchronous request/response. The concurrency
                # bound still applies (the semaphore is sized
                # max(1, max_concurrency), so serial actors stay serial for
                # foreign callers too).
                async with actor.sema:
                    return await self._invoke_actor_method(actor, d)
            if actor.max_concurrency > 1:
                async with actor.sema:
                    return await self._invoke_actor_method(actor, d)
            # Ordered path: execute strictly by per-caller sequence number.
            caller = d.get("caller", b"")
            q = actor.queues.setdefault(caller, _CallerQueue())
            if not q.draining and not q.pending and d["seq"] == q.next_seq:
                # Next in order and alone: run it here. Calls arriving
                # meanwhile queue behind it and drain apart, so this reply
                # never waits for them.
                q.draining = True
                q.next_seq += 1
                try:
                    return await self._invoke_actor_method(actor, d)
                finally:
                    q.draining = False
                    if q.pending:
                        spawn(self._drain_ordered(actor, caller))
            fut = self._enqueue_ordered(actor, d)
            spawn(self._drain_ordered(actor, caller))
            return await fut
        finally:
            self._active_actor_calls -= 1

    async def h_actor_call_batch(self, d, conn):
        """A contiguous run of ordered calls from one caller: enqueue all
        BEFORE draining so the whole run executes in one executor hop."""
        actor = self.actor
        calls = d["calls"]
        if actor is None or any(actor.actor_id != c["actor_id"] for c in calls):
            err = make_task_error(
                ActorDiedError("actor not hosted by this worker")
            )
            return {"results": [err for _ in calls]}
        self._active_actor_calls += len(calls)
        async def one(c):
            async with actor.sema:
                return await self._invoke_actor_method(actor, c)

        try:
            ordered = actor.max_concurrency <= 1
            futs = [self._enqueue_ordered(actor, c) if ordered
                    else asyncio.ensure_future(one(c)) for c in calls]
            replies = _BatchReplies(conn, calls, futs)
            if ordered:
                spawn(self._drain_ordered(actor, calls[0].get("caller", b"")))
            await asyncio.gather(*futs)
            return {"results": await replies.rest()}
        finally:
            self._active_actor_calls -= len(calls)

    async def h_release_actor(self, d, conn):
        """Tear down the hosted actor so this worker returns to the pool
        (clean rt.kill only). Refuses — forcing a process kill — when any
        call is running or queued, or when a thread the actor started
        outlives its teardown: neither can be stopped from outside, and
        either would run on beside the worker's next actor."""
        actor = self.actor
        if actor is None or actor.actor_id != d["actor_id"]:
            return {"recycled": True}
        if self._active_actor_calls > 0 or self._dag_loops:
            return {"recycled": False}
        self.actor = None
        instance = actor.instance
        actor.instance = None

        def cleanup():
            nonlocal instance
            try:
                del instance
            finally:
                import gc

                gc.collect()
            return self._actor_threads_left()

        left = await self.loop.run_in_executor(self.executor, cleanup)
        return {"recycled": not left}

    def _actor_threads_left(self, grace_s: float = 0.2) -> list:
        """Names of the threads the torn-down actor started that are
        still alive, after up to `grace_s` for them to end."""
        deadline = time.monotonic() + grace_s
        left = []
        for t in threading.enumerate():
            if (t in self._threads_before_actor or t.name.startswith("rt-")
                    # a native thread (torch's autograd device threads)
                    # that ran Python: not started by the actor's code
                    or isinstance(t, threading._DummyThread)):
                continue
            t.join(max(0.0, deadline - time.monotonic()))
            if t.is_alive():
                left.append(t.name)
        return left

    def _enqueue_ordered(self, actor: ActorState, d):
        q = actor.queues.setdefault(d.get("caller", b""), _CallerQueue())
        fut = self.loop.create_future()
        heapq.heappush(q.pending, (d["seq"], id(d), d, fut))
        return fut

    async def _drain_ordered(self, actor: ActorState, caller: bytes):
        q = actor.queues.setdefault(caller, _CallerQueue())
        if q.draining:
            return
        q.draining = True
        try:
            while q.pending and q.pending[0][0] == q.next_seq:
                # Pop the whole contiguous seq run and execute it in ONE
                # executor hop — the thread handoff is the dominant cost
                # of a small actor call on a busy host.
                run = []
                limit = get_config().actor_call_batch_max
                while (q.pending and q.pending[0][0] == q.next_seq
                       and len(run) < limit):
                    _, _, req, rfut = heapq.heappop(q.pending)
                    q.next_seq += 1
                    run.append((req, rfut))
                if len(run) == 1:
                    result = await self._invoke_actor_method(actor, run[0][0])
                    if not run[0][1].done():
                        run[0][1].set_result(result)
                else:
                    await self._invoke_actor_run(actor, run)
        finally:
            q.draining = False

    async def _invoke_actor_run(self, actor: ActorState, run) -> None:
        """Execute an ordered run of (call, future) pairs in a single
        executor hop. Each future resolves as its call ends, through a
        hop back to the loop that the calls ending before the loop runs
        share, so a call never waits for a slower one after it."""
        from ray_tpu_torch.util import tracing

        ended: list = []
        ended_lock = threading.Lock()

        def resolve():
            with ended_lock:
                items = ended[:]
                ended.clear()
            for rfut, res in items:
                if not rfut.done():
                    rfut.set_result(res)

        def post(rfut, res):
            with ended_lock:
                ended.append((rfut, res))
                first = len(ended) == 1
            if first:
                self.loop.call_soon_threadsafe(resolve)

        def do_run():
            for d, rfut in run:
                self._record_task_event(d["task_id"], d["method"], "RUNNING")
                lc = {} if d.get("sampled") else None
                try:
                    method = getattr(actor.instance, d["method"])
                    if d.get("xlang"):
                        args, kwargs = tuple(d.get("plain_args") or ()), {}
                    else:
                        if lc is not None:
                            t0, w0 = time.monotonic(), time.time()
                            lifecycle.begin_arg_capture()
                        args, kwargs = self.client.deserialize_args(d["args"])
                        if lc is not None:
                            total = max(0.0, time.monotonic() - t0)
                            arg_s = min(lifecycle.end_arg_capture(), total)
                            lc["arg_fetch"] = [w0, arg_s]
                            lc["deserialize"] = [w0, max(0.0, total - arg_s)]
                    if lc is not None:
                        t0, w0 = time.monotonic(), time.time()
                    with tracing.activate(d.get("trace_ctx"), d["method"]):
                        with actor.lock:
                            if inspect.iscoroutinefunction(method):
                                value = asyncio.run(method(*args, **kwargs))
                            else:
                                value = method(*args, **kwargs)
                    if lc is not None:
                        lc["exec"] = [w0, max(0.0, time.monotonic() - t0)]
                        t0, w0 = time.monotonic(), time.time()
                    spec = {"task_id": d["task_id"],
                            "num_returns": d.get("num_returns", 1)}
                    result = self._package_returns(spec, value,
                                                   bool(d.get("xlang")))
                    if lc is not None:
                        lc["result_store"] = [
                            w0, max(0.0, time.monotonic() - t0)
                        ]
                        self._lc_emit(d["task_id"], f"{d['method']}()", lc)
                    self._record_task_event(
                        d["task_id"], d["method"], "FINISHED")
                except BaseException as e:  # noqa: BLE001 — to the caller
                    self._record_task_event(d["task_id"], d["method"], "FAILED")
                    result = make_task_error(e)
                post(rfut, result)

        await self.loop.run_in_executor(self.executor, do_run)
        resolve()

    async def _invoke_actor_method(self, actor: ActorState, d) -> dict:
        self._record_task_event(d["task_id"], d["method"], "RUNNING")
        lc: Optional[Dict[str, list]] = {} if d.get("sampled") else None

        def do_call():
            from ray_tpu_torch.util import tracing

            method = getattr(actor.instance, d["method"])
            if d.get("xlang"):
                args, kwargs = tuple(d.get("plain_args") or ()), {}
            else:
                if lc is not None:
                    t0, w0 = time.monotonic(), time.time()
                    lifecycle.begin_arg_capture()
                args, kwargs = self.client.deserialize_args(d["args"])
                if lc is not None:
                    total = max(0.0, time.monotonic() - t0)
                    arg_s = min(lifecycle.end_arg_capture(), total)
                    lc["arg_fetch"] = [w0, arg_s]
                    lc["deserialize"] = [w0, max(0.0, total - arg_s)]

            def invoke():
                t0, w0 = (time.monotonic(), time.time()) if lc is not None \
                    else (0.0, 0.0)
                try:
                    with tracing.activate(d.get("trace_ctx"), d["method"]):
                        if inspect.iscoroutinefunction(method):
                            return asyncio.run(method(*args, **kwargs))
                        return method(*args, **kwargs)
                finally:
                    if lc is not None:
                        lc["exec"] = [w0, max(0.0, time.monotonic() - t0)]

            if actor.max_concurrency == 1:
                # Shares the state lock with compiled-DAG loops so stages
                # and regular calls never mutate actor state concurrently.
                with actor.lock:
                    return invoke()
            return invoke()

        def call_and_package():
            # One executor hop covers both the user call and result
            # packaging (_package_returns may block on the raylet during
            # spill, so neither half may run on the event loop).
            value = do_call()
            spec = {"task_id": d["task_id"], "num_returns": d.get("num_returns", 1)}
            if lc is None:
                return self._package_returns(spec, value, bool(d.get("xlang")))
            t0, w0 = time.monotonic(), time.time()
            out = self._package_returns(spec, value, bool(d.get("xlang")))
            lc["result_store"] = [w0, max(0.0, time.monotonic() - t0)]
            self._lc_emit(d["task_id"], f"{d['method']}()", lc)
            return out

        try:
            result = await self.loop.run_in_executor(
                self.executor, call_and_package
            )
            self._record_task_event(d["task_id"], d["method"], "FINISHED")
            return result
        except BaseException as e:  # noqa: BLE001
            self._record_task_event(d["task_id"], d["method"], "FAILED")
            return make_task_error(e)

    # -- compiled DAG resident loop (do_exec_compiled_task analog,
    # dag/compiled_dag_node.py:34) ---------------------------------------
    async def h_dag_start(self, d, conn):
        actor = self.actor
        if actor is None or actor.actor_id != d["actor_id"]:
            return {"ok": False, "error": "actor not hosted by this worker"}
        try:
            stages = self._bind_dag_stages(d["stages"], actor.instance)
        except Exception as e:  # noqa: BLE001
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}
        stop = threading.Event()
        loop_id = os.urandom(8).hex()
        # Serialize stages with regular actor calls on single-threaded
        # actors: both paths take the actor's state lock.
        lock = actor.lock if actor.max_concurrency == 1 else None
        t = threading.Thread(
            target=self._dag_loop, args=(stages, stop, lock), daemon=True,
            name="rt-dag-loop",
        )
        t.start()
        self._dag_loops.append((loop_id, t, stop))
        return {"ok": True, "loop_id": loop_id}

    async def h_dag_stop(self, d, conn):
        target = d.get("loop_id")
        for loop_id, _, stop in self._dag_loops:
            if target is None or loop_id == target:
                stop.set()
        self._dag_loops = [
            (lid, t, s) for lid, t, s in self._dag_loops if t.is_alive()
        ]
        return {"ok": True}

    @staticmethod
    def _bind_dag_stages(stage_specs, instance):
        import pickle

        from ray_tpu_torch.experimental.channel import Channel

        stages = []
        for spec in stage_specs:
            args = []
            for a in spec["args"]:
                if a["kind"] == "chan":
                    args.append(Channel(name=a["name"]))
                else:
                    args.append(("const", pickle.loads(a["value"])))
            kwargs = {}
            for k, v in spec["kwargs"].items():
                if v["kind"] == "chan":
                    kwargs[k] = Channel(name=v["name"])
                else:
                    kwargs[k] = ("const", pickle.loads(v["value"]))
            stages.append(
                {
                    "method": getattr(instance, spec["method"]),
                    "args": args,
                    "kwargs": kwargs,
                    "outs": [Channel(name=n) for n in spec["out_channels"]],
                }
            )
        return stages

    @staticmethod
    def _dag_loop(stages, stop: threading.Event, state_lock=None):
        from ray_tpu_torch.dag.compiled_dag import _StageError
        from ray_tpu_torch.experimental.channel import Channel, ChannelClosed

        def read_arg(a):
            if isinstance(a, Channel):
                while True:
                    try:
                        return a.read(timeout=0.5)
                    except TimeoutError:
                        if stop.is_set():
                            raise ChannelClosed(a.name) from None
            return a[1]  # ("const", value)

        try:
            while not stop.is_set():
                for stage in stages:
                    args = [read_arg(a) for a in stage["args"]]
                    kwargs = {k: read_arg(v) for k, v in stage["kwargs"].items()}
                    err = next(
                        (x for x in [*args, *kwargs.values()]
                         if isinstance(x, _StageError)),
                        None,
                    )
                    if err is not None:
                        value = err  # propagate without executing
                    else:
                        try:
                            if state_lock is not None:
                                with state_lock:
                                    value = stage["method"](*args, **kwargs)
                            else:
                                value = stage["method"](*args, **kwargs)
                        except BaseException as e:  # noqa: BLE001
                            value = _StageError(e)
                    for out in stage["outs"]:
                        while True:
                            try:
                                out.write(value, timeout=0.5)
                                break
                            except TimeoutError:
                                if stop.is_set():
                                    raise ChannelClosed(out.name) from None
        except ChannelClosed:
            pass
        finally:
            for stage in stages:
                for a in [*stage["args"], *stage["kwargs"].values()]:
                    if isinstance(a, Channel):
                        a.detach()
                for out in stage["outs"]:
                    out.detach()

    async def h_ping(self, d, conn):
        return {"pong": True, "actor": self.actor is not None}


def main():
    log_path = os.environ.get("RT_WORKER_BOOT_LOG")
    if log_path:
        import time

        with open(log_path, "a") as f:
            f.write(f"{os.getpid()} start {time.time()}\n")
    wp = WorkerProcess()
    if log_path:
        import time

        with open(log_path, "a") as f:
            f.write(f"{os.getpid()} constructed {time.time()}\n")
    try:
        asyncio.run(wp.run())
    except (KeyboardInterrupt, asyncio.CancelledError):
        pass


if __name__ == "__main__":
    main()
