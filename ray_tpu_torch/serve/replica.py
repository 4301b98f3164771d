"""Replica actors: host the user callable.

Analog of the reference's ReplicaActor (serve/_private/replica.py:240;
UserCallableWrapper :667; streaming handler :478): wraps the deployment's
class/function, tracks ongoing requests (the queue-length signal the
router and autoscaler consume), executes calls — concurrently on executor
threads when the deployment allows it — and streams generator responses
chunk-by-chunk to pollers.
"""

from __future__ import annotations

import inspect
import itertools
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import ray_tpu_torch as rt
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch.exceptions import (
    ReplicaDrainingError,
    RequestCancelledError,
    ServeOverloadedError,
)
from ray_tpu_torch.serve.context import RequestMeta, bind as bind_meta
from ray_tpu_torch.serve.deployment import Sealed


class _StreamBuf:
    """Chunks produced by a generator request, consumed by long-polls."""

    def __init__(self):
        self.chunks: list = []
        self.done = False
        self.error: Optional[str] = None
        self.cond = threading.Condition()
        self.last_read = time.monotonic()
        self.cancelled = False


@rt.remote
class ReplicaActor:
    def __init__(self, cls_or_fn, init_args, init_kwargs, user_config=None,
                 app_name: str = "", slo=None, max_ongoing: int = 0):
        # serve.run seals user code and arguments for the controller's
        # sake; the replica is where they are opened (and where torch and
        # the CUDA context come up, after the zygote's fork).
        cls_or_fn, init_args, init_kwargs = (
            v.open() if isinstance(v, Sealed) else v
            for v in (cls_or_fn, init_args, init_kwargs))
        self._is_function = not inspect.isclass(cls_or_fn)
        if self._is_function:
            self.callable = cls_or_fn
        else:
            self.callable = cls_or_fn(*init_args, **init_kwargs)
            if user_config is not None and hasattr(
                self.callable, "reconfigure"
            ):
                self.callable.reconfigure(user_config)
        self.ongoing = 0
        self.total_served = 0
        self._streams: Dict[int, _StreamBuf] = {}
        self._stream_ids = itertools.count(1)
        self._lock = threading.Lock()
        # Survival plane: bounded admission (max_ongoing executing +
        # serve_max_queued_per_replica queued streams; 0 = unbounded),
        # the drain latch scale-down flips before this process exits,
        # and the idempotency cache that makes redispatch-after-death
        # safe to send twice.
        self._max_ongoing = int(max_ongoing)
        self._draining = False
        self._idem: "OrderedDict[str, Dict]" = OrderedDict()
        # Label this process's request observatory with the deployment
        # name + declared SLO (one replica per process).
        self._app_name = app_name or type(self.callable).__name__
        from ray_tpu_torch.serve import observatory
        from ray_tpu_torch.util import journal

        observatory.configure(self._app_name, slo)
        journal.set_process_label(f"replica:{self._app_name}")

    def _target(self, method: str):
        if self._is_function:
            return self.callable
        return getattr(self.callable, method or "__call__")

    # -- admission (survival plane) -----------------------------------
    def _admit(self, meta: RequestMeta) -> None:
        """Gate every request BEFORE any work happens: draining replicas
        refuse (handle redispatches like a death), expired deadlines
        cancel (the budget is gone — executing would be dead work), and
        past the bounded queue we shed with a typed 429-shaped error
        instead of letting the backlog collapse."""
        from ray_tpu_torch.serve import observatory

        if self._draining:  # rtlint: disable=RT010 — racy fast-path refusal by design: drain's lock-guarded ongoing check is the real fence
            observatory.record_shed(self._app_name, meta.tenant, "draining")
            raise ReplicaDrainingError(
                f"replica for {self._app_name!r} is draining",
                app=self._app_name,
            )
        if meta.expired():
            observatory.record_deadline_expired(self._app_name, "replica")
            raise RequestCancelledError(
                f"deadline expired before replica execution "
                f"(rid={meta.rid or '-'})",
                reason="deadline", app=self._app_name, rid=meta.rid,
            )
        if self._max_ongoing > 0:
            bound = (self._max_ongoing
                     + get_config().serve_max_queued_per_replica)
            with self._lock:
                cur = self.ongoing
            if cur >= bound:
                observatory.record_shed(
                    self._app_name, meta.tenant, "queue_full"
                )
                raise ServeOverloadedError(
                    f"replica admission queue full "
                    f"({cur} ongoing >= {bound})",
                    app=self._app_name, tenant=meta.tenant,
                    reason="queue_full",
                )

    # -- idempotency (safe redispatch) --------------------------------
    def _idem_claim(self, key: str) -> Optional[Dict]:
        """Claim or join an idempotency entry. Returns None when this
        call is the owner (it must execute and publish via
        _idem_publish); otherwise the existing entry to wait on."""
        with self._lock:
            entry = self._idem.get(key)
            if entry is not None:
                self._idem.move_to_end(key)
                return entry
            self._idem[key] = {
                "evt": threading.Event(), "value": None, "error": None,
            }
            while len(self._idem) > get_config().serve_idem_cache_size:
                self._idem.popitem(last=False)
            return None

    def _idem_publish(self, key: str, value=None, error=None) -> None:
        """Publish the owner's outcome. Successes stay cached (bounded
        LRU) so a duplicate redispatch returns the SAME result; errors
        are handed to current waiters but evicted so a later retry
        re-executes."""
        with self._lock:
            entry = self._idem.get(key)
            if entry is None:
                return
            entry["value"] = value
            entry["error"] = error
            entry["evt"].set()
            if error is not None:
                self._idem.pop(key, None)

    def _idem_join(self, entry: Dict, meta: RequestMeta):
        """Wait (deadline-bounded) for the owning execution's outcome."""
        budget = meta.remaining()
        timeout = get_config().serve_result_timeout_s
        if budget != float("inf"):
            timeout = max(0.01, min(timeout, budget))
        if not entry["evt"].wait(timeout=timeout):
            raise RequestCancelledError(
                "timed out joining the in-flight duplicate of this "
                f"request (idem_key race, rid={meta.rid or '-'})",
                reason="deadline", app=self._app_name, rid=meta.rid,
            )
        if entry["error"] is not None:
            raise entry["error"]
        return entry["value"]

    def handle_request(self, method: str, args, kwargs, model_id: str = "",
                       trace_ctx: Optional[Dict[str, str]] = None,
                       obs_ctx: Optional[Dict] = None,
                       meta: Optional[Dict] = None):
        """Execute one request (reference: replica.py handle_request).

        ``meta`` is the survival-plane wire dict (deadline, tenant,
        idem_key): admission is gated on it, and it is bound to the
        request thread so engine code the callable reaches can read the
        deadline without plumbing."""
        from ray_tpu_torch.serve.multiplex import _set_request_model_id
        from ray_tpu_torch.serve import observatory
        from ray_tpu_torch.util import tracing

        rmeta = RequestMeta.from_wire(meta)
        self._admit(rmeta)
        # Idempotent redispatch: a duplicate of an already-seen logical
        # request joins/returns the original execution instead of
        # running twice (a retry after ActorUnavailableError may race a
        # still-executing first attempt).
        if rmeta.idem_key:
            entry = self._idem_claim(rmeta.idem_key)
            if entry is not None:
                return self._idem_join(entry, rmeta)
        with self._lock:
            self.ongoing += 1
        octx = observatory.begin(obs_ctx, self._app_name, method)
        try:
            _set_request_model_id(model_id)
            target = self._target(method)
            with tracing.activate(
                trace_ctx,
                f"serve.{type(self.callable).__name__}"
                f".{method or '__call__'}",
            ), bind_meta(rmeta):
                if inspect.iscoroutinefunction(target):
                    import asyncio

                    out = asyncio.run(target(*args, **kwargs))
                else:
                    out = target(*args, **kwargs)
            if rmeta.idem_key:
                self._idem_publish(rmeta.idem_key, value=out)
            return out
        except BaseException as e:  # noqa: BLE001 — published then re-raised
            if rmeta.idem_key:
                self._idem_publish(rmeta.idem_key, error=e)
            raise
        finally:
            observatory.finish(octx)
            _set_request_model_id("")
            with self._lock:
                self.ongoing -= 1
                self.total_served += 1

    # -- streaming (reference: handle_request_streaming, replica.py:478) --
    def start_stream(self, method: str, args, kwargs,
                     model_id: str = "",
                     trace_ctx: Optional[Dict[str, str]] = None,
                     obs_ctx: Optional[Dict] = None,
                     meta: Optional[Dict] = None) -> int:
        """Begin a generator request; returns a stream id to poll."""
        rmeta = RequestMeta.from_wire(meta)
        self._admit(rmeta)
        sid = next(self._stream_ids)
        buf = _StreamBuf()
        with self._lock:
            self._streams[sid] = buf
            self.ongoing += 1

        def run():
            from ray_tpu_torch.serve.multiplex import _set_request_model_id
            from ray_tpu_torch.serve import observatory
            from ray_tpu_torch.util import tracing

            # begin() in THIS thread: the generator body (and its
            # engine submit()) executes here, so thread-local capture
            # lands the engine's marks on this request's card.
            octx = observatory.begin(obs_ctx, self._app_name, method)
            try:
                _set_request_model_id(model_id)
                with tracing.activate(
                    trace_ctx,
                    f"serve.{type(self.callable).__name__}"
                    f".{method or '__call__'} [stream]",
                ), bind_meta(rmeta):
                    gen = self._target(method)(*args, **kwargs)
                    for chunk in gen:
                        # Abandoning the for-loop closes `gen`
                        # (GeneratorExit reaches engine-backed streams'
                        # cancel path via LLMReplica.stream).
                        if buf.cancelled:
                            gen.close()
                            raise RequestCancelledError(
                                f"stream {sid} cancelled by caller",
                                reason="client", app=self._app_name,
                                rid=rmeta.rid,
                            )
                        if rmeta.expired():
                            gen.close()
                            observatory.record_deadline_expired(
                                self._app_name, "replica"
                            )
                            raise RequestCancelledError(
                                f"deadline expired mid-stream "
                                f"(stream {sid})",
                                reason="deadline", app=self._app_name,
                                rid=rmeta.rid,
                            )
                        with buf.cond:
                            buf.chunks.append(chunk)
                            buf.cond.notify_all()
            except BaseException as e:  # noqa: BLE001 — crosses the wire
                with buf.cond:
                    buf.error = f"{type(e).__name__}: {e}"
            finally:
                observatory.finish(octx)
                _set_request_model_id("")
                with buf.cond:
                    buf.done = True
                    buf.cond.notify_all()
                with self._lock:
                    self.ongoing -= 1
                    self.total_served += 1

        threading.Thread(target=run, daemon=True).start()
        return sid

    def cancel_stream(self, stream_id: int) -> bool:
        """Caller-side stream cancellation: flips the buffer's cancel
        latch (the producer thread notices at its next chunk boundary,
        closes the generator — engine streams free their decode slot via
        GeneratorExit -> GenerationHandle.cancel) and wakes any poller."""
        # start_stream registers under the lock from other request
        # threads; read under it too so a cancel can never miss a
        # stream whose registration is mid-flight.
        with self._lock:
            buf = self._streams.get(stream_id)
        if buf is None:
            return False
        with buf.cond:
            buf.cancelled = True
            buf.cond.notify_all()
        return True

    def next_chunks(self, stream_id: int, start: int,
                    max_wait_s: float = 2.0) -> Dict:
        """Long-poll chunks [start:]; returns {chunks, done, error}."""
        # Same rationale as cancel_stream: registration happens under
        # the lock on another request thread.
        with self._lock:
            buf = self._streams.get(stream_id)
        if buf is None:
            return {"chunks": [], "done": True,
                    "error": f"unknown stream {stream_id}"}
        with buf.cond:
            if len(buf.chunks) <= start and not buf.done:
                buf.cond.wait(timeout=max_wait_s)
            out = buf.chunks[start:]
            done = buf.done and start + len(out) >= len(buf.chunks)
            err = buf.error
            buf.last_read = time.monotonic()
        if done:
            with self._lock:
                self._streams.pop(stream_id, None)
        else:
            self._gc_streams()
        return {"chunks": out, "done": done, "error": err}

    def _gc_streams(self, idle_s: float = 300.0):
        now = time.monotonic()
        with self._lock:
            stale = [
                sid for sid, b in self._streams.items()
                if b.done and now - b.last_read > idle_s
            ]
            for sid in stale:
                self._streams.pop(sid, None)

    def queue_len(self) -> int:
        """Queue-length probe (reference: power-of-two router probes)."""
        return self.ongoing  # rtlint: disable=RT010 — racy probe by design (power-of-two routing tolerates staleness)

    def drain(self, timeout_s: Optional[float] = None) -> Dict:
        """Graceful drain: stop admitting (new requests see
        ReplicaDrainingError and redispatch elsewhere), then wait —
        bounded by serve_drain_timeout_s — for in-flight requests to
        finish. The controller calls this before killing the process on
        scale-down/replace, so accepted requests complete instead of
        dying with the actor. Returns {drained, duration_s, remaining}."""
        from ray_tpu_torch.serve import observatory

        if timeout_s is None:
            timeout_s = get_config().serve_drain_timeout_s
        with self._lock:
            self._draining = True
        t0 = time.monotonic()
        deadline = t0 + max(0.0, float(timeout_s))
        while time.monotonic() < deadline:
            with self._lock:
                if self.ongoing <= 0:
                    break
            time.sleep(0.02)
        dur = time.monotonic() - t0
        with self._lock:
            remaining = self.ongoing
        observatory.record_drain(self._app_name, dur)
        return {"drained": remaining <= 0, "duration_s": dur,
                "remaining": remaining}

    def is_draining(self) -> bool:
        return self._draining

    def stats(self) -> Dict:
        out = {"ongoing": self.ongoing, "total_served": self.total_served}  # rtlint: disable=RT010 — stats snapshot: torn reads are acceptable
        # Batch-size observability for @serve.batch methods.
        if not self._is_function:
            sizes = {}
            for k, v in self.callable.__dict__.items():
                if k.startswith("__serve_batch_queue_"):
                    sizes[k.removeprefix("__serve_batch_queue_")] = list(
                        v.batch_sizes
                    )
            if sizes:
                out["batch_sizes"] = sizes
        return out

    def observatory_records(self) -> List[Dict]:
        """Finished-request phase records from this replica's
        observatory ring (bounded by RT_SERVE_OBS_RING). The loadgen
        reconciler joins these by rid against client stamp cards to
        compute per-request unattributed gaps."""
        from ray_tpu_torch.serve import observatory

        return observatory.profiler().records()

    def observatory_snapshot(self) -> Dict:
        """Per-replica half of ServeSignals (controller merges these
        across replicas each publish tick)."""
        from ray_tpu_torch.serve import observatory

        snap = observatory.profiler().snapshot()
        snap["ongoing"] = self.ongoing
        snap["total_served"] = self.total_served
        snap["draining"] = self._draining
        # Engine-backed deployments contribute occupancy/backlog/HOL.
        if not self._is_function:
            engine = getattr(self.callable, "engine", None)
            if engine is not None and hasattr(engine, "stats"):
                try:
                    es = engine.stats()
                    snap["engine"] = {
                        "active": es.get("active"),
                        "waiting": es.get("waiting"),
                        "prefilling": es.get("prefilling"),
                        "occupancy": es.get("latency", {}).get("occupancy"),
                        "hol": es.get("hol"),
                        "kv": es.get("kv"),
                    }
                except Exception:  # rtlint: disable=RT007 — snapshot is best-effort
                    pass
        return snap

    def reconfigure(self, user_config):
        if hasattr(self.callable, "reconfigure"):
            self.callable.reconfigure(user_config)
        return True

    def health_check(self) -> bool:
        if hasattr(self.callable, "check_health"):
            self.callable.check_health()
        return True
