"""DeploymentHandle: route requests to replicas.

Analog of the reference's DeploymentHandle (serve/handle.py:830) + Router
(serve/_private/router.py:924, assign_request :1040) with the
PowerOfTwoChoicesReplicaScheduler (:295). Unlike round 1, replica choice
uses HANDLE-LOCAL in-flight counts (sample two replicas, pick the one this
handle has fewer outstanding requests on) — zero probe RPCs on the request
path, which is also how the reference's router tracks queue length client-
side between probes. Requests can be tagged with a multiplexed model id;
those route by stable hash so a model's requests land on the replica that
already has it loaded.

Survival plane (PR 8) layered on the router:

  * Deadlines: ``handle.options(deadline_s=...)`` stamps an ABSOLUTE
    deadline into the request's wire meta; every hop (handle dispatch,
    replica admission, engine queue, decode loop) compares wall clock
    against the same number, so elapsed time is subtracted implicitly
    and expired requests are cancelled instead of executed.
  * Admission shed: when every live replica is already loaded past
    ``max_ongoing + serve_max_queued_per_replica`` by THIS handle's own
    in-flight counts, dispatch fails fast with ServeOverloadedError —
    no RPC, sub-millisecond shed decisions under overload.
  * Idempotency keys: each logical request carries a stable idem_key
    across redispatches, so retry-after-replica-death can safely send
    the same request twice (the replica's idempotency cache joins or
    replays the first execution).
  * Per-replica circuit breaker: consecutive dispatch failures (deaths
    weigh a full threshold, sheds weigh one) open the breaker for
    ``serve_cb_reset_s``; _pick_replica skips open replicas while a
    recent-outcome window ("burn rate" of this handle's own traffic)
    keeps half-open trials honest. All replicas open => serve anyway
    (the breaker protects against SOME sick replicas, not against
    having none).
  * Controller failover: _refresh serves CACHED routes when the
    controller is unreachable (it restarts with max_restarts=-1 and
    republishes); death of a picked replica forces an immediate
    route refetch instead of waiting out the poll TTL.
  * Streaming resume-or-restart: a stream cut by replica death is
    re-started on another replica up to serve_stream_resume_attempts
    times and resumes AT THE CHUNK OFFSET already delivered. Contract:
    the client never sees a duplicated or missing chunk INDEX, but
    chunk CONTENTS are only guaranteed identical for deterministic
    requests (greedy decode); sampled requests may resume with a
    different continuation.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
import zlib
from typing import Any, Dict, List, Optional

import ray_tpu_torch as rt
from ray_tpu_torch._private import chaos
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch.util import journal
from ray_tpu_torch.exceptions import (
    ActorError,
    GetTimeoutError,
    ReplicaDrainingError,
    RequestCancelledError,
    ServeOverloadedError,
    TaskError,
    WorkerCrashedError,
)


logger = logging.getLogger("ray_tpu_torch.serve.handle")


def _is_death(err: BaseException) -> bool:
    """True when an error means the replica process is gone. Death has
    two wire shapes: raised LOCALLY by rt.get (ActorError /
    WorkerCrashedError), or wrapped in TaskError when the death surfaced
    remotely (e.g. the raylet answered 'actor not hosted by this worker'
    for a just-killed replica)."""
    if isinstance(err, (ActorError, WorkerCrashedError)):
        return True
    if isinstance(err, TaskError):
        if isinstance(getattr(err, "cause", None),
                      (ActorError, WorkerCrashedError)):
            return True
        return getattr(err, "cause_cls_name", "") in (
            "ActorDiedError", "ActorUnavailableError", "WorkerCrashedError")
    return False


def _is_draining(err: BaseException) -> bool:
    if not isinstance(err, TaskError):
        return False
    return (isinstance(getattr(err, "cause", None), ReplicaDrainingError)
            or getattr(err, "cause_cls_name", "") == "ReplicaDrainingError")


def _retry_class(err: BaseException):
    """Classify a dispatch failure: (retryable_elsewhere, replica_dead,
    backoff_before_retry). Draining/overloaded replicas are healthy
    processes refusing work — retry another replica immediately (shed)
    or after backoff (overload); deaths force a route refetch + backoff.
    Everything else (user exceptions, deadline cancellations) is NOT
    retryable: the request executed (or its budget is gone)."""
    if _is_death(err):
        return True, True, True
    if isinstance(err, TaskError):
        if _is_draining(err):
            return True, False, False
        cause = getattr(err, "cause", None)
        if isinstance(cause, ServeOverloadedError):
            return True, False, True
        # Unpickleable causes still carry the class name.
        if getattr(err, "cause_cls_name", "") == "ServeOverloadedError":
            return True, False, True
    return False, False, False


class DeploymentResponse:
    """Awaitable-ish response wrapper: `.result()` blocks; `.ref` is the
    underlying ObjectRef (reference: serve/handle.py DeploymentResponse).

    A replica that died mid-request (crash, scale-down, self-healing
    restart) re-dispatches to another replica up to `max_retries` times —
    the reference router's retry-on-replica-failure behavior. Draining
    and overloaded replicas redispatch the same way (they are typed,
    retryable refusals), and `.result()`'s default timeout honors the
    request deadline when one was set instead of the fixed 60 s."""

    def __init__(self, ref, on_done=None, redispatch=None, max_retries=2,
                 deadline_ts: float = 0.0, replica_key: bytes = b"",
                 cb_ok=None, cb_fail=None, rid: str = ""):
        self.ref = ref
        # Observatory request id: joins this response's client-side
        # timing against the server's phase attribution (loadgen
        # reconciler). "" when the observatory is disabled.
        self.rid = rid
        self._redispatch = redispatch
        self._retries_left = max_retries
        self._deadline_ts = deadline_ts
        self._replica_key = replica_key
        self._cb_ok = cb_ok
        self._cb_fail = cb_fail
        if on_done is not None and ref._future is not None:
            ref._future.add_done_callback(lambda _f: on_done())

    def _default_timeout(self) -> float:
        if self._deadline_ts:
            return max(0.01, self._deadline_ts - time.time())
        return 60.0

    def result(self, timeout: Optional[float] = None):
        attempt = 0
        while True:
            t = self._default_timeout() if timeout is None else timeout
            try:
                out = rt.get(self.ref, timeout=t)
                if self._cb_ok is not None:
                    self._cb_ok(self._replica_key)
                return out
            except GetTimeoutError:
                if (timeout is None and self._deadline_ts
                        and time.time() >= self._deadline_ts):
                    raise RequestCancelledError(
                        "request deadline expired while waiting for the "
                        "reply", reason="deadline",
                    ) from None
                raise
            except (ActorError, WorkerCrashedError, TaskError) as e:
                retryable, dead, backoff = _retry_class(e)
                if dead and self._cb_fail is not None:
                    self._cb_fail(self._replica_key, death=True)
                if (not retryable or self._redispatch is None
                        or self._retries_left <= 0):
                    journal.emit(
                        "serve.request_error", error=type(e).__name__,
                        replica=(self._replica_key.hex()
                                 if isinstance(self._replica_key, bytes)
                                 else str(self._replica_key or "")),
                    )
                    raise
            self._retries_left -= 1
            if backoff:
                # Capped exponential backoff with jitter before the next
                # dispatch: when a replica dies under load, every queued
                # caller retries at once — unjittered they'd stampede the
                # survivors (and the controller's route table) in
                # lockstep while self-healing is still replacing it.
                cfg = get_config()
                delay = min(
                    cfg.serve_redispatch_backoff_s * (2 ** attempt),
                    cfg.serve_redispatch_backoff_max_s,
                )
                if delay > 0:
                    time.sleep(delay * (0.5 + 0.5 * random.random()))
            attempt += 1
            self.ref, self._replica_key = self._redispatch()
            journal.emit(
                "serve.redispatch", attempt=attempt,
                replica=(self._replica_key.hex()
                         if isinstance(self._replica_key, bytes)
                         else str(self._replica_key or "")),
            )


class StreamingResponse:
    """Iterator over a streaming call's chunks, carrying the request's
    observatory ``rid`` so client-side witnesses (ray_tpu_torch.loadgen) can
    join their stamp cards against the server's phase attribution.
    Behaves exactly like the bare generator it wraps — existing
    ``for chunk in handle.remote(...)`` consumers are unaffected."""

    __slots__ = ("rid", "_gen")

    def __init__(self, gen, rid: str = ""):
        self._gen = gen
        self.rid = rid

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._gen)

    def close(self):
        self._gen.close()


class DeploymentHandle:
    def __init__(self, app_name: str, method: str = "__call__",
                 multiplexed_model_id: str = "", stream: bool = False,
                 max_retries: int = 2, tenant: str = "",
                 deadline_s: float = 0.0, _shared=None):
        self.app_name = app_name
        self.method = method
        self.multiplexed_model_id = multiplexed_model_id
        self._stream = stream
        # Observatory attribution label: requests from this handle are
        # accounted (tokens, queue time, SLO burn) under this tenant.
        self.tenant = tenant
        # Retry-on-replica-failure count (reference: router retry config).
        # Retries re-dispatch the same args — the idempotency key makes
        # that safe for deployments that opt into the replica-side cache;
        # otherwise semantics stay at-least-once and mutating deployments
        # should set max_retries=0 via .options().
        self.max_retries = max_retries
        # Per-request budget in seconds (0 = serve_default_deadline_s,
        # which itself defaults to "no deadline").
        self.deadline_s = deadline_s
        # Router state shared across .options() copies of this handle.
        if _shared is None:
            _shared = {
                "replicas": [],
                "version": -1,
                "last_refresh": 0.0,
                "inflight": {},  # actor_id -> handle-local outstanding
                "lock": threading.Lock(),
                "subscribed": False,
                "max_ongoing": 0,  # published by the controller's table
                # Prefix-affinity hints (paged KV): actor_id hex -> set
                # of resident first-page prefix hashes, plus the page
                # size the hashes were computed with.
                "prefix": {},
                "page_size": 0,
                # actor_id -> {"fails", "open_until", "window"} — the
                # handle-side circuit breaker ledger.
                "cb": {},
            }
        self._shared = _shared

    def options(self, method_name: Optional[str] = None,
                multiplexed_model_id: Optional[str] = None,
                stream: Optional[bool] = None,
                max_retries: Optional[int] = None,
                tenant: Optional[str] = None,
                deadline_s: Optional[float] = None) -> "DeploymentHandle":
        return DeploymentHandle(
            self.app_name,
            method_name if method_name is not None else self.method,
            (multiplexed_model_id if multiplexed_model_id is not None
             else self.multiplexed_model_id),
            stream if stream is not None else self._stream,
            max_retries if max_retries is not None else self.max_retries,
            tenant if tenant is not None else self.tenant,
            deadline_s if deadline_s is not None else self.deadline_s,
            _shared=self._shared,
        )

    def _controller(self):
        from ray_tpu_torch.serve.controller import CONTROLLER_NAME

        return rt.get_actor(CONTROLLER_NAME)

    def _subscribe_invalidation(self):
        """Push invalidation from the controller (LongPollHost analog):
        a routes push zeroes last_refresh so the NEXT request refetches,
        instead of waiting out the poll TTL. Polling stays as fallback."""
        s = self._shared
        with s["lock"]:
            if s["subscribed"]:
                return
            s["subscribed"] = True
        try:
            from ray_tpu_torch._private import worker as worker_mod

            def on_push(_payload, _s=s):
                with _s["lock"]:
                    _s["last_refresh"] = 0.0

            worker_mod.get_client().subscribe_push(
                f"serve_routes:{self.app_name}", on_push
            )
        except Exception:  # noqa: BLE001 — polling still works
            logger.debug("route-invalidation push subscribe failed for "
                         "app %r; falling back to TTL polling",
                         self.app_name, exc_info=True)

    def _refresh(self, force: bool = False):
        self._subscribe_invalidation()
        s = self._shared
        now = time.monotonic()
        with s["lock"]:
            lr0 = s["last_refresh"]
            if not force and s["replicas"] and now - lr0 < 1.0:
                return
        # Request-dispatch path: rides the data-plane rpc timeout, NOT the
        # deploy-readiness knob (tuning deploys must not break dispatch).
        try:
            info = rt.get(
                self._controller().get_replicas.remote(self.app_name),
                timeout=get_config().serve_rpc_timeout_s,
            )
        except (ActorError, WorkerCrashedError, GetTimeoutError,
                ValueError) as e:
            # Controller dead/restarting (it comes back with
            # max_restarts=-1 and restores from checkpoint): keep
            # serving from the CACHED route table — the data plane must
            # not depend on the control plane being up. Bump
            # last_refresh so we don't hammer a dead controller every
            # request; the next TTL expiry (or a routes push from the
            # restarted controller) retries.
            with s["lock"]:
                if s["replicas"]:
                    s["last_refresh"] = time.monotonic()
                    return
            raise RuntimeError(
                f"serve controller unreachable and no cached routes for "
                f"app {self.app_name!r}"
            ) from e
        with s["lock"]:
            if info["version"] >= s["version"]:
                s["version"] = info["version"]
                s["replicas"] = info["replicas"]
                s["max_ongoing"] = info.get("max_ongoing", 0)
                s["prefix"] = {
                    aid: set(keys)
                    for aid, keys in (info.get("prefix") or {}).items()
                }
                s["page_size"] = info.get("page_size") or 0
            if s["last_refresh"] == lr0:
                s["last_refresh"] = time.monotonic()
            # else: a push invalidation zeroed last_refresh while our RPC
            # was in flight — leave it zeroed so the next request refetches
            # the post-change table instead of trusting this possibly-stale
            # response for a full TTL.
            live = {r._actor_id.binary() for r in s["replicas"]}
            s["inflight"] = {
                k: v for k, v in s["inflight"].items() if k in live
            }
            s["cb"] = {k: v for k, v in s["cb"].items() if k in live}

    # -- circuit breaker ------------------------------------------------
    def _cb_fail(self, key: bytes, death: bool = False):
        """Record a dispatch failure against a replica. Deaths weigh a
        full threshold (an ActorDiedError needs no corroboration);
        sheds/unavailability accumulate. The breaker also opens on the
        recent-outcome window: >= 50% failures over the last
        2*threshold outcomes of THIS handle's traffic (the handle-local
        "burn rate"), which catches a flapping replica whose failures
        never run consecutively. While open, _pick_replica skips the
        replica until serve_cb_reset_s passes (half-open: the next
        pick is the trial; one more failure re-opens instantly because
        the consecutive count stays saturated)."""
        cfg = get_config()
        s = self._shared
        threshold = max(1, cfg.serve_cb_failure_threshold)
        now = time.monotonic()
        with s["lock"]:
            ent = s["cb"].setdefault(
                key, {"fails": 0, "open_until": 0.0, "window": []}
            )
            ent["fails"] += threshold if death else 1
            ent["window"] = (ent["window"] + [False])[-2 * threshold:]
            window = ent["window"]
            burned = (len(window) >= 2 * threshold
                      and window.count(False) * 2 >= len(window))
            opened = ent["fails"] >= threshold or burned
            if opened:
                ent["open_until"] = now + cfg.serve_cb_reset_s
            if death:
                # Stale-route fix: a death observed by a response means
                # the cached table lists a corpse — refetch on the next
                # dispatch instead of waiting out the TTL.
                s["last_refresh"] = 0.0
        from ray_tpu_torch.serve import observatory

        observatory.set_circuit_state(
            self.app_name, key.hex()[:12], 2 if opened else 0
        )

    def _cb_ok(self, key: bytes):
        s = self._shared
        had = False
        with s["lock"]:
            ent = s["cb"].get(key)
            if ent is not None:
                had = ent["fails"] > 0 or ent["open_until"] > 0.0
                ent["fails"] = 0
                ent["open_until"] = 0.0
                ent["window"] = (ent["window"] + [True])[-16:]
        if had:
            from ray_tpu_torch.serve import observatory

            observatory.set_circuit_state(
                self.app_name, key.hex()[:12], 0
            )

    def _open_circuits(self) -> set:
        s = self._shared
        now = time.monotonic()
        with s["lock"]:
            return {k for k, e in s["cb"].items()
                    if e["open_until"] > now}

    # -- routing ---------------------------------------------------------
    def _route_key(self, args) -> Optional[str]:
        """Prefix-affinity routing key for a prompt-shaped first arg:
        the hash of its first KV page (paged_kv.prefix_route_key). None
        whenever affinity doesn't apply — no advertised prefixes, a
        multiplexed handle (model residency outranks cache residency),
        or a first arg that isn't a token sequence spanning a page."""
        s = self._shared
        with s["lock"]:
            page_size = s["page_size"]
            has_prefixes = bool(s["prefix"])
        if (not has_prefixes or not page_size or self.multiplexed_model_id
                or not args):
            return None
        prompt = args[0]
        if not isinstance(prompt, (list, tuple)) and not (
                hasattr(prompt, "ndim") and getattr(prompt, "ndim", 0) == 1):
            return None
        try:
            if len(prompt) < page_size:
                return None
            from ray_tpu_torch.serve._prefix_hash import prefix_route_key

            return prefix_route_key(prompt, page_size)
        except (TypeError, ValueError):  # non-token contents
            return None

    def _pick_replica(self, exclude=frozenset(),
                      route_key: Optional[str] = None):
        """Power-of-two by handle-local in-flight count (router.py:295) —
        no probe RPCs on the request path. Multiplexed requests hash the
        model id to a stable replica so its weights stay resident.
        `route_key`: a prompt's first-page prefix hash — when some
        candidate replica advertises it (its prefix cache holds the
        prompt's opening page), the pick prefers covering replicas (the
        least-loaded of them), so repeat prompts land where their KV
        pages already live and prefill skips them. Falls through to the
        normal pick when nobody covers it.
        `exclude`: actor ids observed dead by a retrying response — skip
        them while the controller's table still lists them. Replicas
        with an OPEN circuit breaker are skipped the same way unless
        every candidate is open (breakers protect against some sick
        replicas, not against having none)."""
        self._refresh()
        s = self._shared
        with s["lock"]:
            replicas = list(s["replicas"])
        open_keys = self._open_circuits()
        live = [r for r in replicas if r._actor_id.binary() not in exclude]
        if not live:
            self._refresh(force=True)
            with s["lock"]:
                replicas = list(s["replicas"])
            live = [r for r in replicas
                    if r._actor_id.binary() not in exclude] or replicas
            if not live:
                raise RuntimeError(
                    f"no running replicas for app {self.app_name!r}"
                )
        closed = [r for r in live
                  if r._actor_id.binary() not in open_keys]
        replicas = closed or live
        if self.multiplexed_model_id:
            idx = zlib.crc32(self.multiplexed_model_id.encode()) % len(replicas)
            return replicas[idx]
        if route_key is not None:
            with s["lock"]:
                pm = dict(s["prefix"])
            covering = [r for r in replicas
                        if route_key in pm.get(r._actor_id.hex(), ())]
            if covering:
                with s["lock"]:
                    return min(
                        covering,
                        key=lambda r: s["inflight"].get(
                            r._actor_id.binary(), 0),
                    )
        if len(replicas) == 1:
            return replicas[0]
        a, b = random.sample(replicas, 2)
        with s["lock"]:
            ia = s["inflight"].get(a._actor_id.binary(), 0)
            ib = s["inflight"].get(b._actor_id.binary(), 0)
        return a if ia <= ib else b

    def _track(self, replica):
        s = self._shared
        key = replica._actor_id.binary()
        with s["lock"]:
            s["inflight"][key] = s["inflight"].get(key, 0) + 1

        def done():
            with s["lock"]:
                n = s["inflight"].get(key, 0) - 1
                if n <= 0:
                    s["inflight"].pop(key, None)
                else:
                    s["inflight"][key] = n

        return done

    # -- survival-plane request metadata ---------------------------------
    def _make_meta(self, rid: str = "") -> Dict[str, Any]:
        """The wire meta every hop reads: an ABSOLUTE deadline (0 = no
        deadline), the tenant label, and an idempotency key that stays
        STABLE across redispatches of this logical request."""
        deadline_s = self.deadline_s or get_config().serve_default_deadline_s
        return {
            "deadline_ts": time.time() + deadline_s if deadline_s > 0
            else 0.0,
            "tenant": self.tenant,
            "idem_key": os.urandom(8).hex(),
            "rid": rid,
        }

    def _shed_check(self, meta: Dict[str, Any]):
        """Handle-side fast shed: if EVERY live replica is already
        loaded past its bound by this handle's own in-flight counts,
        reject in microseconds instead of queueing an RPC that the
        replica would shed anyway. Zero RPCs — this is what keeps shed
        decisions sub-millisecond under a burst."""
        from ray_tpu_torch.serve import observatory

        if meta["deadline_ts"] and time.time() > meta["deadline_ts"]:
            observatory.record_deadline_expired(self.app_name, "handle")
            raise RequestCancelledError(
                "deadline expired before dispatch",
                reason="deadline", app=self.app_name, rid=meta["rid"],
            )
        s = self._shared
        with s["lock"]:
            bound = s.get("max_ongoing", 0)
            if not bound or not s["replicas"]:
                return
            limit = bound + get_config().serve_max_queued_per_replica
            least = min(
                s["inflight"].get(r._actor_id.binary(), 0)
                for r in s["replicas"]
            )
        if least >= limit:
            observatory.record_shed(self.app_name, self.tenant, "queue_full")
            raise ServeOverloadedError(
                f"all replicas of {self.app_name!r} are at their admission "
                f"bound ({least} handle-local in-flight >= {limit})",
                app=self.app_name, tenant=self.tenant, reason="queue_full",
                retry_after_s=min(5.0, max(0.1, 0.02 * least)),
            )

    def remote(self, *args, **kwargs):
        """Dispatch a request; returns a DeploymentResponse (streaming
        handles return an iterator over chunks instead)."""
        from ray_tpu_torch.util import tracing

        if self._stream:
            return self._stream_call(args, kwargs)  # rtlint: disable=RT009 — the streaming path builds its own meta inside _stream_call
        # Serve-path trace propagation: the caller's active span (or a
        # fresh root when tracing is enabled) rides the request so the
        # replica's execution joins the request's span tree.
        from ray_tpu_torch.serve import observatory

        obs_ctx = observatory.make_wire_ctx(self.tenant)
        meta = self._make_meta(rid=obs_ctx["rid"] if obs_ctx else "")
        trace_ctx = tracing.inject()
        # Chaos: deterministic dispatch stall (deadline tests burn the
        # budget at this hop on purpose).
        injected = chaos.take_dispatch_delay()
        if injected:
            time.sleep(injected)
        self._refresh()
        self._shed_check(meta)
        route_key = self._route_key(args)
        replica = self._pick_replica(route_key=route_key)
        done = self._track(replica)
        if obs_ctx is not None:
            # handle_queue ends here: routing done, dispatching now.
            obs_ctx["disp_t"] = time.time()
        ref = replica.handle_request.remote(
            self.method, args, kwargs, self.multiplexed_model_id, trace_ctx,
            obs_ctx, meta,
        )

        failed = {replica._actor_id.binary()}

        def redispatch():
            # The chosen replica refused or died: drop the cached route
            # table, pick a replica we haven't seen fail (the
            # controller's table may still list the dead one while
            # self-healing replaces it). The SAME meta rides along —
            # notably the idem_key, so a request the dead replica
            # half-finished cannot execute twice where it matters.
            self._refresh(force=True)
            r = self._pick_replica(exclude=frozenset(failed),
                                   route_key=route_key)
            failed.add(r._actor_id.binary())
            d = self._track(r)
            if obs_ctx is not None:
                # Re-dispatch restarts the wire leg; the backoff before
                # it stays attributed to handle_queue-side waiting.
                obs_ctx["disp_t"] = time.time()
            new_ref = r.handle_request.remote(
                self.method, args, kwargs, self.multiplexed_model_id,
                trace_ctx, obs_ctx, meta,
            )
            if new_ref._future is not None:
                new_ref._future.add_done_callback(lambda _f: d())
            return new_ref, r._actor_id.binary()

        return DeploymentResponse(
            ref, on_done=done, redispatch=redispatch,
            max_retries=self.max_retries,
            deadline_ts=meta["deadline_ts"],
            replica_key=replica._actor_id.binary(),
            cb_ok=self._cb_ok, cb_fail=self._cb_fail,
            rid=meta["rid"],
        )

    def _stream_call(self, args, kwargs):
        """Generator deployment: yields chunks as the replica produces
        them (reference: handle_request_streaming, replica.py:478).

        Resume-or-restart: when the serving replica dies mid-stream the
        generator re-starts the request on another replica (same meta,
        same idem_key) and fast-forwards to the chunk offset already
        delivered, up to serve_stream_resume_attempts times. The client
        sees a contiguous chunk sequence; contents of the re-generated
        prefix are only guaranteed to match for DETERMINISTIC requests
        (greedy decode) — sampled requests may continue differently."""
        from ray_tpu_torch.serve import observatory
        from ray_tpu_torch.util import tracing

        obs_ctx = observatory.make_wire_ctx(self.tenant)
        meta = self._make_meta(rid=obs_ctx["rid"] if obs_ctx else "")
        trace_ctx = tracing.inject()
        injected = chaos.take_dispatch_delay()
        if injected:
            time.sleep(injected)
        self._refresh()
        self._shed_check(meta)
        route_key = self._route_key(args)

        def start_on(replica):
            if obs_ctx is not None:
                obs_ctx["disp_t"] = time.time()
            return rt.get(
                replica.start_stream.remote(
                    self.method, args, kwargs, self.multiplexed_model_id,
                    trace_ctx, obs_ctx, meta,
                ),
                timeout=get_config().serve_rpc_timeout_s,
            )

        # Dead replicas this logical request has observed; picks exclude
        # them. The resume-attempt budget is shared between dispatch-time
        # deaths (the picked replica died before start_stream landed) and
        # mid-stream deaths.
        failed: set = set()
        attempts = [0]

        def start_fresh():
            """Pick a replica and start the request on it, retrying past
            dead (or draining) picks until the resume budget runs out."""
            while True:
                r = self._pick_replica(exclude=frozenset(failed),
                                       route_key=route_key)
                try:
                    return r, start_on(r)
                except (ActorError, WorkerCrashedError, TaskError) as e:
                    if _is_death(e):
                        self._cb_fail(r._actor_id.binary(), death=True)
                    elif not _is_draining(e):
                        raise
                    failed.add(r._actor_id.binary())
                    if attempts[0] >= (
                            get_config().serve_stream_resume_attempts):
                        raise
                    attempts[0] += 1
                    self._refresh(force=True)

        replica, sid = start_fresh()

        def gen():
            nonlocal replica, sid
            start = 0
            while True:
                try:
                    out = rt.get(
                        replica.next_chunks.remote(sid, start),  # rtlint: disable=RT009 — chunk pulls ride the stream registered with meta at start_stream; each pull is rpc-timeout bounded
                        timeout=get_config().serve_rpc_timeout_s,
                    )
                except (ActorError, WorkerCrashedError, TaskError) as e:
                    if not _is_death(e):
                        raise
                    self._cb_fail(replica._actor_id.binary(), death=True)
                    failed.add(replica._actor_id.binary())
                    if attempts[0] >= (
                            get_config().serve_stream_resume_attempts):
                        raise
                    attempts[0] += 1
                    self._refresh(force=True)
                    # Restart the request; next_chunks(sid, start) below
                    # skips the chunks the client already consumed.
                    replica, sid = start_fresh()
                    journal.emit(
                        "serve.stream_resume", app=self.app_name,
                        rid=meta["rid"], offset=start,
                        attempt=attempts[0],
                        replica=replica._actor_id.hex(),
                    )
                    continue
                for c in out["chunks"]:
                    yield c
                start += len(out["chunks"])
                if out["error"]:
                    raise RuntimeError(
                        f"stream failed in replica: {out['error']}"
                    )
                if out["done"]:
                    self._cb_ok(replica._actor_id.binary())
                    return

        return StreamingResponse(gen(), rid=meta["rid"])

    def __reduce__(self):
        # Router state (locks, in-flight counts) is process-local: a handle
        # shipped to another process (deployment composition) starts fresh.
        return (
            DeploymentHandle,
            (self.app_name, self.method, self.multiplexed_model_id,
             self._stream, self.max_retries, self.tenant, self.deadline_s),
        )

    def __call__(self, *args, **kwargs):
        raise TypeError("use handle.remote(...) for deployment calls")
