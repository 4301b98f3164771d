"""HTTP proxy: the ingress data plane. Counterpart of ray_tpu/serve/proxy.py.

Analog of the reference's ProxyActor/HTTPProxy (serve/_private/proxy.py:1115
/ :759, uvicorn+starlette). JSON requests POSTed to
/{app_name} route through a DeploymentHandle; the response resolves
WITHOUT holding a thread per in-flight request (the round-1 weakness): the
actor-call completion future is awaited on the event loop. Streaming
deployments (`?stream=1` or `Accept: text/event-stream`) are served as
Server-Sent Events; the `serve_multiplexed_model_id` header tags requests
for model multiplexing (reference: serve/_private/proxy.py header of the
same name).

Survival plane (PR 8): typed serve failures map to distinct HTTP codes —
429 + Retry-After for admission shed (ServeOverloadedError: retryable,
the request was never executed), 503 + Retry-After for replica death
mid-request (retryable: redispatch exhausted its attempts), 504 for
deadline expiry (NOT retryable: the budget is gone) — instead of a
generic 500, so clients and load balancers can tell "back off" from
"try another instance" from "give up". Every response increments
`serve_http_responses_total{app,code}` and lands one access-log line
tagged with the outcome kind.

The `serve_deadline_ms` request header sets the request's end-to-end
budget: the proxy converts it to an absolute deadline that propagates
handle -> replica -> engine.

The JAX package's proxy is built on aiohttp. This one is built on the
standard library: `asyncio.start_server` and a small HTTP/1.1 parser
(`_read_request`), so the same proxy runs on a host without aiohttp and
its dependencies. It keeps the routes (`POST /{app}`, `GET /-/healthz`),
the JSON bodies, the status codes with `Retry-After`, and the SSE framing
(`data: <json>` events, a terminal `event: error`, chunked transfer), and
answers an unknown path with 404 and a wrong method with 405 as aiohttp
does. Connections are kept alive unless the client asks to close.
"""

from __future__ import annotations

import asyncio
import json
import logging
import math
import threading
import time
from typing import Dict, Optional, Tuple

import ray_tpu_torch as rt
from ray_tpu_torch._private.http11 import (
    _MAX_BODY_BYTES,  # noqa: F401 — the proxy's body limit (413 past it)
    _BadRequest,
    _head,
    _json_response,
    _read_request,
    _Request,
    _text_response,
    _TooLarge,  # noqa: F401
)
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch.exceptions import (
    ActorError,
    GetTimeoutError,
    PromptTooLongError,
    RequestCancelledError,
    ServeOverloadedError,
    TaskError,
    WorkerCrashedError,
)

logger = logging.getLogger("ray_tpu_torch.serve.proxy")

_metrics_lock = threading.Lock()
_metrics: Optional[Dict] = None


def _proxy_metrics() -> Dict:
    global _metrics
    with _metrics_lock:
        if _metrics is None:
            from ray_tpu_torch.util import metrics as _mx

            _metrics = {
                "responses": _mx.get_or_create(
                    _mx.Counter, "serve_http_responses_total",
                    "HTTP responses by status code (200 ok, 413 prompt "
                    "too long, 429 shed, 503 replica death, 504 deadline, "
                    "500 other), per app",
                    tag_keys=("app", "code"),
                ),
            }
        return _metrics


def _classify_error(e: BaseException):
    """(status, retry_after_s | None, kind) for a failed serve request.

    Typed serve errors usually arrive WRAPPED in TaskError (they were
    raised inside the replica); classification looks through to the
    cause, falling back to cause_cls_name when the cause did not
    unpickle."""
    cause = getattr(e, "cause", None) if isinstance(e, TaskError) else e
    cause_name = (getattr(e, "cause_cls_name", "")
                  if isinstance(e, TaskError) else type(e).__name__)
    if isinstance(cause, ServeOverloadedError) or (
            cause_name == "ServeOverloadedError"):
        retry = getattr(cause, "retry_after_s", 1.0) or 1.0
        return 429, retry, "shed"
    if isinstance(cause, RequestCancelledError) or (
            cause_name == "RequestCancelledError"):
        return 504, None, "deadline"
    if isinstance(cause, PromptTooLongError) or (
            cause_name == "PromptTooLongError"):
        # 413: structural rejection — retrying the same prompt against
        # the same app cannot succeed, so no Retry-After.
        return 413, None, "prompt_too_long"
    if isinstance(e, (ActorError, WorkerCrashedError)) or (
            cause_name in ("ActorDiedError", "ActorUnavailableError",
                           "WorkerCrashedError")):
        return 503, 1.0, "replica_death"
    if isinstance(e, GetTimeoutError):
        return 504, None, "timeout"
    return 500, None, "error"


def _count_response(app: str, code: int) -> None:
    try:
        _proxy_metrics()["responses"].inc(
            1, tags={"app": app, "code": str(code)}
        )
    except Exception:  # rtlint: disable=RT007 — metrics must never fail a response
        pass


def _route(method: str, path: str) -> Tuple[str, str]:
    """(route, app) for a request: "healthz", "app", or "404"/"405"."""
    if path == "/-/healthz":
        return ("healthz", "") if method in ("GET", "HEAD") else ("405", "")
    seg = path[1:]
    if path.startswith("/") and seg and "/" not in seg:
        return ("app", seg) if method == "POST" else ("405", "")
    return "404", ""


@rt.remote
class ProxyActor:
    def __init__(self, host: str = "127.0.0.1", port: int = 8000):
        from ray_tpu_torch._private.worker import _IN_STORE
        from ray_tpu_torch.serve.handle import DeploymentHandle
        from ray_tpu_torch.util import journal

        journal.set_process_label("proxy")
        self.host = host
        self.port = port
        self._handles: Dict[str, DeploymentHandle] = {}
        self._binary_port: Optional[int] = None
        self._ready = threading.Event()

        def get_handle(app_name: str) -> DeploymentHandle:
            handle = self._handles.get(app_name)
            if handle is None:
                handle = DeploymentHandle(app_name)
                self._handles[app_name] = handle
            return handle

        async def resolve(loop, response, deadline_ts: float = 0.0):
            """Await a DeploymentResponse without burning a thread: the
            completion future resolves on the client loop; only store-kind
            results (rare for JSON responses) fall back to an executor.
            A deadline bounds the await — past it the client gets 504
            instead of a result it no longer wants."""
            ref = response.ref
            if ref._future is not None:
                fut = asyncio.wrap_future(ref._future)
                if deadline_ts:
                    remaining = deadline_ts - time.time()
                    if remaining <= 0:
                        fut.cancel()
                        raise RequestCancelledError(
                            "deadline expired before result",
                            reason="deadline",
                        )
                    try:
                        value = await asyncio.wait_for(fut, timeout=remaining)
                    except asyncio.TimeoutError:
                        raise RequestCancelledError(
                            "deadline expired while awaiting result",
                            reason="deadline",
                        ) from None
                else:
                    value = await fut
                if value is not _IN_STORE:
                    return value
            return await loop.run_in_executor(
                None,
                lambda: rt.get(ref, timeout=get_config().serve_rpc_timeout_s),
            )

        async def handle_request(request: _Request, app_name: str, writer):
            """POST /{app}: writes the response; returns False when the
            connection must close after it."""
            keep = request.keep_alive
            ver = request.version
            model_id = request.headers.get("serve_multiplexed_model_id", "")
            tenant = request.headers.get("serve_tenant", "")
            deadline_ms = request.headers.get("serve_deadline_ms", "")
            want_stream = (
                request.query.get("stream", [""])[-1] == "1"
                or "text/event-stream" in request.headers.get("accept", "")
            )
            try:
                payload = json.loads(request.body.decode("utf-8"))
            except Exception:  # noqa: BLE001 — body may be empty/non-JSON
                logger.debug("request body for %s is not JSON; "
                             "forwarding an empty payload", app_name,
                             exc_info=True)
                payload = None
            loop = asyncio.get_running_loop()
            handle = get_handle(app_name)
            if model_id:
                handle = handle.options(multiplexed_model_id=model_id)
            if tenant:
                # Observatory attribution: per-tenant tokens/SLO burn.
                handle = handle.options(tenant=tenant)
            deadline_ts = 0.0
            if deadline_ms:
                try:
                    budget_s = max(0.001, float(deadline_ms) / 1000.0)
                    handle = handle.options(deadline_s=budget_s)
                    deadline_ts = time.time() + budget_s
                except ValueError:
                    pass  # malformed header: no deadline

            def dispatch(h):  # rtlint: disable=RT009 — the deadline rides the handle itself via .options(deadline_s=budget_s) above
                if isinstance(payload, dict):
                    return h.remote(**payload)
                if payload is None:
                    return h.remote()
                return h.remote(payload)

            try:
                if want_stream:
                    # HTTP/1.1 streams in chunked transfer coding; an
                    # HTTP/1.0 client reads to the close instead.
                    chunked = ver != "HTTP/1.0"
                    head = {"Content-Type": "text/event-stream",
                            "Cache-Control": "no-cache"}
                    if chunked:
                        head["Transfer-Encoding"] = "chunked"
                    else:
                        keep = False
                    if not keep:
                        head["Connection"] = "close"
                    writer.write(_head(200, head, ver))
                    await writer.drain()

                    async def send(data: bytes):
                        if chunked:
                            data = b"%x\r\n%s\r\n" % (len(data), data)
                        writer.write(data)
                        await writer.drain()

                    # After the head no second response can be returned:
                    # mid-stream failures become a terminal SSE error event.
                    try:
                        chunk_iter = await loop.run_in_executor(
                            None, dispatch, handle.options(stream=True)
                        )

                        def pull(it):
                            try:
                                return next(it), False
                            except StopIteration:
                                return None, True

                        it = iter(chunk_iter)
                        while True:
                            chunk, done = await loop.run_in_executor(
                                None, pull, it
                            )
                            if done:
                                break
                            await send(
                                f"data: {json.dumps(chunk)}\n\n".encode()
                            )
                    except (ConnectionError, asyncio.CancelledError):
                        raise
                    except Exception as e:  # noqa: BLE001
                        status, _retry, kind = _classify_error(e)
                        _count_response(app_name, status)
                        logger.info(
                            "POST /%s -> stream error %d (%s): %s",
                            app_name, status, kind, e,
                        )
                        await send(
                            b"event: error\ndata: "
                            + json.dumps(
                                {
                                    "error": f"{type(e).__name__}: {e}",
                                    "status": status,
                                    "kind": kind,
                                }
                            ).encode()
                            + b"\n\n"
                        )
                    else:
                        _count_response(app_name, 200)
                    if chunked:
                        writer.write(b"0\r\n\r\n")
                        await writer.drain()
                    return keep
                # Dispatch is quick (replica pick + actor-call submit);
                # the potentially-long wait is the await below, which
                # holds no thread.
                response = await loop.run_in_executor(None, dispatch, handle)
                result = await resolve(loop, response, deadline_ts)
                _count_response(app_name, 200)
                writer.write(_json_response({"result": result},
                                            keep_alive=keep, version=ver))
            except (ConnectionError, asyncio.CancelledError):
                raise
            except Exception as e:  # noqa: BLE001
                status, retry_after, kind = _classify_error(e)
                headers = {}
                if retry_after is not None:
                    headers["Retry-After"] = str(
                        max(1, math.ceil(retry_after))
                    )
                _count_response(app_name, status)
                # Access log distinguishes shed (429: request never ran,
                # back off) from replica_death (503: retry elsewhere)
                # from deadline (504: budget gone, do not retry).
                logger.info(
                    "POST /%s -> %d (%s): %s", app_name, status, kind, e
                )
                writer.write(_json_response(
                    {"error": f"{type(e).__name__}: {e}", "kind": kind},
                    status=status, keep_alive=keep, headers=headers,
                    version=ver,
                ))
            await writer.drain()
            return keep

        async def on_client(reader, writer):
            """One connection: requests in order until the client closes
            or asks to (HTTP/1.1 keep-alive)."""
            try:
                while True:
                    try:
                        request = await _read_request(reader)
                    except _BadRequest as e:
                        logger.info("bad HTTP request: %s", e)
                        writer.write(_text_response(e.status,
                                                    keep_alive=False))
                        await writer.drain()
                        return
                    if request is None:
                        return
                    route, app_name = _route(request.method, request.path)
                    keep = request.keep_alive
                    ver = request.version
                    if route == "app":
                        keep = await handle_request(request, app_name, writer)
                    elif route == "healthz":
                        out = _json_response({"status": "ok"},
                                             keep_alive=keep, version=ver)
                        if request.method == "HEAD":
                            out = out[:out.index(b"\r\n\r\n") + 4]
                        writer.write(out)
                    elif route == "405":
                        allow = ("GET,HEAD" if request.path == "/-/healthz"
                                 else "POST")
                        writer.write(_text_response(
                            405, keep, {"Allow": allow}, ver))
                    else:
                        writer.write(_text_response(404, keep, version=ver))
                    await writer.drain()
                    if not keep:
                        return
            except (ConnectionError, asyncio.IncompleteReadError):
                pass  # the client went away
            finally:
                writer.close()

        async def h_serve_call(d, conn):
            """Binary-framed ingress (the reference gRPC proxy's role,
            serve/_private/grpc_util.py): length-prefixed msgpack frames —
            the same wire format the C++ client speaks — carrying
            {app, method?, args?, kwargs?, multiplexed_model_id?,
            tenant?}. The result must be msgpack-encodable."""
            app_name = d["app"]
            handle = get_handle(app_name)
            if d.get("method") and d["method"] != "__call__":
                handle = handle.options(method_name=d["method"])
            if d.get("multiplexed_model_id"):
                handle = handle.options(
                    multiplexed_model_id=d["multiplexed_model_id"]
                )
            if d.get("tenant"):
                handle = handle.options(tenant=d["tenant"])
            deadline_ts = 0.0
            if d.get("deadline_ms"):
                budget_s = max(0.001, float(d["deadline_ms"]) / 1000.0)
                handle = handle.options(deadline_s=budget_s)
                deadline_ts = time.time() + budget_s
            args = d.get("args") or []
            kwargs = d.get("kwargs") or {}
            loop = asyncio.get_running_loop()
            try:
                response = await loop.run_in_executor(
                    None, lambda: handle.remote(*args, **kwargs)  # rtlint: disable=RT009 — deadline rides the handle via .options(deadline_s=...) above
                )
                result = await resolve(loop, response, deadline_ts)
            except Exception as e:  # noqa: BLE001
                status, retry_after, kind = _classify_error(e)
                _count_response(app_name, status)
                logger.info(
                    "serve_call %s -> %d (%s): %s", app_name, status, kind, e
                )
                return {
                    "error": f"{type(e).__name__}: {e}",
                    "status": status,
                    "kind": kind,
                    "retry_after_s": retry_after,
                }
            _count_response(app_name, 200)
            return {"result": result}

        def run_server():
            from ray_tpu_torch._private.protocol import RpcServer

            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            server = loop.run_until_complete(
                asyncio.start_server(on_client, self.host, self.port))
            # port=0 -> the OS picked one; report the real port so many
            # proxies can coexist on one test host.
            self.port = server.sockets[0].getsockname()[1]
            brpc = RpcServer(self.host, 0)
            brpc.register("serve_call", h_serve_call)
            loop.run_until_complete(brpc.start())
            self._binary_port = brpc.port
            self._ready.set()
            loop.run_forever()

        self._thread = threading.Thread(target=run_server, daemon=True)
        self._thread.start()
        self._ready.wait(timeout=get_config().serve_ready_timeout_s)

    def address(self):
        return f"http://{self.host}:{self.port}"

    def binary_address(self):
        """(host, port) of the framed-msgpack ingress."""
        return (self.host, self._binary_port)

    def ready(self) -> bool:
        return self._ready.is_set()
