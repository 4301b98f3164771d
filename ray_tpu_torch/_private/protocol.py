"""Wire protocol for control-plane RPC.

The reference uses gRPC with 24 .proto services (src/ray/protobuf/,
src/ray/rpc/grpc_server.h). This runtime uses a leaner scheme suited to the
few-processes-per-host world: length-prefixed msgpack frames over asyncio
TCP streams, with request/response correlation ids and server-push frames
for pubsub. Binary payloads (pickled functions, inlined objects) ride as
msgpack bin values.

Frame layout: u32 length | msgpack map {
    "k": kind ("req" | "resp" | "push"),
    "i": correlation id (int, for req/resp),
    "m": method name (req) or channel (push),
    "d": payload (any msgpack value),
    "e": error string or null (resp),
    "h": optional HLC stamp [physical_us, logical] (util/journal.py) —
         senders tick, receivers merge, so cross-process happens-before
         is recoverable from journal dumps despite host clock skew,
}
"""

from __future__ import annotations

import asyncio
import itertools
import struct
import time
from typing import Any, Awaitable, Callable, Dict, Optional

from ray_tpu_torch._vendor import msgpack

from ray_tpu_torch._private.config import get_config
from ray_tpu_torch.util import journal

_LEN = struct.Struct("<I")

# asyncio holds only weak references to tasks: a fire-and-forget
# ensure_future() whose result is dropped can be garbage-collected
# mid-flight, silently killing the coroutine (observed as RPC handlers
# vanishing while awaiting a forwarded call). Every background task must
# be anchored here until done.
_background_tasks: set = set()


def spawn(coro) -> asyncio.Task:
    """ensure_future with a strong reference for the task's lifetime."""
    task = asyncio.ensure_future(coro)
    _background_tasks.add(task)
    task.add_done_callback(_background_tasks.discard)
    return task


def pack_frame(obj: Any) -> bytes:
    body = msgpack.packb(obj, use_bin_type=True)
    return _LEN.pack(len(body)) + body


class BinResponse:
    """Handler return type for raw-payload responses: the header map rides
    msgpack, the payload follows the frame as raw bytes (no msgpack copy
    on either side — the bulk-transfer path for object chunks)."""

    __slots__ = ("data", "payload")

    def __init__(self, data: Any, payload):
        self.data = data
        self.payload = payload  # bytes / memoryview


class FrameSender:
    """Coalesces small frames into one transport write per loop tick.

    The naive write-then-drain per frame costs one socket syscall (and an
    asyncio.Lock round trip) per message — ~7 syscalls per task on the
    submit path. Queued frames from the same event-loop iteration are
    joined and written once; large frames flush the queue and await
    drain for backpressure (the gRPC write-buffer role,
    src/ray/rpc/grpc_client.h)."""

    __slots__ = ("_writer", "_buf", "_size", "_scheduled", "_lock",
                 "_direct", "_drain")

    def __init__(self, writer: asyncio.StreamWriter):
        cfg = get_config()
        self._direct = cfg.rpc_direct_write_threshold
        self._drain = cfg.rpc_write_buffer_drain
        self._writer = writer
        self._buf: list = []
        self._size = 0
        self._scheduled = False
        self._lock = asyncio.Lock()  # serializes large direct writes only

    def flush(self) -> None:
        self._scheduled = False
        if not self._buf:
            return
        data = b"".join(self._buf)
        self._buf.clear()
        self._size = 0
        self._writer.write(data)

    async def send(self, frame: bytes) -> None:
        if len(frame) >= self._direct:
            async with self._lock:
                self.flush()
                self._writer.write(frame)
                await self._writer.drain()
            return
        if not self._scheduled:
            # First frame this tick: write immediately (ping-pong traffic
            # keeps its latency); laters coalesce until the tick ends.
            self._scheduled = True
            asyncio.get_event_loop().call_soon(self._safe_flush)
            self._writer.write(frame)
        else:
            self._buf.append(frame)
            self._size += len(frame)
        # Real backpressure: when the transport's unsent backlog (a stuck
        # or slow peer) passes the watermark, park this sender in drain()
        # until the kernel accepts it — small frames must not be allowed
        # to grow the buffer without bound.
        transport = self._writer.transport
        if (
            self._size >= self._drain
            or (
                transport is not None
                and transport.get_write_buffer_size() >= self._drain
            )
        ):
            async with self._lock:
                self.flush()
                await self._writer.drain()

    async def send_pair(self, frame: bytes, payload) -> None:
        """Write a header frame + raw payload back-to-back with nothing
        interleaved: both writes happen without a yield point under the
        large-write lock (small sends cannot slip between either — they
        have no await between our two write() calls)."""
        async with self._lock:
            self.flush()
            self._writer.write(frame)
            self._writer.write(payload)
            await self._writer.drain()

    def _safe_flush(self) -> None:
        try:
            self.flush()
        except Exception:  # noqa: BLE001 — peer gone; read side reports it
            pass


async def read_frame(reader: asyncio.StreamReader) -> Any:
    header = await reader.readexactly(4)
    (length,) = _LEN.unpack(header)
    body = await reader.readexactly(length)
    return msgpack.unpackb(body, raw=False, strict_map_key=False)


class RpcError(Exception):
    pass


class ConnectionLost(RpcError):
    pass


class Connection:
    """A bidirectional RPC connection: concurrent requests + push handling."""

    def __init__(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        push_handler: Optional[Callable[[str, Any], None]] = None,
    ):
        self.reader = reader
        self.writer = writer
        self.push_handler = push_handler
        self._ids = itertools.count(1)
        self._pending: Dict[int, asyncio.Future] = {}
        self._closed = False
        self._reader_task = spawn(self._read_loop())
        self._sender = FrameSender(writer)

    async def _read_loop(self):
        try:
            while True:
                frame = await read_frame(self.reader)
                kind = frame.get("k")
                if "h" in frame:
                    journal.observe_wire(frame["h"])
                if kind == "resp":
                    payload = None
                    if frame.get("nb"):
                        # Raw binary payload follows the header frame.
                        payload = await self.reader.readexactly(frame["nb"])
                    fut = self._pending.pop(frame["i"], None)
                    if fut is not None and not fut.done():
                        if frame.get("e"):
                            fut.set_exception(RpcError(frame["e"]))
                        elif payload is not None:
                            fut.set_result((frame.get("d"), payload))
                        else:
                            fut.set_result(frame.get("d"))
                elif kind == "push":
                    if self.push_handler is not None:
                        self.push_handler(frame["m"], frame.get("d"))
        except (asyncio.IncompleteReadError, ConnectionError, asyncio.CancelledError):
            pass
        finally:
            self._closed = True
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionLost("connection closed"))
            self._pending.clear()

    async def call(self, method: str, payload: Any = None, timeout: float = None) -> Any:
        if self._closed:
            raise ConnectionLost("connection closed")
        cid = next(self._ids)
        fut = asyncio.get_event_loop().create_future()
        self._pending[cid] = fut
        obj = {"k": "req", "i": cid, "m": method, "d": payload}
        h = journal.wire_stamp()
        if h is not None:
            obj["h"] = h
        frame = pack_frame(obj)
        await self._sender.send(frame)
        if timeout is not None:
            return await asyncio.wait_for(fut, timeout)
        return await fut

    async def notify(self, method: str, payload: Any = None):
        """Fire-and-forget request (no response expected)."""
        obj = {"k": "req", "i": 0, "m": method, "d": payload}
        h = journal.wire_stamp()
        if h is not None:
            obj["h"] = h
        frame = pack_frame(obj)
        await self._sender.send(frame)

    async def close(self):
        self._closed = True
        self._reader_task.cancel()
        try:
            self._sender._safe_flush()  # same-tick buffered frames
            self.writer.close()
            await self.writer.wait_closed()
        except Exception:
            pass


Handler = Callable[[Any, "ServerConnection"], Awaitable[Any]]


class ServerConnection:
    """Server side of one accepted connection; supports pushes to the peer."""

    def __init__(self, reader, writer):
        self.reader = reader
        self.writer = writer
        self._sender = FrameSender(writer)
        self.meta: Dict[str, Any] = {}  # e.g. node_id / worker_id after register
        self.closed = False

    async def push(self, channel: str, payload: Any):
        if self.closed:
            return
        obj = {"k": "push", "m": channel, "d": payload}
        h = journal.wire_stamp()
        if h is not None:
            obj["h"] = h
        frame = pack_frame(obj)
        try:
            await self._sender.send(frame)
        except (ConnectionError, RuntimeError):
            self.closed = True

    async def respond(self, cid: int, data: Any = None, error: str = None):
        obj = {"k": "resp", "i": cid, "d": data, "e": error}
        h = journal.wire_stamp()
        if h is not None:
            obj["h"] = h
        frame = pack_frame(obj)
        try:
            await self._sender.send(frame)
        except (ConnectionError, RuntimeError):
            self.closed = True

    async def respond_bin(self, cid: int, data: Any, payload):
        """Header frame + raw payload bytes: the payload goes straight to
        the transport — no msgpack pass over the bulk bytes."""
        obj = {"k": "resp", "i": cid, "d": data, "nb": len(payload)}
        h = journal.wire_stamp()
        if h is not None:
            obj["h"] = h
        frame = pack_frame(obj)
        try:
            await self._sender.send_pair(frame, payload)
        except (ConnectionError, RuntimeError):
            self.closed = True


class RpcServer:
    """Dispatches method calls to registered async handlers.

    Analog of the reference's GrpcServer (src/ray/rpc/grpc_server.h) +
    ServerCall dispatch (src/ray/rpc/server_call.h).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self.handlers: Dict[str, Handler] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self.connections: set[ServerConnection] = set()
        self.on_disconnect: Optional[Callable[[ServerConnection], Awaitable[None]]] = None
        # Per-method request counter hook (the stats/metric_defs.h role:
        # per-component rpc volume metrics). Called synchronously with
        # the method name before dispatch.
        self.on_request: Optional[Callable[[str], None]] = None
        # Per-method handler-latency hook: called synchronously with
        # (method, duration_s) after the handler returns or raises. Feeds
        # the GCS's gcs_rpc_* latency histograms; None keeps dispatch
        # timer-free.
        self.on_complete: Optional[Callable[[str, float], None]] = None

    def register(self, method: str, handler: Handler):
        self.handlers[method] = handler

    async def start(self):
        self._server = await asyncio.start_server(
            self._on_client, self.host, self.port,
            limit=get_config().rpc_stream_buffer_limit,
        )
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def _on_client(self, reader, writer):
        conn = ServerConnection(reader, writer)
        self.connections.add(conn)
        try:
            while True:
                frame = await read_frame(reader)
                if frame.get("k") != "req":
                    continue
                spawn(self._dispatch(conn, frame))
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            conn.closed = True
            self.connections.discard(conn)
            if self.on_disconnect is not None:
                try:
                    await self.on_disconnect(conn)
                except Exception:
                    pass
            try:
                conn._sender._safe_flush()  # same-tick buffered frames
                writer.close()
            except Exception:
                pass

    async def _dispatch(self, conn: ServerConnection, frame):
        cid = frame.get("i", 0)
        method = frame.get("m")
        if "h" in frame:
            journal.observe_wire(frame["h"])
        # Count only known methods: a malformed/unknown frame must not
        # plant unbounded (or None) keys in the metrics table.
        if self.on_request is not None and method in self.handlers:
            self.on_request(method)
        handler = self.handlers.get(method)
        if handler is None:
            if cid:
                await conn.respond(cid, error=f"no such method: {method}")
            return
        on_complete = self.on_complete
        t0 = time.monotonic() if on_complete is not None else 0.0
        try:
            try:
                result = await handler(frame.get("d"), conn)
            finally:
                if on_complete is not None:
                    on_complete(method, time.monotonic() - t0)
            if cid:
                if isinstance(result, BinResponse):
                    await conn.respond_bin(cid, result.data, result.payload)
                else:
                    await conn.respond(cid, data=result)
        except Exception as e:  # noqa: BLE001 — errors cross the wire
            import traceback

            if cid:
                await conn.respond(cid, error=f"{type(e).__name__}: {e}\n{traceback.format_exc()}")

    async def stop(self):
        if self._server is not None:
            self._server.close()
        # Close accepted connections as well: peers must observe the death
        # (ConnectionLost) to enter their reconnect paths — a closed
        # listener alone leaves established sockets half-alive. Must happen
        # BEFORE wait_closed(): since 3.12 it waits for handler coroutines,
        # which only exit when their sockets close.
        for conn in list(self.connections):
            conn.closed = True
            try:
                conn.writer.close()
            except Exception:  # noqa: BLE001
                pass
        if self._server is not None:
            try:
                await asyncio.wait_for(self._server.wait_closed(), 2.0)
            except asyncio.TimeoutError:
                pass


async def connect(host: str, port: int, push_handler=None, timeout: float = 10.0) -> Connection:
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(
            host, port, limit=get_config().rpc_stream_buffer_limit
        ),
        timeout,
    )
    return Connection(reader, writer, push_handler)
