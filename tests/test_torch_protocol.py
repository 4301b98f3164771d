"""Wire-protocol unit tests: framed RPC, raw binary responses, write
coalescing/atomicity.

Reference analogs: src/ray/rpc/grpc_server.h request/response framing and
the object-manager chunk streaming path (object_manager.cc) that the
BinResponse fast path replaces.
"""

import asyncio

import pytest

from ray_tpu_torch._private.protocol import (
    BinResponse,
    RpcServer,
    connect,
)


def run(coro):
    return asyncio.run(coro)


def test_basic_call_roundtrip():
    async def main():
        srv = RpcServer()

        async def echo(d, conn):
            return {"got": d}

        srv.register("echo", echo)
        port = await srv.start()
        conn = await connect("127.0.0.1", port)
        try:
            out = await conn.call("echo", {"x": 1, "b": b"\x00\xff"})
            assert out == {"got": {"x": 1, "b": b"\x00\xff"}}
        finally:
            await conn.close()
            await srv.stop()

    run(main())


def test_bin_response_payload_rides_raw():
    """A BinResponse handler returns (header, raw payload) to the caller
    — the payload bytes follow the frame without a msgpack pass."""

    async def main():
        srv = RpcServer()
        payload = bytes(range(256)) * 1024  # 256KB, all byte values

        async def fetch(d, conn):
            off, n = d["offset"], d["size"]
            return BinResponse({"n": n}, payload[off:off + n])

        srv.register("fetch", fetch)
        port = await srv.start()
        conn = await connect("127.0.0.1", port)
        try:
            header, data = await conn.call(
                "fetch", {"offset": 1000, "size": 70000}
            )
            assert header == {"n": 70000}
            assert data == payload[1000:71000]
        finally:
            await conn.close()
            await srv.stop()

    run(main())


def test_bin_responses_interleaved_with_small_frames():
    """Concurrent bin responses + ordinary responses on ONE connection
    must never interleave a foreign frame between a bin header and its
    payload (send_pair atomicity)."""

    async def main():
        srv = RpcServer()
        blob = b"\xab" * (300 * 1024)

        async def big(d, conn):
            return BinResponse({"k": d["k"]}, blob)

        async def small(d, conn):
            return {"k": d["k"]}

        srv.register("big", big)
        srv.register("small", small)
        port = await srv.start()
        conn = await connect("127.0.0.1", port)
        try:
            calls = []
            for i in range(40):
                if i % 3 == 0:
                    calls.append(conn.call("big", {"k": i}))
                else:
                    calls.append(conn.call("small", {"k": i}))
            results = await asyncio.gather(*calls)
            for i, r in enumerate(results):
                if i % 3 == 0:
                    header, data = r
                    assert header == {"k": i}
                    assert data == blob
                else:
                    assert r == {"k": i}
        finally:
            await conn.close()
            await srv.stop()

    run(main())


def test_error_propagates_and_connection_survives():
    async def main():
        srv = RpcServer()

        async def boom(d, conn):
            raise ValueError("kapow")

        async def ok(d, conn):
            return 7

        srv.register("boom", boom)
        srv.register("ok", ok)
        port = await srv.start()
        conn = await connect("127.0.0.1", port)
        try:
            from ray_tpu_torch._private.protocol import RpcError

            with pytest.raises(RpcError, match="kapow"):
                await conn.call("boom", {})
            assert await conn.call("ok", {}) == 7
        finally:
            await conn.close()
            await srv.stop()

    run(main())


def test_large_frame_respects_stream_limit():
    """Frames far beyond asyncio's 64KiB default reader limit flow
    through (rpc_stream_buffer_limit raises it)."""

    async def main():
        srv = RpcServer()

        async def jumbo(d, conn):
            return {"data": b"z" * (8 * 1024 * 1024)}

        srv.register("jumbo", jumbo)
        port = await srv.start()
        conn = await connect("127.0.0.1", port)
        try:
            out = await conn.call("jumbo", {})
            assert len(out["data"]) == 8 * 1024 * 1024
        finally:
            await conn.close()
            await srv.stop()

    run(main())
