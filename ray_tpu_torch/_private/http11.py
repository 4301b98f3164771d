"""A small HTTP/1.1 server side on the standard library, shared by the
Serve proxy (`serve/proxy.py`) and the dashboard (`dashboard/`): the
request parser (`_read_request`: Content-Length or chunked bodies) and
the response writers, with aiohttp's limits, content types and error
bodies, so the port needs no aiohttp."""

from __future__ import annotations

import asyncio
import http
import json
from typing import Dict, Optional
from urllib.parse import parse_qs, unquote, urlsplit

_MAX_HEADER_BYTES = 64 * 1024
# aiohttp's default client_max_size: a larger body is refused with 413.
_MAX_BODY_BYTES = 1024 ** 2


class _BadRequest(Exception):
    status = 400


class _TooLarge(_BadRequest):
    status = 413


class _Request:
    __slots__ = ("method", "path", "query", "version", "headers", "body")

    def __init__(self, method, path, query, version, headers, body):
        self.method = method
        self.path = path
        self.query = query
        self.version = version
        self.headers = headers  # lower-cased names
        self.body = body

    @property
    def keep_alive(self) -> bool:
        conn = self.headers.get("connection", "").lower()
        if self.version == "HTTP/1.0":
            return conn == "keep-alive"
        return conn != "close"


async def _read_request(reader) -> Optional[_Request]:
    """One HTTP/1.1 request off the stream (None at a clean EOF). Bodies
    come by Content-Length or chunked transfer coding."""
    try:
        return await _parse_request(reader)
    except (ValueError, asyncio.IncompleteReadError) as e:
        # A line past the stream's limit, a bad length or a body cut short.
        raise _BadRequest(f"bad request: {e}") from None


async def _parse_request(reader) -> Optional[_Request]:
    line = await reader.readline()
    if not line:
        return None
    try:
        method, target, version = line.decode("latin-1").split()
    except ValueError:
        raise _BadRequest(f"bad request line {line[:80]!r}") from None
    if not version.startswith("HTTP/1."):
        raise _BadRequest(f"unsupported version {version!r}")
    headers: Dict[str, str] = {}
    size = 0
    while True:
        raw = await reader.readline()
        size += len(raw)
        if size > _MAX_HEADER_BYTES:
            raise _BadRequest("headers too large")
        if raw in (b"\r\n", b"\n", b""):
            break
        name, sep, value = raw.decode("latin-1").partition(":")
        if not sep:
            raise _BadRequest(f"bad header line {raw[:80]!r}")
        headers[name.strip().lower()] = value.strip()
    if "chunked" in headers.get("transfer-encoding", "").lower():
        parts, total = [], 0
        while True:
            n = int((await reader.readline()).split(b";")[0], 16)
            if n == 0:
                while (await reader.readline()) not in (b"\r\n", b"\n", b""):
                    pass  # trailers
                break
            total += n
            if total > _MAX_BODY_BYTES:
                raise _TooLarge(f"body over {_MAX_BODY_BYTES} bytes")
            parts.append(await reader.readexactly(n))
            await reader.readline()
        body = b"".join(parts)
    else:
        n = int(headers.get("content-length") or 0)
        if n > _MAX_BODY_BYTES:
            raise _TooLarge(f"body of {n} bytes")
        body = await reader.readexactly(n)
    url = urlsplit(target)
    return _Request(method.upper(), unquote(url.path), parse_qs(url.query),
                    version, headers, body)


def _head(status: int, headers: Dict[str, str], version: str) -> bytes:
    lines = [f"{version} {status} {http.HTTPStatus(status).phrase}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


def _response(status: int, body: bytes, content_type: str,
              keep_alive: bool, extra: Optional[Dict[str, str]] = None,
              version: str = "HTTP/1.1") -> bytes:
    headers = {"Content-Type": content_type,
               "Content-Length": str(len(body))}
    headers.update(extra or {})
    if not keep_alive:
        headers["Connection"] = "close"
    return _head(status, headers, version) + body


def _json_response(data, status: int = 200, keep_alive: bool = True,
                   headers: Optional[Dict[str, str]] = None,
                   version: str = "HTTP/1.1") -> bytes:
    return _response(status, json.dumps(data).encode(),
                     "application/json; charset=utf-8", keep_alive,
                     headers, version)


def _text_response(status: int, keep_alive: bool,
                   headers: Optional[Dict[str, str]] = None,
                   version: str = "HTTP/1.1") -> bytes:
    text = f"{status}: {http.HTTPStatus(status).phrase}".encode()
    return _response(status, text, "text/plain; charset=utf-8", keep_alive,
                     headers, version)
