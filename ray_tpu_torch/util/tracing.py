"""Distributed tracing: trace-context propagation across task boundaries.

Analog of the reference's OpenTelemetry integration
(python/ray/util/tracing/tracing_helper.py:326 _inject_tracing_into_function
+ context propagation in task metadata): when tracing is enabled, every
task/actor-call submission carries its caller's trace context, the
executing worker opens a child span for the task body, and nested submits
inherit — so one logical request yields a cross-process span TREE, not
disconnected per-process spans.

Spans ride the same GCS task-event stream the timeline uses (type
TRACE_SPAN), so `rt timeline` shows them and the state API can assemble
the tree per trace id. No OpenTelemetry dependency: span records are
plain events; export to OTLP is a consumer-side concern.

Usage:
    from ray_tpu_torch.util import tracing
    tracing.enable()
    with tracing.span("handle-request"):
        rt.get(f.remote(...))   # f's execution becomes a child span
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

_tls = threading.local()
_enabled: Optional[bool] = None


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def is_enabled() -> bool:
    global _enabled
    if _enabled is None:
        _enabled = os.environ.get("RT_TRACING", "0") not in ("0", "", "false")
    return _enabled


def _new_id(nbytes: int = 8) -> str:
    return os.urandom(nbytes).hex()


def current() -> Optional[Dict[str, str]]:
    """The active span context: {"trace_id", "span_id"} or None."""
    return getattr(_tls, "ctx", None)


def inject() -> Optional[Dict[str, str]]:
    """Context to attach to an outgoing task spec (None when tracing is
    off and no span is active).

    An ACTIVE context always propagates — worker processes adopt contexts
    via activate() without the driver's enabled flag (the reference
    propagates the same way: context in task metadata, not env). With
    tracing enabled but no active span, each submission roots a fresh
    trace, matching the reference's span-per-task behavior."""
    ctx = current()
    if ctx is not None:
        return {"trace_id": ctx["trace_id"], "parent_span_id": ctx["span_id"]}
    if not is_enabled():
        return None
    return {"trace_id": _new_id(16), "parent_span_id": ""}


def _record(name: str, ctx: Dict[str, str], parent_id: str, start: float,
            end: float, kind: str) -> None:
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.util import profiling

    try:
        client = worker_mod.get_client()
        node_id = client.node_id
        worker_id = client.client_id
    except Exception:  # noqa: BLE001 — not connected: drop the span  # rtlint: disable=RT007 — tracing is best-effort garnish and must never break the traced op
        return
    base = {
        "task_id": bytes.fromhex(ctx["span_id"]) + os.urandom(8),
        "name": name,
        "job_id": b"",
        "node_id": node_id,
        "worker_id": worker_id,
        "type": "TRACE_SPAN",
        "extra": {
            "trace_id": ctx["trace_id"],
            "span_id": ctx["span_id"],
            "parent_id": parent_id,
            "kind": kind,
        },
    }
    with profiling._lock:
        profiling._buffer.append({**base, "state": "RUNNING", "ts": start})
        profiling._buffer.append({**base, "state": "FINISHED", "ts": end})
    from ray_tpu_torch.util import journal

    journal.emit("trace.span", name=name, trace_id=ctx["trace_id"],
                 kind=kind, dur_s=round(end - start, 6))
    # Bounded-delay batch flush: every span recorded inside the window
    # rides ONE add_task_events RPC (the old force-flush here cost one
    # GCS RPC per span — untenable once serve requests are traced).
    # atexit still force-flushes, so spans recorded just before a worker
    # idles out or the driver exits reach the timeline regardless.
    profiling.request_flush()


@contextmanager
def span(name: str):
    """Open a span as a child of the active one (or a trace root)."""
    if not is_enabled():
        yield
        return
    parent = current()
    ctx = {
        "trace_id": parent["trace_id"] if parent else _new_id(16),
        "span_id": _new_id(),
    }
    parent_id = parent["span_id"] if parent else ""
    prev = current()
    _tls.ctx = ctx
    start = time.time()
    try:
        yield
    finally:
        _tls.ctx = prev
        _record(name, ctx, parent_id, start, time.time(), "local")


@contextmanager
def attach(ctx: Optional[Dict[str, str]]):
    """Adopt an existing span context on THIS thread without opening a
    new span. Trace context is thread-local, so a background thread
    spawned mid-span starts detached; capture `current()` on the
    spawning side and `with tracing.attach(ctx):` in the thread body,
    and spans the thread opens join the request tree instead of rooting
    fresh traces. No-op (and records nothing) when ctx is None."""
    if not ctx:
        yield
        return
    prev = current()
    _tls.ctx = dict(ctx)
    try:
        yield
    finally:
        _tls.ctx = prev


@contextmanager
def activate(trace_ctx: Optional[Dict[str, str]], name: str):
    """Worker-side: adopt a received trace context for the duration of a
    task body, recording the execution as a child span. No-op when the
    submission carried no context."""
    if not trace_ctx:
        yield
        return
    ctx = {"trace_id": trace_ctx["trace_id"], "span_id": _new_id()}
    prev = current()
    _tls.ctx = ctx
    start = time.time()
    try:
        yield
    finally:
        _tls.ctx = prev
        _record(name, ctx, trace_ctx.get("parent_span_id", ""), start,
                time.time(), "task")


def get_trace(trace_id: str, address: Optional[str] = None) -> List[dict]:
    """Assemble one trace's spans (finished only) from the task-event
    stream, parent-linked: [{"name", "span_id", "parent_id", "ts",
    "dur_s", "kind"}]."""
    from ray_tpu_torch.util.state.api import StateApiClient, fetch_task_events

    client = StateApiClient(address)
    try:
        events = fetch_task_events(client.call)
    finally:
        client.close()
    starts: Dict[bytes, dict] = {}
    spans: List[dict] = []
    for ev in events:
        if ev.get("type") != "TRACE_SPAN":
            continue
        extra = ev.get("extra", {})
        if extra.get("trace_id") != trace_id:
            continue
        if ev["state"] == "RUNNING":
            starts[ev["task_id"]] = ev
        elif ev["state"] == "FINISHED" and ev["task_id"] in starts:
            start = starts.pop(ev["task_id"])
            spans.append({
                "name": ev.get("name", ""),
                "span_id": extra["span_id"],
                "parent_id": extra.get("parent_id", ""),
                "kind": extra.get("kind", ""),
                "ts": start["ts"],
                "dur_s": max(0.0, ev["ts"] - start["ts"]),
            })
    spans.sort(key=lambda s: s["ts"])
    return spans
