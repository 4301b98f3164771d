"""User-level profiling spans in the cluster timeline.

Analog of the reference's ray.profiling.profile() (_private/profiling.py:84):
a context manager that records a named span from ANY driver or worker into
the GCS task-event stream, so `rt timeline` shows user phases ("preprocess",
"forward", "checkpoint") interleaved with task execution spans in
chrome://tracing.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

_lock = threading.Lock()
_buffer: List[dict] = []
_last_flush = 0.0
_flush_timer: threading.Timer | None = None

# Spans recorded just before exit must still reach the timeline.
import atexit

atexit.register(lambda: _flush(force=True))


def request_flush(delay_s: float | None = None) -> None:
    """Schedule a forced flush within a bounded delay.

    The batching path for high-rate span producers (tracing._record used
    to force one GCS RPC per span): the first request arms a one-shot
    timer, subsequent requests while it is armed are free, and every
    span buffered in the window rides one add_task_events RPC. Eager
    flushing remains only at atexit/driver exit.
    """
    global _flush_timer
    if delay_s is None:
        from ray_tpu_torch._private.config import get_config

        delay_s = get_config().trace_flush_delay_s
    with _lock:
        if _flush_timer is not None:
            return
        t = threading.Timer(delay_s, _timer_fire)
        t.name = "rt-profiling-flush"  # the runtime's, not an actor's
        t.daemon = True
        _flush_timer = t
    t.start()


def buffer_events(events: List[dict], flush_delay_s: float | None = None) -> None:
    """Append pre-built task events (e.g. serve LIFECYCLE_SPANs) to the
    batched flush buffer. Rides the same armed-timer add_task_events
    batching as spans — no per-event GCS RPC."""
    if not events:
        return
    with _lock:
        _buffer.extend(events)
    request_flush(flush_delay_s)


def _timer_fire() -> None:
    global _flush_timer
    with _lock:
        _flush_timer = None
    _flush(force=True)


def _flush(force: bool = False):
    global _last_flush
    from ray_tpu_torch._private import worker as worker_mod

    with _lock:
        now = time.monotonic()
        if not _buffer or (
            not force and len(_buffer) < 16 and now - _last_flush < 1.0
        ):
            return
        events, _buffer[:] = list(_buffer), []
        _last_flush = now
    try:
        client = worker_mod.get_client()
        client._run(
            client._gcs_call("add_task_events", {"events": events}),
            timeout=10,
        )
    except Exception:  # noqa: BLE001 — profiling must never break user code
        pass


@contextmanager
def profile(name: str, extra: Optional[Dict] = None):
    """Record a named span:

        with rt.util.profiling.profile("tokenize"):
            ...

    Spans appear in `rt timeline` under the emitting worker's row.
    """
    from ray_tpu_torch._private import worker as worker_mod

    try:
        client = worker_mod.get_client()
        node_id = client.node_id
        worker_id = client.client_id
    except Exception:  # noqa: BLE001 — not connected: no-op span
        yield
        return
    span_id = os.urandom(16)
    start = time.time()
    try:
        yield
    finally:
        end = time.time()
        base = {
            "task_id": span_id,
            "name": name,
            "job_id": b"",
            "node_id": node_id,
            "worker_id": worker_id,
            "type": "USER_SPAN",
        }
        if extra:
            base["extra"] = dict(extra)
        with _lock:
            _buffer.append({**base, "state": "RUNNING", "ts": start})
            _buffer.append({**base, "state": "FINISHED", "ts": end})
        _flush()


def flush():
    """Force-flush buffered spans (call before process exit in tests)."""
    _flush(force=True)
