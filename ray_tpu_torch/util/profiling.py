"""User-level profiling spans in the cluster timeline, and device-time
spans inside the model.

Analog of the reference's ray.profiling.profile() (_private/profiling.py:84):
a context manager that records a named span from ANY driver or worker into
the GCS task-event stream, so `rt timeline` shows user phases ("preprocess",
"forward", "checkpoint") interleaved with task execution spans in
chrome://tracing.

`device_span(name)` is the other kind: it measures how long the card spends
in one part of the model (attention, the MoE's experts, the loss), in each
of three passes: the forward, remat's recompute of it, and its backward.
It is on while a torch profiler records, and then also opens a
`record_function` range, so the span sits in the profiler's trace on the
kernels' clock. `device_span_totals()` reads the cumulative milliseconds.
"""

from __future__ import annotations

import collections
import itertools
import os
import sys
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


# -- device-time spans ------------------------------------------------------
#
# A span's forward and recompute are timed between a stamp taken where its
# first input enters (`entry`) and one taken at its close. Its backward is
# timed by identity autograd Functions on the tensors that enter and leave
# it: the first leaving tensor's backward opens the interval, the last
# entering tensor's closes it, and the recompute that remat ran inside the
# interval is taken out. On a CUDA tensor a stamp is a timing event on the
# current stream; on the CPU, where ops run synchronously, the host clock.
# Events are read when the totals are read (or, without waiting, once many
# are pending), never inside a step.

FORWARD, RECOMPUTE, BACKWARD = 0, 1, 2
PASSES = ("forward", "recompute", "backward")

_RESOLVE_AT = 4096  # closed records pending before a non-blocking read

_torch = None  # torch, bound on the first span
_autograd_profiler = None  # torch.autograd.profiler, likewise
_span_tls = threading.local()  # .depth: device spans open on this thread
_span_lock = threading.Lock()
_closed: List["_Rec"] = []  # closed records, in the order they closed
_recent_recompute: "collections.deque" = collections.deque(maxlen=256)
_span_totals: Dict[str, list] = {}
_seq = itertools.count()
_Enter = _Leave = None  # the marker Functions, built with torch


class _Rec:
    """One timed interval of a span: its name and pass, whether it was
    entered with no other span open, and its two stamps (sequence number
    and clock reading: a float on the CPU, an event on the card)."""

    __slots__ = ("name", "kind", "top", "s0", "t0", "s1", "t1", "ms",
                 "inner", "n_in", "n_fired")

    def __init__(self, name: str, kind: int, top: bool):
        self.name, self.kind, self.top = name, kind, top
        self.t0 = self.t1 = self.ms = None
        self.s0 = self.s1 = 0
        self.inner = ()
        self.n_in = self.n_fired = 0


def _stamp(device):
    """(sequence number, clock reading) on `device`'s timeline."""
    if device.type == "cuda":
        ev = _torch.cuda.Event(enable_timing=True)
        ev.record(_torch.cuda.current_stream(device))
        return next(_seq), ev
    return next(_seq), time.perf_counter()


def _close(rec: "_Rec") -> None:
    with _span_lock:
        if rec.kind == BACKWARD:
            rec.inner = [r for r in _recent_recompute
                         if rec.s0 < r.s0 and r.s1 < rec.s1]
        elif rec.kind == RECOMPUTE and rec.top:
            _recent_recompute.append(rec)
        _closed.append(rec)
        full = len(_closed) >= _RESOLVE_AT
    if full:
        _resolve(block=False)


def _elapsed_ms(t0, t1) -> float:
    if isinstance(t0, float):
        return (t1 - t0) * 1e3
    return t0.elapsed_time(t1)


def _resolve(block: bool) -> None:
    """Fold closed records into the totals, in the order they closed. With
    `block`, wait for the card to pass each stamp; without, stop at the
    first record the card has not reached yet."""
    with _span_lock:
        n = 0
        for rec in _closed:
            if not isinstance(rec.t0, float):
                if block:
                    rec.t0.synchronize()
                    rec.t1.synchronize()
                elif not (rec.t0.query() and rec.t1.query()):
                    break
            ms = _elapsed_ms(rec.t0, rec.t1)
            if rec.kind == BACKWARD:
                ms -= sum(r.ms for r in rec.inner)
            rec.ms = ms
            t = _span_totals.get(rec.name)
            if t is None:
                t = _span_totals[rec.name] = [0.0, 0.0, 0.0, 0, 0, 0, False]
            t[rec.kind] += ms
            t[3 + rec.kind] += 1
            t[6] = t[6] or rec.top
            rec.t0 = rec.t1 = rec.inner = None
            n += 1
        del _closed[:n]


def _bind_torch():
    """Bind torch's profiler module (and the marker Functions) on the first
    span: this module is imported by processes that never load torch."""
    global _torch, _autograd_profiler, _Enter, _Leave
    import torch
    import torch.autograd.profiler as autograd_profiler

    class _Leave(torch.autograd.Function):
        """On a tensor leaving a span: its backward opens the span's."""

        @staticmethod
        def forward(ctx, rec, x):
            ctx.rec = rec
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            rec = ctx.rec
            if rec.t0 is None:
                rec.s0, rec.t0 = _stamp(g.device)
            return None, g

    class _Enter(torch.autograd.Function):
        """On a tensor entering a span: the last of these backwards to run
        closes the span's backward."""

        @staticmethod
        def forward(ctx, rec, x):
            ctx.rec = rec
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            rec = ctx.rec
            rec.n_fired += 1
            if rec.n_fired == rec.n_in and rec.t0 is not None:
                done = _Rec(rec.name, BACKWARD, rec.top)
                done.s0, done.t0 = rec.s0, rec.t0
                done.s1, done.t1 = _stamp(g.device)
                rec.t0, rec.n_fired = None, 0  # a retained graph runs again
                _close(done)
            return None, g

    _torch, _autograd_profiler = torch, autograd_profiler
    return autograd_profiler


class _NoSpan:
    """What device_span returns while spans are off: nothing is recorded."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def entry(self, *xs):
        return xs[0] if len(xs) == 1 else xs

    exit = entry


_NO_SPAN = _NoSpan()


class _Span:
    """An open device span (see device_span)."""

    __slots__ = ("_rec", "_bwd", "_range", "_dev")

    def __init__(self, name: str):
        self._rec = _Rec(name, FORWARD, True)
        self._bwd = self._range = self._dev = None

    def __enter__(self):
        rec = self._rec
        self._range = _autograd_profiler.record_function(rec.name)
        self._range.__enter__()
        depth = getattr(_span_tls, "depth", 0)
        _span_tls.depth = depth + 1
        rec.top = depth == 0
        if _torch._C._current_graph_task_id() != -1:
            rec.kind = RECOMPUTE  # entered while autograd runs: remat's re-run
        return self

    def entry(self, *xs):
        """Mark the tensors entering the span (activations, or the weight
        where the input carries no gradient); returns them, as views where
        they carry a gradient. The first call starts the span's clock."""
        rec = self._rec
        if rec.t0 is None:
            self._dev = xs[0].device
            rec.s0, rec.t0 = _stamp(self._dev)
        if _torch.is_grad_enabled():
            out = []
            for x in xs:
                if x.requires_grad:
                    if self._bwd is None:
                        self._bwd = _Rec(rec.name, BACKWARD, rec.top)
                    self._bwd.n_in += 1
                    x = _Enter.apply(self._bwd, x)
                out.append(x)
            xs = out
        return xs[0] if len(xs) == 1 else tuple(xs)

    def exit(self, *xs):
        """Mark the tensors leaving the span; returns them."""
        bwd = self._bwd
        if bwd is not None:
            xs = [_Leave.apply(bwd, x) if x.requires_grad else x for x in xs]
        return xs[0] if len(xs) == 1 else tuple(xs)

    def __exit__(self, *exc):
        rec = self._rec
        if rec.t0 is not None:
            rec.s1, rec.t1 = _stamp(self._dev)
            _close(rec)
        _span_tls.depth -= 1
        self._range.__exit__(*exc)
        return False


def device_span(name: str):
    """A span of device time named `name`, used as

        with device_span("model.mlp") as sp:
            x = sp.entry(x)
            ...
            out = sp.exit(out)

    While spans are off it records nothing, adds no autograd node and
    opens no range. They are on while a torch profiler records. A span
    entered while autograd runs (remat's recompute under a checkpoint)
    counts as recompute."""
    if (_autograd_profiler or _bind_torch())._is_profiler_enabled:
        return _Span(name)
    return _NO_SPAN


def device_spans_on() -> bool:
    """Whether device spans record now: while a torch profiler records.
    Loads no torch into a process that has not loaded it."""
    if _autograd_profiler is None and "torch" not in sys.modules:
        return False
    return (_autograd_profiler or _bind_torch())._is_profiler_enabled


def device_span_totals() -> Dict[str, Dict]:
    """Cumulative device ms and entries of each span name, per pass:
    {name: {"forward_ms", "recompute_ms", "backward_ms", "forward_n",
    "recompute_n", "backward_n", "top"}}, "top" meaning the span was
    entered with no other span open. Waits for the card to reach the
    stamps still pending."""
    _resolve(block=True)
    with _span_lock:
        return {name: {**{f"{p}_ms": t[i] for i, p in enumerate(PASSES)},
                       **{f"{p}_n": t[3 + i] for i, p in enumerate(PASSES)},
                       "top": t[6]}
                for name, t in _span_totals.items()}


def reset_device_spans() -> None:
    """Drop the totals and every record not read yet."""
    with _span_lock:
        _closed.clear()
        _recent_recompute.clear()
        _span_totals.clear()
