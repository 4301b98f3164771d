"""Background device-feed pipeline: data blocks -> host batches -> the card.

The port of ray_tpu/data/feed.py. The step loop should never wait on the
host. This module supplies the host half of that contract for input
pipelines: a bounded producer thread pulls blocks (rt.prefetch + rt.get
overlap the cross-node transfer), assembles zero-copy numpy batches, and
stages each batch's host-to-device copy so batch i+1's transfer is in
flight while step i computes. The consumer iterates batches off a
depth-k queue; when the queue is empty on arrival that's a feed stall —
counted and timed so a starved step loop is diagnosable from
Dataset.stats() and the `data_feed_*` metrics rather than by profiler
archaeology.

The transfer to the card (`_CudaStager`): on the producer thread each
numpy column is copied once into pinned host memory, the copy to the card
starts with non_blocking=True on a CUDA stream of the feed's own, and an
event is recorded on that stream. The consumer's __next__ makes its
current stream wait on the event and calls record_stream on each tensor,
so the caching allocator cannot hand the memory to another stream before
the step that reads it has run. A pinned buffer is freed to PyTorch's
caching host allocator right after its copy is queued; that allocator
records an event on the copy's stream and reuses the block only once the
copy has completed. Nothing falls back: if pinning or the copy fails, the
iteration raises.

Reference analog: ray.data's prefetching block iterator
(python/ray/data/_internal/block_batching/iter_batches.py) collapsed to
one thread + one bounded queue.

Thread discipline (rtlint RT006): the producer is a module-level
function that communicates with the consumer ONLY through the queue
(("batch", v) / ("error", exc) / ("done", None) tuples), a stop Event,
and the lock-guarded FeedStats. No instance attribute is written on one
side and read on the other.

Importing this module loads no torch; only the feed to a device does.
"""

from __future__ import annotations

import queue
import threading
import time
import weakref
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np

from ray_tpu_torch.util import metrics as _metrics
from ray_tpu_torch.util import tracing as _tracing

# Wall seconds the consumer spent blocked on an empty feed queue (the
# step loop outran the producer). One observation per stall.
_STALL_SECONDS = _metrics.get_or_create(
    _metrics.Histogram,
    "data_feed_stall_seconds",
    "Consumer wait per feed stall (queue empty when the step loop "
    "asked for a batch)",
    boundaries=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0),
)
_BATCHES_TOTAL = _metrics.get_or_create(
    _metrics.Counter,
    "data_feed_batches_total",
    "Batches delivered through the background device-feed pipeline",
)


class FeedStats:
    """Per-iterator feed timings, written from both sides of the pipe.

    wait_s/stall_count are consumer-side (time blocked on the queue);
    assemble_s (block pull + batch slicing), h2d_s (the pinned copy and
    the dispatch of the copy to the card) and h2d_bytes (the bytes that
    copy moves) are producer-side. All mutation is lock-guarded; read a
    consistent view with snapshot().
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._wait_s = 0.0
        self._assemble_s = 0.0
        self._h2d_s = 0.0
        self._h2d_bytes = 0
        self._stall_count = 0
        self._batches = 0

    def add_wait(self, seconds: float):
        with self._lock:
            self._wait_s += seconds
            self._stall_count += 1
        _STALL_SECONDS.observe(seconds)

    def add_assemble(self, seconds: float):
        with self._lock:
            self._assemble_s += seconds

    def add_h2d(self, seconds: float):
        with self._lock:
            self._h2d_s += seconds

    def add_h2d_bytes(self, nbytes: int):
        with self._lock:
            self._h2d_bytes += nbytes

    def add_batch(self):
        with self._lock:
            self._batches += 1
        _BATCHES_TOTAL.inc()

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "wait_s": self._wait_s,
                "assemble_s": self._assemble_s,
                "h2d_s": self._h2d_s,
                "h2d_bytes": self._h2d_bytes,
                "stall_count": self._stall_count,
                "batches": self._batches,
            }

    def render(self) -> str:
        s = self.snapshot()
        return (
            f"feed: {s['batches']} batches, "
            f"assemble {s['assemble_s'] * 1e3:.1f}ms, "
            f"h2d {s['h2d_s'] * 1e3:.1f}ms ({s['h2d_bytes']} bytes), "
            f"stalls {s['stall_count']} ({s['wait_s'] * 1e3:.1f}ms waiting)"
        )


def _q_put(q: "queue.Queue", item: Tuple[str, Any],
           stop_event: threading.Event) -> bool:
    """put() that never wedges on a full queue after the consumer left:
    poll the stop event between bounded attempts."""
    while not stop_event.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def _produce(source_factory: Callable[[], Iterable],
             transform: Optional[Callable[[Any], Any]],
             q: "queue.Queue", stop_event: threading.Event,
             stats: FeedStats, trace_ctx=None) -> None:
    """Producer-thread body. Terminates by enqueueing ("done", None) /
    ("error", exc), or silently when the stop event fires.

    trace_ctx is the span context active when the prefetcher was built:
    trace context is thread-local, so without re-attaching it here every
    span the pull/assembly path opens (rt.get, rt.prefetch) would root a
    detached trace instead of joining the request tree.
    """
    try:
        with _tracing.attach(trace_ctx):
            it = iter(source_factory())
            while not stop_event.is_set():
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    break
                stats.add_assemble(time.perf_counter() - t0)
                if transform is not None:
                    t1 = time.perf_counter()
                    item = transform(item)
                    stats.add_h2d(time.perf_counter() - t1)
                if not _q_put(q, ("batch", item), stop_event):
                    return
            _q_put(q, ("done", None), stop_event)
    except BaseException as e:  # noqa: BLE001 — shipped to the consumer
        _q_put(q, ("error", e), stop_event)


def _shutdown(q: "queue.Queue", stop_event: threading.Event,
              thread: threading.Thread) -> None:
    """Idempotent teardown (stop() and GC finalizer): wake the producer
    out of any blocking put by draining, then join."""
    stop_event.set()
    try:
        while True:
            q.get_nowait()
    except queue.Empty:
        pass
    if thread.is_alive():
        thread.join(timeout=5.0)


class _DevicePrefetcher:
    """Iterator that runs its source on a background thread, `depth`
    batches ahead of the consumer (plus the one being assembled).

    `transform` runs producer-side — pass the device staging there so
    the H2D transfer for batch i+1 is dispatched while the consumer is
    still inside step i; `deliver` runs consumer-side on each staged
    batch before it is returned (the stream handoff to the consumer's
    stream). Exceptions from the source or transform re-raise at the
    consumer's next(); stop() (also wired to GC) joins the thread.
    """

    def __init__(self, source_factory: Callable[[], Iterable],
                 depth: int,
                 transform: Optional[Callable[[Any], Any]] = None,
                 stats: Optional[FeedStats] = None,
                 name: str = "feed",
                 deliver: Optional[Callable[[Any], Any]] = None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._stats = stats if stats is not None else FeedStats()
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop_event = threading.Event()
        self._thread = threading.Thread(
            target=_produce,
            args=(source_factory, transform, self._queue, self._stop_event,
                  self._stats, _tracing.current()),
            name=f"rt-data-{name}",
            daemon=True,
        )
        # The finalizer must not capture self, or it would keep the
        # prefetcher alive and GC could never trigger it.
        self._finalizer = weakref.finalize(
            self, _shutdown, self._queue, self._stop_event, self._thread
        )
        self._finished = False
        self._deliver = deliver
        self._thread.start()

    @property
    def stats(self) -> FeedStats:
        return self._stats

    def stop(self) -> None:
        """Stop the producer and join its thread (idempotent)."""
        self._finished = True
        self._finalizer()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        try:
            kind, payload = self._queue.get_nowait()
        except queue.Empty:
            # Feed stall: the consumer outran the producer.
            t0 = time.perf_counter()
            kind, payload = self._blocking_get()
            self._stats.add_wait(time.perf_counter() - t0)
        if kind == "batch":
            self._stats.add_batch()
            return payload if self._deliver is None else self._deliver(payload)
        self.stop()
        if kind == "error":
            raise payload
        raise StopIteration  # "done"

    def _blocking_get(self) -> Tuple[str, Any]:
        while True:
            try:
                return self._queue.get(timeout=0.5)
            except queue.Empty:
                if self._stop_event.is_set() or not self._thread.is_alive():
                    # Producer died without a terminal item (or an external
                    # stop raced us): end the stream instead of wedging.
                    self._finished = True
                    raise StopIteration from None


# ---------------------------------------------------------------------------
# The transfer to a torch device
# ---------------------------------------------------------------------------


def _column(name: str, v) -> np.ndarray:
    """One batch column as a numeric ndarray; anything torch cannot hold
    (strings, or objects such as the rows of an arrow list column)
    raises."""
    v = np.asarray(v)
    if v.dtype.kind not in "biuf":
        raise TypeError(
            f"column {name!r} has dtype {v.dtype}; a tensor batch needs "
            f"numeric columns (map a list column to a fixed-shape one, "
            f"drop or encode the rest first)")
    return v


def _torch_dtype(np_dtype):
    import torch

    return torch.from_numpy(np.empty(0, dtype=np_dtype)).dtype


class _CpuStager:
    """Batches as CPU tensors: one host copy per column (numpy views over
    the store's buffers are read-only and die with the block)."""

    def __init__(self, dtypes: Optional[Dict[str, Any]]):
        self._dtypes = dtypes or {}

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        import torch

        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.array(_column(k, v), copy=True))
            out[k] = t.to(self._dtypes[k]) if k in self._dtypes else t
        return out


class _CudaStager:
    """Producer side: pinned copy + non_blocking copy to the card on the
    feed's own stream, then an event. Consumer side (`deliver`): the
    consumer's stream waits on the event and owns the tensors."""

    def __init__(self, device, dtypes: Optional[Dict[str, Any]],
                 stats: Optional[FeedStats]):
        import torch

        self._device = device
        self._dtypes = dtypes or {}
        self._stats = stats
        self._stream = torch.cuda.Stream(device=device)

    def __call__(self, batch: Dict[str, Any]):
        import torch

        nbytes = 0
        out = {}
        # The current device is per thread: the producer sets its own.
        with torch.cuda.device(self._device), torch.cuda.stream(self._stream):
            for k, v in batch.items():
                v = _column(k, v)
                host = torch.empty(v.shape, dtype=_torch_dtype(v.dtype),
                                   pin_memory=True)
                host.numpy()[...] = v  # the one host copy
                t = host.to(self._device, non_blocking=True)
                out[k] = t.to(self._dtypes[k]) if k in self._dtypes else t
                nbytes += v.nbytes
            event = torch.cuda.Event()
            event.record(self._stream)
        if self._stats is not None:
            self._stats.add_h2d_bytes(nbytes)
        return out, event

    def deliver(self, staged):
        import torch

        out, event = staged
        stream = torch.cuda.current_stream(self._device)
        stream.wait_event(event)
        for t in out.values():
            t.record_stream(stream)
        return out


def _inline(batches: Iterable, transform, deliver) -> Iterator:
    """prefetch_batches=0: assemble on the consumer's thread, with one
    batch's transfer in flight while the previous one is consumed."""
    pending = None
    for batch in batches:
        nxt = transform(batch)
        if pending is not None:
            yield pending if deliver is None else deliver(pending)
        pending = nxt
    if pending is not None:
        yield pending if deliver is None else deliver(pending)


def torch_feed(source_factory: Callable[[], Iterable], *, device=None,
               dtypes: Optional[Dict[str, Any]] = None,
               prefetch_batches: Optional[int] = None,
               new_stats: Callable[[], FeedStats] = FeedStats,
               name: str = "feed") -> Iterator:
    """Numpy batches from `source_factory()` as dicts of torch tensors on
    `device` (Dataset/DataIterator.iter_torch_batches).

    device=None is the card this process was granted (it raises where
    there is none); the CPU only when asked for. prefetch_batches=None
    takes config.data_feed_prefetch_batches; > 0 runs the pull, the
    assembly and the staging on a producer thread that many batches
    ahead, 0 inline."""
    from ray_tpu_torch._device import resolve_device

    dev = resolve_device(device)
    if prefetch_batches is None:
        from ray_tpu_torch._private.config import get_config

        prefetch_batches = get_config().data_feed_prefetch_batches
    stats = new_stats() if prefetch_batches > 0 else None
    deliver = None
    if dev.type == "cuda":
        stager = _CudaStager(dev, dtypes, stats)
        transform, deliver = stager, stager.deliver
    elif dev.type == "cpu":
        transform = _CpuStager(dtypes)
    else:
        raise ValueError(f"no feed to a {dev.type!r} device")
    if prefetch_batches > 0:
        return _DevicePrefetcher(source_factory, depth=prefetch_batches,
                                 transform=transform, stats=stats,
                                 name=name, deliver=deliver)
    return _inline(source_factory(), transform, deliver)
