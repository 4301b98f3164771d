"""Dynamic request batching. Counterpart of ray_tpu/serve/batching.py.

Analog of the reference's @serve.batch (python/ray/serve/batching.py): a
decorated method takes a list of items and returns a list of results;
concurrent callers are transparently coalesced into batches of up to
`max_batch_size`, waiting at most `batch_wait_timeout_s` for the batch to
fill. On a GPU replica this is what turns 32 trickling HTTP requests into
one forward pass over a batch.

Execution model: replicas run requests on actor executor threads
(max_concurrency > 1), so the batcher is thread-based — the first caller
into an empty batch becomes the leader, waits for the window, executes the
underlying function once, and distributes results to the other callers'
futures.
"""

from __future__ import annotations

import concurrent.futures
import threading
from typing import Any, Callable, List, Optional

from ray_tpu_torch._private.config import get_config


class _BatchQueue:
    def __init__(self, fn: Callable, max_batch_size: int,
                 batch_wait_timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.batch_wait_timeout_s = batch_wait_timeout_s
        self.lock = threading.Lock()
        self.full = threading.Condition(self.lock)
        self.items: List[Any] = []
        self.futures: List[concurrent.futures.Future] = []
        self.leader_active = False
        # Observability: batch sizes actually executed (tests + tuning).
        self.batch_sizes: List[int] = []

    def submit(self, instance, item) -> Any:
        """Join the current batch; block until the batch runs; return this
        item's result (or raise the batch's exception)."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self.lock:
            self.items.append(item)
            self.futures.append(fut)
            is_leader = not self.leader_active
            if is_leader:
                self.leader_active = True
            elif len(self.items) >= self.max_batch_size:
                self.full.notify()
        if is_leader:
            self._lead(instance)
        # Bounded wait: if the leader wedges (e.g. the batch fn hangs on
        # a device), followers surface a timeout instead of deadlocking
        # the replica's whole call slot forever.
        return fut.result(timeout=get_config().serve_result_timeout_s)

    def _lead(self, instance):
        with self.lock:
            deadline = (
                threading.TIMEOUT_MAX
                if self.batch_wait_timeout_s is None
                else self.batch_wait_timeout_s
            )
            if len(self.items) < self.max_batch_size:
                self.full.wait(timeout=deadline)
            items, self.items = self.items, []
            futures, self.futures = self.futures, []
            self.leader_active = False
            self.batch_sizes.append(len(items))
        try:
            if instance is not None:
                results = self.fn(instance, items)
            else:
                results = self.fn(items)
            if len(results) != len(items):
                raise ValueError(
                    f"@serve.batch function returned {len(results)} results "
                    f"for a batch of {len(items)}"
                )
        except BaseException as e:  # noqa: BLE001 — fan the error out
            for f in futures:
                if not f.done():
                    f.set_exception(e)
            return
        for f, r in zip(futures, results):
            if not f.done():
                f.set_result(r)


class _BatchedMethod:
    """Descriptor so @serve.batch works on methods: one queue per instance."""

    def __init__(self, fn, max_batch_size, batch_wait_timeout_s):
        self._fn = fn
        self._max_batch_size = max_batch_size
        self._batch_wait_timeout_s = batch_wait_timeout_s
        self.__name__ = getattr(fn, "__name__", "batched")
        self._free_queue: Optional[_BatchQueue] = None

    def _queue_for(self, instance) -> _BatchQueue:
        if instance is None:
            if self._free_queue is None:
                self._free_queue = _BatchQueue(
                    self._fn, self._max_batch_size, self._batch_wait_timeout_s
                )
            return self._free_queue
        key = f"__serve_batch_queue_{self.__name__}"
        q = instance.__dict__.get(key)
        if q is None:
            q = _BatchQueue(
                self._fn, self._max_batch_size, self._batch_wait_timeout_s
            )
            instance.__dict__[key] = q
        return q

    def __get__(self, instance, owner=None):
        if instance is None:
            return self

        def bound(item):
            return self._queue_for(instance).submit(instance, item)

        bound.__name__ = self.__name__
        bound._batch_queue = self._queue_for(instance)
        return bound

    def __call__(self, item):
        return self._queue_for(None).submit(None, item)


def batch(_fn=None, *, max_batch_size: int = 10,
          batch_wait_timeout_s: float = 0.01):
    """Decorator: fn(self, items: List[T]) -> List[R] becomes callable with
    a single item; concurrent single calls coalesce into batches
    (reference: python/ray/serve/batching.py)."""

    def deco(fn):
        return _BatchedMethod(fn, max_batch_size, batch_wait_timeout_s)

    if _fn is not None:
        return deco(_fn)
    return deco
