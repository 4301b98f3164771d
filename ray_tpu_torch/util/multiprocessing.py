"""Drop-in multiprocessing.Pool over the cluster.

Analog of the reference's ``ray.util.multiprocessing`` (util/
multiprocessing/pool.py): a Pool of actor processes; ``map``/``starmap``/
``apply``/``imap`` fan work out as actor calls so a single-machine Pool
program scales onto the cluster unchanged.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch as rt


@rt.remote
class _PoolWorker:
    def __init__(self, initializer=None, initargs=()):
        if initializer is not None:
            initializer(*initargs)

    def run(self, fn, args, kwargs):
        return fn(*args, **(kwargs or {}))

    def run_batch(self, fn, chunk):
        return [fn(*args) for args in chunk]


class AsyncResult:
    def __init__(self, refs, single: bool):
        self._refs = refs
        self._single = single

    def get(self, timeout: Optional[float] = None):
        results = rt.get(self._refs, timeout=timeout)
        return results[0] if self._single else results

    def wait(self, timeout: Optional[float] = None):
        rt.wait(self._refs, num_returns=len(self._refs), timeout=timeout)

    def ready(self) -> bool:
        done, _ = rt.wait(self._refs, num_returns=len(self._refs), timeout=0)
        return len(done) == len(self._refs)

    def successful(self) -> bool:
        try:
            self.get(timeout=0)
            return True
        except Exception:
            return False


class Pool:
    def __init__(
        self,
        processes: Optional[int] = None,
        initializer: Optional[Callable] = None,
        initargs: tuple = (),
    ):
        if not rt.is_initialized():
            rt.init()
        self._size = processes or 4
        self._workers = [
            _PoolWorker.remote(initializer, initargs) for _ in range(self._size)
        ]
        self._rr = itertools.cycle(range(self._size))
        self._closed = False

    # -- scheduling helpers ----------------------------------------------
    def _next(self):
        if self._closed:
            raise ValueError("Pool not running")
        return self._workers[next(self._rr)]

    @staticmethod
    def _chunks(items: List, n: int):
        for i in range(0, len(items), n):
            yield items[i : i + n]

    # -- API ---------------------------------------------------------------
    def apply(self, fn, args=(), kwds=None):
        return self.apply_async(fn, args, kwds).get()

    def apply_async(self, fn, args=(), kwds=None) -> AsyncResult:
        ref = self._next().run.remote(fn, tuple(args), kwds)
        return AsyncResult([ref], single=True)

    def map(self, fn, iterable: Iterable, chunksize: Optional[int] = None):
        return self.map_async(fn, iterable, chunksize).get()

    def map_async(self, fn, iterable, chunksize=None) -> AsyncResult:
        items = [(x,) for x in iterable]
        return self._starmap_async(fn, items, chunksize)

    def starmap(self, fn, iterable, chunksize=None):
        return self.starmap_async(fn, iterable, chunksize).get()

    def starmap_async(self, fn, iterable, chunksize=None) -> AsyncResult:
        return self._starmap_async(fn, [tuple(x) for x in iterable], chunksize)

    def _starmap_async(self, fn, items, chunksize) -> AsyncResult:
        if chunksize is None:
            chunksize = max(1, len(items) // (self._size * 4) or 1)
        refs = [
            self._next().run_batch.remote(fn, chunk)
            for chunk in self._chunks(items, chunksize)
        ]
        return _FlattenResult(refs)

    def imap(self, fn, iterable, chunksize: int = 1):
        refs = [self._next().run.remote(fn, (x,), None) for x in iterable]
        for ref in refs:
            yield rt.get(ref)

    def imap_unordered(self, fn, iterable, chunksize: int = 1):
        refs = [self._next().run.remote(fn, (x,), None) for x in iterable]
        pending = list(refs)
        while pending:
            done, pending = rt.wait(pending, num_returns=1)
            yield rt.get(done[0])

    def close(self):
        self._closed = True

    def terminate(self):
        self.close()
        for w in self._workers:
            rt.kill(w)
        self._workers = []

    def join(self):
        if not self._closed:
            raise ValueError("Pool is still running")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()
        return False


class _FlattenResult(AsyncResult):
    def __init__(self, refs):
        super().__init__(refs, single=False)

    def get(self, timeout: Optional[float] = None):
        out: List[Any] = []
        for batch in rt.get(self._refs, timeout=timeout):
            out.extend(batch)
        return out
