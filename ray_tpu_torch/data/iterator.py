"""Streaming split iteration for train ingestion (the port of
ray_tpu/data/iterator.py).

Analog of the reference's Dataset.streaming_split
(python/ray/data/dataset.py:1161) + StreamSplitDataIterator
(_internal/iterator/stream_split_iterator.py): one coordinator actor
drives the dataset's streaming executor per epoch and deals completed
output blocks to n consumer queues; each training worker holds a
DataIterator that pulls from its queue. Blocks flow while upstream tasks
are still running, and every epoch re-executes the pipeline (fresh
random_shuffle draws etc.).

`equal=True` is row-EXACT (the reference's semantics): blocks stream to
the least-loaded split, each split's most recent block is held back, and
at end of stream the holdbacks are sliced so every split delivers exactly
total // n rows (up to n-1 remainder rows dropped). Row-exact splits are
what keeps gang-SPMD training in lockstep — a skewed split means skewed
worker step counts and a stalled gang.

A DataIterator feeds the card through iter_torch_batches (feed.py). The
coordinator and the read, map and shuffle tasks it drives load no torch.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Iterator, List, Optional

import ray_tpu_torch as rt
from ray_tpu_torch.data import block as B

def _split_queue_depth() -> int:
    # Undelivered blocks buffered per split before the producer stalls
    # (consumer backpressure; reference: per-split output queue bounds).
    from ray_tpu_torch._private.config import get_config

    return get_config().data_split_queue_depth


def _block_rows(block) -> int:
    return B.block_num_rows(block)


def _block_slice_rows(block, start: int, end: int):
    return B.block_slice(block, start, end)


@rt.remote
class _SplitCoordinator:
    """Owns one streaming execution per epoch and deals blocks to n
    split queues. max_concurrency must cover n blocked next_blocks()
    calls plus control calls (set at creation in streaming_split)."""

    def __init__(self, input_refs: List, stages_payload: bytes, n: int,
                 equal: bool):
        from ray_tpu_torch._vendor import cloudpickle

        self._input_refs = list(input_refs)
        self._stages = cloudpickle.loads(stages_payload)
        self._n = n
        self._equal = equal
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._epoch = -1          # epoch currently producing / produced
        self._queues: List[deque] = [deque() for _ in range(n)]
        self._rows: List[int] = [0] * n
        self._producer_done = True
        self._producer_error: Optional[str] = None

    def start_epoch(self, epoch: int) -> bool:
        """Idempotent across the n consumers: the first call for the next
        epoch starts its producer thread. Returns False (caller retries)
        while the previous epoch is still streaming OR any consumer still
        has undrained blocks — advancing then would silently truncate a
        slower consumer's epoch."""
        with self._lock:
            if epoch <= self._epoch:
                return True  # already started (or past)
            if not self._producer_done or any(self._queues):
                return False
            self._epoch = epoch
            self._queues = [deque() for _ in range(self._n)]
            self._rows = [0] * self._n
            self._producer_done = False
            self._producer_error = None
        t = threading.Thread(target=self._produce, args=(epoch,), daemon=True)
        t.start()
        return True

    def _deliver(self, epoch: int, target: int, ref) -> bool:
        """Queue one ref for a split with backpressure; False when the
        epoch was superseded."""
        with self._cond:
            while (len(self._queues[target]) >= _split_queue_depth()
                   and self._epoch == epoch):
                self._cond.wait(timeout=1.0)
            if self._epoch != epoch:
                return False
            self._queues[target].append(ref)
            self._cond.notify_all()
        return True

    def _produce(self, epoch: int):
        from ray_tpu_torch.data.executor import StreamingExecutor

        # Fractional CPU: row counting / boundary slicing must schedule
        # even on a cluster whose whole-CPU budget is held by
        # trainer/accumulator actors.
        count_fn = rt.remote(_block_rows).options(
            max_retries=-1, num_cpus=0.01
        )
        try:
            executor = StreamingExecutor(list(self._stages))
            rr = 0
            # equal=True state: each split's most recent block stays held
            # back (ref, nrows) so end-of-stream can slice the boundary.
            holds: List = [None] * self._n
            delivered = [0] * self._n
            for ref in executor.execute_iter(self._input_refs):
                if not self._equal:
                    with self._cond:
                        target = rr % self._n
                        rr += 1
                    if not self._deliver(epoch, target, ref):
                        return
                    continue
                nrows = rt.get(count_fn.remote(ref), timeout=120)
                with self._lock:
                    target = min(range(self._n), key=lambda i: self._rows[i])
                    self._rows[target] += nrows
                if holds[target] is not None:
                    prev_ref, prev_rows = holds[target]
                    if not self._deliver(epoch, target, prev_ref):
                        return
                    delivered[target] += prev_rows
                holds[target] = (ref, nrows)
            if self._equal and not self._finish_equal(
                epoch, holds, delivered
            ):
                return
        except Exception as e:  # noqa: BLE001 — surface to consumers
            with self._cond:
                self._producer_error = f"{type(e).__name__}: {e}"
        finally:
            with self._cond:
                self._producer_done = True
                self._cond.notify_all()

    def _finish_equal(self, epoch: int, holds: List,
                      delivered: List[int]) -> bool:
        """End-of-stream equalizer: slice the held-back boundary blocks
        so every split delivers exactly total // n rows (reference:
        dataset.py:1161 equal=True semantics; up to n-1 remainder rows
        drop). The greedy least-loaded invariant guarantees each split's
        excess over the global share fits inside its own holdback."""
        slice_fn = rt.remote(_block_slice_rows).options(
            max_retries=-1, num_cpus=0.01
        )
        total = sum(delivered) + sum(h[1] for h in holds if h)
        share = total // self._n
        pool: deque = deque()  # (ref, offset, remaining) spare rows
        plans: List[List] = [[] for _ in range(self._n)]
        needs = [0] * self._n
        for i in range(self._n):
            need = share - delivered[i]
            if holds[i] is not None:
                ref, nrows = holds[i]
                take = min(need, nrows)
                if take == nrows:
                    plans[i].append((ref, nrows))
                elif take > 0:
                    plans[i].append((slice_fn.remote(ref, 0, take), take))
                if nrows - take > 0:
                    pool.append((ref, take, nrows - take))
                need -= take
            needs[i] = need
        for i in range(self._n):
            while needs[i] > 0:
                ref, off, rem = pool.popleft()
                take = min(needs[i], rem)
                plans[i].append(
                    (slice_fn.remote(ref, off, off + take), take)
                )
                needs[i] -= take
                if rem - take > 0:
                    pool.appendleft((ref, off + take, rem - take))
        for i, plan in enumerate(plans):
            for ref, nrows in plan:
                if not self._deliver(epoch, i, ref):
                    return False
        with self._lock:
            self._rows = [share] * self._n
        return True

    def next_blocks(self, epoch: int, split_idx: int, max_blocks: int = 2):
        """Blocking pull: up to max_blocks refs for one split, or
        {"done": True} at end of the split's epoch stream."""
        with self._cond:
            while True:
                if self._producer_error:
                    raise RuntimeError(
                        f"streaming_split producer failed: {self._producer_error}"
                    )
                if epoch > self._epoch:
                    # Our epoch hasn't started yet (another consumer is
                    # still draining the previous one): wait for it.
                    self._cond.wait(timeout=1.0)
                    continue
                if epoch < self._epoch:
                    # Superseded. start_epoch refuses to advance while any
                    # queue holds blocks, so nothing was dropped — this
                    # consumer already drained its split.
                    return {"blocks": [], "done": True}
                q = self._queues[split_idx]
                if q:
                    out = [q.popleft() for _ in range(min(max_blocks, len(q)))]
                    self._cond.notify_all()
                    return {"blocks": out, "done": False}
                if self._producer_done:
                    return {"blocks": [], "done": True}
                self._cond.wait(timeout=1.0)

    def stats(self):
        with self._lock:
            return {"epoch": self._epoch, "rows_per_split": list(self._rows)}


class DataIterator:
    """Per-worker view of one split. Each iteration call (iter_rows /
    iter_batches / iter_blocks) consumes ONE epoch: the underlying
    pipeline re-executes per epoch, coordinated across the n iterators
    (reference: data/iterator.py DataIterator semantics)."""

    def __init__(self, coordinator, split_idx: int, n: int,
                 prefetch_blocks: Optional[int] = None):
        from ray_tpu_torch._private.config import get_config

        self._coord = coordinator
        self._idx = split_idx
        self._n = n
        self._epoch = 0
        # Blocks requested per coordinator round trip AND pulled ahead of
        # consumption; threaded from train.DataConfig(prefetch_blocks=...)
        # (config default: data_iterator_prefetch_blocks).
        self._prefetch_blocks = (
            get_config().data_iterator_prefetch_blocks
            if prefetch_blocks is None else int(prefetch_blocks)
        )

    def iter_blocks(self) -> Iterator[Any]:
        import time as _time

        epoch = self._epoch
        self._epoch += 1
        # Idempotent across the n iterators; whoever arrives first starts
        # the epoch's producer. False = previous epoch still draining
        # elsewhere — retry until the coordinator can roll over.
        deadline = _time.monotonic() + 600
        while not rt.get(self._coord.start_epoch.remote(epoch)):
            if _time.monotonic() > deadline:
                raise TimeoutError(
                    f"epoch {epoch} never started: another split is still "
                    "consuming the previous epoch"
                )
            _time.sleep(0.05)
        max_blocks = max(1, self._prefetch_blocks)
        while True:
            out = rt.get(
                self._coord.next_blocks.remote(epoch, self._idx, max_blocks),
                timeout=600,
            )
            # Start every granted block's pull at once; the per-ref gets
            # below then overlap transfer with downstream batch work.
            rt.prefetch(out["blocks"])
            for ref in out["blocks"]:
                yield rt.get(ref)
            if out["done"]:
                return

    def stop(self):
        """Kill the shared coordinator actor (releases its hold on the
        dataset's input blocks). Call from the split's owner once ALL n
        iterators are finished — the trainer does this automatically."""
        try:
            rt.kill(self._coord)
        except Exception:  # noqa: BLE001 — already gone
            pass

    def iter_rows(self) -> Iterator[Any]:
        for block in self.iter_blocks():
            yield from B.block_to_rows(block)

    def iter_batches(self, batch_size: int = 256,
                     batch_format: str = "numpy",
                     prefetch_batches: Optional[int] = None) -> Iterator[Any]:
        """Re-batch this split's epoch stream. By default (prefetch_batches
        = config.data_feed_prefetch_batches) the pull + assembly runs on a
        background producer thread that stays that many ready batches
        ahead of the training step (data/feed.py), so trainer workers get
        the pipelined feed through session.get_dataset_shard with no code
        change; 0 assembles inline. Feed timings land in feed_stats()."""
        if prefetch_batches is None:
            from ray_tpu_torch._private.config import get_config

            prefetch_batches = get_config().data_feed_prefetch_batches
        if prefetch_batches and prefetch_batches > 0:
            from ray_tpu_torch.data.feed import FeedStats, _DevicePrefetcher

            self._last_feed_stats = FeedStats()
            return _DevicePrefetcher(
                lambda: self._iter_batches_local(batch_size, batch_format),
                depth=prefetch_batches,
                stats=self._last_feed_stats,
                name=f"split{self._idx}",
            )
        return self._iter_batches_local(batch_size, batch_format)

    def _iter_batches_local(self, batch_size: int,
                            batch_format: str) -> Iterator[Any]:
        rows: List[Any] = []
        for block in self.iter_blocks():
            rows.extend(B.block_to_rows(block))
            while len(rows) >= batch_size:
                chunk, rows = rows[:batch_size], rows[batch_size:]
                yield B.block_to_batch(B.block_from_rows(chunk), batch_format)
        if rows:
            yield B.block_to_batch(B.block_from_rows(rows), batch_format)

    def iter_torch_batches(self, batch_size: int = 256, dtypes=None,
                           device=None,
                           prefetch_batches: Optional[int] = None,
                           **kwargs) -> Iterator[Any]:
        """This split's epoch stream as dicts of torch tensors on
        `device` (Dataset.iter_torch_batches: the card this process was
        granted by default, staged prefetch_batches ahead). Batches are
        zero-copy numpy slices of the blocks, as Dataset's are. Feed
        timings land in feed_stats()."""
        from ray_tpu_torch.data.dataset import _numpy_batches
        from ray_tpu_torch.data.feed import FeedStats, torch_feed

        if kwargs:
            raise TypeError(
                f"a split has no batching options {sorted(kwargs)}")

        def new_stats():
            self._last_feed_stats = FeedStats()
            return self._last_feed_stats

        return torch_feed(
            lambda: _numpy_batches(self.iter_blocks(), batch_size),
            device=device, dtypes=dtypes, prefetch_batches=prefetch_batches,
            new_stats=new_stats, name=f"split{self._idx}")

    def feed_stats(self):
        """Snapshot of the newest prefetching iter_batches pipeline's
        timings (None before one runs)."""
        stats = getattr(self, "_last_feed_stats", None)
        return None if stats is None else stats.snapshot()

    def stats(self):
        return rt.get(self._coord.stats.remote())

    def __repr__(self):
        return f"DataIterator(split={self._idx}/{self._n}, epoch={self._epoch})"
