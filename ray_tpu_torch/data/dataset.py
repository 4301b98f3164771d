"""Dataset: lazy logical plans over distributed blocks (the port of
ray_tpu/data/dataset.py).

Analog of the reference's Dataset (python/ray/data/dataset.py:142): a
logical plan (data/_internal/plan.py:35) of operations over blocks stored
in the shared-memory object store, executed lazily by the streaming
executor. Covers the core transform surface: map / map_batches / filter /
flat_map / repartition / random_shuffle / sort / union / limit /
groupby-aggregate, consumption (take / count / iter_rows / iter_batches),
and train-ingest splitting (split(n) feeding one shard per worker,
reference: data/iterator.py + train/_internal/data_config.py).

Differences from the JAX package, by design:
  * iter_torch_batches takes the place of both iter_jax_batches and the
    JAX package's CPU-only iter_torch_batches: batches go to the card this
    process was granted through the pinned, prefetching feed of feed.py
    (device="cpu" only when asked for).
  * A map_batches UDF that returns a column of multi-dimensional arrays
    gets a tensor column (tensor.py) instead of one ndarray per row, so a
    fixed-shape column (token windows, images) reaches the feed as one
    zero-copy (N, *shape) view.
"""

from __future__ import annotations

import os
import random as _random
import zlib

import numpy as np
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import ray_tpu_torch as rt
from ray_tpu_torch.data import block as B
from ray_tpu_torch.data.executor import (
    ActorPoolStage,
    ActorPoolStrategy,
    AllToAllStage,
    MapStage,
    StreamingExecutor,
)


class Dataset:
    def __init__(self, input_refs: List, stages: Optional[List] = None):
        self._input_refs = list(input_refs)
        self._stages = list(stages or [])
        self._materialized: Optional[List] = None
        self._stats: List[Dict] = []
        self._last_feed_stats = None  # FeedStats of the newest feed pipeline

    # -- plan building ---------------------------------------------------
    def _with_stage(self, stage) -> "Dataset":
        return Dataset(self._input_refs, self._stages + [stage])

    def map(self, fn: Callable[[Any], Any]) -> "Dataset":
        def block_fn(block):
            return B.block_from_rows([fn(r) for r in B.block_to_rows(block)])

        return self._with_stage(MapStage(block_fn, name="map"))

    def map_batches(
        self,
        fn: Callable,
        batch_format: str = "numpy",
        compute: Optional["ActorPoolStrategy"] = None,
        fn_constructor_args: tuple = (),
        fn_constructor_kwargs: Optional[dict] = None,
        resources: Optional[dict] = None,
    ) -> "Dataset":
        """Transform batches. With `compute=ActorPoolStrategy(size=N)`,
        `fn` is a CLASS constructed once per pool actor (state — e.g. a
        model on the actor's card — loads once and serves every batch
        routed to that actor); otherwise `fn` runs as stateless tasks.
        Each block is handed to `fn` whole, as one batch."""
        if compute is not None:
            ctor_kwargs = fn_constructor_kwargs or {}

            def factory(cls=fn, a=tuple(fn_constructor_args), kw=ctor_kwargs):
                return cls(*a, **kw)

            def pool_fn(state, block, _fmt=batch_format):
                batch = B.block_to_batch(block, _fmt)
                return _batch_out_to_block(state(batch))

            return self._with_stage(ActorPoolStage(
                factory=factory,
                fn=pool_fn,
                name="map_batches(actors)",
                pool_size=compute.size,
                max_in_flight_per_actor=compute.max_tasks_in_flight_per_actor,
                resources=resources,
            ))

        def block_fn(block):
            batch = B.block_to_batch(block, batch_format)
            return _batch_out_to_block(fn(batch))

        return self._with_stage(
            MapStage(block_fn, name="map_batches", resources=resources)
        )

    def filter(self, fn: Callable[[Any], bool]) -> "Dataset":
        def block_fn(block):
            return B.block_from_rows(
                [r for r in B.block_to_rows(block) if fn(r)]
            )

        return self._with_stage(MapStage(block_fn, name="filter"))

    def flat_map(self, fn: Callable[[Any], List[Any]]) -> "Dataset":
        def block_fn(block):
            rows = []
            for r in B.block_to_rows(block):
                rows.extend(fn(r))
            return B.block_from_rows(rows)

        return self._with_stage(MapStage(block_fn, name="flat_map"))

    def repartition(self, num_blocks: int) -> "Dataset":
        def all_fn(refs):
            return _repartition_refs(refs, num_blocks)

        return self._with_stage(AllToAllStage(all_fn, name="repartition"))

    def random_shuffle(self, seed: Optional[int] = None) -> "Dataset":
        def all_fn(refs):
            return _shuffle_refs(refs, seed)

        return self._with_stage(AllToAllStage(all_fn, name="random_shuffle"))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        def all_fn(refs):
            return _sort_refs(refs, key, descending)

        return self._with_stage(AllToAllStage(all_fn, name="sort"))

    def union(self, other: "Dataset") -> "Dataset":
        left = self.materialize()
        right = other.materialize()
        return Dataset(left._input_refs + right._input_refs)

    def limit(self, n: int) -> "Dataset":
        """First n rows, formed from block refs: whole blocks pass by
        reference, the boundary block is sliced in a remote task."""
        refs = self._executed_refs()
        count_fn = rt.remote(_block_count).options(max_retries=-1)
        counts = rt.get([count_fn.remote(r) for r in refs])
        slice_fn = rt.remote(_slice_block).options(max_retries=-1)
        out: List = []
        remaining = n
        for ref, c in zip(refs, counts):
            if remaining <= 0:
                break
            if c <= remaining:
                out.append(ref)
                remaining -= c
            else:
                out.append(slice_fn.remote(ref, 0, remaining))
                remaining = 0
        return Dataset(out if out else [rt.put(B.block_from_rows([]))])

    def train_test_split(self, test_size, *, shuffle: bool = False,
                         seed: Optional[int] = None):
        """Split into (train, test) Datasets (reference:
        Dataset.train_test_split). test_size: float fraction of rows or
        absolute int count; shuffle applies a random_shuffle first.
        Formed from block refs like limit(): whole blocks pass by
        reference, boundary blocks slice in remote tasks."""
        ds = self.random_shuffle(seed=seed) if shuffle else self
        refs = ds._executed_refs()
        count_fn = rt.remote(_block_count).options(max_retries=-1)
        counts = rt.get([count_fn.remote(r) for r in refs])
        total = sum(counts)
        if isinstance(test_size, (float, np.floating)):
            if not 0.0 < test_size < 1.0:
                raise ValueError("float test_size must be in (0, 1)")
            test_n = int(total * float(test_size))
        elif isinstance(test_size, (int, np.integer)) and not isinstance(
            test_size, bool
        ):
            test_n = int(test_size)
        else:
            raise TypeError(
                f"test_size must be a float fraction or int count, "
                f"got {type(test_size).__name__}"
            )
        if not 0 <= test_n <= total:
            raise ValueError(
                f"test_size {test_size} out of range for {total} rows"
            )
        train_n = total - test_n
        slice_fn = rt.remote(_slice_block).options(max_retries=-1)
        train_refs: List = []
        test_refs: List = []
        seen = 0
        for ref, c in zip(refs, counts):
            lo, hi = seen, seen + c
            seen = hi
            if hi <= train_n:
                train_refs.append(ref)
            elif lo >= train_n:
                test_refs.append(ref)
            else:  # boundary block straddles the split point
                train_refs.append(slice_fn.remote(ref, 0, train_n - lo))
                test_refs.append(slice_fn.remote(ref, train_n - lo, c))
        empty = lambda: [rt.put(B.block_from_rows([]))]  # noqa: E731
        return (
            Dataset(train_refs or empty()),
            Dataset(test_refs or empty()),
        )

    def add_column(self, name: str, fn: Callable[[Any], Any]) -> "Dataset":
        """Row -> value for a new column (reference: Dataset.add_column)."""
        def block_fn(block):
            return B.block_from_rows(
                [{**r, name: fn(r)} for r in B.block_to_rows(block)]
            )

        return self._with_stage(MapStage(block_fn, name="add_column"))

    def drop_columns(self, cols: List[str]) -> "Dataset":
        drop = set(cols)

        def block_fn(block):
            return B.block_from_rows(
                [{k: v for k, v in r.items() if k not in drop}
                 for r in B.block_to_rows(block)]
            )

        return self._with_stage(MapStage(block_fn, name="drop_columns"))

    def select_columns(self, cols: List[str]) -> "Dataset":
        keep = list(cols)

        def block_fn(block):
            return B.block_from_rows(
                [{k: r[k] for k in keep} for r in B.block_to_rows(block)]
            )

        return self._with_stage(MapStage(block_fn, name="select_columns"))

    def random_sample(self, fraction: float,
                      seed: Optional[int] = None) -> "Dataset":
        """Bernoulli row sample (reference: Dataset.random_sample). The
        seed salts per block (the repo's _shuffle_map_block convention) so
        blocks draw independent sequences, not one repeated mask."""
        def block_fn(block, index):
            rows = B.block_to_rows(block)
            rng = _random.Random(None if seed is None else seed + index)
            return B.block_from_rows(
                [r for r in rows if rng.random() < fraction]
            )

        return self._with_stage(
            MapStage(block_fn, name="random_sample", with_index=True)
        )

    def zip(self, other: "Dataset") -> "Dataset":
        """Row-wise zip of two equal-length datasets (reference:
        Dataset.zip). Clashing right-side column names are suffixed with
        "_1" (left value kept under the original name). When per-block row
        counts align, blocks zip pairwise in remote tasks; otherwise one
        remote task merges (rows never pass through the driver)."""
        left = self.materialize()
        right = other.materialize()
        lrefs, rrefs = left._input_refs, right._input_refs
        count_fn = rt.remote(_block_count).options(max_retries=-1)
        lc = rt.get([count_fn.remote(r) for r in lrefs])
        rc = rt.get([count_fn.remote(r) for r in rrefs])
        if sum(lc) != sum(rc):
            raise ValueError(
                f"zip requires equal lengths, got {sum(lc)} vs {sum(rc)}"
            )
        zip_fn = rt.remote(_zip_blocks).options(max_retries=-1)
        if lc == rc:
            return Dataset(
                [zip_fn.remote(a, b) for a, b in zip(lrefs, rrefs)]
            )
        # Misaligned blocks: one worker-side merge (driver touches refs).
        merged = rt.remote(_zip_all).options(num_returns=1).remote(
            len(lrefs), *lrefs, *rrefs
        )
        return Dataset([merged])

    # -- aggregation -----------------------------------------------------
    def groupby(self, key: str) -> "GroupedData":
        return GroupedData(self, key)

    def aggregate(self, *aggs) -> Dict[str, Any]:
        """Distributed aggregation: one remote partial-state task per
        block, tiny states merged on the driver (reference:
        Dataset.aggregate over AggregateFn, data/aggregate.py)."""
        from ray_tpu_torch.data import aggregate as A

        aggs = list(aggs)
        fn = rt.remote(A.partial_states).options(max_retries=-1)
        state_refs = [fn.remote(ref, aggs) for ref in self._executed_refs()]
        values = A.merge_states(rt.get(state_refs), aggs)
        return {agg.name: v for agg, v in zip(aggs, values)}

    def sum(self, column: str):
        from ray_tpu_torch.data.aggregate import Sum

        return self.aggregate(Sum(column))[f"sum({column})"]

    def mean(self, column: str):
        from ray_tpu_torch.data.aggregate import Mean

        return self.aggregate(Mean(column))[f"mean({column})"]

    def min(self, column: str):
        from ray_tpu_torch.data.aggregate import Min

        return self.aggregate(Min(column))[f"min({column})"]

    def max(self, column: str):
        from ray_tpu_torch.data.aggregate import Max

        return self.aggregate(Max(column))[f"max({column})"]

    def std(self, column: str, ddof: int = 1):
        from ray_tpu_torch.data.aggregate import Std

        return self.aggregate(Std(column, ddof))[f"std({column})"]

    def unique(self, column: str) -> List[Any]:
        """Distinct values of a column (reference: Dataset.unique) —
        per-block distinct sets in remote tasks, union on the driver."""
        fn = rt.remote(_distinct_block).options(max_retries=-1)
        sets = rt.get([fn.remote(ref, column) for ref in self._executed_refs()])
        out = set()
        for s in sets:
            out |= s
        return sorted(out)

    # -- execution -------------------------------------------------------
    def materialize(self) -> "Dataset":
        """Execute the plan; the result holds only input refs."""
        if not self._stages:
            return self
        executor = StreamingExecutor(self._stages)
        refs = executor.execute(self._input_refs)
        out = Dataset(refs)
        out._stats = self._stats + executor.stats
        return out

    def stats(self) -> str:
        """Per-stage execution timing of the last materialization
        (reference: Dataset.stats / _internal/stats.py)."""
        if not self._stats and self._stages:
            self._executed_refs()
        lines = [
            f"Stage {i}: {s['stage']}: {s['blocks']} blocks, {s['wall_s']}s"
            for i, s in enumerate(self._stats)
        ]
        if self._last_feed_stats is not None:
            lines.append(self._last_feed_stats.render())
        return "\n".join(lines) if lines else "(no executed stages)"

    def _feed_stats(self):
        """Fresh FeedStats for a new feed pipeline, kept so stats() can
        report wait/assemble/h2d/stall numbers for the newest iterator."""
        from ray_tpu_torch.data.feed import FeedStats

        self._last_feed_stats = FeedStats()
        return self._last_feed_stats

    def _executed_refs(self) -> List:
        if self._materialized is None:
            m = self.materialize()
            self._materialized = m._input_refs
            self._stats = m._stats
        return self._materialized

    def _iter_blocks(self, prefetch_blocks: int = 1) -> Iterator:
        """Yield blocks; with prefetch_blocks > 0 the next k blocks' pulls
        START (rt.prefetch, a real background pull — a zero-timeout
        rt.wait was only a poll) while the current block is consumed, so
        cross-node transfer overlaps compute (reference: prefetching block
        iterator, data/iterator.py)."""
        refs = self._executed_refs()
        for i, ref in enumerate(refs):
            if prefetch_blocks > 0 and i + 1 < len(refs):
                rt.prefetch(refs[i + 1 : i + 1 + prefetch_blocks])
            yield rt.get(ref)

    # -- consumption -----------------------------------------------------
    def count(self) -> int:
        """Row count via per-block remote counts — blocks never move to
        the driver (reference: count() off metadata)."""
        fn = rt.remote(_block_count).options(max_retries=-1)
        return sum(
            rt.get([fn.remote(r) for r in self._executed_refs()])
        )

    def take(self, n: int = 20) -> List[Any]:
        out = []
        for block in self._iter_blocks():
            for r in B.block_to_rows(block):
                out.append(r)
                if len(out) >= n:
                    return out
        return out

    def take_all(self) -> List[Any]:
        out = []
        for block in self._iter_blocks():
            out.extend(B.block_to_rows(block))
        return out

    def iter_rows(self) -> Iterator[Any]:
        for block in self._iter_blocks():
            yield from B.block_to_rows(block)

    def iter_batches(self, batch_size: int = 256,
                     batch_format: str = "numpy",
                     prefetch_blocks: int = 1,
                     local_shuffle_buffer_size: Optional[int] = None,
                     local_shuffle_seed: Optional[int] = None,
                     prefetch_batches: int = 0) -> Iterator:
        """Re-batch across block boundaries (reference: data/iterator.py).

        local_shuffle_buffer_size enables the reference's windowed local
        shuffle: rows accumulate in a buffer of at least that size and
        batches draw from its seeded permutation — cheap randomization
        without a full distributed shuffle.

        prefetch_batches > 0 moves block pull + batch assembly onto a
        background producer thread that stays that many ready batches
        ahead (see data/feed.py), so the consumer's step time and the
        feed overlap instead of serializing.
        """
        if prefetch_batches and prefetch_batches > 0:
            from ray_tpu_torch.data.feed import _DevicePrefetcher

            return _DevicePrefetcher(
                lambda: self._iter_batches_local(
                    batch_size, batch_format, prefetch_blocks,
                    local_shuffle_buffer_size, local_shuffle_seed,
                ),
                depth=prefetch_batches,
                stats=self._feed_stats(),
            )
        return self._iter_batches_local(
            batch_size, batch_format, prefetch_blocks,
            local_shuffle_buffer_size, local_shuffle_seed,
        )

    def _iter_batches_local(self, batch_size: int, batch_format: str,
                            prefetch_blocks: int,
                            local_shuffle_buffer_size: Optional[int],
                            local_shuffle_seed: Optional[int]) -> Iterator:
        """Inline (consumer-thread) batch assembly."""
        if batch_format == "numpy" and not local_shuffle_buffer_size:
            yield from _numpy_batches(
                self._iter_blocks(prefetch_blocks=prefetch_blocks),
                batch_size)
            return
        rng = (
            _random.Random(local_shuffle_seed)
            if local_shuffle_buffer_size else None
        )
        threshold = max(local_shuffle_buffer_size or 0, batch_size)
        carry: List[Any] = []
        for block in self._iter_blocks(prefetch_blocks=prefetch_blocks):
            carry.extend(B.block_to_rows(block))
            if rng is not None and len(carry) >= threshold:
                # One permutation per buffer refill (O(buffer)), then
                # batches peel off it — not a re-shuffle per batch, which
                # made the draw loop O(buffer) PER BATCH. Seeded runs stay
                # deterministic: same seed, same refill sequence.
                rng.shuffle(carry)
            while len(carry) >= threshold:
                chunk, carry = carry[:batch_size], carry[batch_size:]
                yield B.block_to_batch(B.block_from_rows(chunk), batch_format)
        if rng is not None and carry:
            rng.shuffle(carry)
        while carry:
            chunk, carry = carry[:batch_size], carry[batch_size:]
            yield B.block_to_batch(B.block_from_rows(chunk), batch_format)

    def iter_torch_batches(self, batch_size: int = 256, dtypes=None,
                           device=None,
                           prefetch_batches: Optional[int] = None,
                           **kwargs) -> Iterator:
        """numpy batches as dicts of torch tensors on `device`, staged
        ahead of the consumer (the input-pipeline shape: the copy of
        batch i+1 to the card overlaps the step on batch i; reference:
        iter_torch_batches, data/iterator.py). `dtypes` maps column ->
        torch dtype, applied on the device.

        device=None is the card this process was granted and raises
        where there is none; pass device="cpu" for CPU tensors. By
        default (prefetch_batches=config.data_feed_prefetch_batches) the
        block pull, the batch assembly and the pinned copy to the card
        run on a producer thread that stays that many batches ahead;
        prefetch_batches=0 assembles inline with one copy in flight.
        kwargs: prefetch_blocks, local_shuffle_buffer_size,
        local_shuffle_seed (as iter_batches)."""
        from ray_tpu_torch.data.feed import torch_feed

        return torch_feed(
            lambda: self._iter_batches_local(
                batch_size, "numpy", kwargs.get("prefetch_blocks", 1),
                kwargs.get("local_shuffle_buffer_size"),
                kwargs.get("local_shuffle_seed"),
            ),
            device=device, dtypes=dtypes,
            prefetch_batches=prefetch_batches, new_stats=self._feed_stats,
        )

    def schema(self):
        for block in self._iter_blocks():
            return B.block_schema(block)
        return None

    def num_blocks(self) -> int:
        return len(self._executed_refs())

    # -- train ingest ----------------------------------------------------
    def split(self, n: int) -> List["Dataset"]:
        """Split into n equal shards, one per training worker (reference:
        Dataset.split(equal=True) feeding Train workers).

        Shards are formed from block REFS: whole blocks pass by reference
        and only the blocks straddling a shard boundary are sliced — in
        remote tasks. Rows never move through the driver, so the split
        scales with the cluster.
        """
        refs = self.materialize()._input_refs
        count_fn = rt.remote(_block_count).options(max_retries=-1)
        counts = rt.get([count_fn.remote(r) for r in refs])
        total = sum(counts)
        boundaries = [total * i // n for i in range(n + 1)]
        slice_fn = rt.remote(_slice_block).options(max_retries=-1)
        shard_refs: List[List] = [[] for _ in range(n)]
        offset = 0  # global row index of the current block's first row
        for ref, c in zip(refs, counts):
            if c == 0:
                continue
            for i in range(n):
                lo = max(boundaries[i], offset)
                hi = min(boundaries[i + 1], offset + c)
                if lo >= hi:
                    continue
                if lo == offset and hi == offset + c:
                    shard_refs[i].append(ref)  # whole block, no copy
                else:
                    shard_refs[i].append(
                        slice_fn.remote(ref, lo - offset, hi - offset)
                    )
            offset += c
        return [Dataset(sr if sr else [rt.put(B.block_from_rows([]))])
                for sr in shard_refs]

    def to_arrow(self):
        """Materialize as ONE pyarrow Table (reference:
        Dataset.to_arrow_refs, concatenated)."""
        blocks = rt.get(list(self._executed_refs()))
        return B.block_to_batch(B.block_concat(blocks), "pyarrow")

    def to_pandas(self, limit: Optional[int] = None):
        """Materialize as a pandas DataFrame (reference:
        Dataset.to_pandas; `limit` guards accidental huge pulls)."""
        ds = self.limit(limit) if limit is not None else self
        return ds.to_arrow().to_pandas()

    def streaming_split(self, n: int, equal: bool = True,
                        locality_hints: Optional[List] = None,
                        prefetch_blocks: Optional[int] = None) -> List:
        """n coordinated per-worker iterators over ONE shared streaming
        execution per epoch (reference: dataset.py:1161 streaming_split +
        StreamSplitDataIterator). Each DataIterator's iter_rows /
        iter_batches call consumes one epoch; the pipeline re-executes
        per epoch. equal=True balances splits by rows at block
        granularity. Input blocks are promoted to the shared store up
        front; pipeline stages stream. prefetch_blocks sets how many
        blocks each iterator requests (and pulls) ahead of consumption
        (default: config.data_iterator_prefetch_blocks)."""
        from ray_tpu_torch._vendor import cloudpickle

        from ray_tpu_torch.data.iterator import DataIterator, _SplitCoordinator

        coord = _SplitCoordinator.options(
            num_cpus=0.01, max_concurrency=2 * n + 4
        ).remote(
            self._input_refs, cloudpickle.dumps(self._stages), n, equal
        )
        return [DataIterator(coord, i, n, prefetch_blocks=prefetch_blocks)
                for i in range(n)]

    # -- output ----------------------------------------------------------
    def write_datasink(self, sink) -> List[Any]:
        """Write through the Datasink plugin surface: one remote write
        task per block, with driver-side start/complete/failed hooks
        (reference: datasink.py + plan_write_op)."""
        sink.on_write_start()
        write_fn = rt.remote(_run_write_task).options(max_retries=-1)
        refs = [
            write_fn.remote(sink, ref, i)
            for i, ref in enumerate(self._executed_refs())
        ]
        try:
            results = [r for r in rt.get(refs) if r is not None]
        except Exception as e:  # noqa: BLE001 — sink sees the failure
            sink.on_write_failed(e)
            raise
        sink.on_write_complete(results)
        return results

    def write_parquet(self, path: str, filesystem=None) -> List[str]:
        """One parquet file per block under `path` (reference:
        Dataset.write_parquet)."""
        from ray_tpu_torch.data.datasource import ParquetDatasink

        return self.write_datasink(ParquetDatasink(path, filesystem))

    def write_csv(self, path: str, filesystem=None) -> List[str]:
        from ray_tpu_torch.data.datasource import CSVDatasink

        return self.write_datasink(CSVDatasink(path, filesystem))

    def write_json(self, path: str, filesystem=None) -> List[str]:
        from ray_tpu_torch.data.datasource import JSONDatasink

        return self.write_datasink(JSONDatasink(path, filesystem))

    def __repr__(self):
        return (
            f"Dataset(blocks={len(self._input_refs)}, "
            f"pending_stages={[getattr(s, 'name', '?') for s in self._stages]})"
        )


class GroupedData:
    """Distributed groupby (reference: data grouped_data.py).

    Hash-partitions rows by key across remote reduce tasks (each key's
    rows land in exactly one partition), then each partition groups and
    aggregates locally — the reference's hash-shuffle groupby exchange.
    Rows never pass through the driver.
    """

    def __init__(self, ds: Dataset, key: str):
        self.ds = ds
        self.key = key

    def _shuffled_partitions(self) -> List:
        refs = self.ds.materialize()._input_refs
        n = max(len(refs), 1)
        map_fn = rt.remote(_hash_partition_block).options(max_retries=-1)
        pieces: List[List] = []
        for ref in refs:
            out = map_fn.options(num_returns=n).remote(ref, n, self.key)
            pieces.append([out] if n == 1 else list(out))
        return [[pieces[i][j] for i in range(len(refs))] for j in range(n)]

    def _reduce(self, reduce_fn, *args) -> Dataset:
        rfn = rt.remote(reduce_fn).options(max_retries=-1)
        out = [
            rfn.remote(self.key, *args, *partition)
            for partition in self._shuffled_partitions()
        ]
        return Dataset(out)

    def aggregate(self, *aggs) -> Dataset:
        """One result row per group with one column per AggregateFn."""
        return self._reduce(_group_aggregate, list(aggs))

    def count(self) -> Dataset:
        from ray_tpu_torch.data.aggregate import Count

        return self.aggregate(Count())

    def sum(self, column: str) -> Dataset:
        from ray_tpu_torch.data.aggregate import Sum

        return self.aggregate(Sum(column))

    def mean(self, column: str) -> Dataset:
        from ray_tpu_torch.data.aggregate import Mean

        return self.aggregate(Mean(column))

    def min(self, column: str) -> Dataset:
        from ray_tpu_torch.data.aggregate import Min

        return self.aggregate(Min(column))

    def max(self, column: str) -> Dataset:
        from ray_tpu_torch.data.aggregate import Max

        return self.aggregate(Max(column))

    def std(self, column: str, ddof: int = 1) -> Dataset:
        from ray_tpu_torch.data.aggregate import Std

        return self.aggregate(Std(column, ddof))

    def map_groups(self, fn: Callable[[List[dict]], Any]) -> Dataset:
        """Apply a UDF to each group's row list; the UDF returns a row or
        a list of rows (reference: GroupedData.map_groups)."""
        return self._reduce(_group_map, fn)


def _numpy_batches(blocks: Iterable, batch_size: int) -> Iterator:
    """Zero-copy numpy batching (SURVEY §7 "Plasma<->HBM boundary").

    Arrow blocks come out of the shared-memory store as zero-copy
    views (pickle5 out-of-band buffers); columns convert to numpy as
    views over the same buffers, and every batch fully inside one
    block is a SLICE of those views — no host->host copy anywhere on
    the path, so the feed's pinned copy is its only host copy. Only
    batches STRADDLING a block boundary pay one np.concatenate."""
    carry: Optional[dict] = None
    carry_rows = 0
    for block in blocks:
        cols = B.block_to_batch(block, "numpy")
        if not cols:
            continue
        n = len(next(iter(cols.values())))
        start = 0
        if carry_rows:
            if set(cols) != set(carry):
                # A batch straddling blocks with different column
                # sets cannot concatenate; fail with the schemas
                # instead of a bare KeyError from the carry merge.
                raise ValueError(
                    "schema mismatch across blocks: a batch "
                    f"straddles columns {sorted(carry)} vs "
                    f"{sorted(cols)}; make block schemas "
                    "consistent (e.g. map() filling missing "
                    "fields) or use iter_rows()"
                )
            need = batch_size - carry_rows
            if n < need:
                carry = {
                    k: np.concatenate([carry[k], v])
                    for k, v in cols.items()
                }
                carry_rows += n
                continue
            yield {
                k: np.concatenate([carry[k], v[:need]])
                for k, v in cols.items()
            }
            carry, carry_rows = None, 0
            start = need
        while start + batch_size <= n:
            yield {k: v[start:start + batch_size]
                   for k, v in cols.items()}
            start += batch_size
        if start < n:
            carry = {k: v[start:] for k, v in cols.items()}
            carry_rows = n - start
    if carry_rows:
        yield carry


def _stable_hash(value) -> int:
    """Process-stable, equality-consistent hash for shuffle keys.

    Python salts only str/bytes hashing per process (PYTHONHASHSEED), so
    those are rehashed with crc32; numeric types keep the builtin hash,
    which is unsalted and consistent across numeric types (True == 1 ==
    1.0 all co-partition, matching dict semantics)."""
    if isinstance(value, bytes):
        return zlib.crc32(value)
    if isinstance(value, str):
        return zlib.crc32(value.encode("utf-8", "surrogatepass"))
    if isinstance(value, tuple):
        h = 2166136261  # FNV-1a fold over element hashes
        for el in value:
            h = ((h ^ _stable_hash(el)) * 16777619) & 0xFFFFFFFF
        return h
    return hash(value) & 0xFFFFFFFF


def _hash_partition_block(block, n: int, key: str):
    """Partition one block's rows by hash(key) across n pieces."""
    parts: List[List] = [[] for _ in range(n)]
    for r in B.block_to_rows(block):
        parts[_stable_hash(r[key]) % n].append(r)
    out = tuple(B.block_from_rows(p) for p in parts)
    return out if n > 1 else out[0]


def _collect_groups(key: str, pieces) -> Dict[Any, List]:
    groups: Dict[Any, List] = {}
    for blk in pieces:
        for r in B.block_to_rows(blk):
            groups.setdefault(r[key], []).append(r)
    return groups


def _group_aggregate(key: str, aggs, *pieces):
    rows = []
    for k, group_rows in sorted(_collect_groups(key, pieces).items()):
        row = {key: k}
        for agg in aggs:
            row[agg.name] = agg.finalize(agg.partial(group_rows))
        rows.append(row)
    return B.block_from_rows(rows)


def _group_map(key: str, fn, *pieces):
    rows = []
    for _, group_rows in sorted(_collect_groups(key, pieces).items()):
        out = fn(group_rows)
        if isinstance(out, list):
            rows.extend(out)
        else:
            rows.append(out)
    return B.block_from_rows(rows)


def _distinct_block(block, column: str) -> set:
    return {r[column] for r in B.block_to_rows(block)}


def _slice_block(block, start: int, end: int):
    return B.block_slice(block, start, end)


# ---------------------------------------------------------------------------
# all-to-all implementations: push-based distributed shuffle
#
# Reference analog: push_based_shuffle_task_scheduler.py:382 — map tasks
# partition each block into N pieces (multi-return), reduce tasks merge
# piece i from every map. The driver only moves REFS; rows never pass
# through it, so shuffles scale with the cluster, not the driver.
# ---------------------------------------------------------------------------


def _shuffle_map_block(block, n: int, mode: str, key, seed, salt: int):
    """Partition one block's rows into n pieces (runs as a remote task)."""
    rows = B.block_to_rows(block)
    parts: List[List] = [[] for _ in range(n)]
    if mode == "random":
        rng = _random.Random(None if seed is None else seed + salt)
        for r in rows:
            parts[rng.randrange(n)].append(r)
    elif mode == "round_robin":
        for i, r in enumerate(rows):
            parts[i % n].append(r)
    else:  # range partition by sorted boundary list in `key`=(col, bounds)
        col, bounds = key
        import bisect

        for r in rows:
            parts[bisect.bisect_right(bounds, r[col])].append(r)
    out = tuple(B.block_from_rows(p) for p in parts)
    return out if n > 1 else out[0]


def _shuffle_reduce(mode: str, key, seed, salt: int, *pieces):
    """Merge piece blocks from every map task (runs as a remote task)."""
    rows: List = []
    for b in pieces:
        rows.extend(B.block_to_rows(b))
    if mode == "random":
        _random.Random(None if seed is None else seed + 7919 * (salt + 1)).shuffle(rows)
    elif mode == "range":
        col, descending = key
        rows.sort(key=lambda r: r[col], reverse=descending)
    return B.block_from_rows(rows)


def _concat_pieces(*pieces):
    """Order-preserving concat of piece blocks (shuffle combine step)."""
    rows: List = []
    for b in pieces:
        rows.extend(B.block_to_rows(b))
    return B.block_from_rows(rows)


# Max object args per reduce/combine task. A 1000-block shuffle would
# otherwise hand every reduce task 1000 object arguments (resolved and
# held in memory at once); the tree combine bounds per-task fan-in the
# way the reference's multi-round push-based shuffle bounds merge width
# (push_based_shuffle_task_scheduler.py: merge factor).
_SHUFFLE_FANIN = 64


def _push_shuffle(refs: List, n_out: int, mode: str, map_key, reduce_key,
                  seed=None) -> List:
    if not refs:
        return refs
    n_out = max(n_out, 1)
    map_fn = rt.remote(_shuffle_map_block).options(max_retries=-1)
    reduce_fn = rt.remote(_shuffle_reduce).options(max_retries=-1)
    combine_fn = rt.remote(_concat_pieces).options(max_retries=-1)
    pieces: List[List] = []  # [map][partition] -> ref
    for i, ref in enumerate(refs):
        out = map_fn.options(num_returns=n_out).remote(
            ref, n_out, mode, map_key, seed, i
        )
        pieces.append([out] if n_out == 1 else list(out))
    outs = []
    for j in range(n_out):
        parts = [pieces[i][j] for i in range(len(refs))]
        # Contiguous slices keep concat order stable, so seeded random
        # shuffles stay deterministic regardless of tree depth.
        while len(parts) > _SHUFFLE_FANIN:
            parts = [
                combine_fn.remote(*parts[k:k + _SHUFFLE_FANIN])
                for k in range(0, len(parts), _SHUFFLE_FANIN)
            ]
        outs.append(reduce_fn.remote(mode, reduce_key, seed, j, *parts))
    return outs


def _repartition_refs(refs: List, num_blocks: int) -> List:
    return _push_shuffle(refs, num_blocks, "round_robin", None, None)


def _shuffle_refs(refs: List, seed: Optional[int]) -> List:
    return _push_shuffle(refs, len(refs), "random", None, None, seed=seed)


def _sort_refs(refs: List, key: str, descending: bool) -> List:
    """Distributed range-partitioned sort: sample boundaries, range-shuffle,
    sort each partition (the reference's sort exchange, _internal/sort.py)."""
    n = max(len(refs), 1)
    # Sample keys from every block to pick n-1 partition boundaries
    # (all sample tasks in flight at once; one batched get).
    sample_fn = rt.remote(_sample_keys).options(max_retries=-1)
    sample_refs = [sample_fn.remote(ref, key, 16) for ref in refs]
    samples: List = [s for chunk in rt.get(sample_refs) for s in chunk]
    samples.sort()
    bounds = [
        samples[(i + 1) * len(samples) // n]
        for i in range(n - 1)
    ] if samples else []
    out = _push_shuffle(
        refs, n, "range", (key, bounds), (key, descending)
    )
    if descending:
        out = list(reversed(out))
    return out


def _block_count(block) -> int:
    return B.block_num_rows(block)


def _merge_zip_rows(a_rows, b_rows):
    rows = []
    for a, b in zip(a_rows, b_rows):
        merged = dict(a)
        for k, v in b.items():
            merged[k if k not in a else k + "_1"] = v
        rows.append(merged)
    return rows


def _zip_blocks(a_block, b_block):
    return B.block_from_rows(
        _merge_zip_rows(B.block_to_rows(a_block), B.block_to_rows(b_block))
    )


def _zip_all(n_left, *blocks):
    a_rows, b_rows = [], []
    for blk in blocks[:n_left]:
        a_rows.extend(B.block_to_rows(blk))
    for blk in blocks[n_left:]:
        b_rows.extend(B.block_to_rows(blk))
    return B.block_from_rows(_merge_zip_rows(a_rows, b_rows))


def _sample_keys(block, key: str, k: int):
    rows = B.block_to_rows(block)
    if len(rows) <= k:
        return [r[key] for r in rows]
    step = len(rows) / k
    return [rows[int(i * step)][key] for i in range(k)]


def _np_item(x):
    import numpy as np

    if isinstance(x, np.generic):
        return x.item()
    return x


def _batch_out_to_block(out):
    """Convert a map_batches UDF's return (column dict or row iterable)
    back to a block. A column dict holding a multi-dimensional array
    becomes a table with tensor columns (tensor.py)."""
    if isinstance(out, dict):
        if any(getattr(v, "ndim", 1) > 1 for v in out.values()):
            from ray_tpu_torch.data.tensor import table_with_tensors

            return table_with_tensors(out)
        keys = list(out.keys())
        n = len(out[keys[0]])
        rows = [{k: _np_item(out[k][i]) for k in keys} for i in range(n)]
        return B.block_from_rows(rows)
    return B.block_from_rows(list(out))


def _json_fallback(x):
    """json.dumps default= hook: arrays become lists; anything else raises
    (returning the object unchanged would recurse forever)."""
    import numpy as np

    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    raise TypeError(f"not JSON serializable: {type(x).__name__}")


# ---------------------------------------------------------------------------
# creation APIs
# ---------------------------------------------------------------------------


def from_items(items: List[Any], parallelism: int = 4) -> Dataset:
    items = list(items)
    if not items:
        return Dataset([rt.put(B.block_from_rows([]))])
    parallelism = max(1, min(parallelism, len(items)))
    per = (len(items) + parallelism - 1) // parallelism
    refs = [
        rt.put(B.block_from_rows(items[i * per : (i + 1) * per]))
        for i in range(parallelism)
        if items[i * per : (i + 1) * per]
    ]
    return Dataset(refs)


def range_dataset(n: int, parallelism: int = 4) -> Dataset:
    """Rows {"id": i}; generated inside read tasks, not on the driver."""
    from ray_tpu_torch.data.datasource import RangeDatasource

    return read_datasource(RangeDatasource(n), parallelism)


def from_pandas(dfs, parallelism: int = 4) -> Dataset:
    """DataFrame(s) -> Dataset, one arrow block per frame (reference:
    ray.data.from_pandas)."""
    import pyarrow as pa

    if not isinstance(dfs, (list, tuple)):
        dfs = [dfs]
    refs = [rt.put(pa.Table.from_pandas(df, preserve_index=False))
            for df in dfs]
    ds = Dataset(refs)
    if len(refs) < parallelism:
        ds = ds.repartition(parallelism)
    return ds


def from_arrow(tables, parallelism: int = 4) -> Dataset:
    """pyarrow Table(s) -> Dataset; tables ARE the block format, so this
    is zero-conversion (reference: ray.data.from_arrow)."""
    if not isinstance(tables, (list, tuple)):
        tables = [tables]
    refs = [rt.put(t) for t in tables]
    ds = Dataset(refs)
    if len(refs) < parallelism:
        ds = ds.repartition(parallelism)
    return ds


def from_numpy(arrays: Dict[str, Any], parallelism: int = 4) -> Dataset:
    from ray_tpu_torch.data.datasource import NumpyDatasource

    return read_datasource(NumpyDatasource(arrays), parallelism)


def _run_write_task(sink, block, index: int):
    """Remote-task body: hand one block to the Datasink."""
    return sink.write(block, {"task_index": index})


def _run_read_task(task):
    """Remote-task body: execute one ReadTask; concat its blocks."""
    blocks = task()
    if not blocks:
        return B.block_from_rows([])
    if len(blocks) == 1:
        return blocks[0]
    return B.block_concat(blocks)


def read_datasource(datasource, parallelism: int = 4) -> Dataset:
    """Parallel ingestion through the Datasource plugin surface: the
    source plans ReadTasks, each executes in a remote worker (reference:
    read_api.py:read_datasource -> plan_read_op)."""
    tasks = datasource.get_read_tasks(parallelism)
    if not tasks:
        return Dataset([rt.put(B.block_from_rows([]))])
    read_fn = rt.remote(_run_read_task).options(max_retries=-1)
    ds = Dataset([read_fn.remote(t) for t in tasks])
    if len(tasks) < parallelism:
        ds = ds.repartition(parallelism)
    return ds


def read_parquet(path: str, parallelism: int = 4, filesystem=None) -> Dataset:
    from ray_tpu_torch.data.datasource import ParquetDatasource

    return read_datasource(ParquetDatasource(path, filesystem), parallelism)


def read_csv(path: str, parallelism: int = 4, filesystem=None) -> Dataset:
    from ray_tpu_torch.data.datasource import CSVDatasource

    return read_datasource(CSVDatasource(path, filesystem), parallelism)


def read_json(path: str, parallelism: int = 4, filesystem=None) -> Dataset:
    from ray_tpu_torch.data.datasource import JSONDatasource

    return read_datasource(JSONDatasource(path, filesystem), parallelism)


def read_binary_files(path: str, parallelism: int = 4, filesystem=None) -> Dataset:
    """One row per file: {"path", "bytes"} (reference: read_binary_files)."""
    from ray_tpu_torch.data.datasource import BinaryDatasource

    return read_datasource(BinaryDatasource(path, filesystem), parallelism)


def read_images(path: str, parallelism: int = 4, filesystem=None,
                size=None, mode="RGB") -> Dataset:
    """Decoded image rows {"path", "image"} (reference: read_images);
    size=(h, w) resizes; mode="RGB" (default) makes every row (H, W, 3)
    uint8, mode="L" grayscale, mode=None keeps native per-file modes."""
    from ray_tpu_torch.data.datasource import ImageDatasource

    return read_datasource(
        ImageDatasource(path, filesystem, size=size, mode=mode), parallelism
    )


def read_numpy(path: str, parallelism: int = 4, filesystem=None) -> Dataset:
    """One row per .npy file: {"path", "data"} (reference: read_numpy)."""
    from ray_tpu_torch.data.datasource import NpyDatasource

    return read_datasource(NpyDatasource(path, filesystem), parallelism)


def read_text(path: str, parallelism: int = 4) -> Dataset:
    """One row per line: {"text": line} (reference: data read_text)."""
    from ray_tpu_torch.data.datasource import TextDatasource

    class _TxtSource(TextDatasource):
        _GLOB = "*.txt"

    return read_datasource(_TxtSource(path), parallelism)


def read_sql(sql: str, connection_factory, parallelism: int = 1,
             shard_column: str = None) -> Dataset:
    """Rows from a SQL query over a DB-API connection factory
    (reference: ray.data.read_sql). shard_column enables hash-sharded
    parallel reads."""
    from ray_tpu_torch.data.connectors import SQLDatasource

    return read_datasource(
        SQLDatasource(sql, connection_factory, shard_column), parallelism
    )


def read_tfrecords(path: str, parallelism: int = 4, filesystem=None,
                   raw: bool = False) -> Dataset:
    """TFRecord files of tf.train.Examples -> feature-dict rows
    (reference: ray.data.read_tfrecords; no tensorflow needed — the
    Example wire codec is built in)."""
    from ray_tpu_torch.data.connectors import TFRecordDatasource

    return read_datasource(
        TFRecordDatasource(path, filesystem, raw=raw), parallelism
    )


def read_webdataset(path: str, parallelism: int = 4,
                    filesystem=None) -> Dataset:
    """WebDataset tar shards -> one row per sample stem (reference:
    ray.data.read_webdataset)."""
    from ray_tpu_torch.data.connectors import WebDatasetDatasource

    return read_datasource(
        WebDatasetDatasource(path, filesystem), parallelism
    )


def read_mongo(db: str, collection: str, client_factory,
               filter: dict = None,  # noqa: A002 — pymongo name
               parallelism: int = 1) -> Dataset:
    """Documents from a MongoDB collection via an injectable pymongo-
    surface client factory (reference: ray.data.read_mongo)."""
    from ray_tpu_torch.data.connectors import MongoDatasource

    return read_datasource(
        MongoDatasource(db, collection, client_factory, filter), parallelism
    )


def read_bigquery(sql: str, client, parallelism: int = 1) -> Dataset:
    """Rows from a BigQuery query via an injectable client (reference:
    ray.data.read_bigquery)."""
    from ray_tpu_torch.data.connectors import BigQueryDatasource

    return read_datasource(BigQueryDatasource(sql, client), parallelism)
