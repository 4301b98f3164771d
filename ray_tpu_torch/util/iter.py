"""Parallel iterators over actor shards.

Analog of the reference's ``ray.util.iter`` (util/iter.py): partition a
sequence across actor shards, apply lazy transforms shard-side, and gather
(sync or batched) on the driver.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List

import ray_tpu_torch as rt


@rt.remote
class _ShardActor:
    def __init__(self, items: List[Any]):
        self.items = list(items)
        self.ops: List[tuple] = []

    def add_op(self, kind: str, fn):
        self.ops.append((kind, fn))

    def materialize(self) -> List[Any]:
        out: Iterable[Any] = self.items
        for kind, fn in self.ops:
            if kind == "map":
                out = [fn(x) for x in out]
            elif kind == "filter":
                out = [x for x in out if fn(x)]
            elif kind == "flat_map":
                out = [y for x in out for y in fn(x)]
            elif kind == "batch":
                out = list(out)
                out = [out[i : i + fn] for i in range(0, len(out), fn)]
        return list(out)


class ParallelIterator:
    def __init__(self, shards: List):
        self._shards = shards

    # -- transforms (lazy, shard-side) ------------------------------------
    def for_each(self, fn: Callable) -> "ParallelIterator":
        rt.get([s.add_op.remote("map", fn) for s in self._shards])
        return self

    def filter(self, fn: Callable) -> "ParallelIterator":
        rt.get([s.add_op.remote("filter", fn) for s in self._shards])
        return self

    def flat_map(self, fn: Callable) -> "ParallelIterator":
        rt.get([s.add_op.remote("flat_map", fn) for s in self._shards])
        return self

    def batch(self, n: int) -> "ParallelIterator":
        rt.get([s.add_op.remote("batch", n) for s in self._shards])
        return self

    # -- consumption -------------------------------------------------------
    def gather_sync(self) -> List[Any]:
        out: List[Any] = []
        for chunk in rt.get([s.materialize.remote() for s in self._shards]):
            out.extend(chunk)
        return out

    def num_shards(self) -> int:
        return len(self._shards)


def from_items(items: List[Any], num_shards: int = 2) -> ParallelIterator:
    shards = []
    per = max(1, (len(items) + num_shards - 1) // num_shards)
    for i in range(0, max(len(items), 1), per):
        shards.append(_ShardActor.remote(items[i : i + per]))
    return ParallelIterator(shards)


def from_range(n: int, num_shards: int = 2) -> ParallelIterator:
    return from_items(list(range(n)), num_shards)
