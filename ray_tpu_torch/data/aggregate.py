"""Aggregate functions: distributed partial-aggregate / merge / finalize
(the port of ray_tpu/data/aggregate.py).

Analog of the reference's AggregateFn family (python/ray/data/aggregate.py:
Count/Sum/Min/Max/Mean/Std...). Each block computes a partial state in a
remote task; the driver merges the (tiny) states and finalizes — rows
never pass through the driver.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

from ray_tpu_torch.data import block as B


class AggregateFn:
    """One aggregation: block -> partial state, state x state -> state,
    state -> value."""

    name = "agg"

    def partial(self, rows: List[dict]) -> Any:
        raise NotImplementedError

    def merge(self, a: Any, b: Any) -> Any:
        raise NotImplementedError

    def finalize(self, state: Any) -> Any:
        return state


class Count(AggregateFn):
    name = "count()"

    def partial(self, rows):
        return len(rows)

    def merge(self, a, b):
        return a + b


class Sum(AggregateFn):
    def __init__(self, on: str):
        self.on = on
        self.name = f"sum({on})"

    def partial(self, rows):
        return sum(r[self.on] for r in rows)

    def merge(self, a, b):
        return a + b


class Min(AggregateFn):
    def __init__(self, on: str):
        self.on = on
        self.name = f"min({on})"

    def partial(self, rows):
        return min((r[self.on] for r in rows), default=None)

    def merge(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        return min(a, b)


class Max(AggregateFn):
    def __init__(self, on: str):
        self.on = on
        self.name = f"max({on})"

    def partial(self, rows):
        return max((r[self.on] for r in rows), default=None)

    def merge(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        return max(a, b)


class Mean(AggregateFn):
    def __init__(self, on: str):
        self.on = on
        self.name = f"mean({on})"

    def partial(self, rows) -> Tuple[float, int]:
        return (sum(r[self.on] for r in rows), len(rows))

    def merge(self, a, b):
        return (a[0] + b[0], a[1] + b[1])

    def finalize(self, state):
        total, count = state
        return total / count if count else None


class Std(AggregateFn):
    """Sample standard deviation via Chan et al.'s parallel variance
    merge (count/mean/M2 states combine exactly across blocks)."""

    def __init__(self, on: str, ddof: int = 1):
        self.on = on
        self.ddof = ddof
        self.name = f"std({on})"

    def partial(self, rows) -> Tuple[int, float, float]:
        n, mean, m2 = 0, 0.0, 0.0
        for r in rows:
            x = float(r[self.on])
            n += 1
            d = x - mean
            mean += d / n
            m2 += d * (x - mean)
        return (n, mean, m2)

    def merge(self, a, b):
        na, ma, m2a = a
        nb, mb, m2b = b
        n = na + nb
        if n == 0:
            return (0, 0.0, 0.0)
        delta = mb - ma
        mean = ma + delta * nb / n
        m2 = m2a + m2b + delta * delta * na * nb / n
        return (n, mean, m2)

    def finalize(self, state):
        n, _, m2 = state
        if n <= self.ddof:
            return None
        return (m2 / (n - self.ddof)) ** 0.5


def partial_states(block, aggs: List[AggregateFn]) -> List[Any]:
    """Remote-task body: all aggregates' partial states for one block."""
    rows = B.block_to_rows(block)
    return [agg.partial(rows) for agg in aggs]


def merge_states(states: List[List[Any]], aggs: List[AggregateFn]) -> List[Any]:
    """Driver-side merge of per-block partial states, then finalize."""
    out = []
    for i, agg in enumerate(aggs):
        acc: Optional[Any] = None
        first = True
        for s in states:
            acc = s[i] if first else agg.merge(acc, s[i])
            first = False
        out.append(agg.finalize(acc) if not first else None)
    return out
