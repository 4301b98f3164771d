"""ActorPool: load-balance work over a fixed set of actors.

Analog of python/ray/util/actor_pool.py in the reference.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List

import ray_tpu_torch as rt


class ActorPool:
    def __init__(self, actors: List[Any]):
        self._idle = list(actors)
        self._future_to_actor = {}
        self._pending = []

    def submit(self, fn: Callable, value):
        if not self._idle:
            self._pending.append((fn, value))
            return
        actor = self._idle.pop()
        ref = fn(actor, value)
        self._future_to_actor[ref] = actor

    def has_next(self) -> bool:
        return bool(self._future_to_actor) or bool(self._pending)

    def get_next(self, timeout=None):
        if not self._future_to_actor:
            raise StopIteration("no pending results")
        ready, _ = rt.wait(
            list(self._future_to_actor), num_returns=1, timeout=timeout
        )
        if not ready:
            raise TimeoutError("get_next timed out")
        ref = ready[0]
        actor = self._future_to_actor.pop(ref)
        self._idle.append(actor)
        if self._pending:
            fn, value = self._pending.pop(0)
            self.submit(fn, value)
        return rt.get(ref)

    def map(self, fn: Callable, values: Iterable):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable):
        yield from self.map(fn, values)
