"""Distributed FIFO queue backed by an actor.

Analog of python/ray/util/queue.py in the reference.
"""

from __future__ import annotations

import time
from typing import Any, List, Optional

import ray_tpu_torch as rt


class Empty(Exception):
    pass


class Full(Exception):
    pass


@rt.remote
class _QueueActor:
    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self.items: List[Any] = []

    def put(self, item) -> bool:
        if self.maxsize > 0 and len(self.items) >= self.maxsize:
            return False
        self.items.append(item)
        return True

    def get(self) -> tuple:
        if not self.items:
            return False, None
        return True, self.items.pop(0)

    def qsize(self) -> int:
        return len(self.items)

    def empty(self) -> bool:
        return not self.items

    def full(self) -> bool:
        return self.maxsize > 0 and len(self.items) >= self.maxsize


class Queue:
    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        opts = actor_options or {}
        self.actor = _QueueActor.options(**opts).remote(maxsize)

    def put(self, item, block: bool = True, timeout: Optional[float] = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if rt.get(self.actor.put.remote(item)):
                return
            if not block or (deadline and time.monotonic() > deadline):
                raise Full()
            time.sleep(0.01)

    def get(self, block: bool = True, timeout: Optional[float] = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ok, item = rt.get(self.actor.get.remote())
            if ok:
                return item
            if not block or (deadline and time.monotonic() > deadline):
                raise Empty()
            time.sleep(0.01)

    def put_nowait(self, item):
        self.put(item, block=False)

    def get_nowait(self):
        return self.get(block=False)

    def qsize(self) -> int:
        return rt.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return rt.get(self.actor.empty.remote())

    def full(self) -> bool:
        return rt.get(self.actor.full.remote())

    def shutdown(self):
        rt.kill(self.actor)
