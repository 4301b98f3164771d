"""@remote actor classes.

Analog of python/ray/actor.py (ActorClass, _remote at :830 which calls
core_worker.create_actor; max_restarts/max_task_retries options at :75/:147).
"""

from __future__ import annotations

from typing import Any, Dict

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch.remote_function import _resources_from_options, _scheduling_from_options


class ActorClass:
    def __init__(self, cls, **options):
        self._cls = cls
        self._options = options
        self.__name__ = getattr(cls, "__name__", "ActorClass")

    def remote(self, *args, **kwargs):
        client = worker_mod.get_client()
        opts = self._options
        return client.create_actor(
            self._cls,
            args,
            kwargs,
            name=opts.get("name"),
            namespace=opts.get("namespace", ""),
            resources=_resources_from_options(opts),
            max_restarts=opts.get("max_restarts", 0),
            max_task_retries=opts.get("max_task_retries", 0),
            max_concurrency=opts.get("max_concurrency", 1),
            scheduling=_scheduling_from_options(opts),
            detached=opts.get("lifetime") == "detached",
            runtime_env=opts.get("runtime_env"),
            priority=int(opts.get("priority") or 0),
        )

    def options(self, **new_options):
        merged = {**self._options, **new_options}
        return ActorClass(self._cls, **merged)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class {self.__name__!r} cannot be instantiated directly; "
            f"use .remote(...)"
        )


def method(**options):
    """Decorator for per-method options (reference: ray.method)."""

    def decorator(fn):
        fn.__rt_method_options__ = options
        return fn

    return decorator
