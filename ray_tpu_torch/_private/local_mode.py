"""Local (in-process) execution mode.

Analog of the reference's local_mode in ray.init: tasks run synchronously
in the driver process, actors are plain in-process instances. Useful for
debugging user code and for fast unit tests of library layers.
"""

from __future__ import annotations

import concurrent.futures
from typing import Dict, List, Optional

from ray_tpu_torch._private.ids import ActorID, ObjectID
from ray_tpu_torch._private.worker import ActorHandle, ObjectRef, make_task_error, _rebuild_task_error
from ray_tpu_torch.exceptions import ActorDiedError


class _LocalRefGenerator:
    """Local-mode stand-in for ObjectRefGenerator: the task already ran
    eagerly, so iteration walks the stored item refs. A generator body
    that raised mid-way surfaces its error FROM ITERATION after the
    produced items — matching the real path, where the task future's
    error re-raises out of ObjectRefGenerator.__next__."""

    def __init__(self, refs: List[ObjectRef], error=None):
        self._refs = refs
        self._error = error
        self._i = 0

    def __iter__(self) -> "_LocalRefGenerator":
        return self

    def __next__(self) -> ObjectRef:
        if self._i >= len(self._refs):
            if self._error is not None:
                raise self._error
            raise StopIteration
        self._i += 1
        return self._refs[self._i - 1]

    def __len__(self) -> int:
        return len(self._refs)


class LocalClient:
    """Implements the CoreClient surface with synchronous local execution."""

    def __init__(self, resources: Optional[Dict[str, float]] = None):
        self.objects: Dict[bytes, object] = {}
        self.actors: Dict[bytes, object] = {}
        self.named: Dict[tuple, ActorID] = {}
        self.kv: Dict[tuple, bytes] = {}
        self.resources = dict(resources or {"CPU": 8.0})
        self.mode = "local"
        self.known_refs: Dict[bytes, ObjectRef] = {}

    # -- objects ---------------------------------------------------------
    def _store(self, value) -> ObjectRef:
        oid = ObjectID.from_random()
        self.objects[oid.binary()] = value
        fut = concurrent.futures.Future()
        fut.set_result(value)
        return ObjectRef(oid, fut)

    def put(self, value) -> ObjectRef:
        return self._store(value)

    def get(self, refs: List[ObjectRef], timeout=None):
        out = []
        for r in refs:
            if r._future is not None:
                r._future.result(timeout)
            if r.id.binary() not in self.objects:
                raise KeyError(f"object {r.hex()} not found (local mode)")
            out.append(self.objects[r.id.binary()])
        return out

    def wait(self, refs, num_returns, timeout, fetch_local=True):
        return refs[:num_returns], refs[num_returns:]

    def prefetch(self, refs) -> int:
        return 0  # everything is already local in local mode

    def _error_refs(self, err, num_returns):
        if num_returns == "dynamic":
            return [_LocalRefGenerator([], error=err)]
        refs = []
        for _ in range(num_returns):
            fut = concurrent.futures.Future()
            fut.set_exception(err)
            refs.append(ObjectRef(ObjectID.from_random(), fut))
        return refs

    def _result_refs(self, value, num_returns):
        if num_returns == "dynamic":
            import inspect as _inspect

            # Consume incrementally: a generator body that raises midway
            # keeps its produced items; the error re-raises from
            # iteration after them (real-path semantics).
            refs = []
            err = None
            try:
                if _inspect.isgenerator(value):
                    for v in value:
                        refs.append(self._store(v))
                else:
                    refs.append(self._store(value))
            except BaseException as e:  # noqa: BLE001
                err = _rebuild_task_error(make_task_error(e))
            return [_LocalRefGenerator(refs, error=err)]
        values = [value] if num_returns == 1 else list(value)
        return [self._store(v) for v in values]

    # -- tasks -----------------------------------------------------------
    def submit_task(self, fn, args, kwargs, name="", num_returns=1,
                    resources=None, scheduling=None, max_retries=None,
                    runtime_env=None, max_calls=None, priority=0):
        # max_calls and priority are no-ops in local mode: there is no
        # worker process to retire and no queue to reorder (everything
        # runs inline in the driver).
        try:
            value = fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001
            return self._error_refs(
                _rebuild_task_error(make_task_error(e)), num_returns
            )
        return self._result_refs(value, num_returns)

    # -- actors ----------------------------------------------------------
    def create_actor(self, cls, args, kwargs, name=None, namespace="",
                     resources=None, max_restarts=0, max_task_retries=0,
                     max_concurrency=1, scheduling=None, detached=False,
                     runtime_env=None, priority=0):
        instance = cls(*args, **kwargs)
        actor_id = ActorID.from_random()
        self.actors[actor_id.binary()] = instance
        if name:
            self.named[(namespace, name)] = actor_id
        methods = [m for m in dir(instance)
                   if callable(getattr(instance, m, None)) and not m.startswith("__")]
        return ActorHandle(actor_id, cls.__name__, methods, max_task_retries)

    def submit_actor_call(self, actor_id, method, args, kwargs,
                          num_returns=1, max_task_retries=0):
        instance = self.actors.get(actor_id.binary())
        if instance is None:
            raise ActorDiedError(f"actor {actor_id.hex()} not found (local mode)")
        import inspect, asyncio

        m = getattr(instance, method)
        try:
            if inspect.iscoroutinefunction(m):
                value = asyncio.run(m(*args, **kwargs))
            else:
                value = m(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001
            return self._error_refs(
                _rebuild_task_error(make_task_error(e)), num_returns
            )
        return self._result_refs(value, num_returns)

    def kill_actor(self, actor_id, no_restart=True):
        self.actors.pop(actor_id.binary(), None)

    def get_actor_by_name(self, name, namespace=""):
        aid = self.named.get((namespace, name))
        if aid is None or aid.binary() not in self.actors:
            raise ValueError(f"no live actor named {name!r}")
        instance = self.actors[aid.binary()]
        methods = [m for m in dir(instance)
                   if callable(getattr(instance, m, None)) and not m.startswith("__")]
        return ActorHandle(aid, type(instance).__name__, methods)

    # -- kv / cluster ----------------------------------------------------
    def kv_put(self, key, value, ns="", overwrite=True):
        if not overwrite and (ns, key) in self.kv:
            return False
        self.kv[(ns, key)] = value
        return True

    def kv_get(self, key, ns=""):
        return self.kv.get((ns, key))

    def kv_del(self, key, ns=""):
        return self.kv.pop((ns, key), None) is not None

    def kv_keys(self, prefix=b"", ns=""):
        return [k for (n, k) in self.kv if n == ns and k.startswith(prefix)]

    def nodes(self):
        return [{
            "node_id": b"local" * 3 + b"x",
            "state": "ALIVE",
            "address": "127.0.0.1",
            "resources_total": self.resources,
            "resources_available": self.resources,
            "is_head": True,
        }]

    def cluster_resources(self):
        return dict(self.resources)

    def available_resources(self):
        return dict(self.resources)

    def disconnect(self):
        self.objects.clear()
        self.actors.clear()
