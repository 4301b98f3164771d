"""Virtual actors: durable actor state addressed by a string id (the
port of ray_tpu/workflow/virtual_actor.py; the state file is the JAX
package's, so either package reads the other's actors).

Analog of the reference's workflow virtual actors (ray.workflow
virtual_actor decorator): unlike a regular actor — whose state lives in
one process and dies with it — a virtual actor's state lives in workflow
storage. Any process can `get_or_create` the same id, each method call
atomically advances the persisted state, and a crash between calls loses
nothing.

Durability contract: one method call = one atomic state transition.
State is persisted with write-then-rename AFTER the method returns, so a
crash mid-call leaves the previous state intact (the call simply never
happened). Methods marked @readonly skip persistence entirely.

    @workflow.virtual_actor
    class Counter:
        def __init__(self, start=0):
            self.value = start

        def add(self, n):
            self.value += n
            return self.value

        @workflow.readonly
        def get(self):
            return self.value

    c = Counter.get_or_create("my-counter", start=10)
    c.add(5)                                   # -> 15, persisted
    c2 = Counter.get_or_create("my-counter")   # any process, later
    c2.get()                                   # -> 15
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Any, Dict, Optional

from ray_tpu_torch.workflow import _checkpoint, _root


def readonly(fn):
    """Mark a virtual-actor method as non-mutating: it runs against the
    loaded state and skips the persistence step."""
    fn.__rt_readonly__ = True
    return fn


def virtual_actor(cls) -> "VirtualActorClass":
    """Class decorator turning a plain class into a virtual-actor class."""
    return VirtualActorClass(cls)


def _actor_dir(actor_id: str, storage: Optional[str]) -> str:
    return os.path.join(_root(storage), "virtual_actors", actor_id)


class VirtualActorClass:
    def __init__(self, cls):
        self._cls = cls
        self.__name__ = getattr(cls, "__name__", "VirtualActor")

    def get_or_create(self, actor_id: str, *args,
                      storage: Optional[str] = None,
                      **kwargs) -> "VirtualActorHandle":
        d = _actor_dir(actor_id, storage)
        state_path = os.path.join(d, "state.pkl")
        handle = VirtualActorHandle(self._cls, actor_id, d)
        if not os.path.exists(state_path):
            os.makedirs(d, exist_ok=True)
            # Initialization holds the same per-actor lock as _call:
            # without it, two creators can both see state.pkl missing and
            # the loser's late initial write (rename = last-writer-wins)
            # would clobber transitions the winner already committed.
            lock, token = handle._acquire()
            try:
                if not os.path.exists(state_path):
                    instance = self._cls(*args, **kwargs)
                    _checkpoint(state_path, {
                        "seq": 0,
                        "state": dict(instance.__dict__),
                        "created_at": time.time(),
                    })
            finally:
                handle._release(lock, token)
        return handle

    def exists(self, actor_id: str, storage: Optional[str] = None) -> bool:
        return os.path.exists(
            os.path.join(_actor_dir(actor_id, storage), "state.pkl")
        )


class _LockHeld(Exception):
    pass


class VirtualActorHandle:
    """Proxy whose attribute access returns callable method stubs."""

    def __init__(self, cls, actor_id: str, d: str):
        self._cls = cls
        self._actor_id = actor_id
        self._dir = d

    # -- state IO ---------------------------------------------------------
    def _load(self) -> Dict[str, Any]:
        with open(os.path.join(self._dir, "state.pkl"), "rb") as f:
            return pickle.load(f)

    def _persist(self, record: Dict[str, Any]):
        _checkpoint(os.path.join(self._dir, "state.pkl"), record)

    # -- locking (cross-process mutual exclusion per actor id) ------------
    def _acquire(self, timeout_s: float = 30.0):
        """Returns (lock_path, token). Release with _release — a blind
        unlink could delete a *different* holder's lock if ours was
        reaped as stale while we ran (slow user code past timeout_s)."""
        lock = os.path.join(self._dir, ".lock")
        token = f"{os.getpid()}:{time.monotonic_ns()}"
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.write(fd, token.encode())
                os.close(fd)
                return lock, token
            except FileExistsError:
                # Reap locks from dead holders (crash mid-call).
                try:
                    age = time.time() - os.path.getmtime(lock)
                    if age > timeout_s:
                        os.unlink(lock)
                        continue
                except OSError:
                    continue
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"virtual actor {self._actor_id!r} is locked"
                    ) from None
                time.sleep(0.02)

    @staticmethod
    def _release(lock: str, token: str):
        """Unlink the lock only if we still own it (our token inside)."""
        try:
            with open(lock, "rb") as f:
                if f.read().decode(errors="replace") != token:
                    return  # reaped as stale; someone else holds it now
            os.unlink(lock)
        except OSError:
            pass

    def _call(self, method_name: str, args, kwargs):
        fn = getattr(self._cls, method_name)
        is_readonly = getattr(fn, "__rt_readonly__", False)
        if is_readonly:
            record = self._load()
            instance = self._materialize(record)
            return fn(instance, *args, **kwargs)
        lock, token = self._acquire()
        try:
            record = self._load()
            instance = self._materialize(record)
            result = fn(instance, *args, **kwargs)
            # The atomic transition: a crash before this rename = the
            # call never happened; after = fully durable.
            self._persist({
                **record,
                "seq": record["seq"] + 1,
                "state": dict(instance.__dict__),
                "updated_at": time.time(),
            })
            return result
        finally:
            self._release(lock, token)

    def _materialize(self, record: Dict[str, Any]):
        instance = self._cls.__new__(self._cls)
        instance.__dict__.update(record["state"])
        return instance

    @property
    def seq(self) -> int:
        """Number of durable state transitions so far."""
        return self._load()["seq"]

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        if not callable(getattr(self._cls, name, None)):
            raise AttributeError(
                f"{self._cls.__name__} has no method {name!r}"
            )

        def stub(*args, **kwargs):
            return self._call(name, args, kwargs)

        stub.__name__ = name
        return stub
