"""Export / import of remote functions and actor classes through the GCS KV.

Analog of the reference's FunctionActorManager
(python/ray/_private/function_manager.py:62): the driver pickles the
function/class once, exports it under a content-addressed key, and workers
fetch + cache by key.
"""

from __future__ import annotations

import hashlib
import threading
import weakref
from typing import Any, Dict

from ray_tpu_torch._vendor import cloudpickle

_NS = "fn"


def function_key(pickled: bytes) -> bytes:
    return hashlib.blake2b(pickled, digest_size=16).digest()


class FunctionManager:
    def __init__(self, client):
        # `client` provides kv_put / kv_get (sync wrappers over GCS).
        self._client = client
        self._exported: set = set()
        self._cache: Dict[bytes, Any] = {}
        self._lock = threading.Lock()
        # Same-object fast path: pickling the function on every submit just
        # to compute its key was ~90us/task on the hot path. Weak keys so a
        # collected function can't alias a recycled id.
        self._id_cache: "weakref.WeakKeyDictionary[Any, bytes]" = (
            weakref.WeakKeyDictionary()
        )

    def export(self, obj: Any) -> bytes:
        try:
            key = self._id_cache.get(obj)
        except TypeError:  # unhashable / not weakref-able
            key = None
        if key is not None:
            return key
        pickled = cloudpickle.dumps(obj)
        key = function_key(pickled)
        with self._lock:
            if key in self._exported:
                try:
                    self._id_cache[obj] = key
                except TypeError:
                    pass
                return key
        self._client.kv_put(key, pickled, ns=_NS, overwrite=False)
        with self._lock:
            self._exported.add(key)
            self._cache[key] = obj
        try:
            self._id_cache[obj] = key
        except TypeError:
            pass
        return key

    def fetch(self, key: bytes) -> Any:
        with self._lock:
            if key in self._cache:
                return self._cache[key]
        pickled = self._client.kv_get(key, ns=_NS)
        if pickled is None:
            raise KeyError(f"function {key.hex()} not found in GCS")
        obj = cloudpickle.loads(pickled)
        with self._lock:
            self._cache[key] = obj
        return obj
