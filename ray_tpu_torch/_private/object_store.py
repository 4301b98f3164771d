"""Python client for the native shared-memory object store.

Binds ray_tpu_torch/native/object_store.cc via ctypes, built by
`_build.build_native` (the reference binds plasma
through Cython: python/ray/_raylet.pyx + object_manager/plasma/client.cc).
Data access is zero-copy: `get()` returns a memoryview directly over the
shared mapping; `put_serialized()` writes pickle5 out-of-band buffers
straight into the allocation.
"""

from __future__ import annotations

import atexit
import ctypes
import os
import threading
from typing import Optional

from ray_tpu_torch._build import build_native
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch.exceptions import ObjectStoreFullError

_lib = None
_lib_lock = threading.Lock()


def _load_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        # RT_STORE_LIB overrides the library (e.g. a sanitizer build).
        path = os.environ.get("RT_STORE_LIB") or str(build_native("object_store"))
        lib = ctypes.CDLL(path)
        lib.rt_store_open.restype = ctypes.c_void_p
        lib.rt_store_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int]
        lib.rt_store_close.argtypes = [ctypes.c_void_p]
        lib.rt_store_unlink.argtypes = [ctypes.c_char_p]
        lib.rt_store_base.restype = ctypes.c_void_p
        lib.rt_store_base.argtypes = [ctypes.c_void_p]
        lib.rt_store_create_object.restype = ctypes.c_int64
        lib.rt_store_create_object.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_uint64,
        ]
        lib.rt_store_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rt_store_get.restype = ctypes.c_int64
        lib.rt_store_get.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.rt_store_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rt_store_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rt_store_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rt_store_abort.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rt_store_evict.restype = ctypes.c_uint64
        lib.rt_store_evict.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.rt_store_stats.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint64 * 4),
        ]
        _lib = lib
        return lib


RT_OK = 0
RT_ERR_EXISTS = -1
RT_ERR_FULL = -2
RT_ERR_NOT_FOUND = -3
RT_ERR_NOT_SEALED = -4
RT_ERR_IN_USE = -5
RT_ERR_STATE = -6


class ObjectStore:
    """Handle to a shared-memory object store segment."""

    def __init__(self, name: str, size: int = 0, create: bool = False):
        self._lib = _load_lib()
        self.name = name
        self._owner = create
        self._handle = self._lib.rt_store_open(
            name.encode(), ctypes.c_uint64(size), 1 if create else 0
        )
        if not self._handle:
            raise OSError(f"failed to open object store segment {name!r}")
        self._base = self._lib.rt_store_base(self._handle)
        self._closed = False
        self._unmapped = False
        self._lock = threading.Lock()
        if create:
            atexit.register(self.destroy)

    # -- lifecycle ------------------------------------------------------

    def close(self, unmap: bool = True):
        """Close the handle. With unmap=False the shared mapping (and the
        handle) stay valid for the process lifetime — required when
        zero-copy views (numpy arrays over store memory) may still be
        alive; munmap under them is a segfault. Late release() calls are
        still honored in that mode so shared refcounts don't leak."""
        with self._lock:
            if not self._closed:
                if unmap:
                    self._lib.rt_store_close(self._handle)
                    self._unmapped = True
                self._closed = True

    def destroy(self):
        self.close()
        if self._owner:
            self._lib.rt_store_unlink(self.name.encode())
            self._owner = False

    # -- object ops -----------------------------------------------------

    def _view(self, offset: int, size: int) -> memoryview:
        return memoryview(
            (ctypes.c_char * size).from_address(self._base + offset)
        ).cast("B")

    def create(self, object_id: ObjectID, size: int) -> memoryview:
        """Allocate a writable buffer; caller must seal() when done."""
        off = self._lib.rt_store_create_object(
            self._handle, object_id.binary(), ctypes.c_uint64(size)
        )
        if off == RT_ERR_EXISTS:
            raise ValueError(f"object {object_id} already exists")
        if off == RT_ERR_FULL:
            raise ObjectStoreFullError(
                f"cannot allocate {size} bytes in store {self.name}"
            )
        return self._view(off, size)

    def seal(self, object_id: ObjectID):
        rc = self._lib.rt_store_seal(self._handle, object_id.binary())
        if rc != RT_OK:
            raise ValueError(f"seal({object_id}) failed: {rc}")

    def get(self, object_id: ObjectID) -> Optional[memoryview]:
        """Pin and return a read view, or None if absent. Pair with release()."""
        size = ctypes.c_uint64()
        off = self._lib.rt_store_get(
            self._handle, object_id.binary(), ctypes.byref(size)
        )
        if off in (RT_ERR_NOT_FOUND, RT_ERR_NOT_SEALED):
            return None
        return self._view(off, size.value)

    def release(self, object_id: ObjectID):
        self._lib.rt_store_release(self._handle, object_id.binary())

    def contains(self, object_id: ObjectID) -> bool:
        return bool(self._lib.rt_store_contains(self._handle, object_id.binary()))

    def contains_raw(self, id_bytes: bytes) -> bool:
        return bool(self._lib.rt_store_contains(self._handle, id_bytes))

    def delete(self, object_id: ObjectID) -> bool:
        return self._lib.rt_store_delete(self._handle, object_id.binary()) == RT_OK

    def abort(self, object_id: ObjectID):
        self._lib.rt_store_abort(self._handle, object_id.binary())

    def evict(self, nbytes: int) -> int:
        return self._lib.rt_store_evict(self._handle, ctypes.c_uint64(nbytes))

    def stats(self) -> dict:
        out = (ctypes.c_uint64 * 4)()
        self._lib.rt_store_stats(self._handle, ctypes.byref(out))
        return {
            "used_bytes": out[0],
            "num_objects": out[1],
            "num_evictions": out[2],
            "heap_size": out[3],
        }

    # -- high-level helpers ---------------------------------------------

    def put_serialized(self, object_id: ObjectID, serialized) -> bool:
        """Write a SerializedObject directly into shared memory.

        Returns False if the object already exists (put is idempotent,
        matching plasma's ObjectExists handling).
        """
        try:
            buf = self.create(object_id, serialized.total_size)
        except ValueError:
            return False
        serialized.write_into(buf)
        del buf
        self.seal(object_id)
        self.release(object_id)
        return True

    def put_bytes(self, object_id: ObjectID, data: bytes) -> bool:
        try:
            buf = self.create(object_id, len(data))
        except ValueError:
            return False
        buf[: len(data)] = data
        del buf
        self.seal(object_id)
        self.release(object_id)
        return True
