"""Unique identifiers for cluster entities.

Rework of the reference ID scheme (src/ray/common/id.h and the
Cython wrappers in python/ray/includes/unique_ids.pxi). We keep the same
taxonomy — Job, Task, Object, Actor, Node, PlacementGroup, Worker — but use a
flat 16-byte random payload for every kind instead of the reference's
embedded-field encodings; lineage metadata lives in the GCS tables rather
than in the ID bits.
"""

from __future__ import annotations

import hashlib
import os
import threading

_ID_SIZE = 16

# os.urandom costs ~25µs a call on this class of host — material on the
# per-task submit path. Each thread slices IDs from a private pre-filled
# entropy pool instead (one urandom syscall per 256 IDs).
_POOL_IDS = 256
_entropy = threading.local()

# A forked child would inherit the parent's partially-consumed pool and
# mint byte-identical IDs; drop it so the child refills from the kernel.
os.register_at_fork(after_in_child=lambda: setattr(_entropy, "buf", None))


def _random_id_bytes() -> bytes:
    buf = getattr(_entropy, "buf", None)
    off = getattr(_entropy, "off", 0)
    if buf is None or off >= len(buf):
        buf = _entropy.buf = os.urandom(_ID_SIZE * _POOL_IDS)
        off = 0
    _entropy.off = off + _ID_SIZE
    return buf[off:off + _ID_SIZE]


class BaseID:
    """A 16-byte identifier, hashable and cheaply comparable."""

    __slots__ = ("_bytes", "_hash")

    def __init__(self, id_bytes: bytes):
        if not isinstance(id_bytes, bytes) or len(id_bytes) != _ID_SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {_ID_SIZE} bytes, got {id_bytes!r}"
            )
        self._bytes = id_bytes
        self._hash = None

    @classmethod
    def from_random(cls):
        return cls(_random_id_bytes())

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * _ID_SIZE)

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * _ID_SIZE

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __hash__(self):
        if self._hash is None:
            self._hash = hash((type(self).__name__, self._bytes))
        return self._hash

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __lt__(self, other):
        return self._bytes < other._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self._bytes.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    pass


class TaskID(BaseID):
    pass


class ObjectID(BaseID):
    pass


class ActorID(BaseID):
    pass


class NodeID(BaseID):
    pass


class WorkerID(BaseID):
    pass


class PlacementGroupID(BaseID):
    pass


class _Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def next(self) -> int:
        with self._lock:
            self._value += 1
            return self._value


_object_seq = _Counter()


def object_id_for_task(task_id: TaskID, return_index: int) -> ObjectID:
    """Deterministically derive a return-object ID from its creating task.

    Mirrors the reference's ObjectID::FromIndex (src/ray/common/id.h) so that
    lineage-based reconstruction can recompute the same IDs.
    """
    h = hashlib.blake2b(
        task_id.binary() + return_index.to_bytes(4, "little"), digest_size=_ID_SIZE
    )
    return ObjectID(h.digest())
