"""Native shared-memory store tests.

Modeled on the reference plasma test intents
(src/ray/object_manager/plasma/test/): create/seal/get/release lifecycle,
eviction under pressure, allocator reuse, and cross-process visibility.
"""

import multiprocessing as mp
import os

import numpy as np
import pytest

from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.object_store import ObjectStore


@pytest.fixture
def store():
    name = f"/rttorch_ut_{os.getpid()}_{os.urandom(4).hex()}"
    s = ObjectStore(name, 32 * 1024 * 1024, create=True)
    yield s
    s.destroy()


def test_create_seal_get_release(store):
    oid = ObjectID.from_random()
    buf = store.create(oid, 100)
    buf[:5] = b"hello"
    del buf
    store.seal(oid)
    view = store.get(oid)
    assert bytes(view[:5]) == b"hello"
    del view
    store.release(oid)
    assert store.contains(oid)


def test_get_missing_returns_none(store):
    assert store.get(ObjectID.from_random()) is None


def test_unsealed_not_gettable(store):
    oid = ObjectID.from_random()
    store.create(oid, 10)
    assert store.get(oid) is None
    store.abort(oid)
    assert not store.contains(oid)


def test_duplicate_create_rejected(store):
    oid = ObjectID.from_random()
    store.create(oid, 10)
    store.seal(oid)
    with pytest.raises(ValueError):
        store.create(oid, 10)


def test_delete_and_refcount(store):
    oid = ObjectID.from_random()
    store.put_bytes(oid, b"x" * 1000)
    view = store.get(oid)
    assert not store.delete(oid)  # pinned
    del view
    store.release(oid)
    assert store.delete(oid)
    assert not store.contains(oid)


def test_lru_eviction_under_pressure(store):
    ids = []
    for _ in range(60):
        oid = ObjectID.from_random()
        store.put_bytes(oid, os.urandom(1024 * 1024))
        ids.append(oid)
    stats = store.stats()
    assert stats["num_evictions"] > 0
    # Oldest objects evicted first; the most recent one must survive.
    assert store.contains(ids[-1])
    assert not store.contains(ids[0])


def test_pinned_objects_survive_eviction(store):
    pinned = ObjectID.from_random()
    store.put_bytes(pinned, b"p" * (1024 * 1024))
    view = store.get(pinned)  # pin
    for _ in range(60):
        store.put_bytes(ObjectID.from_random(), os.urandom(1024 * 1024))
    assert store.contains(pinned)
    assert bytes(view[:1]) == b"p"
    del view
    store.release(pinned)


def test_allocator_reuse_after_delete(store):
    # Fill, delete all, then the space must be reusable (coalescing works).
    for _ in range(3):
        ids = []
        for _ in range(20):
            oid = ObjectID.from_random()
            store.put_bytes(oid, os.urandom(1024 * 1024))
            ids.append(oid)
        for oid in ids:
            store.delete(oid)
    assert store.stats()["num_objects"] == 0


def test_zero_copy_numpy_roundtrip(store):
    oid = ObjectID.from_random()
    arr = np.arange(100_000, dtype=np.float32).reshape(100, 1000)
    store.put_serialized(oid, ser.serialize({"w": arr}))
    view = store.get(oid)
    out = ser.deserialize(view)["w"]
    assert not out.flags.owndata  # zero-copy view over shared memory
    assert np.array_equal(out, arr)
    del out, view
    store.release(oid)


def _child_read(name, oid_hex, q):
    s = ObjectStore(name)
    v = s.get(ObjectID.from_hex(oid_hex))
    q.put(bytes(v[:5]))
    del v
    s.release(ObjectID.from_hex(oid_hex))
    s.close()


def test_cross_process_get(store):
    oid = ObjectID.from_random()
    store.put_bytes(oid, b"world")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=_child_read, args=(store.name, oid.hex(), q))
    p.start()
    p.join(30)
    assert q.get(timeout=5) == b"world"
