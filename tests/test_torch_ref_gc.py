"""Owner-side reference GC: dropping the last ObjectRef frees cluster copies.

Reference analog: the ReferenceCounter-driven plasma free
(core_worker/reference_count.h:61) — when an owned object's ref count hits
zero the owner deletes the primary copy instead of letting it rot until
eviction/spilling.
"""

import gc
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._private import worker as worker_mod


@pytest.fixture
def rt_start():
    rt.init(num_cpus=2, object_store_memory=256 * 1024 * 1024)
    yield
    rt.shutdown()


def _wait_for(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.1)
    return False


def test_del_put_ref_frees_store(rt_start):
    client = worker_mod.get_client()
    ref = rt.put(np.ones(1_000_000))  # 8 MB
    oid = ref.id.binary()
    assert client.store.contains_raw(oid)
    del ref
    gc.collect()
    assert _wait_for(lambda: not client.store.contains_raw(oid)), (
        "store copy not freed after the last ref died"
    )


def test_del_task_return_frees_store(rt_start):
    client = worker_mod.get_client()

    @rt.remote
    def produce():
        return np.ones(1_000_000)

    ref = produce.remote()
    rt.get(ref)  # materialize in the store
    oid = ref.id.binary()
    assert client.store.contains_raw(oid)
    del ref
    gc.collect()
    assert _wait_for(lambda: not client.store.contains_raw(oid))


def test_repeated_big_puts_never_fill_store(rt_start):
    """The bench_core regression: 20 x 64MB puts through a 256MB store must
    recycle freed space, not spill or die with ObjectStoreFullError."""
    for i in range(20):
        ref = rt.put(np.full(8_000_000, i, dtype=np.float64))  # 64 MB
        out = rt.get(ref)
        assert out[0] == i
        del out, ref
        gc.collect()


def test_borrowed_arg_not_freed_under_running_task(rt_start):
    """Dropping the driver's ref right after submit must not free the
    argument out from under the running task."""

    @rt.remote
    def consume(arr):
        time.sleep(1.0)  # outlive the driver-side del + flush debounce
        return float(arr.sum())

    ref = rt.put(np.ones(1_000_000))
    out_ref = consume.remote(ref)
    del ref
    gc.collect()
    assert rt.get(out_ref, timeout=60) == 1_000_000.0


def test_freed_object_get_fails(rt_start):
    client = worker_mod.get_client()
    ref = rt.put(np.ones(100_000))
    oid = ref.id.binary()
    # A true borrower copy: NOT the owner's instance from known_refs.
    borrowed = worker_mod.ObjectRef(worker_mod.ObjectID(oid))
    del ref
    gc.collect()
    assert _wait_for(lambda: not client.store.contains_raw(oid))
    client._in_store.discard(oid)  # the borrower resolves via the cluster
    with pytest.raises((rt.exceptions.ObjectLostError,
                        rt.exceptions.GetTimeoutError)):
        rt.get(borrowed, timeout=5)


# ---------------------------------------------------------------------------
# Nested references (reference_count.h:61 — refs serialized inside
# arguments/returns are promoted to the store and tracked like plasma
# promotions in the reference).
# ---------------------------------------------------------------------------


def test_nested_ref_in_list_arg(rt_start):
    """A ref inside a container arg is promoted; the task resolves it."""

    @rt.remote
    def read_nested(pair):
        tag, inner = pair
        return tag + float(rt.get(inner).sum())

    inner = rt.put(np.ones(1000))
    assert rt.get(read_nested.remote([1.0, inner]), timeout=30) == 1001.0


def test_nested_ref_in_kwarg_dict(rt_start):
    @rt.remote
    def read_cfg(cfg=None):
        return float(rt.get(cfg["data"]).sum())

    inner = rt.put(np.full(10, 2.0))
    assert rt.get(read_cfg.remote(cfg={"data": inner}), timeout=30) == 20.0


def test_ref_returned_inside_container(rt_start):
    """A task returns a container holding a ref it created; the caller
    (now a borrower of a worker-owned object) can resolve it."""

    @rt.remote
    def produce_wrapped():
        return {"inner": rt.put(np.full(100, 7.0))}

    out = rt.get(produce_wrapped.remote(), timeout=30)
    assert float(rt.get(out["inner"], timeout=30).sum()) == 700.0


def test_task_returns_plain_ref(rt_start):
    @rt.remote
    def produce_ref():
        return [rt.put(b"payload")]

    (inner,) = rt.get(produce_ref.remote(), timeout=30)
    assert rt.get(inner, timeout=30) == b"payload"


# ---------------------------------------------------------------------------
# Borrower chains
# ---------------------------------------------------------------------------


def test_borrower_hands_ref_to_second_borrower(rt_start):
    """A -> B chain: the first borrower submits a task with the borrowed
    ref; each hop pins the arg for its own execution."""

    @rt.remote
    def second(arr):
        return float(arr.sum())

    @rt.remote
    def first(arr):
        # arr arrived resolved; re-share it onward as a fresh object.
        return rt.get(second.remote(arr), timeout=30)

    ref = rt.put(np.ones(5000))
    out_ref = first.remote(ref)
    del ref  # driver's handle dies while the chain runs
    gc.collect()
    assert rt.get(out_ref, timeout=60) == 5000.0


def test_borrowed_ref_forwarded_unresolved(rt_start):
    """The borrower forwards the REF (not the value) to a second task."""

    @rt.remote
    def reader(wrapped):
        return float(rt.get(wrapped["r"], timeout=30).sum())

    @rt.remote
    def forwarder(wrapped):
        return rt.get(reader.remote(wrapped), timeout=30)

    inner = rt.put(np.full(100, 3.0))
    out = forwarder.remote({"r": inner})
    res = rt.get(out, timeout=60)
    assert res == 300.0


def test_same_ref_to_two_concurrent_tasks(rt_start):
    @rt.remote
    def consume(arr):
        time.sleep(0.3)
        return float(arr.sum())

    ref = rt.put(np.ones(2000))
    a = consume.remote(ref)
    b = consume.remote(ref)
    del ref
    gc.collect()
    assert rt.get(a, timeout=60) == 2000.0
    assert rt.get(b, timeout=60) == 2000.0


def test_actor_borrows_arg_during_call(rt_start):
    @rt.remote
    class Reader:
        def read(self, arr):
            time.sleep(0.5)
            return float(arr.sum())

    r = Reader.remote()
    ref = rt.put(np.ones(3000))
    out = r.read.remote(ref)
    del ref
    gc.collect()
    assert rt.get(out, timeout=60) == 3000.0


# ---------------------------------------------------------------------------
# Owner death while a borrower holds a handle
# ---------------------------------------------------------------------------


def test_store_copy_survives_owner_actor_kill(rt_start):
    """The primary copy lives in the node's shared store, not the owner
    process: killing the owning actor must not invalidate a copy a
    borrower already holds a handle to (availability under owner death;
    reference: OBJECT_UNRECONSTRUCTABLE only once copies are gone)."""

    @rt.remote
    class Owner:
        def make(self):
            return rt.put(np.full(100, 9.0))

    o = Owner.remote()
    inner = rt.get(o.make.remote(), timeout=30)
    assert float(rt.get(inner, timeout=30).sum()) == 900.0
    rt.kill(o)
    time.sleep(0.5)
    # Borrowed handle still resolves from the store copy.
    assert float(rt.get(inner, timeout=30).sum()) == 900.0


# ---------------------------------------------------------------------------
# Lineage reconstruction
# ---------------------------------------------------------------------------


def test_lineage_reexecutes_lost_task_result(rt_start):
    """All copies of a task return are lost -> the owner re-executes the
    creating task from lineage (task_manager.cc lineage reconstruction)."""
    client = worker_mod.get_client()

    @rt.remote
    def produce():
        return np.full(50_000, 4.0)

    ref = produce.remote()
    rt.get(ref, timeout=30)
    oid = ref.id.binary()
    assert client.store.contains_raw(oid)
    # Simulate losing every copy: drop it from the store + local caches.
    client.store.delete(worker_mod.ObjectID(oid))
    client._in_store.discard(oid)
    client.memory_store.pop(oid, None)
    out = rt.get(ref, timeout=60)
    assert float(out.sum()) == 200_000.0


def test_lineage_reexec_with_ref_arg(rt_start):
    """Reconstruction of a task whose argument is itself a ref."""
    client = worker_mod.get_client()

    @rt.remote
    def double(arr):
        return arr * 2.0

    base = rt.put(np.full(20_000, 3.0))
    ref = double.remote(base)
    rt.get(ref, timeout=30)
    oid = ref.id.binary()
    client.store.delete(worker_mod.ObjectID(oid))
    client._in_store.discard(oid)
    client.memory_store.pop(oid, None)
    out = rt.get(ref, timeout=60)
    assert float(out.sum()) == 120_000.0
    del base


# ---------------------------------------------------------------------------
# Counts under retries
# ---------------------------------------------------------------------------


def test_borrow_survives_worker_crash_retry(rt_start):
    """First attempt SIGKILLs its worker; the retry still finds the
    borrowed argument alive even though the driver dropped its handle."""

    @rt.remote(max_retries=2)
    def crash_once(arr, marker):
        import os

        key = b"crashed:" + marker
        client = worker_mod.get_client()
        if client.kv_get(key) is None:
            client.kv_put(key, b"1")
            os.kill(os.getpid(), 9)
        return float(arr.sum())

    ref = rt.put(np.ones(1000))
    out = crash_once.remote(ref, b"t1")
    del ref
    gc.collect()
    assert rt.get(out, timeout=90) == 1000.0


def test_retry_failure_releases_borrow_pins(rt_start):
    """After an exhausted-retries failure the argument is freed once the
    driver handle dies too (no leaked pins)."""
    client = worker_mod.get_client()

    @rt.remote(max_retries=0)
    def boom(arr):
        raise ValueError("no")

    ref = rt.put(np.ones(500_000))
    oid = ref.id.binary()
    out = boom.remote(ref)
    with pytest.raises(rt.exceptions.TaskError):
        rt.get(out, timeout=30)
    del ref, out
    gc.collect()
    assert _wait_for(lambda: not client.store.contains_raw(oid)), (
        "failed-task argument pin leaked"
    )


# ---------------------------------------------------------------------------
# Bulk / idempotence
# ---------------------------------------------------------------------------


def test_many_refs_all_freed(rt_start):
    client = worker_mod.get_client()
    oids = []
    refs = []
    for i in range(50):
        r = rt.put(np.full(20_000, float(i)))
        oids.append(r.id.binary())
        refs.append(r)
        del r  # the loop variable must not keep the last object alive
    assert all(client.store.contains_raw(o) for o in oids)
    refs.clear()
    gc.collect()
    assert _wait_for(
        lambda: not any(client.store.contains_raw(o) for o in oids), 20.0
    ), "bulk ref drop left store copies behind"


def test_borrowed_copy_does_not_double_free(rt_start):
    """Deleting a borrower's handle must not free the owner's object."""
    client = worker_mod.get_client()
    ref = rt.put(np.ones(200_000))
    oid = ref.id.binary()
    borrowed = worker_mod.ObjectRef(worker_mod.ObjectID(oid))
    del borrowed
    gc.collect()
    time.sleep(0.5)
    assert client.store.contains_raw(oid), (
        "borrower's del freed the owner's object"
    )
    assert float(rt.get(ref, timeout=10).sum()) == 200_000.0


def test_wait_does_not_leak_pins(rt_start):
    client = worker_mod.get_client()

    @rt.remote
    def produce():
        return np.ones(200_000)

    refs = [produce.remote() for _ in range(4)]
    done, pending = rt.wait(refs, num_returns=4, timeout=60)
    assert len(done) == 4 and not pending
    oids = [r.id.binary() for r in refs]
    refs.clear()
    done.clear()
    gc.collect()
    assert _wait_for(
        lambda: not any(client.store.contains_raw(o) for o in oids), 20.0
    )


def test_get_mixed_inline_and_store(rt_start):
    @rt.remote
    def small():
        return 7  # inline return

    @rt.remote
    def big():
        return np.ones(500_000)  # store return

    s, b = rt.get([small.remote(), big.remote()], timeout=60)
    assert s == 7 and float(b.sum()) == 500_000.0


def test_ref_in_closure_of_second_task(rt_start):
    ref = rt.put(np.full(100, 5.0))

    @rt.remote
    def via_closure():
        return float(rt.get(ref, timeout=30).sum())

    out = rt.get(via_closure.remote(), timeout=60)
    assert out == 500.0


def test_nested_ref_pinned_when_driver_drops_handle(rt_start):
    """A ref nested INSIDE a container argument is borrow-pinned like a
    top-level dep: the driver dropping its handle right after submit must
    not free the object under the running task (reference_count.h nested
    ref tracking)."""

    @rt.remote
    def read_nested(wrapped):
        time.sleep(0.8)  # outlive the driver-side del + free debounce
        return float(rt.get(wrapped["data"], timeout=30).sum())

    inner = rt.put(np.ones(300_000))
    out = read_nested.remote({"data": inner})
    del inner
    gc.collect()
    assert rt.get(out, timeout=60) == 300_000.0


def test_actor_ctor_nested_ref_pinned(rt_start):
    """Constructor args with nested refs are pinned until the actor is
    live: the driver dropping its handle right after Actor.remote() must
    not free the arg before __init__ resolves it."""

    @rt.remote
    class Holder:
        def __init__(self, wrapped):
            self.total = float(rt.get(wrapped["data"], timeout=30).sum())

        def total_(self):
            return self.total

    inner = rt.put(np.ones(200_000))
    h = Holder.remote({"data": inner})
    del inner
    gc.collect()
    assert rt.get(h.total_.remote(), timeout=60) == 200_000.0


def test_restartable_actor_ctor_args_survive_restart(rt_start):
    """A restartable actor's ctor args stay pinned past first ALIVE: the
    GCS replays create_spec on restart, and the replayed __init__ must
    still resolve nested refs the driver dropped long ago."""
    import os

    @rt.remote
    class Phoenix:
        def __init__(self, wrapped):
            self.total = float(rt.get(wrapped["data"], timeout=30).sum())

        def total_(self):
            return self.total

        def die(self):
            os._exit(1)

    inner = rt.put(np.full(150_000, 2.0))
    p = Phoenix.options(max_restarts=1).remote({"data": inner})
    assert rt.get(p.total_.remote(), timeout=60) == 300_000.0
    del inner
    gc.collect()
    time.sleep(0.5)  # free debounce window: pins must hold the object
    try:
        rt.get(p.die.remote(), timeout=30)
    except Exception:
        pass
    # The restarted __init__ replays the create_spec and re-reads the arg.
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        try:
            assert rt.get(p.total_.remote(), timeout=30) == 300_000.0
            break
        except Exception:
            time.sleep(0.5)
    else:
        import pytest as _pytest

        _pytest.fail("restarted actor could not re-resolve its ctor arg")
