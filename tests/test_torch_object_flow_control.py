"""The port's object flow control (the raylet's PullManager byte budget
and its broadcast paths): the cases of tests/test_object_flow_control.py
run against ray_tpu_torch."""

import asyncio

import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch._private.raylet import _PullByteBudget
from ray_tpu_torch.cluster_utils import Cluster


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def test_budget_admits_until_full_then_blocks():
    async def body():
        b = _PullByteBudget(100)
        await b.acquire(60)
        await b.acquire(40)  # exactly full
        waiter = asyncio.ensure_future(b.acquire(10))
        await asyncio.sleep(0.01)
        assert not waiter.done(), "over-budget pull was admitted"
        b.release(60)
        await asyncio.wait_for(waiter, 1)
        assert b.in_use == 50

    _run(body())


def test_budget_oversized_object_proceeds_alone():
    async def body():
        b = _PullByteBudget(100)
        await b.acquire(1000)  # bigger than the whole budget: runs alone
        waiter = asyncio.ensure_future(b.acquire(10))
        await asyncio.sleep(0.01)
        assert not waiter.done()
        b.release(1000)
        await asyncio.wait_for(waiter, 1)

    _run(body())


def test_budget_wakes_smallest_first():
    async def body():
        b = _PullByteBudget(100)
        await b.acquire(100)
        big = asyncio.ensure_future(b.acquire(90))
        await asyncio.sleep(0)  # enqueue in submission order
        small = asyncio.ensure_future(b.acquire(10))
        await asyncio.sleep(0.01)
        b.release(100)
        await asyncio.sleep(0.01)
        # The small pull is admitted ahead of the earlier-queued big one
        # while both fit... only 10+90=100 fits too; smallest went first.
        assert small.done(), "small pull starved behind big one"
        await asyncio.wait_for(big, 1)

    _run(body())


def test_budget_release_wakes_multiple():
    async def body():
        b = _PullByteBudget(100)
        await b.acquire(100)
        waiters = [asyncio.ensure_future(b.acquire(25)) for _ in range(4)]
        await asyncio.sleep(0.01)
        assert not any(w.done() for w in waiters)
        b.release(100)
        await asyncio.wait_for(asyncio.gather(*waiters), 1)
        assert b.in_use == 100

    _run(body())


def test_cross_node_broadcast_under_flow_control():
    """A ~48MB object broadcast to two other nodes: chunked pulls ride
    the byte budget + push chunk caps and arrive intact."""
    cluster = Cluster()
    n1 = cluster.add_node(num_cpus=1, object_store_memory=256 << 20)
    cluster.add_node(num_cpus=1, object_store_memory=256 << 20)
    cluster.add_node(num_cpus=1, object_store_memory=256 << 20)
    cluster.connect()
    try:
        from ray_tpu_torch.util.scheduling_strategies import (
            NodeAffinitySchedulingStrategy,
        )

        blob = np.arange(6_000_000, dtype=np.float64)  # 48 MB
        ref = rt.put(blob)

        @rt.remote
        def checksum(x):
            return float(x.sum())

        expected = float(blob.sum())
        nodes = [n.node_id.binary() for n in cluster.raylets[1:]]
        outs = rt.get(
            [
                checksum.options(
                    scheduling_strategy=NodeAffinitySchedulingStrategy(
                        node_id=nid
                    )
                ).remote(ref)
                for nid in nodes
            ],
            timeout=300,
        )
        assert outs == [expected, expected]
    finally:
        cluster.shutdown()


def test_broadcast_chain_tcp_path(monkeypatch):
    """Multi-consumer broadcast over the TCP pull path (same-host shm
    shortcut disabled): every consumer sees exact bytes while pullers may
    chain off in-progress partial copies (reference:
    object_manager.cc:339 any-holder pulls)."""
    import ray_tpu_torch._private.config as config_mod
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    monkeypatch.setenv("RT_SAME_HOST_SHM_TRANSFER", "0")
    config_mod._config = None
    cluster = Cluster()
    cluster.add_node(num_cpus=1, object_store_memory=256 * 1024 * 1024)
    for _ in range(3):
        cluster.add_node(num_cpus=1, object_store_memory=256 * 1024 * 1024)
    cluster.connect()
    try:
        rng = np.random.default_rng(7)
        payload = rng.standard_normal(4_000_000)  # 32MB
        ref = rt.put(payload)

        @rt.remote
        def digest(x):
            return float(x.sum()), x.nbytes

        outs = rt.get(
            [
                digest.options(
                    scheduling_strategy=NodeAffinitySchedulingStrategy(
                        node_id=r.node_id.binary()
                    )
                ).remote(ref)
                for r in cluster.raylets[1:]
            ],
            timeout=300,
        )
        want = float(payload.sum())
        for s, nbytes in outs:
            assert nbytes == payload.nbytes
            assert abs(s - want) < 1e-6
    finally:
        cluster.shutdown()
        config_mod._config = None


def test_broadcast_same_host_shm_path():
    """Same-machine peers move objects by direct store-to-store memcpy;
    bytes must be exact and the location directory updated."""
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    cluster = Cluster()
    cluster.add_node(num_cpus=1, object_store_memory=256 * 1024 * 1024)
    cluster.add_node(num_cpus=1, object_store_memory=256 * 1024 * 1024)
    cluster.connect()
    try:
        rng = np.random.default_rng(11)
        payload = rng.standard_normal(2_000_000)
        ref = rt.put(payload)

        @rt.remote
        def digest(x):
            return float(x.sum())

        out = rt.get(
            digest.options(
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    node_id=cluster.raylets[1].node_id.binary()
                )
            ).remote(ref),
            timeout=120,
        )
        assert abs(out - float(payload.sum())) < 1e-6
        # The peer's copy is registered: a second consumer on that node
        # reads locally.
        from ray_tpu_torch._private import worker as worker_mod

        client = worker_mod.get_client()
        locs = client._run(client.gcs.call(
            "object_location_get", {"object_id": ref.id.binary()}
        ))
        assert len(locs["nodes"]) == 2
    finally:
        cluster.shutdown()
