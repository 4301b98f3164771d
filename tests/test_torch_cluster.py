"""The port's multi-node Cluster harness (ray_tpu_torch.cluster_utils): the
cases of tests/test_cluster.py against the port's runtime, with the GPU
resource in place of the TPU one in the gang cases, and the port's cases
that waited for several raylets:
  * the per-node proxy with its HTTP and binary ingress
    (tests/test_serve_dataplane.py::test_proxy_per_node_and_binary_ingress);
  * partial reclamation of a gang's GPU bundles
    (tests/test_elastic_gang.py::test_partial_reclamation_arms_and_lifts_obligation);
  * the straggler named on a two-node gang
    (tests/test_flight_recorder.py::test_straggler_attribution_two_node_gang).
The slow drain cases cordon a node through the GCS's own call; the
graceful drain (`util.state.drain_node` and `list_nodes`) waits for the
state API (ROADMAP A2b.5). Each case carries `slow` where its JAX
counterpart does.

Every raylet of a Cluster grants card ids from this process's view of
the host, so only fake cards are given to several nodes here: nothing
below makes a CUDA context.
"""

import asyncio
import json
import os
import time
import urllib.request

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util.placement_group import (placement_group,
                                                remove_placement_group)
from ray_tpu_torch.util.scheduling_strategies import (
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)


@pytest.fixture
def rt_cluster():
    cluster = Cluster()
    yield cluster
    cluster.shutdown()


def _gcs(call, payload):
    from ray_tpu_torch._private import worker as worker_mod

    client = worker_mod.get_client()
    return client._run(client._gcs_call(call, payload))


def test_two_node_scheduling(rt_cluster):
    rt_cluster.add_node(num_cpus=2)
    rt_cluster.add_node(num_cpus=2)
    rt_cluster.connect()

    @rt.remote
    def where():
        time.sleep(2)  # hold the slot so later tasks must spill
        return os.environ["RT_NODE_ID"]

    refs = [where.options(num_cpus=2).remote() for _ in range(4)]
    assert len(set(rt.get(refs, timeout=120))) == 2


def test_node_affinity(rt_cluster):
    rt_cluster.add_node(num_cpus=2)
    n2 = rt_cluster.add_node(num_cpus=2)
    rt_cluster.connect()

    @rt.remote
    def where():
        return os.environ["RT_NODE_ID"]

    strategy = NodeAffinitySchedulingStrategy(node_id=n2.node_id.binary())
    assert rt.get(where.options(scheduling_strategy=strategy).remote()) == \
        n2.node_id.hex()


def test_custom_resources(rt_cluster):
    rt_cluster.add_node(num_cpus=1)
    special = rt_cluster.add_node(num_cpus=1, resources={"special": 2})
    rt_cluster.connect()

    @rt.remote(resources={"special": 1})
    def on_special():
        return os.environ["RT_NODE_ID"]

    assert rt.get(on_special.remote()) == special.node_id.hex()


def test_placement_group_strict_spread(rt_cluster):
    for _ in range(3):
        rt_cluster.add_node(num_cpus=2)
    rt_cluster.connect()

    pg = placement_group([{"CPU": 1}] * 3, strategy="STRICT_SPREAD")
    assert pg.ready(timeout=10)
    nodes = pg.bundle_node_ids()
    assert len(set(nodes)) == 3

    @rt.remote
    def where():
        return os.environ["RT_NODE_ID"]

    refs = [where.options(scheduling_strategy=PlacementGroupSchedulingStrategy(
        placement_group=pg, placement_group_bundle_index=i)).remote()
        for i in range(3)]
    assert [bytes.fromhex(g) for g in rt.get(refs)] == nodes
    remove_placement_group(pg)


def test_placement_group_strict_pack(rt_cluster):
    rt_cluster.add_node(num_cpus=4)
    rt_cluster.add_node(num_cpus=4)
    rt_cluster.connect()

    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="STRICT_PACK")
    assert pg.ready(timeout=10)
    assert len(set(pg.bundle_node_ids())) == 1


def test_placement_group_infeasible(rt_cluster):
    rt_cluster.add_node(num_cpus=1)
    rt_cluster.connect()

    pg = placement_group([{"CPU": 16}], strategy="PACK")
    assert not pg.ready(timeout=1.5)


def test_gpu_gang_resources(rt_cluster):
    """A two-host GPU gang: each host advertises its cards and a gang
    resource; the first also a head resource. One whole-host task lands
    on each host, and the head task on the first."""
    gang = "my-gpu-gang"
    rt_cluster.add_node(num_cpus=1, num_gpus=8,
                        resources={gang: 1, f"{gang}-head": 1})
    rt_cluster.add_node(num_cpus=1, num_gpus=8, resources={gang: 1})
    rt_cluster.connect()

    @rt.remote(resources={f"{gang}-head": 1}, num_cpus=0)
    def on_head():
        return os.environ["RT_NODE_ID"]

    @rt.remote(num_cpus=0)
    def on_host():
        return os.environ["RT_NODE_ID"], os.environ["CUDA_VISIBLE_DEVICES"]

    head_node = rt.get(on_head.remote())
    refs = [on_host.options(num_gpus=8, resources={gang: 1}).remote()
            for _ in range(2)]
    hosts = rt.get(refs)
    assert len({h for h, _ in hosts}) == 2
    assert head_node in {h for h, _ in hosts}
    # Each task is confined to all eight of its own host's cards.
    assert {v for _, v in hosts} == {"0,1,2,3,4,5,6,7"}


def test_object_transfer_between_nodes(rt_cluster):
    n1 = rt_cluster.add_node(num_cpus=2)
    n2 = rt_cluster.add_node(num_cpus=2)
    rt_cluster.connect()

    @rt.remote
    def produce():
        return np.ones(500_000)

    @rt.remote
    def consume(arr):
        return float(arr.sum())

    s1 = NodeAffinitySchedulingStrategy(node_id=n1.node_id.binary())
    s2 = NodeAffinitySchedulingStrategy(node_id=n2.node_id.binary())
    ref = produce.options(scheduling_strategy=s1).remote()
    assert rt.get(consume.options(scheduling_strategy=s2).remote(ref)) == \
        500_000.0


def test_actor_restart_after_kill(rt_cluster):
    rt_cluster.add_node(num_cpus=2)
    rt_cluster.connect()

    @rt.remote(max_restarts=1, max_task_retries=2)
    class Phoenix:
        def __init__(self):
            self.calls = 0

        def call(self):
            self.calls += 1
            return self.calls

        def die(self):
            os._exit(1)

    p = Phoenix.remote()
    assert rt.get(p.call.remote()) == 1
    p.die.options(max_task_retries=0).remote()
    time.sleep(1.0)
    assert rt.get(p.call.remote(), timeout=30) == 1


def test_gang_tasks_spread_not_pipelined(rt_cluster):
    gang = "gpu-gang-spread"
    for _ in range(2):
        rt_cluster.add_node(num_cpus=2, num_gpus=8, resources={gang: 1})
    rt_cluster.connect()

    @rt.remote
    def hold_and_report():
        time.sleep(1.0)
        return rt.get_runtime_context().node_id

    refs = [hold_and_report.options(num_gpus=8, resources={gang: 1}).remote()
            for _ in range(2)]
    assert len(set(rt.get(refs, timeout=120))) == 2


def test_remove_node_takes_its_gpu_out_of_the_cluster(rt_cluster):
    """A GPU task lands on the one node with a GPU, its result is pulled
    across the raylets, and remove_node() takes the GPU out of
    cluster_resources()."""
    head = rt_cluster.add_node(num_cpus=2)
    gpu_node = rt_cluster.add_node(num_cpus=1, num_gpus=1)
    rt_cluster.connect()
    assert rt.cluster_resources()["GPU"] == 1.0

    @rt.remote(num_gpus=1)
    def make():
        return (rt.get_runtime_context().get_node_id(),
                os.environ["CUDA_VISIBLE_DEVICES"],
                np.arange(4_000_000, dtype=np.float32))

    node, visible, arr = rt.get(make.remote(), timeout=60)
    assert node == gpu_node.node_id.hex() != head.node_id.hex()
    assert visible == "0"
    assert np.array_equal(arr, np.arange(4_000_000, dtype=np.float32))
    rt_cluster.remove_node(gpu_node)
    deadline = time.monotonic() + 10
    while "GPU" in rt.cluster_resources() and time.monotonic() < deadline:
        time.sleep(0.1)
    assert "GPU" not in rt.cluster_resources()
    assert rt.cluster_resources()["CPU"] == 2.0


def test_kill_raylet_and_restart_gcs_keep_the_cluster_serving(tmp_path):
    """kill_raylet: retried tasks finish on the survivor; kill_gcs and
    restart_gcs with a persist path: a named actor and a KV entry
    survive, and the raylets register again."""
    cluster = Cluster(gcs_persist_path=str(tmp_path / "gcs.bin"))
    try:
        cluster.add_node(num_cpus=2)
        victim = cluster.add_node(num_cpus=2)
        client = cluster.connect()

        @rt.remote(max_retries=5)
        def work(i):
            time.sleep(0.2)
            return i

        refs = [work.remote(i) for i in range(8)]
        time.sleep(0.5)
        cluster.kill_raylet(victim)
        assert rt.get(refs, timeout=120) == list(range(8))

        @rt.remote
        class Counter:
            def __init__(self):
                self.n = 0

            def inc(self):
                self.n += 1
                return self.n

        c = Counter.options(name="survivor").remote()
        assert rt.get(c.inc.remote()) == 1
        client.kv_put(b"durable-key", b"durable-value")
        time.sleep(0.3)
        cluster.kill_gcs()
        time.sleep(0.5)
        cluster.restart_gcs()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            try:
                if rt.cluster_resources().get("CPU") == 2.0:
                    break
            except Exception:  # noqa: BLE001 — the GCS is coming back
                pass
            time.sleep(0.2)
        assert rt.cluster_resources().get("CPU") == 2.0
        assert client.kv_get(b"durable-key") == b"durable-value"
        assert rt.get(rt.get_actor("survivor").inc.remote(), timeout=30) == 2
        assert rt.get(work.remote(7), timeout=60) == 7
    finally:
        cluster.shutdown()


# -- the cases that waited for several raylets --------------------------------
def test_proxy_per_node_and_binary_ingress():
    from ray_tpu_torch import serve
    from ray_tpu_torch._private.protocol import connect

    cluster = Cluster()
    cluster.add_node(num_cpus=2)
    cluster.add_node(num_cpus=2)
    cluster.connect()
    try:
        @serve.deployment(num_replicas=2)
        def double(x=0):
            return x * 2

        serve.run(double.bind(), name="dbl")
        addrs = serve.start(proxy_location="EveryNode")
        assert len(addrs) == 2, f"expected a proxy per node, got {addrs}"
        for entry in addrs.values():
            req = urllib.request.Request(
                entry["http"] + "/dbl", data=json.dumps({"x": 21}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                assert json.loads(resp.read())["result"] == 42

        host, port = next(iter(addrs.values()))["binary"]

        async def bin_call():
            conn = await connect(host, port)
            try:
                return await conn.call(
                    "serve_call", {"app": "dbl", "kwargs": {"x": 10}},
                    timeout=30)
            finally:
                await conn.close()

        loop = asyncio.new_event_loop()
        try:
            assert loop.run_until_complete(bin_call()) == {"result": 20}
        finally:
            loop.close()
    finally:
        serve.shutdown()
        cluster.shutdown()


@pytest.mark.chaos
def test_partial_reclamation_arms_and_lifts_obligation(rt_cluster):
    """A claimant needing fewer cards than a whole gang drains exactly
    the claimed bundles; releasing them arms a resize obligation that
    blocks re-reserve until the claimant lets go."""
    from ray_tpu_torch._private import chaos
    from ray_tpu_torch.exceptions import PlacementGroupSchedulingError
    from ray_tpu_torch.util.placement_group import (
        placement_group_resize_state,
        release_placement_group_bundles,
        reserve_placement_group_bundles,
    )

    rt_cluster.add_node(num_cpus=4)
    for _ in range(4):
        rt_cluster.add_node(num_cpus=1, num_gpus=4)
    rt_cluster.connect()
    chaos.enable()
    try:
        pg = placement_group([{"GPU": 4}] * 4, strategy="SPREAD",
                             name="gang", priority=0)
        assert pg.ready(timeout=30)

        victims = chaos.reclaim_chips(4, bundle_chips=4)
        assert victims == [{"victim_pg_id": pg.id.binary(),
                            "partial": True, "bundle_indices": [3]}]

        release_placement_group_bundles(pg, [3])
        state = placement_group_resize_state(pg)
        assert state["released_bundles"] == [3]
        (ob,) = state["obligations"]
        assert ob["state"] == "armed"
        assert ob["bundle_indices"] == [3]
        assert ob["claimant_tenant"] == "chaos_reclaim"

        with pytest.raises(PlacementGroupSchedulingError,
                           match="obligation not lifted"):
            reserve_placement_group_bundles(pg, [3])

        assert chaos.lift_fence() == 1
        (ob,) = placement_group_resize_state(pg)["obligations"]
        assert ob["state"] == "lifted"
        reserve_placement_group_bundles(pg, [3])
        assert placement_group_resize_state(pg) == {"obligations": [],
                                                    "released_bundles": []}
    finally:
        chaos.disable()


def _profiled_loop(config):
    from ray_tpu_torch import train
    from ray_tpu_torch._private import chaos

    prof = train.StepProfiler(ring=64)
    rank = train.get_world_rank()
    if rank == config["slow_rank"]:
        chaos.enable()
        chaos.delay_steps(config["delay_s"], count=config["steps"])
    for step in range(config["steps"]):
        with prof.step(tokens=32):
            with prof.phase("compute"):
                time.sleep(0.004)
        train.report({"step": step, "rank": rank})


def test_straggler_attribution_two_node_gang(rt_cluster):
    """A chaos-slowed rank of a gang spread over two nodes is named as the
    straggler, with its phase breakdown and each rank's wall."""
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer

    rt_cluster.add_node(num_cpus=2)
    rt_cluster.add_node(num_cpus=2)
    rt_cluster.connect()
    # STRICT_SPREAD: one worker on each node, or no fit at all.
    trainer = TorchTrainer(
        _profiled_loop,
        train_loop_config={"steps": 8, "slow_rank": 1, "delay_s": 0.05},
        scaling_config=ScalingConfig(num_workers=2,
                                     placement_strategy="STRICT_SPREAD"))
    result = trainer.fit()
    assert result.error is None
    enriched = [m for m in result.metrics_history
                if "train_straggler_rank" in m]
    assert enriched, result.metrics_history
    last = enriched[-1]
    assert last["train_straggler_rank"] == 1
    assert last["train_step_skew_s"] > 0.02
    walls = last["train_step_wall_by_rank"]
    assert {int(k) for k in walls} == {0, 1}
    assert walls[1] > walls[0]
    br = last["train_straggler_breakdown"]
    assert br["other_s"] > br["compute_s"]
    b = [m for m in result.metrics_history
         if "train_step_breakdown" in m][-1]["train_step_breakdown"]
    assert abs(b["wall_s"] - (b["data_s"] + b["compute_s"]
                              + b["collective_s"] + b["checkpoint_s"]
                              + b["other_s"])) < 1e-4


# -- the slow drain cases, cordoned through the GCS -------------------------
@pytest.mark.slow
def test_drain_guards(rt_cluster):
    rt_cluster.add_node(num_cpus=2)
    n2 = rt_cluster.add_node(num_cpus=2)
    rt_cluster.connect()

    r = _gcs("cordon_node", {"node_id": rt_cluster.head.node_id.binary()})
    assert not r.get("ok") and "head" in r.get("error", "")

    n2_id = n2.node_id.binary()
    assert _gcs("cordon_node", {"node_id": n2_id}).get("ok")
    time.sleep(1.2)

    @rt.remote
    def where():
        return os.environ["RT_NODE_ID"]

    strategy = NodeAffinitySchedulingStrategy(node_id=n2_id)
    with pytest.raises(Exception, match="draining"):
        rt.get(where.options(scheduling_strategy=strategy).remote(),
               timeout=30)
    assert _gcs("cordon_node", {"node_id": n2_id, "undo": True}).get("ok")
    time.sleep(1.2)
    assert rt.get(where.options(scheduling_strategy=strategy).remote(),
                  timeout=30) == n2_id.hex()


@pytest.mark.slow
def test_drain_revokes_direct_leases(rt_cluster):
    from ray_tpu_torch._private.ids import JobID
    from ray_tpu_torch._private.worker import CoreClient

    rt_cluster.add_node(num_cpus=2)
    n2 = rt_cluster.add_node(num_cpus=2)
    rt_cluster.connect()
    client2 = CoreClient(rt_cluster.io.loop, ("127.0.0.1", rt_cluster.gcs_port),
                         ("127.0.0.1", n2.port), n2.store_name,
                         n2.node_id.binary(), JobID.from_random(),
                         mode="driver")
    client2.connect()
    try:
        def node_of():
            return os.environ["RT_NODE_ID"]

        def run_one(timeout=30):
            [ref] = client2.submit_task(node_of, (), {})
            return client2.get([ref], timeout=timeout)[0]

        hexid = n2.node_id.binary().hex()
        assert hexid in {run_one() for _ in range(8)}
        assert _gcs("cordon_node", {"node_id": n2.node_id.binary()}).get("ok")
        time.sleep(1.5)
        assert hexid not in {run_one() for _ in range(8)}
    finally:
        client2.disconnect()
