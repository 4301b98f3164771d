"""The port's autoscaler v2 (ray_tpu_torch.autoscaler.v2): the cases of
tests/test_autoscaler_v2.py against the port, with GPU in place of TPU,
and the two packages held against each other:

  * Scheduler.desired_launches on 50 seeded draws (numpy, seed 0) of node
    types, demands, free maps and active counts: the same launches;
  * Reconciler, both driven by the same mock provider and the same
    ray-state and demand sequences (seeded draws keyed by step and cloud
    id): the same status history for every instance and the same
    report() after every step.

The live cases run against the port's Cluster; the one with process
nodes is `slow`, as its JAX counterpart is.
"""

import time

import numpy as np
import pytest

from ray_tpu.autoscaler import v2 as jax_v2
from ray_tpu.autoscaler.node_provider import NodeProvider as JaxNodeProvider
from ray_tpu_torch.autoscaler import v2
from ray_tpu_torch.autoscaler.node_provider import NodeProvider
from ray_tpu_torch.autoscaler.v2 import InstanceManager, Reconciler, Scheduler


class _Mock:
    """In-memory cloud: created nodes appear in non_terminated_nodes
    after `delay` listings (0 = immediately)."""

    def __init__(self, fail_types=(), delay=0):
        self._nodes = {}
        self._counter = 0
        self.fail_types = set(fail_types)
        self.terminated = []
        self.delay = delay
        self._age = {}

    def create_node(self, node_type, node_config, count):
        if node_type in self.fail_types:
            raise RuntimeError("cloud quota exceeded")
        out = []
        for _ in range(count):
            self._counter += 1
            cid = f"i-{self._counter:04d}"
            self._nodes[cid] = node_type
            self._age[cid] = 0
            out.append(cid)
        return out

    def terminate_node(self, provider_node_id):
        self._nodes.pop(provider_node_id, None)
        self.terminated.append(provider_node_id)

    def non_terminated_nodes(self):
        out = []
        for cid in self._nodes:
            if self._age[cid] >= self.delay:
                out.append(cid)
            self._age[cid] += 1
        return out

    def node_tags(self, provider_node_id):
        return {"rt-node-type": self._nodes.get(provider_node_id, "")}


class MockProvider(_Mock, NodeProvider):
    pass


class JaxMockProvider(_Mock, JaxNodeProvider):
    pass


def test_instance_lifecycle_legal_transitions():
    im = InstanceManager()
    inst = im.create("cpu")
    assert inst.status == v2.QUEUED
    im.set_status(inst.instance_id, v2.REQUESTED)
    im.set_status(inst.instance_id, v2.ALLOCATED)
    im.set_status(inst.instance_id, v2.RAY_RUNNING)
    with pytest.raises(ValueError):  # RAY_RUNNING -> ALLOCATED is illegal
        im.set_status(inst.instance_id, v2.ALLOCATED)
    im.set_status(inst.instance_id, v2.TERMINATING)
    im.set_status(inst.instance_id, v2.TERMINATED)
    with pytest.raises(ValueError):  # terminal state
        im.set_status(inst.instance_id, v2.QUEUED)
    assert [s for s, _ in inst.status_history] == [
        "QUEUED", "REQUESTED", "ALLOCATED", "RAY_RUNNING",
        "TERMINATING", "TERMINATED",
    ]
    assert v2._LEGAL == jax_v2._LEGAL


def test_scheduler_binpacks_and_respects_limits():
    sched = Scheduler({
        "cpu": {"resources": {"CPU": 4}, "max_workers": 2},
        "gpu": {"resources": {"GPU": 4}, "slice_hosts": 4, "max_workers": 1},
    })
    # 6 CPU bundles of 2 -> 12 CPU -> 3 cpu nodes, capped at 2.
    launches = sched.desired_launches(
        [{"CPU": 2.0}] * 6, free_per_node=[], active_counts={}
    )
    assert launches["cpu"] == 2
    # GPU demand launches one slice UNIT (4 hosts handled by the caller).
    launches = sched.desired_launches(
        [{"GPU": 4.0}], free_per_node=[], active_counts={}
    )
    assert launches == {"gpu": 1}
    # Existing free capacity absorbs demand: nothing to launch.
    launches = sched.desired_launches(
        [{"CPU": 2.0}], free_per_node=[{"CPU": 4.0}], active_counts={"cpu": 1}
    )
    assert launches == {}


def test_scheduler_min_workers_floor():
    sched = Scheduler({"cpu": {"resources": {"CPU": 4}, "min_workers": 2,
                               "max_workers": 5}})
    launches = sched.desired_launches([], [], {})
    assert launches == {"cpu": 2}
    launches = sched.desired_launches([], [], {"cpu": 2})
    assert launches == {}


def _draw_node_types(rng):
    types = {}
    for i in range(int(rng.integers(1, 4))):
        res = {"CPU": float(rng.choice([1, 2, 4, 8]))}
        if rng.random() < 0.5:
            res["GPU"] = float(rng.choice([0.5, 1, 4, 8]))
        spec = {"resources": res}
        if rng.random() < 0.4:
            spec["slice_hosts"] = int(rng.choice([2, 4]))
        if rng.random() < 0.5:
            spec["min_workers"] = int(rng.integers(0, 3))
        if rng.random() < 0.7:
            spec["max_workers"] = int(rng.integers(0, 5))
        types[f"t{i}"] = spec
    return types


def _draw_bundle(rng):
    b = {"CPU": float(rng.choice([0.5, 1, 2, 4, 16]))}
    if rng.random() < 0.4:
        b["GPU"] = float(rng.choice([0.25, 1, 4, 16]))
    if rng.random() < 0.1:
        b = {"GPU": float(rng.choice([1, 4]))}
    return b


def test_scheduler_matches_jax_on_seeded_draws():
    """50 draws from numpy seed 0: each package's Scheduler returns the
    same launches for the same node types, demands, free maps and active
    counts."""
    rng = np.random.default_rng(0)
    nonempty = 0
    for _ in range(50):
        types = _draw_node_types(rng)
        demands = [_draw_bundle(rng) for _ in range(int(rng.integers(0, 12)))]
        free = [{"CPU": float(rng.integers(0, 5)),
                 "GPU": float(rng.integers(0, 3))}
                for _ in range(int(rng.integers(0, 4)))]
        active = {t: int(rng.integers(0, 6)) for t in types
                  if rng.random() < 0.6}
        got = Scheduler(types).desired_launches(demands, free, active)
        want = jax_v2.Scheduler(types).desired_launches(demands, free, active)
        assert got == want, (types, demands, free, active)
        nonempty += bool(got)
    assert nonempty >= 20  # the draws exercise launching, not only {}


def _mk_reconciler(provider, node_types, ray_state, demands,
                   idle_timeout_s=60.0):
    im = InstanceManager()
    rec = Reconciler(
        im, provider, node_types,
        ray_state_fn=lambda: ray_state,
        demands_fn=lambda: demands,
        idle_timeout_s=idle_timeout_s,
    )
    return im, rec


def test_reconciler_full_lifecycle():
    provider = MockProvider()
    ray_state = {}
    demands = [{"CPU": 2.0}]
    im, rec = _mk_reconciler(
        provider, {"cpu": {"resources": {"CPU": 4}, "max_workers": 4}},
        ray_state, demands, idle_timeout_s=0.0,
    )
    rec.step()  # demand -> QUEUED -> REQUESTED (cloud create issued)
    [inst] = im.instances((v2.REQUESTED,))
    assert inst.cloud_id in provider.non_terminated_nodes()

    rec.step()  # cloud lists it -> ALLOCATED
    assert im.get(inst.instance_id).status == v2.ALLOCATED

    # Raylet registers, busy: RAY_RUNNING and stays.
    ray_state[inst.cloud_id] = {"alive": True, "idle_s": 0.0,
                                "free": {"CPU": 2.0}}
    demands.clear()
    rec.step()
    assert im.get(inst.instance_id).status == v2.RAY_RUNNING

    # Node goes idle past the (zero) timeout -> terminated, slice-atomic
    # path for a single host is the host itself.
    ray_state[inst.cloud_id] = {"alive": True, "idle_s": 10.0,
                                "free": {"CPU": 4.0}}
    rec.step()
    assert im.get(inst.instance_id).status == v2.TERMINATING
    rec.step()  # provider no longer lists it
    assert im.get(inst.instance_id).status == v2.TERMINATED
    assert provider.terminated == [inst.cloud_id]


def test_reconciler_slice_atomic_scale_down():
    provider = MockProvider()
    ray_state = {}
    demands = [{"GPU": 4.0}]
    im, rec = _mk_reconciler(
        provider,
        {"gpu": {"resources": {"GPU": 4}, "slice_hosts": 2, "max_workers": 2}},
        ray_state, demands, idle_timeout_s=0.0,
    )
    rec.step()
    insts = im.instances((v2.REQUESTED,))
    assert len(insts) == 2  # one slice unit = 2 hosts
    assert len({i.slice_group for i in insts}) == 1
    demands.clear()
    # Both register; only ONE is idle -> slice must survive.
    ray_state[insts[0].cloud_id] = {"alive": True, "idle_s": 10.0, "free": {}}
    ray_state[insts[1].cloud_id] = {"alive": True, "idle_s": 0.0, "free": {}}
    rec.step()
    rec.step()
    assert all(
        im.get(i.instance_id).status == v2.RAY_RUNNING for i in insts
    )
    # Both idle -> the whole slice goes together.
    ray_state[insts[1].cloud_id]["idle_s"] = 10.0
    rec.step()
    assert sorted(provider.terminated) == sorted(
        i.cloud_id for i in insts
    )


def test_reconciler_retries_failed_allocation():
    provider = MockProvider(fail_types={"cpu"})
    im, rec = _mk_reconciler(
        provider, {"cpu": {"resources": {"CPU": 4}, "min_workers": 1,
                           "max_workers": 2}},
        {}, [],
    )
    rec.step()  # create_node raises -> instance stays QUEUED
    assert len(im.instances((v2.QUEUED,))) == 1
    rec.step()  # retried every tick; still failing, still exactly one
    assert len(im.instances((v2.QUEUED,))) == 1
    provider.fail_types.clear()
    rec.step()  # cloud recovered
    assert len(im.instances((v2.REQUESTED,))) == 1
    assert rec.report()["cpu"][v2.REQUESTED] == 1


_PARITY_TYPES = {
    "cpu": {"resources": {"CPU": 4}, "min_workers": 1, "max_workers": 3},
    "gpu": {"resources": {"CPU": 1, "GPU": 1}, "max_workers": 2},
    "gpu-slice": {"resources": {"GPU": 4}, "slice_hosts": 2,
                  "max_workers": 1},
}


def _scripted_run(mod, provider, seed, steps, idle_timeout_s,
                  request_timeout_s):
    """Drive one package's Reconciler: each step's demands and each live
    cloud id's ray state come from seeded draws keyed by (seed, step) and
    (seed, step, cloud id), so two packages that act alike see alike."""
    ray_state, demands = {}, []
    im = mod.InstanceManager()
    rec = mod.Reconciler(im, provider, _PARITY_TYPES,
                         ray_state_fn=lambda: ray_state,
                         demands_fn=lambda: demands,
                         idle_timeout_s=idle_timeout_s,
                         request_timeout_s=request_timeout_s)
    reports = []
    for step in range(steps):
        rng = np.random.default_rng([seed, step])
        demands[:] = [_draw_bundle(rng)
                      for _ in range(int(rng.integers(0, 4)))]
        if rng.random() < 0.15:
            provider.fail_types = {str(rng.choice(list(_PARITY_TYPES)))}
        elif rng.random() < 0.5:
            provider.fail_types = set()
        ray_state.clear()
        for cid in sorted(provider._nodes):
            r = np.random.default_rng([seed, step, int(cid[2:])])
            if r.random() < 0.8:
                ray_state[cid] = {
                    "alive": bool(r.random() < 0.85),
                    "idle_s": float(r.choice([0.0, 0.0, 10.0])),
                    "free": {"CPU": float(r.integers(0, 5)),
                             "GPU": float(r.integers(0, 2))}}
        rec.step()
        reports.append(rec.report())
    histories = [(i.node_type, i.cloud_id, i.slice_group is not None,
                  [s for s, _ in i.status_history])
                 for i in im.instances()]
    return histories, reports, list(provider.terminated)


@pytest.mark.parametrize("delay,request_timeout_s,idle_timeout_s", [
    (0, 600.0, 0.0), (1, 600.0, 5.0), (2, -1.0, 0.0)])
@pytest.mark.parametrize("seed", range(4))
def test_reconciler_matches_jax(seed, delay, request_timeout_s,
                                idle_timeout_s):
    got = _scripted_run(v2, MockProvider(delay=delay), seed, 16,
                        idle_timeout_s, request_timeout_s)
    want = _scripted_run(jax_v2, JaxMockProvider(delay=delay), seed, 16,
                         idle_timeout_s, request_timeout_s)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    statuses = {s for h in got[0] for s in h[3]}
    assert {v2.QUEUED, v2.REQUESTED}.issubset(statuses)
    if delay == 2 and request_timeout_s < 0:
        assert v2.ALLOCATION_FAILED in statuses
    else:
        assert v2.RAY_RUNNING in statuses


def _gcs_call_fn():
    import ray_tpu_torch as rt

    client = rt._worker.get_client()

    def gcs_call(method, payload):
        return client._run(client._gcs_call(method, payload))

    return gcs_call


def _demand_reported(gcs_call):
    return any(n.get("demand_bundles")
               for n in gcs_call("get_nodes", {})["nodes"]
               if n.get("state") == "ALIVE")


def test_v2_reconciler_against_live_cluster():
    """End-to-end v2: infeasible task demand reaches the GCS, the
    reconciler launches a fake node through the full instance lifecycle
    (QUEUED->...->RAY_RUNNING), the task completes, and idle timeout
    walks the instance to TERMINATED."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler import FakeMultiNodeProvider
    from ray_tpu_torch.autoscaler.v2 import GcsRayState, gcs_demands
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster()
    cluster.add_node(num_cpus=1)
    cluster.connect()
    try:
        provider = FakeMultiNodeProvider(
            cluster.io, "127.0.0.1", cluster.gcs_port
        )
        gcs_call = _gcs_call_fn()
        im = InstanceManager()
        rec = Reconciler(
            im, provider,
            {"worker": {"resources": {"CPU": 2}, "max_workers": 2}},
            ray_state_fn=GcsRayState(provider, gcs_call),
            demands_fn=gcs_demands(gcs_call),
            idle_timeout_s=1.5,
        )

        @rt.remote(num_cpus=2)
        def heavy():
            time.sleep(0.3)
            return 7

        ref = heavy.remote()  # infeasible on the 1-CPU head
        deadline = time.monotonic() + 30  # demand rides the heartbeat
        while not _demand_reported(gcs_call):
            assert time.monotonic() < deadline, "no demand reached the GCS"
            time.sleep(0.1)

        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            rec.step()
            done, _ = rt.wait([ref], timeout=0.3)
            if done:
                break
            time.sleep(0.2)
        assert rt.get(ref, timeout=60) == 7
        assert any(
            i.status == v2.RAY_RUNNING for i in im.instances()
        ), rec.report()
        assert len(im.instances()) == 1, rec.report()

        # With the task done, the node idles past the timeout -> gone.
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            rec.step()
            insts = im.instances()
            if insts and all(i.status == v2.TERMINATED for i in insts):
                break
            time.sleep(0.3)
        assert all(i.status == v2.TERMINATED for i in im.instances()), (
            rec.report()
        )
    finally:
        for pid in provider.non_terminated_nodes():
            provider.terminate_node(pid)
        cluster.shutdown()


@pytest.mark.slow
def test_process_provider_monitor_e2e():
    """A fake provider launching REAL raylet subprocesses, driven by the
    background Monitor loop (no manual stepping): infeasible demand ->
    scale-up -> process node joins -> task schedules -> idle scale-down
    terminates the process (reference: autoscaler/_private/
    fake_multi_node/)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler import Monitor, ProcessNodeProvider
    from ray_tpu_torch.autoscaler.v2 import GcsRayState, gcs_demands
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster()
    cluster.add_node(num_cpus=1)
    cluster.connect()
    provider = None
    monitor = None
    try:
        provider = ProcessNodeProvider("127.0.0.1", cluster.gcs_port)
        gcs_call = _gcs_call_fn()
        im = InstanceManager()
        rec = Reconciler(
            im, provider,
            {"worker": {"resources": {"CPU": 2}, "max_workers": 2}},
            ray_state_fn=GcsRayState(provider, gcs_call),
            demands_fn=gcs_demands(gcs_call),
            idle_timeout_s=2.0,
        )
        monitor = Monitor(rec, interval_s=0.5).start()

        @rt.remote(num_cpus=2)
        def heavy():
            time.sleep(0.3)
            return 11

        ref = heavy.remote()  # infeasible on the 1-CPU head
        # The monitor must scale up on its own and the task must land on
        # the subprocess node.
        assert rt.get(ref, timeout=90) == 11
        assert any(i.status == v2.RAY_RUNNING for i in im.instances()), (
            rec.report()
        )
        live_pids = provider.non_terminated_nodes()
        assert live_pids, "expected a live subprocess node"

        # Idle past the timeout: the monitor terminates the process node.
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            insts = im.instances()
            if insts and all(i.status == v2.TERMINATED for i in insts) and (
                not provider.non_terminated_nodes()
            ):
                break
            time.sleep(0.4)
        assert all(i.status == v2.TERMINATED for i in im.instances()), (
            rec.report()
        )
        assert not provider.non_terminated_nodes()
    finally:
        if monitor is not None:
            monitor.stop()
        if provider is not None:
            provider.shutdown()
        cluster.shutdown()
