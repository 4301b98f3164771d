"""The port's v1 autoscaler (ray_tpu_torch.autoscaler.StandardAutoscaler)
against the port's Cluster: the cases of tests/test_autoscaler.py, with
the GPU resource in place of the TPU one in the slice cases and the same
launched counts asserted. Where the JAX cases sleep 1.2 s for demand to
ride the heartbeat to the GCS, these poll the GCS with a deadline.

Then ProcessNodeProvider's card count: a raylet subprocess would add
every card it detects, so the provider passes the node type's GPU count
(0 where it names none). The raylets here see a faked card
(RT_NUM_GPUS=1 in their environment) and make no CUDA context.
"""

import json
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.autoscaler import (FakeMultiNodeProvider,
                                      ProcessNodeProvider,
                                      StandardAutoscaler)
from ray_tpu_torch.cluster_utils import Cluster


@pytest.fixture
def scaling_cluster():
    cluster = Cluster()
    cluster.add_node(num_cpus=1)  # head
    cluster.connect()
    provider = FakeMultiNodeProvider(cluster.io, "127.0.0.1", cluster.gcs_port)
    yield cluster, provider
    # The provider's raylets are not the Cluster's: stop them (and their
    # workers) first. The JAX file's fixture leaves them to the exit.
    for pid in provider.non_terminated_nodes():
        provider.terminate_node(pid)
    cluster.shutdown()


def _wait(fn, timeout=30.0, poll=0.2):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(poll)
    raise TimeoutError("condition not met")


def _nodes():
    from ray_tpu_torch._private import worker as worker_mod

    client = worker_mod.get_client()
    return client._run(client._gcs_call("get_nodes", {}))["nodes"]


def _demand_reported():
    """Queued demand has reached the GCS on a raylet's heartbeat."""
    return any(n.get("demand_bundles") for n in _nodes()
               if n["state"] == "ALIVE")


def _no_demand():
    return not _demand_reported()


def _autoscaler(cluster, provider, node_types, idle_timeout_s):
    return StandardAutoscaler(
        {"node_types": node_types, "idle_timeout_s": idle_timeout_s},
        provider,
        f"127.0.0.1:{cluster.gcs_port}",
        io=cluster.io,
    )


def test_scale_up_on_demand(scaling_cluster):
    cluster, provider = scaling_cluster
    autoscaler = _autoscaler(
        cluster, provider,
        {"worker": {"resources": {"CPU": 2}, "max_workers": 4}}, 9999)

    @rt.remote(num_cpus=2)
    def heavy():
        time.sleep(0.5)
        return 1

    # Head has 1 CPU: these 2-CPU tasks are infeasible until workers join.
    refs = [heavy.remote() for _ in range(4)]
    _wait(_demand_reported)

    launched = autoscaler.update()
    assert launched.get("worker", 0) >= 1
    assert rt.get(refs, timeout=60) == [1, 1, 1, 1]

    # Second pass with no pending demand launches nothing.
    _wait(_no_demand)
    assert autoscaler.update() == {}
    assert len(provider.non_terminated_nodes()) <= 4
    autoscaler.close()


def test_scale_up_respects_max_workers(scaling_cluster):
    cluster, provider = scaling_cluster
    autoscaler = _autoscaler(
        cluster, provider,
        {"worker": {"resources": {"CPU": 2}, "max_workers": 1}}, 9999)

    @rt.remote(num_cpus=2)
    def heavy():
        time.sleep(0.2)
        return 1

    refs = [heavy.remote() for _ in range(6)]
    _wait(_demand_reported)
    autoscaler.update()
    _wait(_demand_reported)  # the worker runs one at a time: demand stays
    autoscaler.update()
    assert len(provider.non_terminated_nodes()) == 1
    rt.get(refs, timeout=120)
    autoscaler.close()


def test_min_workers_and_idle_scale_down(scaling_cluster):
    cluster, provider = scaling_cluster
    autoscaler = _autoscaler(
        cluster, provider,
        {"worker": {"resources": {"CPU": 2}, "min_workers": 1,
                    "max_workers": 3}}, 0.5)
    # min_workers=1 launches a worker with no demand at all.
    launched = autoscaler.update()
    assert launched.get("worker") == 1

    @rt.remote(num_cpus=2)
    def heavy():
        time.sleep(0.3)
        return 1

    refs = [heavy.remote() for _ in range(4)]
    _wait(_demand_reported)
    autoscaler.update()
    n_peak = len(provider.non_terminated_nodes())
    assert n_peak >= 1
    rt.get(refs, timeout=60)

    # After the work drains, idle nodes terminate down to min_workers.
    def scaled_down():
        autoscaler.update()
        return len(provider.non_terminated_nodes()) == 1

    _wait(scaled_down, timeout=30, poll=0.6)
    autoscaler.close()


def test_gpu_slice_scales_whole_slices(scaling_cluster):
    """A slice node type launches slice_hosts hosts atomically."""
    cluster, provider = scaling_cluster
    autoscaler = _autoscaler(
        cluster, provider,
        {"gpu-slice": {"resources": {"GPU": 4, "CPU": 1},
                       "slice_hosts": 4, "max_workers": 2}}, 9999)

    @rt.remote(num_gpus=4, num_cpus=0)
    def gpu_task():
        return 1

    ref = gpu_task.remote()
    _wait(_demand_reported)
    launched = autoscaler.update()
    # One unmet GPU bundle still scales a whole 4-host slice.
    assert launched.get("gpu-slice") == 4
    assert len(provider.non_terminated_nodes()) == 4
    assert rt.get(ref, timeout=60) == 1
    autoscaler.close()


def test_gpu_slice_scale_down_is_atomic(scaling_cluster):
    """Idle slices terminate whole-slice or not at all: if even one host of
    a slice is busy, the autoscaler must not strand a partial slice."""
    cluster, provider = scaling_cluster
    autoscaler = _autoscaler(
        cluster, provider,
        {"gpu-slice": {"resources": {"GPU": 4, "CPU": 1},
                       "slice_hosts": 2, "max_workers": 2}}, 0.5)

    @rt.remote(num_gpus=4, num_cpus=0)
    def gpu_task(t):
        time.sleep(t)
        return 1

    ref = gpu_task.remote(0.1)
    _wait(_demand_reported)
    assert autoscaler.update().get("gpu-slice") == 2
    assert rt.get(ref, timeout=60) == 1

    # Keep ONE host of the slice busy: the whole slice must survive.
    busy = gpu_task.remote(6.0)
    _wait(lambda: any(n["resources_available"].get("GPU", 0)
                      < n["resources_total"].get("GPU", 0)
                      for n in _nodes() if n["state"] == "ALIVE"))
    for _ in range(4):
        time.sleep(0.7)  # past the idle timeout of the idle host
        autoscaler.update()
        assert len(provider.non_terminated_nodes()) == 2, (
            "partial slice terminated while one host was busy"
        )
    assert rt.get(busy, timeout=60) == 1

    # Fully idle: the slice terminates together (0 -> whole slice gone).
    def slice_gone():
        autoscaler.update()
        return len(provider.non_terminated_nodes()) == 0

    _wait(slice_gone, timeout=30, poll=0.7)
    autoscaler.close()


@pytest.mark.parametrize("node_type,want_gpu", [
    ({"CPU": 1}, None),
    ({"CPU": 1, "GPU": 0}, None),
    ({"CPU": 1, "GPU": 1}, 1.0),
])
def test_process_node_advertises_only_its_types_gpus(monkeypatch, node_type,
                                                     want_gpu):
    """A raylet subprocess that detects a card (RT_NUM_GPUS=1 here)
    advertises a GPU only where its node type names one."""
    monkeypatch.setenv("RT_NUM_GPUS", "1")
    cluster = Cluster()
    cluster.add_node(num_cpus=1, num_gpus=0)
    cluster.connect()
    provider = ProcessNodeProvider("127.0.0.1", cluster.gcs_port)
    try:
        (pid,) = provider.create_node("t", {"resources": node_type}, 1)
        node_id = provider.node_tags(pid)["rt-node-id"]
        assert node_id

        def registered():
            for n in _nodes():
                nid = n["node_id"]
                nid = nid.hex() if isinstance(nid, bytes) else nid
                if nid == node_id and n["state"] == "ALIVE":
                    return n
            return None

        node = _wait(registered)
        total = node["resources_total"]
        assert total.get("GPU") == want_gpu, total
        assert total["CPU"] == 1.0
        assert not any(k.startswith("GPU-") for k in total) or want_gpu
        assert node["labels"]["rt-node-type"] == "t"
    finally:
        provider.shutdown()
        cluster.shutdown()
    assert provider.non_terminated_nodes() == []


def test_process_provider_passes_the_types_gpu_count(monkeypatch):
    """The raylet's command line carries --num-gpus from the node type and
    leaves GPU out of --resources, so the raylet's own detection decides
    nothing: the same resources as the JAX provider on a host without a
    card."""
    import subprocess

    seen = []

    class FakeProc:
        def __init__(self, argv, **kw):
            seen.append(argv)
            self.stdout = iter(["RAYLET_NODE_ID=ab\n", "RAYLET_STORE=s\n"])

        def poll(self):
            return None

    monkeypatch.setattr(subprocess, "Popen", FakeProc)
    provider = ProcessNodeProvider("127.0.0.1", 1)
    provider.create_node("cpu", {"resources": {"CPU": 2}}, 1)
    provider.create_node("gpu", {"resources": {"CPU": 1, "GPU": 1}}, 1)
    flags = [dict(zip(a[3::2], a[4::2])) for a in seen]
    assert [f["--num-gpus"] for f in flags] == ["0", "1"]
    assert [json.loads(f["--resources"]) for f in flags] == [
        {"CPU": 2}, {"CPU": 1}]
    assert all(a[1:3] == ["-m", "ray_tpu_torch._private.raylet"]
               for a in seen)
    assert provider.node_tags("proc-gpu-2") == {"rt-node-type": "gpu",
                                                "rt-node-id": "ab"}


# ---------------------------------------------------------------------------
# update() held against the JAX StandardAutoscaler on the same inputs. The
# only outside inputs of either are connect() (the GCS's get_nodes and
# drain_node) and the provider, so each side gets a stub GCS and its own
# copy of one scripted world: nodes register a few steps after create_node,
# demand and busy hosts come from one seeded numpy script, and time is a
# fake clock. Every update()'s return, and every create_node,
# terminate_node and drain_node call, must be equal.

_PARITY_CONFIGS = {
    "plain_min_workers": {
        "node_types": {
            "cpu": {"resources": {"CPU": 4}, "max_workers": 3},
            "gpu": {"resources": {"CPU": 1, "GPU": 1}, "min_workers": 1,
                    "max_workers": 2},
        },
        "idle_timeout_s": 4.0,
    },
    "slices": {
        "node_types": {
            "gpu-slice": {"resources": {"CPU": 2, "GPU": 4},
                          "slice_hosts": 4, "max_workers": 2},
            "cpu": {"resources": {"CPU": 2}, "max_workers": 4},
        },
        "idle_timeout_s": 3.0,
    },
    "slice_min_workers_adopted": {
        "node_types": {
            "gpu-slice": {"resources": {"GPU": 8}, "slice_hosts": 2,
                          "min_workers": 2, "max_workers": 3},
            "gpu": {"resources": {"CPU": 1, "GPU": 1}, "min_workers": 2,
                    "max_workers": 3},
        },
        "idle_timeout_s": 2.0,
        # Hosts that predate the autoscaler, with no recorded slice group;
        # the third is a partial slice, and min_workers rounds up past it.
        "preexisting": ["gpu-slice"] * 3 + ["gpu"],
    },
}

_DEMAND_MENU = [{"CPU": 1}, {"CPU": 4}, {"GPU": 1}, {"GPU": 4},
                {"CPU": 1, "GPU": 1}, {"GPU": 8}, {"CPU": 16}]


def _parity_script(seed, steps=30, quiet=10):
    """`steps` seeded rows of demand, busy and dead hosts and clock steps,
    then `quiet` rows with nothing to do, in which idle hosts go."""
    rng = __import__("numpy").random.default_rng(seed)
    script = []
    for _ in range(steps):
        n_demand = int(rng.choice([0, 0, 1, 2, 4]))
        script.append({
            "demand": [dict(_DEMAND_MENU[i])
                       for i in rng.integers(0, len(_DEMAND_MENU), n_demand)],
            "busy": rng.random(16) < 0.3,
            "dead": rng.random(16) < 0.05,
            "dt": float(rng.choice([0.5, 1.0, 1.5, 3.0])),
        })
    script += [{"demand": [], "busy": [False] * 16, "dead": [False] * 16,
                "dt": 1.0}] * quiet
    return script, rng.integers(0, 3, 256)  # registration delays


class _World:
    """One side's provider, GCS and clock, stepped by the shared script."""

    def __init__(self, node_types, preexisting, delays):
        self.node_types = node_types
        self.delays = delays
        self.now = 1000.0
        self.step = 0
        self.nodes = {}  # pid -> {"type", "created", "node_id"}
        self.order = []  # pids in creation order
        self.calls = []
        for t in preexisting:
            self._new(t, registered=True)
        self.calls.clear()

    # -- provider ---------------------------------------------------------
    def _new(self, t, registered=False):
        i = len(self.order)
        pid = f"p{i}"
        self.order.append(pid)
        self.nodes[pid] = {"type": t, "created": self.step,
                           "node_id": f"{i:032x}" if registered else None}
        return pid

    def create_node(self, node_type, node_config, count):
        self.calls.append(("create_node", node_type, count))
        return [self._new(node_type) for _ in range(count)]

    def terminate_node(self, pid):
        self.calls.append(("terminate_node", pid))
        self.nodes.pop(pid, None)

    def non_terminated_nodes(self):
        return [p for p in self.order if p in self.nodes]

    def node_tags(self, pid):
        info = self.nodes[pid]
        tags = {"rt-node-type": info["type"]}
        if info["node_id"]:
            tags["rt-node-id"] = info["node_id"]
        return tags

    # -- GCS --------------------------------------------------------------
    def advance(self, row):
        self.step += 1
        self.now += row["dt"]
        for i, pid in enumerate(self.order):
            info = self.nodes.get(pid)
            if info and not info["node_id"] and (
                    self.step - info["created"] > self.delays[i]):
                info["node_id"] = f"{i:032x}"
        self.row = row

    def get_nodes(self):
        row = self.row
        head_total = {"CPU": 1.0}
        table = [{"node_id": b"\xff" * 16, "state": "ALIVE",
                  "resources_total": dict(head_total),
                  "resources_available": {"CPU": 0.0},
                  "demand_bundles": [dict(b) for b in row["demand"]]}]
        live = [p for p in self.order
                if p in self.nodes and self.nodes[p]["node_id"]]
        for k, pid in enumerate(live):
            info = self.nodes[pid]
            total = {r: float(v) for r, v in
                     self.node_types[info["type"]]["resources"].items()}
            avail = dict(total)
            if row["busy"][k % 16]:
                first = sorted(avail)[0]
                avail[first] = total[first] / 2
            table.append({
                "node_id": bytes.fromhex(info["node_id"]),
                "state": "DEAD" if row["dead"][k % 16] else "ALIVE",
                "resources_total": total,
                "resources_available": avail,
                "demand_bundles": [],
            })
        return table

    async def call(self, method, params):
        if method == "get_nodes":
            return {"nodes": self.get_nodes()}
        if method == "drain_node":
            self.calls.append(("drain_node", params["node_id"].hex()))
            return {}
        raise AssertionError(method)

    async def close(self):
        pass


class _SyncIO:
    """Runs the stub GCS's coroutines, which never wait, in this thread."""

    def run(self, coro, timeout=None):
        try:
            coro.send(None)
        except StopIteration as stop:
            return stop.value
        raise AssertionError("the stub GCS never waits")

    def stop(self):
        pass


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("config", sorted(_PARITY_CONFIGS))
def test_update_equals_the_jax_autoscalers(monkeypatch, config, seed):
    """numpy seeds 0-3, 40 steps each (the last 10 quiet): both StandardAutoscalers see the
    same node tables and make the same launches, drains and terminations."""
    import types

    import ray_tpu.autoscaler.autoscaler as jax_mod
    import ray_tpu_torch.autoscaler.autoscaler as port_mod

    cfg = _PARITY_CONFIGS[config]
    script, delays = _parity_script(seed)
    sides = []
    for mod in (jax_mod, port_mod):
        world = _World(cfg["node_types"], cfg.get("preexisting", []), delays)

        async def connect(host, port, _world=world):
            return _world

        monkeypatch.setattr(mod, "connect", connect)
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            monotonic=lambda _world=world: _world.now))
        scaler = mod.StandardAutoscaler(
            {"node_types": cfg["node_types"],
             "idle_timeout_s": cfg["idle_timeout_s"]},
            world, "127.0.0.1:1", io=_SyncIO())
        sides.append((world, scaler))

    (jw, jax_scaler), (pw, port_scaler) = sides
    seen = set()
    for step, row in enumerate(script):
        jw.advance(row)
        pw.advance(row)
        want = jax_scaler.update()
        got = port_scaler.update()
        assert got == want, (step, got, want)
        assert pw.calls == jw.calls, step
        assert pw.non_terminated_nodes() == jw.non_terminated_nodes(), step
        seen.update(c[0] for c in jw.calls)
    # The script reaches every kind of call.
    assert seen == {"create_node", "terminate_node", "drain_node"}, seen
