"""The port's GKE and GCE TPU node providers against the mocked REST
surfaces of tests/test_gke_provider.py and tests/test_gce_provider.py
(copied here): each case of those files runs its scenario once with the
JAX provider and once with the port's, each against a fresh mock, and
asserts what the JAX case asserts of the port's run. The two runs must
send the same (method, url, body) calls and return the same node ids and
tags. GCE node names take uuid4: both runs draw from one fixed sequence.
"""

import re
import uuid

import pytest

from ray_tpu.autoscaler import node_provider as jax_np
from ray_tpu_torch.autoscaler import node_provider as torch_np


# -- the GKE mock (tests/test_gke_provider.py) -------------------------------
class MockGKE:
    def __init__(self):
        self.pools = {
            "tpu-v5e-16": {"size": 0, "instances": [], "slice_hosts": 4},
            "cpu-pool": {"size": 1, "instances": ["zones/z/instances/cpu-0"],
                         "slice_hosts": 1},
        }
        self._op_counter = 0
        self._pending_ops = {}  # op name -> remaining polls until DONE
        self.calls = []  # recorded (method, url, body)

    def _pool_of(self, url):
        m = re.search(r"nodePools/([^:/]+)", url)
        if m:
            return m.group(1)
        m = re.search(r"instanceGroupManagers/([^/]+)", url)
        return m.group(1)

    def request(self, method, url, body=None):
        self.calls.append((method, url, body))
        if ":setSize" in url:
            pool = self.pools[self._pool_of(url)]
            target = body["nodeCount"]
            while len(pool["instances"]) < target:
                pool["instances"].append(
                    f"zones/z/instances/{self._pool_of(url)}-"
                    f"{len(pool['instances'])}"
                )
            pool["size"] = target
            self._op_counter += 1
            name = f"operation-{self._op_counter}"
            self._pending_ops[name] = 2  # DONE after 2 polls
            return {"name": name, "status": "RUNNING"}
        if "/operations/" in url:
            name = url.rsplit("/", 1)[1]
            self._pending_ops[name] -= 1
            done = self._pending_ops[name] <= 0
            return {"name": name, "status": "DONE" if done else "RUNNING"}
        if url.endswith("/listManagedInstances"):
            pool = self.pools[self._pool_of(url)]
            return {
                "managedInstances": [
                    {"instance": u} for u in pool["instances"]
                ]
            }
        if url.endswith("/deleteInstances"):
            pool = self.pools[self._pool_of(url)]
            for u in body["instances"]:
                if u in pool["instances"]:
                    pool["instances"].remove(u)
                    pool["size"] -= 1
            return {"status": "DONE"}
        if url.endswith("/nodePools") and method == "GET":
            return {"nodePools": [{"name": n} for n in self.pools]}
        if "/nodePools/" in url and method == "GET":
            name = self._pool_of(url)
            pool = self.pools[name]
            return {
                "name": name,
                "initialNodeCount": pool["size"],
                "instanceGroupUrls": [
                    f"https://compute.googleapis.com/compute/v1/projects/p/"
                    f"zones/z/instanceGroupManagers/{name}"
                ],
            }
        raise AssertionError(f"unexpected GKE call: {method} {url}")


# -- the Cloud TPU mock (tests/test_gce_provider.py) -------------------------
class MockTPUAPI:
    def __init__(self):
        self.nodes = {}  # node_id -> node dict
        self._op_counter = 0
        self._pending = {}  # op name -> (polls_left, error_or_None, finalize)
        self.calls = []
        self.quota_denied = False

    def request(self, method, url, body=None):
        self.calls.append((method, url, body))
        if method == "POST" and "/nodes?nodeId=" in url:
            node_id = url.rsplit("nodeId=", 1)[1]
            if self.quota_denied:
                return self._op(error={"code": 8, "message":
                                       "RESOURCE_EXHAUSTED: quota"})

            def finalize():
                self.nodes[node_id] = {
                    "name": f"projects/p/locations/z/nodes/{node_id}",
                    "state": "READY",
                    "labels": body.get("labels", {}),
                    "acceleratorType": body["acceleratorType"],
                    "networkEndpoints": [
                        {"ipAddress": f"10.0.0.{i}"} for i in range(4)
                    ],
                }
            return self._op(finalize=finalize)
        if method == "DELETE" and "/nodes/" in url:
            node_id = url.rsplit("/", 1)[1]
            self.nodes.pop(node_id, None)
            return self._op()
        if method == "GET" and url.endswith("/nodes"):
            return {"nodes": list(self.nodes.values())}
        if method == "GET" and "/operations/" in url:
            name = url.split("/projects/", 1)[1]
            name = "projects/" + name
            polls, error, finalize = self._pending[name]
            polls -= 1
            if polls > 0:
                self._pending[name] = (polls, error, finalize)
                return {"name": name, "done": False}
            if error:
                return {"name": name, "done": True, "error": error}
            if finalize:
                finalize()
            return {"name": name, "done": True, "response": {}}
        raise AssertionError(f"unexpected TPU API call: {method} {url}")

    def _op(self, error=None, finalize=None):
        self._op_counter += 1
        name = f"projects/p/locations/z/operations/op-{self._op_counter}"
        self._pending[name] = (2, error, finalize)  # done after 2 polls
        return {"name": name, "done": False}


@pytest.fixture
def fixed_uuid4(monkeypatch):
    """uuid4 from one fixed sequence, restarted for each package's run."""
    state = {"n": 0}

    def uuid4():
        state["n"] += 1
        return uuid.UUID(int=state["n"] * 0x9E3779B97F4A7C15 % (1 << 128))

    monkeypatch.setattr(uuid, "uuid4", uuid4)
    return state


def _both(scenario, mock_cls, uuid_state=None):
    """Run scenario(module, mock) for the JAX package, then the port; the
    calls and the returned values must be equal. Returns the port's."""
    out = {}
    for name, mod in (("jax", jax_np), ("torch", torch_np)):
        if uuid_state is not None:
            uuid_state["n"] = 0
        mock = mock_cls()
        out[name] = (scenario(mod, mock), mock.calls)
    assert out["torch"][1] == out["jax"][1]
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][1], "the scenario made no API call"
    return out["torch"][0]


# -- GKE cases -----------------------------------------------------------------
def _gke(mod, mock, **kw):
    return mod.GKETPUNodeProvider("proj", "us-central2-b", "tpu-cluster",
                                  transport=mock, poll_interval_s=0.0, **kw)


def test_gke_create_slice_is_whole_slice_atomic():
    def scenario(mod, mock):
        p = _gke(mod, mock)
        ids = p.create_node(
            "v5e-16", {"node_pool": "tpu-v5e-16", "slice_hosts": 4}, count=1)
        # One slice = 4 hosts created together; 0 -> 4 in ONE call.
        assert len(ids) == 4
        resizes = [c for c in mock.calls if ":setSize" in c[1]]
        assert len(resizes) == 1
        assert resizes[0][2] == {"nodeCount": 4}
        assert mock.pools["tpu-v5e-16"]["size"] == 4
        for nid in ids:
            assert p.node_tags(nid)["rt-node-type"] == "v5e-16"
        return ids, [p.node_tags(n) for n in ids]

    _both(scenario, MockGKE)


def test_gke_create_two_slices():
    def scenario(mod, mock):
        ids = _gke(mod, mock).create_node(
            "v5e-16", {"node_pool": "tpu-v5e-16", "slice_hosts": 4}, count=2)
        assert len(ids) == 8
        assert mock.pools["tpu-v5e-16"]["size"] == 8
        return ids

    _both(scenario, MockGKE)


def test_gke_setsize_operation_is_polled_to_done():
    def scenario(mod, mock):
        _gke(mod, mock).create_node(
            "v5e-16", {"node_pool": "tpu-v5e-16", "slice_hosts": 4}, 1)
        op_polls = [c for c in mock.calls if "/operations/" in c[1]]
        assert len(op_polls) >= 2, "async setSize must be polled until DONE"
        return len(op_polls)

    _both(scenario, MockGKE)


def test_gke_terminate_deletes_instance_via_instance_group():
    def scenario(mod, mock):
        p = _gke(mod, mock)
        ids = p.create_node(
            "v5e-16", {"node_pool": "tpu-v5e-16", "slice_hosts": 4}, 1)
        p.terminate_node(ids[0])
        deletes = [c for c in mock.calls
                   if c[1].endswith("/deleteInstances")]
        assert len(deletes) == 1
        assert deletes[0][2]["instances"] == [ids[0].split("|", 1)[1]]
        assert mock.pools["tpu-v5e-16"]["size"] == 3
        live = p.non_terminated_nodes()
        assert ids[0] not in live
        return ids, live

    _both(scenario, MockGKE)


def test_gke_non_terminated_reflects_live_pool_state():
    def scenario(mod, mock):
        p = _gke(mod, mock, managed_pools=["tpu-v5e-16"])
        ids = p.create_node(
            "v5e-16", {"node_pool": "tpu-v5e-16", "slice_hosts": 4}, 1)
        live = p.non_terminated_nodes()
        assert sorted(live) == sorted(ids)
        # An instance that dies out-of-band disappears from the listing.
        mock.pools["tpu-v5e-16"]["instances"].pop()
        after = p.non_terminated_nodes()
        assert len(after) == 3
        return live, after

    _both(scenario, MockGKE)


def test_gke_restarted_provider_still_sees_nodes():
    """Node enumeration comes from the live API, not in-process memory: a
    fresh provider still sees (and can terminate) running slices."""
    def scenario(mod, mock):
        ids = _gke(mod, mock).create_node(
            "v5e-16", {"node_pool": "tpu-v5e-16", "slice_hosts": 4}, 1)
        fresh = _gke(mod, mock)
        live = fresh.non_terminated_nodes()
        assert set(ids) <= set(live)
        assert "cpu-pool|zones/z/instances/cpu-0" in live
        fresh.terminate_node(ids[0])
        assert mock.pools["tpu-v5e-16"]["size"] == 3
        return ids, live, fresh.node_tags(ids[1])

    _both(scenario, MockGKE)


def test_gke_cpu_pool_single_host():
    def scenario(mod, mock):
        ids = _gke(mod, mock).create_node("cpu", {"node_pool": "cpu-pool"},
                                          count=2)
        assert len(ids) == 2
        assert mock.pools["cpu-pool"]["size"] == 3
        return ids

    _both(scenario, MockGKE)


class _QuotaDeniedGKE(MockGKE):
    def request(self, method, url, body=None):
        out = super().request(method, url, body)
        if "/operations/" in url and out.get("status") == "DONE":
            out["error"] = {"code": 8, "message":
                            "RESOURCE_EXHAUSTED: TPU quota exceeded"}
        return out


def test_gke_quota_denied_operation_raises():
    """A setSize whose operation completes with an error (quota denial)
    surfaces as an exception, not as zero nodes."""
    def scenario(mod, mock):
        with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED") as e:
            _gke(mod, mock).create_node(
                "v5e-16", {"node_pool": "tpu-v5e-16", "slice_hosts": 4}, 1)
        return str(e.value)

    _both(scenario, _QuotaDeniedGKE)


class _StockoutGKE(MockGKE):
    def request(self, method, url, body=None):
        if ":setSize" in url:
            body = dict(body)
            body["nodeCount"] = min(body["nodeCount"], 6)  # stockout at 6
        return super().request(method, url, body)


def test_gke_partial_resize_returns_only_new_instances():
    """A resize the platform only partly honours (target 8, delivered 6)
    reports exactly the instances that exist."""
    def scenario(mod, mock):
        p = _gke(mod, mock)
        ids = p.create_node(
            "v5e-16", {"node_pool": "tpu-v5e-16", "slice_hosts": 4}, 2)
        assert len(ids) == 6  # what actually exists, not the 8 requested
        assert len(p.non_terminated_nodes()) >= 6
        return ids

    _both(scenario, _StockoutGKE)


class _HangingGKE(MockGKE):
    def request(self, method, url, body=None):
        out = super().request(method, url, body)
        if "/operations/" in url:
            out["status"] = "RUNNING"  # never completes
        return out


def test_gke_operation_timeout_raises():
    def scenario(mod, mock):
        p = _gke(mod, mock)
        p.op_timeout_s = 0.01
        with pytest.raises(TimeoutError):
            p.create_node(
                "v5e-16", {"node_pool": "tpu-v5e-16", "slice_hosts": 4}, 1)
        # Poll counts depend on the clock: compare the calls up to the
        # first poll, the rest by kind.
        mock.calls[:] = [c for i, c in enumerate(mock.calls)
                         if "/operations/" not in c[1]
                         or "/operations/" not in mock.calls[i - 1][1]]
        return None

    _both(scenario, _HangingGKE)


# -- GCE cases -----------------------------------------------------------------
def _gce(mod, api):
    return mod.GCETPUNodeProvider("p", "z", transport=api,
                                  poll_interval_s=0.0)


def test_gce_create_is_slice_atomic(fixed_uuid4):
    def scenario(mod, api):
        p = _gce(mod, api)
        ids = p.create_node("tpu_v5e_16",
                            {"accelerator_type": "v5litepod-16"}, 2)
        assert len(ids) == 2
        assert set(p.non_terminated_nodes()) == set(ids)
        tags = [p.node_tags(nid) for nid in ids]
        for t in tags:
            assert t["rt-node-type"] == "tpu_v5e_16"
            assert t["rt-workers"] == "4"
            assert t["rt-state"] == "READY"
        return ids, tags

    _both(scenario, MockTPUAPI, fixed_uuid4)


def test_gce_create_passes_config_through(fixed_uuid4):
    def scenario(mod, api):
        ids = _gce(mod, api).create_node(
            "tpu", {
                "accelerator_type": "v5litepod-16",
                "runtime_version": "tpu-vm-v4-base",
                "network": "projects/p/global/networks/default",
                "metadata": {"startup-script": "rt start --join"},
                "labels": {"team": "ml"},
            }, 1,
        )
        method, url, body = api.calls[0]
        assert body["runtimeVersion"] == "tpu-vm-v4-base"
        assert body["networkConfig"]["network"].endswith("default")
        assert body["metadata"]["startup-script"].startswith("rt start")
        assert body["labels"]["rt-managed"] == "1"
        assert body["labels"]["team"] == "ml"
        return ids

    _both(scenario, MockTPUAPI, fixed_uuid4)


def test_gce_terminate_removes_slice(fixed_uuid4):
    def scenario(mod, api):
        p = _gce(mod, api)
        (nid,) = p.create_node("tpu", {"accelerator_type": "v5litepod-16"}, 1)
        p.terminate_node(nid)
        assert p.non_terminated_nodes() == []
        return nid

    _both(scenario, MockTPUAPI, fixed_uuid4)


def test_gce_restarted_provider_rediscovers_fleet(fixed_uuid4):
    """Enumeration comes from the live API and labels, never memory."""
    def scenario(mod, api):
        ids = _gce(mod, api).create_node(
            "tpu", {"accelerator_type": "v5litepod-16"}, 2)
        fresh = _gce(mod, api)
        assert set(fresh.non_terminated_nodes()) == set(ids)
        assert fresh.node_tags(ids[0])["rt-node-type"] == "tpu"
        return ids

    _both(scenario, MockTPUAPI, fixed_uuid4)


def test_gce_unmanaged_and_dead_nodes_excluded(fixed_uuid4):
    def scenario(mod, api):
        p = _gce(mod, api)
        (nid,) = p.create_node("tpu", {"accelerator_type": "v5litepod-16"}, 1)
        api.nodes["other"] = {
            "name": "projects/p/locations/z/nodes/other",
            "state": "READY", "labels": {},
        }
        api.nodes["dead"] = {
            "name": "projects/p/locations/z/nodes/dead",
            "state": "TERMINATED", "labels": {"rt-managed": "1"},
        }
        assert p.non_terminated_nodes() == [nid]
        return nid

    _both(scenario, MockTPUAPI, fixed_uuid4)


def test_gce_quota_denial_raises_with_slice_attribution(fixed_uuid4):
    def scenario(mod, api):
        api.quota_denied = True
        p = _gce(mod, api)
        with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED") as e:
            p.create_node("tpu", {"accelerator_type": "v5litepod-16"}, 3)
        assert p.non_terminated_nodes() == []
        return str(e.value)

    _both(scenario, MockTPUAPI, fixed_uuid4)


def test_gce_op_timeout_raises(fixed_uuid4):
    def scenario(mod, api):
        p = _gce(mod, api)
        p.op_timeout_s = 0.01

        def never_done(method, url, body=None):
            api.calls.append((method, url, body))
            if method == "POST":
                return {"name": "projects/p/locations/z/operations/op-hang",
                        "done": False}
            return {"name": url, "done": False}

        p.transport = type("T", (), {"request": staticmethod(never_done)})()
        with pytest.raises(TimeoutError):
            p.create_node("tpu", {"accelerator_type": "v5litepod-16"}, 1)
        del api.calls[2:]  # the poll count depends on the clock
        return None

    _both(scenario, MockTPUAPI, fixed_uuid4)


def test_provider_registry():
    api = MockTPUAPI()
    p = torch_np.make_node_provider(
        {"type": "gce_tpu", "project": "p", "zone": "z", "transport": api}
    )
    assert isinstance(p, torch_np.GCETPUNodeProvider)
    g = torch_np.make_node_provider(
        {"type": "gke", "project": "p", "zone": "z", "cluster": "c",
         "transport": api}
    )
    assert isinstance(g, torch_np.GKETPUNodeProvider)
    proc = torch_np.make_node_provider({"type": "process"},
                                       gcs_host="127.0.0.1", gcs_port=1)
    assert isinstance(proc, torch_np.ProcessNodeProvider)
    with pytest.raises(ValueError, match="unknown provider"):
        torch_np.make_node_provider({"type": "azure"})
    with pytest.raises(ValueError) as jax_err:
        jax_np.make_node_provider({"type": "azure"})
    with pytest.raises(ValueError) as torch_err:
        torch_np.make_node_provider({"type": "azure"})
    assert str(torch_err.value) == str(jax_err.value)
