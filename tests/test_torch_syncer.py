"""The port's resource syncer (the GCS's full and delta resource views):
the cases of tests/test_syncer.py run against ray_tpu_torch, with the
card as the `GPU` resource where the JAX cases report `TPU` chips."""

import time

import pytest

import ray_tpu_torch as rt


@pytest.fixture
def rt_start():
    """A real single-node runtime of the port."""
    import ray_tpu_torch as rt

    rt.init(num_cpus=4)
    yield rt
    rt.shutdown()


def _gcs_call(method, payload):
    client = rt._worker.get_client()
    return client._run(client._gcs_call(method, payload))


def test_delta_protocol_full_delta_gap(rt_start):
    """Drive the GCS-side protocol directly with a synthetic node:
    full baseline -> delta applies -> version gap demands a full view."""
    node_id = b"\x42" * 16
    _gcs_call("register_node", {
        "node_id": node_id, "address": "127.0.0.1", "port": 1,
        "object_store_name": None, "resources": {"CPU": 4.0, "GPU": 8.0},
        "labels": {}, "is_head": False,
    })
    # 1. Full view establishes the baseline.
    r = _gcs_call("resource_update", {
        "node_id": node_id, "version": 1,
        "available": {"CPU": 4.0, "GPU": 8.0},
    })
    assert r["ok"] and not r.get("need_full")
    # 2. Delta: CPU drops, GPU entry removed.
    r = _gcs_call("resource_update", {
        "node_id": node_id, "version": 2,
        "delta": {"CPU": 1.5}, "removed": ["GPU"],
    })
    assert r["ok"]
    nodes = {n["node_id"]: n for n in _gcs_call("get_nodes", {})["nodes"]}
    avail = nodes[node_id]["resources_available"]
    assert avail == {"CPU": 1.5}
    # 3. Version gap (skipped 3): the GCS must refuse and ask for a full
    # view rather than apply a delta against unknown intermediate state.
    r = _gcs_call("resource_update", {
        "node_id": node_id, "version": 4, "delta": {"CPU": 4.0},
    })
    assert r.get("need_full") and not r["ok"]
    # The stale view is untouched.
    nodes = {n["node_id"]: n for n in _gcs_call("get_nodes", {})["nodes"]}
    assert nodes[node_id]["resources_available"] == {"CPU": 1.5}
    # 4. Recovery: a full view under the next version re-bases.
    r = _gcs_call("resource_update", {
        "node_id": node_id, "version": 5, "available": {"CPU": 4.0},
    })
    assert r["ok"]
    nodes = {n["node_id"]: n for n in _gcs_call("get_nodes", {})["nodes"]}
    assert nodes[node_id]["resources_available"] == {"CPU": 4.0}


def test_unknown_node_demands_full(rt_start):
    r = _gcs_call("resource_update", {
        "node_id": b"\x99" * 16, "version": 7, "delta": {"CPU": 1.0},
    })
    assert r.get("need_full")


def test_live_raylet_syncs_deltas_end_to_end(rt_start):
    """The real heartbeat path: occupancy changes propagate to the GCS
    view through the delta protocol while a task holds resources."""
    from ray_tpu_torch.util.state import list_nodes

    @rt.remote
    def hold():
        import time as _t

        _t.sleep(2.0)
        return 1

    ref = hold.options(num_cpus=3).remote()
    deadline = time.monotonic() + 10
    saw_drop = False
    while time.monotonic() < deadline:
        [node] = [n for n in list_nodes() if n["state"] == "ALIVE"]
        if node["resources_available"].get("CPU") == 1.0:
            saw_drop = True
            break
        time.sleep(0.2)
    assert saw_drop, "GCS never observed the CPU drop via delta sync"
    assert rt.get(ref, timeout=120) == 1
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        [node] = [n for n in list_nodes() if n["state"] == "ALIVE"]
        if node["resources_available"].get("CPU") == 4.0:
            return
        time.sleep(0.2)
    raise AssertionError("GCS never observed the CPU release")
