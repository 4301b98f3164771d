"""The port's state API and `rt` CLI held against the JAX package's.

One driver script runs in a subprocess under each package (`ray_tpu`
and `ray_tpu_torch`), each with a `TMPDIR` of its own: it starts a
runtime, runs tasks (one failing), a named actor, a placement group, a
large put and a traced span around a task, then reads everything back
through `util.state` (`list_*`, `summarize_tasks`, `get_timeline`,
`fetch_task_events` in pages of 5), `util.tracing.get_trace`, and the
CLI (`python -m <package> status`, `list nodes`, `summary tasks`,
`timeline -o`). Ids, pids, ports, addresses, sizes of the runtime's own
records and timestamps are replaced by ordinals or dropped; the two JSON
outputs must then be equal, except in the views of tasks: there the port
also lists the burst of tasks that ran on a leased worker, which the JAX
runtime does not record.

The drain case runs on the port alone: `drain_node` on a two-node
`Cluster` waits for the node's running task, then removes the node, and
`list_nodes` shows it DEAD (the counterpart of
`tests/test_cluster.py::test_graceful_node_drain`).
"""

import json
import os
import pathlib
import subprocess
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]

DRIVER = r'''
import collections, importlib, json, os, re, subprocess, sys, time

pkg, out_dir = sys.argv[1], sys.argv[2]
if pkg == "ray_tpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["RT_TPU_CHIPS"] = "0"
    import jax
    jax.config.update("jax_platforms", "cpu")
else:
    os.environ["RT_NUM_GPUS"] = "0"
import numpy as np

rt = importlib.import_module(pkg)
state = importlib.import_module(pkg + ".util.state")
api = importlib.import_module(pkg + ".util.state.api")
tracing = importlib.import_module(pkg + ".util.tracing")
pgmod = importlib.import_module(pkg + ".util.placement_group")
worker = importlib.import_module(pkg + "._private.worker")

ids = {}


def norm_id(x):
    """Each distinct id (hex or bytes) becomes its ordinal."""
    if not x:
        return x
    return "id%d" % ids.setdefault(x, len(ids))


def wait_for(fn, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(0.2)
    raise TimeoutError(fn)


rt.init(num_cpus=4)
addr = worker._global_node.gcs_address
out = {}
try:
    @rt.remote
    def add(a, b):
        return a + b

    @rt.remote(max_retries=0)
    def broken():
        raise RuntimeError("nope")

    @rt.remote
    class Holder:
        def get(self):
            return 1

    try:
        rt.get(broken.remote())
    except Exception as e:
        assert "nope" in str(e)
    assert rt.get([add.remote(i, i) for i in range(3)]) == [0, 2, 4]
    h = Holder.options(name="holder").remote()
    assert rt.get([h.get.remote() for _ in range(2)]) == [1, 1]
    big = rt.put(np.ones(300_000))
    pg = pgmod.placement_group([{"CPU": 1}], strategy="PACK")
    assert pg.ready(timeout=30)
    tracing.enable()
    with tracing.span("outer"):
        trace_id = tracing.current()["trace_id"]
        assert rt.get(add.remote(5, 6)) == 11
        with tracing.span("inner"):
            pass
    tracing.disable()

    def finished():
        seen = collections.Counter(
            (t["name"].rsplit(".", 1)[-1], t["type"], t.get("state"))
            for t in state.list_tasks())
        # Tasks run on a leased worker record no events in the JAX
        # runtime: only the first task, sent through the raylet, and the
        # actor calls show. The port's worker records them (ROADMAP §C).
        burst = 4 if pkg == "ray_tpu_torch" else 0
        return (seen[("broken", "NORMAL_TASK", "FAILED")] == 1
                and seen[("add", "NORMAL_TASK", "FINISHED")] == burst
                and seen[("get", "ACTOR_TASK", "FINISHED")] == 2)
    wait_for(finished)
    spans = wait_for(lambda: (lambda s: s if len(s) >= 3 else None)(
        tracing.get_trace(trace_id)))

    nodes = state.list_nodes()
    out["nodes"] = [{
        "state": n["state"], "draining": n["draining"],
        "is_head": n["is_head"], "keys": sorted(n),
        "total": {k: v for k, v in n["resources_total"].items()
                  if k in ("CPU", "GPU")},
    } for n in nodes]
    node_ord = {n["node_id"]: norm_id(n["node_id"]) for n in nodes}
    out["actors"] = [{
        "class_name": a["class_name"], "state": a["state"],
        "name": a["name"], "restarts": a["restarts"],
        "node": node_ord.get(a["node_id"]), "keys": sorted(a),
    } for a in state.list_actors()]
    out["tasks"] = sorted(
        [{"name": t["name"].rsplit(".", 1)[-1], "state": t.get("state"),
          "type": t["type"], "has_duration": "duration_s" in t,
          "node": node_ord.get(t["node_id"])}
         for t in state.list_tasks()],
        key=lambda t: (t["name"], t["state"] or "", t["type"]))
    objs = state.list_objects()
    out["objects"] = {
        "keys": sorted(objs[0]) if objs else [],
        "big_located": [[node_ord.get(n) for n in o["locations"]]
                        for o in objs if o["size"] >= 2_400_000],
    }
    out["jobs"] = [{"state": j.get("state"), "keys": sorted(
        k for k in j if k not in ("driver_pid", "pid"))}
        for j in state.list_jobs()]
    out["placement_groups"] = [{
        "state": p["state"], "strategy": p["strategy"],
        "bundles": p["bundles"],
        "nodes": [node_ord.get(n) for n in p["bundle_nodes"]],
    } for p in state.list_placement_groups()]
    workers = state.list_workers()
    out["workers"] = {
        "keys": sorted(workers[0]) if workers else [],
        "hosting_an_actor": sum(1 for w in workers if w["actor_id"]),
    }
    out["summary"] = {k.rsplit(".", 1)[-1]: v
                      for k, v in state.summarize_tasks().items()}
    tl = state.get_timeline()
    out["timeline"] = sorted(collections.Counter(
        (e["name"].rsplit(".", 1)[-1], e["cat"], e["ph"]) for e in tl
        if e.get("cat") != "trace_span").items())

    client = api.StateApiClient(addr)
    pages = []

    def counting(method, payload=None):
        pages.append(payload.get("offset"))
        return client.call(method, payload)

    try:
        paged = api.fetch_task_events(counting, page=5)
        whole = api.fetch_task_events(client.call)
    finally:
        client.close()
    out["pagination"] = {
        "equal": [(e["task_id"], e["state"], e["ts"]) for e in paged]
        == [(e["task_id"], e["state"], e["ts"]) for e in whole],
        "more_than_one_page": len(pages) > 1,
        "pages_cover_all": len(pages) == -(-len(whole) // 5)
        or len(pages) == -(-len(whole) // 5) + 1,
    }
    by_id = {s["span_id"]: s for s in spans}

    def depth(s):
        d = 0
        while s["parent_id"] in by_id:
            s, d = by_id[s["parent_id"]], d + 1
        return d

    out["trace"] = sorted((s["name"].rsplit(".", 1)[-1], s["kind"],
                           depth(s)) for s in spans)

    def cli(*args):
        p = subprocess.run([sys.executable, "-m", pkg, *args,
                            "--address", addr], capture_output=True,
                           text=True, timeout=120)
        assert p.returncode == 0, (args, p.stderr[-3000:])
        return p.stdout

    host, port = addr.rsplit(":", 1)
    status = cli("status")
    for n in nodes:
        status = status.replace(n["node_id"][:12], node_ord[n["node_id"]])
    status = re.sub(r"@ \S+", "@ ADDR", status)
    # What is free depends on when idle leases went back: totals only.
    status = re.sub(r"  [\d.]+/", "  ?/", status)
    out["cli_status"] = status.splitlines()
    listed = json.loads(cli("list", "nodes"))
    out["cli_list_nodes"] = [{"state": n["state"], "is_head": n["is_head"],
                              "node": node_ord[n["node_id"]]}
                             for n in listed]
    out["cli_summary"] = {k.rsplit(".", 1)[-1]: v for k, v in
                          json.loads(cli("summary", "tasks")).items()}
    tl_file = os.path.join(out_dir, "timeline.json")
    said = cli("timeline", "-o", tl_file)
    events = json.load(open(tl_file))
    out["cli_timeline"] = {
        "said": said.replace(tl_file, "FILE").strip(),
        "names": sorted(collections.Counter(
            e["name"].rsplit(".", 1)[-1] for e in events
            if e.get("cat") != "trace_span").items()),
    }
finally:
    rt.shutdown()
print("RESULT " + json.dumps(out, sort_keys=True, default=str))
'''


def _run(tmp_path, pkg):
    script = tmp_path / "driver.py"
    script.write_text(DRIVER)
    tmp = tmp_path / pkg
    tmp.mkdir()
    env = dict(os.environ, TMPDIR=str(tmp))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in [str(ROOT), env.get("PYTHONPATH", "")] if p)
    proc = subprocess.run([sys.executable, str(script), pkg, str(tmp)],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=400)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    assert line, proc.stdout[-4000:]
    return json.loads(line[-1][len("RESULT "):])


# The views of tasks: the port lists the tasks that ran on a leased
# worker, the JAX runtime does not (ROADMAP §C), so these differ by
# exactly the burst of `add` tasks.
TASK_VIEWS = ("tasks", "summary", "cli_summary", "timeline", "cli_timeline")
BURST = 4  # three adds and the traced one, after `broken` took the lease


def test_state_api_and_cli_match_the_jax_runtime(tmp_path):
    ref = _run(tmp_path, "ray_tpu")
    out = _run(tmp_path, "ray_tpu_torch")
    assert ({k: v for k, v in out.items() if k not in TASK_VIEWS}
            == {k: v for k, v in ref.items() if k not in TASK_VIEWS})

    def leased(tasks):
        return [t for t in tasks
                if (t["name"], t["type"]) == ("add", "NORMAL_TASK")]

    # The reference lists only the first task of the burst (`broken`,
    # which took the lease); the port lists every one, as FINISHED.
    assert leased(ref["tasks"]) == []
    assert len(leased(out["tasks"])) == BURST
    assert all(t["state"] == "FINISHED" and t["has_duration"]
               for t in leased(out["tasks"]))
    assert [t for t in out["tasks"] if t not in leased(out["tasks"])] \
        == ref["tasks"]
    for view in ("summary", "cli_summary"):
        assert ref[view]["add"] == {"FINISHED": 1}  # its span
        assert out[view]["add"] == {"FINISHED": 1 + BURST}
        assert ({k: v for k, v in out[view].items() if k != "add"}
                == {k: v for k, v in ref[view].items() if k != "add"})
    assert out["timeline"] == sorted(
        ref["timeline"] + [[["add", "normal_task", "X"], BURST]])
    assert out["cli_timeline"]["names"] == sorted(
        ref["cli_timeline"]["names"] + [["add", BURST]])
    assert ref["cli_timeline"]["said"].startswith("wrote 6 events")
    assert out["cli_timeline"]["said"].startswith(f"wrote {6 + BURST} events")
    # Everything was seen, on both sides.
    assert out["trace"] == [["add", "task", 1], ["inner", "local", 1],
                            ["outer", "local", 0]]
    assert out["summary"]["broken"] == {"FAILED": 1}
    assert out["pagination"] == {"equal": True, "more_than_one_page": True,
                                 "pages_cover_all": True}
    assert out["actors"][0]["name"] == "holder"
    assert out["placement_groups"][0]["state"] == "CREATED"
    assert out["objects"]["big_located"] == [["id0"]]
    assert out["cli_status"][:3] == ["1/1 nodes alive", "resources:",
                                     "  ?/4 CPU"]
    assert out["cli_timeline"]["said"].startswith("wrote ")


def test_drain_node_waits_for_running_work_then_removes_the_node():
    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )
    from ray_tpu_torch.util.state import drain_node, list_nodes

    cluster = Cluster()
    try:
        cluster.add_node(num_cpus=2)
        n2 = cluster.add_node(num_cpus=2)
        cluster.connect()

        @rt.remote
        def where(sleep_s=0.0):
            import os
            import time as _t

            _t.sleep(sleep_s)
            return os.environ["RT_NODE_ID"]

        hexid = n2.node_id.binary().hex()
        busy = where.options(scheduling_strategy=NodeAffinitySchedulingStrategy(
            node_id=n2.node_id.binary())).remote(3.0)
        time.sleep(0.5)
        result = {}
        th = threading.Thread(target=lambda: result.update(
            r=drain_node(hexid, timeout=60, poll_s=0.3)))
        th.start()
        time.sleep(1.0)  # the cordon has reached the raylet
        spots = set(rt.get([where.remote() for _ in range(6)], timeout=60))
        assert hexid not in spots, "the cordoned node still took work"
        assert th.is_alive(), "the drain did not wait for the running task"
        assert rt.get(busy, timeout=60) == hexid
        th.join(timeout=60)
        assert not th.is_alive() and result["r"].get("ok"), result
        states = {n["node_id"]: n["state"] for n in list_nodes()}
        assert states[hexid] == "DEAD"
        assert [s for h, s in states.items() if h != hexid] == ["ALIVE"]
        assert rt.get(where.remote(), timeout=60) != hexid
    finally:
        cluster.shutdown()
