"""The port's dashboard (ray_tpu_torch.dashboard, on the standard
library's asyncio server) and its Grafana board, held against the JAX
package's aiohttp dashboard:

  * the 8 cases of tests/test_metrics_dashboard.py and the 5 of
    tests/test_tracing_grafana.py, run against the port (the page's
    title and the board's uid name the port);
  * one driver script, run under each package, builds the same cluster
    state (an actor, tasks, an object, a placement group, user metrics
    with labels that need escaping, a Serve app, a job POSTed to the
    REST API) and reads every route: each route's status, content type
    and JSON are equal once ids, pids, ports and times are removed; the
    404, 405 (with its Allow header), 500 and HEAD answers are equal;
    the exposition's metric names and label sets are equal, and so are
    the user metrics' lines;
  * the Grafana JSON is equal apart from the title and the uid.
"""

import json
import re
import time
import urllib.request

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch.util import tracing
from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram
from tests.test_torch_serve_api import PRELUDE, run_driver


@pytest.fixture
def rt_start():
    """A real single-node runtime of the port."""
    rt.init(num_cpus=4)
    yield rt
    rt.shutdown()


def _wait_for(fn, timeout=10.0, poll=0.2):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(poll)
    raise TimeoutError("condition not met")


def _snapshot(client):
    return client._run(client.gcs.call("metrics_snapshot", {}))["metrics"]


def test_metric_validation(rt_start):
    c = Counter("val_counter", tag_keys=("a",))
    with pytest.raises(ValueError):
        c.inc(0)
    with pytest.raises(ValueError):
        c.inc(1, tags={"bogus": "x"})
    with pytest.raises(ValueError):
        Histogram("val_hist", boundaries=[2.0, 1.0])


def test_metrics_flow_to_gcs(rt_start):
    client = worker_mod.get_client()
    c = Counter("req_count", description="requests", tag_keys=("route",))
    g = Gauge("queue_depth")
    h = Histogram("latency_s", boundaries=[0.1, 1.0, 10.0])

    c.inc(1, tags={"route": "/a"})
    c.inc(2, tags={"route": "/b"})
    g.set(7.0)
    for v in (0.05, 0.5, 5.0, 50.0):
        h.observe(v)

    def ready():
        names = {m["name"] for m in _snapshot(client)}
        return {"req_count", "queue_depth", "latency_s"} <= names

    _wait_for(ready)
    snap = {m["name"]: m for m in _snapshot(client)}
    counter_series = {tuple(map(tuple, k)): v for k, v in snap["req_count"]["series"]}
    assert counter_series[(("route", "/a"),)] == 1
    assert counter_series[(("route", "/b"),)] == 2
    assert snap["queue_depth"]["series"][0][1] == 7.0
    hseries = snap["latency_s"]["series"][0][1]
    assert hseries["count"] == 4
    assert hseries["buckets"] == [1, 1, 1, 1]

    # Counters accumulate across flushes.
    c.inc(5, tags={"route": "/a"})
    _wait_for(
        lambda: {
            tuple(map(tuple, k)): v
            for k, v in {m["name"]: m for m in _snapshot(client)}["req_count"][
                "series"
            ]
        }.get((("route", "/a"),)) == 6
    )


def test_metrics_in_tasks(rt_start):
    """Metrics recorded inside worker processes reach the GCS aggregate."""

    @rt.remote
    def work():
        from ray_tpu_torch.util.metrics import Counter

        c = Counter("task_side_counter")
        c.inc(1)
        time.sleep(1.5)  # let the worker's flusher run
        return 1

    assert rt.get(work.remote(), timeout=60) == 1
    client = worker_mod.get_client()
    _wait_for(
        lambda: any(m["name"] == "task_side_counter" for m in _snapshot(client))
    )


@pytest.fixture
def dashboard(rt_start):
    """In-process dashboard against the running GCS."""
    from ray_tpu_torch.dashboard import Dashboard

    node = worker_mod._global_node
    dash = Dashboard(node.gcs_address, port=0)
    port = node.io.run(dash.start())
    yield f"http://127.0.0.1:{port}"
    node.io.run(dash.stop())


def _get(url: str) -> str:
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read().decode()


def test_dashboard_endpoints(dashboard):
    @rt.remote
    class Pinger:
        def ping(self):
            return "pong"

    p = Pinger.remote()
    assert rt.get(p.ping.remote()) == "pong"

    assert _get(dashboard + "/healthz") == "ok"
    assert "ray_tpu_torch dashboard" in _get(dashboard + "/")

    status = json.loads(_get(dashboard + "/api/cluster_status"))
    assert status["alive_nodes"] == 1
    assert status["resources_total"]["CPU"] == 4

    nodes = json.loads(_get(dashboard + "/api/nodes"))
    assert nodes[0]["state"] == "ALIVE"

    actors = json.loads(_get(dashboard + "/api/actors"))
    assert actors and actors[0]["class_name"] == "Pinger"

    # Profiling drill-down: live worker thread stacks through the UI API
    # (the `rt stack` backend surfaced per node).
    stacks = json.loads(_get(dashboard + "/api/stacks"))
    assert stacks and stacks[0].get("workers"), stacks
    some = stacks[0]["workers"][0]
    assert some.get("threads") and any(
        "stack" in t for t in some["threads"]
    )

    # Serve tab source: controller checkpoint -> /api/serve.
    from ray_tpu_torch import serve as rt_serve

    @rt_serve.deployment(num_replicas=1)
    def dash_echo(x):
        return x

    rt_serve.run(dash_echo.bind(), name="dash_app")
    apps = _wait_for(
        lambda: (lambda a: a if a else None)(
            json.loads(_get(dashboard + "/api/serve"))
        )
    )
    assert any(a["app"] == "dash_app" and a["running_replicas"] == 1
               for a in apps), apps
    rt_serve.shutdown()

    Counter("dash_counter").inc(3)
    body = _wait_for(
        lambda: (lambda t: t if "dash_counter" in t else None)(
            _get(dashboard + "/metrics")
        )
    )
    assert "rt_node_resource_total" in body
    assert "dash_counter 3" in body


def test_dashboard_job_rest(dashboard):
    import sys

    payload = json.dumps(
        {"entrypoint": f"{sys.executable} -c \"print('dash job ran')\""}
    ).encode()
    req = urllib.request.Request(
        dashboard + "/api/jobs", data=payload,
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=10) as r:
        sid = json.loads(r.read())["submission_id"]

    def done():
        info = json.loads(_get(dashboard + f"/api/jobs/{sid}"))
        return info if info["state"] in ("SUCCEEDED", "FAILED", "STOPPED") else None

    info = _wait_for(done, timeout=60)
    assert info["state"] == "SUCCEEDED"
    assert "dash job ran" in _get(dashboard + f"/api/jobs/{sid}/logs")

def test_raylet_runtime_metrics_reach_prometheus(dashboard):
    """Per-component raylet runtime metrics (tasks dispatched, store usage,
    worker count) flow to the GCS aggregate AND render on the dashboard's
    Prometheus exposition endpoint (reference: stats/metric_defs.h:46-61)."""

    @rt.remote
    def touch():
        return 1

    rt.get([touch.remote() for _ in range(3)])
    client = worker_mod.get_client()

    def dispatched_counted():
        snap = {m["name"]: m for m in _snapshot(client)}
        m = snap.get("rt_raylet_tasks_dispatched_total")
        return m and sum(v for _t, v in m["series"]) >= 3

    _wait_for(dispatched_counted)
    names = {m["name"] for m in _snapshot(client)}
    assert {"rt_raylet_store_used_bytes", "rt_raylet_workers",
            "rt_raylet_tasks_queued"} <= names

    text = urllib.request.urlopen(dashboard + "/metrics", timeout=30).read().decode()
    assert "rt_raylet_tasks_dispatched_total{" in text
    assert "rt_raylet_store_used_bytes{" in text


def test_gcs_runtime_metrics_reach_prometheus(dashboard):
    """GCS-internal per-component metrics (rpc volume by method, table
    sizes) render on /metrics (reference: the GCS rows of
    stats/metric_defs.h)."""

    @rt.remote
    def touch():
        return 1

    rt.get(touch.remote())
    client = worker_mod.get_client()
    stats = client._run(client._gcs_call("gcs_stats", {}))
    assert stats["rpc_counts"].get("register_node", 0) >= 1
    assert stats["nodes_alive"] >= 1
    assert stats["rpc_counts"].get("gcs_stats", 0) >= 1  # self-counting

    text = urllib.request.urlopen(
        dashboard + "/metrics", timeout=30
    ).read().decode()
    # get_nodes is guaranteed counted: the exposition handler itself
    # calls it (heartbeat-dependent methods would race a fresh cluster).
    assert 'rt_gcs_rpc_total{method="get_nodes"}' in text
    assert 'rt_gcs_rpc_total{method="register_node"}' in text
    assert "rt_gcs_kv_entries" in text
    assert "rt_gcs_task_events" in text


def test_structured_events_and_proc_stats(tmp_path, monkeypatch):
    """RAY_EVENT analog: components append JSON-line event files; the
    dashboard merges them at /api/events. Per-process stats (cpu%%, rss
    from /proc) flow raylet -> GCS node view."""
    monkeypatch.setenv("RT_EVENT_DIR", str(tmp_path / "events"))
    from ray_tpu_torch.util.event import read_events, record_event

    record_event("testcomp", "hello world", severity="WARNING", extra=7)
    record_event("othercomp", "second")
    evts = read_events()
    assert len(evts) == 2
    assert evts[0]["message"] == "hello world"
    assert evts[0]["severity"] == "WARNING" and evts[0]["extra"] == 7
    only = read_events(source="othercomp")
    assert len(only) == 1 and only[0]["source"] == "othercomp"

    # Live cluster: a killed worker emits a raylet event, and the GCS
    # node view carries aggregated per-process stats within a heartbeat.
    rt.init(num_cpus=2)
    try:
        @rt.remote
        def hold():
            import time as _t

            _t.sleep(30)

        ref = hold.remote()
        import time as _t

        from ray_tpu_torch._private import worker as worker_mod

        client = worker_mod.get_client()
        deadline = _t.monotonic() + 30
        stats = {}
        while _t.monotonic() < deadline:
            nodes = client._run(client._gcs_call("get_nodes", {}))["nodes"]
            stats = nodes[0].get("proc_stats") or {}
            if stats.get("workers", 0) >= 1 and stats.get("rss_bytes", 0) > 0:
                break
            _t.sleep(0.5)
        assert stats.get("workers", 0) >= 1, stats
        assert stats.get("rss_bytes", 0) > 0, stats

        # SIGKILL the worker running `hold`: an unexpected-death event
        # must appear in the raylet's structured log.
        import os
        import signal

        infos = client._run(
            client.raylet.call("get_info", {}), timeout=10
        )["workers"]
        busy = [w for w in infos if w["current_task"] is not None]
        assert busy
        os.kill(busy[0]["pid"], signal.SIGKILL)
        deadline = _t.monotonic() + 30
        while _t.monotonic() < deadline:
            evts = [e for e in read_events(source="raylet")
                    if "died unexpectedly" in e["message"]]
            if evts:
                break
            _t.sleep(0.5)
        assert evts, "worker death produced no structured event"
    finally:
        rt.shutdown()


# ---------------------------------------------------------------------------
# tests/test_tracing_grafana.py against the port
# ---------------------------------------------------------------------------


@pytest.fixture(autouse=True)
def _tracing_off_after():
    yield
    tracing.disable()


def test_span_nesting_local():
    tracing.enable()
    assert tracing.current() is None
    with tracing.span("outer"):
        outer = tracing.current()
        assert outer is not None
        with tracing.span("inner"):
            inner = tracing.current()
            assert inner["trace_id"] == outer["trace_id"]
            assert inner["span_id"] != outer["span_id"]
        assert tracing.current() == outer
    assert tracing.current() is None


def test_inject_roots_new_trace_when_idle():
    tracing.enable()
    ctx = tracing.inject()
    assert ctx["parent_span_id"] == ""
    assert len(ctx["trace_id"]) == 32
    tracing.disable()
    assert tracing.inject() is None


def test_task_spans_form_cross_process_tree(rt_start):
    tracing.enable()

    @rt.remote
    def child():
        return "ok"

    @rt.remote
    def parent():
        return rt.get(child.remote())

    with tracing.span("request"):
        root_ctx = tracing.current()
        assert rt.get(parent.remote(), timeout=120) == "ok"
    from ray_tpu_torch.util import profiling

    profiling.flush()
    # Worker-side spans ride the bounded-delay batch flush (default
    # 0.25s) rather than an eager per-span RPC — wait out one window.
    time.sleep(0.7)

    spans = tracing.get_trace(root_ctx["trace_id"])
    # Task spans carry the function qualname; match by suffix.
    by_name = {s["name"].rsplit(".", 1)[-1]: s for s in spans}
    assert {"request", "parent", "child"} <= set(by_name), by_name.keys()
    # parent task's span is a child of the driver's "request" span...
    assert by_name["parent"]["parent_id"] == by_name["request"]["span_id"]
    # ...and the nested task's span hangs off the parent task's span.
    assert by_name["child"]["parent_id"] == by_name["parent"]["span_id"]
    assert all(s["dur_s"] >= 0 for s in spans)


def test_actor_call_spans_join_the_trace(rt_start):
    tracing.enable()

    @rt.remote
    class A:
        def work(self):
            return 1

    a = A.remote()
    rt.get(a.work.remote(), timeout=120)  # untraced warmup outside span
    with tracing.span("actor-request"):
        ctx = tracing.current()
        assert rt.get(a.work.remote(), timeout=120) == 1
    from ray_tpu_torch.util import profiling

    profiling.flush()
    # Worker-side spans ride the bounded-delay batch flush (default
    # 0.25s) rather than an eager per-span RPC — wait out one window.
    time.sleep(0.7)
    spans = tracing.get_trace(ctx["trace_id"])
    by_name = {s["name"]: s for s in spans}
    assert by_name["work"]["parent_id"] == by_name["actor-request"]["span_id"]


def test_grafana_dashboard_shape(tmp_path):
    from ray_tpu_torch.dashboard.grafana import generate_dashboard, write_dashboard

    metrics = [
        {"name": "app_requests", "description": "requests", "type": "counter"},
        {"name": "app_depth", "description": "", "type": "gauge"},
        {"name": "app_latency", "description": "latency", "type": "histogram"},
    ]
    dash = generate_dashboard(user_metrics=metrics)
    assert dash["uid"] == "rt-torch-gpu-cluster"
    titles = [p["title"] for p in dash["panels"]]
    assert "Actors by state" in titles
    exprs = [t["expr"] for p in dash["panels"] for t in p["targets"]]
    assert "rate(app_requests[1m])" in exprs
    assert "app_depth" in exprs
    assert any("histogram_quantile(0.99" in e for e in exprs)
    # Every panel is wired to the templated prometheus datasource.
    assert all(
        p["datasource"]["uid"] == "${datasource}" for p in dash["panels"]
    )
    # File output round-trips as JSON.
    import json

    path = write_dashboard(str(tmp_path / "dash.json"), user_metrics=metrics)
    assert json.load(open(path))["panels"]


# ---------------------------------------------------------------------------
# the same cluster state under both packages, every route read
# ---------------------------------------------------------------------------

DRIVER = PRELUDE + r"""
import urllib.error
import urllib.request

worker_mod = importlib.import_module(pkg + "._private.worker")
metrics = importlib.import_module(pkg + ".util.metrics")
pgmod = importlib.import_module(pkg + ".util.placement_group")
Dashboard = importlib.import_module(pkg + ".dashboard").Dashboard
os.environ["RT_EVENT_DIR"] = os.path.join(os.getcwd(), pkg + "_events")


def call(base, path, method="GET", data=None):
    req = urllib.request.Request(
        base + path, method=method, data=data,
        headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return [r.status, r.headers.get("Content-Type"),
                    r.headers.get("Allow"), r.read().decode()]
    except urllib.error.HTTPError as e:
        return [e.code, e.headers.get("Content-Type"),
                e.headers.get("Allow"), e.read().decode()]


rt.init(num_cpus=4)
node = worker_mod._global_node
dash = Dashboard(node.gcs_address, port=0)
base = "http://127.0.0.1:%d" % node.io.run(dash.start())
out = {}
try:
    @rt.remote
    class Pinger:
        def ping(self):
            return "pong"

    @rt.remote
    def square(x):
        return x * x

    @rt.remote
    def size(x):
        return len(x)

    p = Pinger.options(name="pinger").remote()
    assert rt.get(p.ping.remote(), timeout=60) == "pong"
    assert rt.get([square.remote(i) for i in range(3)], timeout=60) == [0, 1, 4]
    ref = rt.put(b"x" * 1000)
    # A task with an object argument goes through the raylet's queue in
    # both packages (direct transport takes only tasks without one), so
    # both export rt_raylet_tasks_dispatched_total; tasks without one may
    # be leased or queued, as the lease pool happens to stand.
    assert rt.get(size.remote(ref), timeout=60) == 1000
    pg = pgmod.placement_group([{"CPU": 1}], strategy="PACK")
    assert pg.ready(timeout=60)
    metrics.Counter("dash_requests", description='reqs "quoted"\nline',
                    tag_keys=("route", "code")).inc(
        2, tags={"route": '/a"b\\c\nd', "code": "200"})
    metrics.Gauge("dash_depth", tag_keys=("q",)).set(3.5, tags={"q": "x"})
    h = metrics.Histogram("dash_latency_s", boundaries=[0.1, 1.0],
                          tag_keys=("op",))
    for v in (0.05, 0.5, 5.0):
        h.observe(v, tags={"op": "get"})

    @serve.deployment(num_replicas=1)
    def echo(x):
        return x

    serve.run(echo.bind(), name="dash_app")
    body = json.dumps({"entrypoint": sys.executable + " -c \"print('dash job ran')\"",
                       "submission_id": "dash_job_1"}).encode()
    out["POST /api/jobs"] = call(base, "/api/jobs", "POST", body)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        info = json.loads(call(base, "/api/jobs/dash_job_1")[3])
        if info["state"] in ("SUCCEEDED", "FAILED", "STOPPED"):
            break
        time.sleep(0.2)
    deadline = time.monotonic() + 30
    while ("dash_latency_s_count" not in call(base, "/metrics")[3]
           or not json.loads(call(base, "/api/serve")[3])):
        assert time.monotonic() < deadline, "metrics or serve never showed"
        time.sleep(0.2)
    # Task events are flushed in batches: wait until every task the
    # comparisons read is listed FINISHED, the Serve actors' calls
    # included. The JAX runtime records no event of a task that ran on
    # a leased worker (ROADMAP §C, R6), so only the port's squares are
    # waited for.
    want = {"ping": 1, "size": 1, "deploy": 1, "health_check": 1,
            "observatory_snapshot": 1}
    if pkg == "ray_tpu_torch":
        want["square"] = 3
    deadline = time.monotonic() + 60
    while True:
        listed = [(t["name"], t["state"])
                  for t in json.loads(call(base, "/api/tasks")[3])]
        missing = {n: k for n, k in want.items()
                   if listed.count((n, "FINISHED")) < k}
        if not missing:
            break
        assert time.monotonic() < deadline, ("tasks never listed", missing)
        time.sleep(0.2)
    deadline = time.monotonic() + 30
    while "rt_raylet_tasks_dispatched_total" not in call(base, "/metrics")[3]:
        assert time.monotonic() < deadline, "no queued dispatch was exported"
        time.sleep(0.2)
    # Idle leases go back: the pinger and the group's bundle hold a CPU
    # each, the Serve controller and its replica 0.1 each.
    deadline = time.monotonic() + 30
    while abs(json.loads(call(base, "/api/cluster_status")[3])[
            "resources_available"].get("CPU", 0.0) - 1.8) > 1e-9:
        assert time.monotonic() < deadline, "leases were not returned"
        time.sleep(0.2)
    for path in ["/", "/healthz", "/metrics", "/api/cluster_status",
                 "/api/nodes", "/api/actors", "/api/tasks", "/api/objects",
                 "/api/placement_groups", "/api/jobs", "/api/events",
                 "/api/stacks", "/api/serve", "/api/jobs/dash_job_1",
                 "/api/jobs/dash_job_1/logs", "/api/jobs/nope",
                 "/api/jobs/nope/logs", "/nope", "/api/nodes/", "/api"]:
        out["GET " + path] = call(base, path)
    for method, path in [("POST", "/api/jobs/nope/stop"), ("POST", "/healthz"),
                         ("PUT", "/api/jobs"), ("GET", "/api/jobs/x/stop"),
                         ("DELETE", "/api/nodes"), ("POST", "/metrics"),
                         ("HEAD", "/healthz"), ("HEAD", "/api/nodes")]:
        data = b"{}" if method in ("POST", "PUT", "DELETE") else None
        out[method + " " + path] = call(base, path, method, data)
    out["POST /api/jobs (bad JSON)"] = call(base, "/api/jobs", "POST", b"{bad")
    out["POST /api/jobs (no entrypoint)"] = call(base, "/api/jobs", "POST", b"{}")
    serve.shutdown()
finally:
    node.io.run(dash.stop())
    rt.shutdown()
print("RESULT " + json.dumps(out))
"""

# Fields that name a process, an id, a port or a time.
_VOLATILE = ("node_id", "actor_id", "task_id", "object_id", "pg_id",
             "worker_id", "pid", "address", "timestamp", "start_time",
             "end_time", "locations")


# Resource quantities are sums and differences of floats, taken in
# another order by each package (the free CPU reads 1.8 in one and
# 1.7999999999999998 in the other): floats compare to 1e-9, rounded to 9
# decimals before the lists they sit in are sorted.
_FLOAT_DECIMALS = 9


def _strip(obj):
    if isinstance(obj, dict):
        return {k: ("*" if k in _VOLATILE else
                    sorted(obj[k]) if k == "proc_stats" else _strip(obj[k]))
                for k in obj}
    if isinstance(obj, list):
        return sorted((_strip(x) for x in obj), key=json.dumps)
    if isinstance(obj, float):
        return round(obj, _FLOAT_DECIMALS)
    return obj


@pytest.fixture(scope="module")
def answers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dashboard")
    return (run_driver(tmp, DRIVER, "ray_tpu", timeout=300),
            run_driver(tmp, DRIVER, "ray_tpu_torch", timeout=300))


_JSON_ROUTES = ["GET /api/cluster_status", "GET /api/nodes",
                "GET /api/actors", "GET /api/objects",
                "GET /api/placement_groups", "GET /api/jobs",
                "GET /api/events", "GET /api/serve",
                "GET /api/jobs/dash_job_1", "POST /api/jobs",
                "POST /api/jobs/nope/stop"]
_TEXT_ROUTES = ["GET /healthz", "GET /api/jobs/dash_job_1/logs",
                "GET /api/jobs/nope", "GET /api/jobs/nope/logs", "GET /nope",
                "GET /api/nodes/", "GET /api", "POST /healthz",
                "PUT /api/jobs", "GET /api/jobs/x/stop", "DELETE /api/nodes",
                "POST /metrics", "HEAD /healthz", "HEAD /api/nodes",
                "POST /api/jobs (bad JSON)", "POST /api/jobs (no entrypoint)"]


@pytest.mark.parametrize("route", _JSON_ROUTES)
def test_a_json_route_answers_as_the_jax_dashboard(answers, route):
    ref, out = answers
    assert out[route][:3] == ref[route][:3]
    assert out[route][1] == "application/json; charset=utf-8"
    assert _strip(json.loads(out[route][3])) == \
        _strip(json.loads(ref[route][3]))


@pytest.mark.parametrize("route", _TEXT_ROUTES)
def test_a_text_or_error_answer_equals_the_jax_dashboards(answers, route):
    ref, out = answers
    assert out[route] == ref[route]


def test_the_page_and_the_task_list(answers):
    """The page differs only in its title. In the task list, the driver's
    own tasks are `ping` on an actor, three `square` tasks and one
    `size` task (queued in both packages: it takes an object). The JAX
    runtime lists no event of a task that ran on a leased worker
    (ROADMAP §C, R6), so its list holds fewer than three `square` tasks
    and the port's all three. The Serve actors' periodic calls (health
    checks, snapshots) come and go with time, so their names are
    compared; the driver reads the routes once each package lists them."""
    ref, out = answers
    assert out["GET /"][:3] == ref["GET /"][:3] == \
        [200, "text/html; charset=utf-8", None]
    assert out["GET /"][3].replace("ray_tpu_torch", "ray_tpu") == \
        ref["GET /"][3]
    assert out["GET /api/tasks"][:3] == ref["GET /api/tasks"][:3]
    got = _strip(json.loads(out["GET /api/tasks"][3]))
    want = _strip(json.loads(ref["GET /api/tasks"][3]))
    ping = {"task_id": "*", "name": "ping", "type": "ACTOR_TASK",
            "state": "FINISHED"}
    square = {"task_id": "*", "name": "square", "type": "NORMAL_TASK",
              "state": "FINISHED"}
    assert [t for t in got if t["name"] in ("ping", "square")] == \
        [ping] + [square] * 3
    assert [t for t in want if t["name"] == "ping"] == [ping]
    assert len([t for t in want if t["name"] == "square"]) < 3
    assert {t["name"] for t in got} - {"square"} == \
        {t["name"] for t in want} - {"square"}


def test_the_stacks_route_has_the_jax_dashboards_shape(answers):
    ref, out = answers

    def shape(text):
        return [(sorted(n), sorted({tuple(sorted(w)) for w in n["workers"]}),
                 sum(bool(w["actor"]) for w in n["workers"]))
                for n in json.loads(text)]

    assert out["GET /api/stacks"][:3] == ref["GET /api/stacks"][:3]
    assert shape(out["GET /api/stacks"][3]) == shape(ref["GET /api/stacks"][3])


def _exposition(text):
    """{(metric name, label names)} of a Prometheus exposition."""
    series = set()
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = re.match(r"^([a-zA-Z_:][\w:]*)(\{.*\})? (\S+)$", line)
        assert m, line
        series.add((m.group(1),
                    tuple(sorted(re.findall(r'(\w+)="', m.group(2) or "")))))
    return series


def test_the_exposition_names_and_labels_equal_the_jax_dashboards(answers):
    ref, out = answers
    assert out["GET /metrics"][:3] == ref["GET /metrics"][:3] == \
        [200, "text/plain; charset=utf-8", None]
    assert _exposition(out["GET /metrics"][3]) == \
        _exposition(ref["GET /metrics"][3])

    def user(text):
        return [ln for ln in text.splitlines() if "dash_" in ln]

    assert user(out["GET /metrics"][3]) == user(ref["GET /metrics"][3])
    assert 'dash_requests{code="200",route="/a\\"b\\\\c\\nd"} 2.0' in \
        user(out["GET /metrics"][3])


def test_the_grafana_board_equals_the_jax_one_but_for_title_and_uid():
    from ray_tpu.dashboard.grafana import generate_dashboard as jax_board
    from ray_tpu_torch.dashboard.grafana import generate_dashboard

    metrics = [
        {"name": "loadgen_requests_total", "description": "", "type": "counter"},
        {"name": "serve_llm_step_host_ms", "description": "host",
         "type": "histogram"},
        {"name": "app_requests", "description": "requests", "type": "counter"},
        {"name": "app_depth", "description": "", "type": "gauge"},
        {"name": "app_latency", "description": "latency", "type": "histogram"},
    ]
    for kw in ({"user_metrics": metrics}, {"user_metrics": []},
               {"user_metrics": metrics, "title": "mine"}):
        out, ref = generate_dashboard(**kw), jax_board(**kw)
        assert (out.pop("uid"), ref.pop("uid")) == ("rt-torch-gpu-cluster",
                                                    "rt-tpu-cluster")
        if "title" not in kw:
            assert (out.pop("title"), ref.pop("title")) == \
                ("ray_tpu_torch GPU cluster", "ray_tpu cluster")
        assert out == ref
