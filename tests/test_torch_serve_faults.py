"""The port's Serve survival plane and HTTP ingress held against the JAX
package's.

The scenarios of tests/test_serve_fault_tolerance.py, run by one driver
script under each package (the harness of test_torch_serve_api.py): the
handle's synchronous typed shed, a deadline bounding `.result()`, a
stream resumed at its offset after its replica was killed, unary
requests redispatched around `chaos.kill_replica`, a drain that finishes
in-flight work and then refuses, and traffic that survives
`chaos.drop_controller` until the restarted controller has restored its
checkpoint. Each fault is recorded once it has settled (the restored
controller serving a fresh handle), never at its first symptom.

Then the same HTTP requests go to each package's proxy: the JAX
package's is built on aiohttp, the port's on the standard library. The
status codes, `Retry-After`, content types and JSON bodies (error texts
cut to their exception class, since tracebacks name each package's
files), the SSE events of a stream and of a failed stream, the health
route, and the 404 and 405 answers must be equal.
"""

import pytest

from test_torch_serve_api import PRELUDE, run_driver

DRIVER = PRELUDE + r'''
import http.client
import signal
import urllib.error
import urllib.request

chaos = importlib.import_module(pkg + "._private.chaos")
get_config = importlib.import_module(pkg + "._private.config").get_config


def scenarios():
    out = {}
    cfg = get_config()

    @serve.deployment(max_ongoing_requests=1)
    class Slow:
        def __call__(self, s):
            time.sleep(s)
            return s

    saved = cfg.serve_max_queued_per_replica
    cfg.serve_max_queued_per_replica = 1
    try:
        h = serve.run(Slow.bind())
        admitted = [h.remote(1.0), h.remote(1.0)]
        t0 = time.perf_counter()
        try:
            h.remote(1.0)
            shed = None
        except exc.ServeOverloadedError as e:
            shed = [type(e).__name__, e.retry_after_s > 0,
                    time.perf_counter() - t0 < 0.05]
        out["handle_shed"] = [shed, [r.result(timeout=60) for r in admitted]]
    finally:
        cfg.serve_max_queued_per_replica = saved

    @serve.deployment
    def napper(s=0.0):
        time.sleep(s)
        return s

    h = serve.run(napper.bind())
    warm = h.remote(0.01).result(timeout=60)
    r = h.options(deadline_s=0.3).remote(10.0)
    t0 = time.monotonic()
    try:
        r.result()
        out["deadline"] = None
    except exc.RequestCancelledError as e:
        out["deadline"] = [warm, type(e).__name__, e.reason,
                           time.monotonic() - t0 < 5.0]

    @serve.deployment(num_replicas=2)
    class Gen:
        def __call__(self, n):
            yield os.getpid()
            for i in range(n):
                time.sleep(0.05)
                yield i

    h = serve.run(Gen.bind())
    it = iter(h.options(stream=True).remote(12))
    pid = next(it)
    got = [next(it) for _ in range(3)]
    os.kill(pid, signal.SIGKILL)
    got.extend(it)
    out["stream_resume"] = got
    serve.delete("Gen")

    chaos.enable()
    try:
        @serve.deployment(num_replicas=2)
        class Echo:
            def __call__(self, x):
                time.sleep(0.4)
                return x * 2

        h = serve.run(Echo.bind())
        rs = [h.remote(i) for i in range(6)]
        time.sleep(0.15)
        chaos.kill_replica("Echo", 0)
        out["kill_replica_redispatch"] = sorted(
            r.result(timeout=90) for r in rs)
        serve.delete("Echo")

        @serve.deployment
        def inc(x):
            return x + 1

        h = serve.run(inc.bind())
        first = h.remote(1).result(timeout=60)
        chaos.drop_controller(restart=True)
        during = [h.remote(i).result(timeout=60) for i in range(5)]
        deadline = time.time() + 60
        restored = False
        while not restored and time.time() < deadline:
            try:
                restored = "inc" in serve.status()
            except Exception:  # noqa: BLE001 — the restart settling
                time.sleep(0.2)
        fresh = serve.get_app_handle("inc").remote(7).result(timeout=60)
        out["controller_death"] = [first, during, restored, fresh]
    finally:
        chaos.disable()

    ReplicaActor = importlib.import_module(
        pkg + ".serve.replica").ReplicaActor

    def nap(s):
        time.sleep(s)
        return s

    rep = ReplicaActor.options(max_concurrency=4).remote(nap, (), {})
    ref = rep.handle_request.remote("__call__", (0.8,), {})
    time.sleep(0.2)
    d = rt.get(rep.drain.remote(10.0), timeout=30)
    inflight = rt.get(ref, timeout=10)
    try:
        rt.get(rep.handle_request.remote("__call__", (0.1,), {}), timeout=10)
        refused = None
    except exc.TaskError as e:
        refused = e.cause_cls_name
    rt.kill(rep)
    out["drain"] = [d["drained"], d["remaining"], d["duration_s"] >= 0.3,
                    inflight, refused]
    return out


def http_scenarios():
    @serve.deployment
    def overloaded():
        raise exc.ServeOverloadedError("busy", retry_after_s=3.0)

    @serve.deployment
    def napper(s=0.0):
        time.sleep(s)
        return s

    @serve.deployment
    def toolong():
        raise exc.PromptTooLongError("too long", prompt_len=9,
                                     max_prompt_len=4)

    @serve.deployment
    def broken(x=0):
        raise KeyError("nope")

    @serve.deployment
    def adder(a, b):
        return {"sum": a + b, "list": [a, b]}

    @serve.deployment
    class Tokens:
        def __call__(self, n=3, fail=False):
            for i in range(n):
                yield {"i": i}
            if fail:
                raise RuntimeError("stream broke")

    for app in (overloaded, napper, toolong, broken, adder, Tokens):
        serve.run(app.bind())
    addr = serve.start_http_proxy(port=0)
    host, port = addr[len("http://"):].rsplit(":", 1)

    def post(path, body, headers=None):
        req = urllib.request.Request(
            f"{addr}{path}", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json", **(headers or {})})
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                code, hdrs, raw = r.status, r.headers, r.read()
        except urllib.error.HTTPError as e:
            code, hdrs, raw = e.code, e.headers, e.read()
        ctype = hdrs.get("Content-Type", "")
        if ctype.startswith("text/event-stream"):
            events, kind = [], "data"
            for line in raw.decode().splitlines():
                if line.startswith("event: "):
                    kind = line[len("event: "):]
                elif line.startswith("data: "):
                    data = json.loads(line[len("data: "):])
                    if "error" in data:
                        data["error"] = data["error"].split(":")[0]
                    events.append([kind, data])
                    kind = "data"
            body = events
        else:
            body = json.loads(raw)
            if isinstance(body, dict) and "error" in body:
                body["error"] = body["error"].split(":")[0]
        return [code, hdrs.get("Retry-After"), ctype, body]

    def raw(method, path):
        conn = http.client.HTTPConnection(host, int(port), timeout=30)
        try:
            conn.request(method, path)
            r = conn.getresponse()
            body = r.read()
            return [r.status, r.getheader("Content-Type"),
                    json.loads(body) if r.status == 200 else body.decode()]
        finally:
            conn.close()

    return {
        "ok": post("/adder", {"a": 2, "b": 3}),
        "shed": post("/overloaded", {}),
        "deadline": post("/napper", {"s": 5.0}, {"serve_deadline_ms": "200"}),
        "in_time": post("/napper", {"s": 0.0}, {"serve_deadline_ms": "5000"}),
        "prompt_too_long": post("/toolong", {}),
        "error": post("/broken", {"x": 1}),
        "missing_app": post("/no_such_app", {})[:2],
        "sse": post("/Tokens?stream=1", {"n": 3}),
        "sse_accept": post("/Tokens", {"n": 2},
                           {"Accept": "text/event-stream"}),
        "sse_error": post("/Tokens?stream=1", {"n": 2, "fail": True}),
        "healthz": raw("GET", "/-/healthz"),
        "not_found": raw("GET", "/a/b")[0],
        "wrong_method": raw("GET", "/adder")[0],
        "post_health": raw("POST", "/-/healthz")[0],
    }


mode = sys.argv[2]
rt.init(num_cpus=4)
try:
    out = {"scenarios": scenarios, "http": http_scenarios}[mode]()
finally:
    serve.shutdown()
    rt.shutdown()
print("RESULT " + json.dumps(out, sort_keys=True))
'''

SCENARIOS = ["handle_shed", "deadline", "stream_resume",
             "kill_replica_redispatch", "controller_death", "drain"]
HTTP = ["ok", "shed", "deadline", "in_time", "prompt_too_long", "error",
        "missing_app", "sse", "sse_accept", "sse_error", "healthz",
        "not_found", "wrong_method", "post_health"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_faults")
    return {mode: (run_driver(tmp, DRIVER, "ray_tpu", mode),
                   run_driver(tmp, DRIVER, "ray_tpu_torch", mode))
            for mode in ("scenarios", "http")}


@pytest.mark.parametrize("key", SCENARIOS)
def test_fault_scenario_matches_the_jax_package(results, key):
    ref, out = results["scenarios"]
    assert set(out) == set(ref) == set(SCENARIOS)
    assert out[key] == ref[key]


@pytest.mark.parametrize("key", HTTP)
def test_http_answer_matches_the_aiohttp_proxy(results, key):
    ref, out = results["http"]
    assert set(out) == set(ref) == set(HTTP)
    assert out[key] == ref[key]


def test_fault_scenarios_give_the_expected_values(results):
    _, out = results["scenarios"]
    assert out["handle_shed"] == [["ServeOverloadedError", True, True],
                                  [1.0, 1.0]]
    assert out["deadline"] == [0.01, "RequestCancelledError", "deadline",
                               True]
    assert out["stream_resume"] == list(range(12))
    assert out["kill_replica_redispatch"] == [0, 2, 4, 6, 8, 10]
    assert out["controller_death"] == [2, [1, 2, 3, 4, 5], True, 8]
    assert out["drain"] == [True, 0, True, 0.8, "ReplicaDrainingError"]


def test_http_answers_give_the_expected_values(results):
    _, out = results["http"]
    assert out["ok"][0] == 200 and out["ok"][3] == {
        "result": {"sum": 5, "list": [2, 3]}}
    assert out["shed"][:2] == [429, "3"]
    assert out["shed"][3]["kind"] == "shed"
    assert out["deadline"][0] == 504 and out["deadline"][3]["kind"] == "deadline"
    assert out["in_time"][0] == 200
    assert out["prompt_too_long"][:2] == [413, None]
    assert out["error"][0] == 500
    assert out["sse"][0] == 200 and out["sse"][3] == [
        ["data", {"i": i}] for i in range(3)]
    assert out["sse_error"][3][-1][0] == "error"
    assert out["healthz"] == [200, "application/json; charset=utf-8",
                              {"status": "ok"}]
    assert (out["not_found"], out["wrong_method"], out["post_health"]) == (
        404, 405, 405)
