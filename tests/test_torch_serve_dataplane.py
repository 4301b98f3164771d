"""The port's Serve data plane held against the JAX package's.

The scenarios of tests/test_serve_dataplane.py, run by one driver script
under each package (the harness of test_torch_serve_api.py): batching
results, a batch's error reaching every caller, streaming in order and a
stream's error, the multiplexed model LRU, `run_from_config` importing
the user's module, route push invalidation, a dead replica replaced, a
request redispatched after its replica died, a `user_config` redeploy
reconfiguring in place, the per-node proxy with its HTTP and binary
ingress (on one node here; on two, in tests/test_torch_cluster.py), and `serve.call` from the driver and from a plain task. Faults
are recorded once they have settled: the replacement replica serving,
not the first failed call. Batch sizes depend on timing, so only the
results and the batch total are compared.
"""

import pytest

from test_torch_serve_api import PRELUDE, run_driver

DRIVER = PRELUDE + r'''
import signal
import threading


def scenarios():
    out = {}

    @serve.deployment(max_ongoing_requests=16)
    class Model:
        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.2)
        def predict(self, items):
            return [x * 2 for x in items]

        def __call__(self, x):
            return self.predict(x)

    h = serve.run(Model.bind())
    results = [None] * 16

    def call(i):
        results[i] = h.remote(i).result(timeout=60)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(90)
    h._refresh(force=True)
    sizes = rt.get(h._shared["replicas"][0].stats.remote(),
                   timeout=30)["batch_sizes"]["predict"]
    out["batch"] = {"results": results, "total": sum(sizes),
                    "coalesced": max(sizes) > 1}

    @serve.deployment(max_ongoing_requests=8)
    class Bad:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.1)
        def predict(self, items):
            raise ValueError("batch exploded")

        def __call__(self, x):
            return self.predict(x)

    h = serve.run(Bad.bind())
    try:
        h.remote(1).result(timeout=60)
        out["batch_error"] = None
    except exc.TaskError as e:
        out["batch_error"] = [type(e).__name__, e.cause_cls_name,
                              "batch exploded" in str(e)]

    @serve.deployment
    class Streamer:
        def __call__(self, n):
            for i in range(n):
                time.sleep(0.02)
                yield {"token": i}

    h = serve.run(Streamer.bind())
    out["stream"] = list(h.options(stream=True).remote(5))

    @serve.deployment
    class BadStream:
        def __call__(self):
            yield 1
            raise RuntimeError("mid-stream failure")

    h = serve.run(BadStream.bind())
    it = h.options(stream=True).remote()
    first = next(it)
    try:
        list(it)
        out["stream_error"] = [first, None]
    except RuntimeError as e:
        out["stream_error"] = [first, type(e).__name__,
                               "mid-stream failure" in str(e)]

    @serve.deployment
    class MultiModel:
        def __init__(self):
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id):
            self.loads.append(model_id)
            return {"id": model_id}

        def __call__(self):
            mid = serve.get_multiplexed_model_id()
            return {"served_by": self.get_model(mid)["id"],
                    "loads": list(self.loads)}

    h = serve.run(MultiModel.bind())
    seq = []
    for mid in ("a", "b", "a", "b", "c", "a"):
        seq.append(h.options(multiplexed_model_id=mid).remote()
                   .result(timeout=60))
    out["multiplex"] = seq

    mod = f"serve_cfg_app_{pkg}"
    with open(f"{mod}.py", "w") as f:
        f.write(
            f"from {pkg} import serve\n"
            "@serve.deployment\n"
            "class Echo:\n"
            "    def __init__(self, prefix='x'):\n"
            "        self.prefix = prefix\n"
            "    def __call__(self, v):\n"
            "        return f'{self.prefix}:{v}'\n"
            "app = Echo.bind(prefix='cfg')\n")
    sys.path.insert(0, os.getcwd())
    handles = serve.run_from_config({"applications": [{
        "name": "echo", "import_path": f"{mod}:app",
        "deployments": [{"name": "Echo", "num_replicas": 2}]}]})
    out["run_from_config"] = [handles["echo"].remote("hi").result(timeout=60),
                              serve.status()["echo"],
                              mod in sys.modules]

    @serve.deployment(num_replicas=1)
    class App:
        def __call__(self):
            return "ok"

    h = serve.run(App.bind(), name="pushy")
    h.remote().result(timeout=60)
    s = h._shared
    with s["lock"]:
        s["last_refresh"] = time.monotonic() + 10_000
        v0 = s["version"]
    serve.run(App.options(num_replicas=3).bind(), name="pushy")
    pushed = False
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and not pushed:
        h.remote().result(timeout=60)
        with s["lock"]:
            pushed = s["version"] > v0 and len(s["replicas"]) == 3
        time.sleep(0.2)
    out["route_push"] = pushed
    serve.delete("pushy")

    @serve.deployment(num_replicas=2)
    class Pid:
        def __call__(self):
            return os.getpid()

    h = serve.run(Pid.bind(), name="healme")
    pids = {h.remote().result(timeout=60) for _ in range(16)}
    victim = min(pids)
    os.kill(victim, signal.SIGKILL)
    alive = set()
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and len(alive) < 2:
        try:
            alive.add(h.remote().result(timeout=30))
        except Exception:  # noqa: BLE001 — the death settling
            time.sleep(0.2)
        alive.discard(victim)
    out["dead_replica_replaced"] = [len(pids), len(alive)]

    h = serve.run(Pid.bind(), name="redispatch")
    pids = {h.remote().result(timeout=60) for _ in range(16)}
    victim = min(pids)
    os.kill(victim, signal.SIGKILL)
    got = [r.result(timeout=120) for r in [h.remote() for _ in range(8)]]
    out["redispatch"] = [len(got), victim in got]
    serve.delete("healme")
    serve.delete("redispatch")

    @serve.deployment(num_replicas=2, user_config={"factor": 2})
    class Scaler:
        def __init__(self):
            self.factor = 1
            self.pid = os.getpid()

        def reconfigure(self, cfg):
            self.factor = cfg["factor"]

        def __call__(self, x):
            return {"y": x * self.factor, "pid": self.pid}

    def replica_ids(app):
        info = rt.get(serve.get_or_create_controller().get_replicas
                      .remote(app), timeout=30)
        return sorted(r._actor_id.hex() for r in info["replicas"])

    h = serve.run(Scaler.bind(), name="scaler")
    before = [h.remote(5).result(timeout=60) for _ in range(6)]
    ids_before = replica_ids("scaler")
    serve.run(Scaler.options(user_config={"factor": 7}).bind(), name="scaler")
    after = []
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        after = [h.remote(5).result(timeout=60) for _ in range(6)]
        if all(o["y"] == 35 for o in after):
            break
    in_place = replica_ids("scaler") == ids_before
    serve.run(Scaler.options(num_replicas=1, user_config={"factor": 7})
              .bind(), name="scaler")
    out["user_config"] = [sorted({o["y"] for o in before}),
                          sorted({o["y"] for o in after}), in_place,
                          len(replica_ids("scaler")),
                          h.remote(3).result(timeout=60)["y"]]
    serve.delete("scaler")

    @serve.deployment(num_replicas=2)
    def double(x=0):
        return x * 2

    serve.run(double.bind(), name="dbl")
    addrs = serve.start(proxy_location="EveryNode")
    import asyncio
    import urllib.request

    http = []
    for entry in addrs.values():
        req = urllib.request.Request(
            entry["http"] + "/dbl", data=json.dumps({"x": 21}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            http.append(json.loads(resp.read()))
    proto = importlib.import_module(pkg + "._private.protocol")
    host, port = next(iter(addrs.values()))["binary"]

    async def frame():
        conn = await proto.connect(host, port)
        try:
            return [await conn.call("serve_call", {"app": "dbl",
                                                   "kwargs": {"x": 10}},
                                    timeout=30),
                    await conn.call("serve_call", {"app": "nope"},
                                    timeout=30)]
        finally:
            await conn.close()

    loop = asyncio.new_event_loop()
    try:
        binary = loop.run_until_complete(frame())
    finally:
        loop.close()
    binary[1] = {k: binary[1][k] for k in ("status", "kind")}
    out["proxy_every_node"] = [len(addrs), http, binary]

    @serve.deployment
    class Echo2:
        def __call__(self, payload):
            return {"echo": payload, "pid": os.getpid()}

        def shout(self, payload):
            return str(payload).upper()

    serve.run(Echo2.bind(), name="xlang")
    client = rt._worker.get_client()
    spec = {"task_id": os.urandom(16), "job_id": client.job_id.binary(),
            "name": f"{pkg}.serve:call", "fn_name": f"{pkg}.serve:call",
            "plain_args": ["xlang", "from-cpp"], "deps": [],
            "num_returns": 1, "resources": {"CPU": 1.0}, "retriable": False}
    res = client._run(client.raylet.call("submit_task", spec, timeout=120))
    ser = importlib.import_module(pkg + "._private.serialization")
    task_value = ser.deserialize_from_bytes(res["returns"][0]["data"])
    direct = serve.call("xlang", "hello")
    out["serve_call"] = [direct["echo"], direct["pid"] != os.getpid(),
                         serve.call("xlang", "hey", method="shout"),
                         res["status"], task_value["echo"]]
    return out


rt.init(num_cpus=4)
try:
    out = scenarios()
finally:
    serve.shutdown()
    rt.shutdown()
print("RESULT " + json.dumps(out, sort_keys=True))
'''

SCENARIOS = ["batch", "batch_error", "stream", "stream_error", "multiplex",
             "run_from_config", "route_push", "dead_replica_replaced",
             "redispatch", "user_config", "proxy_every_node", "serve_call"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_dataplane")
    return (run_driver(tmp, DRIVER, "ray_tpu"),
            run_driver(tmp, DRIVER, "ray_tpu_torch"))


@pytest.mark.parametrize("key", SCENARIOS)
def test_dataplane_scenario_matches_the_jax_package(results, key):
    ref, out = results
    assert set(out) == set(ref) == set(SCENARIOS)
    assert out[key] == ref[key]


def test_dataplane_scenarios_give_the_expected_values(results):
    _, out = results
    assert out["batch"] == {"results": [2 * i for i in range(16)],
                            "total": 16, "coalesced": True}
    assert out["batch_error"] == ["TaskError", "ValueError", True]
    assert out["stream"] == [{"token": i} for i in range(5)]
    assert out["stream_error"] == [1, "RuntimeError", True]
    loads = out["multiplex"][-1]["loads"]
    assert loads == ["a", "b", "c", "a"]  # a evicted by c, then reloaded
    assert out["run_from_config"][0] == "cfg:hi"
    assert out["run_from_config"][1]["target_replicas"] == 2
    assert out["run_from_config"][2] is True  # the user's module
    assert out["route_push"] is True
    assert out["dead_replica_replaced"] == [2, 2]
    assert out["redispatch"] == [8, False]
    assert out["user_config"] == [[10], [35], True, 1, 21]
    assert out["proxy_every_node"] == [
        1, [{"result": 42}], [{"result": 20},
                              {"status": 500, "kind": "error"}]]
    assert out["serve_call"] == ["hello", True, "HEY", "ok", "from-cpp"]
