"""The port's Serve API held against the JAX package's.

One driver script runs in a subprocess under each package (`ray_tpu` and
`ray_tpu_torch`) through the same public API, the scenarios of
tests/test_serve.py: function and class deployments, two replicas both
used, composition through handles and nested `.bind()` (in containers
too), duplicate names made unique, a shared application deployed once,
status and delete, redeploy with another function, with array arguments
and with nothing changed, and the error for a buried application. Each
side prints one `RESULT` line; the two must be equal.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

PRELUDE = r'''
import importlib, json, os, sys, time

pkg = sys.argv[1]
if pkg == "ray_tpu":
    # The JAX runtime's workers and this driver stay on the CPU, as
    # tests/conftest.py arranges: the env alone can come too late.
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["RT_TPU_CHIPS"] = "0"
    import jax
    jax.config.update("jax_platforms", "cpu")
else:
    os.environ["RT_NUM_GPUS"] = "0"
import numpy as np

rt = importlib.import_module(pkg)
serve = importlib.import_module(pkg + ".serve")
exc = importlib.import_module(pkg + ".exceptions")
'''

DRIVER = PRELUDE + r'''

def scenarios():
    out = {}

    @serve.deployment
    def echo(x):
        return {"echo": x}

    h = serve.run(echo.bind())
    out["function"] = rt.get(h.remote("hi"), timeout=60)

    @serve.deployment
    class Greeter:
        def __init__(self, greeting):
            self.greeting = greeting
            self.count = 0

        def __call__(self, name):
            self.count += 1
            return f"{self.greeting}, {name}!"

        def stats(self):
            return self.count

    h = serve.run(Greeter.bind("Hello"))
    out["class"] = [h.remote("GPU").result(timeout=60),
                    h.remote("TPU").result(timeout=60),
                    h.options(method_name="stats").remote().result(timeout=60)]

    @serve.deployment(num_replicas=2)
    class Worker:
        def __init__(self):
            self.pid = os.getpid()

        def __call__(self):
            return self.pid

    h = serve.run(Worker.bind(), name="workers")
    pids = {h.remote().result(timeout=60) for _ in range(24)}
    out["two_replicas_used"] = len(pids)

    @serve.deployment
    class Preprocess:
        def __call__(self, x):
            return x * 2

    @serve.deployment
    class Pipeline:
        def __init__(self, pre_app_name):
            self.pre = serve.get_app_handle(pre_app_name)

        def __call__(self, x):
            return self.pre.remote(x).result(timeout=30) + 1

    serve.run(Preprocess.bind(), name="pre")
    out["composition_by_name"] = serve.run(
        Pipeline.bind("pre"), name="pipe").remote(5).result(timeout=60)

    @serve.deployment
    class Embed:
        def __call__(self, x):
            return x * 10

    @serve.deployment
    class Rank:
        def __call__(self, x):
            return x + 1

    @serve.deployment
    class Chain:
        def __init__(self, embed, rank):
            self.embed, self.rank = embed, rank

        def __call__(self, x):
            e = self.embed.remote(x).result(timeout=30)
            return self.rank.remote(e).result(timeout=30)

    h = serve.run(Chain.bind(Embed.bind(), Rank.bind()), name="chain")
    out["nested_bind"] = h.remote(4).result(timeout=60)

    @serve.deployment
    class Scale:
        def __init__(self, w):
            self.w = w

        def __call__(self, x):
            return x * self.w

    @serve.deployment
    class Ensemble:
        def __init__(self, models, extra):
            self.models, self.extra = models, extra

        def __call__(self, x):
            return ([m.remote(x).result(timeout=30) for m in self.models]
                    + [self.extra["m"].remote(x).result(timeout=30)])

    h = serve.run(Ensemble.bind([Scale.bind(3), Scale.bind(5)],
                                {"m": Scale.bind(7)}), name="ens")
    out["containers_and_unique_names"] = h.remote(2).result(timeout=60)

    @serve.deployment
    class Counter:
        def __init__(self):
            self.n = 0

        def __call__(self):
            self.n += 1
            return self.n

    @serve.deployment
    class Pair:
        def __init__(self, models):
            self.models = models

        def __call__(self):
            return [m.remote().result(timeout=30) for m in self.models]

    shared = Counter.bind()
    out["shared_app"] = serve.run(Pair.bind([shared, shared]),
                                  name="pair").remote().result(timeout=60)

    out["status"] = serve.status()
    serve.delete("workers")
    out["status_after_delete"] = sorted(serve.status())

    @serve.deployment
    def v1():
        return "v1"

    @serve.deployment
    def v2():
        return "v2"

    h = serve.run(v1.bind(), name="app")
    first = h.remote().result(timeout=60)
    h = serve.run(v2.bind(), name="app")
    out["redeploy"] = [first, h.remote().result(timeout=60)]

    @serve.deployment
    class Weighted:
        def __init__(self, w):
            self.w = w

        def __call__(self, x):
            return float((self.w * x).sum())

    serve.run(Weighted.bind(np.ones(4)), name="warr")
    h = serve.run(Weighted.bind(np.ones(4) * 2), name="warr")
    out["redeploy_array_args"] = h.remote(3).result(timeout=60)

    @serve.deployment
    class P:
        def __init__(self):
            self.pid = os.getpid()

        def __call__(self):
            return self.pid

    pid1 = serve.run(P.bind(), name="noop").remote().result(timeout=60)
    pid2 = serve.run(P.bind(), name="noop").remote().result(timeout=60)
    out["noop_redeploy_same_replica"] = pid1 == pid2

    @serve.deployment
    class Inner:
        def __call__(self, x):
            return x

    class Holder:
        def __init__(self, app):
            self.app = app

    @serve.deployment
    class Outer:
        def __init__(self, holder):
            self.holder = holder

    try:
        serve.run(Outer.bind(Holder(Inner.bind())), name="buried")
        out["buried"] = "deployed"
    except ValueError as e:
        out["buried"] = [type(e).__name__, "Application" in str(e),
                         "buried" in str(e)]
    out["final_status"] = serve.status()
    return out


rt.init(num_cpus=4)
try:
    out = scenarios()
finally:
    serve.shutdown()
    rt.shutdown()
print("RESULT " + json.dumps(out, sort_keys=True))
'''


def run_driver(tmp_path, source, pkg, *args, timeout=240):
    """Run a driver script under `pkg`; return its RESULT object."""
    script = tmp_path / f"driver_{pkg}.py"
    script.write_text(source)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in [str(ROOT), str(tmp_path), env.get("PYTHONPATH", "")] if p)
    proc = subprocess.run([sys.executable, str(script), pkg, *args],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    assert line, proc.stdout[-4000:] + proc.stderr[-4000:]
    return json.loads(line[-1][len("RESULT "):])


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_api")
    return (run_driver(tmp, DRIVER, "ray_tpu"),
            run_driver(tmp, DRIVER, "ray_tpu_torch"))


SCENARIOS = ["function", "class", "two_replicas_used", "composition_by_name",
             "nested_bind", "containers_and_unique_names", "shared_app",
             "status", "status_after_delete", "redeploy",
             "redeploy_array_args", "noop_redeploy_same_replica", "buried",
             "final_status"]


@pytest.mark.parametrize("key", SCENARIOS)
def test_serve_scenario_matches_the_jax_package(results, key):
    ref, out = results
    assert set(out) == set(ref) == set(SCENARIOS)
    assert out[key] == ref[key]


def test_serve_scenarios_give_the_expected_values(results):
    _, out = results
    assert out["function"] == {"echo": "hi"}
    assert out["class"] == ["Hello, GPU!", "Hello, TPU!", 2]
    assert out["two_replicas_used"] == 2
    assert out["composition_by_name"] == 11
    assert out["nested_bind"] == 41
    assert out["containers_and_unique_names"] == [6, 10, 14]
    assert out["shared_app"] == [1, 2]
    assert {"Scale", "Scale_1", "Scale_2"} <= set(out["status"])
    assert "Counter_1" not in out["status"]
    assert "workers" not in out["status_after_delete"]
    assert out["redeploy"] == ["v1", "v2"]
    assert out["redeploy_array_args"] == 24.0
    assert out["noop_redeploy_same_replica"] is True
    assert out["buried"] == ["ValueError", True, True]
