"""The port's runtime core held against the JAX package's.

One driver script, written to a file (cloudpickle ships `__main__`
classes by value, which needs a real source file), runs in a subprocess
under each package (`ray_tpu` and `ray_tpu_torch`) through the same
public API: tasks with numpy arguments made from a seed, actor state over
a call sequence, put/get of arrays, error classes through get, wait as a
set, named actors and cluster_resources with a custom resource. The two
JSON outputs must be equal.

The second case runs the whole slice on the CPU at the tiny config: an
actor of each runtime serves greedy requests through its package's
`LLMReplica` on the same weights (the JAX tree, converted for the port
by `models/convert.py` `params_from_jax`), in f32. Their tokens must be
identical.

Run as a script, it prints the CPU host's no-op task and actor-method
round trips of both runtimes (median of 200 each):

    PYTHONPATH=. python tests/test_torch_runtime_parity.py
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

DRIVER = r'''
import importlib, json, os, sys, time

pkg, mode = sys.argv[1], sys.argv[2]
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
exc = importlib.import_module(pkg + ".exceptions")


def api():
    out = {}
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((64, 32)) for _ in range(4)]

    @rt.remote
    def gram(a, b):
        g = a @ b.T
        return {"sum": round(float(g.sum()), 9), "shape": list(g.shape),
                "max": round(float(g.max()), 9)}

    out["tasks"] = rt.get([gram.remote(xs[i], xs[i + 1]) for i in range(3)])

    @rt.remote
    class Acc:
        def __init__(self, start):
            self.v = start
            self.log = []

        def add(self, x):
            self.v += x
            self.log.append(x)
            return self.v

        def state(self):
            return {"v": self.v, "log": self.log}

    a = Acc.remote(10)
    out["actor_calls"] = rt.get([a.add.remote(i) for i in range(5)])
    out["actor_state"] = rt.get(a.state.remote())

    big = rng.integers(0, 1 << 30, size=(1 << 20,), dtype=np.int64)
    got = rt.get(rt.put(big))
    out["put_get_big"] = {"equal": bool(np.array_equal(got, big)),
                          "zero_copy": not got.flags.owndata,
                          "dtype": str(got.dtype), "sum": int(got.sum())}
    small = rt.get(rt.put({"x": xs[0], "tag": "s"}))
    out["put_get_small"] = [bool(np.array_equal(small["x"], xs[0])),
                            small["tag"]]

    @rt.remote
    def boom():
        raise ValueError("boom")

    try:
        rt.get(boom.remote())
    except exc.TaskError as e:
        out["task_error"] = [type(e).__name__, e.cause_cls_name,
                             "boom" in str(e)]

    @rt.remote
    def slow():
        time.sleep(5)
        return 1

    try:
        rt.get(slow.remote(), timeout=0.2)
    except exc.GetTimeoutError as e:
        out["get_timeout"] = type(e).__name__

    dead = Acc.remote(0)
    rt.get(dead.add.remote(1))
    rt.kill(dead)
    # The kill is asynchronous: a call may still land before the actor
    # dies, so call until one fails.
    deadline = time.monotonic() + 60
    while "actor_died" not in out and time.monotonic() < deadline:
        try:
            rt.get(dead.add.remote(1), timeout=60)
            time.sleep(0.05)
        except exc.ActorError as e:
            out["actor_died"] = type(e).__name__

    @rt.remote
    def ident(i, delay):
        time.sleep(delay)
        return i

    fast = [ident.remote(i, 0.0) for i in (0, 2)]
    rt.get(fast)
    slow = [ident.remote(i, 10.0) for i in (1, 3)]
    refs = [fast[0], slow[0], fast[1], slow[1]]
    ready, pending = rt.wait(refs, num_returns=2, timeout=30)
    out["wait"] = {"ready": sorted(rt.get(ready)), "pending": len(pending)}

    named = Acc.options(name="counter").remote(100)
    rt.get(named.add.remote(1))
    out["named"] = rt.get(rt.get_actor("counter").add.remote(2))

    res = rt.cluster_resources()
    out["resources"] = {k: res[k] for k in sorted(res)}

    @rt.remote(resources={"custom": 1})
    def uses_custom():
        return "custom-ok"

    out["custom_task"] = rt.get(uses_custom.remote())
    return out


def roundtrips():
    @rt.remote
    def noop():
        return None

    @rt.remote
    class A:
        def noop(self):
            return None

    a = A.remote()
    rt.get([noop.remote(), a.noop.remote()])

    def med(fn, n=200):
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return sorted(ts)[n // 2] * 1e6

    return {"task_us": med(lambda: rt.get(noop.remote())),
            "actor_us": med(lambda: rt.get(a.noop.remote()))}


def serve():
    flat = dict(np.load(sys.argv[3]))
    tree = {k: v for k, v in flat.items() if "/" not in k}
    tree["layers"] = {k.split("/", 1)[1]: v for k, v in flat.items()
                      if k.startswith("layers/")}
    prompts = json.loads(sys.argv[4])

    @rt.remote
    class Server:
        def __init__(self, tree, new_tokens):
            if pkg == "ray_tpu":
                import jax
                import jax.numpy as jnp
                from ray_tpu.models import configs
                from ray_tpu.serve.llm import LLMReplica
                params = jax.tree_util.tree_map(jnp.asarray, tree)
            else:
                import torch
                torch.set_num_threads(1)
                from ray_tpu_torch.models import configs, params_from_jax
                from ray_tpu_torch.serve.llm import LLMReplica
                params = params_from_jax(tree, configs.tiny, device="cpu")
            cfg = configs.tiny
            self.rep = LLMReplica(lambda: (params, cfg), num_slots=2,
                                  max_len=64, prefill_chunk=8,
                                  default_max_new_tokens=new_tokens)

        def generate(self, prompt):
            return [int(t) for t in self.rep(prompt)]

        def modules(self):
            return sorted(m for m in sys.modules if m in ("jax", "ray_tpu")
                          or m.startswith(("jax.", "ray_tpu.")))

    s = Server.options(max_concurrency=4).remote(tree, 6)
    out = {"tokens": rt.get([s.generate.remote(p) for p in prompts],
                            timeout=300)}
    mods = rt.get(s.modules.remote())
    out["worker_loads_jax"] = "jax" in mods
    out["worker_loads_ray_tpu"] = any(m.startswith("ray_tpu.") and
                                      not m.startswith("ray_tpu_torch")
                                      for m in mods)
    return out


rt.init(num_cpus=4, resources={"custom": 2.0})
try:
    out = {"api": api, "roundtrips": roundtrips, "serve": serve}[mode]()
finally:
    rt.shutdown()
print("RESULT " + json.dumps(out, sort_keys=True))
'''


def _run(tmp_path, pkg, mode, *args, timeout=300):
    script = tmp_path / "driver.py"
    script.write_text(DRIVER)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in [str(ROOT), env.get("PYTHONPATH", "")] if p)
    proc = subprocess.run([sys.executable, str(script), pkg, mode, *args],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    assert line, proc.stdout[-4000:]
    return json.loads(line[-1][len("RESULT "):])


def test_core_api_matches_the_jax_runtime(tmp_path):
    ref = _run(tmp_path, "ray_tpu", "api")
    out = _run(tmp_path, "ray_tpu_torch", "api")
    assert out == ref
    # The script reached every part of the API on both sides.
    assert set(out) == {"tasks", "actor_calls", "actor_state", "put_get_big",
                        "put_get_small", "task_error", "get_timeout",
                        "actor_died", "wait", "named", "resources",
                        "custom_task"}
    assert out["put_get_big"]["equal"] and out["put_get_big"]["zero_copy"]
    assert out["resources"]["custom"] == 2.0 and "GPU" not in out["resources"]
    assert out["wait"] == {"ready": [0, 2], "pending": 2}


PROMPTS = [[1, 2, 3], [5, 6, 7, 8, 9], [4], list(range(10, 29))]


def test_tiny_slice_served_by_actors_matches_the_jax_runtime(tmp_path):
    import jax

    from ray_tpu.models import configs as jax_configs
    from ray_tpu.models import transformer as jax_tf

    jp = jax_tf.init_params(jax.random.PRNGKey(0), jax_configs.tiny)
    flat = {k: np.asarray(v) for k, v in jp.items() if k != "layers"}
    flat.update({f"layers/{k}": np.asarray(v)
                 for k, v in jp["layers"].items()})
    weights = tmp_path / "tiny.npz"
    np.savez(weights, **flat)
    args = (str(weights), json.dumps(PROMPTS))
    ref = _run(tmp_path, "ray_tpu", "serve", *args)
    out = _run(tmp_path, "ray_tpu_torch", "serve", *args)
    assert [len(t) for t in out["tokens"]] == [6] * len(PROMPTS)
    assert out["tokens"] == ref["tokens"]
    assert ref["worker_loads_jax"] and not out["worker_loads_jax"]
    assert not out["worker_loads_ray_tpu"]


def main(tmp_path: pathlib.Path):
    for pkg in ("ray_tpu", "ray_tpu_torch"):
        print(pkg, json.dumps(_run(tmp_path, pkg, "roundtrips")), flush=True)


if __name__ == "__main__":
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        main(pathlib.Path(d))
