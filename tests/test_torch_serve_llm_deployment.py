"""`llm_deployment` of the port held against the JAX package's.

The tiny Llama config in f32, with the JAX weights carried across by
`models.params_from_jax`: a driver script under each package serves it
through `serve.run(llm_deployment(...))` and records the greedy tokens,
unary and streamed, then after `chaos.kill_replica` (once a request
succeeds on the replacement) and after `chaos.drop_controller` (once the
restarted controller has restored its checkpoint and a fresh handle is
served). Both packages must give the same tokens at every step.
test_torch_serve_one_gpu.py runs the same driver's one-GPU case.
"""

import json

import numpy as np
import pytest

from test_torch_serve_api import PRELUDE, run_driver

PROMPTS = [[1, 2, 3], [5, 6, 7, 8, 9], list(range(10, 29))]

DRIVER = PRELUDE + r'''
chaos = importlib.import_module(pkg + "._private.chaos")
llm_deployment = importlib.import_module(pkg + ".serve.llm").llm_deployment

flat = dict(np.load(sys.argv[2]))
tree = {k: v for k, v in flat.items() if "/" not in k}
tree["layers"] = {k.split("/", 1)[1]: v for k, v in flat.items()
                  if k.startswith("layers/")}
prompts = json.loads(sys.argv[3])
mode = sys.argv[4]


def loader():
    if pkg == "ray_tpu":
        import jax
        import jax.numpy as jnp
        from ray_tpu.models import configs
        return jax.tree_util.tree_map(jnp.asarray, tree), configs.tiny
    import torch
    torch.set_num_threads(1)
    from ray_tpu_torch.models import configs, params_from_jax
    return params_from_jax(tree, configs.tiny, device="cpu"), configs.tiny


def greedy(h):
    return [h.remote(p, 6).result(timeout=120) for p in prompts]


def first_success(h, prompt):
    deadline = time.monotonic() + 120
    while True:
        try:
            return h.remote(prompt, 6).result(timeout=120)
        except Exception:  # noqa: BLE001 — the fault settling
            assert time.monotonic() < deadline, "never served again"
            time.sleep(0.2)


def parity():
    out = {}
    h = serve.run(llm_deployment(loader, num_slots=2, max_len=64,
                                 prefill_chunk=8), name="llm")
    out["unary"] = greedy(h)
    out["streamed"] = [list(h.options(stream=True, method_name="stream")
                            .remote(p, 6)) for p in prompts]
    chaos.enable()
    try:
        chaos.kill_replica("llm", 0)
        out["after_kill_first"] = first_success(h, prompts[0])
        out["after_kill"] = greedy(h)
        chaos.drop_controller(restart=True)
        during = greedy(h)
        deadline = time.monotonic() + 60
        while True:
            try:
                if "llm" in serve.status():
                    break
            except Exception:  # noqa: BLE001 — the restart settling
                pass
            assert time.monotonic() < deadline, "controller never came back"
            time.sleep(0.2)
        out["after_drop_controller"] = [during,
                                        greedy(serve.get_app_handle("llm"))]
    finally:
        chaos.disable()
    return out


def one_gpu():
    gcs = rt._worker.get_client()

    def replicas():
        acts = gcs._run(gcs._gcs_call("list_actors", {}))["actors"]
        return sorted(a["state"] for a in acts
                      if a["class_name"] == "ReplicaActor")

    h = serve.run(llm_deployment(loader, num_slots=2, max_len=64,
                                 prefill_chunk=8,
                                 ray_actor_options={"num_gpus": 1}),
                  name="llm")
    before = greedy(h)
    held = rt.available_resources().get("GPU")
    chaos.enable()
    try:
        chaos.kill_replica("llm", 0)
        first = first_success(h, prompts[0])
    finally:
        chaos.disable()
    return {"before": before, "held": held, "first": first,
            "after": greedy(h),
            "held_by_replacement": rt.available_resources().get("GPU"),
            "replicas": replicas(), "total": rt.cluster_resources()["GPU"]}


if mode == "one_gpu":
    os.environ["RT_NUM_GPUS"] = "1"  # one fake card, as detection reads it
rt.init(num_cpus=4)
try:
    out = {"parity": parity, "one_gpu": one_gpu}[mode]()
finally:
    serve.shutdown()
    rt.shutdown()
print("RESULT " + json.dumps(out, sort_keys=True))
'''


def save_tiny_weights(tmp):
    """The JAX package's tiny Llama weights (seed 0) as an .npz file the
    drivers load; returns its path and the JAX tree."""
    import jax

    from ray_tpu.models import configs as jax_configs
    from ray_tpu.models import transformer as jax_tf

    jp = jax_tf.init_params(jax.random.PRNGKey(0), jax_configs.tiny)
    flat = {k: np.asarray(v) for k, v in jp.items() if k != "layers"}
    flat.update({f"layers/{k}": np.asarray(v)
                 for k, v in jp["layers"].items()})
    weights = tmp / "tiny.npz"
    np.savez(weights, **flat)
    return weights, jp


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("llm_deployment")
    weights, _ = save_tiny_weights(tmp)
    args = (str(weights), json.dumps(PROMPTS), "parity")
    return {"ref": run_driver(tmp, DRIVER, "ray_tpu", *args),
            "port": run_driver(tmp, DRIVER, "ray_tpu_torch", *args)}


@pytest.mark.parametrize("key", ["unary", "streamed", "after_kill_first",
                                 "after_kill", "after_drop_controller"])
def test_llm_deployment_tokens_match_the_jax_package(results, key):
    ref, out = results["ref"], results["port"]
    assert out[key] == ref[key]


def test_llm_deployment_tokens_are_greedy_and_stable(results):
    out = results["port"]
    assert [len(t) for t in out["unary"]] == [6] * len(PROMPTS)
    assert all(0 <= t < 256 for toks in out["unary"] for t in toks)
    assert out["streamed"] == out["unary"] == out["after_kill"]
    assert out["after_kill_first"] == out["unary"][0]
    assert out["after_drop_controller"] == [out["unary"], out["unary"]]
