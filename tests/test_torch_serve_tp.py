"""Tensor-parallel serving in the port (ray_tpu_torch.serve.llm with a
mesh) held against the JAX package's.

The configuration is tests/test_serve_llm.py:384-420's (d 64, 8 heads,
8 KV heads, 2 layers, vocab 128, f32) with the JAX init_params(PRNGKey(0))
weights. The JAX engine runs at tp=8 over the virtual CPU devices; the
port's at tp=2 and tp=4 on gloo ranks (tests/torch_dist_util.py,
tests/torch_serve_tp_cases.py), in paged and slotted KV mode: greedy
tokens equal the JAX engine's and the port's unsharded engine's, for one
request, two at once, and a page-long prompt asked twice (the second
shares its page from the prefix cache and forks it copy-on-write on every
rank). Then `llm_deployment` with a loader that returns (params, cfg,
mesh) from a replica granted two (faked) cards, as
test_llm_deployment_tp_via_loader does in the JAX package.
"""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from tests.torch_dist_util import Ranks
from tests.torch_serve_tp_cases import PROMPT, load_params, serve

CFG_KW = dict(d_model=64, d_ff=128, vocab_size=128, n_layers=2, n_heads=8,
              n_kv_heads=8, max_seq=64, remat=False)


def _flat(tree):
    out = {k: v for k, v in tree.items() if k != "layers"}
    out.update({f"layers/{k}": v for k, v in tree["layers"].items()})
    return out


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    import jax

    from ray_tpu.models import configs, init_params

    cfg = dataclasses.replace(configs.tiny, dtype=np.float32, **CFG_KW)
    tree = jax.tree_util.tree_map(np.asarray,
                                  init_params(jax.random.PRNGKey(0), cfg))
    path = tmp_path_factory.mktemp("tp_weights") / "weights.npz"
    np.savez(path, **_flat(tree))
    return str(path)


@pytest.fixture(scope="module")
def jax_tokens():
    """The JAX engine at tp=8 and its unsharded engine on one request."""
    import jax

    from ray_tpu.models import configs, init_params, param_logical_axes
    from ray_tpu.parallel import MeshConfig, build_mesh, shard_params
    from ray_tpu.serve.llm import ContinuousBatchingEngine

    cfg = dataclasses.replace(configs.tiny, dtype=np.float32, **CFG_KW)
    params = init_params(jax.random.PRNGKey(0), cfg)
    mesh = build_mesh(MeshConfig(tp=8), jax.devices()[:8])
    sharded = shard_params(params, param_logical_axes(cfg), mesh)
    out = {}
    for name, p, m in (("tp8", sharded, mesh), ("single", params, None)):
        eng = ContinuousBatchingEngine(p, cfg, num_slots=2, max_len=48,
                                       mesh=m)
        try:
            out[name] = eng.submit(PROMPT, max_new_tokens=6).result(
                timeout=180)
        finally:
            eng.shutdown()
    return out


@pytest.fixture(scope="module")
def unsharded(weights):
    from ray_tpu_torch.serve.llm import ContinuousBatchingEngine
    from tests.torch_serve_tp_cases import CFG

    torch.set_num_threads(1)
    out = {}
    for kv_mode in ("paged", "slotted"):
        eng = ContinuousBatchingEngine(load_params(weights), CFG,
                                       num_slots=2, max_len=48,
                                       kv_mode=kv_mode)
        try:
            out[kv_mode] = serve(eng)
        finally:
            eng.shutdown()
    return out


@pytest.fixture(scope="module", params=[2, 4])
def tp_run(request, weights, tmp_path_factory, monkeypatch_module):
    monkeypatch_module.setenv("RT_TP_WEIGHTS", weights)
    world = request.param
    tmp = tmp_path_factory.mktemp(f"serve_tp{world}")
    return world, Ranks("tests/torch_serve_tp_cases.py:serve_tp_cases",
                        world, tmp, timeout=600).get()


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_jax_engine_tp8_matches_its_unsharded_engine(jax_tokens):
    assert jax_tokens["tp8"] == jax_tokens["single"]


@pytest.mark.parametrize("kv_mode", ["paged", "slotted"])
def test_tp_greedy_tokens_equal_jax_tp8_and_the_unsharded_port(
        tp_run, unsharded, jax_tokens, kv_mode):
    world, ranks = tp_run
    got = ranks[0][kv_mode]
    want = unsharded[kv_mode]
    assert got["greedy"] == jax_tokens["tp8"] == want["greedy"]
    assert got["concurrent"] == want["concurrent"]
    assert got["page_twice"] == want["page_twice"]
    assert got["page_twice"][0] == got["page_twice"][1]
    assert got["sampled_len"] == want["sampled_len"] == 5


@pytest.mark.parametrize("kv_mode", ["paged", "slotted"])
def test_every_rank_holds_its_kv_heads_and_follows_each_pass(tp_run,
                                                             kv_mode):
    world, ranks = tp_run
    assert [r[kv_mode]["kv_heads"] for r in ranks] == [8 // world] * world
    passes = [r[kv_mode]["passes"] for r in ranks[1:]]
    assert len(set(passes)) == 1 and passes[0] > 0


def test_engine_mesh_checks():
    """The JAX engine's checks: a mesh without "tp", and a tp that does
    not divide the KV heads, are refused."""
    from ray_tpu_torch.serve.llm import ContinuousBatchingEngine

    class Mesh:
        mesh_dim_names = ("dp",)
        shape = (1,)

    with pytest.raises(ValueError, match="\"tp\" axis"):
        ContinuousBatchingEngine({"embed": torch.zeros(2, 2)}, None,
                                 mesh=Mesh())

    class Mesh3:
        mesh_dim_names = ("tp",)
        shape = (3,)

    from tests.torch_serve_tp_cases import CFG

    with pytest.raises(ValueError, match="must divide"):
        ContinuousBatchingEngine({"embed": torch.zeros(2, 2)}, CFG,
                                 mesh=Mesh3())


def test_llm_deployment_tp_via_loader(weights, unsharded):
    """Tensor-parallel serving through serve.run: a replica granted two
    cards starts its follower, and the loader builds the mesh and shards
    params inside each rank and returns (params, cfg, mesh)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import llm_deployment

    def loader():
        from ray_tpu_torch.models.transformer import param_logical_axes
        from ray_tpu_torch.parallel import (MeshConfig, build_mesh,
                                            shard_params)
        from tests.torch_serve_tp_cases import CFG, load_params

        torch.set_num_threads(1)
        mesh = build_mesh(MeshConfig(tp=2), "cpu")
        return (shard_params(load_params(weights), param_logical_axes(CFG),
                             mesh), CFG, mesh)

    rt.init(num_cpus=4, num_gpus=2)
    try:
        serve.start(port=0)
        h = serve.run(llm_deployment(loader, num_slots=2, max_len=48,
                                     default_max_new_tokens=6,
                                     ray_actor_options={"num_gpus": 2}),
                      name="tpllm")
        out = h.remote(PROMPT).result(timeout=300)
        stats = h.options(method_name="stats").remote().result(timeout=60)
        serve.shutdown()
    finally:
        rt.shutdown()
    assert out == unsharded["paged"]["greedy"]
    assert stats["forward_passes"] > 0
    # The follower ends with its replica.
    deadline = time.monotonic() + 15
    while _followers() and time.monotonic() < deadline:
        time.sleep(0.2)
    assert not _followers()


def _followers():
    """Live follower processes (python -m ray_tpu_torch.serve.tp)."""
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                args = f.read().split(b"\0")
        except OSError:
            continue
        if b"ray_tpu_torch.serve.tp" in args:
            out.append(int(pid))
    return out
