"""Rank programs for tests/test_torch_serve_tp.py: the port's serving
engine at tp = world on gloo ranks of the CPU (tests/torch_dist_util
starts them). The weights are the JAX package's init_params tree, saved
by the test as the .npz that RT_TP_WEIGHTS names. This file imports no
JAX.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ray_tpu_torch.models import configs, params_from_jax
from ray_tpu_torch.models.transformer import param_logical_axes
from ray_tpu_torch.parallel import MeshConfig, build_mesh, shard_params
from ray_tpu_torch.serve.llm import ContinuousBatchingEngine

# tests/test_serve_llm.py:384-420's configuration.
CFG = dataclasses.replace(configs.tiny, d_model=64, d_ff=128, vocab_size=128,
                          n_layers=2, n_heads=8, n_kv_heads=8, max_seq=64,
                          remat=False, dtype=torch.float32)
PROMPT = [3, 7, 5]
# 16 tokens, one full page at the engine's default page size: asked twice,
# the second prefill shares the page and forks it copy-on-write.
PAGE_PROMPT = list(range(1, 17))


def nest(flat):
    tree = {"layers": {}}
    for k, v in flat.items():
        if k.startswith("layers/"):
            tree["layers"][k[len("layers/"):]] = v
        else:
            tree[k] = v
    return tree


def load_params(path=None):
    flat = dict(np.load(path or os.environ["RT_TP_WEIGHTS"]))
    return params_from_jax(nest(flat), CFG, device="cpu")


def serve(engine) -> dict:
    """The requests every engine of the test answers, in order."""
    out = {}
    for mode_kw in ({},):
        out["greedy"] = engine.submit(PROMPT, max_new_tokens=6).result(180)
        both = [engine.submit([9, 4, 1, 7], max_new_tokens=5),
                engine.submit(PROMPT, max_new_tokens=6)]
        out["concurrent"] = [h.result(180) for h in both]
        out["page_twice"] = [
            engine.submit(PAGE_PROMPT, max_new_tokens=4).result(180)
            for _ in range(2)]
        sampled = engine.submit(PROMPT, max_new_tokens=5, temperature=0.8,
                                top_k=20, top_p=0.9).result(180)
        out["sampled_len"] = len(sampled)
    return out


def serve_tp_cases(rank: int, world: int) -> dict:
    mesh = build_mesh(MeshConfig(tp=world), "cpu")
    params = shard_params(load_params(), param_logical_axes(CFG), mesh)
    out = {}
    for kv_mode in ("paged", "slotted"):
        engine = ContinuousBatchingEngine(params, CFG, num_slots=2,
                                          max_len=48, mesh=mesh,
                                          kv_mode=kv_mode)
        if rank == 0:
            out[kv_mode] = serve(engine)
            out[kv_mode]["kv_heads"] = int(engine._k.shape[3])
            engine.shutdown()
        else:
            assert engine.wait(600), "the follower never saw STOP"
            out[kv_mode] = {"kv_heads": int(engine._k.shape[3]),
                            "passes": engine._forward_passes}
    return out
