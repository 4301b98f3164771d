"""One card, a replacement replica: the port's `llm_deployment` on a node
that detects one fake GPU (`RT_NUM_GPUS=1`).

The driver of test_torch_serve_llm_deployment.py serves the tiny Llama
config (f32, the JAX package's seed-0 weights carried across by
`params_from_jax`) from a `num_gpus=1` replica, then `chaos.kill_replica`.
The replacement can only start once the dead replica's GPU is released:
it holds the GPU, is the only live replica, and serves the greedy tokens
of the JAX package's `generate` on the same weights.
"""

import json

import jax.numpy as jnp
import numpy as np

from ray_tpu.models import configs as jax_configs
from ray_tpu.models.generate import generate as jax_generate
from test_torch_serve_api import run_driver
from test_torch_serve_llm_deployment import DRIVER, PROMPTS, save_tiny_weights


def test_replacement_replica_waits_for_the_one_gpu(tmp_path):
    weights, jp = save_tiny_weights(tmp_path)
    one = run_driver(tmp_path, DRIVER, "ray_tpu_torch", str(weights),
                     json.dumps(PROMPTS), "one_gpu")
    refs = [np.asarray(jax_generate(jp, jnp.asarray([p], dtype=jnp.int32),
                                    jax_configs.tiny, max_new_tokens=6))
            [0].tolist() for p in PROMPTS]
    assert one["total"] == 1.0
    assert one["held"] == 0.0 and one["held_by_replacement"] == 0.0
    # The killed replica is dead, its replacement alive: never both.
    assert one["replicas"] == ["ALIVE", "DEAD"]
    assert one["before"] == one["after"] == refs
    assert one["first"] == refs[0]
