"""Parallelism primitives of the PyTorch port: mesh management, sharding
rules, ring attention, sequence parallelism, pipeline parallelism, expert
parallelism. Counterpart of ray_tpu/parallel.

The reference runs each primitive as one SPMD program over a jax.Mesh
(shard_map, ppermute, all_to_all, GSPMD). The port runs one process per
rank over torch.distributed — NCCL on the card, gloo on the CPU — and
each function takes a DeviceMesh and the rank's local shards and issues
the collectives GSPMD would have inserted, with the matching backward,
so a sharded run computes what the unsharded run computes.
"""

from ray_tpu_torch.parallel.mesh import (
    MeshConfig,
    build_mesh,
    logical_to_physical,
    shard_params,
    with_sharding_constraint,
)
from ray_tpu_torch.parallel.ring_attention import ring_attention
from ray_tpu_torch.parallel.ulysses import ulysses_attention
from ray_tpu_torch.parallel.pipeline import pipeline_stages
from ray_tpu_torch.parallel.moe import moe_layer, top_k_routing

__all__ = [
    "MeshConfig",
    "build_mesh",
    "logical_to_physical",
    "shard_params",
    "with_sharding_constraint",
    "ring_attention",
    "ulysses_attention",
    "pipeline_stages",
    "moe_layer",
    "top_k_routing",
]
