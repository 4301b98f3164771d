"""Collective communication (the port of ray_tpu/util/collective)."""

from ray_tpu_torch.util.collective.collective import (
    add_op_observer,
    allgather,
    allreduce,
    barrier,
    broadcast,
    create_collective_group,
    destroy_collective_group,
    get_collective_group_size,
    get_rank,
    init_collective_group,
    last_op_info,
    recv,
    reduce,
    reducescatter,
    remove_op_observer,
    send,
)
from ray_tpu_torch.util.collective.types import Backend, ReduceOp

__all__ = [
    "add_op_observer",
    "remove_op_observer",
    "last_op_info",
    "init_collective_group",
    "create_collective_group",
    "destroy_collective_group",
    "allreduce",
    "allgather",
    "reducescatter",
    "broadcast",
    "reduce",
    "barrier",
    "send",
    "recv",
    "get_rank",
    "get_collective_group_size",
    "Backend",
    "ReduceOp",
]
