from ray_tpu_torch.util import debug
from ray_tpu_torch.util.check_serialize import inspect_serializability
from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.placement_group import (
    PlacementGroup,
    PlacementGroupConfig,
    placement_group,
    remove_placement_group,
)

__all__ = [
    "inspect_serializability",
    "ActorPool",
    "debug",
    "PlacementGroup",
    "PlacementGroupConfig",
    "placement_group",
    "remove_placement_group",
]
