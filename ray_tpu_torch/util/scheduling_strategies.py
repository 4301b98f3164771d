"""Scheduling strategies for tasks and actors.

Analog of python/ray/util/scheduling_strategies.py in the reference
(PlacementGroupSchedulingStrategy :15, NodeAffinitySchedulingStrategy :41,
NodeLabelSchedulingStrategy :135).
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch.util.placement_group import PlacementGroup


class PlacementGroupSchedulingStrategy:
    def __init__(
        self,
        placement_group: PlacementGroup,
        placement_group_bundle_index: int = 0,
        placement_group_capture_child_tasks: bool = False,
    ):
        self.placement_group = placement_group
        self.placement_group_bundle_index = placement_group_bundle_index
        self.placement_group_capture_child_tasks = placement_group_capture_child_tasks

    def to_dict(self):
        return {
            "type": "placement_group",
            "pg_id": self.placement_group.id.binary(),
            "bundle_index": self.placement_group_bundle_index,
        }


class NodeAffinitySchedulingStrategy:
    def __init__(self, node_id: bytes, soft: bool = False):
        self.node_id = node_id
        self.soft = soft

    def to_dict(self):
        return {"type": "node_affinity", "node_id": self.node_id, "soft": self.soft}


class NodeLabelSchedulingStrategy:
    def __init__(self, hard: Optional[dict] = None, soft: Optional[dict] = None):
        self.hard = hard or {}
        self.soft = soft or {}

    def to_dict(self):
        return {"type": "node_label", "hard": self.hard, "soft": self.soft}
