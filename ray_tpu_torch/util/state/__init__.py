"""Cluster state introspection API.

Analog of the reference's ``ray.util.state`` (python/ray/util/state/api.py,
state_manager.py aggregating from GCS): ``list_tasks/actors/nodes/objects/
jobs/placement_groups/workers`` plus ``summarize_tasks``, powering the
``rt list`` / ``rt summary`` CLI.
"""

from ray_tpu_torch.util.state.api import (  # noqa: F401
    StateApiClient,
    get_timeline,
    get_worker_stacks,
    list_actors,
    list_jobs,
    drain_node,
    get_log,
    list_logs,
    list_nodes,
    list_objects,
    list_placement_groups,
    list_tasks,
    list_workers,
    summarize_tasks,
)
