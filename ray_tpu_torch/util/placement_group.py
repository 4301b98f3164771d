"""Placement groups: atomic gang reservation of resource bundles.

Analog of python/ray/util/placement_group.py (:41 PlacementGroup, :146
placement_group()) backed by the GCS two-phase bundle reservation
(gcs/gcs_server/gcs_placement_group_scheduler.h; strategies from
bundle_scheduling_policy.cc). On GPU clusters a bundle is typically one
whole host's GPUs, so STRICT_SPREAD of N bundles == gang-reserve N hosts.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.ids import PlacementGroupID
from ray_tpu_torch.exceptions import PlacementGroupSchedulingError

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundles: List[Dict[str, float]]):
        self.id = pg_id
        self.bundles = bundles

    @property
    def bundle_count(self) -> int:
        return len(self.bundles)

    def ready(self, timeout: float = 30.0) -> bool:
        """Block until the group is reserved (reference: pg.ready())."""
        client = worker_mod.get_client()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            info = client._run(
                client.gcs.call("get_placement_group", {"pg_id": self.id.binary()})
            )["pg"]
            if info is None:
                return False
            if info["state"] == "CREATED":
                return True
            if info["state"] in ("INFEASIBLE", "REMOVED"):
                raise PlacementGroupSchedulingError(
                    f"placement group {self.id.hex()} is {info['state']}"
                )
            time.sleep(0.05)
        return False

    def bundle_node_ids(self) -> List[bytes]:
        client = worker_mod.get_client()
        info = client._run(
            client.gcs.call("get_placement_group", {"pg_id": self.id.binary()})
        )["pg"]
        return info["bundle_nodes"] if info else []

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundles))


@dataclass
class PlacementGroupConfig:
    """Declarative gang spec: bundles plus the scheduling tier.

    `priority` is the preemption class — when this gang cannot place, the
    GCS may reclaim chips from strictly lower-priority gangs (and this
    gang may in turn be evicted by higher tiers). 0 is the default
    best-effort tier.
    """

    bundles: List[Dict[str, float]] = field(default_factory=list)
    strategy: str = "PACK"
    name: str = ""
    priority: int = 0

    def create(self) -> PlacementGroup:
        return placement_group(
            self.bundles,
            strategy=self.strategy,
            name=self.name,
            priority=self.priority,
        )


def placement_group(
    bundles: List[Dict[str, float]],
    strategy: str = "PACK",
    name: str = "",
    priority: int = 0,
) -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"strategy must be one of {VALID_STRATEGIES}")
    if not bundles:
        raise ValueError("placement group needs at least one bundle")
    client = worker_mod.get_client()
    pg_id = PlacementGroupID.from_random()
    resp = client._run(
        client.gcs.call(
            "create_placement_group",
            {
                "pg_id": pg_id.binary(),
                "bundles": [dict(b) for b in bundles],
                "strategy": strategy,
                "name": name,
                "priority": int(priority),
            },
        )
    )
    pg = PlacementGroup(pg_id, [dict(b) for b in bundles])
    if not resp.get("ok"):
        # Reservation is retried by ready(); surface infeasibility there.
        pass
    return pg


def remove_placement_group(pg: PlacementGroup):
    client = worker_mod.get_client()
    client._run(
        client.gcs.call("remove_placement_group", {"pg_id": pg.id.binary()})
    )


def placement_group_state(pg: PlacementGroup) -> Optional[str]:
    """Current GCS state of the group (None once it is forgotten)."""
    client = worker_mod.get_client()
    info = client._run(
        client.gcs.call("get_placement_group", {"pg_id": pg.id.binary()})
    )["pg"]
    return info["state"] if info else None


def release_placement_group_bundles(pg: PlacementGroup, indices: List[int]):
    """Give individual bundles of a CREATED group back to the cluster
    (elastic shrink): their chips are credited and, when the release
    satisfies a partial-reclamation drain, the GCS records a *resize
    obligation* so the gang can reclaim exactly these bundles later."""
    client = worker_mod.get_client()
    resp = client._run(
        client.gcs.call(
            "release_pg_bundles",
            {"pg_id": pg.id.binary(), "indices": [int(i) for i in indices]},
        )
    )
    if not resp.get("ok"):
        raise PlacementGroupSchedulingError(
            f"bundle release failed for pg {pg.id.hex()}: "
            f"{resp.get('error', 'unknown error')}"
        )


def reserve_placement_group_bundles(pg: PlacementGroup, indices: List[int]):
    """Re-reserve previously released bundles (elastic grow-back).
    Fails while the chips are fenced for another claimant or occupied."""
    client = worker_mod.get_client()
    resp = client._run(
        client.gcs.call(
            "reserve_pg_bundles",
            {"pg_id": pg.id.binary(), "indices": [int(i) for i in indices]},
        )
    )
    if not resp.get("ok"):
        raise PlacementGroupSchedulingError(
            f"bundle re-reserve failed for pg {pg.id.hex()}: "
            f"{resp.get('error', 'unknown error')}"
        )


def placement_group_resize_state(pg: PlacementGroup) -> Dict:
    """Resize obligations recorded against this group: the bundles it
    gave up to a partial reclamation and whether the claimant has
    released them (state \"lifted\" — the fence-lift signal the trainer's
    grow-back path polls)."""
    client = worker_mod.get_client()
    return client._run(
        client.gcs.call("get_resize_state", {"pg_id": pg.id.binary()})
    )
