"""Runtime context introspection (reference: python/ray/runtime_context.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from ray_tpu_torch._private import worker as worker_mod


@dataclass
class RuntimeContext:
    job_id: Optional[str]
    node_id: Optional[str]
    worker_mode: Optional[str]

    def get_job_id(self) -> Optional[str]:
        return self.job_id

    def get_node_id(self) -> Optional[str]:
        return self.node_id

    def get_assigned_resources(self) -> Dict[str, float]:
        client = worker_mod.get_client()
        if hasattr(client, "cluster_resources"):
            return client.cluster_resources()
        return {}


def get_runtime_context() -> RuntimeContext:
    client = worker_mod.get_client()
    job_id = getattr(client, "job_id", None)
    node_id = getattr(client, "node_id", None)
    return RuntimeContext(
        job_id=job_id.hex() if job_id is not None and hasattr(job_id, "hex") else None,
        node_id=node_id.hex() if isinstance(node_id, bytes) else None,
        worker_mode=worker_mod.get_mode(),
    )
