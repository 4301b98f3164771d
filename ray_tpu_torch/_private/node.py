"""Node bootstrap: starts the control-plane services for a host.

Analog of python/ray/_private/node.py:37 (Node) + services.py in the
reference (start_gcs_server services.py:1421, start_raylet :1485). Unlike
the reference — which execs separate gcs_server/raylet binaries — the head
services here run on an asyncio loop in a background thread of the driver
process by default (worker processes are always real subprocesses). A
`Cluster` harness can attach extra raylets to the same loop to simulate
multi-node topologies, mirroring python/ray/cluster_utils.py:108.
"""

from __future__ import annotations

import asyncio
import os
import threading
from typing import Dict, Optional

from ray_tpu_torch._private.accelerators import get_all_accelerator_managers
from ray_tpu_torch._private.gcs import GcsServer
from ray_tpu_torch._private.ids import JobID
from ray_tpu_torch._private.raylet import Raylet
from ray_tpu_torch._private.worker import CoreClient


def resolve_resources(
    num_cpus: Optional[float] = None,
    num_gpus: Optional[float] = None,
    resources: Optional[Dict[str, float]] = None,
) -> Dict[str, float]:
    """ResourceSpec.resolve analog (_private/resource_spec.py:169): CPU
    count, accelerator detection, and accelerator-specific extra resources
    (the GPU count and its type label enter here)."""
    out: Dict[str, float] = dict(resources or {})
    out["CPU"] = float(num_cpus if num_cpus is not None else (os.cpu_count() or 1))
    for name, mgr in get_all_accelerator_managers().items():
        if name in out:
            continue
        count = num_gpus if (name == "GPU" and num_gpus is not None) else None
        if count is None:
            count = mgr.get_current_node_num_accelerators()
        if count:
            out[name] = float(count)
            acc_type = mgr.get_current_node_accelerator_type()
            if acc_type:
                out.setdefault(acc_type, 1.0)
            for k, v in mgr.get_current_node_additional_resources().items():
                out.setdefault(k, v)
    out.setdefault("memory", 0.0)
    return out


class EventLoopThread:
    def __init__(self, name="ray_tpu_torch-io"):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self._run, name=name, daemon=True)
        self.thread.start()

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def run(self, coro, timeout=None):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def stop(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=5)


class Node:
    """A head (or worker) node running in this process."""

    def __init__(
        self,
        head: bool = True,
        gcs_address: Optional[str] = None,
        num_cpus: Optional[float] = None,
        num_gpus: Optional[float] = None,
        resources: Optional[Dict[str, float]] = None,
        object_store_memory: Optional[int] = None,
        labels: Optional[Dict[str, str]] = None,
        loop_thread: Optional[EventLoopThread] = None,
    ):
        self.io = loop_thread or EventLoopThread()
        self._owns_loop = loop_thread is None
        self.gcs_server: Optional[GcsServer] = None
        if head:
            import os as _os

            # GCS fault tolerance: set RT_GCS_PERSIST_PATH to snapshot the
            # durable GCS tables (kv/jobs/actors/PGs/object dir) to disk so a
            # restarted GCS rejoins live raylets with its state intact.
            self.gcs_server = GcsServer(
                persist_path=_os.environ.get("RT_GCS_PERSIST_PATH") or None
            )
            self.gcs_port = self.io.run(self.gcs_server.start())
            self.gcs_host = "127.0.0.1"
        else:
            assert gcs_address is not None
            host, port = gcs_address.rsplit(":", 1)
            self.gcs_host, self.gcs_port = host, int(port)

        node_resources = resolve_resources(num_cpus, num_gpus, resources)
        self.raylet = Raylet(
            self.gcs_host,
            self.gcs_port,
            node_resources,
            labels=labels,
            object_store_memory=object_store_memory,
            is_head=head,
        )
        self.raylet_port = self.io.run(self.raylet.start())

    @property
    def gcs_address(self) -> str:
        return f"{self.gcs_host}:{self.gcs_port}"

    def make_client(self, job_id: Optional[JobID] = None, mode="driver") -> CoreClient:
        client = CoreClient(
            self.io.loop,
            (self.gcs_host, self.gcs_port),
            ("127.0.0.1", self.raylet_port),
            self.raylet.store_name,
            self.raylet.node_id.binary(),
            job_id or JobID.from_random(),
            mode=mode,
        )
        client.connect()
        return client

    def stop(self):
        try:
            self.io.run(self.raylet.stop(), timeout=10)
        except Exception:
            pass
        if self.gcs_server is not None:
            try:
                self.io.run(self.gcs_server.stop(), timeout=5)
            except Exception:
                pass
        if self._owns_loop:
            self.io.stop()
