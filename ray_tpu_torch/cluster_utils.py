"""In-process multi-node cluster harness for tests.

Analog of python/ray/cluster_utils.py:108 in the reference: `Cluster` boots
multiple raylets (each with its own object store, resources, and worker
pool) against one GCS, which is how nearly all "distributed" tests run on a
single machine. Raylet control loops share one event-loop thread here;
workers are real subprocesses.

Every raylet here grants card ids from this process's view of the host's
cards (CUDA_VISIBLE_DEVICES, or all of them), and nothing arbitrates
between raylets: two nodes given `num_gpus` would both grant card 0.
Give `num_gpus` to one node of a host.
"""

from __future__ import annotations

from typing import Dict, Optional

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.gcs import GcsServer
from ray_tpu_torch._private.ids import JobID
from ray_tpu_torch._private.node import EventLoopThread, resolve_resources
from ray_tpu_torch._private.raylet import Raylet


class Cluster:
    def __init__(self, gcs_persist_path: Optional[str] = None):
        self.io = EventLoopThread("rt-cluster")
        self.gcs_persist_path = gcs_persist_path
        self.gcs = GcsServer(persist_path=gcs_persist_path)
        self.gcs_port = self.io.run(self.gcs.start())
        self.raylets = []
        self.head = None
        self._client = None

    def kill_gcs(self, hard: bool = False):
        """Stop the GCS (fault injection). `hard=True` skips the final
        snapshot flush — recovery then depends entirely on WAL replay."""
        self.io.run(
            self.gcs.kill() if hard else self.gcs.stop(), timeout=5
        )

    def restart_gcs(self):
        """Start a fresh GCS on the same port; with a persist path it
        restores its durable tables and live raylets re-register within a
        heartbeat (GCS fault tolerance, redis_store_client.h:33 analog)."""
        self.gcs = GcsServer(
            port=self.gcs_port, persist_path=self.gcs_persist_path
        )
        assert self.io.run(self.gcs.start()) == self.gcs_port

    def add_node(
        self,
        num_cpus: float = 1,
        num_gpus: Optional[float] = None,
        resources: Optional[Dict[str, float]] = None,
        object_store_memory: Optional[int] = None,
        labels: Optional[Dict[str, str]] = None,
        env_overrides: Optional[Dict[str, str]] = None,
    ) -> Raylet:
        node_resources = dict(resources or {})
        node_resources["CPU"] = float(num_cpus)
        if num_gpus is not None:
            node_resources["GPU"] = float(num_gpus)
        raylet = Raylet(
            "127.0.0.1",
            self.gcs_port,
            node_resources,
            labels=labels,
            object_store_memory=object_store_memory,
            is_head=self.head is None,
        )
        if env_overrides:
            raylet.spawn_env_overrides = env_overrides
        self.io.run(raylet.start())
        self.raylets.append(raylet)
        if self.head is None:
            self.head = raylet
        return raylet

    def connect(self):
        """Attach the current process as a driver on the head node."""
        from ray_tpu_torch._private.worker import CoreClient

        assert self.head is not None, "add_node() first"
        client = CoreClient(
            self.io.loop,
            ("127.0.0.1", self.gcs_port),
            ("127.0.0.1", self.head.port),
            self.head.store_name,
            self.head.node_id.binary(),
            JobID.from_random(),
            mode="driver",
        )
        client.connect()
        self._client = client
        worker_mod.set_client(client, "driver")
        return client

    def remove_node(self, raylet: Raylet):
        self.io.run(raylet.stop(), timeout=10)
        self.raylets.remove(raylet)
        self.io.run(self.gcs._mark_node_dead(raylet.node_id.binary(), "removed"))

    def kill_raylet(self, raylet: Raylet):
        """Node failure without graceful teardown: the raylet's services
        stop abruptly, its workers are SIGKILLed, and the GCS discovers the
        death through the dropped connection (chaos testing, reference:
        test_utils.py RayletKiller :1446)."""
        self.io.run(raylet.kill(), timeout=10)
        self.raylets.remove(raylet)
        self.io.run(self.gcs._mark_node_dead(raylet.node_id.binary(), "killed"))

    def shutdown(self):
        if self._client is not None:
            try:
                self._client.disconnect()
            except Exception:
                pass
            worker_mod.set_client(None, None)
        for raylet in list(self.raylets):
            try:
                self.io.run(raylet.stop(), timeout=10)
            except Exception:
                pass
        self.raylets.clear()
        try:
            self.io.run(self.gcs.stop(), timeout=5)
        except Exception:
            pass
        self.io.stop()
