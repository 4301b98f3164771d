"""Node providers: how the autoscaler creates/terminates hosts.

Analog of the reference's ``NodeProvider`` ABC
(python/ray/autoscaler/node_provider.py) and the offline test provider
(autoscaler/_private/fake_multi_node/node_provider.py — "nodes" are local
processes so autoscaler logic is testable without a cloud).

A *node type* describes one host class; a node type that sets
``slice_hosts`` > 1 is a slice, and the provider must create/terminate
its hosts atomically — a partial slice is useless to SPMD jobs (the
reference reaches the same effect through GKE TPU node pools). The GKE
and GCE providers keep the TPU REST surfaces of the JAX package.

GPU framing: a node type's ``GPU`` resource is the count of cards its
raylet advertises, and no more: a process node of a type that names no
GPU advertises none, even on a host whose cards its raylet would detect.
"""

from __future__ import annotations

import abc
from typing import Dict, List, Optional


class NodeProvider(abc.ABC):
    """Minimal provider surface the autoscaler drives."""

    @abc.abstractmethod
    def create_node(self, node_type: str, node_config: Dict, count: int) -> List[str]:
        """Launch `count` hosts of `node_type`; returns provider node ids."""

    @abc.abstractmethod
    def terminate_node(self, provider_node_id: str) -> None:
        ...

    @abc.abstractmethod
    def non_terminated_nodes(self) -> List[str]:
        ...

    @abc.abstractmethod
    def node_tags(self, provider_node_id: str) -> Dict[str, str]:
        """Must include "rt-node-type"; includes "rt-node-id" (hex) once
        the raylet on that host has registered."""


class FakeMultiNodeProvider(NodeProvider):
    """Boots raylets in-process against a live GCS (offline testing).

    The reference's fake provider launches local processes; here the
    cluster harness's event loop hosts extra raylet control loops, which
    is exactly how multi-node tests run (cluster_utils.Cluster).
    """

    def __init__(self, io_loop_thread, gcs_host: str, gcs_port: int):
        self.io = io_loop_thread
        self.gcs_host, self.gcs_port = gcs_host, gcs_port
        self._nodes: Dict[str, dict] = {}  # provider id -> {raylet, type}
        self._counter = 0

    def create_node(self, node_type: str, node_config: Dict, count: int) -> List[str]:
        from ray_tpu_torch._private.raylet import Raylet

        created = []
        for _ in range(count):
            raylet = Raylet(
                self.gcs_host,
                self.gcs_port,
                dict(node_config.get("resources", {"CPU": 1})),
                labels={"rt-node-type": node_type},
            )
            self.io.run(raylet.start())
            self._counter += 1
            pid = f"fake-{node_type}-{self._counter}"
            self._nodes[pid] = {"raylet": raylet, "type": node_type}
            created.append(pid)
        return created

    def terminate_node(self, provider_node_id: str) -> None:
        node = self._nodes.pop(provider_node_id, None)
        if node is None:
            return
        try:
            self.io.run(node["raylet"].stop(), timeout=10)
        except Exception:
            pass

    def non_terminated_nodes(self) -> List[str]:
        return list(self._nodes)

    def node_tags(self, provider_node_id: str) -> Dict[str, str]:
        node = self._nodes.get(provider_node_id)
        if node is None:
            return {}
        return {
            "rt-node-type": node["type"],
            "rt-node-id": node["raylet"].node_id.hex(),
        }


class ProcessNodeProvider(NodeProvider):
    """Launches each node as a real raylet SUBPROCESS against a live GCS —
    the reference's fake_multi_node pattern
    (autoscaler/_private/fake_multi_node/node_provider.py): full process
    isolation, so autoscaler e2e tests exercise the same join/heartbeat/
    death paths a real cloud node takes."""

    def __init__(self, gcs_host: str, gcs_port: int):
        self.gcs_host, self.gcs_port = gcs_host, gcs_port
        self._nodes: Dict[str, dict] = {}  # provider id -> {proc, type, node_id}
        self._counter = 0

    def create_node(self, node_type: str, node_config: Dict, count: int) -> List[str]:
        import json
        import subprocess
        import sys

        created = []
        for _ in range(count):
            self._counter += 1
            pid = f"proc-{node_type}-{self._counter}"
            # The raylet adds every card it detects unless told a count:
            # give it the type's GPU count (0 where the type names none),
            # so it also adds the card's type label only where it has one.
            resources = dict(node_config.get("resources", {"CPU": 1}))
            num_gpus = resources.pop("GPU", 0)
            proc = subprocess.Popen(
                [
                    sys.executable, "-m", "ray_tpu_torch._private.raylet",
                    "--gcs-host", self.gcs_host,
                    "--gcs-port", str(self.gcs_port),
                    "--resources", json.dumps(resources),
                    "--num-gpus", str(num_gpus),
                    "--labels", json.dumps({"rt-node-type": node_type}),
                ],
                stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL,
                text=True,
            )
            node_id = None
            for line in proc.stdout:  # startup banner
                if line.startswith("RAYLET_NODE_ID="):
                    node_id = line.strip().split("=", 1)[1]
                if line.startswith("RAYLET_STORE="):
                    break
            # Keep draining stdout forever: workers inherit this pipe and
            # a full (unread) 64KB pipe blocks their print()s — wedging
            # tasks with no diagnostic.
            import threading

            threading.Thread(
                target=lambda s=proc.stdout: [None for _ in s],
                daemon=True,
            ).start()
            self._nodes[pid] = {"proc": proc, "type": node_type,
                                "node_id": node_id}
            created.append(pid)
        return created

    def terminate_node(self, provider_node_id: str) -> None:
        node = self._nodes.pop(provider_node_id, None)
        if node is None:
            return
        node["proc"].terminate()
        try:
            node["proc"].wait(timeout=10)
        except Exception:  # noqa: BLE001
            node["proc"].kill()

    def non_terminated_nodes(self) -> List[str]:
        # A crashed raylet process counts as terminated (cloud-instance
        # failure surface the reconciler must observe).
        return [
            pid for pid, n in self._nodes.items()
            if n["proc"].poll() is None
        ]

    def node_tags(self, provider_node_id: str) -> Dict[str, str]:
        node = self._nodes.get(provider_node_id)
        if node is None:
            return {}
        return {
            "rt-node-type": node["type"],
            "rt-node-id": node["node_id"] or "",
        }

    def shutdown(self):
        for pid in list(self._nodes):
            self.terminate_node(pid)


class GoogleCloudTransport:  # pragma: no cover - needs GCP network
    """Default HTTP transport for GKETPUNodeProvider: Bearer-token REST
    calls against the container/compute APIs, token from the GCE metadata
    server. Injectable so the provider is fully testable offline (the
    reference's fake-provider pattern, autoscaler/_private/fake_multi_node)."""

    METADATA_TOKEN_URL = (
        "http://metadata.google.internal/computeMetadata/v1/instance/"
        "service-accounts/default/token"
    )

    def __init__(self, token_provider=None):
        self._token_provider = token_provider or self._metadata_token

    def _metadata_token(self) -> str:
        import json as _json
        import urllib.request

        req = urllib.request.Request(
            self.METADATA_TOKEN_URL, headers={"Metadata-Flavor": "Google"}
        )
        with urllib.request.urlopen(req, timeout=10) as resp:
            return _json.loads(resp.read())["access_token"]

    def request(self, method: str, url: str, body: Optional[dict] = None) -> dict:
        import json as _json
        import urllib.request

        data = _json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            url,
            data=data,
            method=method,
            headers={
                "Authorization": f"Bearer {self._token_provider()}",
                "Content-Type": "application/json",
            },
        )
        with urllib.request.urlopen(req, timeout=30) as resp:
            payload = resp.read()
            return _json.loads(payload) if payload else {}


class GKETPUNodeProvider(NodeProvider):
    """GKE TPU slice node pools as autoscaler nodes.

    Mapping (reference: autoscaler/_private/gcp/node_provider.py +
    kuberay TPU webhook semantics):
      * a node type's ``node_config`` names its GKE ``node_pool``; a TPU
        slice type also sets ``slice_hosts`` (hosts per slice);
      * ``create_node(type, cfg, count)`` resizes the pool UP by
        ``count * slice_hosts`` via ``nodePools/:setSize`` — slices are
        whole-pool-increment atomic, a partial slice is useless to SPMD;
      * ``terminate_node`` deletes the slice's VMs through the pool's
        instance-group manager (``deleteInstances``), shrinking the pool;
      * provider node ids are ``{pool}|{instance-url}``.

    All API traffic flows through the injected ``transport.request(method,
    url, body) -> dict`` so tests drive the provider against a recorded
    API surface; production uses GoogleCloudTransport.
    """

    CONTAINER = "https://container.googleapis.com/v1"

    def __init__(self, project: str, zone: str, cluster: str, transport=None,
                 poll_interval_s: float = 2.0, op_timeout_s: float = 600.0,
                 managed_pools: Optional[List[str]] = None):
        self.project, self.zone, self.cluster = project, zone, cluster
        self.transport = transport or GoogleCloudTransport()
        self.poll_interval_s = poll_interval_s
        self.op_timeout_s = op_timeout_s
        # Which pools this provider owns. Explicit list survives a head
        # restart; None = discover every pool from the cluster API — the
        # live API, never in-process memory, is the source of truth for
        # node enumeration (a restarted provider must still see running
        # TPU slices or the autoscaler double-pays for them).
        self._managed_pools = list(managed_pools) if managed_pools else None
        self._tags: Dict[str, Dict[str, str]] = {}  # advisory type tags

    # -- REST helpers -----------------------------------------------------
    def _cluster_path(self) -> str:
        return (
            f"{self.CONTAINER}/projects/{self.project}/zones/{self.zone}/"
            f"clusters/{self.cluster}"
        )

    def _pool(self, pool: str) -> dict:
        return self.transport.request(
            "GET", f"{self._cluster_path()}/nodePools/{pool}"
        )

    def _wait_op(self, op: dict) -> None:
        """Poll a container Operation until DONE (setSize is async)."""
        import time

        name = op.get("name")
        if not name or op.get("status") == "DONE":
            return
        url = (
            f"{self.CONTAINER}/projects/{self.project}/zones/{self.zone}/"
            f"operations/{name}"
        )
        deadline = time.monotonic() + self.op_timeout_s
        while time.monotonic() < deadline:
            cur = self.transport.request("GET", url)
            if cur.get("status") == "DONE":
                if cur.get("error"):
                    raise RuntimeError(f"GKE operation {name} failed: {cur['error']}")
                return
            time.sleep(self.poll_interval_s)
        raise TimeoutError(f"GKE operation {name} not DONE after {self.op_timeout_s}s")

    def _managed_instances(self, pool: str) -> List[str]:
        """Instance URLs behind a pool's instance group manager(s)."""
        info = self._pool(pool)
        urls = []
        for ig_url in info.get("instanceGroupUrls", []):
            # ..../instanceGroupManagers/{name} — listManagedInstances is a
            # POST on the compute API.
            resp = self.transport.request(
                "POST", ig_url + "/listManagedInstances", {}
            )
            urls.extend(
                mi["instance"] for mi in resp.get("managedInstances", [])
            )
        return urls

    # -- NodeProvider surface --------------------------------------------
    def create_node(self, node_type: str, node_config: Dict, count: int) -> List[str]:
        pool = node_config["node_pool"]
        slice_hosts = int(node_config.get("slice_hosts", 1))
        # Current size = the LIVE instance list. initialNodeCount is
        # immutable creation-time metadata: trusting it on a pool that
        # has since shrunk would over-provision whole (billed) slices.
        before = set(self._managed_instances(pool))
        target = len(before) + count * slice_hosts
        op = self.transport.request(
            "POST",
            f"{self._cluster_path()}/nodePools/{pool}:setSize",
            {"nodeCount": target},
        )
        self._wait_op(op)
        after = self._managed_instances(pool)
        new = [u for u in after if u not in before]
        ids = [f"{pool}|{u}" for u in new]
        for nid in ids:
            self._tags[nid] = {"rt-node-type": node_type,
                               "rt-node-pool": pool}
        return ids

    def terminate_node(self, provider_node_id: str) -> None:
        pool, _, instance_url = provider_node_id.partition("|")
        info = self._pool(pool)
        for ig_url in info.get("instanceGroupUrls", []):
            # Multi-zonal pools have several IGMs; only the one actually
            # holding the instance accepts the delete (the others 4xx).
            # An accepted request returns a compute Operation — in ANY
            # state (PENDING/RUNNING/DONE) the deletion is underway.
            try:
                self.transport.request(
                    "POST",
                    ig_url + "/deleteInstances",
                    {"instances": [instance_url]},
                )
                break
            except Exception:  # noqa: BLE001 — wrong IGM for this instance
                continue
        self._tags.pop(provider_node_id, None)

    def _pools(self) -> List[str]:
        if self._managed_pools is not None:
            return self._managed_pools
        resp = self.transport.request(
            "GET", f"{self._cluster_path()}/nodePools"
        )
        return [p["name"] for p in resp.get("nodePools", [])]

    def non_terminated_nodes(self) -> List[str]:
        out = []
        for pool in self._pools():
            out.extend(f"{pool}|{u}" for u in self._managed_instances(pool))
        return out

    def node_tags(self, provider_node_id: str) -> Dict[str, str]:
        tags = dict(self._tags.get(provider_node_id, {}))
        tags.setdefault("rt-node-pool", provider_node_id.split("|", 1)[0])
        return tags


class GCETPUNodeProvider(NodeProvider):
    """Direct (non-GKE) TPU VMs via the Cloud TPU API — the most common
    real TPU deployment (reference pattern:
    autoscaler/_private/gcp/node_provider.py, which splits compute vs
    tpu resources; here the provider IS the tpu.googleapis.com surface).

    Mapping:
      * one TPU API ``node`` IS one slice (multi-host slices are a
        single node resource with several worker endpoints), so slice
        atomicity is the API's own granularity — create/delete always
        moves whole slices;
      * ``node_config``: ``accelerator_type`` (e.g. "v5litepod-16"),
        ``runtime_version``, optional ``network``, ``labels``,
        ``metadata`` (startup script that runs `rt start` and joins the
        cluster);
      * provider node ids are the TPU node names; tags ride TPU labels
        (``rt-managed``/``rt-node-type``), so a RESTARTED provider
        re-discovers its fleet from the live API — never from memory.

    All traffic flows through the injected ``transport.request`` so
    tests drive a recorded API surface; production uses
    GoogleCloudTransport (same bearer-token REST as GKE).
    """

    TPU = "https://tpu.googleapis.com/v2"
    # Node states that hold (or will hold) real capacity. STOPPED slices
    # keep their name reserved -> still "non-terminated" for the
    # autoscaler's accounting.
    LIVE_STATES = ("CREATING", "READY", "STARTING", "STOPPING", "STOPPED",
                   "REPAIRING")

    def __init__(self, project: str, zone: str, transport=None,
                 name_prefix: str = "rt-tpu",
                 poll_interval_s: float = 2.0, op_timeout_s: float = 900.0):
        self.project, self.zone = project, zone
        self.transport = transport or GoogleCloudTransport()
        self.name_prefix = name_prefix
        self.poll_interval_s = poll_interval_s
        self.op_timeout_s = op_timeout_s
        self._list_cache = None  # (monotonic_ts, nodes) — one per tick

    def _parent(self) -> str:
        return f"{self.TPU}/projects/{self.project}/locations/{self.zone}"

    def _wait_op(self, op: dict) -> dict:
        import time

        name = op.get("name")
        if not name or op.get("done"):
            if op.get("error"):
                raise RuntimeError(f"TPU operation failed: {op['error']}")
            return op
        deadline = time.monotonic() + self.op_timeout_s
        while time.monotonic() < deadline:
            cur = self.transport.request("GET", f"{self.TPU}/{name}")
            if cur.get("done"):
                if cur.get("error"):
                    raise RuntimeError(
                        f"TPU operation {name} failed: {cur['error']}"
                    )
                return cur
            time.sleep(self.poll_interval_s)
        raise TimeoutError(
            f"TPU operation {name} not done after {self.op_timeout_s}s"
        )

    # -- NodeProvider surface --------------------------------------------
    def create_node(self, node_type: str, node_config: Dict,
                    count: int) -> List[str]:
        import uuid

        ids = []
        for _ in range(count):
            node_id = f"{self.name_prefix}-{uuid.uuid4().hex[:8]}"
            body = {
                "acceleratorType": node_config["accelerator_type"],
                "runtimeVersion": node_config.get(
                    "runtime_version", "tpu-ubuntu2204-base"
                ),
                "labels": {
                    "rt-managed": "1",
                    "rt-node-type": node_type,
                    **(node_config.get("labels") or {}),
                },
            }
            if node_config.get("network"):
                body["networkConfig"] = {"network": node_config["network"]}
            if node_config.get("metadata"):
                body["metadata"] = dict(node_config["metadata"])
            op = self.transport.request(
                "POST", f"{self._parent()}/nodes?nodeId={node_id}", body
            )
            # Waiting per slice keeps failures attributable: a quota
            # denial names the slice it refused instead of surfacing
            # three creates later.
            self._wait_op(op)
            ids.append(node_id)
        self._list_cache = None
        return ids

    def terminate_node(self, provider_node_id: str) -> None:
        # Fire-and-forget like the GKE provider: once the DELETE is
        # accepted the teardown is underway (slices take minutes to
        # die; waiting would freeze the autoscaler's reconcile loop),
        # and a node deleted out-of-band (404) is already the desired
        # state. Completion is observed by the state filter in _nodes.
        try:
            self.transport.request(
                "DELETE", f"{self._parent()}/nodes/{provider_node_id}"
            )
        except Exception:  # noqa: BLE001 — already gone / in teardown
            pass
        self._list_cache = None

    def _nodes(self) -> List[dict]:
        # One fleet listing serves a whole reconcile tick: both
        # autoscalers call node_tags per node right after
        # non_terminated_nodes, which would otherwise be N+1 full list
        # requests against the Cloud TPU API quota.
        import time

        cached = getattr(self, "_list_cache", None)
        if cached is not None and time.monotonic() - cached[0] < 5.0:
            return cached[1]
        resp = self.transport.request("GET", f"{self._parent()}/nodes")
        out = []
        for node in resp.get("nodes", []):
            labels = node.get("labels") or {}
            if labels.get("rt-managed") != "1":
                continue
            if node.get("state") not in self.LIVE_STATES:
                continue
            out.append(node)
        self._list_cache = (time.monotonic(), out)
        return out

    def non_terminated_nodes(self) -> List[str]:
        # name is "projects/p/locations/z/nodes/{id}".
        return [n["name"].rsplit("/", 1)[1] for n in self._nodes()]

    def node_tags(self, provider_node_id: str) -> Dict[str, str]:
        for node in self._nodes():
            if node["name"].rsplit("/", 1)[1] == provider_node_id:
                labels = node.get("labels") or {}
                return {
                    "rt-node-type": labels.get("rt-node-type", ""),
                    "rt-state": node.get("state", ""),
                    "rt-workers": str(
                        len(node.get("networkEndpoints") or []) or 1
                    ),
                }
        return {}


def make_node_provider(provider_config: Dict, **runtime_kwargs) -> NodeProvider:
    """Provider registry (reference: autoscaler/_private/providers.py
    _get_node_provider): maps a config ``type`` to a provider class.

    runtime_kwargs carries environment handles some providers need
    (ProcessNodeProvider's gcs_host/gcs_port); cloud providers take
    everything from the config dict.
    """
    ptype = (provider_config or {}).get("type", "process")
    cfg = dict(provider_config or {})
    cfg.pop("type", None)
    if ptype == "gke":
        return GKETPUNodeProvider(
            cfg.pop("project"), cfg.pop("zone"), cfg.pop("cluster"), **cfg
        )
    if ptype in ("gce_tpu", "tpu_vm"):
        return GCETPUNodeProvider(cfg.pop("project"), cfg.pop("zone"), **cfg)
    if ptype == "process":
        return ProcessNodeProvider(
            runtime_kwargs["gcs_host"], runtime_kwargs["gcs_port"]
        )
    raise ValueError(
        f"unknown provider type {ptype!r}: expected gke / gce_tpu / process"
    )
