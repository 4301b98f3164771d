"""Unified memory accounting: card memory + host object store.

A training or serving job's memory lives in two pools: the card's
(torch tensors in the CUDA caching allocator — invisible to the object
store) and plasma (host shared memory — invisible to torch). OOMs on
either side get diagnosed by the other side's numbers unless someone
joins them. This module is the join:

  * device_memory() — this process's per-card view, from the caching
    allocator (`torch.cuda.memory_allocated`, `memory_stats`,
    `memory_reserved`, `max_memory_reserved`) and the card's total
    (`mem_get_info`), under the gauge names the JAX package uses
    (`device_hbm_*`). A card is tagged by its physical id.
  * MemoryAccountant / sample_once() — publish that view as node+device
    tagged gauges through the existing metrics stream, so the driver,
    `rt memory --devices` and `rt top` read one source.
  * memory_summary() — the cluster-unified view assembled from the GCS:
    card gauges from every sampling process, per-node plasma usage from
    the raylet's `rt_raylet_store_used_bytes` gauge, and the object
    listing's primary-copy totals from the state API.

Reference analog: `ray memory` / memory_utils.py group object stats per
node; the card half has no reference analog.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Any, Dict, List, Optional

from ray_tpu_torch.util import metrics as _metrics

_gauges_lock = threading.Lock()
_gauges: Optional[Dict[str, Any]] = None


def _hbm_gauges() -> Dict[str, Any]:
    global _gauges
    with _gauges_lock:
        if _gauges is None:
            _gauges = {
                "live": _metrics.get_or_create(
                    _metrics.Gauge, "device_hbm_live_bytes",
                    "Bytes of live torch tensors resident per card "
                    "(torch.cuda.memory_allocated).",
                    tag_keys=("node", "device"),
                ),
                "arrays": _metrics.get_or_create(
                    _metrics.Gauge, "device_hbm_live_arrays",
                    "Count of live allocations per card "
                    "(memory_stats allocation.all.current).",
                    tag_keys=("node", "device"),
                ),
                "in_use": _metrics.get_or_create(
                    _metrics.Gauge, "device_hbm_in_use_bytes",
                    "Caching-allocator bytes reserved per card "
                    "(torch.cuda.memory_reserved).",
                    tag_keys=("node", "device"),
                ),
                "limit": _metrics.get_or_create(
                    _metrics.Gauge, "device_hbm_limit_bytes",
                    "Total bytes of the card (torch.cuda.mem_get_info).",
                    tag_keys=("node", "device"),
                ),
            }
        return _gauges


def _node_tag() -> str:
    from ray_tpu_torch._private import worker as worker_mod

    client = worker_mod.get_client_or_none()
    if client is not None and getattr(client, "node_id", None):
        return client.node_id.hex()[:12]
    return "-"


def _physical_id(index: int) -> str:
    """The physical card id of local CUDA index `index`: the raylet
    confines each GPU worker through CUDA_VISIBLE_DEVICES, so every
    worker's card is its local 0."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible:
        ids = [v.strip() for v in visible.split(",") if v.strip()]
        if index < len(ids):
            return ids[index]
    return str(index)


def device_memory() -> List[Dict[str, Any]]:
    """Per-card memory view of THIS process: one dict per card it has
    initialised (the current card, and any other holding reserved
    memory). Empty where torch is not imported or CUDA not initialised:
    it never creates a CUDA context (the zygote forks every worker, and
    the control-plane processes load no torch)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return []
    cuda = torch.cuda
    current = cuda.current_device()
    out = []
    for i in range(cuda.device_count()):
        if i != current and cuda.memory_reserved(i) == 0:
            continue
        stats = cuda.memory_stats(i)
        out.append({
            "device": f"cuda:{_physical_id(i)}",
            "kind": cuda.get_device_name(i),
            "live_bytes": int(cuda.memory_allocated(i)),
            "live_arrays": int(stats.get("allocation.all.current", 0)),
            "bytes_in_use": int(cuda.memory_reserved(i)),
            "peak_bytes_in_use": int(cuda.max_memory_reserved(i)),
            "bytes_limit": int(cuda.mem_get_info(i)[1]),
        })
    return out


def sample_once() -> List[Dict[str, Any]]:
    """Take one device-memory sample and publish it as gauges; returns
    the sample. Call from any process holding card tensors (training
    workers, serving engines) — each publishes under its own node tag."""
    sample = device_memory()
    if not sample:
        return sample
    g = _hbm_gauges()
    node = _node_tag()
    for entry in sample:
        tags = {"node": node, "device": entry["device"]}
        g["live"].set(float(entry["live_bytes"]), tags=tags)
        g["arrays"].set(float(entry["live_arrays"]), tags=tags)
        if "bytes_in_use" in entry:
            g["in_use"].set(float(entry["bytes_in_use"]), tags=tags)
        if "bytes_limit" in entry:
            g["limit"].set(float(entry["bytes_limit"]), tags=tags)
    return sample


def _sample_loop(stop_event: threading.Event, interval_s: float) -> None:
    """Sampler-thread body (module function per RT006: communicates with
    the owner only through the stop event; gauges are process-global)."""
    while not stop_event.wait(interval_s):
        try:
            sample_once()
        except Exception:  # noqa: BLE001 — sampling must never kill the host  # rtlint: disable=RT007
            pass


class MemoryAccountant:
    """Background card-memory sampler: publishes this process's device gauges
    every `interval_s` until stop() (or GC — daemon thread). One per
    process is enough; the gauges are process-global."""

    def __init__(self, interval_s: float = 5.0):
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=_sample_loop, args=(self._stop, interval_s),
            name="rt-mem-accountant", daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)


def _snapshot_metrics(address: Optional[str]) -> Dict[str, Dict]:
    """{name: {tags_tuple: value}} for the gauges memory_summary reads."""
    from ray_tpu_torch.util.state.api import StateApiClient

    client = StateApiClient(address)
    try:
        snapshot = client.call("metrics_snapshot")["metrics"]
    finally:
        client.close()
    out: Dict[str, Dict] = {}
    for m in snapshot:
        series = {}
        for tags, val in m["series"]:
            series[tuple(sorted((k, v) for k, v in tags))] = val
        out[m["name"]] = series
    return out


def memory_summary(address: Optional[str] = None) -> Dict[str, Any]:
    """Cluster-unified memory view: every sampled card's gauges,
    per-node object-store usage, and the object table's primary-copy
    totals — one dict, one source for CLI/dashboard rendering."""
    from ray_tpu_torch.util.state import api as state_api

    snap = _snapshot_metrics(address)

    devices: Dict[tuple, Dict[str, Any]] = {}
    for metric, field in (
        ("device_hbm_live_bytes", "live_bytes"),
        ("device_hbm_live_arrays", "live_arrays"),
        ("device_hbm_in_use_bytes", "bytes_in_use"),
        ("device_hbm_limit_bytes", "bytes_limit"),
    ):
        for tags, val in snap.get(metric, {}).items():
            td = dict(tags)
            key = (td.get("node", "-"), td.get("device", "?"))
            d = devices.setdefault(
                key, {"node": key[0], "device": key[1]}
            )
            d[field] = int(val)

    per_node_store: Dict[str, Dict[str, int]] = {}
    for tags, val in snap.get("rt_raylet_store_used_bytes", {}).items():
        node = dict(tags).get("node", "-")
        per_node_store.setdefault(node, {})["used_bytes"] = int(val)
    for tags, val in snap.get("rt_raylet_store_objects", {}).items():
        node = dict(tags).get("node", "-")
        per_node_store.setdefault(node, {})["num_objects"] = int(val)

    objects = state_api.list_objects(address=address)
    obj_bytes = sum(o["size"] or 0 for o in objects)

    return {
        "devices": sorted(
            devices.values(), key=lambda d: (d["node"], d["device"])
        ),
        "hbm_live_bytes": sum(d.get("live_bytes", 0)
                              for d in devices.values()),
        "object_store": {
            "per_node": per_node_store,
            "used_bytes": sum(v.get("used_bytes", 0)
                              for v in per_node_store.values()),
            "num_objects": sum(v.get("num_objects", 0)
                               for v in per_node_store.values()),
        },
        "objects": {"count": len(objects), "bytes": obj_bytes},
    }
