"""The autoscaler control loop.

Analog of the reference's ``StandardAutoscaler``
(autoscaler/_private/autoscaler.py:171) driven by the head-node Monitor
(_private/monitor.py:126), with the demand binpacking of
resource_demand_scheduler.py: unmet task demand bundles are packed onto
node types to decide scale-up; idle provider nodes past the timeout are
drained and terminated for scale-down.

Slices: a node type with ``slice_hosts`` N scales in whole slices — N
hosts are created (and terminated) together, because a partial slice
cannot run SPMD programs.

Config shape (mirrors the reference's YAML ``available_node_types``):

    {
      "node_types": {
        "cpu-worker": {"resources": {"CPU": 4}, "min_workers": 0,
                        "max_workers": 10},
        "gpu-worker": {"resources": {"CPU": 1, "GPU": 1},
                        "max_workers": 1},
        "gpu-slice":  {"resources": {"GPU": 4}, "slice_hosts": 4,
                        "max_workers": 2},   # max 2 slices = 8 hosts
      },
      "idle_timeout_s": 60,
    }
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ray_tpu_torch._private.node import EventLoopThread
from ray_tpu_torch._private.protocol import connect
from ray_tpu_torch.autoscaler.node_provider import NodeProvider


def _fits(bundle: Dict[str, float], free: Dict[str, float]) -> bool:
    return all(free.get(k, 0) + 1e-9 >= v for k, v in bundle.items())


def _claim(bundle: Dict[str, float], free: Dict[str, float]):
    for k, v in bundle.items():
        free[k] = free.get(k, 0) - v


class StandardAutoscaler:
    def __init__(
        self,
        config: Dict,
        provider: NodeProvider,
        gcs_address: str,
        io: Optional[EventLoopThread] = None,
    ):
        self.config = config
        self.provider = provider
        self.node_types: Dict[str, dict] = config.get("node_types", {})
        self.idle_timeout_s = config.get("idle_timeout_s", 60.0)
        self._own_io = io is None
        self.io = io or EventLoopThread("rt-autoscaler")
        host, port = gcs_address.rsplit(":", 1)
        self.gcs = self.io.run(connect(host, int(port)))
        self._idle_since: Dict[str, float] = {}  # provider id -> ts
        # Launched but not yet registered: count toward limits so one burst
        # of updates doesn't over-launch.
        self._starting: Dict[str, List[str]] = {t: [] for t in self.node_types}
        # Slice membership for slice_hosts>1 types: type -> list of pid
        # groups created together. Scale-down is slice-atomic: a group is
        # terminated only when every host in it has idled past the timeout.
        self._slice_groups: Dict[str, List[List[str]]] = {}
        self._warned_unplaceable: set = set()
        self._warned_untracked_slice: set = set()

    def close(self):
        try:
            self.io.run(self.gcs.close(), timeout=5)
        except Exception:
            pass
        if self._own_io:
            self.io.stop()

    # -- state ------------------------------------------------------------
    def _cluster_nodes(self) -> List[dict]:
        return self.io.run(self.gcs.call("get_nodes", {}))["nodes"]

    def _provider_view(self):
        """provider id -> {type, node_id(hex or None)}; prunes _starting."""
        view = {}
        for pid in self.provider.non_terminated_nodes():
            tags = self.provider.node_tags(pid)
            view[pid] = {
                "type": tags.get("rt-node-type"),
                "node_id": tags.get("rt-node-id"),
            }
        for t, pids in self._starting.items():
            self._starting[t] = [p for p in pids if p in view]
        return view

    def _count_by_type(self, view) -> Dict[str, int]:
        counts = {t: 0 for t in self.node_types}
        for info in view.values():
            if info["type"] in counts:
                counts[info["type"]] += 1
        return counts

    # -- the decision step ------------------------------------------------
    def update(self) -> Dict[str, int]:
        """One reconcile pass. Returns {node_type: hosts_launched}."""
        nodes = self._cluster_nodes()
        alive = [n for n in nodes if n["state"] == "ALIVE"]
        view = self._provider_view()
        launched: Dict[str, int] = {}

        # ---- scale up: binpack unmet demand --------------------------
        free_per_node = [dict(n.get("resources_available", {})) for n in alive]
        unmet: List[Dict[str, float]] = []
        for n in alive:
            for bundle in n.get("demand_bundles", []) or []:
                placed = False
                for free in free_per_node:
                    if _fits(bundle, free):
                        _claim(bundle, free)
                        placed = True
                        break
                if not placed:
                    unmet.append(bundle)

        if unmet:
            counts = self._count_by_type(view)
            # Pending capacity from still-starting nodes absorbs demand.
            pending_free = []
            for t, pids in self._starting.items():
                spec = self.node_types.get(t, {})
                for pid in pids:
                    if view.get(pid, {}).get("node_id") is None:
                        pending_free.append(dict(spec.get("resources", {})))
            to_launch: Dict[str, int] = {}
            for bundle in unmet:
                placed = False
                for free in pending_free:
                    if _fits(bundle, free):
                        _claim(bundle, free)
                        placed = True
                        break
                if placed:
                    continue
                for t, spec in self.node_types.items():
                    res = spec.get("resources", {})
                    if not _fits(bundle, dict(res)):
                        continue
                    slice_hosts = spec.get("slice_hosts", 1)
                    in_use = counts.get(t, 0) + to_launch.get(t, 0) * slice_hosts
                    max_hosts = spec.get("max_workers", 2**31) * slice_hosts
                    if in_use + slice_hosts > max_hosts:
                        continue
                    to_launch[t] = to_launch.get(t, 0) + 1
                    free = dict(res)
                    _claim(bundle, free)
                    pending_free.append(free)
                    for _ in range(slice_hosts - 1):
                        pending_free.append(dict(res))
                    placed = True
                    break
                if not placed:
                    key = tuple(sorted(bundle.items()))
                    if key not in self._warned_unplaceable:
                        self._warned_unplaceable.add(key)
                        import sys

                        print(
                            "[ray_tpu_torch autoscaler] WARNING: demand "
                            f"{bundle} fits no configured node type (or all "
                            "types are at max_workers); the task will stay "
                            "pending.",
                            file=sys.stderr, flush=True,
                        )
            for t, groups in to_launch.items():
                spec = self.node_types[t]
                slice_hosts = spec.get("slice_hosts", 1)
                n_hosts = groups * slice_hosts
                pids = self.provider.create_node(t, spec, n_hosts)
                self._starting.setdefault(t, []).extend(pids)
                self._record_slices(t, slice_hosts, pids)
                launched[t] = launched.get(t, 0) + n_hosts

        # ---- enforce min_workers -------------------------------------
        counts = self._count_by_type(self._provider_view())
        for t, spec in self.node_types.items():
            slice_hosts = spec.get("slice_hosts", 1)
            min_hosts = spec.get("min_workers", 0) * slice_hosts
            if counts.get(t, 0) < min_hosts:
                # Round up to whole slices: a partial slice is useless.
                need = min_hosts - counts.get(t, 0)
                need = -(-need // slice_hosts) * slice_hosts
                pids = self.provider.create_node(t, spec, need)
                self._starting.setdefault(t, []).extend(pids)
                self._record_slices(t, slice_hosts, pids)
                launched[t] = launched.get(t, 0) + need

        # ---- scale down: idle past timeout ---------------------------
        by_node_id = {n["node_id"].hex() if isinstance(n["node_id"], bytes)
                      else n["node_id"]: n for n in alive}
        now = time.monotonic()
        view = self._provider_view()
        counts = self._count_by_type(view)

        def idle_expired(pid, info):
            """True once the host has been idle past the timeout."""
            node = by_node_id.get(info.get("node_id") or "")
            if node is None:
                return False  # still starting
            idle = (
                not node.get("demand_bundles")
                and node.get("resources_available") == node.get("resources_total")
            )
            if not idle:
                self._idle_since.pop(pid, None)
                return False
            first = self._idle_since.setdefault(pid, now)
            return now - first > self.idle_timeout_s

        # Single-host node types terminate host by host.
        for pid, info in view.items():
            spec = self.node_types.get(info["type"] or "", {})
            if spec.get("slice_hosts", 1) > 1:
                continue
            if (
                idle_expired(pid, info)
                and counts.get(info["type"], 0) - 1 >= spec.get("min_workers", 0)
            ):
                self._drain_and_terminate(pid, info)
                counts[info["type"]] = counts.get(info["type"], 0) - 1

        # Slice types terminate whole slices, and only when EVERY host of
        # the slice has idled past the timeout: a partial slice cannot run
        # SPMD programs, so per-host scale-down would strand capacity.
        for t, spec in self.node_types.items():
            slice_hosts = spec.get("slice_hosts", 1)
            if slice_hosts <= 1:
                continue
            min_hosts = spec.get("min_workers", 0) * slice_hosts
            for group in self._live_slice_groups(t, slice_hosts, view):
                # Evaluate EVERY host (no short-circuit): idle_expired also
                # clears a busy host's stale idle timer, and skipping that
                # reset would let a pre-busy timer expire the slice.
                statuses = [idle_expired(pid, view[pid]) for pid in group]
                if not all(statuses):
                    continue
                if counts.get(t, 0) - len(group) < min_hosts:
                    continue
                for pid in group:
                    self._drain_and_terminate(pid, view[pid])
                counts[t] = counts.get(t, 0) - len(group)
                self._slice_groups[t].remove(group)
        return launched

    # -- slice bookkeeping -------------------------------------------------
    def _record_slices(self, t: str, slice_hosts: int, pids: List[str]):
        """Remember which provider hosts were created together as slices."""
        if slice_hosts <= 1:
            return
        groups = self._slice_groups.setdefault(t, [])
        for i in range(0, len(pids), slice_hosts):
            groups.append(list(pids[i:i + slice_hosts]))

    def _live_slice_groups(self, t: str, slice_hosts: int, view) -> List[List[str]]:
        """Recorded slice groups pruned to live hosts; adopts untracked ones.

        Hosts of a slice type with no recorded group (e.g. they predate this
        autoscaler process) are chunked into slices in sorted order so they
        can still be scaled down atomically rather than leaking forever.
        """
        live = {pid for pid, info in view.items() if info["type"] == t}
        groups: List[List[str]] = []
        tracked: set = set()
        for g in self._slice_groups.get(t, []):
            g2 = [p for p in g if p in live]
            if g2:
                groups.append(g2)
                tracked.update(g2)
        untracked = sorted(live - tracked)
        if untracked:
            if t not in self._warned_untracked_slice:
                self._warned_untracked_slice.add(t)
                import sys

                print(
                    "[ray_tpu_torch autoscaler] WARNING: "
                    f"{len(untracked)} hosts of slice type {t!r} have no "
                    "recorded slice group; adopting them in sorted order "
                    "for slice-atomic scale-down.",
                    file=sys.stderr, flush=True,
                )
            for i in range(0, len(untracked), slice_hosts):
                groups.append(untracked[i:i + slice_hosts])
        self._slice_groups[t] = groups
        return list(groups)

    def _drain_and_terminate(self, pid: str, info: dict):
        node_id = info.get("node_id")
        if node_id:
            try:
                self.io.run(
                    self.gcs.call(
                        "drain_node", {"node_id": bytes.fromhex(node_id)}
                    ),
                    timeout=10,
                )
            except Exception:
                pass
        self.provider.terminate_node(pid)
        self._idle_since.pop(pid, None)
