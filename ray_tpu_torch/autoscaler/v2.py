"""Autoscaler v2: instance-manager architecture with explicit lifecycle.

Analog of the reference's autoscaler v2 (python/ray/autoscaler/v2/
instance_manager/, v2/scheduler.py, backed by GcsAutoscalerStateManager —
SURVEY.md §2.2): instead of v1's implicit "launched/running" bookkeeping,
every cloud instance is a first-class record walking an explicit state
machine, and a Reconciler makes the world match the schedule each tick:

    QUEUED -> REQUESTED -> ALLOCATED -> RAY_RUNNING
                 |              |            |
            ALLOCATION_FAILED   |       RAY_STOPPED
                 |              v            v
                 +-------> TERMINATING -> TERMINATED

The separation of concerns mirrors the reference:
  * InstanceManager  — the instance table + legal-transition enforcement
    (reference: v2/instance_manager/instance_manager.py, instance
    lifecycle in instance_storage.py / common.py Instance proto states)
  * Scheduler        — demand bundles -> per-type target counts
    (reference: v2/scheduler.py ResourceDemandScheduler)
  * Reconciler       — drives providers + observed ray state toward the
    target (reference: v2/instance_manager/reconciler.py)

Slices carry over from v1: a node type with slice_hosts = N is managed
in atomic groups of N instances (a partial slice cannot run SPMD
programs) — both scale-up and scale-down happen slice-at-a-time.
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.autoscaler.node_provider import NodeProvider

# -- instance lifecycle ------------------------------------------------------

QUEUED = "QUEUED"                      # decided, not yet requested from cloud
REQUESTED = "REQUESTED"                # provider.create_node issued
ALLOCATED = "ALLOCATED"                # cloud reports the VM up
RAY_RUNNING = "RAY_RUNNING"            # raylet registered with the GCS
RAY_STOPPED = "RAY_STOPPED"            # raylet gone (drained or died)
ALLOCATION_FAILED = "ALLOCATION_FAILED"
TERMINATING = "TERMINATING"            # provider.terminate_node issued
TERMINATED = "TERMINATED"

_LEGAL: Dict[str, Tuple[str, ...]] = {
    QUEUED: (REQUESTED, TERMINATED),
    REQUESTED: (ALLOCATED, ALLOCATION_FAILED, TERMINATING),
    ALLOCATED: (RAY_RUNNING, RAY_STOPPED, TERMINATING),
    RAY_RUNNING: (RAY_STOPPED, TERMINATING),
    RAY_STOPPED: (TERMINATING, RAY_RUNNING),
    ALLOCATION_FAILED: (QUEUED, TERMINATED),
    TERMINATING: (TERMINATED,),
    TERMINATED: (),
}


@dataclass
class Instance:
    instance_id: str
    node_type: str
    status: str = QUEUED
    cloud_id: Optional[str] = None
    slice_group: Optional[str] = None  # atomic-slice membership
    status_history: List[Tuple[str, float]] = field(default_factory=list)
    idle_since: Optional[float] = None

    def age_in_status(self) -> float:
        if not self.status_history:
            return 0.0
        return time.monotonic() - self.status_history[-1][1]


class InstanceManager:
    """The instance table. All mutations go through set_status, which
    enforces the lifecycle's legal transitions and records history."""

    def __init__(self):
        self._instances: Dict[str, Instance] = {}

    def create(self, node_type: str, slice_group: Optional[str] = None) -> Instance:
        inst = Instance(
            instance_id=uuid.uuid4().hex[:12],
            node_type=node_type,
            slice_group=slice_group,
        )
        inst.status_history.append((QUEUED, time.monotonic()))
        self._instances[inst.instance_id] = inst
        return inst

    def set_status(self, instance_id: str, status: str) -> Instance:
        inst = self._instances[instance_id]
        if status not in _LEGAL[inst.status]:
            raise ValueError(
                f"illegal transition {inst.status} -> {status} "
                f"for instance {instance_id}"
            )
        inst.status = status
        inst.status_history.append((status, time.monotonic()))
        return inst

    def instances(self, statuses: Optional[Tuple[str, ...]] = None,
                  node_type: Optional[str] = None) -> List[Instance]:
        out = []
        for inst in self._instances.values():
            if statuses and inst.status not in statuses:
                continue
            if node_type and inst.node_type != node_type:
                continue
            out.append(inst)
        return out

    def get(self, instance_id: str) -> Instance:
        return self._instances[instance_id]

    def by_cloud_id(self, cloud_id: str) -> Optional[Instance]:
        for inst in self._instances.values():
            if inst.cloud_id == cloud_id:
                return inst
        return None


# -- scheduler ---------------------------------------------------------------

_ACTIVE = (QUEUED, REQUESTED, ALLOCATED, RAY_RUNNING, RAY_STOPPED)


def _fits(bundle: Dict[str, float], free: Dict[str, float]) -> bool:
    return all(free.get(k, 0) + 1e-9 >= v for k, v in bundle.items())


def _claim(bundle: Dict[str, float], free: Dict[str, float]):
    for k, v in bundle.items():
        free[k] = free.get(k, 0) - v


class Scheduler:
    """Demand bundles + node-type config -> launch decisions
    (reference: v2/scheduler.py ResourceDemandScheduler).

    Bin-packs unmet demand onto copies of each node type, respecting
    min/max workers; slice types count in whole slices.
    """

    def __init__(self, node_types: Dict[str, dict]):
        self.node_types = node_types

    def desired_launches(
        self,
        demands: List[Dict[str, float]],
        free_per_node: List[Dict[str, float]],
        active_counts: Dict[str, int],
    ) -> Dict[str, int]:
        """Returns {node_type: units to launch} (a unit = slice_hosts
        hosts for slice types, 1 host otherwise)."""
        free = [dict(f) for f in free_per_node]
        unmet: List[Dict[str, float]] = []
        for bundle in demands:
            for f in free:
                if _fits(bundle, f):
                    _claim(bundle, f)
                    break
            else:
                unmet.append(bundle)

        launches: Dict[str, int] = {}
        # min_workers floors first.
        for t, spec in self.node_types.items():
            slice_hosts = spec.get("slice_hosts", 1)
            have_units = active_counts.get(t, 0) // slice_hosts
            need = spec.get("min_workers", 0) - have_units
            if need > 0:
                launches[t] = need

        for bundle in unmet:
            placed = False
            for t, spec in self.node_types.items():
                res = dict(spec.get("resources", {}))
                if not _fits(bundle, res):
                    continue
                slice_hosts = spec.get("slice_hosts", 1)
                have_units = (
                    active_counts.get(t, 0) // slice_hosts
                    + launches.get(t, 0)
                )
                if have_units >= spec.get("max_workers", 2 ** 30):
                    continue
                launches[t] = launches.get(t, 0) + 1
                # The new unit's free capacity absorbs later bundles too.
                unit_free = dict(res)
                _claim(bundle, unit_free)
                free.append(unit_free)
                placed = True
                break
            if not placed:
                pass  # infeasible on every type — surfaced via report()
        return launches


# -- reconciler --------------------------------------------------------------


class GcsRayState:
    """Live ray_state_fn backed by the GCS (the GcsAutoscalerStateManager
    role): maps provider cloud ids to registered nodes via the provider's
    rt-node-id tag, reports aliveness + free resources, and accumulates
    idle seconds from observed full-availability transitions."""

    def __init__(self, provider: NodeProvider, gcs_call):
        """gcs_call: callable(method, payload) -> response dict (sync)."""
        self.provider = provider
        self.gcs_call = gcs_call
        self._idle_since: Dict[str, float] = {}

    def __call__(self) -> Dict[str, dict]:
        nodes = {
            n["node_id"].hex() if isinstance(n["node_id"], bytes)
            else n["node_id"]: n
            for n in self.gcs_call("get_nodes", {})["nodes"]
        }
        now = time.monotonic()
        out: Dict[str, dict] = {}
        for cloud_id in self.provider.non_terminated_nodes():
            tags = self.provider.node_tags(cloud_id)
            node = nodes.get(tags.get("rt-node-id", ""))
            if node is None or node.get("state") != "ALIVE":
                out[cloud_id] = {"alive": False, "idle_s": 0.0, "free": {}}
                self._idle_since.pop(cloud_id, None)
                continue
            avail = dict(node.get("resources_available", {}))
            total = node.get("resources_total", {})
            idle = (
                avail == dict(total)
                and not node.get("demand_bundles")
            )
            if idle:
                self._idle_since.setdefault(cloud_id, now)
            else:
                self._idle_since.pop(cloud_id, None)
            out[cloud_id] = {
                "alive": True,
                "idle_s": now - self._idle_since.get(cloud_id, now),
                "free": avail,
            }
        return out


def gcs_demands(gcs_call):
    """demands_fn reading queued-task resource bundles from the GCS node
    table (the LoadMetrics role)."""

    def demands() -> List[Dict[str, float]]:
        out: List[Dict[str, float]] = []
        for n in gcs_call("get_nodes", {})["nodes"]:
            if n.get("state") == "ALIVE":
                out.extend(n.get("demand_bundles") or [])
        return out

    return demands


class Reconciler:
    """One tick: observe cloud + ray state, converge instances toward the
    schedule (reference: v2/instance_manager/reconciler.py).

    `ray_state_fn` abstracts the GCS view (reference:
    GcsAutoscalerStateManager): it returns
      {cloud_id: {"alive": bool, "idle_s": float, "free": {...}}}
    for every provider node whose raylet has (ever) registered.
    """

    def __init__(
        self,
        im: InstanceManager,
        provider: NodeProvider,
        node_types: Dict[str, dict],
        ray_state_fn,
        demands_fn,
        idle_timeout_s: float = 60.0,
        request_timeout_s: float = 600.0,
    ):
        self.im = im
        self.provider = provider
        self.node_types = node_types
        self.scheduler = Scheduler(node_types)
        self.ray_state_fn = ray_state_fn
        self.demands_fn = demands_fn
        self.idle_timeout_s = idle_timeout_s
        self.request_timeout_s = request_timeout_s

    # .. observation ........................................................
    def _sync_cloud(self):
        cloud_ids = set(self.provider.non_terminated_nodes())
        # REQUESTED whose VM appeared -> ALLOCATED; too old -> failed.
        for inst in self.im.instances((REQUESTED,)):
            if inst.cloud_id in cloud_ids:
                self.im.set_status(inst.instance_id, ALLOCATED)
            elif inst.age_in_status() > self.request_timeout_s:
                self.im.set_status(inst.instance_id, ALLOCATION_FAILED)
        # Anything we think is up but the cloud no longer lists -> gone.
        for inst in self.im.instances((ALLOCATED, RAY_RUNNING, RAY_STOPPED)):
            if inst.cloud_id not in cloud_ids:
                self.im.set_status(inst.instance_id, TERMINATING)
                self.im.set_status(inst.instance_id, TERMINATED)
        for inst in self.im.instances((TERMINATING,)):
            if inst.cloud_id not in cloud_ids:
                self.im.set_status(inst.instance_id, TERMINATED)

    def _sync_ray(self):
        state = self.ray_state_fn()
        now = time.monotonic()
        for inst in self.im.instances((ALLOCATED, RAY_RUNNING, RAY_STOPPED)):
            s = state.get(inst.cloud_id)
            if s is None:
                continue
            if s.get("alive") and inst.status in (ALLOCATED, RAY_STOPPED):
                self.im.set_status(inst.instance_id, RAY_RUNNING)
            elif not s.get("alive") and inst.status == RAY_RUNNING:
                self.im.set_status(inst.instance_id, RAY_STOPPED)
            if inst.status == RAY_RUNNING:
                idle_s = s.get("idle_s", 0.0)
                inst.idle_since = (now - idle_s) if idle_s > 0 else None

    # .. convergence ........................................................
    def _launch_queued(self):
        by_type: Dict[str, List[Instance]] = {}
        for inst in self.im.instances((QUEUED,)):
            by_type.setdefault(inst.node_type, []).append(inst)
        for t, insts in by_type.items():
            spec = self.node_types.get(t, {})
            try:
                cloud_ids = self.provider.create_node(t, spec, len(insts))
            except Exception:  # noqa: BLE001 — cloud hiccup: retry next tick
                continue
            for inst, cid in zip(insts, cloud_ids):
                inst.cloud_id = cid
                self.im.set_status(inst.instance_id, REQUESTED)

    def _scale_up(self):
        state = self.ray_state_fn()
        free = [
            dict(s.get("free", {})) for s in state.values() if s.get("alive")
        ]
        active: Dict[str, int] = {}
        for inst in self.im.instances(_ACTIVE):
            active[inst.node_type] = active.get(inst.node_type, 0) + 1
        for t, units in self.scheduler.desired_launches(
            list(self.demands_fn()), free, active
        ).items():
            slice_hosts = self.node_types.get(t, {}).get("slice_hosts", 1)
            for _ in range(units):
                group = uuid.uuid4().hex[:8] if slice_hosts > 1 else None
                for _ in range(slice_hosts):
                    self.im.create(t, slice_group=group)

    def _scale_down(self):
        now = time.monotonic()
        min_floor: Dict[str, int] = {
            t: spec.get("min_workers", 0) * spec.get("slice_hosts", 1)
            for t, spec in self.node_types.items()
        }
        active: Dict[str, int] = {}
        for inst in self.im.instances(_ACTIVE):
            active[inst.node_type] = active.get(inst.node_type, 0) + 1

        def expired(inst: Instance) -> bool:
            return (
                inst.idle_since is not None
                and now - inst.idle_since > self.idle_timeout_s
            )

        # Group instances by slice; a slice goes only when ALL its hosts
        # are idle past the timeout (slice-atomic invariant).
        groups: Dict[Tuple[str, Optional[str]], List[Instance]] = {}
        for inst in self.im.instances((RAY_RUNNING, RAY_STOPPED)):
            key = (inst.node_type, inst.slice_group or inst.instance_id)
            groups.setdefault(key, []).append(inst)
        for (t, _), insts in groups.items():
            if not all(
                expired(i) or i.status == RAY_STOPPED for i in insts
            ):
                continue
            if any(i.status == RAY_RUNNING for i in insts) and (
                active.get(t, 0) - len(insts) < min_floor.get(t, 0)
            ):
                continue  # would dip below min_workers
            for inst in insts:
                try:
                    self.provider.terminate_node(inst.cloud_id)
                except Exception:  # noqa: BLE001
                    continue
                self.im.set_status(inst.instance_id, TERMINATING)
                active[t] = active.get(t, 0) - 1

    def _retry_failed(self):
        for inst in self.im.instances((ALLOCATION_FAILED,)):
            # Requeue once; a type that keeps failing stays visible in the
            # report as repeated ALLOCATION_FAILED history.
            self.im.set_status(inst.instance_id, QUEUED)
            inst.cloud_id = None

    def step(self):
        """One reconciliation tick (observe, then converge)."""
        self._sync_cloud()
        self._sync_ray()
        self._retry_failed()
        self._scale_up()
        self._launch_queued()
        self._scale_down()

    def report(self) -> Dict[str, Dict[str, int]]:
        """{node_type: {status: count}} — the `rt status` v2 view."""
        out: Dict[str, Dict[str, int]] = {}
        for inst in self.im.instances():
            t = out.setdefault(inst.node_type, {})
            t[inst.status] = t.get(inst.status, 0) + 1
        return out


class Monitor:
    """Background autoscaling loop: runs reconciler ticks on a daemon
    thread (the reference's monitor.py process role — here a thread owned
    by whoever starts autoscaling, typically the head node)."""

    def __init__(self, reconciler: "Reconciler", interval_s: float = 1.0):
        import threading

        self.reconciler = reconciler
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._errors: list = []
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="rt-autoscaler-v2"
        )

    def start(self) -> "Monitor":
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.reconciler.step()
            except Exception as e:  # noqa: BLE001 — keep scaling
                self._errors.append(f"{type(e).__name__}: {e}")
                del self._errors[:-20]

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10)
