"""Serve controller: reconciles deployments to replica actors.

Analog of the reference's ServeController (serve/_private/controller.py:91)
+ DeploymentState reconciliation (deployment_state.py:1211) + the basic
autoscaling loop (autoscaling_policy.py): a named actor owning the desired
state; a background thread reconciles replica counts and applies
queue-length-based autoscaling; handles fetch the replica list with a
version number and long-poll-style refresh on change
(serve/_private/long_poll.py analog via polling).

Counterpart of ray_tpu/serve/controller.py. The controller never runs
user code: deployments arrive sealed (`deployment.Sealed`) and are
opened only in the replica, so this process imports no torch and never
touches CUDA. A GPU replica takes `num_gpus` from ray_actor_options.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch as rt
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch.exceptions import (
    ActorError,
    GetTimeoutError,
    WorkerCrashedError,
)
from ray_tpu_torch.serve import autoscale
from ray_tpu_torch.serve.deployment import Application, AutoscalingConfig, Deployment
from ray_tpu_torch.serve.replica import ReplicaActor
from ray_tpu_torch._vendor import cloudpickle
from ray_tpu_torch.util import journal

logger = logging.getLogger("ray_tpu_torch.serve")

CONTROLLER_NAME = "RT_SERVE_CONTROLLER"


CHECKPOINT_KEY = b"serve_controller_ckpt"


@rt.remote
class ServeController:
    def __init__(self):
        journal.set_process_label("serve-controller")
        # app name -> {deployment, replicas: [handles], version}
        self.apps: Dict[str, Dict] = {}
        self._health_fails: Dict[bytes, int] = {}
        self._lock = threading.Lock()
        # Event, not a bare bool: shutdown() runs on an actor-call thread
        # while _reconcile_loop reads it — Event gives the cross-thread
        # visibility guarantee without taking self._lock (RT006).
        self._stop = threading.Event()
        # ProxyStateManager state (reference: serve/_private/proxy_state.py
        # ProxyStateManager): when enabled, the reconcile loop keeps ONE
        # proxy actor alive on every ALIVE cluster node, pinned there by
        # node-affinity scheduling, replacing dead ones.
        self._proxy_every_node = False
        self._proxies: Dict[bytes, Dict] = {}  # node_id -> {actor, ...}
        self._proxies_reconciling = False  # single-flight across threads
        # Crash recovery (reference: controller.py:91 checkpointing via
        # KVStore + deployment_state.py:2321 _recover_from_checkpoint):
        # every mutation persists the desired state INCLUDING live replica
        # handles to the GCS KV; a restarted controller re-adopts running
        # replicas, so controller death costs no routes and no replica
        # restarts.
        # ServeSignals publication (observatory): versioned snapshot of
        # per-app load/latency/SLO state written to the GCS KV each
        # serve_signals_interval_s (rt serve + autoscalers read it).
        self._signals_seq = 0
        self._signals_last = 0.0
        # Signals-driven autoscaler hysteresis memory, one entry per app
        # (ray_tpu_torch/serve/autoscale.py). Not checkpointed: hysteresis
        # restarts cold after a controller crash, which only delays the
        # next scaling move by one hold period.
        self._scale_state: Dict[str, "autoscale.AutoscalerState"] = {}
        self._restore()
        self._thread = threading.Thread(target=self._reconcile_loop, daemon=True)
        self._thread.start()

    # -- checkpoint / recovery --------------------------------------------
    def _checkpoint(self):
        from ray_tpu_torch._private import worker as worker_mod

        with self._lock:
            state = {
                "apps": {
                    name: {
                        "deployment": app["deployment"],
                        "init_args": app["init_args"],
                        "init_kwargs": app["init_kwargs"],
                        "replicas": list(app["replicas"]),
                        "version": app["version"],
                        "target": app["target"],
                    }
                    for name, app in self.apps.items()
                },
                "proxy_every_node": self._proxy_every_node,
                "proxies": {
                    nid: {"actor": e["actor"], "http": e["http"],
                          "binary": e["binary"]}
                    for nid, e in self._proxies.items()
                },
            }
        try:
            worker_mod.get_client().kv_put(
                CHECKPOINT_KEY, cloudpickle.dumps(state), ns="serve"
            )
        except Exception:  # noqa: BLE001 — next mutation retries
            logger.warning(
                "serve controller checkpoint write failed for %d app(s); "
                "a controller crash before the next mutation loses routes",
                len(state["apps"]), exc_info=True,
            )

    def _restore(self):
        from ray_tpu_torch._private import worker as worker_mod

        try:
            raw = worker_mod.get_client().kv_get(CHECKPOINT_KEY, ns="serve")
        except Exception:  # noqa: BLE001
            logger.warning(
                "serve controller checkpoint read failed; recovering "
                "with empty state (running replicas will be re-adopted "
                "only on redeploy)", exc_info=True,
            )
            raw = None
        if not raw:
            return
        try:
            state = cloudpickle.loads(raw)
        except Exception:  # noqa: BLE001 — corrupt checkpoint: start fresh
            logger.warning(
                "serve controller checkpoint is corrupt (%d bytes); "
                "starting fresh", len(raw), exc_info=True,
            )
            return
        now = time.monotonic()
        # _restore runs in __init__ before the reconcile thread starts,
        # but take the lock anyway so every apps/_proxy_every_node
        # write is uniformly guarded.
        with self._lock:
            for name, app in state.get("apps", {}).items():
                self.apps[name] = {
                    "deployment": app["deployment"],
                    "init_args": app["init_args"],
                    "init_kwargs": app["init_kwargs"],
                    # Live replicas are re-adopted as-is; the first
                    # health pass reaps any that died while the
                    # controller was down and reconcile replaces them.
                    "replicas": list(app["replicas"]),
                    "version": app["version"] + 1,
                    "target": app["target"],
                    "last_scale_up": now,
                    "last_scale_down": now,
                }
            self._proxy_every_node = state.get("proxy_every_node", False)
            for nid, e in state.get("proxies", {}).items():
                self._proxies[nid] = dict(e)
        # Controller failover: handles kept serving from CACHED routes
        # while we were down. Push an invalidation per app so they
        # re-sync with the restored (version-bumped) table immediately
        # instead of trusting possibly-stale caches for a full TTL.
        for name in list(self.apps):
            self._publish_routes(name)

    # -- API -------------------------------------------------------------
    @staticmethod
    def _same_except_user_config(old_app, deployment, init_args,
                                 init_kwargs) -> bool:
        """True when a redeploy matches the running app in everything
        but (possibly) user_config. With user_config also equal it is a
        no-op redeploy; with it different it is the lightweight-update
        case the reference handles by reconfigure()ing live replicas
        instead of restarting them (deployment_state.py: user_config-only
        version changes)."""
        od: Deployment = old_app["deployment"]

        def ident(obj):
            return (getattr(obj, "__module__", None),
                    getattr(obj, "__qualname__", None))

        def same_code(a, b):
            # (module, qualname) alone is blind to an edited class body
            # redeployed under the same name; compare the serialized
            # bytes too. Any pickling instability reads as "changed" ->
            # full replace, the safe direction.
            if ident(a) != ident(b):
                return False
            try:
                return cloudpickle.dumps(a) == cloudpickle.dumps(b)
            except Exception:  # rtlint: disable=RT007 — by design:
                # pickling instability reads as "changed" -> full
                # replace, the safe direction (nothing to handle/log).
                return False

        return (
            same_code(od.func_or_class, deployment.func_or_class)
            and od.num_replicas == deployment.num_replicas
            and od.ray_actor_options == deployment.ray_actor_options
            and od.autoscaling_config == deployment.autoscaling_config
            and od.max_ongoing_requests == deployment.max_ongoing_requests
            and _safe_eq(old_app["init_args"], init_args)
            and _safe_eq(old_app["init_kwargs"], init_kwargs)
        )

    def _reconfigure_in_place(self, name: str, deployment: Deployment) -> bool:
        """Push the new user_config to every live replica. Re-snapshots
        until stable: a replica the reconcile/autoscale thread spawned
        mid-pass (constructed with the old config) gets picked up on the
        next sweep. Any failure aborts -> the caller falls back to a
        full replace (the reference marks the deployment unhealthy on
        reconfigure errors; replacing is our recovery)."""
        done: set = set()
        for _ in range(3):
            with self._lock:
                app = self.apps.get(name)
                if app is None:
                    return False
                todo = [r for r in app["replicas"]
                        if r._actor_id.binary() not in done]
            if not todo:
                return True
            refs = [r.reconfigure.remote(deployment.user_config)
                    for r in todo]
            ready, not_ready = rt.wait(
                refs, num_returns=len(refs),
                timeout=get_config().serve_ready_timeout_s,
            )
            if not_ready:
                return False
            for r, ref in zip(todo, refs):
                try:
                    rt.get(ref, timeout=1)
                except Exception:  # noqa: BLE001 — user code rejected it
                    logger.warning(
                        "replica %s of app %r rejected user_config; "
                        "falling back to full replace", r._actor_id.hex(),
                        name, exc_info=True,
                    )
                    return False
                done.add(r._actor_id.binary())
        return False  # still churning after 3 sweeps: replace instead

    def deploy(self, name: str, deployment: Deployment, init_args, init_kwargs):
        with self._lock:
            old = self.apps.get(name)
            same_core = bool(
                old and old["replicas"] and self._same_except_user_config(
                    old, deployment, init_args, init_kwargs
                )
            )
            if same_core and _safe_eq(
                old["deployment"].user_config, deployment.user_config
            ):
                # Nothing changed at all: a no-op redeploy must not
                # restart healthy replicas (reference: same-version
                # redeploys are no-ops).
                return True
            lightweight = same_core
            if lightweight:
                old["deployment"] = deployment
        if lightweight:
            # In-place reconfigure: replicas keep serving (and their
            # caches/connections) through the config change.
            if self._reconfigure_in_place(name, deployment):
                self._checkpoint()
                return True
            # Reconfigure failed somewhere: fall through to the full
            # replace below so state and replicas cannot diverge.
        with self._lock:
            old = self.apps.get(name)
            to_retire = list(old["replicas"]) if old else []
            self.apps[name] = {
                "deployment": deployment,
                "init_args": init_args,
                "init_kwargs": init_kwargs,
                "replicas": [],
                # Monotonic across redeploys so handles can compare
                # versions to detect ANY change, including replacement.
                "version": (old["version"] + 1) if old else 0,
                "target": deployment.num_replicas,
                "last_scale_up": 0.0,
                "last_scale_down": time.monotonic(),
            }
        journal.emit("serve.controller", action="deploy", app=name,
                     replicas=deployment.num_replicas)
        self._reconcile_once(name)
        self._checkpoint()
        # New replicas are up and published; the replaced generation
        # drains (finishes in-flight requests) before dying.
        self._drain_then_kill(to_retire, name)
        return True

    def delete(self, name: str):
        with self._lock:
            app = self.apps.pop(name, None)
        journal.emit("serve.controller", action="delete", app=name)
        self._checkpoint()
        if app:
            # Short drain on delete: in-flight requests get a grace
            # window without making serve.shutdown() (which deletes
            # every app) wait out the full drain budget per app.
            self._drain_then_kill(
                app["replicas"], name,
                timeout_s=min(get_config().serve_drain_timeout_s, 1.0),
            )
        return True

    def get_replicas(self, name: str):
        with self._lock:
            app = self.apps.get(name)
            if app is None:
                return {"version": -1, "replicas": [], "max_ongoing": 0}
            return {
                "version": app["version"],
                "replicas": list(app["replicas"]),
                "max_ongoing": app["deployment"].max_ongoing_requests,
                # Prefix-affinity hints (paged KV): actor_id hex -> list of
                # first-page prefix hashes resident in that replica's
                # cache, refreshed each signals tick. Handles route
                # matching prompts to a covering replica.
                "prefix": dict(app.get("prefix_routes") or {}),
                "page_size": app.get("kv_page_size") or 0,
            }

    def status(self) -> Dict:
        with self._lock:
            return {
                name: {
                    "target_replicas": app["target"],
                    "running_replicas": len(app["replicas"]),
                    "deployment": app["deployment"].name,
                }
                for name, app in self.apps.items()
            }

    def shutdown(self):
        self._stop.set()
        with self._lock:
            names = list(self.apps)
        for n in names:
            self.delete(n)
        with self._lock:
            entries = list(self._proxies.values())
            self._proxies.clear()
        for entry in entries:
            _kill_quietly(entry["actor"])
        try:
            from ray_tpu_torch._private import worker as worker_mod

            worker_mod.get_client().kv_del(CHECKPOINT_KEY, ns="serve")
        except Exception:  # noqa: BLE001
            logger.warning(
                "serve shutdown could not delete the controller "
                "checkpoint; a restarted controller will re-adopt "
                "stale state", exc_info=True,
            )
        return True

    # -- reconciliation ---------------------------------------------------
    def _reconcile_once(self, name: str):
        with self._lock:
            app = self.apps.get(name)
            if app is None:
                return
            dep: Deployment = app["deployment"]
            current = len(app["replicas"])
            target = app["target"]
        if current < target:
            new = []
            for _ in range(target - current):
                opts = dict(dep.ray_actor_options)
                replica = ReplicaActor.options(
                    num_cpus=opts.pop("num_cpus", 0.1),
                    num_gpus=opts.pop("num_gpus", None),
                    resources=opts.pop("resources", None),
                    # Priority tier rides the actor options: a latency-
                    # critical deployment's pending replica may reclaim
                    # chips from lower-priority gangs.
                    priority=opts.pop("priority", 0),
                    # Concurrent request execution inside the replica: the
                    # substrate @serve.batch coalesces across (capped so a
                    # misconfigured deployment can't demand 100 threads).
                    max_concurrency=min(dep.max_ongoing_requests, 32),
                ).remote(
                    dep.func_or_class,
                    app["init_args"],
                    app["init_kwargs"],
                    dep.user_config,
                    name,
                    getattr(dep, "slo", None),
                    dep.max_ongoing_requests,
                )
                new.append(replica)
            with self._lock:
                app["replicas"].extend(new)
                app["version"] += 1
            journal.emit("serve.controller", action="scale_up", app=name,
                         added=len(new), target=target)
            self._publish_routes(name)
            self._checkpoint()
        elif current > target:
            with self._lock:
                excess = app["replicas"][target:]
                app["replicas"] = app["replicas"][:target]
                app["version"] += 1
            journal.emit("serve.controller", action="scale_down", app=name,
                         removed=len(excess), target=target)
            # Routes flip FIRST (handles stop picking the victims), then
            # the victims drain: new requests they still receive bounce
            # with ReplicaDrainingError and redispatch, in-flight ones
            # finish, and only then does the process die.
            self._publish_routes(name)
            self._checkpoint()
            self._drain_then_kill(excess, name)

    def _drain_then_kill(self, replicas: List, name: str = "",
                         timeout_s: Optional[float] = None):
        """Graceful scale-down/replace: each victim stops admitting
        (handles redispatch its refusals), finishes in-flight work —
        bounded by serve_drain_timeout_s — and only then is killed.
        One collective wait bounds the whole pass; a replica that cannot
        drain in time is killed anyway (drain improves the common case,
        the kill below is the guarantee)."""
        if not replicas:
            return
        cfg = get_config()
        if timeout_s is None:
            timeout_s = cfg.serve_drain_timeout_s
        refs = [r.drain.remote(timeout_s) for r in replicas]
        ready, _ = rt.wait(refs, num_returns=len(refs),
                           timeout=timeout_s + 2.0)
        ready_set = set(ready)
        for r, ref in zip(replicas, refs):
            if ref in ready_set:
                try:
                    res = rt.get(ref, timeout=1.0)
                    logger.info(
                        "replica %s of app %r drained in %.3fs "
                        "(remaining=%d)", r._actor_id.hex(), name,
                        res.get("duration_s", 0.0),
                        res.get("remaining", 0),
                    )
                except Exception:  # rtlint: disable=RT007 — drain is best-effort; the kill below is the guarantee
                    pass
            _kill_quietly(r)

    def _publish_routes(self, name: str):
        """Push a routing-table invalidation to subscribed handles — the
        LongPollHost role (serve/_private/long_poll.py:175): handles learn
        of replica set changes immediately instead of on their poll TTL."""
        try:
            from ray_tpu_torch._private import worker as worker_mod

            with self._lock:
                version = self.apps[name]["version"]
            journal.emit("serve.controller", action="route_flip", app=name,
                         version=version)
            worker_mod.get_client().publish(
                f"serve_routes:{name}", {"version": version}
            )
        except Exception:  # noqa: BLE001 — handles fall back to polling
            logger.debug("route-invalidation push failed for app %r "
                         "(handles fall back to polling)", name,
                         exc_info=True)

    def _publish_signals(self):
        """Assemble and publish the ServeSignals snapshot (observatory).

        Fans out observatory_snapshot() to every replica, merges per app
        (QPS sums, occupancy averages, latency sample sets pool before
        the percentile cut, per-tenant SLO window counts add before the
        burn-rate division — burn of sums, not mean of burns), and
        writes ONE versioned JSON document to the GCS KV under
        ns="serve"/serve_signals. Read path needs no actors: rt serve
        and autoscalers kv_get it straight off the GCS."""
        from ray_tpu_torch.serve import observatory

        cfg = get_config()
        if not cfg.serve_observatory:
            return
        now = time.monotonic()
        if now - self._signals_last < cfg.serve_signals_interval_s:
            return
        self._signals_last = now
        with self._lock:
            app_replicas = {
                name: list(app["replicas"]) for name, app in self.apps.items()
            }
        doc = {
            "schema": observatory.SIGNALS_SCHEMA_VERSION,
            "seq": self._signals_seq,
            "ts": time.time(),
            "apps": {},
        }
        self._signals_seq += 1
        for name, replicas in app_replicas.items():
            snaps = []
            refs = [r.observatory_snapshot.remote() for r in replicas]
            ready, _ = rt.wait(
                refs, num_returns=len(refs),
                timeout=cfg.serve_probe_timeout_s,
            )
            per_replica = []
            prefix_routes: Dict[str, List[str]] = {}
            page_size = 0
            for r, ref in zip(replicas, refs):
                entry = {
                    "actor_id": r._actor_id.hex(),
                    "health_fails": self._health_fails.get(
                        r._actor_id.binary(), 0
                    ),
                }
                if ref in ready:
                    try:
                        snap = rt.get(ref, timeout=1.0)
                        snaps.append(snap)
                        entry["ongoing"] = snap.get("ongoing")
                        entry["total_served"] = snap.get("total_served")
                        entry["qps"] = snap.get("qps")
                        kv = (snap.get("engine") or {}).get("kv") or {}
                        if kv.get("mode") == "paged":
                            entry["kv_util"] = kv.get("util")
                            entry["prefix_hit_rate"] = kv.get(
                                "prefix_hit_rate")
                            entry["prefill_tokens_skipped"] = kv.get(
                                "prefill_tokens_skipped")
                            if kv.get("roots"):
                                prefix_routes[entry["actor_id"]] = list(
                                    kv["roots"])
                            page_size = kv.get("page_size") or page_size
                    except Exception:  # rtlint: disable=RT007 — replica mid-death; marked unreachable
                        entry["unreachable"] = True
                else:
                    entry["unreachable"] = True
                per_replica.append(entry)
            app_sig = self._merge_app_signals(name, snaps, per_replica, cfg)
            with self._lock:
                app = self.apps.get(name)
                if app is not None:
                    # Cached for get_replicas(): handles learn prefix
                    # residency on their normal routing-table refresh, no
                    # extra RPC.
                    app["prefix_routes"] = prefix_routes
                    app["kv_page_size"] = page_size
                    app_sig["target_replicas"] = app["target"]
                    app_sig["running_replicas"] = len(app["replicas"])
            doc["apps"][name] = app_sig
        try:
            from ray_tpu_torch._private import worker as worker_mod

            worker_mod.get_client().kv_put(
                observatory.SIGNALS_KEY,
                json.dumps(doc).encode(),
                ns="serve",
            )
        except Exception:  # noqa: BLE001 — next tick republishes
            logger.debug("ServeSignals publish failed", exc_info=True)

    @staticmethod
    def _merge_app_signals(name, snaps, per_replica, cfg):
        from ray_tpu_torch.serve import observatory

        qps = sum(s.get("qps") or 0.0 for s in snaps)
        ttft = sorted(x for s in snaps for x in s.get("ttft_samples") or [])
        tpot = sorted(x for s in snaps for x in s.get("tpot_samples") or [])
        phases: Dict[str, Dict[str, float]] = {}
        fractions = [s["phase_sum_fraction"] for s in snaps
                     if s.get("phase_sum_fraction") is not None]
        for s in snaps:
            for phase, row in (s.get("phases") or {}).items():
                agg = phases.setdefault(phase, {"sum_s": 0.0, "count": 0})
                agg["sum_s"] += row["sum_s"]
                agg["count"] += row["count"]
        waiting = sum(
            (s.get("engine") or {}).get("waiting") or 0 for s in snaps
        )
        occ = [
            (s.get("engine") or {}).get("occupancy")
            for s in snaps if (s.get("engine") or {}).get("occupancy") is not None
        ]
        hol_s = sum(
            ((s.get("engine") or {}).get("hol") or {})
            .get("blocked_slot_seconds") or 0.0
            for s in snaps
        )
        hol_events = [
            ev for s in snaps
            for ev in (((s.get("engine") or {}).get("hol") or {})
                       .get("events") or [])
        ]
        hol_events.sort(key=lambda e: e.get("ts", 0.0))
        slo = next((s["slo"] for s in snaps if s.get("slo")), None)
        objective = (slo or {}).get("objective", 0.99)
        # Per-tenant merge: window counts ADD across replicas, then one
        # burn-rate division over the pooled counts.
        tenants: Dict[str, Dict] = {}
        for s in snaps:
            for tname, t in (s.get("tenants") or {}).items():
                agg = tenants.setdefault(tname, {
                    "requests": 0, "tokens_in": 0, "tokens_out": 0,
                    "queue_s": 0.0, "slo_windows": {},
                })
                for k in ("requests", "tokens_in", "tokens_out"):
                    agg[k] += t.get(k) or 0
                agg["queue_s"] += t.get("queue_s") or 0.0
                for w, kinds in (t.get("slo_windows") or {}).items():
                    aw = agg["slo_windows"].setdefault(w, {})
                    for kind, row in kinds.items():
                        ar = aw.setdefault(kind, {"good": 0, "total": 0})
                        ar["good"] += row["good"]
                        ar["total"] += row["total"]
        for t in tenants.values():
            for kinds in t["slo_windows"].values():
                for row in kinds.values():
                    row["burn"] = observatory.burn_rate(
                        row["good"], row["total"], objective
                    )
        # Paged-KV aggregate (schema v2): pooled page counts across
        # replicas, one hit-rate division over pooled lookups.
        kv_snaps = [
            (s.get("engine") or {}).get("kv") or {} for s in snaps
        ]
        kv_snaps = [k for k in kv_snaps if k.get("mode") == "paged"]
        kv_agg = None
        if kv_snaps:
            hits = sum(k.get("prefix_hits") or 0 for k in kv_snaps)
            misses = sum(k.get("prefix_misses") or 0 for k in kv_snaps)
            total = sum(k.get("pages_total") or 0 for k in kv_snaps)
            in_use = sum(k.get("pages_in_use") or 0 for k in kv_snaps)
            kv_agg = {
                "page_size": kv_snaps[0].get("page_size"),
                "pages_total": total,
                "pages_in_use": in_use,
                "util": (in_use / total) if total else None,
                "prefix_hit_rate": (
                    hits / (hits + misses) if (hits + misses) else None
                ),
                "prefill_tokens_skipped": sum(
                    k.get("prefill_tokens_skipped") or 0 for k in kv_snaps
                ),
            }
        return {
            "replicas": per_replica,
            "qps": qps,
            "waiting": waiting,
            "occupancy": sum(occ) / len(occ) if occ else None,
            # Backlog-drain estimate: queued requests over current
            # throughput — how many seconds of arrivals are waiting.
            "backlog_drain_s": (waiting / qps) if qps > 0 else None,
            "ttft_s": {
                "p50": observatory.percentile(ttft, 0.50),
                "p99": observatory.percentile(ttft, 0.99),
                "n": len(ttft),
            },
            "tpot_s": {
                "p50": observatory.percentile(tpot, 0.50),
                "p99": observatory.percentile(tpot, 0.99),
                "n": len(tpot),
            },
            "phases": phases,
            "phase_sum_fraction": (
                sum(fractions) / len(fractions) if fractions else None
            ),
            "hol": {"blocked_slot_seconds": hol_s,
                    "events": hol_events[-16:]},
            "slo": slo,
            "tenants": tenants,
            "kv": kv_agg,
        }

    def _reconcile_loop(self):
        while not self._stop.is_set():
            time.sleep(get_config().serve_reconcile_interval_s)
            try:
                with self._lock:
                    names = list(self.apps)
                    proxy_mode = self._proxy_every_node
                for name in names:
                    self._check_replica_health(name)
                    self._evict_draining_replicas(name)
                    self._autoscale(name)
                    self._reconcile_once(name)
                if proxy_mode:
                    self._reconcile_proxies()
                self._publish_signals()
            except Exception:  # noqa: BLE001 — keep reconciling; next
                # tick retries. Logged, not swallowed: a persistent error
                # here silently freezes replica replacement (it did once).
                logging.getLogger("ray_tpu_torch.serve").exception(
                    "serve controller reconcile tick failed"
                )

    # -- proxy state manager ---------------------------------------------
    def start_proxies(self) -> int:
        """Enable one-proxy-per-node mode; returns the current live-node
        count (proxies come up within a reconcile tick)."""
        with self._lock:
            self._proxy_every_node = True
        self._reconcile_proxies()
        with self._lock:
            return len(self._proxies)

    def _alive_nodes(self):
        from ray_tpu_torch._private import worker as worker_mod

        client = worker_mod.get_client()
        nodes = client._run(client._gcs_call("get_nodes", {}))["nodes"]
        return [n for n in nodes if n.get("state") == "ALIVE"]

    def _reconcile_proxies(self):
        """Called from both the actor-call thread (start_proxies) and the
        reconcile daemon thread: single-flighted, and every _proxies
        read/write happens under self._lock (the slow actor RPCs do not)."""
        from ray_tpu_torch.serve.proxy import ProxyActor
        from ray_tpu_torch.util.scheduling_strategies import (
            NodeAffinitySchedulingStrategy,
        )

        with self._lock:
            if self._proxies_reconciling:
                return
            self._proxies_reconciling = True
        try:
            alive = {n["node_id"]: n for n in self._alive_nodes()}
            with self._lock:
                existing = dict(self._proxies)
            # Reap proxies on dead nodes / dead proxy actors.
            for node_id, entry in existing.items():
                dead = node_id not in alive
                if not dead:
                    try:
                        rt.get(entry["actor"].ready.remote(),
                               timeout=get_config().serve_probe_timeout_s)
                    except (ActorError, WorkerCrashedError,
                            GetTimeoutError):
                        # Only actor-death/unreachable errors mean the
                        # proxy is gone; anything else (a controller-side
                        # bug) should surface, not silently kill proxies.
                        dead = True
                if dead:
                    _kill_quietly(entry["actor"])
                    with self._lock:
                        self._proxies.pop(node_id, None)
            for node_id in alive:
                with self._lock:
                    if node_id in self._proxies:
                        continue
                try:
                    actor = ProxyActor.options(
                        num_cpus=0.01,
                        scheduling_strategy=NodeAffinitySchedulingStrategy(
                            node_id=node_id
                        ),
                    ).remote("127.0.0.1", 0)
                    rt.get(actor.ready.remote(),
                           timeout=get_config().serve_ready_timeout_s)
                    entry = {
                        "actor": actor,
                        "http": rt.get(actor.address.remote(),
                                       timeout=get_config().serve_probe_timeout_s),
                        "binary": rt.get(
                            actor.binary_address.remote(),
                            timeout=get_config().serve_probe_timeout_s,
                        ),
                    }
                    with self._lock:
                        self._proxies[node_id] = entry
                except Exception:  # noqa: BLE001 — retried next tick
                    nid = (node_id.hex()
                           if isinstance(node_id, (bytes, bytearray))
                           else node_id)
                    logger.warning(
                        "proxy spawn failed on node %s; retried next "
                        "reconcile tick", nid, exc_info=True,
                    )
            self._checkpoint()
        finally:
            with self._lock:
                self._proxies_reconciling = False

    def proxy_addresses(self) -> Dict[str, Dict]:
        """node_id hex -> {http, binary} for every live proxy."""
        with self._lock:
            entries = dict(self._proxies)
        return {
            nid.hex() if isinstance(nid, (bytes, bytearray)) else str(nid): {
                "http": e["http"],
                "binary": list(e["binary"]),
            }
            for nid, e in entries.items()
        }

    @staticmethod
    def _actor_state(actor_id: bytes) -> Optional[str]:
        """GCS-recorded state of an actor ("ALIVE"/"DEAD"/...), or None
        when the lookup fails (treat as unknown, fall back to the
        consecutive-failure threshold)."""
        try:
            from ray_tpu_torch._private import worker as worker_mod

            client = worker_mod.get_client()
            info = client._run(
                client._gcs_call("get_actor", {"actor_id": actor_id})
            )["actor"]
            return info["state"] if info else None
        except Exception:  # noqa: BLE001 — control-plane hiccup
            logger.debug("GCS actor-state lookup failed for %s (treated "
                         "as unknown)", actor_id.hex(), exc_info=True)
            return None

    def _evict_draining_replicas(self, name: str):
        """Graceful replica eviction off draining nodes (the preemption /
        maintenance path): route-flip first, then the PR 8 drain-then-kill,
        and _reconcile_once respawns the lost count elsewhere — the GCS
        never places a new actor on a draining node. Zero lost non-shed
        requests: victims stop receiving new work before they die."""
        try:
            draining = {
                n["node_id"] for n in self._alive_nodes()
                if n.get("draining")
            }
        except Exception:  # noqa: BLE001 — control-plane hiccup; next tick
            logger.debug("draining-node sweep could not list nodes for "
                         "app %r (retried next tick)", name, exc_info=True)
            return
        if not draining:
            return
        with self._lock:
            app = self.apps.get(name)
            if app is None:
                return
            replicas = list(app["replicas"])
        victims = []
        for r in replicas:
            try:
                from ray_tpu_torch._private import worker as worker_mod

                client = worker_mod.get_client()
                info = client._run(
                    client._gcs_call(
                        "get_actor", {"actor_id": r._actor_id.binary()}
                    )
                )["actor"]
            except Exception:  # noqa: BLE001 — lookup hiccup; next tick
                logger.debug("replica node lookup failed for app %r "
                             "(retried next tick)", name, exc_info=True)
                continue
            if (
                info
                and info.get("state") == "ALIVE"
                and info.get("node_id") in draining
            ):
                victims.append(r)
        if not victims:
            return
        victim_ids = {v._actor_id.binary() for v in victims}
        with self._lock:
            app = self.apps.get(name)
            if app is None:
                return
            app["replicas"] = [
                r for r in app["replicas"]
                if r._actor_id.binary() not in victim_ids
            ]
            app["version"] += 1
        logger.warning(
            "evicting %d replica(s) of app %r from draining node(s)",
            len(victims), name,
        )
        journal.emit("serve.controller", action="evict_draining", app=name,
                     victims=len(victims))
        self._publish_routes(name)
        self._checkpoint()
        self._drain_then_kill(victims, name)

    def _check_replica_health(self, name: str):
        """Drop dead replicas so reconcile replaces them — the
        DeploymentState failure-recovery role (deployment_state.py:1211).
        Probes run in PARALLEL (one slow app must not stall the reconcile
        loop) and a replica is declared dead only after 3 consecutive
        failed probes, so a replica that is briefly saturated (all
        concurrency slots busy) or still loading a model is not killed.
        Exception: a probe that fails with an actor-death error, or whose
        actor the GCS already marked DEAD, is replaced immediately — the
        threshold protects slow-but-alive replicas, not corpses."""
        with self._lock:
            app = self.apps.get(name)
            if app is None:
                return
            replicas = list(app["replicas"])
        if not replicas:
            return
        refs = [r.health_check.remote() for r in replicas]
        # One collective wait bounds the whole pass (serve_health_wait_s)
        # regardless of how many replicas are hung.
        ready, _not_ready = rt.wait(refs, num_returns=len(refs),
                                    timeout=get_config().serve_health_wait_s)
        ready_set = set(ready)
        dead = []
        for r, ref in zip(replicas, refs):
            key = r._actor_id.binary()
            healthy = False
            actor_dead = False
            if ref in ready_set:
                try:
                    rt.get(ref, timeout=get_config().serve_probe_timeout_s)
                    healthy = True
                except (ActorError, WorkerCrashedError):
                    # The probe failed because the actor PROCESS is gone,
                    # not because the replica was slow — there is nothing
                    # a second probe could learn.
                    actor_dead = True
                except Exception:  # noqa: BLE001 — call errored: unhealthy
                    logger.warning(
                        "health probe errored for replica %s of app %r "
                        "(failure %d/%d)", r._actor_id.hex(), name,
                        self._health_fails.get(key, 0) + 1,
                        get_config().serve_health_fail_threshold,
                        exc_info=True,
                    )
            elif self._actor_state(key) == "DEAD":
                # Probe never completed AND the GCS already declared the
                # actor dead (its worker lost the raylet connection).
                actor_dead = True
            if healthy:
                self._health_fails.pop(key, None)
                continue
            if actor_dead:
                # Confirmed death bypasses the consecutive-failure
                # threshold: the threshold exists to tolerate saturated-
                # but-alive replicas, and waiting it out here just leaves
                # a known-dead replica in the route table for two more
                # reconcile ticks.
                dead.append(r)
                continue
            fails = self._health_fails.get(key, 0) + 1
            self._health_fails[key] = fails
            if fails >= get_config().serve_health_fail_threshold:
                dead.append(r)
        if not dead:
            return
        for r in dead:
            self._health_fails.pop(r._actor_id.binary(), None)
        dead_ids = {d._actor_id.binary() for d in dead}
        with self._lock:
            app = self.apps.get(name)
            if app is None:
                return
            app["replicas"] = [
                r for r in app["replicas"]
                if r._actor_id.binary() not in dead_ids
            ]
            app["version"] += 1
        # A replica the controller had to declare dead is a cluster-
        # visible failure: journal the replacement and freeze the black
        # box so the postmortem shows what killed it.
        journal.emit("serve.controller", action="replace_dead", app=name,
                     dead=[d._actor_id.hex() for d in dead])
        journal.trigger_postmortem(
            f"replica_dead:{name}", app=name,
            dead=[d._actor_id.hex() for d in dead],
        )
        self._publish_routes(name)
        self._checkpoint()
        for r in dead:
            _kill_quietly(r)

    def _autoscale(self, name: str):
        """Replica autoscaling off the published ServeSignals snapshot.

        ONE `kv_get` of the observatory document, zero actor calls: the
        signal plane (PR 7) already carries ongoing requests, admission
        queue depth, TTFT percentiles and SLO burn per app, so the
        decision (ray_tpu_torch/serve/autoscale.py) is a pure function over
        the snapshot with per-app hysteresis memory. Falls back to the
        legacy per-replica queue-length probe when the snapshot is
        missing or stale (observatory disabled, first ticks after boot,
        publisher wedged) — autoscaling never goes blind just because
        telemetry did."""
        with self._lock:
            app = self.apps.get(name)
            if app is None:
                return
            acfg: Optional[AutoscalingConfig] = (
                app["deployment"].autoscaling_config)
            target = app["target"]
            running = len(app["replicas"])
        if acfg is None or running == 0:
            return
        cfg = get_config()
        app_sig = None
        if cfg.serve_observatory:
            from ray_tpu_torch.serve import observatory

            try:
                from ray_tpu_torch._private import worker as worker_mod

                raw = worker_mod.get_client().kv_get(
                    observatory.SIGNALS_KEY, ns="serve")
                doc = json.loads(raw) if raw else None
            except Exception:  # rtlint: disable=RT007 — doc=None routes to the queue-probe fallback below
                doc = None
            stale_after = max(3 * cfg.serve_signals_interval_s, 5.0)
            if doc and time.time() - float(doc.get("ts") or 0) <= stale_after:
                app_sig = (doc.get("apps") or {}).get(name)
        if app_sig is None:
            return self._autoscale_probe(name)
        # _scale_state is only touched on the reconcile thread.
        state = self._scale_state.setdefault(
            name, autoscale.AutoscalerState())
        now = time.monotonic()
        new_target = autoscale.decide(
            app_sig, acfg, state, now, target, running)
        m = _controller_metrics()
        m["as_target"].set(float(new_target), tags={"app": name})
        m["as_actual"].set(float(running), tags={"app": name})
        if new_target == target:
            return
        with self._lock:
            app = self.apps.get(name)
            # Bail if the app vanished or someone else moved the target
            # (redeploy) between our read and this write.
            if app is None or app["target"] != target:
                return
            app["target"] = new_target
            if new_target > target:
                app["last_scale_up"] = now
            else:
                app["last_scale_down"] = now
        logger.info("autoscaler: app %r target %d -> %d (%s)",
                    name, target, new_target, state.last_reason)
        journal.emit("serve.controller", action="autoscale", app=name,
                     old_target=target, new_target=new_target,
                     reason=state.last_reason)
        self._checkpoint()

    def _autoscale_probe(self, name: str):
        """Legacy queue-length autoscaling (reference:
        autoscaling_policy.py): probes every replica's queue depth with
        an actor call. Kept as the fallback for when ServeSignals are
        unavailable."""
        with self._lock:
            app = self.apps.get(name)
            if app is None:
                return
            cfg: Optional[AutoscalingConfig] = app["deployment"].autoscaling_config
            replicas = list(app["replicas"])
        if cfg is None or not replicas:
            return
        try:
            qlens = rt.get([r.queue_len.remote() for r in replicas],
                           timeout=get_config().serve_probe_timeout_s)
        except Exception:  # noqa: BLE001 — next tick re-probes
            logger.debug("autoscale queue-length probe failed for app "
                         "%r; skipping this tick", name, exc_info=True)
            return
        avg = sum(qlens) / len(qlens)
        now = time.monotonic()
        with self._lock:
            app = self.apps.get(name)
            if app is None:
                return
            target = app["target"]
            changed = False
            if avg > cfg.target_ongoing_requests and target < cfg.max_replicas:
                if now - app["last_scale_up"] > cfg.upscale_delay_s:
                    app["target"] = min(target + 1, cfg.max_replicas)
                    app["last_scale_up"] = now
                    changed = True
            elif avg < cfg.target_ongoing_requests * 0.5 and target > cfg.min_replicas:
                if now - app["last_scale_down"] > cfg.downscale_delay_s:
                    app["target"] = max(target - 1, cfg.min_replicas)
                    app["last_scale_down"] = now
                    changed = True
        if changed:
            self._checkpoint()


_METRICS: Optional[Dict[str, Any]] = None


def _controller_metrics() -> Dict[str, Any]:
    # Lazy: the metrics registry must not be touched at import time
    # (same discipline as llm._engine_metrics).
    global _METRICS
    if _METRICS is None:
        from ray_tpu_torch.util.metrics import Gauge, get_or_create

        _METRICS = {
            "as_target": get_or_create(
                Gauge, "serve_autoscaler_target_replicas",
                "Autoscaler's desired replica count per app.",
                tag_keys=("app",)),
            "as_actual": get_or_create(
                Gauge, "serve_autoscaler_actual_replicas",
                "Running replica count per app as seen by the autoscaler.",
                tag_keys=("app",)),
        }
    return _METRICS


def _safe_eq(a, b) -> bool:  # rtlint: disable=RT007
    # Array-like args make == elementwise; any ambiguity (or raising
    # comparison) counts as "changed" -> full replace, never a crash.
    try:
        return bool(a == b)
    except Exception:  # noqa: BLE001
        return False


def _kill_quietly(actor):  # rtlint: disable=RT007
    # Best-effort teardown of an actor that may already be gone; any
    # error here means "nothing left to kill".
    try:
        rt.kill(actor)
    except Exception:
        pass


def get_or_create_controller():
    try:
        return rt.get_actor(CONTROLLER_NAME)
    except ValueError:
        pass
    try:
        return ServeController.options(
            name=CONTROLLER_NAME, num_cpus=0.1, max_restarts=-1
        ).remote()
    except ValueError:
        # Raced with another creator.
        return rt.get_actor(CONTROLLER_NAME)
