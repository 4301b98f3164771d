"""Deterministic fault injection for chaos testing.

Reference analogs: ResourceKillerActor / WorkerKillerActor / RayletKiller
(python/ray/_private/test_utils.py:1396,1446,1527) — reshaped as a small
library the train/serve/data layers and their chaos suites share instead
of each test hand-rolling kill threads.

Everything here is gated on RT_CHAOS=1 (set by `enable()`), so a stray
import in production code can never inject a fault. Injection is
deterministic by construction: faults fire at a caller-chosen point
(`once()` markers on shared storage make "exactly once across restarts"
trivial), never on a timer.

Driver-side injections (drain, poll delay) live in process-local state;
worker-side helpers (`die`, `sever_dcn_peer`) execute inside the worker
that calls them — ship them there with `worker_group.execute*` or call
them from the training loop itself.

Injection table (all gated on RT_CHAOS=1):

  hook                      | fires in          | models
  --------------------------|-------------------|------------------------
  die()                     | calling worker    | host preemption
  sever_dcn_peer(rank)      | calling worker    | network partition
  kill_rank(group, rank)    | driver            | train-worker host death
  inject_drain(ranks)       | driver            | preemption notice
  delay_polls(s, n)         | driver            | saturated control plane
  delay_object_pulls(s, n)  | raylet (local)    | slow cross-node fetch
  delay_steps(s, n)         | calling process   | straggling train rank
  delay_prefills(s, n)      | replica process   | huge-prompt HOL blocker
  kill_replica(app, index)  | driver            | serve replica death
  delay_dispatch(s, n)      | handle process    | slow router dispatch
  drop_controller()         | driver            | serve controller crash
  delay_dcn_send(s, n)      | calling process   | DCN per-message latency
  cap_dcn_bandwidth(B/s)    | calling process   | DCN bandwidth ceiling
  preempt_node(node_id)     | driver (GCS RPC)  | node-scope chip reclaim
  reclaim_chips(n)          | driver (GCS RPC)  | partial chip reclaim (elastic shrink)
  lift_fence()              | driver (GCS RPC)  | claimant releases (elastic grow-back)
  kill_victim_mid_drain()   | driver            | victim dies while draining
  flush_prefix_cache()      | replica process   | prefix-cache cold start
  exhaust_kv_pages(frac)    | replica process   | KV page-pool pressure
  kill_replica_at(t, app)   | driver (sched)    | replica death at trace time t
  drop_controller_at(t)     | driver (sched)    | controller crash at trace time t
  anchor_schedule(off)      | driver (sched)    | pins t=0 for the *_at faults
  postmortem(reason)        | driver (GCS RPC)  | manual black-box dump trigger

Every hook journals a ``chaos.injected`` event at fire time (the
cluster black box, util/journal.py), so an assembled postmortem
timeline starts at the injection that provoked it — the causal chain
is reconstructable without cross-referencing the test source.

Schedule-anchored faults (`*_at`) fire at a fixed offset from an anchor
set by `anchor_schedule()` — the same t=0 a recorded loadgen trace
replays against, so a chaos scenario replays deterministically alongside
the traffic that provoked it.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Set

from ray_tpu_torch.util import journal

logger = logging.getLogger("ray_tpu_torch.chaos")

_ENV = "RT_CHAOS"

_lock = threading.Lock()
# rank -> pretend "this rank's node is draining" (consumed once, like a
# real preemption notice).
_injected_drain_ranks: Set[int] = set()
# Deterministic delay applied to the next executor polls (seconds, count).
_poll_delay_s: float = 0.0
_poll_delays_left: int = 0
# Deterministic delay applied to the next raylet object pulls
# (wait_object_local), modelling slow cross-node transfer.
_pull_delay_s: float = 0.0
_pull_delays_left: int = 0
# Deterministic delay applied to the next training steps (consumed by
# the flight recorder's StepProfiler), modelling a straggling rank.
_step_delay_s: float = 0.0
_step_delays_left: int = 0
_prefill_delay_s: float = 0.0
_prefill_delays_left: int = 0
# Deterministic delay applied to the next handle dispatches (consumed by
# DeploymentHandle.remote before the replica call), modelling a slow
# router so deadline-propagation tests can burn budget at a chosen hop.
_dispatch_delay_s: float = 0.0
_dispatch_delays_left: int = 0
# Deterministic per-message latency on the next DCN socket sends plus an
# optional bandwidth ceiling (consumed by dcn_group._Peer.send_bytes) —
# turns the loopback TCP of CPU tests into a modelable slow tier so the
# collective-algorithm benches measure deterministic cost, not scheduler
# noise.
_dcn_send_delay_s: float = 0.0
_dcn_send_delays_left: int = 0
_dcn_bandwidth_cap_bps: float = 0.0
# Paged-KV faults (consumed by ContinuousBatchingEngine's loop): a
# one-shot prefix-cache flush, and a PERSISTENT pool-pressure fraction
# (the engine holds that share of pages until it is set back to 0 —
# a memory squeeze, not an event). -1 = no injection.
_flush_prefix_pending: bool = False
_kv_exhaust_frac: float = -1.0
# Schedule-anchored fault windows: entries fire at anchor + entry["t"]
# on a daemon scheduler thread (started lazily, exits when the schedule
# drains or clear() empties it).
_sched_anchor: Optional[float] = None
_sched_faults: List[Dict] = []
_sched_thread_alive: bool = False


def enabled() -> bool:
    return os.environ.get(_ENV, "").lower() in ("1", "true", "yes")


def enable():
    """Turn fault injection on for this process AND its future children
    (worker processes inherit the environment)."""
    os.environ[_ENV] = "1"


def disable():
    os.environ.pop(_ENV, None)
    clear()


def clear():
    """Drop all pending driver-side injections."""
    global _poll_delay_s, _poll_delays_left
    global _pull_delay_s, _pull_delays_left
    global _step_delay_s, _step_delays_left
    global _prefill_delay_s, _prefill_delays_left
    global _dispatch_delay_s, _dispatch_delays_left
    global _dcn_send_delay_s, _dcn_send_delays_left, _dcn_bandwidth_cap_bps
    global _flush_prefix_pending, _kv_exhaust_frac
    global _sched_anchor
    with _lock:
        _injected_drain_ranks.clear()
        _sched_anchor = None
        # Emptying the list retires the scheduler thread at its next
        # tick (it exits when nothing is pending).
        _sched_faults.clear()
        _flush_prefix_pending = False
        _kv_exhaust_frac = -1.0
        _poll_delay_s = 0.0
        _poll_delays_left = 0
        _pull_delay_s = 0.0
        _pull_delays_left = 0
        _step_delay_s = 0.0
        _step_delays_left = 0
        _prefill_delay_s = 0.0
        _prefill_delays_left = 0
        _dispatch_delay_s = 0.0
        _dispatch_delays_left = 0
        _dcn_send_delay_s = 0.0
        _dcn_send_delays_left = 0
        _dcn_bandwidth_cap_bps = 0.0


def _require_enabled(what: str):
    if not enabled():
        raise RuntimeError(
            f"chaos.{what} called without RT_CHAOS=1 — call chaos.enable() "
            f"first (fault injection is refused in production)"
        )
    # Every armed injection leaves a journal fingerprint at fire time, so
    # a postmortem timeline opens with the fault that provoked it.
    journal.emit("chaos.injected", hook=what)


# -- cross-process / cross-attempt determinism ---------------------------
def once(marker_dir: str, key: str) -> bool:
    """True exactly once per (marker_dir, key), across processes and
    restart attempts — the standard guard so an injected fault fires on
    attempt 1 and never again. Atomic via O_CREAT|O_EXCL."""
    path = os.path.join(marker_dir, f".chaos_once_{key}")
    try:
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return False
    os.close(fd)
    return True


# -- worker-side faults --------------------------------------------------
def die(exit_code: int = 1):
    """Kill this process like a preempted host would: immediate, no
    cleanup handlers, no goodbye to the raylet (os._exit ~ SIGKILL)."""
    _require_enabled("die")
    os._exit(exit_code)


def sever_dcn_peer(peer_rank: int, group_name: str = "default"):
    """Cut this process's DCN sockets to/from `peer_rank` — the network
    analog of a host vanishing: the peer's next op on the link raises
    (closed) and ours times out instead of hanging."""
    _require_enabled("sever_dcn_peer")
    from ray_tpu_torch.util.collective.collective import _manager

    group = _manager.get(group_name)
    for table in (group._accepted, group._outgoing):
        peer = table.pop(peer_rank, None)
        if peer is not None:
            try:
                peer.sock.close()
            except OSError:
                pass


# -- driver-side faults --------------------------------------------------
def kill_rank(worker_group, rank: int):
    """Hard-kill one rank's TrainWorker actor (preemption of its host)."""
    _require_enabled("kill_rank")
    import ray_tpu_torch as rt

    rt.kill(worker_group.workers[rank])


def inject_drain(ranks: Iterable[int]):
    """Pretend the nodes hosting `ranks` received a preemption notice.
    Consumed by BackendExecutor.draining_ranks() exactly once (a real
    drain persists in the GCS node table; the injected one must not
    re-trigger after the gang restarts elsewhere)."""
    _require_enabled("inject_drain")
    with _lock:
        _injected_drain_ranks.update(int(r) for r in ranks)


def take_injected_drain_ranks() -> Set[int]:
    """Pop all injected drain ranks (empty when chaos is off)."""
    if not enabled():
        return set()
    with _lock:
        out = set(_injected_drain_ranks)
        _injected_drain_ranks.clear()
    return out


def delay_polls(seconds: float, count: int = 1):
    """Deterministically slow down the next `count` executor polls —
    models a saturated control plane without nondeterministic sleeps
    scattered through tests."""
    _require_enabled("delay_polls")
    global _poll_delay_s, _poll_delays_left
    with _lock:
        _poll_delay_s = float(seconds)
        _poll_delays_left = int(count)


def take_poll_delay() -> Optional[float]:
    """Pop one pending poll delay (None when chaos is off or exhausted)."""
    if not enabled():
        return None
    global _poll_delays_left
    with _lock:
        if _poll_delays_left <= 0:
            return None
        _poll_delays_left -= 1
        return _poll_delay_s


def delay_object_pulls(seconds: float, count: int = 1):
    """Deterministically slow down the next `count` object pulls
    (raylet wait_object_local) — models slow cross-node transfer, so
    feed-pipeline tests and benches see a realistic fetch-latency-bound
    regime without real multi-node network. Driver-process raylets only
    (cluster_utils nodes share this process's state)."""
    _require_enabled("delay_object_pulls")
    global _pull_delay_s, _pull_delays_left
    with _lock:
        _pull_delay_s = float(seconds)
        _pull_delays_left = int(count)


def take_pull_delay() -> Optional[float]:
    """Pop one pending object-pull delay (None when chaos is off or
    exhausted)."""
    if not enabled():
        return None
    global _pull_delays_left
    with _lock:
        if _pull_delays_left <= 0:
            return None
        _pull_delays_left -= 1
        return _pull_delay_s


def delay_steps(seconds: float, count: int = 1):
    """Deterministically slow down this process's next `count` training
    steps (consumed by flight_recorder.StepProfiler at step start) —
    models a straggling rank for skew-attribution tests without
    nondeterministic sleeps in the loop body. Process-local: call it
    from inside the rank you want to slow."""
    _require_enabled("delay_steps")
    global _step_delay_s, _step_delays_left
    with _lock:
        _step_delay_s = float(seconds)
        _step_delays_left = int(count)


def take_step_delay() -> Optional[float]:
    """Pop one pending step delay (None when chaos is off or exhausted).

    Runs once per training step, so the common no-injection case exits
    on a plain global read before touching os.environ or the lock."""
    global _step_delays_left
    if _step_delays_left <= 0 or not enabled():
        return None
    with _lock:
        if _step_delays_left <= 0:
            return None
        _step_delays_left -= 1
        return _step_delay_s


def delay_prefills(seconds: float, count: int = 1):
    """Deterministically stretch this process's next `count` engine
    prefill passes (consumed by ContinuousBatchingEngine at prefill
    start) — models a long-prompt head-of-line blocker for the serve
    observatory's HOL-attribution tests without needing a genuinely
    huge prompt. Process-local: call it inside the replica process."""
    _require_enabled("delay_prefills")
    global _prefill_delay_s, _prefill_delays_left
    with _lock:
        _prefill_delay_s = float(seconds)
        _prefill_delays_left = int(count)


def take_prefill_delay() -> Optional[float]:
    """Pop one pending prefill delay (None when chaos is off/exhausted).

    Runs once per prefill pass — never on the steady-state decode path —
    and the no-injection case exits on a plain global read."""
    global _prefill_delays_left
    if _prefill_delays_left <= 0 or not enabled():
        return None
    with _lock:
        if _prefill_delays_left <= 0:
            return None
        _prefill_delays_left -= 1
        return _prefill_delay_s


# -- serve-side faults ----------------------------------------------------
def kill_replica(app: str, index: int = 0):
    """Hard-kill one replica of a serve app (the serving analog of
    kill_rank): looks the current replica set up from the controller and
    SIGKILLs replica `index`. Deterministic: the caller picks which
    replica dies and when; the controller's health pass + the handles'
    redispatch path then have to recover. Returns the killed replica's
    actor id hex so tests can assert replacement."""
    _require_enabled("kill_replica")
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.config import get_config
    from ray_tpu_torch.serve.controller import CONTROLLER_NAME

    ctrl = rt.get_actor(CONTROLLER_NAME)
    info = rt.get(ctrl.get_replicas.remote(app),
                  timeout=get_config().serve_probe_timeout_s)
    replicas = info["replicas"]
    if not replicas:
        raise RuntimeError(f"chaos.kill_replica: app {app!r} has no replicas")
    victim = replicas[index % len(replicas)]
    journal.emit("chaos.kill_replica", app=app, index=int(index),
                 actor_id=victim._actor_id.hex())
    rt.kill(victim)
    return victim._actor_id.hex()


def delay_dispatch(seconds: float, count: int = 1):
    """Deterministically slow down this process's next `count` handle
    dispatches (consumed by DeploymentHandle.remote just before the
    replica call) — lets deadline-propagation tests burn a request's
    budget at the dispatch hop without nondeterministic sleeps."""
    _require_enabled("delay_dispatch")
    global _dispatch_delay_s, _dispatch_delays_left
    with _lock:
        _dispatch_delay_s = float(seconds)
        _dispatch_delays_left = int(count)


def take_dispatch_delay() -> Optional[float]:
    """Pop one pending dispatch delay (None when chaos is off/exhausted).
    Runs once per handle dispatch; the no-injection case exits on a
    plain global read before touching os.environ or the lock."""
    global _dispatch_delays_left
    if _dispatch_delays_left <= 0 or not enabled():
        return None
    with _lock:
        if _dispatch_delays_left <= 0:
            return None
        _dispatch_delays_left -= 1
        return _dispatch_delay_s


# -- DCN wire faults ------------------------------------------------------
def delay_dcn_send(seconds: float, count: int = 1):
    """Deterministically add `seconds` of latency to this process's next
    `count` DCN socket sends (consumed by the collective transport just
    before sendall) — models per-message DCN latency (the alpha term of
    the cost model) so algorithm-selection benches on loopback TCP
    measure a deterministic latency regime. Process-local: call it
    inside the rank whose sends should stall."""
    _require_enabled("delay_dcn_send")
    global _dcn_send_delay_s, _dcn_send_delays_left
    with _lock:
        _dcn_send_delay_s = float(seconds)
        _dcn_send_delays_left = int(count)


def take_dcn_send_delay() -> Optional[float]:
    """Pop one pending DCN send delay (None when chaos is off or
    exhausted). Runs on every DCN message, so the no-injection case
    exits on a plain global read before touching os.environ or the
    lock."""
    global _dcn_send_delays_left
    if _dcn_send_delays_left <= 0 or not enabled():
        return None
    with _lock:
        if _dcn_send_delays_left <= 0:
            return None
        _dcn_send_delays_left -= 1
        return _dcn_send_delay_s


def cap_dcn_bandwidth(bytes_per_s: float):
    """Impose a bandwidth ceiling on this process's DCN sends until
    cleared: each message sleeps nbytes/bytes_per_s before hitting the
    socket (the beta term of the cost model). Unlike the counted delays
    this persists until clear()/disable() — a slow tier, not an event.
    Pass 0 to lift the cap."""
    _require_enabled("cap_dcn_bandwidth")
    global _dcn_bandwidth_cap_bps
    if bytes_per_s < 0:
        raise ValueError("bandwidth cap must be >= 0")
    with _lock:
        _dcn_bandwidth_cap_bps = float(bytes_per_s)


def dcn_bandwidth_cap() -> Optional[float]:
    """The active DCN bandwidth cap in bytes/s (None when chaos is off
    or no cap is set). Fast path: plain global read first."""
    if not _dcn_bandwidth_cap_bps or not enabled():
        return None
    return _dcn_bandwidth_cap_bps


# -- preemption faults -----------------------------------------------------
def preempt_node(node_id: bytes):
    """Node-scope preemption (a spot/maintenance reclaim of one host):
    asks the GCS to cordon `node_id` and open a grace-then-hard-kill
    eviction record for every CREATED placement group holding a bundle
    there. Deterministic: the caller picks the node and the moment.
    Returns the list of victim placement-group ids (hex)."""
    _require_enabled("preempt_node")
    from ray_tpu_torch._private import worker as worker_mod

    client = worker_mod.get_client()
    resp = client._run(
        client._gcs_call("preempt_node", {"node_id": node_id})
    )
    if not resp.get("ok"):
        raise RuntimeError(
            f"chaos.preempt_node: {resp.get('error', 'preempt_node failed')}"
        )
    return [v.hex() for v in resp.get("victims", [])]


def reclaim_chips(amount: float, resource: str = "GPU",
                  bundle_chips: Optional[float] = None,
                  priority: int = 1_000_000):
    """Partial chip reclamation (a serve spike claiming k < gang_size
    chips): runs the GCS's real reclamation pass under a synthetic
    top-priority claimant that needs `amount` of `resource`, split into
    bundles of `bundle_chips` each (default: one bundle of `amount`).
    The claimed victim bundles drain; an elastic gang sheds exactly
    those ranks and keeps training. The sentinel claimant never places,
    so the chips stay fenced until lift_fence(). Deterministic: fires
    the pass inline, no health-loop timing involved. Returns the victim
    list: [{"victim_pg_id", "partial", "bundle_indices"}, ...]."""
    _require_enabled("reclaim_chips")
    from ray_tpu_torch._private import worker as worker_mod

    client = worker_mod.get_client()
    req = {"amount": float(amount), "resource": resource,
           "priority": int(priority)}
    if bundle_chips is not None:
        req["bundle_chips"] = float(bundle_chips)
    resp = client._run(client._gcs_call("chaos_reclaim_chips", req))
    if not resp.get("ok"):
        raise RuntimeError(
            f"chaos.reclaim_chips: {resp.get('error', 'reclaim failed')}"
        )
    return resp.get("victims", [])


def lift_fence():
    """Release every chaos reclamation claim (the synthetic claimant
    goes away): still-draining chaos evictions are cancelled, armed
    resize obligations flip to lifted — the grow-back signal elastic
    trainers poll — and the fences clear. Returns the number of
    obligations lifted."""
    _require_enabled("lift_fence")
    from ray_tpu_torch._private import worker as worker_mod

    client = worker_mod.get_client()
    resp = client._run(client._gcs_call("chaos_lift_fence", {}))
    if not resp.get("ok"):
        raise RuntimeError("chaos.lift_fence failed")
    return int(resp.get("lifted", 0))


def kill_victim_mid_drain():
    """Kill one actor of a currently-draining preemption victim — the
    worst-case compound fault: the gang dies *while* it is gracefully
    checkpointing out. The hard-kill deadline and the trainer's crash
    path must still converge (no wedged placement groups). Returns the
    killed actor's id hex."""
    _require_enabled("kill_victim_mid_drain")
    from ray_tpu_torch._private import worker as worker_mod

    client = worker_mod.get_client()
    resp = client._run(client._gcs_call("get_preemptions", {}))
    for rec in resp.get("preemptions", []):
        if rec.get("state") != "draining":
            continue
        for aid in rec.get("victim_actors", []):
            client._run(
                client._gcs_call(
                    "kill_actor", {"actor_id": aid, "no_restart": True}
                )
            )
            return aid.hex()
    raise RuntimeError(
        "chaos.kill_victim_mid_drain: no draining victim with live actors"
    )


def flush_prefix_cache():
    """Drop every resident prefix-cache entry in THIS process's serving
    engine(s) at their next loop tick — a deterministic cold-cache
    transition (rolling restart, cache invalidation) without restarting
    the replica. One-shot: consumed once. Process-local: call it inside
    the replica process (serve tests use worker_group.execute or a
    replica method)."""
    _require_enabled("flush_prefix_cache")
    global _flush_prefix_pending
    with _lock:
        _flush_prefix_pending = True


def take_flush_prefix_cache() -> bool:
    """Pop the pending prefix-cache flush (False when chaos is off or
    none pending). Runs every engine loop iteration, so the
    no-injection case exits on a plain global read."""
    global _flush_prefix_pending
    if not _flush_prefix_pending or not enabled():
        return False
    with _lock:
        if not _flush_prefix_pending:
            return False
        _flush_prefix_pending = False
        return True


def exhaust_kv_pages(frac: float):
    """Squeeze the paged-KV pool: the engine holds `frac` of its usable
    pages hostage (admissions then queue on pool pressure) until a
    later call sets the fraction back to 0.0. Unlike the counted delays
    this PERSISTS — it models a memory squeeze (fragmentation, a noisy
    co-tenant), not an event. Process-local, like flush_prefix_cache."""
    _require_enabled("exhaust_kv_pages")
    if not 0.0 <= frac <= 1.0:
        raise ValueError("exhaust_kv_pages frac must be in [0, 1]")
    global _kv_exhaust_frac
    with _lock:
        _kv_exhaust_frac = float(frac)


def kv_exhaust_frac() -> Optional[float]:
    """The active pool-pressure fraction (None when chaos is off or no
    squeeze is set). Runs every engine loop iteration: plain global
    read first."""
    if _kv_exhaust_frac < 0 or not enabled():
        return None
    return _kv_exhaust_frac


def drop_controller(restart: bool = True):
    """Crash the serve controller actor (SIGKILL-style). With
    restart=True (the default) the GCS replays the creation spec —
    max_restarts=-1 — and the restarted controller restores from its
    KV checkpoint; restart=False pins it dead so tests can exercise the
    handles-serve-from-cached-routes window. Returns the old actor's
    id hex."""
    _require_enabled("drop_controller")
    import ray_tpu_torch as rt
    from ray_tpu_torch.serve.controller import CONTROLLER_NAME

    ctrl = rt.get_actor(CONTROLLER_NAME)
    journal.emit("chaos.drop_controller", restart=bool(restart),
                 actor_id=ctrl._actor_id.hex())
    rt.kill(ctrl, no_restart=not restart)
    return ctrl._actor_id.hex()


def postmortem(reason: str = "chaos.postmortem") -> str:
    """Force a cluster-wide black-box dump NOW (bypasses the failure
    cooldown): every connected process freezes its journal ring into a
    bundle directory that `rt postmortem` can assemble. Deterministic
    capture point for chaos suites — inject a fault, let the cluster
    react, then snapshot exactly when the scenario says to. Returns the
    bundle directory path."""
    _require_enabled("postmortem")
    from ray_tpu_torch._private import worker as worker_mod

    client = worker_mod.get_client()
    resp = client._run(
        client._gcs_call(
            "journal_trigger",
            {"reason": reason, "source": "chaos", "force": True},
        )
    )
    if not resp.get("triggered"):
        raise RuntimeError("chaos.postmortem: trigger suppressed")
    return resp["bundle"]


# -- schedule-anchored fault windows ---------------------------------------
def anchor_schedule(offset_s: float = 0.0) -> None:
    """Pin t=0 of the fault schedule to ``now - offset_s`` — the same
    origin a loadgen run (or trace replay) measures its arrival offsets
    from. Registered ``*_at(t)`` faults then fire at schedule-relative
    times, so a recorded chaos scenario replays deterministically
    alongside the recorded traffic. Re-anchoring moves t=0 for every
    not-yet-fired entry."""
    _require_enabled("anchor_schedule")
    global _sched_anchor
    with _lock:
        _sched_anchor = time.monotonic() - float(offset_s)
    _ensure_sched_thread()


def kill_replica_at(t: float, app: str, index: int = 0) -> None:
    """Schedule kill_replica(app, index) at schedule time ``t`` seconds
    (relative to the anchor_schedule origin). Registration is allowed
    before anchoring; the fault arms once the anchor exists."""
    _require_enabled("kill_replica_at")
    _schedule_fault("kill_replica", t, {"app": app, "index": int(index)})


def drop_controller_at(t: float, restart: bool = True) -> None:
    """Schedule drop_controller(restart) at schedule time ``t`` seconds
    (relative to the anchor_schedule origin)."""
    _require_enabled("drop_controller_at")
    _schedule_fault("drop_controller", t, {"restart": bool(restart)})


def scheduled_faults() -> List[Dict]:
    """JSON-safe copy of the fault schedule ({kind, t, kwargs, fired,
    result}) — recorded next to a loadgen trace so replays re-register
    the identical scenario."""
    with _lock:
        return [dict(e, kwargs=dict(e["kwargs"])) for e in _sched_faults]


def _schedule_fault(kind: str, t: float, kwargs: Dict) -> None:
    if t < 0:
        raise ValueError(f"chaos schedule time must be >= 0, got {t}")
    with _lock:
        _sched_faults.append({
            "kind": kind, "t": float(t), "kwargs": kwargs,
            "fired": False, "result": None,
        })
    _ensure_sched_thread()


def _ensure_sched_thread() -> None:
    global _sched_thread_alive
    with _lock:
        if _sched_thread_alive:
            return
        _sched_thread_alive = True
    threading.Thread(
        target=_sched_loop, name="rt-chaos-scheduler", daemon=True,
    ).start()


def _sched_loop() -> None:
    """Fire due faults every 20ms until the schedule drains (or clear()
    empties it). Exit and the alive flag flip happen under the SAME lock
    hold as the emptiness check, so a fault registered concurrently
    either keeps this thread alive or starts a fresh one — never
    stranded. Execution happens on this thread — the driver process,
    where kill_replica/drop_controller expect to run."""
    global _sched_thread_alive
    while True:
        due = []
        with _lock:
            pending = [e for e in _sched_faults if not e["fired"]]
            if not pending or not enabled():
                _sched_thread_alive = False
                return
            anchor = _sched_anchor
            if anchor is not None:
                now = time.monotonic() - anchor
                for e in pending:
                    if e["t"] <= now:
                        e["fired"] = True
                        due.append(e)
        for e in due:
            with _lock:
                if e not in _sched_faults:  # clear() raced the firing
                    continue
            try:
                journal.emit("chaos.scheduled_fire", fault=e["kind"],
                             t=e["t"], kwargs=dict(e["kwargs"]))
                if e["kind"] == "kill_replica":
                    e["result"] = kill_replica(**e["kwargs"])
                elif e["kind"] == "drop_controller":
                    e["result"] = drop_controller(**e["kwargs"])
            except Exception as err:  # noqa: BLE001 — a failed
                # injection (app already gone, controller mid-restart)
                # must not kill the scheduler or the run; the entry
                # records what happened for the trace.
                e["result"] = f"error: {err}"
                logger.warning(
                    "scheduled chaos fault %s(%s) at t=%.3f failed",
                    e["kind"], e["kwargs"], e["t"], exc_info=True,
                )
        time.sleep(0.02)
