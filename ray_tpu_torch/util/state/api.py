"""State API client: list/summarize cluster entities from the GCS.

Reference analog: python/ray/util/state/api.py (StateApiClient over the
dashboard REST API) + state_manager.py (aggregation from GcsTaskManager and
raylets). Here the client talks straight to the GCS over the control-plane
protocol; per-node worker listings fan out to each raylet's get_info.
"""

from __future__ import annotations

import os
import sys
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.node import EventLoopThread
from ray_tpu_torch._private.protocol import connect


def _hex(b) -> str:
    return b.hex() if isinstance(b, (bytes, bytearray)) else str(b)


def fetch_task_events(call, page: int = 10_000, warn: bool = True) -> List[dict]:
    """Fetch the FULL task-event ring via offset pagination.

    `call` is any callable(method, payload) -> reply dict. Replaces the
    old single `limit=100_000` fetch that silently truncated; when the
    GCS reports evicted events ("dropped"), a warning lands on stderr so
    truncated history is never mistaken for complete history.
    """
    events: List[dict] = []
    offset = 0
    dropped = 0
    while True:
        r = call("list_task_events", {"offset": offset, "limit": page})
        evs = r.get("events", [])
        events.extend(evs)
        dropped = r.get("dropped", 0)
        total = r.get("total")
        if total is None:
            break  # pre-pagination server: one tail page is all there is
        offset += len(evs)
        if not evs or offset >= total:
            break
    if warn and dropped:
        print(
            f"warning: GCS task-event ring evicted {dropped} old events; "
            "timeline/trace history is incomplete",
            file=sys.stderr,
        )
    return events


class StateApiClient:
    """Dial the GCS directly (or reuse the connected driver's session)."""

    def __init__(self, address: Optional[str] = None):
        self._own_io: Optional[EventLoopThread] = None
        self._conn = None
        client = worker_mod.get_client_or_none()
        if address is None and client is not None and getattr(client, "gcs", None):
            self._loop = client.loop
            self._conn = client.gcs
        else:
            if address is None:
                address = os.environ.get("RT_GCS_ADDR")
            if address is None:
                raise RuntimeError(
                    "not connected: call rt.init() or pass address='host:port'"
                )
            host, port = address.rsplit(":", 1)
            self._own_io = EventLoopThread("rt-state")
            self._loop = self._own_io.loop
            self._conn = self._run_new(connect(host, int(port)))

    def _run_new(self, coro, timeout=30.0):
        import asyncio

        return asyncio.run_coroutine_threadsafe(coro, self._loop).result(timeout)

    def call(self, method: str, payload: Dict[str, Any] | None = None):
        return self._run_new(self._conn.call(method, payload or {}))

    def close(self):
        if self._own_io is not None:
            try:
                self._run_new(self._conn.close(), timeout=5)
            except Exception:
                pass
            self._own_io.stop()
            self._own_io = None

    # -- listings --------------------------------------------------------
    def nodes(self) -> List[dict]:
        out = []
        for n in self.call("get_nodes")["nodes"]:
            out.append(
                {
                    "node_id": _hex(n["node_id"]),
                    "state": n["state"],
                    "draining": bool(n.get("draining", False)),
                    "address": f"{n['address']}:{n['port']}",
                    "is_head": n.get("is_head", False),
                    "resources_total": n.get("resources_total", {}),
                    "resources_available": n.get("resources_available", {}),
                    "labels": n.get("labels", {}),
                }
            )
        return out

    def worker_stacks(self) -> List[dict]:
        """Live thread stacks of every worker on every node (the `rt
        stack` view; reference: dashboard py-spy on-demand profiling)."""
        import asyncio

        from ray_tpu_torch._private.protocol import connect as _connect

        out: List[dict] = []
        for n in self.call("get_nodes")["nodes"]:
            if n["state"] != "ALIVE":
                continue

            async def _collect(addr=n["address"], port=n["port"]):
                conn = await _connect(addr, port, timeout=5)
                try:
                    return await asyncio.wait_for(
                        conn.call("worker_stacks", {}), 30
                    )
                finally:
                    await conn.close()

            try:
                r = self._run_new(_collect(), timeout=40)
            except Exception as e:  # noqa: BLE001 — node unreachable
                out.append({"node_id": _hex(n["node_id"]),
                            "error": f"{type(e).__name__}: {e}"})
                continue
            for w in r["workers"]:
                w = dict(w)
                w["node_id"] = _hex(n["node_id"])
                if isinstance(w.get("worker_id"), bytes):
                    w["worker_id"] = _hex(w["worker_id"])
                out.append(w)
        return out

    def task_events(self, warn: bool = True) -> List[dict]:
        """Every event in the GCS ring (paginated; warns if truncated)."""
        return fetch_task_events(self.call, warn=warn)

    def tasks(self, limit: int = 1000) -> List[dict]:
        events = self.task_events()
        # Collapse the event log into latest-state-per-task
        # (GcsTaskManager's task view).
        tasks: Dict[bytes, dict] = {}
        for ev in events:
            if ev.get("type") == "LIFECYCLE_SPAN":
                # Phase-mark events are per-hop profiler payloads, not
                # task state transitions.
                continue
            t = tasks.setdefault(
                ev["task_id"],
                {
                    "task_id": _hex(ev["task_id"]),
                    "name": ev.get("name", ""),
                    "job_id": _hex(ev.get("job_id", b"")),
                    "type": ev.get("type", "NORMAL_TASK"),
                    "events": [],
                },
            )
            t["state"] = ev["state"]
            t["node_id"] = _hex(ev.get("node_id", b""))
            if ev.get("worker_id"):
                t["worker_id"] = _hex(ev["worker_id"])
            t["events"].append({"state": ev["state"], "ts": ev["ts"]})
        out = list(tasks.values())[-limit:]
        for t in out:
            ts = {e["state"]: e["ts"] for e in t.pop("events")}
            if "RUNNING" in ts:
                end = ts.get("FINISHED") or ts.get("FAILED")
                if end is not None:
                    t["duration_s"] = round(end - ts["RUNNING"], 6)
        return out

    def actors(self) -> List[dict]:
        out = []
        for a in self.call("list_actors")["actors"]:
            out.append(
                {
                    "actor_id": _hex(a["actor_id"]),
                    "class_name": a.get("class_name", ""),
                    "state": a.get("state", ""),
                    "name": a.get("name") or "",
                    "node_id": _hex(a.get("node_id") or b""),
                    "pid": a.get("pid"),
                    "restarts": a.get("restarts_used", 0),
                }
            )
        return out

    def objects(self, limit: int = 10_000) -> List[dict]:
        out = []
        for o in self.call("list_objects", {"limit": limit})["objects"]:
            out.append(
                {
                    "object_id": _hex(o["object_id"]),
                    "size": o["size"],
                    "locations": [_hex(n) for n in o["nodes"]],
                }
            )
        return out

    def jobs(self) -> List[dict]:
        return [
            {**j, "job_id": _hex(j.get("job_id", b""))}
            for j in self.call("list_jobs")["jobs"]
        ]

    def placement_groups(self) -> List[dict]:
        out = []
        for pg in self.call("list_placement_groups")["pgs"]:
            out.append(
                {
                    "pg_id": _hex(pg["pg_id"]),
                    "name": pg.get("name", ""),
                    "state": pg["state"],
                    "strategy": pg["strategy"],
                    "bundles": pg["bundles"],
                    "bundle_nodes": [
                        _hex(n) if n else None for n in pg.get("bundle_nodes", [])
                    ],
                }
            )
        return out

    def workers(self) -> List[dict]:
        """Fan out to every raylet for its worker pool state."""
        out = []
        for n in self.call("get_nodes")["nodes"]:
            if n["state"] != "ALIVE":
                continue
            try:
                conn = self._run_new(connect(n["address"], n["port"]))
                info = self._run_new(conn.call("get_info", {}))
                self._run_new(conn.close(), timeout=5)
            except Exception:
                continue
            for w in info.get("workers", []):
                out.append(
                    {
                        "worker_id": _hex(w["worker_id"]),
                        "node_id": _hex(n["node_id"]),
                        "pid": w.get("pid"),
                        "idle": w.get("idle"),
                        "actor_id": _hex(w["actor_id"]) if w.get("actor_id") else None,
                    }
                )
        return out

    def timeline(self, lifecycle: bool = False) -> List[dict]:
        """Chrome-trace events (ray timeline analog,
        _private/profiling.py:124 chrome_tracing_dump). With
        lifecycle=True, sampled tasks' control-plane phase marks
        (LIFECYCLE_SPAN events) become their own rows — one lane per
        hop (client/raylet/worker) under the emitting node."""
        events = self.task_events()
        spans: Dict[bytes, dict] = {}
        trace: List[dict] = []
        for ev in events:
            key = ev["task_id"]
            if ev.get("type") == "LIFECYCLE_SPAN":
                if not lifecycle:
                    continue
                extra = ev.get("extra") or {}
                hop = extra.get("hop", "?")
                for phase, mark in (extra.get("phases") or {}).items():
                    try:
                        start, dur = float(mark[0]), float(mark[1])
                    except (TypeError, ValueError, IndexError):
                        continue
                    trace.append(
                        {
                            "name": phase,
                            "cat": "lifecycle",
                            "ph": "X",
                            "ts": start * 1e6,
                            "dur": dur * 1e6,
                            "pid": "node:" + _hex(ev.get("node_id", b""))[:8],
                            "tid": f"lifecycle:{hop}",
                            "args": {
                                "task_id": _hex(key),
                                "task": ev.get("name", ""),
                                "hop": hop,
                            },
                        }
                    )
                continue
            if ev["state"] == "RUNNING":
                spans[key] = ev
            elif ev["state"] in ("FINISHED", "FAILED") and key in spans:
                start = spans.pop(key)
                trace.append(
                    {
                        "name": ev.get("name") or _hex(key)[:8],
                        "cat": ev.get("type", "NORMAL_TASK").lower(),
                        "ph": "X",
                        "ts": start["ts"] * 1e6,
                        "dur": max(0.0, (ev["ts"] - start["ts"]) * 1e6),
                        "pid": "node:" + _hex(ev.get("node_id", b""))[:8],
                        "tid": "worker:" + _hex(ev.get("worker_id", b""))[:8],
                        "args": {"state": ev["state"]},
                    }
                )
        return trace


def _with_client(fn):
    def wrapper(*args, address: Optional[str] = None, **kwargs):
        client = StateApiClient(address)
        try:
            return fn(client, *args, **kwargs)
        finally:
            client.close()

    wrapper.__name__ = fn.__name__
    return wrapper


@_with_client
def list_nodes(c):
    return c.nodes()


@_with_client
def list_tasks(c, limit: int = 1000):
    return c.tasks(limit)


@_with_client
def list_actors(c):
    return c.actors()


@_with_client
def list_objects(c, limit: int = 10_000):
    return c.objects(limit)


@_with_client
def list_jobs(c):
    return c.jobs()


@_with_client
def list_placement_groups(c):
    return c.placement_groups()


@_with_client
def list_workers(c):
    return c.workers()


@_with_client
def get_timeline(c, lifecycle: bool = False):
    return c.timeline(lifecycle=lifecycle)


@_with_client
def get_worker_stacks(c):
    return c.worker_stacks()


@_with_client
def summarize_tasks(c):
    """`ray summary tasks` analog: counts by (name, state)."""
    summary: Dict[str, Dict[str, int]] = {}
    for t in c.tasks(limit=100_000):
        by_state = summary.setdefault(t["name"] or "<anonymous>", {})
        by_state[t.get("state", "?")] = by_state.get(t.get("state", "?"), 0) + 1
    return summary


@_with_client
def drain_node(c, node_id: str, timeout: float = 300.0, undo: bool = False,
               poll_s: float = 1.0):
    """Graceful node drain (reference: `ray drain-node` / autoscaler.proto
    DrainNode): cordon the node so every placement path skips it, wait
    for running work to finish (resources fully returned, no queued
    demand), then remove it. undo=True lifts a cordon instead."""
    import time as _time

    try:
        nid = bytes.fromhex(node_id)
    except ValueError:
        return {"ok": False,
                "error": f"invalid node id {node_id!r} (expected hex)"}
    if undo:
        return c.call("cordon_node", {"node_id": nid, "undo": True})
    r = c.call("cordon_node", {"node_id": nid})
    if not r.get("ok"):
        return r
    deadline = _time.monotonic() + timeout
    st: dict = {}
    idle_streak = 0
    # Two consecutive idle polls ≥0.6s apart must both pass: the GCS
    # availability view lags the raylet by one heartbeat (~0.5s), so a
    # single idle reading can predate a just-dispatched task or the
    # raylet even learning of the cordon.
    gap = max(poll_s, 0.6)
    while _time.monotonic() < deadline:
        st = c.call("node_drain_status", {"node_id": nid})
        if not st.get("ok"):
            return st
        if not st.get("draining"):
            # Cordon lifted mid-drain (rt drain --undo elsewhere, or a
            # GCS restart dropped the volatile flag): abort rather than
            # removing a node that is accepting work again.
            return {"ok": False, "error": "cordon was lifted mid-drain"}
        if st.get("state") != "ALIVE":
            # Died (or was removed) mid-drain: nothing left to wait for.
            return {"ok": True, "drained": True, "already_dead": True}
        if st.get("idle"):
            idle_streak += 1
            if idle_streak >= 2:
                c.call("drain_node", {"node_id": nid})
                return {"ok": True, "drained": True}
        else:
            idle_streak = 0
        _time.sleep(gap)
    return {"ok": False, "error": "drain timed out (node still busy; "
            "cordon stays in effect)", "status": st}


def _dial_raylet(c, node_hex, method, payload, timeout=30,
                 stop_on_ok=False):
    """Call one raylet (or every ALIVE one when node_hex is None; a hex
    PREFIX selects, so ids copied from truncated CLI output work).
    Returns [(node_hex, reply-or-error-dict)]; with stop_on_ok the dials
    stop at the first ok reply (no redundant transfers, and unreachable
    later nodes cost nothing). Raises if a requested node matches no
    ALIVE node."""
    import asyncio

    from ray_tpu_torch._private.protocol import connect as _connect

    out = []
    matched = False
    for n in c.call("get_nodes")["nodes"]:
        nid = _hex(n["node_id"])
        if n["state"] != "ALIVE":
            continue
        if node_hex is not None and not nid.startswith(node_hex):
            continue
        matched = True

        async def _one(addr=n["address"], port=n["port"]):
            conn = await _connect(addr, port, timeout=5)
            try:
                return await asyncio.wait_for(
                    conn.call(method, payload), timeout
                )
            finally:
                await conn.close()

        try:
            reply = c._run_new(_one(), timeout=timeout + 10)
        except Exception as e:  # noqa: BLE001 — node unreachable
            reply = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        out.append((nid, reply))
        if stop_on_ok and reply.get("ok"):
            break
    if node_hex is not None and not matched:
        raise ValueError(f"no ALIVE node matches id prefix {node_hex!r}")
    return out


@_with_client
def list_logs(c, node_id: str = None):
    """Per-node session log files (reference: `ray logs` listing)."""
    out = []
    for nid, r in _dial_raylet(c, node_id, "list_logs", {}):
        for entry in r.get("logs", []):
            out.append({"node_id": nid, **entry})
        if "error" in r:
            out.append({"node_id": nid, "error": r["error"]})
    return out


@_with_client
def get_log(c, filename: str, node_id: str = None,
            tail_bytes: int = 64 * 1024) -> str:
    """Tail of one log file (reference: `ray logs <file>`); node_id
    defaults to the first ALIVE node holding it."""
    errors = []
    for nid, r in _dial_raylet(
        c, node_id, "read_log", {"name": filename, "tail_bytes": tail_bytes},
        stop_on_ok=True,
    ):
        if r.get("ok"):
            return r["data"].decode(errors="replace")
        errors.append(f"{nid}: {r.get('error')}")
    raise FileNotFoundError(
        f"log {filename!r} not found on any node ({'; '.join(errors)})"
    )
