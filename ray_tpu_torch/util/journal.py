"""Cluster black box: per-process event journal with hybrid logical clocks.

The runtime's telemetry planes — the train flight recorder, the serve
observatory, the lifecycle profiler, loadgen stamp cards — each keep a
private ring with a private clock, so reconstructing *why* a client saw
a 503 after a chaos run means hand-joining five snapshots taken after
the evidence was overwritten. This module is the shared spine under all
of them: an always-on, lock-cheap, ring-buffered journal every emitter
routes one summary event through, stamped with a **hybrid logical
clock** (Kulkarni et al., "Logical Physical Clocks") so events from
different processes merge into one causally-consistent timeline despite
host clock skew.

HLC in one paragraph: a stamp is ``(pt, lc)`` — physical microseconds
plus a logical counter. A local event takes ``max(wall, last_pt)`` and
bumps ``lc`` when the wall did not advance (monotone under clock
regression); receiving a remote stamp takes the max of all three clocks
and bumps ``lc`` past whichever won, so *send happens-before receive*
holds in stamp order even when the receiver's wall clock is behind the
sender's. Stamps ride the wires that already exist: every RPC frame
(``_private/protocol.py``, the ``"h"`` field), observatory wire
contexts (handle stamp cards), and DCN identification frames.

Failure-triggered capture: typed failure observers (replica death seen
by the controller, breaker-open, collective timeout, deadline-expiry
storms, HOL detection, gang restart) call :func:`trigger_postmortem`,
which asks the GCS to fan a ``journal_dump`` push to every connected
process; each freezes its last-``journal_window_s`` ring into
``<journal_dir>/<bundle>/<label>-<pid>.jsonl``. ``rt postmortem
<bundle>`` merges the files into one HLC-ordered timeline and names the
culprit chain; ``rt timeline --cluster`` triggers a manual dump and
renders the live merged spine.

Knobs (Config fields, env-overridable): RT_JOURNAL_ENABLED,
RT_JOURNAL_RING, RT_JOURNAL_WINDOW_S, RT_JOURNAL_DIR,
RT_JOURNAL_AUTODUMP, RT_JOURNAL_COOLDOWN_S.

Steady-state cost is one short lock hold + a deque append per event
(emitters send one event per *step/request/transition*, never per
task), gated <2% on a 5 ms train step by bench_obs.py.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "HLC", "emit", "enabled", "wire_stamp", "observe_wire",
    "set_process_label", "process_label", "snapshot", "dump",
    "on_dump_trigger", "trigger_postmortem", "dump_dir", "load_bundle",
    "merge_events", "causal_chain", "render_timeline",
]


class HLC:
    """Hybrid logical clock: (physical µs, logical counter).

    ``tick()`` stamps a local/send event; ``update(remote)`` merges a
    received stamp. Both are monotone: a host clock stepping backwards
    (NTP correction, VM migration) bumps ``lc`` instead of ever issuing
    a stamp that sorts before an earlier one.
    """

    __slots__ = ("_pt", "_lc", "_lock")

    def __init__(self):
        self._pt = 0
        self._lc = 0
        self._lock = threading.Lock()

    def tick(self) -> Tuple[int, int]:
        wall = int(time.time() * 1e6)
        with self._lock:
            if wall > self._pt:
                self._pt = wall
                self._lc = 0
            else:
                self._lc += 1
            return self._pt, self._lc

    def update(self, remote: Tuple[int, int]) -> Tuple[int, int]:
        """Merge a remote stamp (message receive): the new local stamp
        sorts after both the remote stamp and every prior local one."""
        rpt, rlc = int(remote[0]), int(remote[1])
        wall = int(time.time() * 1e6)
        with self._lock:
            pt = max(wall, self._pt, rpt)
            if pt == self._pt and pt == rpt:
                lc = max(self._lc, rlc) + 1
            elif pt == self._pt:
                lc = self._lc + 1
            elif pt == rpt:
                lc = rlc + 1
            else:
                lc = 0
            self._pt, self._lc = pt, lc
            return pt, lc

    def read(self) -> Tuple[int, int]:
        with self._lock:
            return self._pt, self._lc


# -- process-wide singleton state ----------------------------------------

_hlc = HLC()
_lock = threading.Lock()
_ring: deque = deque()
_ring_max = 0
_label = ""
_events_total = 0
_dropped_total = 0
_seen_triggers: set = set()
_last_trigger_mono = 0.0
_metric_keys: Dict[str, tuple] = {}


def _cfg():
    from ray_tpu_torch._private.config import get_config

    return get_config()


def enabled() -> bool:
    return _cfg().journal_enabled


def set_process_label(label: str, weak: bool = False) -> None:
    """Name this process in dumps ("driver", "serve-controller",
    "replica:app#0", ...). ``weak=True`` only fills an unset label —
    the GCS/raylet use it so an in-process test node never clobbers
    the driver's name."""
    global _label
    if weak and _label:
        return
    _label = str(label)


def process_label() -> str:
    return _label or f"pid{os.getpid()}"


def _metrics(kind: str):
    """Keyed counter fast path per event kind; lazy so importing the
    journal never drags the metrics/worker stack in."""
    key = _metric_keys.get(kind)
    if key is None:
        from ray_tpu_torch.util import metrics as rt_metrics

        events = rt_metrics.get_or_create(
            rt_metrics.Counter, "journal_events_total",
            "Events appended to the process-local journal ring, by kind.",
            tag_keys=("kind",),
        )
        dropped = rt_metrics.get_or_create(
            rt_metrics.Counter, "journal_dropped_total",
            "Journal events overwritten before any dump captured them.",
        )
        key = (events, events._key({"kind": kind}), dropped, dropped._key(None))
        _metric_keys[kind] = key
    return key


def emit(kind: str, /, **fields: Any) -> None:
    """Append one event to this process's ring. Lock-cheap and never
    raises: the black box must not take down the component feeding it.
    ``kind`` is positional-only so a payload field named "kind" cannot
    collide at call time; envelope keys in the payload are prefixed
    rather than letting them clobber the stamp."""
    global _ring_max, _events_total, _dropped_total
    try:
        cfg = _cfg()
        if not cfg.journal_enabled:
            return
        if _ring_max != cfg.journal_ring:
            _resize_ring(cfg.journal_ring)
        pt, lc = _hlc.tick()
        rec = {"hlc": [pt, lc], "ts": time.time(), "kind": kind,
               "proc": process_label(), "pid": os.getpid()}
        for k in ("hlc", "ts", "kind", "proc", "pid"):
            if k in fields:
                fields[f"f_{k}"] = fields.pop(k)
        rec.update(fields)
        with _lock:
            dropped = len(_ring) >= _ring_max
            _ring.append(rec)
            _events_total += 1
            if dropped:
                _dropped_total += 1
        try:
            events, ek, drop_m, dk = _metrics(kind)
            events.inc_keyed(ek, 1.0)
            if dropped:
                drop_m.inc_keyed(dk, 1.0)
        except Exception:  # rtlint: disable=RT007 — metrics registry may not be up yet; the event is already in the ring
            pass
    except Exception:  # rtlint: disable=RT007 — emit() never raises by contract; the black box must not take down its feeder
        pass


def _resize_ring(n: int) -> None:
    global _ring, _ring_max
    with _lock:
        _ring = deque(_ring, maxlen=max(16, int(n)))
        _ring_max = _ring.maxlen


def counts() -> Tuple[int, int]:
    """(events_total, dropped_total) for this process."""
    with _lock:
        return _events_total, _dropped_total


# -- wire propagation -----------------------------------------------------

def wire_stamp() -> Optional[List[int]]:
    """HLC stamp for an outgoing frame ([pt_us, lc]), or None when the
    journal is disabled (the frame field is simply omitted)."""
    try:
        if not _cfg().journal_enabled:
            return None
        pt, lc = _hlc.tick()
        return [pt, lc]
    except Exception:  # rtlint: disable=RT007 — stamping must never break an RPC; the frame goes out unstamped
        return None


def observe_wire(h: Any) -> None:
    """Merge a received frame's HLC stamp into the local clock."""
    try:
        if h and _cfg().journal_enabled:
            _hlc.update((h[0], h[1]))
    except Exception:  # rtlint: disable=RT007 — a malformed wire stamp is ignored, the local clock stands
        pass


# -- freeze / dump --------------------------------------------------------

def dump_dir() -> str:
    d = _cfg().journal_dir or os.path.join(
        os.environ.get("TMPDIR", "/tmp"), "ray_tpu_torch", "postmortem"
    )
    return d


def snapshot(window_s: Optional[float] = None) -> List[Dict]:
    """Copy of the ring (oldest first), optionally only the last
    ``window_s`` seconds by wall timestamp."""
    with _lock:
        events = list(_ring)
    if window_s is not None and window_s > 0:
        cutoff = time.time() - window_s  # rtlint: disable=RT011 — deliberate wall anchor: ring events carry wall ts for cross-process stitching
        events = [e for e in events if e.get("ts", 0.0) >= cutoff]
    return events


def dump(bundle_dir: str, trigger: Optional[Dict] = None,
         window_s: Optional[float] = None) -> Optional[str]:
    """Freeze this process's ring into ``bundle_dir`` as one JSONL file.

    Returns the written path (None on failure — dumping is best-effort,
    a full disk must not crash a replica that just survived a fault)."""
    try:
        window = window_s if window_s is not None else _cfg().journal_window_s
        events = snapshot(window_s=window)
        os.makedirs(bundle_dir, exist_ok=True)
        label = process_label().replace("/", "_").replace(":", "_")
        path = os.path.join(bundle_dir, f"{label}-{os.getpid()}.jsonl")
        ev_total, drop_total = counts()
        meta = {
            "kind": "journal.meta", "proc": process_label(),
            "pid": os.getpid(), "ts": time.time(),
            "hlc": list(_hlc.read()), "events": len(events),
            "events_total": ev_total, "dropped_total": drop_total,
            "trigger": trigger or {},
        }
        with open(path, "w") as f:
            f.write(json.dumps(meta, default=str) + "\n")
            for e in events:
                f.write(json.dumps(e, default=str) + "\n")
        return path
    except Exception:  # noqa: BLE001 — best-effort by contract
        return None


def on_dump_trigger(payload: Any) -> None:
    """``journal_dump`` pubsub push handler: every connected process runs
    this (worker.py subscribes on connect). Idempotent per trigger id —
    the GCS may re-publish after a redial replays subscriptions."""
    try:
        if not isinstance(payload, dict):
            return
        trigger_id = payload.get("trigger_id") or ""
        with _lock:
            if trigger_id in _seen_triggers:
                return
            _seen_triggers.add(trigger_id)
            if len(_seen_triggers) > 512:
                _seen_triggers.clear()
                _seen_triggers.add(trigger_id)
        observe_wire(payload.get("hlc"))
        bundle = payload.get("bundle")
        if not bundle:
            return
        dump(bundle, trigger=payload, window_s=payload.get("window_s"))
    except Exception:  # noqa: BLE001 — push handlers must never raise
        pass


def trigger_postmortem(reason: str, **detail: Any) -> None:
    """Publish a cluster-wide dump trigger via the GCS (fire-and-forget).

    Called by typed failure observers (breaker-open, replica-death
    replacement, collective timeout, HOL, deadline storms, gang
    restart). Local cooldown + GCS-side cooldown keep a failure *storm*
    from turning into a dump storm; the first trigger in a window wins
    and later ones ride in its bundle."""
    global _last_trigger_mono
    try:
        cfg = _cfg()
        if not cfg.journal_enabled or not cfg.journal_autodump:
            return
        now = time.monotonic()
        with _lock:
            if now - _last_trigger_mono < cfg.journal_cooldown_s:
                return
            _last_trigger_mono = now
        emit("journal.trigger_requested", reason=reason, **detail)

        def _fire():
            try:
                from ray_tpu_torch._private import worker as worker_mod

                client = worker_mod.get_client()
                client._run(
                    client._gcs_call(
                        "journal_trigger",
                        {"reason": reason, "source": process_label(),
                         "detail": {k: str(v) for k, v in detail.items()}},
                    ),
                    timeout=10.0,
                )
            except Exception:  # noqa: BLE001 — no client / GCS down: the
                # local ring still holds the evidence for a manual dump.
                pass

        threading.Thread(
            target=_fire, name="rt-journal-trigger", daemon=True
        ).start()
    except Exception:  # rtlint: disable=RT007 — trigger is fire-and-forget by contract; the local ring keeps the evidence
        pass


# -- bundle assembly (rt postmortem / rt timeline --cluster) --------------

def load_bundle(bundle_dir: str) -> Tuple[List[Dict], List[Dict]]:
    """Read every per-process JSONL in a bundle.

    Returns (events, metas): events from all processes (unmerged),
    metas one per file (the ``journal.meta`` header lines)."""
    events: List[Dict] = []
    metas: List[Dict] = []
    for name in sorted(os.listdir(bundle_dir)):
        if not name.endswith(".jsonl"):
            continue
        path = os.path.join(bundle_dir, name)
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if rec.get("kind") == "journal.meta":
                        metas.append(rec)
                    else:
                        events.append(rec)
        except OSError:
            continue
    return merge_events(events), metas


def _order_key(e: Dict) -> tuple:
    h = e.get("hlc") or [0, 0]
    try:
        pt, lc = int(h[0]), int(h[1])
    except (TypeError, ValueError, IndexError):
        pt, lc = 0, 0
    return (pt, lc, str(e.get("proc", "")), int(e.get("pid", 0) or 0))


def merge_events(events: Iterable[Dict]) -> List[Dict]:
    """One causally-ordered timeline: sort by (pt, lc, origin). HLC
    guarantees send < receive in this order; the origin tie-break makes
    the merge deterministic for concurrent events."""
    return sorted(events, key=_order_key)


#: Event kinds that seed a culprit chain (the injected/primary fault).
_CHAIN_SEEDS = (
    "chaos.", "collective.timeout", "raylet.worker_dead",
    "gcs.node_dead", "train.gang_restart",
)
#: Kinds that count as links from fault to client-observed effect. The
#: chain reports the FIRST occurrence of each link after the seed, in
#: HLC order — e.g. chaos.kill_replica → raylet.worker_dead →
#: gcs.actor DEAD → serve.controller replace → serve.breaker open →
#: serve.redispatch → serve.stream_resume → client.error.
_CHAIN_LINKS = (
    "chaos.", "raylet.worker_dead", "gcs.actor", "gcs.node_dead",
    "gcs.preemption", "serve.controller", "serve.breaker",
    "serve.redispatch", "serve.stream_resume", "serve.shed",
    "serve.deadline_expired", "serve.hol", "collective.timeout",
    "train.gang_restart", "train.resize", "serve.request_error",
    "client.error", "journal.trigger",
)


def _link_ident(e: Dict) -> Optional[str]:
    """Dedup identity for a chain link (None = not a link). State-change
    kinds key on their salient value so e.g. breaker open and breaker
    close are distinct links but 40 redispatches collapse to one."""
    kind = e.get("kind", "")
    for prefix in _CHAIN_LINKS:
        if kind.startswith(prefix):
            break
    else:
        return None
    if kind == "gcs.actor":
        # Only lifecycle edges matter for causality; ALIVE churn from
        # unrelated actors would bury the chain.
        if e.get("state") not in ("DEAD", "RESTARTING"):
            return None
        return f"{kind}:{e.get('state')}:{e.get('actor_id', '')}"
    if kind == "serve.breaker":
        return f"{kind}:{e.get('state')}:{e.get('replica', '')}"
    if kind == "serve.controller":
        return f"{kind}:{e.get('action')}:{e.get('app', '')}"
    return kind


def causal_chain(events: List[Dict]) -> List[Dict]:
    """Name the culprit chain in a merged timeline: the first injected /
    primary fault, then the first occurrence of each downstream link in
    HLC order, ending at the first client-observed error (when one was
    captured).

    An explicit chaos injection outranks ambient infrastructure seeds:
    a capture window usually also holds unrelated worker-death noise
    (a previous app's teardown, a drained replica being reaped), and
    seeding there would pin the postmortem on the wrong fault. When the
    timeline records an injection, that IS the primary fault; only
    without one does the earliest typed infrastructure failure seed."""
    events = merge_events(events)
    seed_idx = None
    for i, e in enumerate(events):
        if e.get("kind", "").startswith("chaos."):
            seed_idx = i
            break
    if seed_idx is None:
        for i, e in enumerate(events):
            kind = e.get("kind", "")
            if any(kind.startswith(s) for s in _CHAIN_SEEDS):
                seed_idx = i
                break
    if seed_idx is None:
        return []
    chain = [events[seed_idx]]
    seen = {_link_ident(events[seed_idx])}
    for e in events[seed_idx + 1:]:
        ident = _link_ident(e)
        if ident is None or ident in seen:
            continue
        seen.add(ident)
        chain.append(e)
        if e.get("kind") in ("client.error", "serve.request_error"):
            break
    return chain


def _fmt_event(e: Dict, t0: Optional[float] = None) -> str:
    ts = e.get("ts", 0.0)
    h = e.get("hlc") or [0, 0]
    rel = f"+{ts - t0:8.3f}s" if t0 is not None else (
        time.strftime("%H:%M:%S", time.localtime(ts))
        + f".{int((ts % 1) * 1000):03d}"
    )
    extras = " ".join(
        f"{k}={e[k]}" for k in sorted(e)
        if k not in ("hlc", "ts", "kind", "proc", "pid")
    )
    origin = f"{e.get('proc', '?')}({e.get('pid', '?')})"
    return (f"{rel}  hlc={h[0]}.{h[1]:<3} {origin:<28} "
            f"{e.get('kind', '?'):<24} {extras}")


def render_timeline(events: List[Dict], limit: int = 0,
                    relative: bool = True) -> str:
    """Human-readable merged spine, one line per event in HLC order."""
    events = merge_events(events)
    if limit and len(events) > limit:
        events = events[-limit:]
    if not events:
        return "(no events)"
    t0 = events[0].get("ts", 0.0) if relative else None
    return "\n".join(_fmt_event(e, t0) for e in events)
