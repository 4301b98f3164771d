"""Sampled control-plane lifecycle profiler: name where the µs/task go.

Analog of the reference's task-event lifecycle stream
(src/ray/protobuf/export_task_event.proto state transitions feeding
`ray timeline`), narrowed to the question ROADMAP item 2 asks: which
control-plane phase bends the cost curve at a million tasks?

Head sampling: the submitting client decides once per task
(`RT_TASK_TRACE_SAMPLE` rate, flippable cluster-wide at runtime via
`rt profile --on`) and stamps a ``sampled`` bit into the task spec /
actor-call request. Every hop that sees the bit stamps monotonic phase
marks and emits ONE ``LIFECYCLE_SPAN`` task event carrying its phases;
the stitcher joins them per task id into a breakdown whose leaf phases
sum to ≈ the submit→complete wall.

Phase marks ride as ``extra["phases"] = {name: [epoch_start_s, dur_s]}``
— durations from ``time.monotonic()`` deltas (immune to clock steps),
start stamps from ``time.time()`` so `rt timeline --lifecycle` can place
the rows on the shared chrome-trace axis.

The unsampled fast path must stay ~free: the only per-task cost with
sampling off is the module-attribute ``enabled`` check on the submit
side and ``spec.get("sampled")`` dict misses on the hops (benched in
bench_scale.py, gated < 2 µs/task).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional

#: Canonical phase order for display (client submit → worker → result).
PHASE_ORDER = (
    "serialize",      # client: args → wire payload
    "submit_buffer",  # client: submit-burst buffer wait (batching delay)
    "lease",          # client: direct-path worker-lease RPC (per group)
    "queue_wait",     # raylet: enqueue → dispatch pop
    "dispatch",       # raylet: resource grant + push to worker
    "fn_fetch",       # worker: function-manager fetch
    "arg_fetch",      # worker: store pulls for by-reference args
    "deserialize",    # worker: arg payload decode (minus arg_fetch)
    "exec",           # worker: user function body
    "result_store",   # worker: package / store returns
    "transport",      # client: submit-RPC wire + event-loop residual
    "get_wait",       # driver: rt.get block (overlaps remote phases)
)

#: Leaf phases whose sum is compared against the submit→complete wall.
#: get_wait overlaps remote execution (a caller blocked in get is waiting
#: on queue/exec time already counted), so it stays out of the sum.
SUM_PHASES = frozenset(PHASE_ORDER) - {"get_wait"}

#: Canonical phase order for SERVE requests (serve.observatory emits
#: these on sampled requests; display order for rt trace / aggregate).
#: `exec` replaces the four engine phases on non-engine deployments.
SERVE_PHASE_ORDER = (
    "handle_queue",           # caller: .remote() → router dispatch
    "dispatch",               # wire + replica pre-engine work
    "engine_admission_wait",  # engine queue → decode-slot grant
    "prefill",                # slot grant → first token
    "decode",                 # first token → terminal token
    "stream",                 # terminal token → reply handed back
    "exec",                   # non-engine deployments: user callable body
)

#: Fast-path guard: hops check this module attribute before doing ANY
#: sampling work. Only set_sample_rate flips it.
enabled = False
_rate = 0.0
_lock = threading.Lock()
_tls = threading.local()


def set_sample_rate(rate: float) -> None:
    """Set the head-sampling probability (0 disables, 1 traces all)."""
    global enabled, _rate
    rate = min(1.0, max(0.0, float(rate)))
    with _lock:
        _rate = rate
        enabled = rate > 0.0


def get_sample_rate() -> float:
    return _rate


def sample() -> bool:
    """One head-sampling decision. Callers must gate on ``enabled``."""
    r = _rate
    return r >= 1.0 or random.random() < r


def event(
    task_id: bytes,
    name: str,
    job_id: bytes,
    node_id: bytes,
    hop: str,
    phases: Dict[str, List[float]],
    e2e_s: Optional[float] = None,
    worker_id: Optional[bytes] = None,
) -> dict:
    """Build one LIFECYCLE_SPAN task event for this hop's phase marks.

    phases: {phase: [epoch_start_s, dur_s]}. The caller appends the
    event to whatever task-event buffer its process already flushes
    (client: profiling._buffer, raylet/worker: self._task_events).
    """
    extra: Dict = {"hop": hop, "phases": phases}
    if e2e_s is not None:
        extra["e2e_s"] = e2e_s
    ev = {
        "task_id": task_id,
        "name": name,
        "job_id": job_id,
        "node_id": node_id,
        "type": "LIFECYCLE_SPAN",
        "state": "PHASES",
        "ts": time.time(),
        "extra": extra,
    }
    if worker_id is not None:
        ev["worker_id"] = worker_id
    from ray_tpu_torch.util import journal

    journal.emit("lifecycle.span", task=name, hop=hop,
                 **({"e2e_s": round(e2e_s, 6)} if e2e_s is not None else {}))
    return ev


# -- executing-worker arg-fetch capture ---------------------------------
# deserialize_args resolves by-reference args with store gets; splitting
# that wait out of "deserialize" needs a thread-local accumulator the
# resolver adds into. Off path: one getattr miss per STORE arg (which
# already paid an RPC), nothing on inline args.

def begin_arg_capture() -> None:
    _tls.arg_fetch = 0.0


def add_arg_fetch(dur_s: float) -> None:
    if getattr(_tls, "arg_fetch", None) is not None:
        _tls.arg_fetch += dur_s


def end_arg_capture() -> float:
    dur = getattr(_tls, "arg_fetch", 0.0) or 0.0
    _tls.arg_fetch = None
    return dur


# -- stitching / aggregation --------------------------------------------

def stitch(events: List[dict]) -> Dict[str, dict]:
    """Join LIFECYCLE_SPAN events per task id.

    Returns {task_id_hex: {"name", "ts", "hops": [..], "phases":
    {phase: dur_s}, "e2e_s": float|None}}. Durations for a phase seen on
    several hops (never expected, but a retry can re-stamp) accumulate.
    """
    tasks: Dict[str, dict] = {}
    for ev in events:
        if ev.get("type") != "LIFECYCLE_SPAN":
            continue
        extra = ev.get("extra") or {}
        tid = ev.get("task_id")
        key = tid.hex() if isinstance(tid, (bytes, bytearray)) else str(tid)
        rec = tasks.setdefault(
            key,
            {"name": ev.get("name", ""), "ts": ev.get("ts", 0.0),
             "hops": [], "phases": {}, "phase_marks": {}, "e2e_s": None},
        )
        if ev.get("name"):
            rec["name"] = ev["name"]
        hop = extra.get("hop", "")
        if hop and hop not in rec["hops"]:
            rec["hops"].append(hop)
        for phase, mark in (extra.get("phases") or {}).items():
            try:
                start, dur = float(mark[0]), float(mark[1])
            except (TypeError, ValueError, IndexError):
                continue
            rec["phases"][phase] = rec["phases"].get(phase, 0.0) + dur
            rec["phase_marks"].setdefault(phase, [start, dur])
            if hop != "client" and phase in SUM_PHASES:
                rec["_remote_s"] = rec.get("_remote_s", 0.0) + dur
        if extra.get("e2e_s") is not None:
            rec["e2e_s"] = float(extra["e2e_s"])
    # Derive "transport": the client stamps rpc_wait (the submit RPC's
    # full round-trip on single-spec frames); everything the raylet /
    # worker attributed happened inside that window, so the residual is
    # wire + event-loop time — the phase that dominates tiny tasks.
    # rpc_wait itself would double-count the remote phases, so it is
    # replaced, not kept.
    for rec in tasks.values():
        remote = rec.pop("_remote_s", 0.0)
        rpc = rec["phases"].pop("rpc_wait", None)
        mark = rec["phase_marks"].pop("rpc_wait", None)
        if rpc is None:
            continue
        rec["rpc_wait_s"] = rpc
        resid = rpc - remote
        if resid > 0.0:
            rec["phases"]["transport"] = (
                rec["phases"].get("transport", 0.0) + resid
            )
            if mark is not None:
                rec["phase_marks"].setdefault("transport", [mark[0], resid])
    return tasks


def coverage(record: dict) -> Optional[float]:
    """Fraction of the task's e2e wall its leaf phases explain
    (None when the client hop — which owns e2e — wasn't seen)."""
    e2e = record.get("e2e_s")
    if not e2e:
        return None
    leaf = sum(
        d for p, d in record["phases"].items() if p in SUM_PHASES
    )
    return leaf / e2e


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[idx]


def aggregate(records: Dict[str, dict]) -> Dict[str, dict]:
    """Per-phase aggregate over stitched records:
    {phase: {"count", "mean_us", "p50_us", "p99_us"}} plus pseudo-rows
    ``e2e`` (client submit→complete wall) and ``coverage`` (leaf-phase
    sum / e2e, unitless fractions in the *_us fields)."""
    by_phase: Dict[str, List[float]] = {}
    e2es: List[float] = []
    covs: List[float] = []
    for rec in records.values():
        for phase, dur in rec["phases"].items():
            by_phase.setdefault(phase, []).append(dur * 1e6)
        if rec.get("e2e_s"):
            e2es.append(rec["e2e_s"] * 1e6)
            c = coverage(rec)
            if c is not None:
                covs.append(c)
    out: Dict[str, dict] = {}

    def _row(vals: List[float]) -> dict:
        vals = sorted(vals)
        return {
            "count": len(vals),
            "mean_us": sum(vals) / len(vals) if vals else 0.0,
            "p50_us": _percentile(vals, 0.5),
            "p99_us": _percentile(vals, 0.99),
        }

    for phase in PHASE_ORDER + SERVE_PHASE_ORDER:
        if phase in by_phase:
            out[phase] = _row(by_phase.pop(phase))
    for phase, vals in sorted(by_phase.items()):  # unknown extras last
        out[phase] = _row(vals)
    if e2es:
        out["e2e"] = _row(e2es)
    if covs:
        out["coverage"] = _row(covs)
    return out


def _init_from_config() -> None:
    try:
        from ray_tpu_torch._private.config import get_config

        set_sample_rate(get_config().task_trace_sample)
    except Exception:  # noqa: BLE001 — profiling must never break import
        pass


_init_from_config()
