"""Serve request observatory: per-request phase attribution + SLO plane.

Three pieces the serving stack gains here (ROADMAP serving-observability
item; the request-path mirror of the train-side flight recorder):

  1. ALWAYS-ON phase attribution. Every request is stamped at handle
     enqueue, router dispatch, replica receive, engine admission (slot
     grant), prefill completion (first token) and terminal token; the
     finished request yields a phase vector

         {handle_queue, dispatch, engine_admission_wait,
          prefill, decode, stream}

     that sums to the e2e wall BY CONSTRUCTION (telescoping over the
     stamp chain — the fraction gate in bench_serve_obs.py catches any
     stamp-wiring regression, not float drift). Finished vectors ride a
     per-replica ring (same design as the StepProfiler ring) and feed
     process-wide labeled metrics. Non-engine deployments collapse the
     engine phases into one ``exec`` phase.

  2. Per-tenant / per-deployment SLO accounting. Deployments declare
     optional targets (``SloConfig``: TTFT / TPOT / e2e p-latency
     bounds); the observatory scores every finished request against
     them per tenant, keeps fast/slow sliding windows, and exposes
     attainment + multi-window burn rates (violation rate over the
     window divided by the error budget ``1 - objective``).

  3. The autoscaling signal plane. ``snapshot()`` is the per-replica
     half of the versioned ``ServeSignals`` document the controller
     assembles and publishes to the GCS KV at a fixed cadence
     (controller._publish_signals) — QPS, batch occupancy, slot-wait
     queue depth, TTFT/TPOT percentiles, backlog-drain estimate,
     per-replica health, per-tenant SLO burn. `rt serve` renders it;
     a future autoscaler consumes it.

Clock discipline: cross-process stamps (handle enqueue/dispatch ->
replica receive) use ``time.time()`` (the only clock that compares
across processes; NTP skew lands in the ``dispatch`` phase and is
clamped at >= 0), everything after replica receive uses
``time.perf_counter()`` deltas, immune to clock steps. Sampled requests
(lifecycle head sampling) additionally emit one LIFECYCLE_SPAN event so
serve requests stitch into `rt profile tasks` / `rt timeline
--lifecycle` next to control-plane phases.

The unsampled steady-state cost is a handful of perf_counter stamps and
dict writes per REQUEST (never per decode step); bench_serve_obs.py
gates the paired-median per-request overhead at < 2%.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from ray_tpu_torch._private.config import get_config
from ray_tpu_torch.util import journal
from ray_tpu_torch.util.lifecycle import SERVE_PHASE_ORDER

logger = logging.getLogger("ray_tpu_torch.serve")

#: ServeSignals document schema version (bump on breaking shape change).
#: v2 adds paged-KV fields (per-replica kv_util / prefix_hit_rate /
#: prefill_tokens_skipped, per-app "kv" aggregate, target/running
#: replica counts) — purely additive, v1 readers ignore them.
SIGNALS_SCHEMA_VERSION = 2

#: GCS KV key (ns="serve") the controller publishes ServeSignals under.
SIGNALS_KEY = b"serve_signals"

#: SLO kinds a deployment can bound (SloConfig fields <kind>_ms).
SLO_KINDS = ("ttft", "tpot", "e2e")

_tls = threading.local()

_metrics_lock = threading.Lock()
_metrics: Optional[Dict] = None


def _obs_metrics() -> Dict:
    """Lazy module-level metric set (one per process, flushed to GCS by
    the metrics flusher) — created on the first finished request so
    importing this module never spins up the flusher thread."""
    global _metrics
    with _metrics_lock:
        if _metrics is None:
            from ray_tpu_torch.util import metrics as _mx

            _metrics = {
                "phase_s": _mx.get_or_create(
                    _mx.Counter, "serve_request_phase_seconds_total",
                    "Per-request phase attribution: seconds spent in each "
                    "serve phase (handle_queue/dispatch/admission/prefill/"
                    "decode/stream), per deployment",
                    tag_keys=("app", "phase"),
                ),
                "e2e_s": _mx.get_or_create(
                    _mx.Histogram, "serve_request_e2e_seconds",
                    "End-to-end request wall (handle enqueue -> reply), "
                    "per deployment",
                    # Wide tail: macro-load e2e p99s run multi-second and
                    # must not clamp into +Inf (other serve histograms
                    # keep LATENCY_BOUNDARIES).
                    boundaries=_mx.LATENCY_BOUNDARIES_WIDE,
                    tag_keys=("app",),
                ),
                "requests": _mx.get_or_create(
                    _mx.Counter, "serve_requests_total",
                    "Finished serve requests per deployment and tenant",
                    tag_keys=("app", "tenant"),
                ),
                "tokens": _mx.get_or_create(
                    _mx.Counter, "serve_tenant_tokens_total",
                    "Prompt (in) and generated (out) tokens per deployment "
                    "and tenant", tag_keys=("app", "tenant", "direction"),
                ),
                "queue_s": _mx.get_or_create(
                    _mx.Histogram, "serve_tenant_queue_seconds",
                    "Pre-execution queueing per request (handle_queue + "
                    "dispatch + engine admission wait), per tenant",
                    boundaries=_mx.LATENCY_BOUNDARIES,
                    tag_keys=("app", "tenant"),
                ),
                "slo_total": _mx.get_or_create(
                    _mx.Counter, "serve_slo_requests_total",
                    "Requests scored against a declared SLO target",
                    tag_keys=("app", "tenant", "slo"),
                ),
                "slo_viol": _mx.get_or_create(
                    _mx.Counter, "serve_slo_violations_total",
                    "Requests that missed their declared SLO target",
                    tag_keys=("app", "tenant", "slo"),
                ),
                "slo_burn": _mx.get_or_create(
                    _mx.Gauge, "serve_slo_burn_rate",
                    "Fast-window SLO burn rate (violation rate / error "
                    "budget); > 1 consumes budget faster than allowed",
                    tag_keys=("app", "tenant", "slo"),
                ),
                # -- survival plane (PR 8) ---------------------------
                "shed": _mx.get_or_create(
                    _mx.Counter, "serve_requests_shed_total",
                    "Requests rejected by admission control instead of "
                    "queued (reason: queue_full/draining/circuit_open)",
                    tag_keys=("app", "tenant", "reason"),
                ),
                "deadline_expired": _mx.get_or_create(
                    _mx.Counter, "serve_deadline_expired_total",
                    "Requests cancelled because their propagated deadline "
                    "expired, by the hop that noticed (replica/engine_"
                    "admission/engine_decode/handle)",
                    tag_keys=("app", "hop"),
                ),
                "drain_s": _mx.get_or_create(
                    _mx.Histogram, "serve_drain_seconds",
                    "Graceful replica drain duration (admission stop -> "
                    "last in-flight request finished)",
                    boundaries=_mx.LATENCY_BOUNDARIES, tag_keys=("app",),
                ),
                "cb_state": _mx.get_or_create(
                    _mx.Gauge, "serve_circuit_breaker_state",
                    "Per-replica circuit breaker state as seen by a "
                    "handle (0 closed, 1 half-open, 2 open)",
                    tag_keys=("app", "replica"),
                ),
            }
        return _metrics


class RequestContext:
    """Per-request stamp card, threaded from the wire dict the handle
    ships through to the terminal engine token.

    The replica's request thread owns begin()/finish(); the engine
    thread writes only into ``marks`` (distinct keys, single writer per
    key — same discipline as GenerationHandle's engine-side fields).
    """

    __slots__ = ("rid", "tenant", "app", "method", "sampled",
                 "enq_t", "disp_t", "recv_t", "recv_p",
                 "marks", "tokens_in", "tokens_out", "finished")

    def __init__(self, rid: str, tenant: str, app: str, method: str,
                 sampled: bool, enq_t: Optional[float],
                 disp_t: Optional[float]):
        self.rid = rid
        self.tenant = tenant or "default"
        self.app = app
        self.method = method or "__call__"
        self.sampled = sampled
        self.enq_t = enq_t          # caller epoch: handle .remote() entry
        self.disp_t = disp_t        # caller epoch: just before actor call
        self.recv_t = time.time()   # replica epoch: request received
        self.recv_p = time.perf_counter()
        self.marks: Dict[str, float] = {}   # perf-clock stamps
        self.tokens_in = 0
        self.tokens_out = 0
        self.finished = False

    def mark(self, name: str, at: Optional[float] = None) -> None:
        self.marks[name] = time.perf_counter() if at is None else at

    def epoch_of(self, perf_t: float) -> float:
        """Map a replica perf_counter stamp onto the epoch axis."""
        return self.recv_t + (perf_t - self.recv_p)


def make_wire_ctx(tenant: str = "") -> Optional[Dict]:
    """Caller-side half of the stamp card, built at handle enqueue.

    Ships as a plain dict (rid, tenant, epoch stamps, sampled bit); the
    replica rehydrates it into a RequestContext. None when the
    observatory is disabled — every downstream hop then short-circuits.
    """
    if not get_config().serve_observatory:
        return None
    from ray_tpu_torch.util import lifecycle

    return {
        "rid": os.urandom(8).hex(),
        "tenant": tenant,
        "enq_t": time.time(),
        "sampled": bool(lifecycle.enabled and lifecycle.sample()),
        # HLC stamp: the enqueue happens-before everything the replica
        # does for this request, across the process boundary.
        "hlc": journal.wire_stamp(),
    }


def begin(obs_ctx: Optional[Dict], app: str,
          method: str = "__call__") -> Optional[RequestContext]:
    """Open a request context on this (replica) thread.

    Tolerates a missing wire dict (direct replica calls, disabled
    callers): the request still gets local phases, just no
    handle_queue/dispatch attribution.
    """
    if not get_config().serve_observatory:
        return None
    d = obs_ctx or {}
    journal.observe_wire(d.get("hlc"))
    ctx = RequestContext(
        rid=d.get("rid") or os.urandom(8).hex(),
        tenant=d.get("tenant", ""),
        app=app,
        method=method,
        sampled=bool(d.get("sampled")),
        enq_t=d.get("enq_t"),
        disp_t=d.get("disp_t"),
    )
    _tls.ctx = ctx
    return ctx


def current() -> Optional[RequestContext]:
    """The request context active on this thread (engine submit() grabs
    it so engine-thread stamps land on the right card)."""
    return getattr(_tls, "ctx", None)


def finish(ctx: Optional[RequestContext]) -> Optional[Dict]:
    """Close the context: compute the phase vector, feed the ring,
    metrics, tenant SLO accounting, and (sampled) the lifecycle stream.
    Returns the finished record (None when disabled/double-finished)."""
    if ctx is None or ctx.finished:
        return None
    ctx.finished = True
    if getattr(_tls, "ctx", None) is ctx:
        _tls.ctx = None
    return profiler().finish(ctx)


def _compute_phases(ctx: RequestContext, end_p: float) -> Dict[str, float]:
    """Telescoping phase vector over the stamp chain.

    Caller-side epoch stamps cover handle_queue (enqueue -> dispatch)
    and the cross-process wire (dispatch -> receive, folded into
    ``dispatch`` together with replica-side pre-engine work); replica
    perf stamps cover everything after receive. The six phases sum to
    e2e exactly (modulo the >= 0 clamps on cross-clock deltas).
    """
    marks = ctx.marks
    hq = wire = 0.0
    if ctx.enq_t is not None and ctx.disp_t is not None:
        hq = max(ctx.disp_t - ctx.enq_t, 0.0)
        wire = max(ctx.recv_t - ctx.disp_t, 0.0)
    eq = marks.get("engine_enqueue")
    phases: Dict[str, float] = {"handle_queue": hq}
    if eq is None:
        phases["dispatch"] = wire
        phases["exec"] = max(end_p - ctx.recv_p, 0.0)
        return phases
    # Clamp the engine chain monotone (a failed request may miss marks;
    # missing ones collapse their phase to 0 at the end stamp).
    eq = min(max(eq, ctx.recv_p), end_p)
    sg = min(max(marks.get("slot_grant", end_p), eq), end_p)
    ft = min(max(marks.get("first_token", end_p), sg), end_p)
    ed = min(max(marks.get("engine_done", end_p), ft), end_p)
    phases["dispatch"] = wire + (eq - ctx.recv_p)
    phases["engine_admission_wait"] = sg - eq
    phases["prefill"] = ft - sg
    phases["decode"] = ed - ft
    phases["stream"] = end_p - ed
    return phases


class _TenantStats:
    """Per-tenant accumulator: lifetime totals + a time-pruned window of
    per-request SLO outcomes for burn-rate math."""

    __slots__ = ("requests", "tokens_in", "tokens_out", "queue_s",
                 "outcomes")

    def __init__(self):
        self.requests = 0
        self.tokens_in = 0
        self.tokens_out = 0
        self.queue_s = 0.0
        # (epoch_ts, {kind: violated_bool}) — pruned past the slow window.
        self.outcomes: deque = deque(maxlen=8192)

    def window_counts(self, now: float, window_s: float) -> Dict[str, List[int]]:
        """{kind: [good, total]} over the trailing window."""
        out: Dict[str, List[int]] = {}
        lo = now - window_s
        for ts, verdicts in self.outcomes:
            if ts < lo:
                continue
            for kind, violated in verdicts.items():
                row = out.setdefault(kind, [0, 0])
                row[1] += 1
                if not violated:
                    row[0] += 1
        return out


def burn_rate(good: int, total: int, objective: float) -> float:
    """Violation rate over the error budget: 1.0 burns budget exactly at
    the allowed rate, > 1 exhausts it early, 0 is a clean window."""
    if total <= 0:
        return 0.0
    budget = max(1.0 - float(objective), 1e-9)
    return ((total - good) / total) / budget


class RequestProfiler:
    """Per-replica finished-request ring + tenant SLO ledger.

    The serve-side sibling of the train flight recorder's StepProfiler:
    bounded memory, lock only around the ring/tenant maps (the stamps
    themselves are lock-free), aggregates computed at read time.
    """

    def __init__(self, ring: Optional[int] = None, app: str = "",
                 slo=None):
        cfg = get_config()
        self.app = app or "-"
        self.slo = slo
        # Capacity comes from cfg.serve_obs_ring, overridable per process
        # via RT_SERVE_OBS_RING — macro-load runs size it to hold the
        # whole run so the reconciler can join every request.
        self._ring: deque = deque(maxlen=ring or cfg.serve_obs_ring)
        # Overwrite accounting: a full ring silently drops the oldest
        # finished-request record per append. Counted so sustained-QPS
        # runs can tell (and warn) when phase records are being lost.
        self._overwrites = 0
        self._overwrite_warn_t = 0.0
        self._lock = threading.Lock()
        self._tenants: Dict[str, _TenantStats] = {}
        self._finish_ts: deque = deque(maxlen=2048)  # epoch, for QPS
        self._ttft: deque = deque(maxlen=512)        # recent samples the
        self._tpot: deque = deque(maxlen=512)        # controller merges
        self._requests = 0
        # Survival-plane tallies: sheds keyed "tenant|reason", deadline
        # expiries keyed by the hop that noticed. Written by the replica/
        # engine threads under the same lock as the ring.
        self._shed: Dict[str, int] = {}
        self._expired: Dict[str, int] = {}
        # Hot-path metric keys resolved once per (phase)/(tenant) label
        # set — the keyed fast path from util.metrics.
        self._phase_keys: Dict[str, tuple] = {}

    def configure(self, app: str, slo) -> None:
        self.app = app or self.app
        self.slo = slo
        self._phase_keys.clear()

    # -- write side ------------------------------------------------------
    def finish(self, ctx: RequestContext) -> Dict:
        end_p = time.perf_counter()
        phases = _compute_phases(ctx, end_p)
        e2e = sum(phases.values())
        ft = ctx.marks.get("first_token")
        ttft = None
        if ft is not None:
            ttft = (phases["handle_queue"] + phases["dispatch"]
                    + phases.get("engine_admission_wait", 0.0)
                    + phases.get("prefill", 0.0))
        tpot = None
        if ctx.tokens_out > 1 and "decode" in phases:
            tpot = phases["decode"] / (ctx.tokens_out - 1)
        rec = {
            "rid": ctx.rid,
            "tenant": ctx.tenant,
            "method": ctx.method,
            "ts": time.time(),
            "phases": phases,
            "e2e_s": e2e,
            "ttft_s": ttft,
            "tpot_s": tpot,
            "tokens_in": ctx.tokens_in,
            "tokens_out": ctx.tokens_out,
        }
        queue_s = (phases["handle_queue"] + phases["dispatch"]
                   + phases.get("engine_admission_wait", 0.0))
        verdicts = self._score_slo(ttft, tpot, e2e)
        warn_overwrites = 0
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self._overwrites += 1
                now_m = time.monotonic()
                if now_m - self._overwrite_warn_t >= 60.0:
                    self._overwrite_warn_t = now_m
                    warn_overwrites = self._overwrites
            self._ring.append(rec)
            self._requests += 1
            self._finish_ts.append(rec["ts"])
            if ttft is not None:
                self._ttft.append(ttft)
            if tpot is not None:
                self._tpot.append(tpot)
            t = self._tenants.get(ctx.tenant)
            if t is None:
                t = self._tenants[ctx.tenant] = _TenantStats()
            t.requests += 1
            t.tokens_in += ctx.tokens_in
            t.tokens_out += ctx.tokens_out
            t.queue_s += queue_s
            if verdicts:
                t.outcomes.append((rec["ts"], verdicts))
        journal.emit("serve.request", rid=ctx.rid, app=self.app,
                     tenant=ctx.tenant, e2e_s=round(e2e, 6),
                     tokens_out=ctx.tokens_out)
        if warn_overwrites:
            # Rate-limited (once per minute per replica): sustained load
            # past ring capacity silently evicts phase records, which
            # starves the reconciler and ServeSignals of attribution.
            logger.warning(
                "observatory ring for app %r is overwriting finished-"
                "request records (%d overwritten so far, capacity %d); "
                "raise RT_SERVE_OBS_RING to keep full attribution for "
                "macro runs", self.app, warn_overwrites,
                self._ring.maxlen,
            )
        self._observe_metrics(ctx, phases, e2e, queue_s, verdicts)
        if ctx.sampled:
            self._emit_lifecycle(ctx, phases, e2e)
        return rec

    def _score_slo(self, ttft, tpot, e2e) -> Dict[str, bool]:
        """{kind: violated} for every target the deployment declared."""
        slo = self.slo
        if slo is None:
            return {}
        out: Dict[str, bool] = {}
        for kind, value in (("ttft", ttft), ("tpot", tpot), ("e2e", e2e)):
            target_ms = getattr(slo, f"{kind}_ms", None)
            if target_ms is None or value is None:
                continue
            out[kind] = value * 1e3 > target_ms
        return out

    def _observe_metrics(self, ctx, phases, e2e, queue_s, verdicts):
        m = _obs_metrics()
        for phase, dur in phases.items():
            key = self._phase_keys.get(phase)
            if key is None:
                key = m["phase_s"]._key({"app": self.app, "phase": phase})
                self._phase_keys[phase] = key
            m["phase_s"].inc_keyed(key, dur)
        m["e2e_s"].observe(e2e, tags={"app": self.app})
        base = {"app": self.app, "tenant": ctx.tenant}
        m["requests"].inc(1, tags=base)
        if ctx.tokens_in:
            m["tokens"].inc(ctx.tokens_in, tags={**base, "direction": "in"})
        if ctx.tokens_out:
            m["tokens"].inc(ctx.tokens_out, tags={**base, "direction": "out"})
        m["queue_s"].observe(queue_s, tags=base)
        for kind, violated in verdicts.items():
            tags = {**base, "slo": kind}
            m["slo_total"].inc(1, tags=tags)
            if violated:
                m["slo_viol"].inc(1, tags=tags)

    def _emit_lifecycle(self, ctx: RequestContext, phases, e2e) -> None:
        """One LIFECYCLE_SPAN per sampled request: serve phases stitch
        into `rt profile tasks` / `rt timeline --lifecycle` alongside the
        control-plane phases (same event stream, same stitcher)."""
        try:
            from ray_tpu_torch._private import worker as worker_mod
            from ray_tpu_torch.util import lifecycle, profiling

            client = worker_mod.get_client_or_none()
            node_id = getattr(client, "node_id", b"") or b""
            start = ctx.enq_t if ctx.enq_t is not None else ctx.recv_t
            marks: Dict[str, List[float]] = {}
            cursor = start
            for phase in SERVE_PHASE_ORDER:
                if phase not in phases:
                    continue
                dur = phases[phase]
                marks[phase] = [cursor, dur]
                cursor += dur
            ev = lifecycle.event(
                task_id=bytes.fromhex(ctx.rid),
                name=f"serve.{self.app}.{ctx.method}",
                job_id=b"",
                node_id=node_id,
                hop="serve_replica",
                phases=marks,
                e2e_s=e2e,
            )
            profiling.buffer_events([ev])
        except Exception:  # rtlint: disable=RT007 — observability must never fail a request
            pass

    def record_shed(self, tenant: str, reason: str) -> None:
        """Account one admission rejection (metric + snapshot tally)."""
        tenant = tenant or "default"
        with self._lock:
            key = f"{tenant}|{reason}"
            self._shed[key] = self._shed.get(key, 0) + 1
        m = _obs_metrics()
        m["shed"].inc(1, tags={"app": self.app, "tenant": tenant,  # rtlint: disable=RT013 — tenant values are validated against the fixed admission table before reaching here
                               "reason": reason})

    def record_deadline_expired(self, hop: str) -> None:
        """Account one deadline cancellation at the hop that noticed."""
        with self._lock:
            self._expired[hop] = self._expired.get(hop, 0) + 1
        m = _obs_metrics()
        m["deadline_expired"].inc(1, tags={"app": self.app, "hop": hop})

    # -- read side -------------------------------------------------------
    def records(self) -> List[Dict]:
        with self._lock:
            return list(self._ring)

    def qps(self, window_s: float = 30.0) -> float:
        now = time.time()
        with self._lock:
            n = sum(1 for ts in self._finish_ts if ts >= now - window_s)
        return n / window_s

    def snapshot(self) -> Dict:
        """The per-replica half of ServeSignals: bounded, JSON-safe."""
        cfg = get_config()
        now = time.time()
        windows = (cfg.serve_slo_fast_window_s, cfg.serve_slo_slow_window_s)
        with self._lock:
            ring = list(self._ring)
            tenants = dict(self._tenants)
            ttft = sorted(self._ttft)
            tpot = sorted(self._tpot)
            requests = self._requests
            shed = dict(self._shed)
            expired = dict(self._expired)
            overwrites = self._overwrites
            ring_cap = self._ring.maxlen or 0
        phase_agg: Dict[str, Dict[str, float]] = {}
        fractions: List[float] = []
        for rec in ring:
            if rec["e2e_s"] > 0:
                fractions.append(
                    sum(rec["phases"].values()) / rec["e2e_s"]
                )
            for phase, dur in rec["phases"].items():
                row = phase_agg.setdefault(phase, {"sum_s": 0.0, "count": 0})
                row["sum_s"] += dur
                row["count"] += 1
        slo_doc = None
        if self.slo is not None:
            slo_doc = {k: getattr(self.slo, f"{k}_ms", None)
                       for k in SLO_KINDS}
            slo_doc["objective"] = self.slo.objective
        tenant_doc: Dict[str, Dict] = {}
        m = _obs_metrics()
        for name, t in tenants.items():
            slo_windows: Dict[str, Dict] = {}
            for w in windows:
                counts = t.window_counts(now, w)
                slo_windows[str(int(w))] = {
                    kind: {
                        "good": good, "total": total,
                        "burn": burn_rate(
                            good, total,
                            self.slo.objective if self.slo else 0.99,
                        ),
                    }
                    for kind, (good, total) in counts.items()
                }
            fast = slo_windows.get(str(int(windows[0])), {})
            for kind, row in fast.items():
                m["slo_burn"].set(row["burn"], tags={
                    "app": self.app, "tenant": name, "slo": kind,
                })
            tenant_doc[name] = {
                "requests": t.requests,
                "tokens_in": t.tokens_in,
                "tokens_out": t.tokens_out,
                "queue_s": t.queue_s,
                "slo_windows": slo_windows,
            }
        return {
            "app": self.app,
            "ts": now,
            "requests_total": requests,
            "ring": {
                "capacity": ring_cap,
                "len": len(ring),
                "overwrites": overwrites,
                # Fraction of finished requests whose record was evicted
                # before this snapshot.
                "overwrite_rate": (
                    overwrites / requests if requests else 0.0
                ),
            },
            "qps": self.qps(),
            "phases": phase_agg,
            "phase_sum_fraction": (
                sum(fractions) / len(fractions) if fractions else None
            ),
            "ttft_samples": ttft[-256:],
            "tpot_samples": tpot[-256:],
            "slo": slo_doc,
            "slo_windows_s": [int(w) for w in windows],
            "tenants": tenant_doc,
            "shed": shed,
            "shed_total": sum(shed.values()),
            "deadline_expired": expired,
        }


_profiler_lock = threading.Lock()
_profiler: Optional[RequestProfiler] = None


def profiler() -> RequestProfiler:
    """Process-global per-replica profiler (one replica per process)."""
    global _profiler
    with _profiler_lock:
        if _profiler is None:
            _profiler = RequestProfiler()
        return _profiler


def configure(app: str, slo=None) -> None:
    """Label this replica process's profiler (called at replica init)."""
    profiler().configure(app, slo)


def record_shed(app: str, tenant: str = "",
                reason: str = "queue_full") -> None:
    """Module-level shed accounting (replica/engine/handle hops call
    this; no-op with the observatory disabled — shedding itself is
    never gated on observability)."""
    if not get_config().serve_observatory:
        return
    p = profiler()
    if app and p.app in ("-", ""):
        p.app = app
    p.record_shed(tenant, reason)
    journal.emit("serve.shed", app=app, tenant=tenant, reason=reason)


# Deadline-storm detector: a burst of expiries across hops is the
# signature of a systemic stall (dead replica, wedged engine), not a
# slow request — it earns an automatic black-box capture.
_expiry_times: deque = deque(maxlen=32)
_EXPIRY_STORM_N = 8
_EXPIRY_STORM_WINDOW_S = 5.0


def record_deadline_expired(app: str, hop: str) -> None:
    """Module-level deadline-expiry accounting, by noticing hop."""
    if not get_config().serve_observatory:
        return
    profiler().record_deadline_expired(hop)
    journal.emit("serve.deadline_expired", app=app, hop=hop)
    now = time.monotonic()
    _expiry_times.append(now)
    if (len(_expiry_times) >= _EXPIRY_STORM_N
            and now - _expiry_times[-_EXPIRY_STORM_N]
            <= _EXPIRY_STORM_WINDOW_S):
        journal.trigger_postmortem(
            f"deadline_storm:{app}", app=app, hop=hop,
            expiries=_EXPIRY_STORM_N, window_s=_EXPIRY_STORM_WINDOW_S,
        )


def record_drain(app: str, seconds: float) -> None:
    """One graceful-drain duration observation (controller-side)."""
    if not get_config().serve_observatory:
        return
    _obs_metrics()["drain_s"].observe(seconds, tags={"app": app or "-"})
    journal.emit("serve.drain", app=app, seconds=round(seconds, 3))


def set_circuit_state(app: str, replica: str, state: int) -> None:
    """Publish a handle's view of one replica's breaker (0 closed,
    1 half-open, 2 open). An open breaker is a client-visible failure
    signal — it triggers a black-box capture."""
    if not get_config().serve_observatory:
        return
    _obs_metrics()["cb_state"].set(
        float(state), tags={"app": app or "-", "replica": replica or "-"})
    journal.emit("serve.breaker", app=app, replica=replica,
                 state=int(state))
    if state == 2:
        journal.trigger_postmortem(
            f"breaker_open:{app}", app=app, replica=replica)


def reset_for_tests() -> None:
    """Drop the process-global profiler (test isolation only)."""
    global _profiler
    with _profiler_lock:
        _profiler = None


def percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over pre-sorted samples (0 when empty)."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[idx]
