"""Load-generator fleet driver.

Executes a trace (header + records from loadgen.trace) against a
callable:

  * open loop — a dispatcher thread walks the arrival offsets from a
    perf-clock origin and hands records to a worker pool; arrivals
    fire on schedule whether or not earlier requests finished (no
    coordinated omission — the queue grows, as real traffic would).
  * closed loop — ``concurrency`` virtual users issue, wait, think
    (the record's pre-drawn think time), repeat; in-flight never
    exceeds the bound.

The driver also anchors any chaos schedule recorded in the trace
header at the run's t=0 (chaos.anchor_schedule), so a recorded fault
scenario replays in lockstep with the traffic.

``call_fn(request, card) -> card`` is the pluggable dispatch: the
serve-backed one (serve_call_fn) drives a deployment handle with
client stamp cards; tests substitute a stub and never need a cluster.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from ray_tpu_torch.loadgen.client import StampCard, call_streaming, call_unary
from ray_tpu_torch.serve.observatory import percentile

_metrics_lock = threading.Lock()
_metrics: Optional[Dict] = None


def _lg_metrics() -> Dict:
    global _metrics
    with _metrics_lock:
        if _metrics is None:
            from ray_tpu_torch.util import metrics as _mx

            _metrics = {
                "requests": _mx.get_or_create(
                    _mx.Counter, "loadgen_requests_total",
                    "Requests issued by the loadgen fleet, by tenant and "
                    "outcome (ok/error)",
                    tag_keys=("tenant", "outcome"),
                ),
                "e2e_s": _mx.get_or_create(
                    _mx.Histogram, "loadgen_client_e2e_seconds",
                    "Client-observed end-to-end latency (send to last "
                    "chunk), measured outside the serving stack",
                    boundaries=_mx.LATENCY_BOUNDARIES_WIDE,
                    tag_keys=("tenant",),
                ),
                "ttfb_s": _mx.get_or_create(
                    _mx.Histogram, "loadgen_client_ttfb_seconds",
                    "Client-observed time to first byte (the TTFT the "
                    "user sees, handle overhead and wire included)",
                    boundaries=_mx.LATENCY_BOUNDARIES_WIDE,
                    tag_keys=("tenant",),
                ),
                "offered_qps": _mx.get_or_create(
                    _mx.Gauge, "loadgen_offered_qps",
                    "Offered arrival rate of the active loadgen run",
                ),
            }
        return _metrics


class RunResult:
    """Outcome of one trace execution."""

    def __init__(self, cards: List[Optional[StampCard]], kind: str,
                 t0_epoch: float, duration_s: float):
        self.cards = [c for c in cards if c is not None]
        self.kind = kind
        self.t0_epoch = t0_epoch
        self.duration_s = duration_s

    @property
    def ok_cards(self) -> List[StampCard]:
        return [c for c in self.cards if c.ok]

    @property
    def errors(self) -> int:
        return sum(1 for c in self.cards if not c.ok)

    @property
    def achieved_qps(self) -> float:
        if self.duration_s <= 0:
            return 0.0
        return len(self.ok_cards) / self.duration_s

    def summary(self) -> Dict:
        ok = self.ok_cards
        e2es = sorted(c.client_e2e_s for c in ok)
        ttfbs = sorted(c.ttfb_s for c in ok if c.ttfb_s is not None)
        by_tenant: Dict[str, int] = {}
        for c in self.cards:
            by_tenant[c.tenant] = by_tenant.get(c.tenant, 0) + 1
        return {
            "kind": self.kind,
            "issued": len(self.cards),
            "ok": len(ok),
            "errors": self.errors,
            "shed": sum(
                1 for c in self.cards
                if c.error and "ServeOverloadedError" in c.error),
            "duration_s": self.duration_s,
            "achieved_qps": self.achieved_qps,
            "client_e2e_s": {"p50": percentile(e2es, 0.50),
                             "p99": percentile(e2es, 0.99)},
            "client_ttfb_s": {"p50": percentile(ttfbs, 0.50),
                              "p99": percentile(ttfbs, 0.99)},
            "by_tenant": by_tenant,
        }


def serve_call_fn(app: str, stream: bool = True,
                  deadline_s: float = 0.0,
                  max_retries: Optional[int] = None) -> Callable:
    """call_fn driving a serve deployment: one tenant-bound handle per
    tenant (shared router state underneath), streaming or unary."""
    from ray_tpu_torch import serve

    base = serve.get_app_handle(app)
    handles: Dict[str, object] = {}
    hlock = threading.Lock()

    def call(request: Dict, card: StampCard) -> StampCard:
        tenant = request.get("tenant", "")
        with hlock:
            h = handles.get(tenant)
            if h is None:
                kwargs = {"stream": stream, "tenant": tenant,
                          "deadline_s": deadline_s}
                if max_retries is not None:
                    kwargs["max_retries"] = max_retries
                h = base.options(**kwargs)
                handles[tenant] = h
        if stream:
            return call_streaming(h, request, card)
        return call_unary(h, request, card)

    return call


def apply_chaos_schedule(header: Dict) -> int:
    """Register the trace header's chaos entries as schedule-anchored
    faults (chaos must already be enabled). Returns the count
    registered; the runner anchors t=0 when the run starts."""
    from ray_tpu_torch._private import chaos

    entries = header.get("chaos") or []
    for e in entries:
        if e["kind"] == "kill_replica":
            chaos.kill_replica_at(e["t"], **e.get("kwargs", {}))
        elif e["kind"] == "drop_controller":
            chaos.drop_controller_at(e["t"], **e.get("kwargs", {}))
        else:
            raise ValueError(f"unknown chaos kind {e['kind']!r} in trace")
    return len(entries)


def run_trace(header: Dict, records: Sequence[Dict], call_fn: Callable,
              workers: int = 64, emit_metrics: bool = True) -> RunResult:
    """Execute a trace. Open loop uses a ``workers``-thread pool fed on
    the arrival schedule; closed loop runs ``header['concurrency']``
    virtual users. Chaos entries recorded in the header fire relative
    to this run's t=0 when chaos is enabled."""
    from ray_tpu_torch._private import chaos

    kind = header.get("kind", "open")
    m = _lg_metrics() if emit_metrics else None
    if m is not None and header.get("duration_s"):
        m["offered_qps"].set(len(records) / header["duration_s"])
    cards: List[Optional[StampCard]] = [None] * len(records)

    def execute(rec: Dict) -> None:
        card = StampCard(rec["i"], rec.get("tenant", ""),
                         sched_t=rec.get("t", 0.0))
        try:
            call_fn(rec, card)
        except Exception as e:  # noqa: BLE001 — a call_fn that leaks an
            # exception must not kill the worker; the card records it.
            card.error = card.error or f"{type(e).__name__}: {e}"
        cards[rec["i"]] = card
        if m is not None:
            outcome = "ok" if card.ok else "error"
            m["requests"].inc(1, tags={"tenant": card.tenant,  # rtlint: disable=RT013 — tenant set is bounded by the trace file's tenant column, fixed per run
                                       "outcome": outcome})
            if card.ok:
                m["e2e_s"].observe(card.client_e2e_s,  # rtlint: disable=RT013 — bounded: tenants are fixed per trace
                                   tags={"tenant": card.tenant})
                if card.ttfb_s is not None:
                    m["ttfb_s"].observe(card.ttfb_s,  # rtlint: disable=RT013 — bounded: tenants are fixed per trace
                                        tags={"tenant": card.tenant})

    t0_epoch = time.time()
    if chaos.enabled() and (header.get("chaos") or []):
        chaos.anchor_schedule()
    t0 = time.perf_counter()
    if kind == "open":
        _drive_open(records, execute, workers)
    else:
        _drive_closed(records, execute,
                      int(header.get("concurrency", 8)))
    duration = time.perf_counter() - t0
    return RunResult(cards, kind, t0_epoch, duration)


def _drive_open(records: Sequence[Dict], execute: Callable,
                workers: int) -> None:
    q: queue_mod.Queue = queue_mod.Queue()
    threads = [
        threading.Thread(target=_pool_worker, args=(q, execute),
                         name=f"rt-loadgen-{i}", daemon=True)
        for i in range(max(1, workers))
    ]
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    for rec in records:
        delay = rec["t"] - (time.perf_counter() - t0)
        if delay > 0:
            time.sleep(delay)
        # Behind schedule: fire immediately (open loop never skips —
        # lateness shows up as queueing, exactly like real overload).
        q.put(rec)
    for _ in threads:
        q.put(None)
    for t in threads:
        t.join()


def _pool_worker(q: "queue_mod.Queue", execute: Callable) -> None:
    while True:
        rec = q.get()
        if rec is None:
            return
        execute(rec)


def _drive_closed(records: Sequence[Dict], execute: Callable,
                  concurrency: int) -> None:
    it = iter(records)
    lock = threading.Lock()

    def user() -> None:
        while True:
            with lock:
                rec = next(it, None)
            if rec is None:
                return
            execute(rec)
            think = rec.get("t", 0.0)
            if think > 0:
                time.sleep(think)

    threads = [
        threading.Thread(target=user, name=f"rt-loadgen-user-{i}",
                         daemon=True)
        for i in range(max(1, concurrency))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
