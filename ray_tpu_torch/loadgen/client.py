"""Client stamp cards: the witness's half of the reconciliation.

Every generated request gets a ``StampCard`` — send / first-byte /
per-chunk / done perf-clock stamps plus the observatory rid the handle
exposes (DeploymentResponse.rid / StreamingResponse.rid). The card's
``client_e2e_s`` is measured OUTSIDE the serving stack, so joining it
against the server's six-phase attribution (reconcile.py) makes any
time the server failed to attribute visible as a gap — the server can
no longer grade its own homework.

Clock discipline mirrors the observatory: durations come from
``time.perf_counter()`` deltas on the client (immune to clock steps);
the epoch ``send_t`` is kept only for ordering/joining against
schedule offsets, never differenced against server stamps.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ray_tpu_torch._private.config import get_config
from ray_tpu_torch.util import journal


class StampCard:
    """Per-request client-side timing record."""

    __slots__ = ("idx", "tenant", "rid", "sched_t", "send_t", "send_p",
                 "first_byte_p", "chunk_p", "done_p", "error", "chunks")

    def __init__(self, idx: int, tenant: str = "", sched_t: float = 0.0):
        self.idx = idx
        self.tenant = tenant or "default"
        self.rid = ""
        self.sched_t = sched_t        # schedule offset the trace assigned
        self.send_t = 0.0             # epoch at send (ordering only)
        self.send_p = 0.0             # perf stamps: the duration axis
        self.first_byte_p: Optional[float] = None
        self.chunk_p: List[float] = []
        self.done_p: Optional[float] = None
        self.error: Optional[str] = None
        self.chunks = 0

    @property
    def ok(self) -> bool:
        return self.error is None and self.done_p is not None

    @property
    def client_e2e_s(self) -> Optional[float]:
        if self.done_p is None:
            return None
        return self.done_p - self.send_p

    @property
    def ttfb_s(self) -> Optional[float]:
        """Client-observed time to first byte (the TTFT the user sees,
        handle overhead and wire included)."""
        if self.first_byte_p is None:
            return None
        return self.first_byte_p - self.send_p

    def to_doc(self) -> Dict:
        return {
            "idx": self.idx, "tenant": self.tenant, "rid": self.rid,
            "sched_t": self.sched_t, "send_t": self.send_t,
            "client_e2e_s": self.client_e2e_s, "ttfb_s": self.ttfb_s,
            "chunks": self.chunks, "error": self.error,
        }


def call_streaming(handle, request: Dict, card: StampCard) -> StampCard:
    """Issue one streaming request and stamp the card. The handle must
    already be bound to the request's tenant
    (``handle.options(stream=True, tenant=...)``)."""
    card.send_t = time.time()
    card.send_p = time.perf_counter()
    try:
        it = handle.remote(request)
        card.rid = getattr(it, "rid", "") or ""
        for _chunk in it:
            now = time.perf_counter()
            if card.first_byte_p is None:
                card.first_byte_p = now
            card.chunk_p.append(now)
            card.chunks += 1
        card.done_p = time.perf_counter()
    except Exception as e:  # noqa: BLE001 — the card IS the error report;
        # a load generator must survive every per-request failure mode
        # (shed, deadline, replica death past the retry budget).
        card.error = f"{type(e).__name__}: {e}"
        card.done_p = None
        journal.emit("client.error", rid=card.rid, tenant=card.tenant,
                     error=type(e).__name__)
    return card


def call_unary(handle, request: Dict, card: StampCard) -> StampCard:
    """Issue one unary request and stamp the card (first byte == done)."""
    card.send_t = time.time()
    card.send_p = time.perf_counter()
    try:
        resp = handle.remote(request)
        card.rid = getattr(resp, "rid", "") or ""
        resp.result(timeout=get_config().serve_rpc_timeout_s)
        card.done_p = time.perf_counter()
        card.first_byte_p = card.done_p
        card.chunks = 1
    except Exception as e:  # noqa: BLE001 — same contract as streaming:
        # failures are data, not crashes.
        card.error = f"{type(e).__name__}: {e}"
        card.done_p = None
        journal.emit("client.error", rid=card.rid, tenant=card.tenant,
                     error=type(e).__name__)
    return card
