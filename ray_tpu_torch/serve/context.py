"""Request-scoped serving metadata. A copy of ray_tpu/serve/context.py.

The observatory's ``RequestContext`` answers "where did the time go"; this
module answers "is this request still worth running".  A ``RequestMeta``
is built once at the handle (absolute ``deadline_ts``, tenant label,
idempotency key), shipped alongside every hop (handle→proxy→replica→
engine) as a plain dict, and re-hydrated into a thread-local on the
replica's request thread so code the user callable calls into — notably
``ContinuousBatchingEngine.submit`` — can read the deadline without the
user threading it through their own signatures.

Deadlines are *absolute* wall-clock timestamps, not budgets: every hop
compares ``time.time()`` against the same number, so elapsed time is
subtracted implicitly and no hop can accidentally reset the clock.
Single-node clocks are shared; on multi-host this inherits normal NTP
skew, which is fine at the ≥100 ms deadlines serving uses.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional


class RequestMeta:
    """Per-request survival metadata (immutable after construction)."""

    __slots__ = ("deadline_ts", "tenant", "idem_key", "rid")

    def __init__(self, deadline_ts: float = 0.0, tenant: str = "",
                 idem_key: str = "", rid: str = ""):
        self.deadline_ts = deadline_ts  # 0.0 == no deadline
        self.tenant = tenant
        self.idem_key = idem_key
        self.rid = rid

    # -- wire form ---------------------------------------------------
    def to_wire(self) -> Dict[str, Any]:
        return {"deadline_ts": self.deadline_ts, "tenant": self.tenant,
                "idem_key": self.idem_key, "rid": self.rid}

    @classmethod
    def from_wire(cls, wire: Optional[Dict[str, Any]]) -> "RequestMeta":
        if not wire:
            return cls()
        return cls(
            deadline_ts=float(wire.get("deadline_ts", 0.0) or 0.0),
            tenant=str(wire.get("tenant", "") or ""),
            idem_key=str(wire.get("idem_key", "") or ""),
            rid=str(wire.get("rid", "") or ""),
        )

    # -- deadline arithmetic -----------------------------------------
    def remaining(self, now: Optional[float] = None) -> float:
        """Seconds of budget left; ``inf`` when no deadline is set."""
        if not self.deadline_ts:
            return float("inf")
        return self.deadline_ts - (time.time() if now is None else now)

    def expired(self, now: Optional[float] = None) -> bool:
        return bool(self.deadline_ts) and self.remaining(now) <= 0.0


_local = threading.local()


def current() -> Optional[RequestMeta]:
    """The RequestMeta bound to this thread, or None outside a request."""
    return getattr(_local, "meta", None)


class bind:
    """Context manager binding a RequestMeta to the current thread.

    The replica wraps each request-thread body in ``with bind(meta):`` so
    engine code deep in the user callable sees the right deadline even
    though the callable's signature never mentions one.
    """

    def __init__(self, meta: Optional[RequestMeta]):
        self._meta = meta
        self._prev: Optional[RequestMeta] = None

    def __enter__(self):
        self._prev = getattr(_local, "meta", None)
        _local.meta = self._meta
        return self._meta

    def __exit__(self, *exc):
        _local.meta = self._prev
        return False


def remaining_budget(default: float = float("inf")) -> float:
    """Budget left for the current request (``default`` when unbound)."""
    meta = current()
    if meta is None:
        return default
    return meta.remaining()
