"""Debug utilities (reference: ray.util.debug — log_once/disable_log_once)."""

from __future__ import annotations

import time
from typing import Set

_logged: Set[str] = set()
_disabled = False
_periodic: dict = {}


def log_once(key: str) -> bool:
    """True the FIRST time this key is seen (per process) — gate warnings
    that would otherwise spam per-task (reference: util/debug.py log_once)."""
    if _disabled:
        return False
    if key in _logged:
        return False
    _logged.add(key)
    return True


def log_every_n_seconds(key: str, period_s: float = 60.0) -> bool:
    """True at most once per `period_s` for this key."""
    if _disabled:
        return False
    now = time.monotonic()
    last = _periodic.get(key)
    if last is not None and now - last < period_s:
        return False
    _periodic[key] = now
    return True


def disable_log_once_globally() -> None:
    global _disabled
    _disabled = True


def enable_periodic_logging() -> None:
    global _disabled
    _disabled = False


def reset_log_once(key: str) -> None:
    _logged.discard(key)
    _periodic.pop(key, None)
