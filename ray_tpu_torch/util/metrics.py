"""User-facing application metrics: Counter, Gauge, Histogram.

Analog of the reference's ``ray.util.metrics`` (python/ray/util/metrics.py:
Counter :19, Gauge :150, Histogram :229). Metric records are aggregated
locally and flushed to the GCS metrics table once a second by a background
thread; the dashboard exports the cluster-wide aggregate in Prometheus
text format at ``/metrics`` (the role the per-node metrics agent +
prometheus_exporter.py plays in the reference).
"""

from __future__ import annotations

import atexit
import threading
import time
from bisect import bisect_left as _bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

_DEFAULT_BOUNDARIES = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    25.0, 50.0, 100.0,
)

# Boundaries for step/latency-class histograms (seconds). Device step phases
# (dispatch, fetch, collective, feed stall) live well under the 5ms floor
# of _DEFAULT_BOUNDARIES; metrics that time hot-loop phases should pass
# these instead. Existing metrics keep _DEFAULT_BOUNDARIES — the GCS
# aggregator rejects a histogram re-registered under different
# boundaries, so the default must stay stable.
LATENCY_BOUNDARIES = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# LATENCY_BOUNDARIES with a multi-second tail, for request-scale
# histograms (e2e, TTFT) whose macro-load p99s run past 10s and would
# otherwise clamp into the +Inf bucket. A separate tuple — NOT an edit
# to LATENCY_BOUNDARIES — because the aggregator rejects re-registered
# histograms whose boundaries changed; only metrics that have always
# used this tuple may use it.
LATENCY_BOUNDARIES_WIDE = LATENCY_BOUNDARIES + (
    15.0, 25.0, 40.0, 60.0, 90.0, 120.0, 180.0, 300.0,
)

_registry_lock = threading.Lock()
_registry: List["Metric"] = []
_flusher_started = False


def _tags_key(tags: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(tags.items()))


class Metric:
    def __init__(
        self,
        name: str,
        description: str = "",
        tag_keys: Optional[Sequence[str]] = None,
    ):
        if not name:
            raise ValueError("metric name is required")
        self._name = name
        self._description = description
        self._tag_keys = tuple(tag_keys or ())
        self._default_tags: Dict[str, str] = {}
        self._lock = threading.Lock()
        with _registry_lock:
            _registry.append(self)
        _ensure_flusher()

    @property
    def info(self) -> Dict:
        return {
            "name": self._name,
            "description": self._description,
            "tag_keys": self._tag_keys,
            "default_tags": dict(self._default_tags),
        }

    def set_default_tags(self, tags: Dict[str, str]):
        self._check_tags(tags)
        self._default_tags = dict(tags)
        return self

    def _check_tags(self, tags: Optional[Dict[str, str]]):
        for k in tags or ():
            if k not in self._tag_keys:
                raise ValueError(
                    f"tag {k!r} was not declared in tag_keys={self._tag_keys}"
                )

    def _merged(self, tags: Optional[Dict[str, str]]) -> Dict[str, str]:
        self._check_tags(tags)
        merged = dict(self._default_tags)
        merged.update(tags or {})
        return merged

    def _key(self, tags: Optional[Dict[str, str]]) -> tuple:
        """Resolve tags to the internal series key once, for hot paths
        that record per step/request: validate + merge + sort here, then
        pass the key to *_keyed() on every observation."""
        return _tags_key(self._merged(tags))

    def _drain(self) -> Optional[dict]:  # -> report record or None
        raise NotImplementedError


class Counter(Metric):
    """Monotonically increasing value (util/metrics.py:19)."""

    def __init__(self, name, description="", tag_keys=None):
        super().__init__(name, description, tag_keys)
        self._deltas: Dict[tuple, float] = {}

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None):
        if value <= 0:
            raise ValueError("Counter.inc() requires value > 0")
        self.inc_keyed(self._key(tags), value)

    def inc_keyed(self, key: tuple, value: float = 1.0):
        """inc() with a key pre-resolved via _key() — per-step hot path."""
        with self._lock:
            self._deltas[key] = self._deltas.get(key, 0.0) + value

    def _drain(self):
        with self._lock:
            if not self._deltas:
                return None
            deltas, self._deltas = self._deltas, {}
        return {
            "type": "counter",
            "name": self._name,
            "description": self._description,
            "data": [[list(k), v] for k, v in deltas.items()],
        }


class Gauge(Metric):
    """Point-in-time value (util/metrics.py:150)."""

    def __init__(self, name, description="", tag_keys=None):
        super().__init__(name, description, tag_keys)
        self._values: Dict[tuple, float] = {}
        self._dirty = False

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        self.set_keyed(self._key(tags), value)

    def set_keyed(self, key: tuple, value: float):
        """set() with a key pre-resolved via _key() — per-step hot path."""
        with self._lock:
            self._values[key] = float(value)
            self._dirty = True

    def _drain(self):
        with self._lock:
            if not self._dirty:
                return None
            self._dirty = False
            values = dict(self._values)
        return {
            "type": "gauge",
            "name": self._name,
            "description": self._description,
            "data": [[list(k), v] for k, v in values.items()],
        }


class Histogram(Metric):
    """Distribution over fixed bucket boundaries (util/metrics.py:229)."""

    def __init__(self, name, description="", boundaries=None, tag_keys=None):
        bounds = tuple(boundaries or _DEFAULT_BOUNDARIES)
        if list(bounds) != sorted(bounds):
            raise ValueError("histogram boundaries must be sorted")
        super().__init__(name, description, tag_keys)
        self._boundaries = bounds
        # per-tags: [bucket_counts (len boundaries+1), sum, count]
        self._state: Dict[tuple, list] = {}
        # Lifetime aggregates, NOT cleared by _drain: local observers
        # (engine stats endpoints) read these without perturbing the
        # once-a-second GCS/Prometheus flush.
        self._life_sum = 0.0
        self._life_count = 0
        self._life_max = 0.0

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        self.observe_keyed(self._key(tags), value)

    def observe_keyed(self, key: tuple, value: float):
        """observe() with a key pre-resolved via _key() — hot path."""
        with self._lock:
            st = self._state.get(key)
            if st is None:
                st = self._state[key] = [
                    [0] * (len(self._boundaries) + 1), 0.0, 0,
                ]
            st[0][_bisect_left(self._boundaries, value)] += 1
            st[1] += value
            st[2] += 1
            self._life_sum += value
            self._life_count += 1
            if value > self._life_max:
                self._life_max = value

    def summary(self) -> Dict:
        """Lifetime {count, sum, avg, max} across all tag sets — a
        local, non-draining read (the flusher's _drain keeps its own
        delta state untouched by this)."""
        with self._lock:
            count = self._life_count
            return {
                "count": count,
                "sum": self._life_sum,
                "avg": self._life_sum / count if count else 0.0,
                "max": self._life_max,
            }

    def _drain(self):
        with self._lock:
            if not self._state:
                return None
            state, self._state = self._state, {}
        return {
            "type": "histogram",
            "name": self._name,
            "description": self._description,
            "boundaries": list(self._boundaries),
            "data": [
                [list(k), {"buckets": st[0], "sum": st[1], "count": st[2]}]
                for k, st in state.items()
            ],
        }


def get_or_create(metric_cls, name: str, description: str = "", **kwargs):
    """Return the already-registered metric called `name` (of the same
    class) or create it. Module-level metric definitions that can be
    re-imported/re-executed (trainer restarts, test reruns in one
    process) must not register duplicates — the flusher would double-
    report every increment."""
    with _registry_lock:
        for m in _registry:
            if m._name == name and type(m) is metric_cls:
                return m
    return metric_cls(name, description, **kwargs)


def _flush_once() -> bool:
    """Drain all registered metrics into one GCS report. Returns True if
    anything was sent."""
    from ray_tpu_torch._private import worker as worker_mod

    client = worker_mod.get_client_or_none()
    if client is None or not getattr(client, "_connected", False):
        return False
    with _registry_lock:
        metrics = list(_registry)
    records = []
    for m in metrics:
        try:
            r = m._drain()
        except Exception:  # one broken metric must not poison the batch
            continue
        if r is not None:
            records.append(r)
    if not records:
        return False
    try:
        client._run(
            client.gcs.call("metrics_report", {"records": records}), timeout=5
        )
        return True
    except Exception:
        return False


def _flusher_loop():
    while True:
        time.sleep(1.0)
        try:
            _flush_once()
        except Exception:
            pass


def _ensure_flusher():
    global _flusher_started
    with _registry_lock:
        if _flusher_started:
            return
        _flusher_started = True
    threading.Thread(
        target=_flusher_loop, name="rt-metrics-flush", daemon=True
    ).start()
    # Final drain at interpreter exit: a short-lived task/worker that
    # records and exits within the flusher's 1s period would otherwise
    # silently drop its last counters (profiling.py registers the same
    # guard for timeline spans). Registered with the flusher — once per
    # process, and only in processes that actually use metrics.
    atexit.register(_flush_once)
