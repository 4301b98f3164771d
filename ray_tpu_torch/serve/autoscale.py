"""ServeSignals-driven replica autoscaling policy.

The controller's original `_autoscale` probed every replica with an
actor call per reconcile tick — O(replicas) RPCs just to learn the
queue depth the observatory already publishes. This module is the
other half of PR 7's signal plane: a PURE decision function over the
published ServeSignals snapshot (one `kv_get`, zero actor calls) that
the controller consults each tick.

Signals consulted, in order of authority:

  * mean ongoing requests per reachable replica vs
    `target_ongoing_requests` (the reference autoscaler's primary);
  * engine admission-queue depth per replica vs `upscale_queue_depth`
    (saturation shows here before latency does);
  * TTFT p99 vs `ttft_p99_high_ms` and the max tenant SLO burn rate vs
    `burn_rate_high` — both opt-in (None disables), both upscale-only
    pressure plus a hold against scaling down while elevated.

Hysteresis: pressure must persist for `upscale_delay_s` (resp.
`downscale_delay_s`) before the target moves, one replica per move,
with the same delay as a cooldown between moves — so a traffic ramp
walks the replica count up and back down instead of flapping. The
function is pure in `now`, which is what makes the hysteresis unit-
testable with a fake clock (tests/test_paged_kv.py drives it through
minutes of synthetic traffic in microseconds).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional


@dataclass
class AutoscalerState:
    """Per-app hysteresis memory the controller keeps between ticks."""

    high_since: Optional[float] = None   # pressure-up first seen at
    low_since: Optional[float] = None    # pressure-down first seen at
    last_change: Optional[float] = None  # last target move (cooldown)
    last_reason: str = ""                # why the last decision happened


def _max_burn(app_signals: Dict) -> float:
    burn = 0.0
    for rows in (app_signals.get("tenants") or {}).values():
        for windows in (rows.get("slo_windows") or {}).values():
            for w in windows.values():
                try:
                    burn = max(burn, float(w.get("burn") or 0.0))
                except (TypeError, ValueError):
                    pass
    return burn


def extract_load(app_signals: Dict) -> Dict:
    """Flatten one app's signals into the numbers decide() scores.
    Tolerant of missing fields (older publishers)."""
    reps = [r for r in (app_signals.get("replicas") or [])
            if not r.get("unreachable")]
    ongoing = [float(r.get("ongoing") or 0.0) for r in reps]
    n = max(1, len(ongoing))
    ttft = (app_signals.get("ttft_s") or {})
    return {
        "replicas": len(reps),
        "ongoing_mean": sum(ongoing) / n,
        "waiting": float(app_signals.get("waiting") or 0.0),
        "waiting_per_replica": float(app_signals.get("waiting") or 0.0) / n,
        "ttft_p99_ms": (float(ttft["p99"]) * 1e3
                        if ttft.get("p99") is not None else None),
        "burn_max": _max_burn(app_signals),
    }


def decide(app_signals: Dict, acfg, state: AutoscalerState, now: float,
           current_target: int, running: int) -> int:
    """New replica target for one app. Mutates `state` (hysteresis
    memory); clamps to [min_replicas, max_replicas]; moves at most one
    replica per call. `now` is any monotonic clock."""
    load = extract_load(app_signals)
    up_reasons = []
    if load["ongoing_mean"] > acfg.target_ongoing_requests:
        up_reasons.append(
            f"ongoing {load['ongoing_mean']:.2f} > "
            f"target {acfg.target_ongoing_requests:g}")
    queue_high = getattr(acfg, "upscale_queue_depth", 1.0)
    if queue_high is not None and load["waiting_per_replica"] > queue_high:
        up_reasons.append(
            f"queued/replica {load['waiting_per_replica']:.2f} > "
            f"{queue_high:g}")
    ttft_high = getattr(acfg, "ttft_p99_high_ms", None)
    ttft_hot = (ttft_high is not None and load["ttft_p99_ms"] is not None
                and load["ttft_p99_ms"] > ttft_high)
    if ttft_hot:
        up_reasons.append(
            f"ttft p99 {load['ttft_p99_ms']:.0f}ms > {ttft_high:g}ms")
    burn_high = getattr(acfg, "burn_rate_high", None)
    burn_hot = burn_high is not None and load["burn_max"] > burn_high
    if burn_hot:
        up_reasons.append(f"burn {load['burn_max']:.2f} > {burn_high:g}")

    pressure_up = bool(up_reasons)
    # Downscale only when EVERY signal is comfortably idle: ongoing
    # under half the target, nothing queued, and no elevated latency or
    # burn holding the fleet where it is.
    pressure_down = (not pressure_up
                     and load["ongoing_mean"]
                     < 0.5 * acfg.target_ongoing_requests
                     and load["waiting"] == 0
                     and not ttft_hot and not burn_hot)

    target = current_target
    if pressure_up:
        state.low_since = None
        if state.high_since is None:
            state.high_since = now
        held = now - state.high_since
        cooled = (state.last_change is None
                  or now - state.last_change >= acfg.upscale_delay_s)
        if (held >= acfg.upscale_delay_s and cooled
                and current_target < acfg.max_replicas):
            target = current_target + 1
            state.last_change = now
            state.high_since = now  # re-arm: next step needs its own hold
            state.last_reason = "up: " + "; ".join(up_reasons)
    elif pressure_down:
        state.high_since = None
        if state.low_since is None:
            state.low_since = now
        held = now - state.low_since
        cooled = (state.last_change is None
                  or now - state.last_change >= acfg.downscale_delay_s)
        if (held >= acfg.downscale_delay_s and cooled
                and current_target > acfg.min_replicas):
            target = current_target - 1
            state.last_change = now
            state.low_since = now
            state.last_reason = (
                f"down: idle (ongoing {load['ongoing_mean']:.2f}, "
                f"waiting {load['waiting']:g})")
    else:
        state.high_since = None
        state.low_since = None

    return max(acfg.min_replicas, min(acfg.max_replicas, target))
