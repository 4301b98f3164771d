"""Arrival processes: when each request enters the system.

Two regimes with opposite failure semantics (the distinction every
serious load study hinges on):

  * OPEN LOOP — arrivals are exogenous: a precomputed schedule of
    offsets fires regardless of how the system responds, so queueing
    delay compounds under saturation exactly as it does for real user
    traffic (no coordinated omission). Poisson (memoryless) or Pareto
    (heavy-tailed, bursty) inter-arrivals, modulated by a RateCurve
    via thinning.
  * CLOSED LOOP — arrivals are completion-driven: a bounded fleet of
    virtual users each issues, waits, thinks, repeats. Throughput
    self-limits to what the system serves; concurrency never exceeds
    the bound. Useful for capacity probing, wrong for latency-under-
    overload.

Schedules are pure functions of (spec, seed) — same seed, same floats,
same bytes on disk.
"""

from __future__ import annotations

import random
from typing import List

from ray_tpu_torch.loadgen.workload import RateCurve

#: Arrival process names accepted by open_loop_arrivals.
PROCESSES = ("poisson", "pareto")


def open_loop_arrivals(curve: RateCurve, duration_s: float, seed: int,
                      process: str = "poisson",
                      pareto_alpha: float = 1.5) -> List[float]:
    """Deterministic open-loop arrival offsets in [0, duration_s).

    Poisson: nonhomogeneous via Lewis thinning — candidates at the
    majorizing (peak) rate, kept with probability qps(t)/peak, so the
    realized intensity tracks the RateCurve exactly.

    Pareto: a renewal process whose inter-arrival gaps are Pareto with
    index ``pareto_alpha`` (heavier the closer to 1), scaled so the
    LOCAL mean gap is 1/qps(t) — bursty arrivals with the same average
    load, the regime that breaks queues sized for Poisson.
    """
    if process not in PROCESSES:
        raise ValueError(
            f"unknown arrival process {process!r} (want one of {PROCESSES})")
    if pareto_alpha <= 1.0:
        raise ValueError("pareto_alpha must be > 1 (finite mean)")
    rng = random.Random(seed)
    out: List[float] = []
    if process == "poisson":
        peak = curve.peak(duration_s)
        if peak <= 0:
            return out
        t = 0.0
        while True:
            t += rng.expovariate(peak)
            if t >= duration_s:
                return out
            if rng.random() * peak < curve.qps(t):
                out.append(t)
    # pareto renewal
    mean_pareto = pareto_alpha / (pareto_alpha - 1.0)
    t = 0.0
    while True:
        rate = curve.qps(t)
        if rate <= 0:
            # Dead zone in the curve: step past it without emitting.
            t += 0.1
            if t >= duration_s:
                return out
            continue
        t += rng.paretovariate(pareto_alpha) / (mean_pareto * rate)
        if t >= duration_s:
            return out
        out.append(t)


def closed_loop_think_times(num: int, seed: int,
                            mean_think_s: float = 0.0) -> List[float]:
    """Deterministic per-request think-time draws for a closed-loop run
    (exponential with the given mean; all zeros when mean is 0). Drawn
    up front so the trace can record them and a replay re-uses them."""
    if num < 0:
        raise ValueError("num must be >= 0")
    if mean_think_s <= 0:
        return [0.0] * num
    rng = random.Random(seed)
    return [rng.expovariate(1.0 / mean_think_s) for _ in range(num)]
