"""Workload shapes for the macro traffic harness.

Three orthogonal knobs compose a traffic scenario:

  * ``RateCurve`` — the offered-load trajectory qps(t): a base rate,
    an optional linear ramp, a diurnal sine, and flash crowds (step
    multipliers over fixed windows). Pure function of t, JSON-safe, so
    a recorded trace can carry the exact curve it was generated from.
  * ``LengthMix`` — heavy-tailed prompt/output token lengths: a
    bounded lognormal (body) plus a tail bucket hit with probability
    ``tail_p`` (the long-context requests that dominate engine cost).
  * ``TenantBlend`` — a weighted multi-tenant mix, each tenant with
    its own LengthMix, so fairness/SLO-burn behavior is exercised by
    the same run that measures latency.

Everything draws from a caller-owned ``random.Random`` — the single
seed threaded through ray_tpu_torch.loadgen is what makes a scenario
replayable byte-for-byte.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Sequence, Tuple


class RateCurve:
    """Offered load qps(t), t in seconds from the run origin.

    qps(t) = max(base(t) * diurnal(t) * flash(t), 0) where base(t)
    ramps linearly from ``base_qps`` to ``ramp_to_qps`` over
    ``ramp_s`` (then holds), diurnal(t) is 1 + amplitude *
    sin(2*pi*t/period), and flash(t) multiplies by ``mult`` inside
    each (start, duration) window.
    """

    def __init__(self, base_qps: float, ramp_to_qps: Optional[float] = None,
                 ramp_s: float = 0.0, diurnal_amplitude: float = 0.0,
                 diurnal_period_s: float = 86400.0,
                 flash: Sequence[Tuple[float, float, float]] = ()):
        if base_qps < 0:
            raise ValueError("base_qps must be >= 0")
        if not 0.0 <= diurnal_amplitude < 1.0:
            raise ValueError("diurnal_amplitude must be in [0, 1)")
        self.base_qps = float(base_qps)
        self.ramp_to_qps = (
            float(ramp_to_qps) if ramp_to_qps is not None else None)
        self.ramp_s = float(ramp_s)
        self.diurnal_amplitude = float(diurnal_amplitude)
        self.diurnal_period_s = float(diurnal_period_s)
        # (start_s, duration_s, multiplier) step windows.
        self.flash = [(float(s), float(d), float(m)) for s, d, m in flash]

    def qps(self, t: float) -> float:
        base = self.base_qps
        if self.ramp_to_qps is not None and self.ramp_s > 0:
            frac = min(max(t / self.ramp_s, 0.0), 1.0)
            base = base + (self.ramp_to_qps - base) * frac
        if self.diurnal_amplitude:
            base *= 1.0 + self.diurnal_amplitude * math.sin(
                2.0 * math.pi * t / self.diurnal_period_s)
        for start, dur, mult in self.flash:
            if start <= t < start + dur:
                base *= mult
        return max(base, 0.0)

    def peak(self, duration_s: float) -> float:
        """Upper bound on qps over [0, duration_s] — the majorizing rate
        for Poisson thinning. Sampled on a 100ms grid plus the exact
        edges of every flash window (step changes between grid points
        must not be missed)."""
        ts = [i * 0.1 for i in range(int(duration_s * 10) + 1)]
        for start, dur, _ in self.flash:
            ts.extend((start, min(start + dur - 1e-9, duration_s)))
        return max((self.qps(min(t, duration_s)) for t in ts),
                   default=self.base_qps)

    def to_doc(self) -> Dict:
        return {
            "base_qps": self.base_qps,
            "ramp_to_qps": self.ramp_to_qps,
            "ramp_s": self.ramp_s,
            "diurnal_amplitude": self.diurnal_amplitude,
            "diurnal_period_s": self.diurnal_period_s,
            "flash": [list(f) for f in self.flash],
        }

    @classmethod
    def from_doc(cls, doc: Dict) -> "RateCurve":
        return cls(
            base_qps=doc["base_qps"],
            ramp_to_qps=doc.get("ramp_to_qps"),
            ramp_s=doc.get("ramp_s", 0.0),
            diurnal_amplitude=doc.get("diurnal_amplitude", 0.0),
            diurnal_period_s=doc.get("diurnal_period_s", 86400.0),
            flash=[tuple(f) for f in doc.get("flash", [])],
        )


class LengthMix:
    """Heavy-tailed token-length distribution: lognormal body with a
    tail bucket. ``draw`` returns an int clamped to [lo, hi]."""

    def __init__(self, median: int = 128, sigma: float = 0.8,
                 lo: int = 1, hi: int = 4096,
                 tail_p: float = 0.02, tail_lo: int = 1024,
                 tail_hi: int = 4096):
        self.median = int(median)
        self.sigma = float(sigma)
        self.lo = int(lo)
        self.hi = int(hi)
        self.tail_p = float(tail_p)
        self.tail_lo = int(tail_lo)
        self.tail_hi = int(tail_hi)

    def draw(self, rng: random.Random) -> int:
        if self.tail_p and rng.random() < self.tail_p:
            return rng.randint(self.tail_lo, self.tail_hi)
        n = int(round(rng.lognormvariate(math.log(self.median),
                                         self.sigma)))
        return min(max(n, self.lo), self.hi)

    def to_doc(self) -> Dict:
        return {
            "median": self.median, "sigma": self.sigma,
            "lo": self.lo, "hi": self.hi, "tail_p": self.tail_p,
            "tail_lo": self.tail_lo, "tail_hi": self.tail_hi,
        }

    @classmethod
    def from_doc(cls, doc: Dict) -> "LengthMix":
        return cls(**doc)


class TenantBlend:
    """Weighted multi-tenant traffic mix. Each tenant carries its own
    prompt/output LengthMix; ``draw`` picks a tenant then its lengths."""

    def __init__(self, tenants: Sequence[Dict]):
        if not tenants:
            raise ValueError("TenantBlend needs at least one tenant")
        self.tenants: List[Dict] = []
        for t in tenants:
            self.tenants.append({
                "name": t["name"],
                "weight": float(t.get("weight", 1.0)),
                "prompt": (t["prompt"] if isinstance(t.get("prompt"),
                                                     LengthMix)
                           else LengthMix(**(t.get("prompt") or {}))),
                "output": (t["output"] if isinstance(t.get("output"),
                                                     LengthMix)
                           else LengthMix(**(t.get("output") or {}))),
            })
        self._cum: List[float] = []
        total = sum(t["weight"] for t in self.tenants)
        acc = 0.0
        for t in self.tenants:
            acc += t["weight"] / total
            self._cum.append(acc)

    def draw(self, rng: random.Random) -> Dict:
        """One request's shape: {tenant, prompt_tokens, max_tokens}."""
        x = rng.random()
        idx = next((i for i, c in enumerate(self._cum) if x <= c),
                   len(self.tenants) - 1)
        t = self.tenants[idx]
        return {
            "tenant": t["name"],
            "prompt_tokens": t["prompt"].draw(rng),
            "max_tokens": t["output"].draw(rng),
        }

    def to_doc(self) -> Dict:
        return {"tenants": [
            {"name": t["name"], "weight": t["weight"],
             "prompt": t["prompt"].to_doc(), "output": t["output"].to_doc()}
            for t in self.tenants
        ]}

    @classmethod
    def from_doc(cls, doc: Dict) -> "TenantBlend":
        return cls([
            {"name": t["name"], "weight": t["weight"],
             "prompt": LengthMix.from_doc(t["prompt"]),
             "output": LengthMix.from_doc(t["output"])}
            for t in doc["tenants"]
        ])


def default_blend() -> TenantBlend:
    """The stock two-tenant blend benches and the CLI default to: an
    interactive tenant (short prompts, short outputs, 80% of traffic)
    and a batch tenant (long prompts, long outputs, heavy tail)."""
    return TenantBlend([
        {"name": "interactive", "weight": 0.8,
         "prompt": LengthMix(median=64, sigma=0.6, hi=512,
                             tail_p=0.01, tail_lo=256, tail_hi=512),
         "output": LengthMix(median=32, sigma=0.5, hi=256,
                             tail_p=0.01, tail_lo=128, tail_hi=256)},
        {"name": "batch", "weight": 0.2,
         "prompt": LengthMix(median=512, sigma=0.9, hi=4096,
                             tail_p=0.05, tail_lo=2048, tail_hi=4096),
         "output": LengthMix(median=128, sigma=0.7, hi=1024,
                             tail_p=0.03, tail_lo=512, tail_hi=1024)},
    ])
