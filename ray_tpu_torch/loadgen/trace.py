"""Trace record / byte-identical replay.

A trace is one JSONL file: a header line (schema, seed, loop kind,
curve/blend docs, optional chaos schedule) followed by one line per
request ({i, t, tenant, prompt_tokens, max_tokens} — ``t`` is the
arrival offset for open loop, the think-time draw for closed loop).

Determinism contract: ``generate(spec)`` is a pure function of the
spec (seed included), and serialization is canonical (sorted keys,
fixed separators, no whitespace variance) — so generating the same
spec twice, or replaying a recorded file through ``generate`` of its
own header, produces byte-identical files; the trace's users gate on
exactly that.
"""

from __future__ import annotations

import json
import random
from typing import Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.loadgen import arrival
from ray_tpu_torch.loadgen.workload import RateCurve, TenantBlend, default_blend

SCHEMA_VERSION = 1


def _canon(obj: Dict) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


class TraceSpec:
    """Everything needed to regenerate a trace from scratch."""

    def __init__(self, seed: int, duration_s: float, curve: RateCurve,
                 blend: Optional[TenantBlend] = None, kind: str = "open",
                 process: str = "poisson", pareto_alpha: float = 1.5,
                 concurrency: int = 8, num_requests: int = 0,
                 mean_think_s: float = 0.0,
                 chaos: Sequence[Dict] = ()):
        if kind not in ("open", "closed"):
            raise ValueError("kind must be 'open' or 'closed'")
        self.seed = int(seed)
        self.duration_s = float(duration_s)
        self.curve = curve
        self.blend = blend or default_blend()
        self.kind = kind
        self.process = process
        self.pareto_alpha = float(pareto_alpha)
        self.concurrency = int(concurrency)
        self.num_requests = int(num_requests)
        self.mean_think_s = float(mean_think_s)
        # Schedule-anchored chaos entries ({kind, t, kwargs}) recorded
        # alongside the traffic they were injected into.
        self.chaos = [dict(c) for c in chaos]

    def header(self) -> Dict:
        return {
            "schema": SCHEMA_VERSION,
            "seed": self.seed,
            "duration_s": self.duration_s,
            "kind": self.kind,
            "process": self.process,
            "pareto_alpha": self.pareto_alpha,
            "concurrency": self.concurrency,
            "num_requests": self.num_requests,
            "mean_think_s": self.mean_think_s,
            "curve": self.curve.to_doc(),
            "blend": self.blend.to_doc(),
            "chaos": [
                {"kind": c["kind"], "t": c["t"],
                 "kwargs": dict(c.get("kwargs", {}))}
                for c in self.chaos
            ],
        }

    @classmethod
    def from_header(cls, doc: Dict) -> "TraceSpec":
        if doc.get("schema") != SCHEMA_VERSION:
            raise ValueError(
                f"unsupported trace schema {doc.get('schema')!r} "
                f"(this build reads {SCHEMA_VERSION})")
        return cls(
            seed=doc["seed"], duration_s=doc["duration_s"],
            curve=RateCurve.from_doc(doc["curve"]),
            blend=TenantBlend.from_doc(doc["blend"]),
            kind=doc.get("kind", "open"),
            process=doc.get("process", "poisson"),
            pareto_alpha=doc.get("pareto_alpha", 1.5),
            concurrency=doc.get("concurrency", 8),
            num_requests=doc.get("num_requests", 0),
            mean_think_s=doc.get("mean_think_s", 0.0),
            chaos=doc.get("chaos", ()),
        )


def generate(spec: TraceSpec) -> Tuple[Dict, List[Dict]]:
    """(header, records) for the spec — the deterministic core.

    Open loop: one record per arrival offset. Closed loop: exactly
    ``num_requests`` records, ``t`` holding the pre-drawn think time
    (issue order is the record order; timing is completion-driven).
    Request shapes draw from an rng seeded independently of the
    arrival rng (seed ^ a fixed salt), so changing the arrival process
    does not reshuffle every prompt length.
    """
    shape_rng = random.Random(spec.seed ^ 0x5EED5A17)
    records: List[Dict] = []
    if spec.kind == "open":
        offsets = arrival.open_loop_arrivals(
            spec.curve, spec.duration_s, spec.seed,
            process=spec.process, pareto_alpha=spec.pareto_alpha)
        for i, t in enumerate(offsets):
            shape = spec.blend.draw(shape_rng)
            records.append({"i": i, "t": t, **shape})
    else:
        thinks = arrival.closed_loop_think_times(
            spec.num_requests, spec.seed, spec.mean_think_s)
        for i, t in enumerate(thinks):
            shape = spec.blend.draw(shape_rng)
            records.append({"i": i, "t": t, **shape})
    return spec.header(), records


def dumps(header: Dict, records: List[Dict]) -> str:
    """Canonical JSONL serialization (what byte-identity is defined
    over)."""
    lines = [_canon(header)]
    lines.extend(_canon(r) for r in records)
    return "\n".join(lines) + "\n"


def write(path: str, header: Dict, records: List[Dict]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(dumps(header, records))


def read(path: str) -> Tuple[Dict, List[Dict]]:
    with open(path, "r", encoding="utf-8") as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    if not lines:
        raise ValueError(f"trace {path!r} is empty")
    header = json.loads(lines[0])
    if header.get("schema") != SCHEMA_VERSION:
        raise ValueError(
            f"unsupported trace schema {header.get('schema')!r} in {path!r}")
    return header, [json.loads(ln) for ln in lines[1:]]


def regenerate_bytes(path: str) -> bytes:
    """Re-derive the trace from its own header and return the canonical
    bytes — equal to the file's bytes iff generation is deterministic
    (the replay gate of the trace's users and tests/test_torch_loadgen)."""
    header, _ = read(path)
    spec = TraceSpec.from_header(header)
    new_header, records = generate(spec)
    return dumps(new_header, records).encode("utf-8")
