"""ray_tpu_torch.loadgen: the cluster witness (the PyTorch port of
ray_tpu/loadgen/, same names, same trace bytes for a spec).

A load-generator fleet plus a client<->server latency reconciler —
the macro harness that drives the full handle->replica->engine stack
at sustained multi-tenant load and then checks the serving stack's
own latency attribution against what clients actually observed.

  * workload  — RateCurve (ramps, diurnal, flash crowds), heavy-tailed
                LengthMix, multi-tenant TenantBlend
  * arrival   — open-loop (Poisson / Pareto) and closed-loop arrival
                processes, seeded-deterministic
  * trace     — JSONL record / byte-identical replay
  * client    — per-request stamp cards (send / first byte / chunks /
                done + the observatory rid)
  * reconcile — unattributed_gap = client_e2e - server_attributed,
                p50/p99 + the gap_fraction <= 0.05 gate
  * runner    — the fleet driver (also replays chaos schedules
                anchored to the trace origin)

Entry point: ``python -m ray_tpu_torch loadgen gen|run`` (the port's
``rt loadgen``). Nothing here loads torch: the fleet only routes.
"""

from ray_tpu_torch.loadgen.arrival import (
    closed_loop_think_times,
    open_loop_arrivals,
)
from ray_tpu_torch.loadgen.client import StampCard, call_streaming, call_unary
from ray_tpu_torch.loadgen.reconcile import (
    GAP_FRACTION_LIMIT,
    collect_server_records,
    reconcile,
    render_report,
)
from ray_tpu_torch.loadgen.runner import (
    RunResult,
    apply_chaos_schedule,
    run_trace,
    serve_call_fn,
)
from ray_tpu_torch.loadgen.trace import TraceSpec, generate, regenerate_bytes
from ray_tpu_torch.loadgen.workload import (
    LengthMix,
    RateCurve,
    TenantBlend,
    default_blend,
)

__all__ = [
    "GAP_FRACTION_LIMIT",
    "LengthMix",
    "RateCurve",
    "RunResult",
    "StampCard",
    "TenantBlend",
    "TraceSpec",
    "apply_chaos_schedule",
    "call_streaming",
    "call_unary",
    "closed_loop_think_times",
    "collect_server_records",
    "default_blend",
    "generate",
    "open_loop_arrivals",
    "reconcile",
    "regenerate_bytes",
    "render_report",
    "run_trace",
    "serve_call_fn",
]
