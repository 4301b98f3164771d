"""Grafana dashboard generation from the metrics surface (the PyTorch
port's counterpart of ray_tpu/dashboard/grafana.py: the same panels and
expressions; only the title and the uid name the port and the GPU).

Analog of the reference's grafana_dashboard_factory
(dashboard/modules/metrics/grafana_dashboard_factory.py): emit a Grafana
dashboard JSON whose panels query the Prometheus metrics this runtime
exposes at the dashboard's /metrics endpoint — the built-in system series
(rt_node_resource_*, rt_actors) plus one panel per registered user
metric (Counter -> rate graph, Gauge -> graph, Histogram -> p50/p95/p99
quantile graph over _bucket series).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional


def _panel(panel_id: int, title: str, targets: List[Dict], y: int,
           unit: str = "short") -> Dict:
    return {
        "id": panel_id,
        "title": title,
        "type": "timeseries",
        "datasource": {"type": "prometheus", "uid": "${datasource}"},
        "gridPos": {"h": 8, "w": 12, "x": (panel_id % 2) * 12, "y": y},
        "fieldConfig": {"defaults": {"unit": unit}, "overrides": []},
        "targets": [
            {"expr": t["expr"], "legendFormat": t.get("legend", ""),
             "refId": chr(ord("A") + i)}
            for i, t in enumerate(targets)
        ],
    }


_SYSTEM_PANELS = [
    ("Node resources available", [
        {"expr": "rt_node_resource_available",
         "legend": "{{node}} {{resource}}"},
    ]),
    ("Node resources total", [
        {"expr": "rt_node_resource_total", "legend": "{{node}} {{resource}}"},
    ]),
    ("Actors by state", [
        {"expr": "rt_actors", "legend": "{{state}}"},
    ]),
]

# Flight-recorder panel set: the curated training/serving/memory views
# the StepProfiler + memory accountant + serving engine publish. Emitted
# ahead of the generic per-registered-metric panels so a fresh cluster's
# dashboard has the observability story laid out even before any process
# registers the series locally. (name, targets, unit) triples.
_FLIGHT_RECORDER_PANELS = [
    ("Train step wall time p50/p95 by rank", [
        {"expr": "histogram_quantile(0.5, rate("
                 "train_step_wall_seconds_bucket[1m]))",
         "legend": "p50 rank {{rank}}"},
        {"expr": "histogram_quantile(0.95, rate("
                 "train_step_wall_seconds_bucket[1m]))",
         "legend": "p95 rank {{rank}}"},
    ], "s"),
    ("Train step phase breakdown", [
        {"expr": "rate(train_step_phase_seconds_total[1m])",
         "legend": "rank {{rank}} {{phase}}"},
    ], "s"),
    ("Cross-rank step skew (straggler gap)", [
        {"expr": "histogram_quantile(0.95, rate("
                 "train_step_skew_seconds_bucket[1m]))",
         "legend": "p95 skew"},
        {"expr": "train_straggler_rank", "legend": "straggler rank"},
    ], "s"),
    ("Elastic gang size vs reclaimed chips", [
        {"expr": "train_gang_size", "legend": "gang world size"},
        {"expr": "sum(rate(preempt_total[5m])) by (reason)",
         "legend": "preemptions/s {{reason}}"},
        {"expr": "rate(train_resize_total[5m])",
         "legend": "resizes/s {{direction}}"},
    ], "short"),
    ("Training throughput / MFU", [
        {"expr": "train_tokens_per_s", "legend": "rank {{rank}} tok/s"},
        {"expr": "train_step_mfu", "legend": "rank {{rank}} MFU"},
    ], "short"),
    ("Step compiles (retraces)", [
        {"expr": "rate(train_step_compiles_total[5m])",
         "legend": "rank {{rank}}"},
    ], "short"),
    ("Device HBM (live arrays vs allocator)", [
        {"expr": "device_hbm_live_bytes",
         "legend": "{{node}} {{device}} live"},
        {"expr": "device_hbm_in_use_bytes",
         "legend": "{{node}} {{device}} in use"},
        {"expr": "device_hbm_limit_bytes",
         "legend": "{{node}} {{device}} limit"},
    ], "bytes"),
    ("Object store usage by node", [
        {"expr": "rt_raylet_store_used_bytes", "legend": "{{node}}"},
    ], "bytes"),
    ("Data feed stalls", [
        {"expr": "rate(data_feed_stall_seconds_count[1m])",
         "legend": "stalls/s"},
        {"expr": "rate(data_feed_stall_seconds_sum[1m])",
         "legend": "stall seconds/s"},
    ], "short"),
    ("Serving TTFT p50/p95", [
        {"expr": "histogram_quantile(0.5, rate("
                 "serve_llm_ttft_seconds_bucket[1m]))", "legend": "p50"},
        {"expr": "histogram_quantile(0.95, rate("
                 "serve_llm_ttft_seconds_bucket[1m]))", "legend": "p95"},
    ], "s"),
    ("Serving TPOT p50/p95", [
        {"expr": "histogram_quantile(0.5, rate("
                 "serve_llm_tpot_seconds_bucket[1m]))", "legend": "p50"},
        {"expr": "histogram_quantile(0.95, rate("
                 "serve_llm_tpot_seconds_bucket[1m]))", "legend": "p95"},
    ], "s"),
    ("Serving batch occupancy", [
        {"expr": "serve_llm_batch_occupancy", "legend": "occupancy"},
    ], "percentunit"),
    # -- request observatory --------------------------------------------
    ("Serve request e2e p50/p99", [
        {"expr": "histogram_quantile(0.5, rate("
                 "serve_request_e2e_seconds_bucket[1m]))",
         "legend": "{{app}} p50"},
        {"expr": "histogram_quantile(0.99, rate("
                 "serve_request_e2e_seconds_bucket[1m]))",
         "legend": "{{app}} p99"},
    ], "s"),
    ("Serve request phase breakdown", [
        {"expr": "rate(serve_request_phase_seconds_total[1m])",
         "legend": "{{app}} {{phase}}"},
    ], "s"),
    ("Serve per-tenant request rate", [
        {"expr": "rate(serve_requests_total[1m])",
         "legend": "{{app}} {{tenant}}"},
    ], "short"),
    ("Serve SLO burn rate by tenant", [
        {"expr": "serve_slo_burn_rate",
         "legend": "{{app}} {{tenant}} {{slo}}"},
    ], "short"),
    ("Serve head-of-line blocking", [
        {"expr": "rate(serve_hol_blocked_seconds_total[1m])",
         "legend": "blocked slot-seconds/s"},
    ], "s"),
    ("Serve engine admission queue", [
        {"expr": "serve_llm_waiting_requests", "legend": "waiting"},
        {"expr": "histogram_quantile(0.99, rate("
                 "serve_llm_admission_wait_seconds_bucket[1m]))",
         "legend": "admission wait p99"},
    ], "short"),
    # -- serve survival plane -------------------------------------------
    ("Serve shed rate (admission control)", [
        {"expr": "rate(serve_requests_shed_total[1m])",
         "legend": "{{app}} {{tenant}} {{reason}}"},
    ], "short"),
    ("Serve circuit-breaker state (0 closed / 2 open)", [
        {"expr": "serve_circuit_breaker_state",
         "legend": "{{app}} {{replica}}"},
    ], "short"),
    ("Serve drain duration p50/p99", [
        {"expr": "histogram_quantile(0.5, rate("
                 "serve_drain_seconds_bucket[5m]))",
         "legend": "{{app}} p50"},
        {"expr": "histogram_quantile(0.99, rate("
                 "serve_drain_seconds_bucket[5m]))",
         "legend": "{{app}} p99"},
    ], "s"),
    ("Serve deadline expirations by hop", [
        {"expr": "rate(serve_deadline_expired_total[1m])",
         "legend": "{{app}} {{hop}}"},
    ], "short"),
    ("Serve HTTP responses by code", [
        {"expr": "rate(serve_http_responses_total[1m])",
         "legend": "{{app}} {{code}}"},
    ], "short"),
    # -- paged KV cache ---------------------------------------------------
    ("Serve KV page-pool occupancy", [
        {"expr": "serve_kv_pages_in_use", "legend": "pages in use"},
    ], "short"),
    ("Serve prefix-cache hit ratio", [
        {"expr": "rate(serve_prefix_cache_hits_total[1m]) / "
                 "(rate(serve_prefix_cache_hits_total[1m]) + "
                 "rate(serve_prefix_cache_misses_total[1m]))",
         "legend": "hit ratio"},
        {"expr": "rate(serve_prefill_tokens_skipped_total[1m])",
         "legend": "prefill tokens skipped/s"},
    ], "short"),
    ("Serve autoscaler target vs actual replicas", [
        {"expr": "serve_autoscaler_target_replicas",
         "legend": "{{app}} target"},
        {"expr": "serve_autoscaler_actual_replicas",
         "legend": "{{app}} actual"},
    ], "short"),
    # -- control-plane profiler -----------------------------------------
    ("GCS RPC rate by method", [
        {"expr": "rate(gcs_rpc_calls_total[1m])", "legend": "{{method}}"},
    ], "short"),
    ("GCS RPC handler latency p50/p99", [
        {"expr": "histogram_quantile(0.5, rate("
                 "gcs_rpc_server_seconds_bucket[1m]))", "legend": "p50"},
        {"expr": "histogram_quantile(0.99, rate("
                 "gcs_rpc_server_seconds_bucket[1m]))", "legend": "p99"},
    ], "s"),
    ("GCS RPC client-observed latency p50/p99", [
        {"expr": "histogram_quantile(0.5, rate("
                 "gcs_rpc_client_seconds_bucket[1m]))", "legend": "p50"},
        {"expr": "histogram_quantile(0.99, rate("
                 "gcs_rpc_client_seconds_bucket[1m]))", "legend": "p99"},
    ], "s"),
    ("Scheduler queue depth by node", [
        {"expr": "rt_raylet_tasks_queued", "legend": "{{node}}"},
    ], "short"),
    ("Scheduler dispatch scans / passes", [
        {"expr": "rate(rt_raylet_dispatch_scans_total[1m])",
         "legend": "{{node}} scans/s"},
        {"expr": "rate(rt_raylet_dispatch_passes_total[1m])",
         "legend": "{{node}} passes/s"},
    ], "short"),
    ("Scheduler last dispatch batch / scan length", [
        {"expr": "rt_raylet_dispatch_batch_last",
         "legend": "{{node}} batch"},
        {"expr": "rt_raylet_dispatch_scan_last",
         "legend": "{{node}} scan"},
    ], "short"),
    # -- topology-native collectives -------------------------------------
    ("Collective wire bytes by tier/algo", [
        {"expr": "rate(collective_bytes_total[1m])",
         "legend": "{{tier}} {{algo}} {{dtype}}"},
    ], "Bps"),
    ("Collective op latency p50/p95", [
        {"expr": "histogram_quantile(0.5, rate("
                 "collective_op_seconds_bucket[1m]))", "legend": "p50"},
        {"expr": "histogram_quantile(0.95, rate("
                 "collective_op_seconds_bucket[1m]))", "legend": "p95"},
    ], "s"),
    # -- multi-tenancy / preemption ---------------------------------------
    ("Preemptions by tenant/reason", [
        {"expr": "rate(preempt_total[5m])",
         "legend": "{{tenant}} {{reason}}"},
        {"expr": "preempt_active", "legend": "active drains"},
    ], "short"),
    ("Preemption grace (drain-to-release) p50/p99", [
        {"expr": "histogram_quantile(0.5, rate("
                 "preempt_grace_seconds_bucket[5m]))", "legend": "p50"},
        {"expr": "histogram_quantile(0.99, rate("
                 "preempt_grace_seconds_bucket[5m]))", "legend": "p99"},
    ], "s"),
    ("Chip occupancy by tenant", [
        {"expr": "tenant_chip_occupancy", "legend": "{{tenant}}"},
    ], "short"),
    # -- loadgen witness (macro harness) -----------------------------------
    ("Loadgen offered vs achieved QPS", [
        {"expr": "loadgen_offered_qps", "legend": "offered"},
        {"expr": "rate(loadgen_requests_total[1m])",
         "legend": "{{tenant}} {{outcome}}"},
    ], "short"),
    ("Client-observed latency p50/p99 (witness)", [
        {"expr": "histogram_quantile(0.5, rate("
                 "loadgen_client_e2e_seconds_bucket[1m]))", "legend": "p50"},
        {"expr": "histogram_quantile(0.99, rate("
                 "loadgen_client_e2e_seconds_bucket[1m]))", "legend": "p99"},
        {"expr": "histogram_quantile(0.99, rate("
                 "loadgen_client_ttfb_seconds_bucket[1m]))",
         "legend": "ttfb p99"},
    ], "s"),
    ("Unattributed client<->server gap", [
        {"expr": "loadgen_gap_fraction", "legend": "gap fraction {{q}}"},
        {"expr": "loadgen_unattributed_gap_seconds",
         "legend": "gap seconds {{q}}"},
    ], "short"),
    # -- cluster black box (event journal) ---------------------------------
    ("Journal events by kind", [
        {"expr": "rate(journal_events_total[1m])", "legend": "{{kind}}"},
    ], "short"),
    ("Journal ring overwrites (events lost to any future dump)", [
        {"expr": "rate(journal_dropped_total[1m])", "legend": "dropped/s"},
    ], "short"),
]


def generate_dashboard(
    user_metrics: Optional[List[Dict]] = None,
    title: str = "ray_tpu_torch GPU cluster",
) -> Dict:
    """Build the dashboard dict.

    user_metrics: list of Metric.info dicts ({"name", "description",
    "type"}); defaults to every metric registered in this process
    (util/metrics._registry).
    """
    if user_metrics is None:
        from ray_tpu_torch.util import metrics as m

        with m._registry_lock:
            user_metrics = [
                {**metric.info, "type": type(metric).__name__.lower()}
                for metric in m._registry
            ]

    panels: List[Dict] = []
    pid = 1
    y = 0
    for name, targets in _SYSTEM_PANELS:
        panels.append(_panel(pid, name, targets, y))
        pid += 1
        y += 8 * (pid % 2 == 1)

    covered = set()
    for name, targets, unit in _FLIGHT_RECORDER_PANELS:
        panels.append(_panel(pid, name, targets, y, unit=unit))
        pid += 1
        y += 8 * (pid % 2 == 1)
        for t in targets:
            # Track the base series each curated panel queries so the
            # generic per-metric pass below doesn't duplicate it.
            expr = t["expr"]
            for suffix in ("_bucket", "_sum", "_count"):
                expr = expr.replace(suffix, "")
            for token in expr.replace("(", " ").replace(")", " ").replace(
                    "[1m]", " ").replace("[5m]", " ").split():
                if token.startswith(("train_", "serve_", "device_", "data_",
                                     "rt_raylet_", "gcs_rpc_",
                                     "collective_", "preempt_",
                                     "tenant_", "loadgen_", "journal_")):
                    covered.add(token)

    for info in user_metrics:
        name, mtype = info["name"], info["type"]
        if name in covered:
            continue
        if mtype == "counter":
            targets = [{"expr": f"rate({name}[1m])", "legend": name}]
        elif mtype == "gauge":
            targets = [{"expr": name, "legend": name}]
        else:  # histogram
            targets = [
                {"expr": f"histogram_quantile({q}, "
                         f"rate({name}_bucket[1m]))",
                 "legend": f"p{int(q * 100)}"}
                for q in (0.5, 0.95, 0.99)
            ]
        panels.append(
            _panel(pid, info.get("description") or name, targets, y)
        )
        pid += 1
        y += 8 * (pid % 2 == 1)

    return {
        "title": title,
        "uid": "rt-torch-gpu-cluster",
        "schemaVersion": 39,
        "refresh": "10s",
        "time": {"from": "now-1h", "to": "now"},
        "templating": {
            "list": [{
                "name": "datasource",
                "type": "datasource",
                "query": "prometheus",
            }]
        },
        "panels": panels,
    }


def write_dashboard(path: str, **kwargs) -> str:
    """Write the dashboard JSON to `path`; returns the path."""
    with open(path, "w") as f:
        json.dump(generate_dashboard(**kwargs), f, indent=2)
    return path
