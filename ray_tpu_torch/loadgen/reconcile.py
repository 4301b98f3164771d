"""Client <-> server latency reconciliation.

Joins client stamp cards (loadgen.client) against the observatory's
per-request six-phase attribution by rid and computes, per request,

    unattributed_gap = client_e2e - server_attributed

where server_attributed is the sum of the server's phase vector
(which itself telescopes to the server-side e2e by construction, in
serve/observatory.py). The gap is therefore exactly the time the serving stack could
not account for: handle-side routing/dispatch overhead beyond the
stamped hops, response-wire time, long-poll scheduling slack, GIL
stalls in the client. ``gap_fraction = gap / client_e2e`` is the
honest version of the observatory's phase-sum gate: measured from
OUTSIDE, so lost time cannot hide. The macro bench gates p99
gap_fraction at <= 0.05.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from ray_tpu_torch.serve.observatory import percentile

#: The macro gate: at p99, at most 5% of client-observed latency may be
#: unattributed by the server's phase vector.
GAP_FRACTION_LIMIT = 0.05


def collect_server_records(app: str,
                           timeout_s: float = 10.0) -> List[Dict]:
    """Fetch finished-request phase records from every live replica of
    ``app`` (ReplicaActor.observatory_records). Replicas that died
    during the run took their ring with them — their requests show up
    as unmatched cards, which the report surfaces rather than hides."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.serve.controller import CONTROLLER_NAME

    ctrl = rt.get_actor(CONTROLLER_NAME)
    info = rt.get(ctrl.get_replicas.remote(app), timeout=timeout_s)
    refs = [r.observatory_records.remote() for r in info["replicas"]]
    ready, _ = rt.wait(refs, num_returns=len(refs), timeout=timeout_s)
    out: List[Dict] = []
    for ref in refs:
        if ref not in ready:
            continue
        try:
            out.extend(rt.get(ref, timeout=1.0))
        except Exception:  # rtlint: disable=RT007 — a replica dying
            # between wait and get is the chaos scenario itself; its
            # requests are reported as unmatched, not raised.
            pass
    return out


def reconcile(cards: Sequence, server_records: Sequence[Dict],
              gap_limit: float = GAP_FRACTION_LIMIT) -> Dict:
    """The reconciliation report.

    Per matched request: client_e2e, server_attributed (phase sum),
    gap seconds and gap fraction (clamped at >= 0 — a small negative
    gap just means the clocks disagree at sub-ms scale). Summary:
    p50/p99 of both, match/unmatch/error counts, and the pass/fail of
    the p99 gap-fraction gate.
    """
    by_rid = {r["rid"]: r for r in server_records if r.get("rid")}
    rows: List[Dict] = []
    unmatched = 0
    errors = 0
    for card in cards:
        if not card.ok:
            errors += 1
            continue
        rec = by_rid.get(card.rid) if card.rid else None
        if rec is None:
            unmatched += 1
            continue
        client_e2e = card.client_e2e_s
        attributed = sum(rec["phases"].values())
        gap = max(client_e2e - attributed, 0.0)
        rows.append({
            "rid": card.rid,
            "tenant": card.tenant,
            "client_e2e_s": client_e2e,
            "server_attributed_s": attributed,
            "server_e2e_s": rec["e2e_s"],
            "gap_s": gap,
            "gap_fraction": gap / client_e2e if client_e2e > 0 else 0.0,
            "ttfb_s": card.ttfb_s,
            "server_ttft_s": rec.get("ttft_s"),
        })
    gaps = sorted(r["gap_s"] for r in rows)
    fracs = sorted(r["gap_fraction"] for r in rows)
    e2es = sorted(r["client_e2e_s"] for r in rows)
    summary = {
        "matched": len(rows),
        "unmatched": unmatched,
        "errors": errors,
        "gap_s": {"p50": percentile(gaps, 0.50),
                  "p99": percentile(gaps, 0.99)},
        "gap_fraction": {"p50": percentile(fracs, 0.50),
                         "p99": percentile(fracs, 0.99)},
        "client_e2e_s": {"p50": percentile(e2es, 0.50),
                         "p99": percentile(e2es, 0.99)},
        "gap_limit": gap_limit,
        # No matches means nothing was witnessed — that must read as a
        # failure, not a vacuous pass.
        "gate_pass": bool(rows) and percentile(fracs, 0.99) <= gap_limit,
    }
    _emit_metrics(summary)
    return {"summary": summary, "requests": rows}


def _emit_metrics(summary: Dict) -> None:
    """Publish the reconciliation summary as loadgen_* gauges (Grafana's
    witness row). Best-effort: reconciliation must work without a
    metrics plane (offline trace analysis)."""
    try:
        from ray_tpu_torch.util.metrics import Gauge, get_or_create

        get_or_create(
            Gauge, "loadgen_gap_fraction",
            "Unattributed fraction of client-observed latency "
            "(client_e2e - server phase sum) / client_e2e, per quantile",
            tag_keys=("q",),
        ).set(summary["gap_fraction"]["p99"], tags={"q": "p99"})
        get_or_create(
            Gauge, "loadgen_unattributed_gap_seconds",
            "Unattributed client<->server latency gap in seconds, "
            "per quantile", tag_keys=("q",),
        ).set(summary["gap_s"]["p99"], tags={"q": "p99"})
    except Exception:  # rtlint: disable=RT007 — metrics are garnish
        # here; the report dict is the product.
        pass


def render_report(report: Dict) -> str:
    """Human-readable reconciliation report (rt loadgen prints this)."""
    s = report["summary"]
    lines = [
        "client <-> server latency reconciliation",
        f"  matched {s['matched']}  unmatched {s['unmatched']}  "
        f"errors {s['errors']}",
        f"  client e2e    p50 {s['client_e2e_s']['p50'] * 1e3:8.1f} ms   "
        f"p99 {s['client_e2e_s']['p99'] * 1e3:8.1f} ms",
        f"  unattributed  p50 {s['gap_s']['p50'] * 1e3:8.1f} ms   "
        f"p99 {s['gap_s']['p99'] * 1e3:8.1f} ms",
        f"  gap fraction  p50 {s['gap_fraction']['p50']:8.4f}      "
        f"p99 {s['gap_fraction']['p99']:8.4f}",
        f"  gate: p99 gap_fraction <= {s['gap_limit']} -> "
        f"{'PASS' if s['gate_pass'] else 'FAIL'}",
    ]
    return "\n".join(lines)
