"""The `rt` command-line interface of the PyTorch port:
`python -m ray_tpu_torch ...`.

Analog of the reference CLI (python/ray/scripts/scripts.py: `ray start`
:566, `ray stop` :1042, `ray status`, `ray list/summary` via state_cli.py,
`ray timeline`, `ray memory`). Cluster services start as real subprocesses
(the standalone GCS and raylet mains of ray_tpu_torch), tracked through a
session file of the port's own (`$TMPDIR/ray_tpu_torch/session.json`) so
`rt stop` can tear them down. This process loads neither torch nor JAX.

Usage:
    rt start --head [--port 6379] [--num-cpus N] [--num-gpus N]
             [--resources '{...}'] [--object-store-memory BYTES]
    rt start --address HOST:PORT [--num-cpus N] [--num-gpus N]
    rt stop
    rt status [--address HOST:PORT]
    rt list {nodes,tasks,actors,objects,jobs,placement-groups,workers}
    rt summary tasks
    rt timeline [--output FILE]
    rt memory [--devices]
    rt top
    rt job submit|status|logs|list|stop ...
    rt loadgen gen TRACE [--seed N --duration S --qps Q --flash A:B:M ...]
    rt loadgen run TRACE --app APP [--address HOST:PORT] [--out REPORT]
    rt up|down|attach CONFIG
    rt exec [--all-nodes] CONFIG CMD...

`rt start --head` also starts the dashboard (`ray_tpu_torch.dashboard`,
port 8265 unless `--dashboard-port`; `--no-dashboard` to skip it).
`rt up/down/exec/attach` drive the cluster launcher
(`ray_tpu_torch.autoscaler.launcher`) from a `.json` or YAML config.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from typing import Optional

SESSION_FILE = os.path.join(
    os.environ.get("TMPDIR", "/tmp"), "ray_tpu_torch", "session.json"
)


def _read_session() -> Optional[dict]:
    try:
        with open(SESSION_FILE) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def _write_session(data: dict):
    os.makedirs(os.path.dirname(SESSION_FILE), exist_ok=True)
    with open(SESSION_FILE, "w") as f:
        json.dump(data, f)


def _log_dir() -> str:
    from ray_tpu_torch._private.config import session_log_dir

    d = session_log_dir()
    os.makedirs(d, exist_ok=True)
    return d


def _spawn_service(name: str, cmd: list) -> subprocess.Popen:
    """Start a daemon with stdout/stderr to a session log file, NOT
    inherited — inherited pipes keep `rt start | ...` pipelines open
    forever and break user prints once the CLI exits."""
    log = open(os.path.join(_log_dir(), f"{name}-{os.getpid()}.log"), "ab")
    return subprocess.Popen(
        cmd, stdout=log, stderr=subprocess.STDOUT, start_new_session=True
    )


def _wait_for_key(proc: subprocess.Popen, log_path: str, prefix: str,
                  timeout: float = 60.0) -> str:
    """Poll the service's log until its `KEY=value` bootstrap line appears."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            tail = ""
            try:
                with open(log_path) as f:
                    tail = f.read()[-2000:]
            except OSError:
                pass
            raise RuntimeError(
                f"process exited while waiting for {prefix}\n{tail}"
            )
        try:
            with open(log_path) as f:
                for line in f:
                    if line.startswith(prefix):
                        return line.strip().split("=", 1)[1]
        except OSError:
            pass
        time.sleep(0.1)
    raise TimeoutError(f"timed out waiting for {prefix}")


def _resolve_address(args) -> str:
    addr = getattr(args, "address", None)
    if addr:
        return addr
    addr = os.environ.get("RT_GCS_ADDR")
    if addr:
        return addr
    sess = _read_session()
    if sess:
        return sess["gcs_address"]
    sys.exit("error: no running session found; pass --address host:port")


def cmd_start(args):
    logdir = _log_dir()
    if args.head:
        gcs = _spawn_service(
            "gcs",
            [sys.executable, "-m", "ray_tpu_torch._private.gcs", "--port", str(args.port)],
        )
        gcs_log = os.path.join(logdir, f"gcs-{os.getpid()}.log")
        gcs_port = int(_wait_for_key(gcs, gcs_log, "GCS_PORT="))
        raylet_cmd = [
            sys.executable, "-m", "ray_tpu_torch._private.raylet",
            "--gcs-port", str(gcs_port), "--head",
        ]
    else:
        address = _resolve_address(args)
        host, port = address.rsplit(":", 1)
        gcs = None
        gcs_port = int(port)
        raylet_cmd = [
            sys.executable, "-m", "ray_tpu_torch._private.raylet",
            "--gcs-host", host, "--gcs-port", str(gcs_port),
        ]
    if args.num_cpus is not None:
        raylet_cmd += ["--num-cpus", str(args.num_cpus)]
    if args.num_gpus is not None:
        raylet_cmd += ["--num-gpus", str(args.num_gpus)]
    if args.resources:
        raylet_cmd += ["--resources", args.resources]
    if args.object_store_memory:
        raylet_cmd += ["--object-store-memory", str(args.object_store_memory)]
    raylet = _spawn_service("raylet", raylet_cmd)
    raylet_log = os.path.join(logdir, f"raylet-{os.getpid()}.log")
    raylet_port = int(_wait_for_key(raylet, raylet_log, "RAYLET_PORT="))
    node_id = _wait_for_key(raylet, raylet_log, "RAYLET_NODE_ID=")

    gcs_address = f"127.0.0.1:{gcs_port}" if args.head else _resolve_address(args)
    sess = _read_session() if not args.head else None
    pids = (sess or {}).get("pids", [])
    if gcs is not None:
        pids.append(gcs.pid)
    pids.append(raylet.pid)
    dashboard_port = None
    if args.head and not args.no_dashboard:
        dash = _spawn_service(
            "dashboard",
            [sys.executable, "-m", "ray_tpu_torch.dashboard",
             "--address", gcs_address, "--port", str(args.dashboard_port)],
        )
        dash_log = os.path.join(_log_dir(), f"dashboard-{os.getpid()}.log")
        try:
            dashboard_port = int(
                _wait_for_key(dash, dash_log, "DASHBOARD_PORT=", timeout=60)
            )
            pids.append(dash.pid)
        except (RuntimeError, TimeoutError) as e:
            print(f"warning: dashboard failed to start: {e}")
            try:
                dash.kill()
            except OSError:
                pass
    if sess and dashboard_port is None:
        dashboard_port = sess.get("dashboard_port")
    _write_session(
        {"gcs_address": gcs_address, "pids": pids, "raylet_port": raylet_port,
         "dashboard_port": dashboard_port}
    )
    print(f"started node {node_id[:12]} (raylet port {raylet_port})")
    print(f"GCS address: {gcs_address}")
    if dashboard_port:
        print(f"dashboard: http://127.0.0.1:{dashboard_port}")
    print(f'connect with:  ray_tpu_torch.init(address="{gcs_address}")')
    if args.block:
        try:
            raylet.wait()
        except KeyboardInterrupt:
            pass


def cmd_stop(args):
    sess = _read_session()
    if not sess:
        print("no running session")
        return
    for pid in reversed(sess.get("pids", [])):
        try:
            os.kill(pid, signal.SIGTERM)
            print(f"stopped pid {pid}")
        except ProcessLookupError:
            pass
    deadline = time.monotonic() + 5
    for pid in sess.get("pids", []):
        while time.monotonic() < deadline:
            try:
                os.kill(pid, 0)
                time.sleep(0.1)
            except ProcessLookupError:
                break
        else:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    try:
        os.unlink(SESSION_FILE)
    except OSError:
        pass


def cmd_status(args):
    from ray_tpu_torch.util.state import list_nodes

    nodes = list_nodes(address=_resolve_address(args))
    alive = [n for n in nodes if n["state"] == "ALIVE"]
    print(f"{len(alive)}/{len(nodes)} nodes alive")
    totals: dict = {}
    avail: dict = {}
    for n in alive:
        for k, v in n["resources_total"].items():
            totals[k] = totals.get(k, 0) + v
        for k, v in n["resources_available"].items():
            avail[k] = avail.get(k, 0) + v
    print("resources:")
    for k in sorted(totals):
        print(f"  {avail.get(k, 0):g}/{totals[k]:g} {k}")
    for n in nodes:
        head = " (head)" if n.get("is_head") else ""
        print(f"  node {n['node_id'][:12]} {n['state']}{head} @ {n['address']}")


def cmd_list(args):
    from ray_tpu_torch.util import state as state_api

    fns = {
        "nodes": state_api.list_nodes,
        "tasks": state_api.list_tasks,
        "actors": state_api.list_actors,
        "objects": state_api.list_objects,
        "jobs": state_api.list_jobs,
        "placement-groups": state_api.list_placement_groups,
        "workers": state_api.list_workers,
    }
    rows = fns[args.entity](address=_resolve_address(args))
    print(json.dumps(rows, indent=2, default=str))


def cmd_summary(args):
    from ray_tpu_torch.util.state import summarize_tasks

    print(json.dumps(summarize_tasks(address=_resolve_address(args)), indent=2))


def cmd_timeline(args):
    if getattr(args, "cluster", False):
        return _timeline_cluster(args)
    from ray_tpu_torch.util.state import get_timeline

    trace = get_timeline(
        address=_resolve_address(args),
        lifecycle=getattr(args, "lifecycle", False),
    )
    out = args.output or f"timeline-{int(time.time())}.json"
    with open(out, "w") as f:
        json.dump(trace, f)
    print(f"wrote {len(trace)} events to {out} (open in chrome://tracing)")


def _wait_bundle(bundle: str, settle_s: float = 0.4,
                 timeout_s: float = 5.0) -> None:
    """Wait for a postmortem bundle to stop growing: processes dump on
    the pubsub push asynchronously, so the CLI polls until the file
    count holds still for `settle_s` (or gives up at `timeout_s`)."""
    deadline = time.monotonic() + timeout_s
    last_n, last_change = -1, time.monotonic()
    while time.monotonic() < deadline:
        try:
            n = len([f for f in os.listdir(bundle) if f.endswith(".jsonl")])
        except OSError:
            n = 0
        if n != last_n:
            last_n, last_change = n, time.monotonic()
        elif n > 0 and time.monotonic() - last_change >= settle_s:
            return
        time.sleep(0.1)


def _timeline_cluster(args):
    """Live merged spine: force a cluster-wide journal dump and render
    the assembled HLC-ordered timeline."""
    from ray_tpu_torch.util import journal
    from ray_tpu_torch.util.state.api import StateApiClient

    client = StateApiClient(_resolve_address(args))
    try:
        resp = client.call("journal_trigger", {
            "reason": "manual", "source": "rt timeline", "force": True,
        })
    finally:
        client.close()
    bundle = resp.get("bundle")
    if not bundle:
        print("journal trigger suppressed (journal disabled?)",
              file=sys.stderr)
        sys.exit(1)
    _wait_bundle(bundle)
    events, metas = journal.load_bundle(bundle)
    print(f"cluster spine: {len(events)} events from {len(metas)} "
          f"process(es) — bundle {bundle}")
    print(journal.render_timeline(events, limit=args.limit))


def cmd_postmortem(args):
    """Assemble a postmortem bundle into one causally-ordered timeline
    and name the culprit chain."""
    from ray_tpu_torch.util import journal

    bundle = args.bundle
    if bundle in (None, "latest"):
        bundle = _latest_bundle(args)
        if bundle is None:
            print("no postmortem bundles found (none triggered yet, or "
                  f"look under {journal.dump_dir()})", file=sys.stderr)
            sys.exit(1)
    if not os.path.isdir(bundle):
        print(f"not a bundle directory: {bundle}", file=sys.stderr)
        sys.exit(1)
    events, metas = journal.load_bundle(bundle)
    if not events:
        print(f"bundle {bundle} holds no events", file=sys.stderr)
        sys.exit(1)
    procs = sorted({f"{m.get('proc', '?')}({m.get('pid', '?')})"
                    for m in metas})
    trigger = next((m.get("trigger") for m in metas
                    if m.get("trigger")), None) or {}
    print(f"postmortem {os.path.basename(bundle)} — {len(events)} events "
          f"from {len(metas)} process(es): {', '.join(procs)}")
    if trigger:
        print(f"trigger: {trigger.get('reason', '?')} "
              f"(source: {trigger.get('source') or 'auto'})")
    chain = journal.causal_chain(events)
    if chain:
        print("\nculprit chain:")
        t0 = chain[0].get("ts", 0.0)
        for i, e in enumerate(chain):
            arrow = "   " if i == 0 else " → "
            print(f" {arrow}{journal._fmt_event(e, t0)}")
    else:
        print("\nno causal chain found (no seed fault in the window)")
    if not args.chain_only:
        print("\nmerged timeline:")
        print(journal.render_timeline(events, limit=args.limit))


def _latest_bundle(args) -> Optional[str]:
    """Newest bundle: ask the GCS first (it minted them), fall back to
    scanning the dump directory (offline postmortems)."""
    from ray_tpu_torch.util import journal

    try:
        from ray_tpu_torch.util.state.api import StateApiClient

        client = StateApiClient(_resolve_address(args))
        try:
            pms = client.call("get_postmortems", {}).get("postmortems", [])
        finally:
            client.close()
        if pms:
            return pms[-1]["bundle"]
    except Exception:  # noqa: BLE001 — no live cluster; scan the dir
        pass
    root = journal.dump_dir()
    try:
        cands = [os.path.join(root, d) for d in os.listdir(root)
                 if os.path.isdir(os.path.join(root, d))]
    except OSError:
        return None
    return max(cands, key=os.path.getmtime) if cands else None


def cmd_profile(args):
    """Flip cluster-wide lifecycle sampling / show the phase breakdown."""
    from ray_tpu_torch.util import lifecycle
    from ray_tpu_torch.util.state.api import StateApiClient

    client = StateApiClient(_resolve_address(args))
    try:
        if args.on or args.off:
            rate = 0.0 if args.off else (
                args.rate if args.rate is not None else 1.0
            )
            client.call("set_profile_config", {"task_trace_sample": rate})
            state = "off" if rate == 0.0 else f"on (rate {rate:g})"
            print(f"task lifecycle sampling: {state} — applies to every "
                  "connected driver and worker")
            return
        if args.profile_command != "tasks":
            print("usage: rt profile [--on [--rate R] | --off | tasks]",
                  file=sys.stderr)
            sys.exit(2)
        records = lifecycle.stitch(client.task_events())
        if not records:
            print("no sampled lifecycle spans; enable with `rt profile --on"
                  " [--rate R]` or RT_TASK_TRACE_SAMPLE=R")
            return
        agg = lifecycle.aggregate(records)
        cov = agg.pop("coverage", None)
        e2e = agg.pop("e2e", None)
        print(f"{len(records)} sampled tasks — per-phase latency (µs)")
        print(f"  {'phase':<14}{'count':>8}{'mean':>12}{'p50':>12}{'p99':>12}")
        for phase, row in agg.items():
            print(f"  {phase:<14}{row['count']:>8}{row['mean_us']:>12.1f}"
                  f"{row['p50_us']:>12.1f}{row['p99_us']:>12.1f}")
        if e2e:
            print(f"  {'e2e':<14}{e2e['count']:>8}{e2e['mean_us']:>12.1f}"
                  f"{e2e['p50_us']:>12.1f}{e2e['p99_us']:>12.1f}")
        if cov:
            print(f"  phase coverage of e2e wall: mean "
                  f"{100 * cov['mean_us']:.1f}%  p50 {100 * cov['p50_us']:.1f}%")
    finally:
        client.close()


def _hist_percentile(buckets, bounds, q):
    """Upper-bound percentile estimate from cumulative histogram buckets."""
    total = sum(buckets)
    if not total:
        return 0.0
    target = q * total
    cum = 0
    for i, n in enumerate(buckets):
        cum += n
        if cum >= target:
            return bounds[i] if i < len(bounds) else bounds[-1]
    return bounds[-1]


def cmd_rpc(args):
    """Per-method GCS RPC accounting (server-side handler latency)."""
    from ray_tpu_torch.util.state.api import StateApiClient

    client = StateApiClient(_resolve_address(args))
    try:
        stats = client.call("gcs_stats")
    finally:
        client.close()
    lat = stats.get("rpc_latency") or {}
    bounds = stats.get("rpc_latency_boundaries") or []
    if not lat:
        print("no GCS RPCs recorded yet")
        return
    rows = sorted(lat.items(), key=lambda kv: -kv[1].get("sum_s", 0.0))
    total_calls = sum(st.get("count", 0) for _, st in rows)
    total_s = sum(st.get("sum_s", 0.0) for _, st in rows)
    print(f"GCS RPCs: {total_calls} calls, {total_s * 1e3:.1f} ms handler "
          "time — by method, busiest first")
    print(f"  {'method':<24}{'calls':>9}{'total_ms':>11}{'mean_us':>10}"
          f"{'p50_us':>9}{'p99_us':>9}{'max_ms':>9}")
    for method, st in rows:
        n = st.get("count", 0) or 1
        bkts = st.get("buckets") or []
        print(f"  {method:<24}{st.get('count', 0):>9}"
              f"{st.get('sum_s', 0.0) * 1e3:>11.1f}"
              f"{st.get('sum_s', 0.0) / n * 1e6:>10.1f}"
              f"{_hist_percentile(bkts, bounds, 0.5) * 1e6:>9.0f}"
              f"{_hist_percentile(bkts, bounds, 0.99) * 1e6:>9.0f}"
              f"{st.get('max_s', 0.0) * 1e3:>9.2f}")


def cmd_trace(args):
    """Print one trace's span tree (TRACE_SPAN events, parent-linked)."""
    from ray_tpu_torch.util import tracing

    spans = tracing.get_trace(args.trace_id, address=_resolve_address(args))
    if not spans:
        print(f"no finished spans for trace {args.trace_id}")
        return
    by_id = {s["span_id"]: s for s in spans}
    children: dict = {}
    roots = []
    for s in spans:
        pid = s.get("parent_id") or ""
        if pid and pid in by_id:
            children.setdefault(pid, []).append(s)
        else:
            roots.append(s)

    def emit(s, depth):
        print(f"  {'  ' * depth}{s['name'] or '<unnamed>'}  "
              f"[{s['kind']}]  {s['dur_s'] * 1e3:.2f} ms")
        for c in children.get(s["span_id"], []):
            emit(c, depth + 1)

    print(f"trace {args.trace_id}: {len(spans)} spans")
    for r in roots:
        emit(r, 0)


def cmd_memory(args):
    from ray_tpu_torch.util.state import list_objects

    if getattr(args, "devices", False):
        # Unified card-memory + object-store view from the accountant.
        from ray_tpu_torch.util.memory import memory_summary

        s = memory_summary(address=_resolve_address(args))
        print(f"HBM (live torch tensors): {s['hbm_live_bytes'] / 1e6:.1f} MB "
              f"across {len(s['devices'])} sampled device(s)")
        for d in s["devices"]:
            extra = ""
            if "bytes_in_use" in d:
                extra = f"  in_use {d['bytes_in_use'] / 1e6:.1f} MB"
                if "bytes_limit" in d and d["bytes_limit"]:
                    extra += (f" / limit {d['bytes_limit'] / 1e6:.1f} MB"
                              f" ({100 * d['bytes_in_use'] / d['bytes_limit']:.0f}%)")
            print(f"  node {d['node']} {d['device']}: "
                  f"{d.get('live_bytes', 0) / 1e6:>9.1f} MB live "
                  f"({d.get('live_arrays', 0)} arrays){extra}")
        st = s["object_store"]
        print(f"object store: {st['used_bytes'] / 1e6:.1f} MB, "
              f"{st['num_objects']} objects "
              f"({s['objects']['count']} in object table, "
              f"{s['objects']['bytes'] / 1e6:.1f} MB primary copies)")
        for node, v in sorted(st["per_node"].items()):
            print(f"  node {node}: {v.get('used_bytes', 0) / 1e6:>9.1f} MB, "
                  f"{v.get('num_objects', 0)} objects")
        return

    objs = list_objects(address=_resolve_address(args))
    total = sum(o["size"] for o in objs)
    print(f"{len(objs)} objects, {total / 1e6:.1f} MB total")
    for o in sorted(objs, key=lambda o: -o["size"])[:50]:
        locs = ",".join(loc[:8] for loc in o["locations"])
        print(f"  {o['object_id'][:16]}  {o['size']:>12} B  on [{locs}]")


def _series_by_tags(snapshot, name):
    """[(tags_dict, value)] for one metric from a metrics_snapshot reply."""
    for m in snapshot:
        if m["name"] == name:
            return [(dict(tuple(t) for t in tags), val)
                    for tags, val in m["series"]]
    return []


def _hist_total(snapshot, name):
    """(count, sum) over every tag set of a histogram metric."""
    count, total = 0, 0.0
    for _, st in _series_by_tags(snapshot, name):
        if isinstance(st, dict):
            count += st.get("count", 0)
            total += st.get("sum", 0.0)
    return count, total


def _render_top(snapshot, nodes) -> str:
    """One frame of the `rt top` live cluster view, assembled purely from
    the GCS metrics snapshot + node table (no per-node dials)."""
    lines = []
    alive = [n for n in nodes if n["state"] == "ALIVE"]
    lines.append(f"rt top — {len(alive)}/{len(nodes)} nodes alive")

    # -- training: per-rank step wall + skew/straggler -------------------
    per_rank = {}
    for tags, st in _series_by_tags(snapshot, "train_step_wall_seconds"):
        if isinstance(st, dict) and st.get("count"):
            per_rank[tags.get("rank", "-")] = st
    if per_rank:
        lines.append("train:")
        phases = {}
        for tags, v in _series_by_tags(snapshot,
                                       "train_step_phase_seconds_total"):
            phases.setdefault(tags.get("rank", "-"), {})[
                tags.get("phase", "?")] = v
        compiles = {t.get("rank", "-"): v for t, v in
                    _series_by_tags(snapshot, "train_step_compiles_total")}
        tput = {t.get("rank", "-"): v for t, v in
                _series_by_tags(snapshot, "train_tokens_per_s")}
        means = {}
        for rank in sorted(per_rank):
            st = per_rank[rank]
            mean_ms = st["sum"] / st["count"] * 1e3
            means[rank] = mean_ms
            ph = phases.get(rank, {})
            ph_total = sum(ph.values()) or 1.0
            ph_str = " ".join(
                f"{k} {100 * v / ph_total:.0f}%"
                for k, v in sorted(ph.items(), key=lambda kv: -kv[1])
            )
            extra = ""
            if rank in tput:
                extra += f"  {tput[rank]:,.0f} tok/s"
            if compiles.get(rank):
                extra += f"  compiles={compiles[rank]:.0f}"
            lines.append(f"  rank {rank}: {st['count']} steps, "
                         f"{mean_ms:.1f} ms/step  [{ph_str}]{extra}")
        if len(means) >= 2:
            slowest = max(means, key=means.get)
            skew_ms = means[slowest] - min(means.values())
            lines.append(f"  skew: {skew_ms:.1f} ms/step — slowest rank "
                         f"{slowest} (straggler)")
    sk_count, sk_sum = _hist_total(snapshot, "train_step_skew_seconds")
    if sk_count:
        lines.append(f"  skew metric: {sk_sum / sk_count * 1e3:.1f} ms avg "
                     f"over {sk_count} polls")

    # -- memory: HBM gauges + per-node object store ----------------------
    hbm = _series_by_tags(snapshot, "device_hbm_live_bytes")
    store = _series_by_tags(snapshot, "rt_raylet_store_used_bytes")
    if hbm or store:
        lines.append("memory:")
        for tags, v in sorted(hbm, key=lambda x: (x[0].get("node", ""),
                                                  x[0].get("device", ""))):
            lines.append(f"  hbm {tags.get('node', '-')} "
                         f"{tags.get('device', '?')}: {v / 1e6:.1f} MB live")
        for tags, v in sorted(store, key=lambda x: x[0].get("node", "")):
            lines.append(f"  store {tags.get('node', '-')}: "
                         f"{v / 1e6:.1f} MB")

    # -- data feed -------------------------------------------------------
    st_count, st_sum = _hist_total(snapshot, "data_feed_stall_seconds")
    batches = sum(v for _, v in
                  _series_by_tags(snapshot, "data_feed_batches_total"))
    if batches or st_count:
        lines.append(f"data feed: {batches:.0f} batches, {st_count} stalls "
                     f"({st_sum * 1e3:.1f} ms waiting)")

    # -- serving ---------------------------------------------------------
    occ = _series_by_tags(snapshot, "serve_llm_batch_occupancy")
    ttft_c, ttft_s = _hist_total(snapshot, "serve_llm_ttft_seconds")
    tpot_c, tpot_s = _hist_total(snapshot, "serve_llm_tpot_seconds")
    req = _series_by_tags(snapshot, "serve_requests_total")
    if occ or ttft_c or req:
        lines.append("serve:")
        if occ:
            lines.append(f"  batch occupancy: "
                         f"{100 * sum(v for _, v in occ) / len(occ):.0f}%")
        waiting = _series_by_tags(snapshot, "serve_llm_waiting_requests")
        if waiting:
            lines.append(f"  waiting: "
                         f"{sum(v for _, v in waiting):.0f} queued")
        if ttft_c:
            lines.append(f"  ttft: {ttft_s / ttft_c * 1e3:.1f} ms avg "
                         f"({ttft_c} requests)")
        if tpot_c:
            lines.append(f"  tpot: {tpot_s / tpot_c * 1e3:.2f} ms/token avg")
        # Observatory phase attribution: where request wall-time goes.
        phases = _series_by_tags(snapshot,
                                 "serve_request_phase_seconds_total")
        if phases:
            total = sum(v for _, v in phases) or 1.0
            top = sorted(phases, key=lambda x: -x[1])[:4]
            lines.append("  phases: " + " ".join(
                f"{t.get('phase', '?')}={100 * v / total:.0f}%"
                for t, v in top
            ))
        hol = sum(v for _, v in _series_by_tags(
            snapshot, "serve_hol_blocked_seconds_total"))
        if hol:
            lines.append(f"  hol blocked: {hol:.3f} slot-seconds")
        if req:
            by_tenant: dict = {}
            for t, v in req:
                key = t.get("tenant", "-")
                by_tenant[key] = by_tenant.get(key, 0) + v
            lines.append("  tenants: " + " ".join(
                f"{k}={v:.0f}" for k, v in sorted(by_tenant.items())
            ))

    # -- preemption / multi-tenancy --------------------------------------
    pre = _series_by_tags(snapshot, "preempt_total")
    active = sum(v for _, v in _series_by_tags(snapshot, "preempt_active"))
    chips = _series_by_tags(snapshot, "tenant_chip_occupancy")
    if pre or active or chips:
        lines.append("preemptions:")
        if active:
            lines.append(f"  active: {active:.0f} draining")
        by_victim: dict = {}
        for t, v in pre:
            key = (t.get("tenant", "-"), t.get("reason", "-"))
            by_victim[key] = by_victim.get(key, 0) + v
        for (tenant, reason), v in sorted(by_victim.items()):
            lines.append(f"  evicted {tenant}: {v:.0f} ({reason})")
        g_count, g_sum = _hist_total(snapshot, "preempt_grace_seconds")
        if g_count:
            lines.append(f"  grace: {g_sum / g_count:.2f} s avg to release "
                         f"({g_count} evictions)")
        if chips:
            lines.append("  chips: " + " ".join(
                f"{t.get('tenant', '-')}={v:.0f}"
                for t, v in sorted(chips, key=lambda x: -x[1])
            ))
    return "\n".join(lines)


def cmd_top(args):
    """Live cluster view: per-rank step times + skew, HBM/object-store
    memory, feed stalls, serving occupancy/latency — everything the
    flight recorder publishes, one screen."""
    from ray_tpu_torch.util.state.api import StateApiClient

    address = _resolve_address(args)
    while True:
        client = StateApiClient(address)
        try:
            snapshot = client.call("metrics_snapshot")["metrics"]
            nodes = client.nodes()
        finally:
            client.close()
        print(_render_top(snapshot, nodes))
        if not args.watch:
            return
        time.sleep(args.interval)
        print()


def cmd_drain(args):
    """Graceful drain (reference: `ray drain-node`): cordon -> wait for
    running work to finish -> remove from the cluster."""
    from ray_tpu_torch.util.state import drain_node

    r = drain_node(args.node_id, timeout=args.timeout, undo=args.undo,
                   address=_resolve_address(args))
    if args.undo:
        if r.get("ok"):
            print("cordon lifted")
            return
        print(f"failed: {r.get('error')}")
        raise SystemExit(1)
    if r.get("ok"):
        print(f"node {args.node_id[:12]} drained and removed")
    else:
        print(f"drain failed: {r.get('error')}")
        raise SystemExit(1)


def cmd_logs(args):
    """List session log files, or tail one (reference: `ray logs`)."""
    from ray_tpu_torch.util.state import get_log, list_logs

    addr = _resolve_address(args)
    if not args.filename:
        for e in list_logs(node_id=args.node, address=addr):
            if "error" in e:
                print(f"{e['node_id'][:12]}  <error: {e['error']}>")
            else:
                print(f"{e['node_id'][:12]}  {e['size']:>10}  {e['name']}")
        return
    print(get_log(args.filename, node_id=args.node,
                  tail_bytes=args.tail, address=addr), end="")


def cmd_stack(args):
    """Live thread stacks of every worker (reference: dashboard py-spy
    on-demand dumps)."""
    from ray_tpu_torch.util.state import get_worker_stacks

    for w in get_worker_stacks(address=_resolve_address(args)):
        if "error" in w:
            print(f"== worker {w.get('worker_id', '?')}: {w['error']}")
            continue
        kind = "actor" if w.get("actor") else "worker"
        print(f"== {kind} pid={w['pid']} node={w['node_id'][:8]}")
        for t in w["threads"]:
            print(f"-- thread {t['thread']}")
            print(t["stack"], end="")


def cmd_job(args):
    from ray_tpu_torch.job import job_cli

    job_cli(args, _resolve_address(args))


def _fetch_serve_signals(address=None):
    """Read the controller-published ServeSignals doc off the GCS KV.

    No actors are dialed — one kv_get against the GCS (the controller
    republishes each serve_signals_interval_s), so this works from any
    machine that can reach the head. None when nothing is published."""
    import json as _json

    from ray_tpu_torch.serve.observatory import SIGNALS_KEY
    from ray_tpu_torch.util.state.api import StateApiClient

    client = StateApiClient(address)
    try:
        raw = client.call(
            "kv_get", {"key": SIGNALS_KEY, "ns": "serve"}
        ).get("value")
    finally:
        client.close()
    if not raw:
        return None
    return _json.loads(raw)


def _render_serve(doc) -> str:
    """ServeSignals -> the `rt serve` table (deployments, replicas,
    latency, phase breakdown, HOL, per-tenant SLO burn)."""
    if not doc or not doc.get("apps"):
        return "no serve signals published (is a serve app running?)"
    age = time.time() - doc.get("ts", 0.0)
    lines = [f"serve signals  seq={doc.get('seq')}  age={age:.1f}s"]
    for name, app in sorted(doc["apps"].items()):
        occ = app.get("occupancy")
        drain = app.get("backlog_drain_s")
        frac = app.get("phase_sum_fraction")
        # Schema v2 fields — absent in docs from older controllers.
        tgt = app.get("target_replicas")
        run = app.get("running_replicas")
        lines.append(
            f"app {name}: qps={app.get('qps', 0.0):.2f} "
            f"waiting={app.get('waiting', 0)}"
            + (f" replicas={run}/{tgt}" if tgt is not None else "")
            + (f" occupancy={100 * occ:.0f}%" if occ is not None else "")
            + (f" backlog_drain={drain:.2f}s" if drain is not None else "")
            + (f" phase_sum={100 * frac:.1f}%" if frac is not None else "")
        )
        kv = app.get("kv")
        if kv:
            hr = kv.get("prefix_hit_rate")
            lines.append(
                f"  kv: pages {kv.get('pages_in_use', 0)}"
                f"/{kv.get('pages_total', 0)}"
                + (f" ({100 * kv['util']:.0f}%)"
                   if kv.get("util") is not None else "")
                + (f" prefix_hit={100 * hr:.0f}%" if hr is not None else "")
                + (f" prefill_skipped={kv['prefill_tokens_skipped']}"
                   if kv.get("prefill_tokens_skipped") else "")
            )
        for r in app.get("replicas") or []:
            status = ("UNREACHABLE" if r.get("unreachable")
                      else f"ongoing={r.get('ongoing')} "
                           f"served={r.get('total_served')}")
            hf = r.get("health_fails", 0)
            ku = r.get("kv_util")
            lines.append(
                f"  replica {r.get('actor_id', '?')[:8]}: {status}"
                + (f" kv={100 * ku:.0f}%" if ku is not None else "")
                + (f" health_fails={hf}" if hf else "")
            )
        ttft, tpot = app.get("ttft_s") or {}, app.get("tpot_s") or {}
        if ttft.get("n"):
            lines.append(
                f"  ttft p50={ttft['p50'] * 1e3:.1f}ms "
                f"p99={ttft['p99'] * 1e3:.1f}ms (n={ttft['n']})  "
                f"tpot p50={tpot.get('p50', 0) * 1e3:.2f}ms "
                f"p99={tpot.get('p99', 0) * 1e3:.2f}ms"
            )
        phases = app.get("phases") or {}
        if phases:
            total = sum(p["sum_s"] for p in phases.values()) or 1.0
            parts = [
                f"{ph}={100 * p['sum_s'] / total:.0f}%"
                for ph, p in sorted(
                    phases.items(), key=lambda kv: -kv[1]["sum_s"]
                )
            ]
            lines.append("  phases: " + " ".join(parts))
        hol = app.get("hol") or {}
        if hol.get("blocked_slot_seconds"):
            lines.append(
                f"  hol: {hol['blocked_slot_seconds']:.3f} "
                f"slot-seconds blocked"
            )
            for ev in (hol.get("events") or [])[-3:]:
                culprits = ", ".join(
                    f"req {c['request_id']} ({c['prompt_tokens']} tok)"
                    for c in ev.get("culprits") or []
                ) or "unknown"
                lines.append(
                    f"    {ev['prefill_s'] * 1e3:.0f}ms prefill stalled "
                    f"{ev['victims']} slot(s) — {culprits}"
                )
        for tname, t in sorted((app.get("tenants") or {}).items()):
            burns = []
            for w, kinds in sorted(t.get("slo_windows", {}).items(),
                                   key=lambda kv: int(kv[0])):
                for kind, row in sorted(kinds.items()):
                    burns.append(
                        f"{kind}@{w}s={row['burn']:.2f}"
                        f"({row['total'] - row['good']}/{row['total']})"
                    )
            lines.append(
                f"  tenant {tname}: req={t.get('requests', 0)} "
                f"tokens={t.get('tokens_in', 0)}/{t.get('tokens_out', 0)}"
                + ("  burn " + " ".join(burns) if burns else "")
            )
    return "\n".join(lines)


def cmd_serve(args):
    """`rt serve [signals]`: live ServeSignals table straight off the
    GCS KV (per-deployment QPS/occupancy/latency, per-tenant SLO burn,
    HOL events). `rt serve deploy <config>`: declarative deploys
    (reference: `serve deploy`, serve/scripts.py:256)."""
    cmdname = args.serve_command or "signals"
    if cmdname == "signals":
        # Read-only path: one GCS kv_get, no rt.init / actor dials.
        address = _resolve_address(args)
        if not getattr(args, "watch", False):
            print(_render_serve(_fetch_serve_signals(address)))
            return
        try:
            while True:
                out = _render_serve(_fetch_serve_signals(address))
                print("\x1b[2J\x1b[H" + out, flush=True)
                time.sleep(args.interval)
        except KeyboardInterrupt:
            return
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve

    rt.init(address=_resolve_address(args), num_cpus=0,
            ignore_reinit_error=True)
    if cmdname == "deploy":
        if not args.config:
            raise SystemExit("rt serve deploy requires a config file path")
        handles = serve.run_from_config(args.config)
        print(f"deployed: {', '.join(handles) or '(nothing)'}")
    elif cmdname == "status":
        import json as _json

        print(_json.dumps(serve.status(), indent=2, default=str))
    elif cmdname == "shutdown":
        serve.shutdown()
        print("serve shut down")


def cmd_loadgen(args):
    """`rt loadgen gen <trace>`: write a seeded-deterministic traffic
    trace (offline — no cluster). `rt loadgen run <trace> --app X`:
    replay it against a deployed serve app and print the
    client<->server latency reconciliation report."""
    from ray_tpu_torch.loadgen import trace as trace_mod
    from ray_tpu_torch.loadgen import workload

    if args.loadgen_command == "gen":
        flash = []
        for f in args.flash:
            parts = f.split(":")
            if len(parts) != 3:
                raise SystemExit(
                    f"--flash wants START:DUR:MULT, got {f!r}")
            flash.append(tuple(float(x) for x in parts))
        curve = workload.RateCurve(
            base_qps=args.qps, ramp_to_qps=args.ramp_to,
            ramp_s=args.ramp_s,
            diurnal_amplitude=args.diurnal_amplitude,
            diurnal_period_s=args.diurnal_period, flash=flash,
        )
        spec = trace_mod.TraceSpec(
            seed=args.seed, duration_s=args.duration, curve=curve,
            kind="closed" if args.closed else "open",
            process=args.process, pareto_alpha=args.pareto_alpha,
            concurrency=args.concurrency, num_requests=args.requests,
            mean_think_s=args.think,
        )
        header, records = trace_mod.generate(spec)
        trace_mod.write(args.trace, header, records)
        print(f"wrote {len(records)} requests to {args.trace} "
              f"({header['kind']} loop, seed {header['seed']})")
        return
    # run
    if not args.app:
        raise SystemExit("rt loadgen run requires --app")
    import ray_tpu_torch as rt
    from ray_tpu_torch import loadgen

    header, records = trace_mod.read(args.trace)
    rt.init(address=_resolve_address(args), num_cpus=0,
            ignore_reinit_error=True)
    call = loadgen.serve_call_fn(args.app, stream=not args.unary)
    result = loadgen.run_trace(header, records, call,
                               workers=args.workers)
    server = loadgen.collect_server_records(args.app)
    report = loadgen.reconcile(result.cards, server)
    summary = result.summary()
    print(json.dumps(summary, indent=2))
    print(loadgen.render_report(report))
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump({"run": summary, "reconciliation": report}, f,
                      indent=2)
        print(f"report written to {args.out}")
    if not report["summary"]["gate_pass"]:
        raise SystemExit(1)


def cmd_config(args):
    """List the runtime config registry (the ray_config_def.h analog):
    every knob, its current value, and the RT_* env var that tunes it."""
    from dataclasses import fields

    from ray_tpu_torch._private.config import Config, get_config

    cfg = get_config()
    rows = []
    for f in fields(Config):
        cur = getattr(cfg, f.name)
        default = f.default
        rows.append((f.name, cur, default))
    width = max(len(r[0]) for r in rows)
    for name, cur, default in sorted(rows):
        marker = " *" if cur != default else ""
        print(f"RT_{name.upper():<{width}}  {cur!r}{marker}")
    print(f"\n{len(rows)} knobs; * = overridden from default")


def cmd_up(args):
    """`rt up cluster.json` (reference: scripts.py:566 up)."""
    from ray_tpu_torch.autoscaler.launcher import ClusterLauncher

    ClusterLauncher.from_yaml(args.config).up()


def cmd_down(args):
    from ray_tpu_torch.autoscaler.launcher import ClusterLauncher

    ClusterLauncher.from_yaml(args.config).down()


def cmd_exec(args):
    from ray_tpu_torch.autoscaler.launcher import ClusterLauncher

    launcher = ClusterLauncher.from_yaml(args.config)
    for out in launcher.exec(" ".join(args.cmd), all_nodes=args.all_nodes):
        print(out, end="")


def cmd_attach(args):
    """Exec into an interactive shell on the head node."""
    from ray_tpu_torch.autoscaler.launcher import ClusterLauncher

    cmd = ClusterLauncher.from_yaml(args.config).attach_command()
    os.execvp("/bin/sh", ["/bin/sh", "-c", cmd])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rt", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("start", help="start cluster services on this host")
    sp.add_argument("--head", action="store_true")
    sp.add_argument("--address", help="existing GCS address (worker nodes)")
    sp.add_argument("--port", type=int, default=0, help="GCS port (head)")
    sp.add_argument("--num-cpus", type=float, default=None)
    sp.add_argument("--num-gpus", type=float, default=None,
                    help="GPU count (default: detected)")
    sp.add_argument("--resources", help="JSON resource map")
    sp.add_argument("--object-store-memory", type=int)
    sp.add_argument("--block", action="store_true")
    sp.add_argument("--no-dashboard", action="store_true")
    sp.add_argument("--dashboard-port", type=int, default=8265)
    sp.set_defaults(fn=cmd_start)

    sp = sub.add_parser("stop", help="stop services started by `rt start`")
    sp.set_defaults(fn=cmd_stop)

    sp = sub.add_parser("config", help="list runtime config knobs")
    sp.set_defaults(fn=cmd_config)

    sp = sub.add_parser("up", help="launch a cluster from a YAML config")
    sp.add_argument("config")
    sp.set_defaults(fn=cmd_up)

    sp = sub.add_parser("down", help="tear down a YAML-launched cluster")
    sp.add_argument("config")
    sp.set_defaults(fn=cmd_down)

    sp = sub.add_parser("exec", help="run a command on the cluster head")
    sp.add_argument("config")
    sp.add_argument("--all-nodes", action="store_true")
    sp.add_argument("cmd", nargs=argparse.REMAINDER)
    sp.set_defaults(fn=cmd_exec)

    sp = sub.add_parser("attach", help="open a shell on the cluster head")
    sp.add_argument("config")
    sp.set_defaults(fn=cmd_attach)

    sp = sub.add_parser("status", help="cluster resource overview")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_status)

    sp = sub.add_parser(
        "drain", help="gracefully drain a node (cordon, wait idle, remove)"
    )
    sp.add_argument("node_id", help="node id (hex, from `rt list nodes`)")
    sp.add_argument("--timeout", type=float, default=300.0)
    sp.add_argument("--undo", action="store_true",
                    help="lift the cordon instead of draining")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_drain)

    sp = sub.add_parser("list", help="list cluster entities")
    sp.add_argument(
        "entity",
        choices=["nodes", "tasks", "actors", "objects", "jobs",
                 "placement-groups", "workers"],
    )
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_list)

    sp = sub.add_parser("summary", help="summarize tasks by name/state")
    sp.add_argument("entity", choices=["tasks"])
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_summary)

    sp = sub.add_parser("timeline", help="dump chrome-trace task timeline")
    sp.add_argument("--output", "-o")
    sp.add_argument("--lifecycle", action="store_true",
                    help="include sampled per-phase lifecycle rows")
    sp.add_argument("--cluster", action="store_true",
                    help="render the live merged cluster event spine "
                         "(forces a journal dump) instead of a trace file")
    sp.add_argument("--limit", type=int, default=200,
                    help="max events to render with --cluster")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_timeline)

    sp = sub.add_parser(
        "postmortem",
        help="assemble a black-box bundle into a causal timeline",
    )
    sp.add_argument("bundle", nargs="?", default="latest",
                    help="bundle directory (default: newest)")
    sp.add_argument("--chain-only", action="store_true",
                    help="print only the culprit chain")
    sp.add_argument("--limit", type=int, default=0,
                    help="max timeline events to render (0 = all)")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_postmortem)

    sp = sub.add_parser(
        "profile", help="sampled task-lifecycle profiler (control plane)"
    )
    sp.add_argument("profile_command", nargs="?", choices=["tasks"],
                    help="tasks: per-phase latency breakdown")
    sp.add_argument("--on", action="store_true",
                    help="enable sampling cluster-wide")
    sp.add_argument("--off", action="store_true", help="disable sampling")
    sp.add_argument("--rate", type=float,
                    help="sample probability 0..1 (with --on; default 1)")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_profile)

    sp = sub.add_parser("rpc", help="per-method GCS RPC latency accounting")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_rpc)

    sp = sub.add_parser("trace", help="print one trace's span tree")
    sp.add_argument("trace_id")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_trace)

    sp = sub.add_parser("logs", help="list or tail session log files")
    sp.add_argument("filename", nargs="?", help="log file to tail")
    sp.add_argument("--node", help="node id (hex) to query")
    sp.add_argument("--tail", type=int, default=64 * 1024,
                    help="bytes from the end of the file")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_logs)

    sp = sub.add_parser("stack", help="dump live worker thread stacks")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_stack)

    sp = sub.add_parser("memory", help="object store usage by object")
    sp.add_argument("--devices", action="store_true",
                    help="unified HBM + object-store view per device/node")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_memory)

    sp = sub.add_parser(
        "top", help="live cluster view: step times, skew, memory, serving"
    )
    sp.add_argument("--watch", action="store_true",
                    help="refresh continuously instead of one shot")
    sp.add_argument("--interval", type=float, default=2.0,
                    help="refresh period with --watch (seconds)")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_top)

    sp = sub.add_parser(
        "serve",
        help="serve observability (signals) and declarative deploys",
    )
    sp.add_argument(
        "serve_command", nargs="?",
        choices=["signals", "deploy", "status", "shutdown"],
        help="default: signals (live ServeSignals table off the GCS)",
    )
    sp.add_argument("config", nargs="?", help="JSON/YAML app config")
    sp.add_argument("--watch", action="store_true",
                    help="refresh the signals table continuously")
    sp.add_argument("--interval", type=float, default=2.0,
                    help="refresh period with --watch (seconds)")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("job", help="submit and manage jobs")
    sp.add_argument("job_command",
                    choices=["submit", "status", "logs", "list", "stop"])
    sp.add_argument("args", nargs=argparse.REMAINDER)
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_job)

    sp = sub.add_parser(
        "loadgen",
        help="macro traffic harness: generate/replay traces, reconcile "
             "client vs server latency",
    )
    sp.add_argument("loadgen_command", choices=["gen", "run"])
    sp.add_argument("trace", help="trace file (JSONL) to write or replay")
    # gen knobs (offline; no cluster needed)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--duration", type=float, default=30.0,
                    help="open-loop trace length in seconds")
    sp.add_argument("--qps", type=float, default=20.0,
                    help="base offered rate")
    sp.add_argument("--ramp-to", type=float, default=None,
                    help="ramp linearly from --qps to this rate")
    sp.add_argument("--ramp-s", type=float, default=0.0,
                    help="ramp duration (seconds)")
    sp.add_argument("--diurnal-amplitude", type=float, default=0.0)
    sp.add_argument("--diurnal-period", type=float, default=86400.0)
    sp.add_argument("--flash", action="append", default=[],
                    metavar="START:DUR:MULT",
                    help="flash-crowd window (repeatable)")
    sp.add_argument("--process", choices=["poisson", "pareto"],
                    default="poisson")
    sp.add_argument("--pareto-alpha", type=float, default=1.5)
    sp.add_argument("--closed", action="store_true",
                    help="closed-loop trace (bounded concurrency)")
    sp.add_argument("--concurrency", type=int, default=8)
    sp.add_argument("--requests", type=int, default=0,
                    help="closed-loop request count")
    sp.add_argument("--think", type=float, default=0.0,
                    help="closed-loop mean think time (seconds)")
    # run knobs
    sp.add_argument("--app", help="deployed serve app to drive")
    sp.add_argument("--workers", type=int, default=64,
                    help="open-loop dispatch pool size")
    sp.add_argument("--unary", action="store_true",
                    help="unary calls instead of streaming")
    sp.add_argument("--out", help="write the reconciliation report "
                                  "(JSON) here")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_loadgen)

    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
