"""Cluster dashboard of the PyTorch port: HTTP JSON API + Prometheus
metrics + a one-page UI, fed directly from the GCS. Counterpart of
ray_tpu/dashboard/dashboard.py, with the same routes, JSON bodies, status
codes and exposition text.

The JAX package's dashboard is an aiohttp app. This one is built on the
standard library: `asyncio.start_server` and the HTTP/1.1 parser the
Serve proxy uses (`_private/http11.py`), so it runs on a host without
aiohttp. It answers as aiohttp does where the routes do not: 404
"404: Not Found" for an unknown path, 405 with an `Allow` header for a
known path and another method, HEAD wherever GET is routed, and 500
"500 Internal Server Error" for a handler that raises. The process
imports no torch: it reads the GCS and the raylets, nothing else.

Run standalone:
    python -m ray_tpu_torch.dashboard --address HOST:PORT [--port 8265]
"""

from __future__ import annotations

import asyncio
import http
import json
import logging
import re
import time
from typing import Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private.http11 import (
    _BadRequest,
    _read_request,
    _Request,
    _response,
    _text_response,
)
from ray_tpu_torch._private.protocol import Connection, connect

logger = logging.getLogger(__name__)

_HTML = """<!DOCTYPE html>
<html><head><title>ray_tpu_torch dashboard</title>
<style>
 :root { --bg:#fff; --fg:#1a1a1a; --muted:#667; --line:#d8dbe0;
         --accent:#2563eb; --ok:#16a34a; --warn:#d97706; --bad:#dc2626; }
 body { font-family: system-ui, sans-serif; margin:0; color:var(--fg);
        background:var(--bg); }
 header { display:flex; align-items:center; gap:1rem; padding:.7rem 1.2rem;
          border-bottom:1px solid var(--line); }
 header h1 { font-size:1.05rem; margin:0; }
 nav button { border:0; background:none; padding:.45rem .8rem;
              font-size:.9rem; cursor:pointer; color:var(--muted);
              border-bottom:2px solid transparent; }
 nav button.active { color:var(--accent);
                     border-bottom-color:var(--accent); }
 #status { margin-left:auto; font-size:.8rem; color:var(--muted); }
 main { padding:1rem 1.2rem; }
 table { border-collapse:collapse; width:100%; margin-top:.5rem; }
 th, td { border-bottom:1px solid var(--line); padding:.3rem .6rem;
          font-size:.82rem; text-align:left; vertical-align:top; }
 th { color:var(--muted); font-weight:600; cursor:pointer;
      white-space:nowrap; user-select:none; }
 tr:hover td { background:#f6f8fa; }
 .bar { background:#eef1f5; border-radius:4px; height:.9rem; width:14rem;
        display:inline-block; vertical-align:middle; overflow:hidden; }
 .bar i { display:block; height:100%; background:var(--accent); }
 .cards { display:flex; gap:1rem; flex-wrap:wrap; margin:.4rem 0 1rem; }
 .card { border:1px solid var(--line); border-radius:8px;
         padding:.7rem 1rem; min-width:9rem; }
 .card b { font-size:1.4rem; display:block; }
 .card span { font-size:.78rem; color:var(--muted); }
 .state-ALIVE, .state-RUNNING, .state-CREATED, .state-SUCCEEDED
   { color:var(--ok); font-weight:600; }
 .state-PENDING, .state-RESTARTING, .state-PENDING_SCHEDULING
   { color:var(--warn); font-weight:600; }
 .state-DEAD, .state-FAILED, .state-REMOVED { color:var(--bad);
   font-weight:600; }
 input[type=search] { padding:.3rem .5rem; border:1px solid var(--line);
   border-radius:6px; font-size:.85rem; width:16rem; }
 pre { background:#0f172a; color:#e2e8f0; padding: .8rem; border-radius:8px;
       font-size:.78rem; overflow:auto; max-height:24rem; }
 canvas { border:1px solid var(--line); border-radius:6px; }
 code { background:#f2f4f7; padding:0 .25rem; border-radius:3px; }
</style></head>
<body>
<header>
 <h1>ray_tpu_torch</h1>
 <nav id="tabs"></nav>
 <span id="status">connecting…</span>
</header>
<main>
 <div id="controls"></div>
 <div id="main">loading…</div>
</main>
<script>
"use strict";
const TABS = ["overview","nodes","actors","tasks","objects",
              "placement groups","serve","jobs","events","metrics","stacks"];
let tab = location.hash.slice(1) || "overview";
let filter = "", sortKey = null, sortDir = 1, openJob = null;
const hist = {};  // metric sparkline history

const el = (id) => document.getElementById(id);
const fmt = (o) => o === null || o === undefined ? "" :
  typeof o === "object" ? JSON.stringify(o) : String(o);
const esc = (s) => String(s).replace(/&/g,"&amp;").replace(/</g,"&lt;")
  .replace(/"/g,"&quot;").replace(/'/g,"&#39;");
const api = (p) => fetch("api/" + p).then(r => r.json());

function nav() {
  el("tabs").innerHTML = TABS.map(t =>
    `<button class="${t===tab?"active":""}"
      onclick="setTab('${t}')">${t}</button>`).join("");
}
function setTab(t) { tab = t; location.hash = t; sortKey = null;
  openJob = null; filter = ""; nav(); controls(); refresh(); }
function controls() {
  // The filter box lives OUTSIDE the refreshed content so typing never
  // loses focus to a re-render; refreshes also pause while it has focus.
  el("controls").innerHTML = tab === "overview" ? "" :
    `<input type=search id=filterbox placeholder="filter…"
       value="${esc(filter)}"
       oninput="filter=this.value;render()">`;
}

function stateCell(v) {
  return `<span class="state-${esc(v)}">${esc(v)}</span>`;
}
function cmpVals(a, b) {
  if (typeof a === "number" && typeof b === "number") return a - b;
  const fa = fmt(a), fb = fmt(b);
  return fa < fb ? -1 : fa > fb ? 1 : 0;
}
function rows(items, cols, stateCol) {
  if (filter) {
    const f = filter.toLowerCase();
    items = items.filter(it =>
      cols.some(c => fmt(it[c]).toLowerCase().includes(f)));
  }
  if (sortKey) {
    items = [...items].sort((a, b) =>
      sortDir * cmpVals(a[sortKey], b[sortKey]));
  }
  return `<table><tr>${cols.map(c => `<th onclick="sortBy('${c}')">${c}
     ${sortKey===c ? (sortDir>0?"▲":"▼") : ""}</th>`).join("")}</tr>` +
   items.map(it => "<tr>" + cols.map(c =>
     `<td>${c===stateCol ? stateCell(it[c]) : esc(fmt(it[c] ?? ""))}</td>`
   ).join("") + "</tr>").join("") + "</table>" +
   `<p style="color:var(--muted);font-size:.78rem">${items.length} rows</p>`;
}
function sortBy(c) {
  sortDir = sortKey === c ? -sortDir : 1; sortKey = c; refresh();
}

function resourceBars(status) {
  return Object.entries(status.resources_total).map(([k, total]) => {
    const avail = status.resources_available[k] ?? 0;
    const used = total - avail;
    const pct = total ? Math.round(100 * used / total) : 0;
    return `<div style="margin:.2rem 0">
      <code>${esc(k)}</code> ${used.toFixed(2)} / ${total} used
      <span class="bar"><i style="width:${pct}%"></i></span> ${pct}%
      </div>`;
  }).join("");
}

function spark(id, values, w=260, h=48) {
  const c = el(id); if (!c) return;
  const ctx = c.getContext("2d");
  ctx.clearRect(0, 0, w, h);
  if (values.length < 2) return;
  const max = Math.max(...values, 1e-9), min = Math.min(...values, 0);
  ctx.beginPath(); ctx.strokeStyle = "#2563eb"; ctx.lineWidth = 1.5;
  values.forEach((v, i) => {
    const x = i * (w - 4) / (values.length - 1) + 2;
    const y = h - 3 - (v - min) * (h - 8) / (max - min || 1);
    i ? ctx.lineTo(x, y) : ctx.moveTo(x, y);
  });
  ctx.stroke();
}

async function render() {
  if (tab === "overview") {
    const [status, actors, tasks, jobs] = await Promise.all([
      api("cluster_status"), api("actors"), api("tasks"), api("jobs")]);
    const cpuT = status.resources_total.CPU || 0;
    const cpuA = status.resources_available.CPU ?? cpuT;
    (hist.cpu = hist.cpu || []).push(cpuT - cpuA);
    if (hist.cpu.length > 120) hist.cpu.shift();
    el("main").innerHTML = `
      <div class="cards">
       <div class="card"><b>${status.alive_nodes}/${status.total_nodes}</b>
         <span>nodes alive</span></div>
       <div class="card"><b>${actors.filter(a=>a.state==="ALIVE").length}</b>
         <span>live actors</span></div>
       <div class="card"><b>${tasks.length}</b><span>tasks seen</span></div>
       <div class="card"><b>${jobs.length}</b><span>jobs</span></div>
       <div class="card"><canvas id=cpuspark width=260 height=48></canvas>
         <span>CPU in use (last ${hist.cpu.length} ticks)</span></div>
      </div>
      <h3>Cluster resources</h3>${resourceBars(status)}`;
    spark("cpuspark", hist.cpu);
  } else if (tab === "nodes") {
    el("main").innerHTML = rows(await api("nodes"),
      ["node_id","state","draining","address","is_head","resources_total",
       "resources_available","proc_stats"], "state");
  } else if (tab === "actors") {
    el("main").innerHTML = rows(await api("actors"),
      ["actor_id","class_name","name","state","node_id"], "state");
  } else if (tab === "tasks") {
    el("main").innerHTML = rows(await api("tasks"),
      ["task_id","name","type","state"], "state");
  } else if (tab === "objects") {
    el("main").innerHTML = rows(await api("objects"),
      ["object_id","size","locations"]);
  } else if (tab === "placement groups") {
    el("main").innerHTML = rows(await api("placement_groups"),
      ["pg_id","state","strategy","bundles"], "state");
  } else if (tab === "serve") {
    const apps = await api("serve");
    el("main").innerHTML = apps.length
      ? rows(apps, ["app","deployment","target_replicas",
                    "running_replicas","version"])
      : `<p style="color:var(--muted)">no serve applications</p>`;
  } else if (tab === "jobs") {
    const jobs = await api("jobs");
    let html = `<table><tr><th>submission_id</th><th>state</th>
        <th>entrypoint</th><th>logs</th></tr>` +
      jobs.map(j => `<tr><td>${esc(j.submission_id ?? "")}</td>` +
        `<td>${stateCell(j.state ?? "")}</td>` +
        `<td>${esc(j.entrypoint ?? "")}</td>` +
        `<td><a href="#jobs" data-sid="${esc(j.submission_id ?? "")}"
           onclick="openJob=this.dataset.sid;refresh();return false"
           >view</a></td></tr>`).join("") +
      `</table>`;
    if (openJob) {
      const logs = await fetch(`api/jobs/${openJob}/logs`)
        .then(r => r.text());
      html += `<h3>logs: ${esc(openJob)}</h3><pre>${esc(logs)}</pre>`;
    }
    el("main").innerHTML = html;
  } else if (tab === "events") {
    const evts = (await api("events")).reverse().map(e => ({
      time: new Date(e.timestamp * 1000).toLocaleTimeString(),
      source: e.source, severity: e.severity, message: e.message,
      detail: Object.fromEntries(Object.entries(e).filter(([k]) =>
        !["timestamp","source","severity","message","pid"].includes(k))),
    }));
    el("main").innerHTML = rows(evts,
      ["time","source","severity","message","detail"]);
  } else if (tab === "stacks") {
    // On-demand per-worker thread stacks (the `rt stack` profiling
    // drill-down; reference: dashboard reporter py-spy integration).
    el("main").innerHTML = `<p style="color:var(--muted)">collecting live
      thread stacks from every worker…</p>`;
    const nodes = await api("stacks");
    el("main").innerHTML = nodes.map(n => `
      <h3>node ${esc(n.node_id)}</h3>` +
      (n.error ? `<pre>error: ${esc(n.error)}</pre>` :
       n.workers.map(w => `
        <details><summary>pid ${esc(fmt(w.pid))}
          ${w.actor ? "(actor)" : "(worker)"}
          — ${(w.threads||[]).length} threads
          ${w.error ? " — " + esc(w.error) : ""}</summary>
          <pre>${esc((w.threads||[]).map(t =>
            "-- " + t.thread + " --\n" + t.stack).join("\n"))}</pre>
        </details>`).join(""))).join("");
  } else if (tab === "metrics") {
    const text = await fetch("metrics").then(r => r.text());
    const rowsOut = [];
    for (const line of text.split("\n")) {
      if (!line || line.startsWith("#")) continue;
      const i = line.lastIndexOf(" ");
      const name = line.slice(0, i), val = parseFloat(line.slice(i + 1));
      rowsOut.push({metric: name, value: val});
      (hist[name] = hist[name] || []).push(val);
      if (hist[name].length > 120) hist[name].shift();
    }
    el("main").innerHTML = rows(rowsOut, ["metric","value"]);
  }
}

let lastStacks = 0;
async function refresh() {
  if (document.activeElement && document.activeElement.id === "filterbox")
    return;  // don't repaint under the user's caret
  if (tab === "stacks") {
    // Expensive probe: refresh at most every 15s.
    if (Date.now() - lastStacks < 15000) return;
    lastStacks = Date.now();
  }
  try {
    await render();
    el("status").textContent =
      "live · " + new Date().toLocaleTimeString();
  } catch (e) {
    el("status").textContent = "api error: " + e;
  }
}
nav(); controls(); refresh(); setInterval(refresh, 2000);
</script></body></html>
"""


def _hex(b):
    return b.hex() if isinstance(b, (bytes, bytearray)) else b


def _prom_escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _prom_labels(tags) -> str:
    if not tags:
        return ""
    inner = ",".join(f'{k}="{_prom_escape(v)}"' for k, v in tags)
    return "{" + inner + "}"


class _Reply:
    """A handler's answer (aiohttp's `web.Response`, as far as the
    dashboard uses it): text, a status and a content type, to which the
    writer appends `; charset=utf-8` as aiohttp does."""

    __slots__ = ("status", "text", "content_type")

    def __init__(self, text: str = "", status: int = 200,
                 content_type: str = "text/plain"):
        self.status = status
        self.text = text
        self.content_type = content_type


class _Call:
    """The request as a handler sees it: `query` (first value of each
    parameter), `match_info` (the `{name}` segments of its route) and
    `json()` of the body."""

    __slots__ = ("query", "match_info", "body")

    def __init__(self, request: _Request, match_info: Dict[str, str]):
        self.query = {k: v[0] for k, v in request.query.items()}
        self.match_info = match_info
        self.body = request.body

    async def json(self):
        return json.loads(self.body.decode("utf-8"))


def _compile(path: str) -> "re.Pattern":
    # aiohttp's `{name}` placeholder matches one non-empty segment.
    return re.compile(
        "^" + re.sub(r"\\\{(\w+)\\\}", r"(?P<\1>[^{}/]+)", re.escape(path)) + "$")


class Dashboard:
    def __init__(self, gcs_address: str, host: str = "127.0.0.1", port: int = 8265):
        self.gcs_address = gcs_address
        self.host, self.port = host, port
        self.gcs: Optional[Connection] = None
        routes = [
            ("GET", "/", self.page),
            ("GET", "/healthz", self.healthz),
            ("GET", "/metrics", self.metrics),
            ("GET", "/api/cluster_status", self.cluster_status),
            ("GET", "/api/nodes", self.nodes),
            ("GET", "/api/actors", self.actors),
            ("GET", "/api/tasks", self.tasks),
            ("GET", "/api/objects", self.objects),
            ("GET", "/api/placement_groups", self.placement_groups),
            ("GET", "/api/jobs", self.jobs),
            ("GET", "/api/events", self.events),
            ("GET", "/api/stacks", self.stacks),
            ("GET", "/api/serve", self.serve_apps),
            ("POST", "/api/jobs", self.submit_job),
            ("GET", "/api/jobs/{submission_id}", self.job_info),
            ("GET", "/api/jobs/{submission_id}/logs", self.job_logs),
            ("POST", "/api/jobs/{submission_id}/stop", self.stop_job),
        ]
        # One resource per path, as aiohttp groups routes: its methods
        # (GET brings HEAD) answer, any other method gets a 405.
        self._resources: List[Tuple["re.Pattern", Dict[str, Callable]]] = []
        by_path: Dict[str, Dict[str, Callable]] = {}
        for method, path, fn in routes:
            if path not in by_path:
                by_path[path] = {}
                self._resources.append((_compile(path), by_path[path]))
            by_path[path][method] = fn
            if method == "GET":
                by_path[path]["HEAD"] = fn
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> int:
        host, port = self.gcs_address.rsplit(":", 1)
        self.gcs = await connect(host, int(port))
        self._server = await asyncio.start_server(
            self._on_client, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self):
        if self._server:
            self._server.close()
            await self._server.wait_closed()
        if self.gcs:
            await self.gcs.close()

    # -- http ------------------------------------------------------------
    def _resolve(self, method: str, path: str):
        """(handler, match_info) or (None, status, extra headers)."""
        for pattern, methods in self._resources:
            m = pattern.match(path)
            if m is None:
                continue
            fn = methods.get(method)
            if fn is None:
                return None, 405, {"Allow": ",".join(sorted(methods))}
            return fn, m.groupdict()
        return None, 404, {}

    async def _answer(self, request: _Request) -> Tuple[bytes, bool]:
        keep, ver = request.keep_alive, request.version
        found = self._resolve(request.method, request.path)
        if found[0] is None:
            _, status, extra = found
            return _text_response(status, keep, extra or None, ver), keep
        fn, match_info = found
        try:
            reply = await fn(_Call(request, match_info))
        except Exception:  # noqa: BLE001 — aiohttp answers 500 and closes
            logger.exception("dashboard %s %s failed", request.method,
                             request.path)
            text = "500 Internal Server Error\n\n" + \
                http.HTTPStatus.INTERNAL_SERVER_ERROR.description
            return _response(500, text.encode(), "text/plain; charset=utf-8",
                             False, None, ver), False
        out = _response(reply.status, reply.text.encode("utf-8"),
                        reply.content_type + "; charset=utf-8", keep,
                        None, ver)
        if request.method == "HEAD":
            out = out[:out.index(b"\r\n\r\n") + 4]
        return out, keep

    async def _on_client(self, reader, writer):
        """One connection: requests in order until the client closes or
        asks to (HTTP/1.1 keep-alive)."""
        try:
            while True:
                try:
                    request = await _read_request(reader)
                except _BadRequest as e:
                    writer.write(_text_response(e.status, keep_alive=False))
                    await writer.drain()
                    return
                if request is None:
                    return
                out, keep = await self._answer(request)
                writer.write(out)
                await writer.drain()
                if not keep:
                    return
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # the client went away
        finally:
            writer.close()

    # -- pages -----------------------------------------------------------
    async def page(self, request):
        return _Reply(_HTML, content_type="text/html")

    async def healthz(self, request):
        try:
            await self.gcs.call("ping", {}, timeout=2)
        except Exception:
            return _Reply("gcs unreachable", status=503)
        return _Reply("ok")

    # -- json api --------------------------------------------------------
    def _json(self, data):
        return _Reply(json.dumps(data, default=_hex),
                      content_type="application/json")

    async def cluster_status(self, request):
        nodes = (await self.gcs.call("get_nodes", {}))["nodes"]
        alive = [n for n in nodes if n["state"] == "ALIVE"]
        totals, avail = {}, {}
        for n in alive:
            for k, v in n.get("resources_total", {}).items():
                totals[k] = totals.get(k, 0) + v
            for k, v in n.get("resources_available", {}).items():
                avail[k] = avail.get(k, 0) + v
        return self._json(
            {
                "alive_nodes": len(alive),
                "total_nodes": len(nodes),
                "resources_total": totals,
                "resources_available": avail,
                "timestamp": time.time(),
            }
        )

    async def nodes(self, request):
        nodes = (await self.gcs.call("get_nodes", {}))["nodes"]
        return self._json(
            [
                {
                    "node_id": _hex(n["node_id"]),
                    "state": n["state"],
                    "draining": bool(n.get("draining", False)),
                    "address": f"{n['address']}:{n['port']}",
                    "is_head": n.get("is_head", False),
                    "resources_total": n.get("resources_total", {}),
                    "resources_available": n.get("resources_available", {}),
                    "proc_stats": n.get("proc_stats", {}),
                }
                for n in nodes
            ]
        )

    async def actors(self, request):
        actors = (await self.gcs.call("list_actors", {}))["actors"]
        return self._json(
            [
                {
                    "actor_id": _hex(a["actor_id"]),
                    "class_name": a.get("class_name", ""),
                    "state": a.get("state", ""),
                    "name": a.get("name") or "",
                    "node_id": _hex(a.get("node_id") or b""),
                }
                for a in actors
            ]
        )

    async def tasks(self, request):
        events = (await self.gcs.call("list_task_events", {"limit": 100_000}))[
            "events"
        ]
        tasks = {}
        for ev in events:
            t = tasks.setdefault(
                ev["task_id"],
                {"task_id": _hex(ev["task_id"]), "name": ev.get("name", ""),
                 "type": ev.get("type")},
            )
            t["state"] = ev["state"]
        return self._json(list(tasks.values()))

    async def objects(self, request):
        objs = (await self.gcs.call("list_objects", {}))["objects"]
        return self._json(
            [
                {"object_id": _hex(o["object_id"]), "size": o["size"],
                 "locations": [_hex(n) for n in o["nodes"]]}
                for o in objs
            ]
        )

    async def placement_groups(self, request):
        pgs = (await self.gcs.call("list_placement_groups", {}))["pgs"]
        return self._json(
            [
                {"pg_id": _hex(p["pg_id"]), "state": p["state"],
                 "strategy": p["strategy"], "bundles": p["bundles"]}
                for p in pgs
            ]
        )

    async def serve_apps(self, request):
        """Serve application/deployment view, read from the controller's
        GCS-KV checkpoint (written on every mutation — the dashboard
        needs no actor-call machinery; reference: the dashboard serve
        module reading controller state)."""
        from ray_tpu_torch._vendor import cloudpickle

        try:
            r = await self.gcs.call(
                "kv_get", {"ns": "serve", "key": b"serve_controller_ckpt"}
            )
            raw = r.get("value")
            if not raw:
                return self._json([])
            state = cloudpickle.loads(raw)
        except Exception:  # noqa: BLE001 — no serve running
            return self._json([])
        out = []
        for name, app in (state.get("apps") or {}).items():
            dep = app.get("deployment")
            out.append({
                "app": name,
                "deployment": getattr(dep, "name", str(dep)),
                "target_replicas": app.get("target"),
                "running_replicas": len(app.get("replicas") or []),
                "version": app.get("version"),
            })
        return self._json(out)

    async def stacks(self, request):
        """Live per-worker thread stacks from every (or one) node — the
        `rt stack` drill-down surfaced in the UI (reference: the
        dashboard reporter's on-demand py-spy profiling,
        dashboard/modules/reporter/profile_manager.py)."""
        from ray_tpu_torch._private.protocol import connect as _connect

        node_filter = request.query.get("node_id")
        out = []
        for n in (await self.gcs.call("get_nodes", {}))["nodes"]:
            if n["state"] != "ALIVE":
                continue
            nid = _hex(n["node_id"])
            if node_filter and nid != node_filter:
                continue
            try:
                conn = await _connect(n["address"], n["port"], timeout=5)
                try:
                    r = await asyncio.wait_for(
                        conn.call("worker_stacks", {}), 30
                    )
                finally:
                    await conn.close()
                workers = []
                for w in r.get("workers", []):
                    w = dict(w)
                    wid = w.get("worker_id")
                    if isinstance(wid, (bytes, bytearray)):
                        w["worker_id"] = wid.hex()
                    workers.append(w)
                out.append({"node_id": nid, "workers": workers})
            except Exception as e:  # noqa: BLE001 — node mid-death
                out.append({"node_id": nid, "error": f"{type(e).__name__}: {e}"})
        return self._json(out)

    async def events(self, request):
        """Merged structured event tail (reference: dashboard event
        module over RAY_EVENT JSON files)."""
        from ray_tpu_torch.util.event import read_events

        limit = int(request.query.get("limit", 200))
        return self._json(read_events(limit=limit))

    async def jobs(self, request):
        jobs = (await self.gcs.call("list_jobs", {}))["jobs"]
        return self._json(
            [{**j, "job_id": _hex(j.get("job_id", b"")),
              "node_id": _hex(j.get("node_id") or b"")} for j in jobs]
        )

    async def submit_job(self, request):
        body = await request.json()
        r = await self.gcs.call(
            "submit_job",
            {
                "entrypoint": body["entrypoint"],
                "submission_id": body.get("submission_id"),
                "runtime_env": body.get("runtime_env"),
                "metadata": body.get("metadata"),
            },
        )
        status = 200 if r.get("ok") else 400
        return _Reply(json.dumps(r), status=status,
                      content_type="application/json")

    async def job_info(self, request):
        sid = request.match_info["submission_id"]
        r = await self.gcs.call("get_job", {"submission_id": sid})
        if r["job"] is None:
            return _Reply("no such job", status=404)
        return self._json(
            {**r["job"], "job_id": _hex(r["job"].get("job_id", b"")),
             "node_id": _hex(r["job"].get("node_id") or b"")}
        )

    async def job_logs(self, request):
        sid = request.match_info["submission_id"]
        r = await self.gcs.call("job_logs", {"submission_id": sid})
        if r["logs"] is None:
            return _Reply("no such job", status=404)
        return _Reply(r["logs"])

    async def stop_job(self, request):
        sid = request.match_info["submission_id"]
        r = await self.gcs.call("stop_job", {"submission_id": sid})
        return self._json(r)

    # -- prometheus ------------------------------------------------------
    async def metrics(self, request):
        lines = []
        # System metrics derived from GCS tables (stats/metric_defs.h
        # analog: node resources, actor/task/job states).
        nodes = (await self.gcs.call("get_nodes", {}))["nodes"]
        lines.append("# TYPE rt_node_resource_total gauge")
        lines.append("# TYPE rt_node_resource_available gauge")
        for n in nodes:
            if n["state"] != "ALIVE":
                continue
            nid = _hex(n["node_id"])[:12]
            for k, v in n.get("resources_total", {}).items():
                lines.append(
                    f'rt_node_resource_total{{node="{nid}",resource="{_prom_escape(k)}"}} {v}'
                )
            for k, v in n.get("resources_available", {}).items():
                lines.append(
                    f'rt_node_resource_available{{node="{nid}",resource="{_prom_escape(k)}"}} {v}'
                )
        actors = (await self.gcs.call("list_actors", {}))["actors"]
        states: dict = {}
        for a in actors:
            states[a.get("state", "?")] = states.get(a.get("state", "?"), 0) + 1
        lines.append("# TYPE rt_actors gauge")
        for s, c in states.items():
            lines.append(f'rt_actors{{state="{s}"}} {c}')

        # GCS-internal runtime metrics (per-component stats).
        stats = await self.gcs.call("gcs_stats", {})
        lines.append("# TYPE rt_gcs_rpc_total counter")
        for method, count in sorted(stats["rpc_counts"].items()):
            lines.append(
                f'rt_gcs_rpc_total{{method="{_prom_escape(method)}"}} {count}'
            )
        for gauge in ("kv_entries", "task_events", "subscriber_conns",
                      "object_dir_entries", "placement_groups"):
            lines.append(f"# TYPE rt_gcs_{gauge} gauge")
            lines.append(f"rt_gcs_{gauge} {stats[gauge]}")

        # User metrics (util/metrics.py) from the GCS aggregate.
        snapshot = (await self.gcs.call("metrics_snapshot", {}))["metrics"]
        for m in snapshot:
            name = m["name"]
            if m["description"]:
                lines.append(f"# HELP {name} {_prom_escape(m['description'])}")
            ptype = {"counter": "counter", "gauge": "gauge",
                     "histogram": "histogram"}[m["type"]]
            lines.append(f"# TYPE {name} {ptype}")
            for tags, val in m["series"]:
                if m["type"] in ("counter", "gauge"):
                    lines.append(f"{name}{_prom_labels(tags)} {val}")
                else:
                    bounds = m["boundaries"]
                    cum = 0
                    for i, b in enumerate(bounds):
                        cum += val["buckets"][i]
                        lab = list(tags) + [["le", str(b)]]
                        lines.append(f"{name}_bucket{_prom_labels(lab)} {cum}")
                    cum += val["buckets"][-1]
                    lab = list(tags) + [["le", "+Inf"]]
                    lines.append(f"{name}_bucket{_prom_labels(lab)} {cum}")
                    lines.append(f"{name}_sum{_prom_labels(tags)} {val['sum']}")
                    lines.append(f"{name}_count{_prom_labels(tags)} {val['count']}")
        return _Reply("\n".join(lines) + "\n")


def run_dashboard(gcs_address: str, host: str = "127.0.0.1", port: int = 8265):
    """Blocking entry point (standalone dashboard process)."""

    async def main():
        dash = Dashboard(gcs_address, host, port)
        actual = await dash.start()
        print(f"DASHBOARD_PORT={actual}", flush=True)
        await asyncio.Event().wait()

    asyncio.run(main())


def main():  # pragma: no cover - subprocess entry
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--address", required=True, help="GCS host:port")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8265)
    args = p.parse_args()
    run_dashboard(args.address, args.host, args.port)


if __name__ == "__main__":
    main()
