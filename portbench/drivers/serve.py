"""Serving cells: open-loop traffic into the in-process
`ray_tpu_torch.serve.llm.LLMReplica` (the class a Serve replica runs)
through `stream()`, over its `ContinuousBatchingEngine`.

Set-up builds the replica on the seed's weights and sends each system
prompt once, which fills the prefix cache as a running deployment's would
be. The window offers the mix's requests at their due times, one client
thread each, and times every token on arrival. Traced, the profiler
covers the mix's `trace.seconds` at the window's start, and the engine's
counters are read over the rest. After the window every
request due in it is waited for (a minute at most); then the replica is
shut down and the reference reads a sample of the finished requests,
drawn from the seed with the longest in it: the widest gap by which a
served token's logit lies below the reference's best.
"""

from __future__ import annotations

import gc
import queue
import random
import threading
import time
from typing import Dict, List

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench import traffic as traffic_gen
from portbench import weights, yardstick
from portbench.reference import model as reference

DRAIN_S = 60.0
# Client threads: more than the requests a window holds in flight at once.
CLIENTS = 128


def port_config(dims: Dict, dtype=torch.bfloat16):
    from ray_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(
        vocab_size=dims["vocab"], d_model=dims["d"],
        n_layers=dims["layers"], n_heads=dims["heads"],
        n_kv_heads=dims["kv_heads"], d_ff=dims["ff"],
        max_seq=dims["max_seq"], rope_theta=dims["rope_theta"],
        norm_eps=dims["eps"], dtype=dtype, remat=False)


def build_replica(run):
    from ray_tpu_torch.serve.llm import LLMReplica

    dims, dev, eng = run.dims, run.device, run.traffic["engine"]
    cfg = port_config(dims)

    def loader():
        return weights.make_weights(dims, run.seed, dev), cfg

    return LLMReplica(loader, num_slots=eng["num_slots"],
                      max_len=eng["max_len"],
                      prefill_chunk=eng["prefill_chunk"], kv_mode="paged",
                      page_size=eng["page_size"], kv_pages=eng["kv_pages"])


def _client(replica, req: Dict) -> None:
    req["sent"] = time.perf_counter()
    try:
        with record_function("portbench.stream"):
            for tok in replica.stream(req["prompt"], req["max_new_tokens"],
                                      temperature=0.0):
                req["times"].append(time.perf_counter())
                req["tokens"].append(tok)
    except Exception as e:  # noqa: BLE001 - a failed request is counted
        req["error"] = f"{type(e).__name__}: {e}"


def offer(replica, requests: List[Dict], seconds: float,
          trace_s: float = 0.0) -> Dict:
    """Hand each request to a client thread at its due time (seconds after
    the window opens) and wait for all of them, a minute past the close at
    most; returns the window's opening, its close and the engine's stats at
    both ends. With trace_s, the profiler runs over the window's first
    trace_s seconds only (it starts before the window opens, since its
    start takes seconds), and the engine's stats are read again once it
    has stopped: its callbacks on every launch slow the host, so what the
    host's clock and the program's counters read comes from the rest."""
    engine = replica.engine
    for r in requests:
        r.update(times=[], tokens=[], error=None, sent=None)
    jobs: "queue.Queue" = queue.Queue()

    def worker():
        while True:
            r = jobs.get()
            if r is None:
                return
            _client(replica, r)

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(CLIENTS)]
    for th in threads:
        th.start()
    prof = window = untraced = None
    if trace_s > 0:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
        window = record_function("portbench.window")
        window.__enter__()
    before = engine.stats()
    t0 = time.perf_counter()
    close = t0 + seconds
    stop_at = t0 + trace_s

    def wait_until(t):
        nonlocal untraced
        while True:
            now = time.perf_counter()
            tracing = prof is not None and untraced is None
            if tracing and now >= stop_at:
                window.__exit__(None, None, None)
                prof.stop()
                untraced = (time.perf_counter(), engine.stats())
                continue
            if now >= t:
                return
            time.sleep((min(t, stop_at) if tracing else t) - now)

    for r in requests:
        r["due_at"] = t0 + r["due"]
        wait_until(r["due_at"])
        jobs.put(r)
    wait_until(close)
    after = engine.stats()
    for _ in threads:
        jobs.put(None)
    deadline = close + DRAIN_S
    for th in threads:
        th.join(max(0.0, deadline - time.perf_counter()))
    return {"t0": t0, "close": close, "before": before, "after": after,
            "untraced": untraced,
            "alive": sum(th.is_alive() for th in threads), "prof": prof}


def window_metrics(requests: List[Dict], t0: float, close: float) -> Dict:
    ttft, gaps, delivered = [], [], 0
    for r in requests:
        ts = r["times"]
        ttft.append(ts[0] - r["due_at"] if ts and not r["error"]
                    else float("inf"))
        delivered += sum(1 for t in ts if t <= close)
        gaps.extend(b - a for a, b in zip(ts, ts[1:]) if b <= close)
    return {"output_tokens_per_s": delivered / (close - t0),
            "ttft_p90_s": yardstick.percentile(ttft, 90),
            "itl_p95_ms": yardstick.percentile(gaps, 95) * 1e3,
            "delivered": delivered, "gaps": len(gaps)}


def sample(requests: List[Dict], seed: int, n: int) -> List[Dict]:
    """n finished requests drawn from the seed, the longest among them."""
    done = [r for r in requests if not r["error"]
            and len(r["tokens"]) == r["max_new_tokens"]]
    if not done:
        return []
    longest = max(done, key=lambda r: len(r["prompt"]) + len(r["tokens"]))
    rest = [r for r in done if r is not longest]
    random.Random(seed).shuffle(rest)
    return [longest] + rest[:n - 1]


def drive(run) -> None:
    reference.strict_float32()
    mix, dims, dev = run.traffic, run.dims, run.device
    sched = traffic_gen.chat_requests(mix, run.seconds, run.seed,
                                      dims["vocab"])
    replica = build_replica(run)
    for prompt in sched["systems"]:
        list(replica.stream(prompt, 2, temperature=0.0))
    run.setup_done()

    requests = sched["requests"]
    trace_s = float(mix["trace"]["seconds"]) if run.trace else 0.0
    got = offer(replica, requests, run.seconds, min(trace_s, run.seconds))
    t0, close = got["t0"], got["close"]
    run.memory_peak_bytes = (torch.cuda.max_memory_allocated(dev)
                             if dev.type == "cuda" else 0)
    m = window_metrics(requests, t0, close)
    run.e2e.update({k: m[k] for k in ("ttft_p90_s", "itl_p95_ms")})
    run.attempted = len(requests)
    bad = [r for r in requests
           if r["error"] or len(r["tokens"]) != r["max_new_tokens"]]
    run.failed = len(bad)
    late = [r["sent"] - r["due_at"] for r in requests if r["sent"]]
    run.notes.update({
        "requests": len(requests), "tokens_delivered": m["delivered"],
        "output_tokens_per_s": m["output_tokens_per_s"],
        "gaps": m["gaps"], "unfinished_after_drain": got["alive"],
        "errors": sorted({r["error"] for r in bad if r["error"]})[:5],
        "generator_late_ms": {"p50": yardstick.percentile(late, 50) * 1e3,
                              "max": max(late, default=0.0) * 1e3},
    })
    run.facts.update({"kind": "serve", "t0": t0, "close": close,
                      "before": got["before"], "after": got["after"],
                      "untraced": got["untraced"],
                      "requests": [{"prompt_len": len(r["prompt"]),
                                    "times": r["times"]} for r in requests],
                      "system_tokens": mix["system_prompts"]["tokens"]})
    if got["prof"] is not None:
        _reduce_trace(run, got)

    picked = sample(requests, run.seed, int(mix["check"]["requests"]))
    seqs = [(r["prompt"], r["tokens"]) for r in picked]
    replica.shutdown()
    del replica
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if not seqs:
        run.check("served_logit_gap", float("inf"),
                  mix["check"]["limits"]["served_logit_gap"])
        return
    gaps = reference.served_gaps(dims, run.seed, seqs, dev,
                                 control=run.control == "float8")
    run.notes["checked_tokens"] = gaps["tokens"]
    run.facts["control_gap"] = gaps["control"]
    run.check("served_logit_gap", gaps["served"],
              mix["check"]["limits"]["served_logit_gap"])


def _reduce_trace(run, got) -> None:
    t = time.perf_counter()
    summary = yardstick.trace_summary(got["prof"])
    run.facts["trace"] = summary
    run.breakdown = {"device_ops": yardstick.top(summary["by_name"]),
                     "idle_gaps": yardstick.top(summary["idle_by_label"])}
    run.notes["trace_reduce_s"] = time.perf_counter() - t
