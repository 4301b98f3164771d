"""The port's card-memory accounting and the CLI views that read it.

- The renderers of `rt top`, `rt serve` and `rt memory --devices` in
  both packages turn one fixed snapshot into the same text, except the
  labels listed in RELABELED, which name torch in place of jax.
- `util.memory.device_memory` / `sample_once` with `torch.cuda`'s
  functions monkeypatched to fixed values report them under the card's
  physical id (CUDA_VISIBLE_DEVICES), and `rt memory --devices` and
  `rt top` on the live GCS show them beside a rank's steps and the object
  store (the counterpart of tests/test_flight_recorder.py:252); on this
  host, where CUDA is never initialised, `device_memory()` is empty.
- `rt serve` reads a running app's signals off the GCS and renders them
  (the CLI part of tests/test_serve_observatory.py:208).
"""

import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.scripts import scripts as jax_cli
from ray_tpu_torch.scripts import scripts as torch_cli

# (JAX package's label, the port's label)
RELABELED = [("HBM (live jax arrays)", "HBM (live torch tensors)")]

NODES = [{"node_id": "aa" * 16, "state": "ALIVE"},
         {"node_id": "bb" * 16, "state": "DEAD"}]


def _hist(count, total):
    return {"count": count, "sum": total}


SNAPSHOT = [
    {"name": "train_step_wall_seconds", "series": [
        [[["rank", "0"]], _hist(3, 0.6)], [[["rank", "1"]], _hist(3, 0.75)]]},
    {"name": "train_step_phase_seconds_total", "series": [
        [[["rank", "0"], ["phase", "compute"]], 0.5],
        [[["rank", "0"], ["phase", "data"]], 0.1],
        [[["rank", "1"], ["phase", "compute"]], 0.7]]},
    {"name": "train_tokens_per_s", "series": [[[["rank", "0"]], 40960.0]]},
    {"name": "train_step_skew_seconds", "series": [[[], _hist(2, 0.05)]]},
    {"name": "device_hbm_live_bytes", "series": [
        [[["node", "aaaa"], ["device", "cuda:0"]], 5.7e9]]},
    {"name": "rt_raylet_store_used_bytes", "series": [
        [[["node", "aaaa"]], 2.5e8]]},
    {"name": "data_feed_batches_total", "series": [[[], 12.0]]},
    {"name": "serve_llm_batch_occupancy", "series": [[[], 0.5]]},
    {"name": "serve_llm_ttft_seconds", "series": [[[], _hist(4, 1.2)]]},
    {"name": "serve_llm_tpot_seconds", "series": [[[], _hist(4, 0.08)]]},
    {"name": "serve_requests_total", "series": [
        [[["tenant", "acme"]], 6.0], [[["tenant", "globex"]], 3.0]]},
    {"name": "serve_request_phase_seconds_total", "series": [
        [[["phase", "queue"]], 0.3], [[["phase", "engine"]], 0.9]]},
    {"name": "preempt_total", "series": [
        [[["tenant", "batch"], ["reason", "slo"]], 2.0]]},
]

SIGNALS = {"seq": 7, "ts": 0.0, "apps": {"echo": {
    "qps": 2.5, "waiting": 1, "target_replicas": 2, "running_replicas": 2,
    "occupancy": 0.5, "backlog_drain_s": 0.25, "phase_sum_fraction": 0.98,
    "kv": {"pages_in_use": 3, "pages_total": 8, "util": 0.375,
           "prefix_hit_rate": 0.5, "prefill_tokens_skipped": 64},
    "replicas": [{"actor_id": "cc" * 8, "ongoing": 1, "total_served": 6,
                  "kv_util": 0.4},
                 {"actor_id": "dd" * 8, "unreachable": True,
                  "health_fails": 2}],
    "ttft_s": {"n": 6, "p50": 0.2, "p99": 0.9},
    "tpot_s": {"p50": 0.02, "p99": 0.05},
    "phases": {"queue": {"sum_s": 0.3}, "engine": {"sum_s": 0.9}},
    "hol": {"blocked_slot_seconds": 0.4, "events": [
        {"prefill_s": 0.3, "victims": 1, "culprits": [
            {"request_id": "r1", "prompt_tokens": 900}]}]},
    "tenants": {"acme": {"requests": 6, "tokens_in": 60, "tokens_out": 96,
                         "slo_windows": {"60": {"e2e": {
                             "burn": 0.0, "total": 6, "good": 6}}}}},
}}}

SUMMARY = {
    "devices": [{"node": "aaaa", "device": "cuda:0", "live_bytes": 5_700_000_000,
                 "live_arrays": 291, "bytes_in_use": 6_000_000_000,
                 "bytes_limit": 85_000_000_000}],
    "hbm_live_bytes": 5_700_000_000,
    "object_store": {"per_node": {"aaaa": {"used_bytes": 250_000_000,
                                           "num_objects": 4}},
                     "used_bytes": 250_000_000, "num_objects": 4},
    "objects": {"count": 4, "bytes": 250_000_000},
}


def _relabel(text):
    for jax_label, torch_label in RELABELED:
        text = text.replace(jax_label, torch_label)
    return text


def test_renderers_match_the_jax_package(monkeypatch, capsys):
    assert torch_cli._render_top(SNAPSHOT, NODES) == \
        jax_cli._render_top(SNAPSHOT, NODES)
    monkeypatch.setattr(time, "time", lambda: 10.0)
    assert torch_cli._render_serve(SIGNALS) == jax_cli._render_serve(SIGNALS)
    assert torch_cli._render_serve({}) == jax_cli._render_serve({})

    import ray_tpu.util.memory as jax_memory
    import ray_tpu_torch.util.memory as torch_memory

    texts = []
    for cli, memory in ((jax_cli, jax_memory), (torch_cli, torch_memory)):
        monkeypatch.setattr(memory, "memory_summary",
                            lambda address=None: SUMMARY)
        args = cli.build_parser().parse_args(
            ["memory", "--devices", "--address", "127.0.0.1:1"])
        args.fn(args)
        texts.append(capsys.readouterr().out)
    assert "HBM (live jax arrays)" in texts[0]
    assert texts[1] == _relabel(texts[0])
    assert "cuda:0:    5700.0 MB live (291 arrays)" in texts[1]


class _FakeCuda:
    """torch.cuda's allocator and device queries at fixed values."""

    def install(self, monkeypatch):
        values = {
            "is_initialized": lambda: True,
            "device_count": lambda: 1,
            "current_device": lambda: 0,
            "memory_allocated": lambda i=0: 123_456_789,
            "memory_reserved": lambda i=0: 200_000_000,
            "max_memory_reserved": lambda i=0: 300_000_000,
            "memory_stats": lambda i=0: {"allocation.all.current": 42},
            "mem_get_info": lambda i=0: (1_000, 85_000_000_000),
            "get_device_name": lambda i=0: "NVIDIA H100 80GB HBM3",
        }
        for name, fn in values.items():
            monkeypatch.setattr(torch.cuda, name, fn)


def test_device_memory_is_empty_without_cuda():
    from ray_tpu_torch.util import memory

    assert not torch.cuda.is_initialized()
    assert memory.device_memory() == []
    assert not torch.cuda.is_initialized()


@pytest.fixture(scope="module")
def runtime():
    rt.init(num_cpus=4)
    yield rt
    rt.shutdown()


def _wait_for(fn, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(0.2)
    raise TimeoutError("condition not met")


def test_memory_accounting_and_cli_on_the_live_gcs(runtime, monkeypatch,
                                                   capsys):
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.train import StepProfiler
    from ray_tpu_torch.util import memory, metrics

    _FakeCuda().install(monkeypatch)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3")
    ref = rt.put(np.zeros(100_000, dtype=np.uint8))
    sample = memory.sample_once()
    assert sample == [{
        "device": "cuda:3", "kind": "NVIDIA H100 80GB HBM3",
        "live_bytes": 123_456_789, "live_arrays": 42,
        "bytes_in_use": 200_000_000, "peak_bytes_in_use": 300_000_000,
        "bytes_limit": 85_000_000_000}]
    prof = StepProfiler(ring=8, rank=0)
    for _ in range(3):
        with prof.step(tokens=16):
            with prof.phase("compute"):
                time.sleep(0.002)
    metrics._flush_once()

    addr = worker_mod._global_node.gcs_address
    parser = torch_cli.build_parser()

    def gauges_visible():
        args = parser.parse_args(["memory", "--devices", "--address", addr])
        args.fn(args)
        out = capsys.readouterr().out
        return out if "cuda:3" in out else None

    out = _wait_for(gauges_visible)
    node = worker_mod.get_client().node_id.hex()[:12]
    assert "HBM (live torch tensors): 123.5 MB across 1 sampled device(s)" \
        in out
    assert (f"node {node} cuda:3:     123.5 MB live (42 arrays)  in_use "
            "200.0 MB / limit 85000.0 MB (0%)") in out
    assert "object store" in out
    summary = memory.memory_summary(address=addr)
    assert summary["hbm_live_bytes"] == 123_456_789
    assert summary["objects"]["bytes"] >= 100_000

    args = parser.parse_args(["top", "--address", addr])
    args.fn(args)
    top = capsys.readouterr().out
    assert "1/1 nodes alive" in top
    assert "rank 0: 3 steps" in top
    assert f"hbm {node} cuda:3: 123.5 MB live" in top
    del ref


def test_rt_serve_renders_a_running_apps_signals(runtime, capsys):
    from ray_tpu_torch import serve

    @serve.deployment(num_replicas=1,
                      slo={"e2e_ms": 30_000.0, "objective": 0.99})
    def echo(x=0):
        return x * 2

    try:
        handle = serve.run(echo.bind(), name="echo")
        acme = handle.options(tenant="acme")
        for i in range(4):
            assert rt.get(acme.remote(i), timeout=60) == i * 2

        def published():
            doc = torch_cli._fetch_serve_signals(None)
            app = (doc or {}).get("apps", {}).get("echo") or {}
            tenant = app.get("tenants", {}).get("acme", {})
            return doc if tenant.get("requests", 0) >= 4 else None

        doc = _wait_for(published, timeout=40)
        from ray_tpu_torch._private import worker as worker_mod

        args = torch_cli.build_parser().parse_args(
            ["serve", "--address", worker_mod._global_node.gcs_address])
        args.fn(args)
        out = capsys.readouterr().out
        assert out.startswith("serve signals  seq=")
        assert "app echo: qps=" in out and " replicas=1/1" in out
        assert "  tenant acme: req=4" in out
        assert torch_cli._render_serve(doc).splitlines()[1:] == \
            jax_cli._render_serve(doc).splitlines()[1:]
    finally:
        serve.shutdown()
