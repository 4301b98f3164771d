"""The port's control-plane profiler: the cases of
tests/test_control_plane_profiler.py run against ray_tpu_torch. Sampled
tasks carry a `sampled` bit that every hop honors (client serialize and
submit buffer, raylet queue and dispatch, worker fetch, deserialize,
exec and store); the stitched per-phase breakdown sums to about the
submit-to-complete wall; the GCS counts every RPC per method on both
sides; sampling off emits nothing."""

import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.util import lifecycle, profiling, tracing


@pytest.fixture
def rt_start():
    """A real single-node runtime of the port."""
    import ray_tpu_torch as rt

    rt.init(num_cpus=4)
    yield rt
    rt.shutdown()


@pytest.fixture
def rt_cluster():
    """Multi-raylet cluster harness of the port."""
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster()
    yield cluster
    cluster.shutdown()


def _wait_for(fn, timeout=30.0, poll=0.25):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(poll)
    raise TimeoutError("condition not met")


@pytest.fixture(autouse=True)
def _profiler_off_after():
    yield
    lifecycle.set_sample_rate(0.0)
    tracing.disable()


def _state_client():
    from ray_tpu_torch.util.state.api import StateApiClient

    return StateApiClient()


def _lifecycle_events():
    c = _state_client()
    try:
        return [e for e in c.task_events(warn=False)
                if e.get("type") == "LIFECYCLE_SPAN"]
    finally:
        c.close()


# -- stitcher / aggregator units (no runtime needed) ---------------------


def test_stitch_joins_hops_and_aggregate_shapes():
    tid = b"\x01" * 16
    events = [
        lifecycle.event(tid, "f()", b"", b"n1", "client",
                        {"serialize": [10.0, 0.001],
                         "submit_buffer": [10.001, 0.002]}, e2e_s=0.010),
        lifecycle.event(tid, "", b"", b"n1", "raylet",
                        {"queue_wait": [10.003, 0.003],
                         "dispatch": [10.006, 0.001]}),
        lifecycle.event(tid, "", b"", b"n1", "worker",
                        {"exec": [10.007, 0.002]}),
    ]
    recs = lifecycle.stitch(events)
    assert list(recs) == [tid.hex()]
    rec = recs[tid.hex()]
    assert set(rec["hops"]) == {"client", "raylet", "worker"}
    assert rec["name"] == "f()"
    assert abs(sum(rec["phases"].values()) - 0.009) < 1e-9
    assert abs(lifecycle.coverage(rec) - 0.9) < 1e-9
    agg = lifecycle.aggregate(recs)
    for phase in ("serialize", "queue_wait", "exec", "e2e", "coverage"):
        assert agg[phase]["count"] == 1
    assert agg["exec"]["p50_us"] == pytest.approx(2000.0)


def test_sample_rate_clamps_and_gates():
    lifecycle.set_sample_rate(2.0)
    assert lifecycle.get_sample_rate() == 1.0
    assert lifecycle.enabled and lifecycle.sample()
    lifecycle.set_sample_rate(0.0)
    assert not lifecycle.enabled


# -- end-to-end sampling --------------------------------------------------


def test_rate_zero_emits_no_lifecycle_events(rt_start):
    assert not lifecycle.enabled  # default off

    @rt.remote
    def f(x):
        return x + 1

    assert rt.get([f.remote(i) for i in range(20)], timeout=120) == list(
        range(1, 21)
    )
    profiling.flush()
    time.sleep(1.2)  # let worker/raylet event buffers drain
    assert _lifecycle_events() == []


def test_phases_cover_e2e_wall(rt_start):
    @rt.remote
    def work(x):
        time.sleep(0.02)
        return x

    # Warm the worker pool unsampled so sampled tasks measure a steady
    # state dispatch, not a worker cold start.
    rt.get([work.remote(i) for i in range(4)], timeout=120)

    lifecycle.set_sample_rate(1.0)
    # Serial round-trips: burst submissions complete batch-granular (an
    # early task's e2e spans its successors' exec), so the coverage
    # contract holds per round-trip, matching how bench_scale measures.
    for i in range(6):
        assert rt.get(work.remote(i), timeout=120) == i
    lifecycle.set_sample_rate(0.0)
    profiling.flush()

    def stitched():
        recs = lifecycle.stitch(_lifecycle_events())
        full = {
            k: r for k, r in recs.items()
            if r["e2e_s"] and "worker" in r["hops"] and "exec" in r["phases"]
        }
        return full or None

    recs = _wait_for(stitched)
    rec = next(iter(recs.values()))
    assert "client" in rec["hops"]
    assert rec["phases"]["exec"] >= 0.019
    cov = lifecycle.coverage(rec)
    # Leaf phases explain most of the wall and never (meaningfully)
    # exceed it — the phase marks are disjoint intervals inside e2e.
    assert 0.5 < cov < 1.25, (cov, rec)


def test_actor_calls_carry_the_sampled_bit(rt_start):
    @rt.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def bump(self):
            self.n += 1
            time.sleep(0.01)
            return self.n

    a = Counter.remote()
    rt.get(a.bump.remote(), timeout=120)  # unsampled warmup
    lifecycle.set_sample_rate(1.0)
    assert rt.get(a.bump.remote(), timeout=120) == 2
    lifecycle.set_sample_rate(0.0)
    profiling.flush()

    def actor_span():
        for k, r in lifecycle.stitch(_lifecycle_events()).items():
            if r["name"] == "bump()" and "exec" in r["phases"]:
                return r
        return None

    rec = _wait_for(actor_span)
    assert rec["phases"]["exec"] >= 0.009
    assert "worker" in rec["hops"] and "client" in rec["hops"]


def test_sampled_bit_propagates_across_two_nodes(rt_cluster):
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    cluster = rt_cluster
    n1 = cluster.add_node(num_cpus=2)
    n2 = cluster.add_node(num_cpus=2)
    cluster.connect()

    @rt.remote
    def where():
        import os

        return os.environ["RT_NODE_ID"]

    def on(node):
        return where.options(scheduling_strategy=(
            NodeAffinitySchedulingStrategy(node_id=node.node_id.binary())
        ))

    # Warm both nodes unsampled, then pin sampled tasks to each node.
    rt.get([on(n1).remote(), on(n2).remote()], timeout=120)
    lifecycle.set_sample_rate(1.0)
    nodes = {rt.get(on(n).remote(), timeout=120) for n in (n1, n2)}
    lifecycle.set_sample_rate(0.0)
    assert nodes == {n1.node_id.hex(), n2.node_id.hex()}
    profiling.flush()

    def worker_hop_nodes():
        seen = set()
        for ev in _lifecycle_events():
            if (ev.get("extra") or {}).get("hop") == "worker":
                seen.add(bytes(ev["node_id"]))
        return seen if len(seen) >= 2 else None

    # Worker-hop spans arrive from BOTH nodes: the bit rode the spec
    # across the wire and remote workers stamped their phases.
    assert len(_wait_for(worker_hop_nodes)) >= 2


def test_profile_config_flips_sampling_at_runtime(rt_start):
    assert lifecycle.get_sample_rate() == 0.0
    c = _state_client()
    try:
        r = c.call("set_profile_config", {"task_trace_sample": 0.5})
        assert r["profile_config"]["task_trace_sample"] == 0.5
        # The GCS publishes to every subscribed client (this driver
        # included) — no reconnect, no env var.
        _wait_for(lambda: lifecycle.get_sample_rate() == 0.5, timeout=10)
        c.call("set_profile_config", {"task_trace_sample": 0.0})
        _wait_for(lambda: lifecycle.get_sample_rate() == 0.0, timeout=10)
    finally:
        c.close()


# -- GCS RPC accounting ---------------------------------------------------


def test_gcs_rpc_counters_move_on_actor_create(rt_start):
    from ray_tpu_torch._private import worker as worker_mod

    c = _state_client()
    try:
        before = dict(c.call("gcs_stats").get("rpc_counts") or {})

        @rt.remote
        class A:
            def ping(self):
                return "pong"

        a = A.remote()
        assert rt.get(a.ping.remote(), timeout=120) == "pong"

        stats = c.call("gcs_stats")
        after = stats.get("rpc_counts") or {}
        assert after.get("register_actor", 0) > before.get(
            "register_actor", 0
        )
        # Server-side latency histogram: every counted method has a
        # consistent bucket sum.
        lat = stats.get("rpc_latency") or {}
        assert "register_actor" in lat
        st = lat["register_actor"]
        assert st["count"] >= 1
        assert sum(st["buckets"]) == st["count"]
        assert st["sum_s"] >= 0.0 and st["max_s"] >= 0.0
        assert len(st["buckets"]) == len(
            stats["rpc_latency_boundaries"]
        ) + 1
    finally:
        c.close()

    # Client-side chokepoint accounting on the driver's own GCS calls.
    client = worker_mod.get_client()
    assert client.gcs_rpc_counts.get("register_actor", 0) >= 1
    assert client.gcs_rpc_time_s.get("register_actor", 0.0) >= 0.0


def test_metrics_snapshot_exports_rpc_and_scheduler_series(rt_start):
    @rt.remote
    def f():
        return 1

    assert rt.get([f.remote() for _ in range(8)], timeout=120) == [1] * 8

    c = _state_client()
    try:
        def series():
            names = {m["name"] for m in
                     c.call("metrics_snapshot")["metrics"]}
            want = {"gcs_rpc_calls_total", "gcs_rpc_server_seconds",
                    "rt_raylet_dispatch_passes_total"}
            return want <= names and names
        names = _wait_for(series)
        snapshot = c.call("metrics_snapshot")["metrics"]
    finally:
        c.close()
    rpc = next(m for m in snapshot if m["name"] == "gcs_rpc_calls_total")
    assert rpc["type"] == "counter"
    assert any(val > 0 for _tags, val in rpc["series"])
    hist = next(m for m in snapshot if m["name"] == "gcs_rpc_server_seconds")
    assert hist["type"] == "histogram"
    _tags, payload = hist["series"][0]
    assert payload["count"] == sum(payload["buckets"])


# -- task-event pagination ------------------------------------------------


def test_list_task_events_paginates_without_truncation(rt_start):
    from ray_tpu_torch.util.state.api import fetch_task_events

    c = _state_client()
    try:
        total0 = c.call("list_task_events",
                        {"offset": 0, "limit": 1})["total"]
        events = [
            {"task_id": i.to_bytes(4, "big"), "name": f"ev{i}",
             "job_id": b"", "node_id": b"t", "type": "NORMAL_TASK",
             "state": "FINISHED", "ts": float(i)}
            for i in range(250)
        ]
        c.call("add_task_events", {"events": events})
        r = c.call("list_task_events", {"offset": 0, "limit": 100})
        assert r["total"] >= total0 + 250
        assert len(r["events"]) == 100
        assert r["dropped"] == 0
        # Offset pages tile the ring exactly, no overlap and no holes.
        fetched = fetch_task_events(c.call, page=64, warn=False)
        assert len(fetched) >= r["total"]
        names = [e["name"] for e in fetched if str(e.get("name", ""))
                 .startswith("ev")]
        assert names == [f"ev{i}" for i in range(250)]
        # Legacy no-offset call still answers with the tail slice.
        legacy = c.call("list_task_events", {"limit": 10})
        assert len(legacy["events"]) == 10
        assert legacy["events"][-1]["name"] == "ev249"
    finally:
        c.close()


# -- batched trace flush --------------------------------------------------


def test_trace_spans_batch_into_few_rpcs(rt_start):
    """50 spans inside one flush window ride ~1 add_task_events RPC
    (the old per-span force-flush cost 50)."""
    c = _state_client()
    try:
        profiling.flush()  # drain anything pending before measuring
        time.sleep(0.1)
        before = (c.call("gcs_stats").get("rpc_counts") or {}).get(
            "add_task_events", 0
        )
        tracing.enable()
        for i in range(50):
            with tracing.span(f"s{i}"):
                pass
        tracing.disable()
        # Wait out the bounded-delay window (default 0.25s) plus slack.
        time.sleep(1.0)
        after = (c.call("gcs_stats").get("rpc_counts") or {}).get(
            "add_task_events", 0
        )
    finally:
        c.close()
    delta = after - before
    assert 1 <= delta <= 3, delta
    ev = _state_client()
    try:
        names = {e.get("name") for e in ev.task_events(warn=False)}
    finally:
        ev.close()
    assert {"s0", "s49"} <= names


# -- serve request span tree ----------------------------------------------


def test_serve_request_joins_span_tree(rt_start):
    from ray_tpu_torch import serve

    @serve.deployment
    class Echo:
        def __call__(self, x):
            return {"echo": x}

    try:
        handle = serve.run(Echo.bind())
        assert rt.get(handle.remote("warm"), timeout=60) == {"echo": "warm"}

        tracing.enable()
        with tracing.span("serve-request"):
            ctx = tracing.current()
            assert rt.get(handle.remote("hi"), timeout=60) == {"echo": "hi"}
        tracing.disable()
        profiling.flush()

        def tree():
            spans = tracing.get_trace(ctx["trace_id"])
            by_name = {s["name"]: s for s in spans}
            serve_spans = [s for n, s in by_name.items()
                           if n.startswith("serve.Echo.")]
            if "serve-request" in by_name and serve_spans:
                return by_name, serve_spans
            return None

        by_name, serve_spans = _wait_for(tree)
        # The replica's execution span hangs off the caller's request
        # span: handle.remote() injected the active context and the
        # replica activated it.
        assert serve_spans[0]["parent_id"] == \
            by_name["serve-request"]["span_id"]
        assert serve_spans[0]["kind"] == "task"
    finally:
        serve.shutdown()
