"""Faults of the runtime that the port repairs (the JAX package keeps
them; ROADMAP §C, "Fixed"; R4 is in test_torch_spill_uri.py):

- R1: a frame of several calls to one actor was answered once, when its
  slowest call ended. Each call is now answered when it ends.
- R2: a killed actor's worker was returned to the pool while threads the
  actor started ran on. The worker now refuses to be recycled, so its
  process ends, while such a thread is alive; a thread-free actor's
  worker is still reused.
- R3: removing a placement group credited its bundles to the GCS's view
  at once, before the raylet freed the card a worker still held, so
  `available_resources()` read GPU 1.0, then 0.0, then 1.0. The view now
  rises once.
- R5: the GCS did not answer `actor_unplaceable`, so an actor a raylet
  bounced stayed PENDING for good. It is queued again now.
- R6: a task that ran on a leased worker (every task of a burst after
  the first that shares a lease key) recorded no task events, so
  `list_tasks`, `summarize_tasks` and the timeline showed only the first.
  The worker now records RUNNING and FINISHED or FAILED for each.
- R7: a value read from the store that is not weakref-able (a dict or a
  list of arrays, as an RL rollout is) held its pin until the session
  ended, so every such result stayed in the store: PPO's 113 MB
  rollouts filled a 2 GiB store in five iterations and a restore then
  failed ("nothing left to spill"). Each out-of-band buffer is now
  exported through an object whose lifetime holds the pin (PEP 688), so
  the pin goes with the last array, whatever held it.

Run as a script, it prints the actor call's round trip and a 2000-call
burst on the runtime that PYTHONPATH selects, so a commit and its parent
can be timed in turns on one host. Run it from a directory that holds
no package: `python -m` puts the working directory first on the path of
every worker the runtime spawns.

    cd /tmp && PYTHONPATH=<checkout> python <repo>/tests/test_torch_runtime_repairs.py
"""

import os
import threading
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.util.scheduling_strategies import (
    PlacementGroupSchedulingStrategy,
)
from ray_tpu_torch.util.placement_group import (
    placement_group,
    remove_placement_group,
)


@pytest.fixture(scope="module")
def runtime():
    rt.init(num_cpus=4, num_gpus=1)  # one faked card
    yield rt
    rt.shutdown()


@pytest.mark.parametrize("kind", ["threaded", "ordered"])
def test_a_fast_call_is_answered_before_a_slow_one_of_its_burst(runtime,
                                                                kind):
    @rt.remote
    class Calls:
        def slow(self):
            time.sleep(2.0)
            return "slow"

        def fast(self):
            return "fast"

    opts = {"max_concurrency": 2} if kind == "threaded" else {}
    a = Calls.options(**opts).remote()
    assert rt.get(a.fast.remote(), timeout=60) == "fast"
    for _ in range(2):
        # One burst: the client sends it as frames of several calls, the
        # slow one among fast ones (an ordered actor runs them in turn,
        # so there the fast calls come first).
        t0 = time.monotonic()
        fast = [a.fast.remote() for _ in range(10)]
        slow = a.slow.remote()
        if kind == "threaded":
            fast += [a.fast.remote() for _ in range(10)]
        assert rt.get(fast, timeout=30) == ["fast"] * len(fast)
        fast_s = time.monotonic() - t0
        assert rt.get(slow, timeout=30) == "slow"
        assert fast_s < 0.5, f"the fast calls took {fast_s:.2f} s"
    rt.kill(a)


def test_a_killed_actors_thread_stops_and_thread_free_workers_are_reused(
        runtime, tmp_path):
    @rt.remote
    class Ticker:
        def start(self, path):
            def tick():
                while True:
                    with open(path, "a") as f:
                        f.write("x")
                    time.sleep(0.02)

            threading.Thread(target=tick, daemon=True).start()
            return os.getpid()

    @rt.remote
    class Plain:
        def pid(self):
            return os.getpid()

    path = str(tmp_path / "ticks")
    t = Ticker.remote()
    rt.get(t.start.remote(path), timeout=60)
    time.sleep(0.2)
    rt.kill(t)
    time.sleep(1.0)
    size = os.path.getsize(path)
    time.sleep(0.5)
    assert os.path.getsize(path) == size, "the killed actor's thread ran on"

    p = Plain.remote()
    pid = rt.get(p.pid.remote(), timeout=60)
    rt.kill(p)
    deadline = time.monotonic() + 30
    reused = False
    while time.monotonic() < deadline and not reused:
        q = Plain.remote()
        reused = rt.get(q.pid.remote(), timeout=60) == pid
        rt.kill(q)
    assert reused, "a thread-free actor's worker was not reused"


def test_the_gpu_reading_rises_once_after_a_group_is_removed(runtime):
    @rt.remote
    class Holder:
        def hold(self, s):
            time.sleep(s)
            return True

    def gpu():
        return rt.available_resources().get("GPU", 0.0)

    deadline = time.monotonic() + 30
    while gpu() < 1.0 and time.monotonic() < deadline:
        time.sleep(0.05)
    pg = placement_group([{"CPU": 1, "GPU": 1}])
    assert pg.ready(timeout=30)
    h = Holder.options(
        num_gpus=1, num_cpus=1,
        scheduling_strategy=PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=0)).remote()
    assert rt.get(h.hold.remote(0.0), timeout=60)
    h.hold.remote(5.0)  # the worker holds the card while the group goes
    time.sleep(0.7)  # a heartbeat has shown the card held
    remove_placement_group(pg)
    readings = []
    start = time.monotonic()
    killed = False
    while time.monotonic() < start + 3.0:
        readings.append(gpu())
        if not killed and time.monotonic() > start + 1.0:
            rt.kill(h)  # the worker ends, heartbeats after the removal
            killed = True
        time.sleep(0.05)
    risen = [i for i, r in enumerate(readings) if r >= 1.0]
    assert risen, f"the GPU never came back: {readings}"
    after = readings[risen[0]:]
    assert min(after) >= 1.0, f"the GPU reading fell back: {readings}"


def test_the_gcs_takes_back_an_actor_a_raylet_could_not_place(runtime):
    """A raylet that finds the CPUs an actor was placed on held by leases
    bounces it to the GCS (`actor_unplaceable`), which must queue it
    again. The handler existed but was never registered, so the raylet's
    call failed ("no such method") and the actor stayed PENDING for good;
    a burst of leased tasks followed by actor creations met it."""
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.util.state.api import StateApiClient

    @rt.remote(resources={"nowhere": 1})
    class Unplaced:
        pass

    a = Unplaced.remote()
    client = StateApiClient(worker_mod._global_node.gcs_address)
    try:
        node = client.call("get_nodes")["nodes"][0]["node_id"]
        reply = client.call("actor_unplaceable", {
            "actor_id": a._actor_id.binary(), "node_id": node})
        state = [x["state"] for x in client.call("list_actors")["actors"]
                 if x["actor_id"] == a._actor_id.binary()]
    finally:
        client.close()
    assert reply == {"ok": True}
    assert state == ["PENDING"]
    rt.kill(a)


def test_every_task_of_a_leased_burst_is_listed(runtime):
    from ray_tpu_torch.util import state

    @rt.remote
    def leased_ok(i):
        return i

    @rt.remote(max_retries=0)
    def leased_bad():
        raise ValueError("leased failure")

    # One at a time, the first takes the lease and the rest run on it
    # (run_task_direct); the failure shares the lease key. Then a burst
    # on the held lease travels as batch frames (run_tasks_batch).
    n = 24
    assert [rt.get(leased_ok.remote(i)) for i in range(n)] == list(range(n))
    with pytest.raises(Exception, match="leased failure"):
        rt.get(leased_bad.remote())
    assert rt.get([leased_ok.remote(i) for i in range(n, 2 * n)]) \
        == list(range(n, 2 * n))

    def seen():
        tasks = [t for t in state.list_tasks(limit=100_000)
                 if t["name"].endswith(("leased_ok", "leased_bad"))]
        return ({(t["name"].rsplit(".", 1)[-1], t["type"], t["state"])
                 for t in tasks}, len(tasks), tasks)

    deadline = time.monotonic() + 30
    while True:
        kinds, count, tasks = seen()
        if count == 2 * n + 1 or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    assert count == 2 * n + 1, tasks
    assert kinds == {("leased_ok", "NORMAL_TASK", "FINISHED"),
                     ("leased_bad", "NORMAL_TASK", "FAILED")}
    assert all("duration_s" in t for t in tasks)
    summary = {k.rsplit(".", 1)[-1]: v
               for k, v in state.summarize_tasks().items()}
    assert summary["leased_ok"] == {"FINISHED": 2 * n}
    assert summary["leased_bad"] == {"FAILED": 1}


def test_a_dict_of_arrays_read_from_the_store_lets_its_object_go(runtime):
    """Twelve 64 MiB results, each a dict holding its array, through the
    256 MiB store: each is read, checked and dropped. With the pin held
    for the session, the fifth no longer fits and nothing can be spilled;
    now each is evicted or spilled once its array is gone. A view kept
    alive keeps its object readable."""
    import gc

    import numpy as np

    @rt.remote
    class Rollouts:
        def sample(self, i):
            return {"obs": np.full(16 * 2**20, float(i), np.float32),
                    "step": i}

    r = Rollouts.remote()
    try:
        kept = None
        for i in range(12):
            out = rt.get(r.sample.remote(i), timeout=120)
            assert out["step"] == i and float(out["obs"][-1]) == i
            if i == 3:
                kept = out["obs"][:4]
            del out
            gc.collect()
        assert kept.tolist() == [3.0] * 4
    finally:
        rt.kill(r)


def main():
    """The actor path R1 changed, on the runtime that PYTHONPATH selects:
    the no-op actor call's round trip (median of 300) and a burst of 2000
    ordered calls (median of 5), on the host's clock."""
    import json
    import statistics

    rt.init(num_cpus=4)
    try:
        @rt.remote
        class Echo:
            def f(self, x=None):
                return x

        a = Echo.remote()
        rt.get(a.f.remote())
        trips, bursts = [], []
        for _ in range(300):
            t0 = time.perf_counter()
            rt.get(a.f.remote())
            trips.append(time.perf_counter() - t0)
        for _ in range(5):
            t0 = time.perf_counter()
            rt.get([a.f.remote(i) for i in range(2000)])
            bursts.append(time.perf_counter() - t0)
        print(json.dumps({"runtime": os.path.dirname(rt.__file__),
                          "actor_round_trip_p50_us":
                          statistics.median(trips) * 1e6,
                          "burst_2000_ms": statistics.median(bursts) * 1e3,
                          "burst_2000_ms_all": [b * 1e3 for b in bursts]}))
    finally:
        rt.shutdown()


if __name__ == "__main__":
    main()
