"""The port's memory monitor: the cases of tests/test_oom.py run against
ray_tpu_torch. Under memory pressure the raylet kills the newest
retriable task, which retries, before any task that cannot retry."""

import time

import ray_tpu_torch as rt
from ray_tpu_torch.cluster_utils import Cluster


def test_oom_kills_newest_retriable_and_task_retries():
    cluster = Cluster()
    head = cluster.add_node(num_cpus=2)
    cluster.connect()
    try:
        fake = {"frac": 0.5}
        head._memory_usage_fraction = lambda: fake["frac"]

        @rt.remote(max_retries=3)
        def hog():
            time.sleep(1.0)
            return "survived"

        ref = hog.remote()
        time.sleep(0.4)  # task is inflight
        fake["frac"] = 0.99  # cross the threshold: monitor must kill
        time.sleep(0.8)
        fake["frac"] = 0.5   # pressure gone: retry can complete

        assert rt.get(ref, timeout=60) == "survived"
        # The kill is surfaced in the task-event stream for the state API.
        events = [e for e in head._task_events] + [
            e for e in cluster.gcs.task_events
        ]
        assert any(e.get("state") == "OOM_KILLED" for e in events), (
            "no OOM_KILLED task event recorded"
        )
    finally:
        cluster.shutdown()


def test_oom_prefers_retriable_over_nonretriable():
    cluster = Cluster()
    head = cluster.add_node(num_cpus=2)
    cluster.connect()
    try:
        fake = {"frac": 0.5}
        head._memory_usage_fraction = lambda: fake["frac"]

        @rt.remote(max_retries=0)
        def precious():
            time.sleep(2.5)
            return "precious"

        @rt.remote(max_retries=3)
        def expendable():
            time.sleep(2.5)
            return "expendable"

        p_ref = precious.remote()
        time.sleep(0.3)
        e_ref = expendable.remote()  # newer AND retriable: the victim
        time.sleep(0.5)
        fake["frac"] = 0.99
        # Drop pressure as soon as the first kill lands: under SUSTAINED
        # pressure the policy correctly escalates to non-retriable tasks
        # once no retriable candidates remain.
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            seen = list(head._task_events) + list(cluster.gcs.task_events)
            if any(e.get("state") == "OOM_KILLED" for e in seen):
                break
            time.sleep(0.05)
        fake["frac"] = 0.5

        # The non-retriable task must NOT have been chosen while a
        # retriable candidate existed.
        assert rt.get(p_ref, timeout=60) == "precious"
        assert rt.get(e_ref, timeout=60) == "expendable"  # retried
        events = [e for e in head._task_events] + [
            e for e in cluster.gcs.task_events
        ]
        oom = [e for e in events if e.get("state") == "OOM_KILLED"]
        assert oom, "monitor never fired"
        assert all(e.get("name") != "precious" for e in oom)
    finally:
        cluster.shutdown()
