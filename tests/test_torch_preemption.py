"""Priority preemption and graceful card reclamation in the port: the
cases of tests/test_preemption.py run against ray_tpu_torch, with the
card as the `GPU` resource where the JAX package's cases reserve `TPU`
chips (gcs.py `_maybe_preempt` counts the GPUs of a gang; "chips" in
the cases' text are cards). The partial-reclamation case, which the JAX
package keeps in tests/test_elastic_gang.py, has its counterpart in
test_torch_cluster.py. Markers are the JAX cases' (`chaos`)."""

import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._private import chaos
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util.placement_group import (
    PlacementGroupConfig,
    placement_group,
    remove_placement_group,
)
from ray_tpu_torch.util.scheduling_strategies import PlacementGroupSchedulingStrategy


@pytest.fixture
def rt_cluster():
    """Multi-raylet cluster harness of the port."""
    cluster = Cluster()
    yield cluster
    cluster.shutdown()


def _wait_for(pred, timeout=10.0, interval=0.05, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {what}")


# -- priority plumbing ------------------------------------------------------


def test_priority_carried_on_pg_and_actor(rt_cluster):
    cluster = rt_cluster
    cluster.add_node(num_cpus=4)
    cluster.connect()

    pg = PlacementGroupConfig(
        bundles=[{"CPU": 1}], name="tier2", priority=2
    ).create()
    assert pg.ready(timeout=10)
    gpg = cluster.gcs.placement_groups[pg.id.binary()]
    assert gpg["priority"] == 2
    assert gpg["name"] == "tier2"
    assert gpg["seq"] > 0

    @rt.remote(priority=7, num_cpus=1)
    class A:
        def ping(self):
            return "ok"

    a = A.options(name="prio-actor").remote()
    assert rt.get(a.ping.remote(), timeout=30) == "ok"
    ga = cluster.gcs.actors[a._actor_id.binary()]
    assert ga["priority"] == 7
    remove_placement_group(pg)


def test_high_priority_task_dispatched_first(rt_cluster):
    """With one CPU held by a blocker, a later-submitted high-priority
    task must clear the raylet queue before the earlier low-priority one
    (dispatch walks scheduling classes priority-descending)."""
    cluster = rt_cluster
    cluster.add_node(num_cpus=1)
    cluster.connect()

    @rt.remote(num_cpus=1)
    def blocker():
        time.sleep(1.2)
        return "held"

    @rt.remote(num_cpus=1)
    def stamp(tag):
        return (tag, time.monotonic())

    b = blocker.remote()
    time.sleep(0.4)  # let the blocker actually hold the CPU
    low = stamp.options(priority=0).remote("low")
    high = stamp.options(priority=5).remote("high")
    assert rt.get(b, timeout=60) == "held"
    (_, t_low), (_, t_high) = rt.get([low, high], timeout=60)
    assert t_high < t_low, "high-priority task ran after the low one"


# -- reclamation ------------------------------------------------------------


def test_reclamation_graceful_release(rt_cluster):
    """Infeasible high-priority demand drains the low-priority gang;
    when the victim hands its group back the claimant places on the
    freed (fenced) chips and the node un-cordons."""
    cluster = rt_cluster
    cluster.add_node(num_cpus=2)  # head: CPU only, never preempted
    worker = cluster.add_node(num_cpus=2, num_gpus=4)
    cluster.connect()
    wid = worker.node_id.binary()

    low = placement_group([{"GPU": 4}], name="train-low", priority=0)
    assert low.ready(timeout=10)

    high = placement_group([{"GPU": 4}], name="serve-spike", priority=5)
    _wait_for(
        lambda: cluster.gcs.preemptions.get(low.id.binary()) is not None,
        timeout=10, what="preemption record",
    )
    rec = cluster.gcs.preemptions[low.id.binary()]
    assert rec["state"] == "draining"
    assert rec["reason"] == "priority"
    assert rec["victim_tenant"] == "train-low"
    assert rec["claimant_tenant"] == "serve-spike"
    node_info = cluster.gcs.nodes[wid]
    assert node_info.get("draining") is True
    assert node_info.get("fenced_for") == high.id.binary()
    # The fence blocks everyone but the claimant: a third-party group
    # must not steal the chips mid-handover.
    interloper = placement_group([{"GPU": 4}], name="interloper", priority=1)
    assert not interloper.ready(timeout=1.0)

    # Victim completes its graceful exit (checkpoint done -> group freed).
    remove_placement_group(low)
    assert high.ready(timeout=10)
    assert rec["state"] == "released"
    assert rec["outcome"] == "graceful"
    _wait_for(
        lambda: not cluster.gcs.nodes[wid].get("draining"),
        timeout=5, what="node un-drain",
    )
    assert cluster.gcs.nodes[wid].get("fenced_for") is None
    assert cluster.gcs.preempt_counts.get(
        (("reason", "priority"), ("tenant", "train-low"))
    ) == 1.0
    # The grace histogram observed the drain-to-release window.
    assert cluster.gcs.preempt_grace["count"] == 1
    remove_placement_group(high)
    remove_placement_group(interloper)


def test_equal_priority_never_preempts(rt_cluster):
    """Reclamation only crosses strict priority boundaries: an equal-
    priority pending group waits instead of evicting."""
    cluster = rt_cluster
    cluster.add_node(num_cpus=2)
    cluster.add_node(num_cpus=2, num_gpus=4)
    cluster.connect()

    first = placement_group([{"GPU": 4}], name="first", priority=3)
    assert first.ready(timeout=10)
    second = placement_group([{"GPU": 4}], name="second", priority=3)
    assert not second.ready(timeout=1.5)
    assert cluster.gcs.preemptions == {}
    remove_placement_group(first)
    remove_placement_group(second)


def test_hard_kill_deadline(rt_cluster, monkeypatch):
    """A victim that ignores the drain is hard-killed at the grace
    deadline: its actors die, its group is force-removed, and the
    claimant places — the deadline is the guarantee."""
    monkeypatch.setattr(get_config(), "preempt_grace_s", 1.0)
    cluster = rt_cluster
    cluster.add_node(num_cpus=2)
    cluster.add_node(num_cpus=2, num_gpus=4)
    cluster.connect()

    low = placement_group([{"GPU": 4}], name="deaf-gang", priority=0)
    assert low.ready(timeout=10)

    @rt.remote(num_cpus=0, resources={"GPU": 1})
    class Deaf:
        def ping(self):
            return "ok"

    a = Deaf.options(
        scheduling_strategy=PlacementGroupSchedulingStrategy(
            placement_group=low, placement_group_bundle_index=0
        )
    ).remote()
    assert rt.get(a.ping.remote(), timeout=30) == "ok"

    t0 = time.monotonic()
    high = placement_group([{"GPU": 4}], name="spike", priority=9)
    assert high.ready(timeout=15)
    took = time.monotonic() - t0
    rec = cluster.gcs.preemptions[low.id.binary()]
    assert rec["outcome"] == "hard_kill"
    assert took >= 0.9, "hard kill fired before the grace window elapsed"
    assert cluster.gcs.placement_groups[low.id.binary()]["state"] == "REMOVED"
    _wait_for(
        lambda: cluster.gcs.actors[a._actor_id.binary()]["state"] == "DEAD",
        timeout=10, what="victim actor death",
    )
    assert cluster.gcs.preempt_counts.get(
        (("reason", "hard_kill"), ("tenant", "deaf-gang"))
    ) == 1.0
    remove_placement_group(high)


def test_claimant_withdrawal_cancels_preemption(rt_cluster, monkeypatch):
    """If the claimant gives up while victims drain, the eviction is
    cancelled: nodes un-cordon and the victim keeps its chips."""
    monkeypatch.setattr(get_config(), "preempt_grace_s", 30.0)
    cluster = rt_cluster
    cluster.add_node(num_cpus=2)
    worker = cluster.add_node(num_cpus=2, num_gpus=4)
    cluster.connect()
    wid = worker.node_id.binary()

    low = placement_group([{"GPU": 4}], name="steady", priority=0)
    assert low.ready(timeout=10)
    high = placement_group([{"GPU": 4}], name="flash-spike", priority=5)
    _wait_for(
        lambda: cluster.gcs.preemptions.get(low.id.binary()) is not None,
        timeout=10, what="preemption record",
    )
    remove_placement_group(high)  # spike subsides before the victim moved
    _wait_for(
        lambda: cluster.gcs.preemptions[low.id.binary()]["state"]
        == "released",
        timeout=5, what="cancelled record",
    )
    rec = cluster.gcs.preemptions[low.id.binary()]
    assert rec["outcome"] == "cancelled"
    _wait_for(
        lambda: not cluster.gcs.nodes[wid].get("draining")
        and cluster.gcs.nodes[wid].get("fenced_for") is None,
        timeout=5, what="node restored",
    )
    assert cluster.gcs.placement_groups[low.id.binary()]["state"] == "CREATED"
    remove_placement_group(low)


def test_preempt_metrics_in_snapshot(rt_cluster):
    """preempt_total / preempt_grace_seconds / preempt_active /
    tenant_chip_occupancy appear as synthetic series in the GCS metrics
    snapshot (the autoscaler/dashboard feed)."""
    cluster = rt_cluster
    cluster.add_node(num_cpus=2)
    cluster.add_node(num_cpus=2, num_gpus=4)
    client = cluster.connect()

    low = placement_group([{"GPU": 4}], name="tenant-a", priority=0)
    assert low.ready(timeout=10)
    high = placement_group([{"GPU": 4}], name="tenant-b", priority=5)
    _wait_for(
        lambda: cluster.gcs.preemptions.get(low.id.binary()) is not None,
        timeout=10, what="preemption record",
    )
    snap = client._run(client._gcs_call("metrics_snapshot", {}))["metrics"]
    by_name = {m["name"]: m for m in snap}
    assert by_name["preempt_active"]["series"][0][1] == 1
    tags = dict(
        tuple(t) for t in by_name["preempt_total"]["series"][0][0]
    )
    assert tags == {"reason": "priority", "tenant": "tenant-a"}
    occ = {
        dict(tuple(t) for t in tags_)["tenant"]: v
        for tags_, v in by_name["tenant_chip_occupancy"]["series"]
    }
    assert occ.get("tenant-a") == 4.0
    remove_placement_group(low)
    assert high.ready(timeout=10)
    snap = client._run(client._gcs_call("metrics_snapshot", {}))["metrics"]
    by_name = {m["name"]: m for m in snap}
    assert by_name["preempt_grace_seconds"]["series"][0][1]["count"] == 1
    remove_placement_group(high)


def test_actor_never_oversubscribes_reserved_chips(rt_cluster):
    """A plain actor demanding chips a placement group has reserved stays
    PENDING — node availability must never go negative (regression: the
    GCS used to place actors by node *totals* and the raylet force-
    acquired, double-booking pg-reserved chips and silently bypassing
    the whole preemption plane)."""
    cluster = rt_cluster
    cluster.add_node(num_cpus=2)
    worker = cluster.add_node(num_cpus=2, num_gpus=4)
    cluster.connect()

    holder = placement_group([{"GPU": 4}], name="holder", priority=5)
    assert holder.ready(timeout=10)

    @rt.remote(num_cpus=0, resources={"GPU": 4})
    class Chip:
        def ping(self):
            return "ok"

    a = Chip.remote()  # lower priority than the holder: waits, no evict
    deadline = time.monotonic() + 1.5
    wid = worker.node_id.binary()
    while time.monotonic() < deadline:
        avail = cluster.gcs.nodes[wid]["resources_available"]
        assert avail.get("GPU", 0) >= 0, "chip availability went negative"
        time.sleep(0.05)
    assert cluster.gcs.actors[a._actor_id.binary()]["state"] == "PENDING"
    assert cluster.gcs.preemptions == {}
    remove_placement_group(holder)
    assert rt.get(a.ping.remote(), timeout=30) == "ok"


def test_pending_actor_claimant_preempts_gang(rt_cluster):
    """A high-priority pending ACTOR — no placement group of its own —
    is a reclamation claimant too (this is the serve-replica spike path:
    ray_actor_options={"resources": {"GPU": n}, "priority": p})."""
    cluster = rt_cluster
    cluster.add_node(num_cpus=2)
    cluster.add_node(num_cpus=2, num_gpus=4)
    cluster.connect()

    low = placement_group([{"GPU": 4}], name="train-low", priority=0)
    assert low.ready(timeout=10)

    @rt.remote(num_cpus=0, resources={"GPU": 4}, priority=9)
    class Spike:
        def ping(self):
            return "ok"

    a = Spike.remote()
    _wait_for(
        lambda: cluster.gcs.preemptions.get(low.id.binary()) is not None,
        timeout=10, what="actor-claimant preemption record",
    )
    rec = cluster.gcs.preemptions[low.id.binary()]
    assert rec["claimant"] == a._actor_id.binary()
    assert rec["reason"] == "priority"
    remove_placement_group(low)  # victim releases gracefully
    assert rt.get(a.ping.remote(), timeout=30) == "ok"
    assert rec["outcome"] == "graceful"


# -- raylet bundle accounting (regression) ----------------------------------


def test_cancel_bundle_no_oversubscription(rt_cluster):
    """Removing a placement group while a task still runs inside it must
    credit only the bundle's unused share; the running task's share
    returns on completion (raylet.py cancel_bundle + release fall-through
    pairing). The old behavior credited the full reservation, transiently
    oversubscribing the node."""
    cluster = rt_cluster
    node = cluster.add_node(num_cpus=2)
    cluster.connect()

    pg = placement_group([{"CPU": 2}], strategy="PACK")
    assert pg.ready(timeout=10)

    @rt.remote(num_cpus=1)
    def hold():
        time.sleep(1.5)
        return "done"

    ref = hold.options(
        scheduling_strategy=PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=0
        )
    ).remote()
    # Wait until the task actually holds CPU inside the bundle.
    _wait_for(
        lambda: any(
            b["available"].get("CPU") == 1.0 for b in node.bundles.values()
        ),
        timeout=10, what="task holding bundle CPU",
    )
    remove_placement_group(pg)
    _wait_for(lambda: not node.bundles, timeout=5, what="bundle cancel")
    # Unused share (1 CPU) is back; the running task's 1 CPU is not.
    assert node.resources_available.get("CPU", 0) <= 1.0 + 1e-6
    assert rt.get(ref, timeout=30) == "done"
    _wait_for(
        lambda: abs(node.resources_available.get("CPU", 0) - 2.0) < 1e-6,
        timeout=5, what="full CPU release",
    )


def test_task_errors_fast_when_bundle_removed(rt_cluster):
    """A task already queued behind a busy bundle errors out when the
    bundle is cancelled mid-wait instead of wedging its scheduling class
    (raylet _dispatch_class bundle-vanished path)."""
    cluster = rt_cluster
    cluster.add_node(num_cpus=2)
    cluster.connect()

    pg = placement_group([{"CPU": 1}])
    assert pg.ready(timeout=10)

    @rt.remote(num_cpus=1)
    def hold():
        time.sleep(2.0)
        return "held"

    @rt.remote(num_cpus=1)
    def f():
        return 1

    strat = PlacementGroupSchedulingStrategy(
        placement_group=pg, placement_group_bundle_index=0
    )
    blocker = hold.options(scheduling_strategy=strat).remote()
    time.sleep(0.6)  # blocker holds the bundle; f queues behind it
    queued = f.options(scheduling_strategy=strat).remote()
    time.sleep(0.3)
    remove_placement_group(pg)
    with pytest.raises(Exception, match="bundle was removed"):
        rt.get(queued, timeout=15)
    assert rt.get(blocker, timeout=30) == "held"
    # The node is not wedged: plain tasks still dispatch.
    assert rt.get(f.remote(), timeout=30) == 1


# -- chaos hooks ------------------------------------------------------------


@pytest.mark.chaos
def test_chaos_preempt_node(rt_cluster, monkeypatch):
    monkeypatch.setenv("RT_CHAOS", "1")
    cluster = rt_cluster
    cluster.add_node(num_cpus=2)
    worker = cluster.add_node(num_cpus=2, num_gpus=4)
    cluster.connect()
    wid = worker.node_id.binary()

    pg = placement_group([{"GPU": 4}], name="victim", priority=0)
    assert pg.ready(timeout=10)

    victims = chaos.preempt_node(wid)
    assert victims == [pg.id.hex()]
    assert cluster.gcs.nodes[wid].get("draining") is True
    rec = cluster.gcs.preemptions[pg.id.binary()]
    assert rec["reason"] == "chaos"
    assert rec["claimant"] is None
    remove_placement_group(pg)  # graceful exit closes the record
    assert rec["outcome"] == "graceful"
    # Head node refuses: it cannot drain.
    head_id = cluster.head.node_id.binary()
    with pytest.raises(RuntimeError, match="head node"):
        chaos.preempt_node(head_id)


@pytest.mark.chaos
def test_chaos_kill_victim_mid_drain(rt_cluster, monkeypatch):
    """Compound fault: the victim dies *while* draining. The record
    still converges (here via graceful close when the group is removed;
    the bench exercises the hard-kill convergence)."""
    monkeypatch.setenv("RT_CHAOS", "1")
    monkeypatch.setattr(get_config(), "preempt_grace_s", 30.0)
    cluster = rt_cluster
    cluster.add_node(num_cpus=2)
    worker = cluster.add_node(num_cpus=2, num_gpus=4)
    cluster.connect()

    pg = placement_group([{"GPU": 4}], name="gang", priority=0)
    assert pg.ready(timeout=10)

    @rt.remote(num_cpus=0, resources={"GPU": 1})
    class W:
        def ping(self):
            return "ok"

    a = W.options(
        scheduling_strategy=PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=0
        )
    ).remote()
    assert rt.get(a.ping.remote(), timeout=30) == "ok"

    # No drain in flight yet -> the hook refuses.
    with pytest.raises(RuntimeError, match="no draining victim"):
        chaos.kill_victim_mid_drain()

    chaos.preempt_node(worker.node_id.binary())
    killed = chaos.kill_victim_mid_drain()
    assert killed == a._actor_id.hex()
    _wait_for(
        lambda: cluster.gcs.actors[a._actor_id.binary()]["state"] == "DEAD",
        timeout=10, what="mid-drain victim death",
    )
    remove_placement_group(pg)


def test_chaos_hooks_require_env(monkeypatch):
    monkeypatch.delenv("RT_CHAOS", raising=False)
    with pytest.raises(RuntimeError, match="RT_CHAOS"):
        chaos.preempt_node(b"\x00" * 16)
    with pytest.raises(RuntimeError, match="RT_CHAOS"):
        chaos.kill_victim_mid_drain()


# -- trainer backoff reset --------------------------------------------------


def test_backoff_for_attempt_unit():
    from ray_tpu_torch.train.config import FailureConfig

    fc = FailureConfig(backoff_s=0.5, backoff_max_s=3.0)
    assert fc.backoff_for_attempt(0) == 0.5
    assert fc.backoff_for_attempt(1) == 1.0
    assert fc.backoff_for_attempt(2) == 2.0
    assert fc.backoff_for_attempt(3) == 3.0  # capped
    assert FailureConfig(backoff_s=0).backoff_for_attempt(5) == 0.0


def test_fit_backoff_resets_after_progress(tmp_path, monkeypatch):
    """After an attempt that made progress (new reports/checkpoint), a
    later unrelated failure backs off from backoff_s again — the counter
    tracks consecutive no-progress failures, not total restarts."""
    from ray_tpu_torch.train import trainer as trainer_mod
    from ray_tpu_torch.train.backend_executor import TrainingFailedError
    from ray_tpu_torch.train.config import FailureConfig, RunConfig

    class DummyExecutor:
        def __init__(self, *a, **k):
            pass

        def start(self):
            pass

        def restart(self):
            pass

        def shutdown(self):
            pass

    sleeps = []

    class FakeTime:
        monotonic = staticmethod(time.monotonic)

        @staticmethod
        def sleep(s):
            sleeps.append(round(s, 6))

    monkeypatch.setattr(trainer_mod, "BackendExecutor", DummyExecutor)
    monkeypatch.setattr(trainer_mod, "time", FakeTime)

    attempt_no = {"n": 0}

    def fake_run_attempt(self, executor, manager, checkpoint, trial_dir):
        n = attempt_no["n"]
        attempt_no["n"] += 1
        if n == 1:
            # This attempt trained for a while before dying.
            self._metrics_history.append({"loss": 1.0})
        if n < 3:
            raise TrainingFailedError(f"crash {n}", retryable=True)
        return "ok"

    monkeypatch.setattr(
        trainer_mod.DataParallelTrainer, "_run_attempt", fake_run_attempt
    )
    t = trainer_mod.DataParallelTrainer(
        lambda: None,
        run_config=RunConfig(
            name="backoff-reset",
            storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=3, backoff_s=0.07,
                                         backoff_max_s=10.0),
        ),
    )
    assert t.fit() == "ok"
    # attempt 0 fails cold -> 0.07; attempt 1 made progress -> reset to
    # 0.07; attempt 2 fails cold again -> doubled 0.14. The pre-fix
    # never-resetting counter would have slept [0.07, 0.14, 0.28].
    assert sleeps == [0.07, 0.07, 0.14]
