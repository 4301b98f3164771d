"""The port's durable workflows and virtual actors
(ray_tpu_torch/workflow) on the cases of tests/test_virtual_actor.py (7)
and tests/test_workflow_and_shims.py's workflow cases (5), each asserting
what its JAX counterpart asserts, plus the storage layout shared with
the JAX package: a workflow run or an actor advanced by one package is
read, and an actor continued, by the other.

Both runtimes run in this process (tests/torch_data_util.py); the cases
of the JAX files run the port's tasks.
"""

import multiprocessing
import threading
import time

import pytest

import ray_tpu
import ray_tpu_torch as rt
from ray_tpu import workflow as jax_workflow
from ray_tpu_torch import workflow
from ray_tpu_torch.dag import InputNode
from tests.torch_data_util import both_runtimes


@pytest.fixture(scope="module")
def rt_start():
    with both_runtimes(num_cpus=4):
        yield rt


@workflow.virtual_actor
class Counter:
    def __init__(self, start=0):
        self.value = start

    def add(self, n):
        self.value += n
        return self.value

    def fail_after_mutating(self):
        self.value += 1000
        raise RuntimeError("boom")

    @workflow.readonly
    def get(self):
        return self.value


# The same class under the JAX package's decorator: one storage, two
# packages.
JaxCounter = jax_workflow.virtual_actor(Counter._cls)


# -- tests/test_virtual_actor.py ---------------------------------------------

def test_state_survives_handle_loss(tmp_path):
    storage = str(tmp_path)
    c = Counter.get_or_create("counter-1", start=10, storage=storage)
    assert c.add(5) == 15
    assert c.add(1) == 16
    c2 = Counter.get_or_create("counter-1", storage=storage)
    assert c2.get() == 16
    assert c2.seq == 2


def test_get_or_create_ignores_init_args_when_existing(tmp_path):
    storage = str(tmp_path)
    Counter.get_or_create("c", start=7, storage=storage)
    again = Counter.get_or_create("c", start=999, storage=storage)
    assert again.get() == 7


def test_readonly_does_not_advance_state(tmp_path):
    c = Counter.get_or_create("ro", storage=str(tmp_path))
    before = c.seq
    assert c.get() == 0
    assert c.seq == before


def test_failed_call_is_rolled_back(tmp_path):
    c = Counter.get_or_create("atomic", start=1, storage=str(tmp_path))
    with pytest.raises(RuntimeError, match="boom"):
        c.fail_after_mutating()
    assert c.get() == 1
    assert c.seq == 0


def test_exists(tmp_path):
    storage = str(tmp_path)
    assert not Counter.exists("nope", storage=storage)
    Counter.get_or_create("yep", storage=storage)
    assert Counter.exists("yep", storage=storage)


def _worker_add(storage, n, reps):
    c = Counter.get_or_create("shared", storage=storage)
    for _ in range(reps):
        c.add(n)


def test_cross_process_calls_serialize(tmp_path):
    storage = str(tmp_path)
    Counter.get_or_create("shared", start=0, storage=storage)
    ctx = multiprocessing.get_context("spawn")
    ps = [ctx.Process(target=_worker_add, args=(storage, 1, 10))
          for _ in range(2)]
    for p in ps:
        p.start()
    for p in ps:
        p.join(60)
    assert not any(p.is_alive() for p in ps)
    c = Counter.get_or_create("shared", storage=storage)
    assert c.get() == 20
    assert c.seq == 20


def test_unknown_method_raises(tmp_path):
    c = Counter.get_or_create("m", storage=str(tmp_path))
    with pytest.raises(AttributeError):
        c.not_a_method


@pytest.mark.parametrize("first,then", [(JaxCounter, Counter),
                                        (Counter, JaxCounter)],
                         ids=["jax-then-port", "port-then-jax"])
def test_one_packages_actor_continues_in_the_other(tmp_path, first, then):
    storage = str(tmp_path)
    a = first.get_or_create("both", start=3, storage=storage)
    assert a.add(4) == 7
    b = then.get_or_create("both", start=99, storage=storage)
    assert b.get() == 7 and b.seq == 1
    assert b.add(1) == 8
    assert a.get() == 8 and a.seq == 2


# -- tests/test_workflow_and_shims.py's workflow cases -----------------------

def test_workflow_run_and_resume(rt_start, tmp_path):
    storage = str(tmp_path / "wf")

    @rt.remote
    def ingest(x):
        return list(range(x))

    @rt.remote
    def total(xs):
        return sum(xs)

    @rt.remote
    def must_fail_once(t, flag_path=str(tmp_path / "flag")):
        import os

        if not os.path.exists(flag_path):
            open(flag_path, "w").close()
            raise RuntimeError("transient")
        return t * 10

    with InputNode() as inp:
        dag = must_fail_once.bind(total.bind(ingest.bind(inp)))

    out = workflow.run(dag, 5, workflow_id="wf-1", storage=storage)
    assert out == 100
    assert workflow.get_status("wf-1", storage=storage) == "SUCCEEDED"
    assert workflow.get_output("wf-1", storage=storage) == 100
    assert workflow.resume("wf-1", storage=storage) == 100
    assert any(w["workflow_id"] == "wf-1" for w in workflow.list_all(storage))
    workflow.delete("wf-1", storage=storage)
    assert workflow.get_status("wf-1", storage=storage) is None


def test_workflow_resume_skips_completed_steps(rt_start, tmp_path):
    storage = str(tmp_path / "wf2")
    marker = tmp_path / "count"
    marker.write_text("0")

    @rt.remote
    def counted(x, path=str(marker)):
        n = int(open(path).read()) + 1
        open(path, "w").write(str(n))
        return x + 1

    @rt.remote
    def boom(x, arm_path=str(tmp_path / "armed")):
        import os

        if os.path.exists(arm_path):
            return x * 2
        raise RuntimeError("not armed yet")

    with InputNode() as inp:
        dag = boom.bind(counted.bind(inp))

    with pytest.raises(workflow.WorkflowError):
        workflow.run(dag, 1, workflow_id="wf-2", storage=storage,
                     max_step_retries=0)
    assert workflow.get_status("wf-2", storage=storage) == "FAILED"
    assert marker.read_text() == "1"

    (tmp_path / "armed").write_text("")
    out = workflow.resume("wf-2", storage=storage, max_step_retries=0)
    assert out == 4
    assert marker.read_text() == "1"


def test_workflow_events_signal_and_resume(rt_start, tmp_path):
    @rt.remote
    def combine(a, b):
        return {"approved": a, "value": b}

    ev = workflow.event("approval")
    dag = combine.bind(ev, 42)
    wf_id = "wf-events-1"
    out = {}

    def run():
        out["result"] = workflow.run(dag, workflow_id=wf_id,
                                     storage=str(tmp_path))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        if workflow.get_status(wf_id, storage=str(tmp_path)) == "WAITING":
            break
        time.sleep(0.1)
    assert t.is_alive(), "workflow finished without the event"

    workflow.signal(wf_id, "approval", {"by": "alice"}, storage=str(tmp_path))
    t.join(timeout=60)
    assert not t.is_alive()
    assert out["result"] == {"approved": {"by": "alice"}, "value": 42}

    wf2 = "wf-events-2"
    workflow.signal(wf2, "approval", "pre", storage=str(tmp_path))
    res = workflow.run(combine.bind(workflow.event("approval"), 1),
                       workflow_id=wf2, storage=str(tmp_path))
    assert res == {"approved": "pre", "value": 1}


def test_workflow_event_timeout(rt_start, tmp_path):
    @rt.remote
    def use(x):
        return x

    with pytest.raises(workflow.WorkflowError, match="timed out"):
        workflow.run(use.bind(workflow.event("never", timeout_s=0.5)),
                     workflow_id="wf-timeout", storage=str(tmp_path))


def test_workflow_run_async_and_waiting_output(rt_start, tmp_path):
    @rt.remote
    def slow_double(x):
        import time as _t

        _t.sleep(0.4)
        return x * 2

    wid = workflow.run_async(slow_double.bind(21), workflow_id="async-wf",
                             storage=str(tmp_path))
    assert wid == "async-wf"
    with pytest.raises(workflow.WorkflowError):
        workflow.get_output(wid, storage=str(tmp_path))
    assert workflow.get_output(wid, storage=str(tmp_path), wait=30) == 42
    assert workflow.get_status(wid, storage=str(tmp_path)) == "SUCCEEDED"


# -- one storage layout --------------------------------------------------------

def _run(pkg, wf_mod, dag_mod, storage, wid):
    @pkg.remote
    def double(x):
        return x * 2

    @pkg.remote
    def fail(x):
        raise RuntimeError("stop here")

    with dag_mod.InputNode() as inp:
        wf_mod.run(double.bind(inp), 21, workflow_id=wid, storage=storage)
    with pytest.raises(wf_mod.WorkflowError):
        wf_mod.run(fail.bind(double.bind(5)), workflow_id=wid + "-f",
                   storage=storage, max_step_retries=0)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_one_packages_workflows_read_in_the_other(rt_start, tmp_path, writer):
    """Status, output, the list and a failed run's error as the other
    package wrote them (dag.pkl holds the writer's own DAG nodes, so a
    resume belongs to the package that ran it)."""
    import ray_tpu.dag as jax_dag
    import ray_tpu_torch.dag as torch_dag

    storage = str(tmp_path)
    if writer == "jax":
        _run(ray_tpu, jax_workflow, jax_dag, storage, "w")
        reader = workflow
    else:
        _run(rt, workflow, torch_dag, storage, "w")
        reader = jax_workflow
    assert reader.get_status("w", storage=storage) == "SUCCEEDED"
    assert reader.get_output("w", storage=storage) == 42
    assert reader.get_status("w-f", storage=storage) == "FAILED"
    with pytest.raises(reader.WorkflowError, match="stop here"):
        reader.get_output("w-f", storage=storage)
    assert sorted(s["workflow_id"] for s in reader.list_all(storage)) == \
        ["w", "w-f"]
    assert reader.resume("w", storage=storage) == 42
