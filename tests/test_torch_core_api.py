"""Core task/actor/object API tests against the port's real multiprocess
runtime: tests/test_core_api.py run against ray_tpu_torch.

Modeled on the reference's python/ray/tests/test_basic*.py and
test_actor.py coverage.
"""

import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.exceptions import ActorDiedError, GetTimeoutError, TaskError


pytestmark = pytest.mark.usefixtures("rt_start")


@pytest.fixture
def rt_start():
    """A real single-node runtime: in-process GCS+raylet, subprocess workers."""
    rt.init(num_cpus=4)
    yield rt
    rt.shutdown()


def test_put_get_roundtrip():
    ref = rt.put({"a": 1, "arr": np.arange(10)})
    out = rt.get(ref)
    assert out["a"] == 1
    assert np.array_equal(out["arr"], np.arange(10))


def test_simple_task():
    @rt.remote
    def add(a, b):
        return a + b

    assert rt.get(add.remote(1, 2)) == 3


def test_task_with_large_result():
    @rt.remote
    def big():
        return np.ones((1000, 1000))

    out = rt.get(big.remote())
    assert out.shape == (1000, 1000)
    assert out[0, 0] == 1.0


def test_task_chain_ref_args():
    @rt.remote
    def inc(x):
        return x + 1

    ref = inc.remote(0)
    for _ in range(5):
        ref = inc.remote(ref)
    assert rt.get(ref) == 6


def test_task_chain_large_intermediate():
    @rt.remote
    def double(x):
        return x * 2

    ref = double.remote(np.ones(200_000))
    ref = double.remote(ref)
    out = rt.get(ref)
    assert out[0] == 4.0


def test_parallel_tasks():
    @rt.remote
    def sq(i):
        return i * i

    refs = [sq.remote(i) for i in range(20)]
    assert rt.get(refs) == [i * i for i in range(20)]


def test_task_error_propagates():
    @rt.remote
    def boom():
        raise ValueError("bad value")

    with pytest.raises(TaskError) as ei:
        rt.get(boom.remote())
    assert "bad value" in str(ei.value)
    assert ei.value.cause_cls_name == "ValueError"


def test_num_returns():
    @rt.remote(num_returns=3)
    def three():
        return 1, 2, 3

    a, b, c = three.remote()
    assert rt.get([a, b, c]) == [1, 2, 3]


def test_wait():
    @rt.remote
    def fast():
        return "fast"

    @rt.remote
    def slow():
        time.sleep(20)
        return "slow"

    f, s = fast.remote(), slow.remote()
    ready, pending = rt.wait([f, s], num_returns=1, timeout=15)
    assert ready == [f]
    assert pending == [s]


def test_get_timeout():
    @rt.remote
    def sleepy():
        time.sleep(10)

    with pytest.raises(GetTimeoutError):
        rt.get(sleepy.remote(), timeout=0.3)


def test_nested_refs_in_args():
    @rt.remote
    def make():
        return np.arange(1000)

    @rt.remote
    def consume(refs):
        return sum(rt.get(r)[0] for r in refs)

    refs = [make.remote() for _ in range(3)]
    assert rt.get(consume.remote(refs)) == 0


def test_nested_task_submission():
    @rt.remote
    def outer():
        @rt.remote
        def inner(x):
            return x * 10

        return rt.get(inner.remote(4))

    assert rt.get(outer.remote()) == 40


def test_basic_actor():
    @rt.remote
    class Counter:
        def __init__(self, start=0):
            self.n = start

        def inc(self, by=1):
            self.n += by
            return self.n

        def value(self):
            return self.n

    c = Counter.remote(10)
    assert rt.get(c.inc.remote()) == 11
    assert rt.get(c.inc.remote(5)) == 16
    assert rt.get(c.value.remote()) == 16


def test_actor_call_ordering():
    @rt.remote
    class Appender:
        def __init__(self):
            self.items = []

        def add(self, x):
            self.items.append(x)

        def items_list(self):
            return self.items

    a = Appender.remote()
    for i in range(50):
        a.add.remote(i)
    assert rt.get(a.items_list.remote()) == list(range(50))


def test_actor_error_propagates():
    @rt.remote
    class Bad:
        def fail(self):
            raise RuntimeError("actor oops")

    b = Bad.remote()
    with pytest.raises(TaskError) as ei:
        rt.get(b.fail.remote())
    assert "actor oops" in str(ei.value)


def test_named_actor():
    @rt.remote
    class Registry:
        def __init__(self):
            self.d = {}

        def set(self, k, v):
            self.d[k] = v

        def get(self, k):
            return self.d.get(k)

    Registry.options(name="reg").remote()
    h = rt.get_actor("reg")
    rt.get(h.set.remote("k", 42))
    assert rt.get(h.get.remote("k")) == 42


def test_kill_actor():
    @rt.remote
    class Victim:
        def ping(self):
            return "pong"

    v = Victim.remote()
    assert rt.get(v.ping.remote()) == "pong"
    rt.kill(v)
    time.sleep(0.5)
    with pytest.raises((ActorDiedError, Exception)):
        rt.get(v.ping.remote(), timeout=10)


def test_actor_handle_passed_to_task():
    @rt.remote
    class Store:
        def __init__(self):
            self.v = None

        def set(self, v):
            self.v = v

        def get(self):
            return self.v

    @rt.remote
    def writer(handle, value):
        rt.get(handle.set.remote(value))
        return True

    s = Store.remote()
    assert rt.get(writer.remote(s, 123))
    assert rt.get(s.get.remote()) == 123


def test_cluster_resources():
    res = rt.cluster_resources()
    assert res.get("CPU") == 4.0


def test_runtime_context():
    ctx = rt.get_runtime_context()
    assert ctx.worker_mode == "driver"
    assert ctx.node_id is not None


def test_task_inside_actor():
    @rt.remote
    def helper(x):
        return x + 1

    @rt.remote
    class Orchestrator:
        def run(self):
            return rt.get(helper.remote(41))

    o = Orchestrator.remote()
    assert rt.get(o.run.remote()) == 42


def test_dynamic_generator_task_streams_items():
    """num_returns="dynamic": a generator task's item refs become
    consumable WHILE the task is still yielding (reference:
    ObjectRefGenerator / streaming generators)."""
    import numpy as np

    @rt.remote
    def produce(n):
        for i in range(n):
            time.sleep(0.15)
            yield np.full(4, i, dtype=np.float64)

    gen = produce.options(num_returns="dynamic").remote(5)
    assert isinstance(gen, rt.ObjectRefGenerator)
    arrivals = []
    values = []
    for ref in gen:
        arrivals.append(time.monotonic())
        values.append(rt.get(ref, timeout=30))
    assert len(values) == 5
    for i, v in enumerate(values):
        assert v[0] == float(i)
    # Streaming proof: items arrived SPREAD over the generator's ~0.75s
    # of yields, not in one burst at completion (first-to-last arrival
    # spans most of the runtime).
    spread = arrivals[-1] - arrivals[0]
    assert spread > 0.4, f"not streaming: all items within {spread:.2f}s"


def test_dynamic_generator_non_generator_value():
    @rt.remote
    def single():
        return 42

    gen = single.options(num_returns="dynamic").remote()
    vals = [rt.get(r, timeout=30) for r in gen]
    assert vals == [42]


def test_dynamic_generator_error_propagates():
    @rt.remote(max_retries=0)
    def explode():
        yield 1
        raise RuntimeError("mid-stream failure")

    gen = explode.options(num_returns="dynamic").remote()
    with pytest.raises(Exception, match="mid-stream failure"):
        for ref in gen:
            rt.get(ref, timeout=30)


def test_dynamic_generator_actor_method():
    """Generator ACTOR methods stream items too (reference: streaming
    generator actor calls — the Serve token-streaming substrate)."""

    @rt.remote
    class Streamer:
        def tokens(self, n):
            for i in range(n):
                yield f"tok-{i}"

    s = Streamer.remote()
    gen = s.tokens.options(num_returns="dynamic").remote(4)
    assert isinstance(gen, rt.ObjectRefGenerator)
    out = [rt.get(r, timeout=30) for r in gen]
    assert out == ["tok-0", "tok-1", "tok-2", "tok-3"]


@pytest.mark.slow
def test_max_calls_retires_worker(rt_start):
    """@rt.remote(max_calls=N): the worker process exits after N
    executions and the pool replaces it — tasks keep completing on fresh
    pids (reference: remote_function.py max_calls leak mitigation)."""
    import os as _os

    @rt.remote(max_calls=3)
    def pid():
        import os

        return os.getpid()

    # Serialize calls so the per-worker counter is deterministic.
    pids = [rt.get(pid.remote(), timeout=120) for _ in range(9)]
    # Every worker served at most 3 calls.
    from collections import Counter

    counts = Counter(pids)
    assert all(c <= 3 for c in counts.values()), counts
    assert len(counts) >= 3  # at least three generations of workers
    # And an unlimited function on the same cluster is unaffected.
    @rt.remote
    def pid2():
        import os

        return os.getpid()

    pids2 = {rt.get(pid2.remote(), timeout=120) for _ in range(4)}
    assert len(pids2) >= 1
