"""The port's DAGs and channels (ray_tpu_torch.dag,
ray_tpu_torch.experimental.channel): the cases of tests/test_dag.py run
against the port's runtime, and one set of DAGs run by a driver script
under each package (the harness of test_torch_serve_api.py), whose
outputs must be equal.

Values cross a channel pickled, as in the JAX package: a CPU tensor reads
back as an equal CPU tensor, and no segment outlives teardown().
"""

import os
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.dag import InputNode, MultiOutputNode
from ray_tpu_torch.experimental.channel import Channel, ChannelClosed
from tests.test_torch_serve_api import PRELUDE, run_driver

torch.set_num_threads(1)


@pytest.fixture
def rt_start():
    rt.init(num_cpus=4)
    yield rt
    rt.shutdown()


def _segments():
    return {f for f in os.listdir("/dev/shm") if f.startswith("rtchan_")}


def test_channel_roundtrip():
    ch = Channel(create=True, max_size=1_000_000)
    try:
        ch.write({"x": 1})
        assert ch.read() == {"x": 1}
        ch.write([1, 2, 3])
        assert ch.read() == [1, 2, 3]
        with pytest.raises(ValueError):
            ch.write(b"x" * 2_000_000)
        ch.close()
        with pytest.raises(ChannelClosed):
            ch.write(1)
    finally:
        ch.destroy()
    assert ch.name not in _segments()


def test_cpu_tensor_through_a_channel_reads_back_equal():
    """A CPU tensor (and a bf16 one, and a view) crosses a channel by
    pickle and reads back as an equal CPU tensor of the same dtype."""
    ch = Channel(create=True, max_size=1_000_000)
    reader = Channel(name=ch.name)  # attached by name, as a stage does
    try:
        x = torch.arange(24, dtype=torch.float32).reshape(4, 6)
        for value in (x, x.to(torch.bfloat16), x[:, 1:3]):
            ch.write(value)
            got = reader.read()
            assert isinstance(got, torch.Tensor)
            assert got.device.type == "cpu" and got.dtype == value.dtype
            assert torch.equal(got, value)
    finally:
        reader.detach()
        ch.destroy()


def test_eager_task_dag(rt_start):
    @rt.remote
    def double(x):
        return 2 * x

    @rt.remote
    def add(a, b):
        return a + b

    with InputNode() as inp:
        dag = add.bind(double.bind(inp), double.bind(inp))
    assert dag.execute(5) == 20
    assert dag.execute(7) == 28


def test_eager_actor_dag(rt_start):
    @rt.remote
    class Acc:
        def __init__(self):
            self.total = 0

        def add(self, x):
            self.total += x
            return self.total

    acc = Acc.remote()
    with InputNode() as inp:
        dag = acc.add.bind(inp)
    assert dag.execute(3) == 3
    assert dag.execute(4) == 7


def test_compiled_chain(rt_start):
    @rt.remote
    class Stage:
        def __init__(self, mul):
            self.mul = mul

        def fwd(self, x):
            return x * self.mul

    s1, s2 = Stage.remote(2), Stage.remote(10)
    with InputNode() as inp:
        dag = s2.fwd.bind(s1.fwd.bind(inp))
    compiled = dag.experimental_compile()
    names = {c.name for c in compiled._channels}
    try:
        assert names <= _segments()
        for i in range(10):
            assert compiled.execute(i) == i * 20
    finally:
        compiled.teardown()
    assert not names & _segments()


def test_compiled_fan_out_fan_in(rt_start):
    @rt.remote
    class Worker:
        def sq(self, x):
            return x * x

        def neg(self, x):
            return -x

    a, b = Worker.remote(), Worker.remote()
    with InputNode() as inp:
        dag = MultiOutputNode([a.sq.bind(inp), b.neg.bind(inp)])
    compiled = dag.experimental_compile()
    try:
        assert compiled.execute(4) == [16, -4]
        assert compiled.execute(5) == [25, -5]
    finally:
        compiled.teardown()


def test_compiled_error_propagates(rt_start):
    @rt.remote
    class Boomer:
        def go(self, x):
            if x == 13:
                raise ValueError("unlucky")
            return x

        def fwd(self, x):
            return x

    actor = Boomer.remote()
    with InputNode() as inp:
        dag = actor.fwd.bind(actor.go.bind(inp))
    compiled = dag.experimental_compile()
    try:
        assert compiled.execute(1) == 1
        with pytest.raises(rt.exceptions.TaskError):
            compiled.execute(13)
        assert compiled.execute(2) == 2
    finally:
        compiled.teardown()


def test_compiled_throughput_faster_than_actor_calls(rt_start):
    @rt.remote
    class Echo:
        def fwd(self, x):
            return x

    actor = Echo.remote()
    rt.get(actor.fwd.remote(0))

    n = 200
    t0 = time.perf_counter()
    for i in range(n):
        rt.get(actor.fwd.remote(i))
    eager_s = time.perf_counter() - t0

    with InputNode() as inp:
        dag = actor.fwd.bind(inp)
    compiled = dag.experimental_compile()
    try:
        compiled.execute(0)
        t0 = time.perf_counter()
        for i in range(n):
            assert compiled.execute(i) == i
        compiled_s = time.perf_counter() - t0
    finally:
        compiled.teardown()
    assert compiled_s < eager_s, (compiled_s, eager_s)


def test_compiled_stage_runs_beside_actor_calls(rt_start):
    """A resident loop and ordinary calls share one actor: both reach
    its state, serialized by the actor's lock."""
    @rt.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def bump(self, x):
            self.n += x
            return self.n

        def read(self):
            return self.n

    c = Counter.remote()
    with InputNode() as inp:
        dag = c.bump.bind(inp)
    compiled = dag.experimental_compile()
    try:
        assert [compiled.execute(1) for _ in range(5)] == [1, 2, 3, 4, 5]
        assert rt.get(c.read.remote(), timeout=30) == 5
        assert rt.get(c.bump.remote(10), timeout=30) == 15
        assert compiled.execute(1) == 16
    finally:
        compiled.teardown()


# -- one set of DAGs under both packages ---------------------------------------
DRIVER = PRELUDE + r'''
dag = importlib.import_module(pkg + ".dag")
InputNode, MultiOutputNode = dag.InputNode, dag.MultiOutputNode


@rt.remote
def double(x):
    return 2 * x


@rt.remote
def add(a, b):
    return a + b


@rt.remote
class Stage:
    def __init__(self, scale):
        self.scale = scale
        self.calls = 0

    def norm(self, x):
        """A row-wise RMS normalisation of a float32 array."""
        self.calls += 1
        x = np.asarray(x, dtype=np.float32)
        r = 1.0 / np.sqrt((x * x).mean(axis=-1, keepdims=True) + 1e-6)
        return (x * r * self.scale).astype(np.float32)

    def checksum(self, x):
        return [float(np.asarray(x, dtype=np.float64).sum()),
                list(np.asarray(x).shape)]

    def count(self):
        return self.calls

    def boom(self, x):
        if np.asarray(x).min() < -100:
            raise ValueError("negative input")
        return x


rt.init(num_cpus=4)
out = {}
try:
    with InputNode() as inp:
        eager = add.bind(double.bind(inp), double.bind(inp))
    out["eager_tasks"] = [eager.execute(5), eager.execute(7)]

    a, b = Stage.remote(2.0), Stage.remote(0.5)
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((8, 64)).astype(np.float32) for _ in range(5)]
    with InputNode() as inp:
        chain = b.checksum.bind(a.norm.bind(inp))
    out["eager_chain"] = [chain.execute(x) for x in xs[:2]]
    compiled = chain.experimental_compile()
    try:
        out["compiled_chain"] = [compiled.execute(x) for x in xs]
    finally:
        compiled.teardown()

    with InputNode() as inp:
        fan = MultiOutputNode([a.norm.bind(inp), b.norm.bind(inp)])
    compiled = fan.experimental_compile()
    try:
        outs = [compiled.execute(x) for x in xs[:2]]
        out["fan_out"] = [[o.round(6).tolist() for o in pair]
                          for pair in outs]
    finally:
        compiled.teardown()

    with InputNode() as inp:
        guarded = b.checksum.bind(a.boom.bind(inp))
    compiled = guarded.experimental_compile()
    try:
        seq = [compiled.execute(xs[0])]
        try:
            compiled.execute(xs[1] - 1000)
            seq.append("no error")
        except exc.TaskError as e:
            seq.append(["TaskError", "negative input" in str(e)])
        seq.append(compiled.execute(xs[2]))
        out["error_then_continue"] = seq
    finally:
        compiled.teardown()
    out["norm_calls"] = rt.get(a.count.remote(), timeout=30)
    out["segments_left"] = [f for f in os.listdir("/dev/shm")
                            if f.startswith("rtchan_")
                            and f in {c.name for c in compiled._channels}]
finally:
    rt.shutdown()
print("RESULT " + json.dumps(out, sort_keys=True))
'''


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dag")
    return [run_driver(tmp, DRIVER, pkg, timeout=240)
            for pkg in ("ray_tpu", "ray_tpu_torch")]


@pytest.mark.parametrize("name", ["eager_tasks", "eager_chain",
                                  "compiled_chain", "fan_out",
                                  "error_then_continue", "norm_calls",
                                  "segments_left"])
def test_same_dags_give_the_same_outputs_on_both_runtimes(both, name):
    jax_out, port_out = both
    assert port_out[name] == jax_out[name]
    if name == "eager_tasks":
        assert port_out[name] == [20, 28]
    if name == "norm_calls":
        assert port_out[name] == 2 + 5 + 2  # eager, compiled, fan-out
    if name == "segments_left":
        assert port_out[name] == []
    if name == "error_then_continue":
        assert port_out[name][1] == ["TaskError", True]
