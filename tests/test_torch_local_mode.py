"""Local (in-process) mode tests of the port — reference:
ray.init(local_mode=True). tests/test_local_mode.py run against
ray_tpu_torch."""

import pytest

from ray_tpu_torch.exceptions import TaskError


@pytest.fixture
def rt_local():
    import ray_tpu_torch as rt

    rt.init(local_mode=True)
    yield rt
    rt.shutdown()


def test_local_task(rt_local):
    rt = rt_local

    @rt.remote
    def mul(a, b):
        return a * b

    assert rt.get(mul.remote(6, 7)) == 42


def test_local_actor(rt_local):
    rt = rt_local

    @rt.remote
    class Acc:
        def __init__(self):
            self.n = 0

        def add(self, x):
            self.n += x
            return self.n

    a = Acc.remote()
    a.add.remote(1)
    assert rt.get(a.add.remote(2)) == 3


def test_local_error(rt_local):
    rt = rt_local

    @rt.remote
    def bad():
        raise KeyError("nope")

    with pytest.raises(TaskError):
        rt.get(bad.remote())


def test_local_put_get(rt_local):
    rt = rt_local
    ref = rt.put([1, 2, 3])
    assert rt.get(ref) == [1, 2, 3]


def test_local_dynamic_generator(rt_local):
    """num_returns='dynamic' works in local mode: iteration yields item
    refs (regression: returned a bare ObjectRef, dropping later items)."""
    rt = rt_local

    @rt.remote(num_returns="dynamic")
    def gen(n):
        for i in range(n):
            yield i * 10

    out = [rt.get(ref) for ref in gen.remote(3)]
    assert out == [0, 10, 20]

    @rt.remote(num_returns="dynamic")
    def boom():
        raise ValueError("nope")
        yield  # pragma: no cover — makes it a generator

    import pytest as _pytest

    # Real-path semantics: the error raises FROM ITERATION after any
    # produced items (here: none).
    with _pytest.raises(Exception, match="nope"):
        list(boom.remote())

    @rt.remote(num_returns="dynamic")
    def partial():
        yield 1
        raise ValueError("late")

    gen = partial.remote()
    assert rt.get(next(gen)) == 1
    with _pytest.raises(Exception, match="late"):
        next(gen)
