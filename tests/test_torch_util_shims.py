"""The port's small utilities (`util.multiprocessing`, `util.joblib`,
`util.iter`, `util.queue`) on its runtime: the counterparts of
tests/test_workflow_and_shims.py:95-126, and `Queue`'s semantics (FIFO,
Empty, Full, timeouts, sizes) held against the JAX package's Queue,
which runs the same script in a subprocess."""

import json
import os
import pathlib
import subprocess
import sys
import time

import pytest

import ray_tpu_torch as rt

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def runtime():
    rt.init(num_cpus=4)
    yield rt
    rt.shutdown()


def _sq(x):
    return x * x


def test_multiprocessing_pool(runtime):
    from ray_tpu_torch.util.multiprocessing import Pool

    with Pool(processes=2) as pool:
        assert pool.map(_sq, range(10)) == [x * x for x in range(10)]
        assert pool.apply(_sq, (7,)) == 49
        ar = pool.apply_async(_sq, (8,))
        assert ar.get(timeout=30) == 64
        assert ar.ready() and ar.successful()
        assert pool.starmap(pow, [(2, 3), (3, 2)]) == [8, 9]
        assert list(pool.imap(_sq, [3, 1, 2])) == [9, 1, 4]
        assert sorted(pool.imap_unordered(_sq, [1, 2, 3])) == [1, 4, 9]
        pool.close()
        with pytest.raises(ValueError):
            pool.apply(_sq, (1,))


def test_joblib_backend(runtime):
    import joblib

    from ray_tpu_torch.util.joblib import register_rt

    register_rt()
    with joblib.parallel_backend("rt"):
        out = joblib.Parallel(n_jobs=2)(
            joblib.delayed(_sq)(i) for i in range(8))
    assert out == [i * i for i in range(8)]
    with joblib.parallel_backend("rt"):
        assert joblib.Parallel(n_jobs=-1)(
            joblib.delayed(_sq)(i) for i in range(3)) == [0, 1, 4]


def test_parallel_iterator(runtime):
    from ray_tpu_torch.util import iter as rt_iter

    it = rt_iter.from_range(10, num_shards=3)
    assert it.num_shards() == 3
    out = it.for_each(lambda x: x * 2).filter(lambda x: x % 4 == 0) \
        .gather_sync()
    assert sorted(out) == [0, 4, 8, 12, 16]
    for shard in it._shards:  # each shard actor holds a CPU
        rt.kill(shard)
    it = rt_iter.from_items(list("abcdef"), num_shards=2)
    batches = it.flat_map(lambda c: [c, c.upper()]).batch(2).gather_sync()
    assert batches == [["a", "A"], ["b", "B"], ["c", "C"],
                       ["d", "D"], ["e", "E"], ["f", "F"]]
    for shard in it._shards:
        rt.kill(shard)


QUEUE_SCRIPT = r'''
import importlib, json, os, sys, time
pkg = sys.argv[1]
if pkg == "ray_tpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["RT_TPU_CHIPS"] = "0"
    import jax
    jax.config.update("jax_platforms", "cpu")
rt = importlib.import_module(pkg)
queue = importlib.import_module(pkg + ".util.queue")
rt.init(num_cpus=2)
out = []
try:
    q = queue.Queue(maxsize=2)
    out.append(["empty", q.empty(), q.qsize(), q.full()])
    q.put("a")
    q.put_nowait({"b": [1, 2]})
    out.append(["full", q.full(), q.qsize()])
    try:
        q.put_nowait("c")
    except queue.Full:
        out.append(["Full", "put_nowait"])
    t0 = time.monotonic()
    try:
        q.put("c", timeout=0.3)
    except queue.Full:
        out.append(["Full", "timeout", time.monotonic() - t0 >= 0.3])
    out.append(["get", q.get(), q.get_nowait()])
    try:
        q.get_nowait()
    except queue.Empty:
        out.append(["Empty", "get_nowait"])
    t0 = time.monotonic()
    try:
        q.get(timeout=0.3)
    except queue.Empty:
        out.append(["Empty", "timeout", time.monotonic() - t0 >= 0.3])

    @rt.remote
    def producer(q, n):
        for i in range(n):
            q.put(i)
        return n

    ref = producer.remote(q, 5)
    got = [q.get(timeout=30) for _ in range(5)]
    out.append(["across tasks", got, rt.get(ref)])
    q.shutdown()
finally:
    rt.shutdown()
print("RESULT " + json.dumps(out))
'''


def _queue_run(tmp_path, pkg):
    script = tmp_path / "queue_driver.py"
    script.write_text(QUEUE_SCRIPT)
    env = dict(os.environ, TMPDIR=str(tmp_path))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in [str(ROOT), env.get("PYTHONPATH", "")] if p)
    proc = subprocess.run([sys.executable, str(script), pkg], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    assert line, proc.stdout[-4000:]
    return json.loads(line[-1][len("RESULT "):])


def test_queue_semantics_match_the_jax_package(tmp_path):
    ref = _queue_run(tmp_path, "ray_tpu")
    out = _queue_run(tmp_path, "ray_tpu_torch")
    assert out == ref
    assert out == [
        ["empty", True, 0, False], ["full", True, 2],
        ["Full", "put_nowait"], ["Full", "timeout", True],
        ["get", "a", {"b": [1, 2]}], ["Empty", "get_nowait"],
        ["Empty", "timeout", True], ["across tasks", [0, 1, 2, 3, 4], 5]]


def test_queue_in_the_runtime(runtime):
    from ray_tpu_torch.util.queue import Empty, Queue

    q = Queue()
    t0 = time.monotonic()
    with pytest.raises(Empty):
        q.get(timeout=0.2)
    assert time.monotonic() - t0 >= 0.2
    for i in range(50):
        q.put(i)
    assert q.qsize() == 50
    assert [q.get() for _ in range(50)] == list(range(50))
    q.shutdown()
