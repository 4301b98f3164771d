"""The port's device feed (ray_tpu_torch.data.feed) held against the JAX
package's: tests/test_data_feed.py.

The prefetcher's unit behaviour runs against both packages' modules; the
Dataset wiring runs both runtimes in this process on the same seeded
rows and compares the batches bit for bit. The transfer to the card
itself (pinned copy, the feed's own stream, the event handed to the
consumer's stream) runs only on the card: tests/test_torch_gpu.py.
"""

import gc
import threading
import time

import numpy as np
import pytest

import ray_tpu.data.feed as jax_feed
import ray_tpu_torch.data.feed as torch_feed_mod
from tests.torch_data_util import both_runtimes, same

FEEDS = pytest.mark.parametrize("feed", [jax_feed, torch_feed_mod],
                                ids=["jax", "torch"])


# -- _DevicePrefetcher unit behaviour (no runtime needed) -----------------

@FEEDS
def test_producer_exception_surfaces_at_consumer(feed):
    def src():
        yield 1
        yield 2
        raise ValueError("boom in producer")

    pf = feed._DevicePrefetcher(src, depth=2)
    assert next(pf) == 1
    assert next(pf) == 2
    with pytest.raises(ValueError, match="boom in producer"):
        next(pf)
    with pytest.raises(StopIteration):
        next(pf)
    pf._thread.join(timeout=2.0)
    assert not pf._thread.is_alive()


@FEEDS
def test_stop_joins_thread_and_gc_cleans_up(feed):
    def src():
        yield from range(10_000)

    pf = feed._DevicePrefetcher(src, depth=2)
    assert next(pf) == 0
    thread = pf._thread
    pf.stop()
    assert not thread.is_alive()
    pf.stop()  # idempotent
    with pytest.raises(StopIteration):
        next(pf)
    pf2 = feed._DevicePrefetcher(src, depth=2)
    assert next(pf2) == 0
    thread2 = pf2._thread
    del pf2
    gc.collect()
    thread2.join(timeout=2.0)
    assert not thread2.is_alive()


@FEEDS
def test_prefetch_depth_respected_under_slow_consumer(feed):
    produced = []

    def src():
        for i in range(100):
            produced.append(i)
            yield i

    pf = feed._DevicePrefetcher(src, depth=3)
    try:
        deadline = time.monotonic() + 2.0
        while len(produced) < 4 and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.2)
        # depth ready in the queue + one blocked in put() = depth + 1.
        assert 3 <= len(produced) <= 4, produced
    finally:
        pf.stop()


@FEEDS
def test_transform_runs_producer_side_and_stats_account(feed):
    stats = feed.FeedStats()
    threads = []

    def transform(x):
        threads.append(threading.current_thread().name)
        return x * 10

    pf = feed._DevicePrefetcher(lambda: iter(range(5)), depth=2,
                                transform=transform, stats=stats)
    assert list(pf) == [0, 10, 20, 30, 40]
    assert set(threads) == {"rt-data-feed"}
    snap = stats.snapshot()
    assert snap["batches"] == 5 and snap["h2d_s"] >= 0.0
    assert "feed: 5 batches" in stats.render()


@FEEDS
def test_depth_must_be_positive(feed):
    with pytest.raises(ValueError):
        feed._DevicePrefetcher(lambda: iter([]), depth=0)


def test_deliver_runs_consumer_side():
    """The port's handoff hook: `deliver` runs on the consumer's thread
    for each staged batch (where the consumer's stream takes the card's
    tensors over)."""
    where = []

    def deliver(x):
        where.append(threading.current_thread() is threading.main_thread())
        return x + 1

    pf = torch_feed_mod._DevicePrefetcher(lambda: iter(range(4)), depth=2,
                                          deliver=deliver)
    assert list(pf) == [1, 2, 3, 4] and where == [True] * 4


def test_feed_columns_and_no_fallback():
    """Numeric columns become tensors of their own dtype; a column of
    objects (the rows of an arrow list column) raises; a card that is
    not there raises instead of the feed going on with the CPU."""
    import torch

    (b,) = torch_feed_mod.torch_feed(
        lambda: iter([{"t": np.arange(12, dtype=np.int16).reshape(3, 4)}]),
        device="cpu", prefetch_batches=0)
    assert b["t"].dtype == torch.int16 and b["t"].shape == (3, 4)
    col = np.empty(3, dtype=object)
    for i in range(3):
        col[i] = np.arange(4) + i
    with pytest.raises(TypeError, match="column 't' has dtype object"):
        list(torch_feed_mod.torch_feed(lambda: iter([{"t": col}]),
                                       device="cpu", prefetch_batches=0))
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            torch_feed_mod.torch_feed(lambda: iter([]), device="cuda")


# -- Dataset wiring -------------------------------------------------------

@pytest.fixture(scope="module")
def runtimes():
    with both_runtimes(num_cpus=4):
        yield


def test_pipelined_batches_byte_identical_to_serial(runtimes):
    def pipeline(rt, rd):
        ds = rd.range(100).map(lambda r: {"id": r["id"],
                                          "x": float(r["id"])})
        ds = ds.repartition(5)
        return [list(ds.iter_batches(batch_size=16, prefetch_batches=0)),
                list(ds.iter_batches(batch_size=16, prefetch_batches=3))]

    serial, pipelined = same(pipeline)
    assert serial == pipelined and len(serial) == 7


def test_iter_torch_batches_pipelined_default_and_stats(runtimes):
    """The port's default (prefetch_batches from the config, 2) against
    iter_jax_batches' default: the same batches and the same counts. A
    1-D column from from_numpy travels as Python floats (float64 rows, in
    both packages); JAX without x64 narrows it to float32 on the device,
    so it is compared after that narrowing, and bit for bit with the JAX
    package's iter_torch_batches."""
    import ray_tpu.data as jd
    import ray_tpu_torch.data as td

    x = np.random.default_rng(5).normal(size=64).astype(np.float32)
    jds = jd.from_numpy({"x": x})
    tds = td.from_numpy({"x": x})
    want = [np.asarray(b["x"]) for b in jds.iter_jax_batches(batch_size=16)]
    cpu = [b["x"].numpy() for b in jds.iter_torch_batches(batch_size=16)]
    got = [b["x"].numpy() for b in tds.iter_torch_batches(batch_size=16,
                                                          device="cpu")]
    assert [g.tobytes() for g in got] == [c.tobytes() for c in cpu]
    assert [g.astype(w.dtype).tobytes() for g, w in zip(got, want)] \
        == [w.tobytes() for w in want]
    snap = tds._last_feed_stats.snapshot()
    assert snap["batches"] == 4 == jds._last_feed_stats.snapshot()["batches"]
    assert "feed: 4 batches" in tds.stats()


def test_local_shuffle_seeded_deterministic(runtimes):
    def pipeline(rt, rd):
        ds = rd.range(60).repartition(3)

        def run():
            return [int(i) for b in ds.iter_batches(
                batch_size=10, local_shuffle_buffer_size=20,
                local_shuffle_seed=7) for i in b["id"]]

        return [run(), run()]

    a, b = same(pipeline)
    assert a == b and sorted(a) == list(range(60)) and a != list(range(60))


def test_local_shuffle_one_permutation_per_refill(runtimes, monkeypatch):
    import ray_tpu_torch.data as td
    import ray_tpu_torch.data.dataset as dsmod

    calls = []
    real_random = dsmod._random.Random

    class CountingRandom(real_random):
        def shuffle(self, x):
            calls.append(len(x))
            super().shuffle(x)

    monkeypatch.setattr(dsmod._random, "Random", CountingRandom)
    out = list(td.range(120).repartition(2).iter_torch_batches(
        batch_size=10, device="cpu", local_shuffle_buffer_size=60,
        local_shuffle_seed=0))
    assert sum(len(b["id"]) for b in out) == 120
    assert 2 <= len(calls) <= 4, calls


def test_prefetch_skips_local_objects(runtimes):
    def pipeline(rt, rd):
        ref = rt.put(np.arange(1000))
        return [rt.prefetch([ref]), rt.prefetch(ref)]

    assert same(pipeline) == [0, 0]
