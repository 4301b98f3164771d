"""The port's streaming executor, distributed shuffles and streaming split
held against the JAX package's: tests/test_data_streaming.py.

Each case starts both runtimes in this process with the same arguments
(tests/torch_data_util.py), drives the same pipeline under each and
compares the results exactly. What depends on completion order (which
split receives which block) is compared as row-exact coverage.
"""

import threading

import numpy as np
import pytest

from tests.torch_data_util import both_runtimes, same


def test_out_of_core_pipeline_exceeds_store():
    """16 blocks of ~8 MB stream through a 48 MB store in both runtimes:
    bounded in-flight blocks, spilling and reference release."""
    def pipeline(rt, rd):
        ds = rd.from_items([{"i": i} for i in range(16)], parallelism=16)
        ds = ds.map_batches(
            lambda b: {"x": np.ones((len(b["i"]), 1_000_000)), "i": b["i"]}
        ).map_batches(
            lambda b: {"s": np.asarray([np.asarray(x).sum()
                                        for x in b["x"]]), "i": b["i"]})
        return sorted((r["i"], r["s"]) for r in ds.take_all())

    with both_runtimes(num_cpus=2, object_store_memory=48 * 1024 * 1024):
        out = same(pipeline)
    assert out == [[i, 1_000_000.0] for i in range(16)]


def test_two_node_distributed_shuffle():
    """random_shuffle over a two-node Cluster: the same seeded order in
    both runtimes, every row once, again with the same seed."""
    import importlib

    def pipeline(rt, rd):
        cluster = importlib.import_module(
            rt.__name__ + ".cluster_utils").Cluster()
        cluster.add_node(num_cpus=2)
        cluster.add_node(num_cpus=2)
        cluster.connect()
        try:
            ds = rd.from_items([{"i": i} for i in range(500)],
                               parallelism=8)
            vals = [r["i"] for r in
                    ds.random_shuffle(seed=7).materialize().take_all()]
            again = [r["i"] for r in
                     ds.random_shuffle(seed=7).materialize().take_all()]
            return [vals, again == vals]
        finally:
            cluster.shutdown()

    vals, again = same(pipeline)
    assert again and sorted(vals) == list(range(500))
    assert vals != list(range(500))


def test_distributed_sort_range_partitioned():
    rng = np.random.default_rng(3)
    items = [{"k": float(v)} for v in rng.normal(size=200) * 50]

    def pipeline(rt, rd):
        return [[r["k"] for r in
                 rd.from_items(items, parallelism=6).sort("k").take_all()],
                [r["k"] for r in rd.from_items(items, parallelism=6)
                 .sort("k", descending=True).take_all()]]

    with both_runtimes(num_cpus=2):
        asc, desc = same(pipeline)
    assert asc == sorted(asc) and desc == sorted(desc, reverse=True)


def _event_log_fn(log_path, stage, delay=0.0):
    """Block fn appending (stage, start, end) lines to a shared file:
    cross-process evidence of scheduling order."""

    def fn(block, _stage=stage, _p=log_path, _d=delay):
        import time as _t

        start = _t.monotonic()
        if _d:
            _t.sleep(_d)
        with open(_p, "a") as f:
            f.write(f"{_stage} {start} {_t.monotonic()}\n")
        return block

    return fn


def _events(path):
    with open(path) as f:
        return [(s, float(a), float(b)) for s, a, b in
                (line.split() for line in f)]


def test_block_level_pipelining_fusion_and_backpressure(tmp_path):
    """The executor in both runtimes: stage 2 starts on early blocks while
    stage 1 still runs (no barrier); adjacent maps of one resource shape
    fuse into one task per block; a window of 2 bounds the overlap."""
    import importlib

    def pipeline(rt, rd):
        ex_mod = importlib.import_module(rd.__name__ + ".executor")
        MapStage = ex_mod.MapStage
        StreamingExecutor = ex_mod.StreamingExecutor
        log = str(tmp_path / f"{rt.__name__}.log")
        refs = [rt.put([{"i": i}]) for i in range(8)]
        ex = StreamingExecutor([
            MapStage(_event_log_fn(log, "s1", 0.15), name="s1",
                     max_in_flight=2, resources={"CPU": 0.1}),
            MapStage(_event_log_fn(log, "s2", 0.15), name="s2",
                     max_in_flight=2, resources={"CPU": 0.2}),
        ])
        out = rt.get(ex.execute(refs))
        ev = _events(log)
        s1_ends = sorted(e[2] for e in ev if e[0] == "s1")
        s2_starts = sorted(e[1] for e in ev if e[0] == "s2")
        fused = StreamingExecutor([MapStage(lambda b: b, name=n)
                                   for n in "abc"])
        fused.execute([rt.put([{"i": i}]) for i in range(6)])
        (seg,) = fused.stats
        bp_log = str(tmp_path / f"{rt.__name__}_bp.log")
        StreamingExecutor([MapStage(_event_log_fn(bp_log, "w", 0.1),
                                    name="w", max_in_flight=2)]).execute(
            [rt.put([{"i": i}]) for i in range(10)])
        spans = [(a, b) for _, a, b in _events(bp_log)]
        peak = max(sum(1 for s, e in spans if s <= t < e) for t, _ in spans)
        return [out, len(s1_ends), len(s2_starts),
                s2_starts[0] < s1_ends[-1], seg["stage"], seg["tasks"],
                len(spans), peak <= 2]

    with both_runtimes(num_cpus=4):
        out = same(pipeline)
    assert out == [[[{"i": i}] for i in range(8)], 8, 8, True, "a+b+c", 6,
                   10, True]


def test_actor_pool_map_batches(tmp_path):
    """map_batches(CallableClass, compute=ActorPoolStrategy(size=2)):
    state built once per pool actor in both runtimes."""

    def pipeline(rt, rd):
        log = str(tmp_path / f"{rt.__name__}_inits.log")

        class CountingModel:
            def __init__(self, log_path):
                import os

                with open(log_path, "a") as f:
                    f.write(f"init {os.getpid()}\n")
                self.bias = 100.0

            def __call__(self, batch):
                return {"y": np.asarray(batch["i"], dtype=float)
                        + self.bias}

        out = rd.from_items([{"i": i} for i in range(24)], parallelism=8) \
            .map_batches(CountingModel, compute=rd.ActorPoolStrategy(size=2),
                         fn_constructor_args=(log,)).take_all()
        with open(log) as f:
            inits = f.readlines()
        return [sorted(r["y"] for r in out), len(inits)]

    with both_runtimes(num_cpus=2):
        ys, inits = same(pipeline)
    assert ys == [100.0 + i for i in range(24)] and inits == 2


def test_repartition_distributed():
    def pipeline(rt, rd):
        rp = rd.from_items([{"i": i} for i in range(100)],
                           parallelism=2).repartition(8).materialize()
        return [rp.num_blocks(), [r["i"] for r in rp.take_all()]]

    with both_runtimes(num_cpus=2):
        n, rows = same(pipeline)
    assert n == 8 and sorted(rows) == list(range(100))


@pytest.mark.slow
def test_wide_shuffle_bounded_fanin():
    def pipeline(rt, rd):
        ds = rd.from_items([{"i": i} for i in range(600)], parallelism=150)
        rp = ds.repartition(4).materialize()
        s1 = [r["i"] for r in ds.random_shuffle(seed=11).take_all()]
        s2 = [r["i"] for r in ds.random_shuffle(seed=11).take_all()]
        return [rp.num_blocks(), sorted(r["i"] for r in rp.take_all()),
                s1, s1 == s2]

    with both_runtimes(num_cpus=4, object_store_memory=256 * 1024 * 1024):
        n, rows, s1, again = same(pipeline)
    assert n == 4 and rows == list(range(600)) and again
    assert s1 != list(range(600))


def test_datasource_datasink_plugin_and_binary_files(tmp_path):
    import importlib
    import os

    blobs = tmp_path / "blobs"
    blobs.mkdir()
    for i in range(3):
        (blobs / f"blob{i}.bin").write_bytes(bytes([i]) * (10 + i))

    def pipeline(rt, rd):
        B = importlib.import_module(rd.__name__ + ".block")
        src = importlib.import_module(rd.__name__ + ".datasource")

        class SquaresSource(src.Datasource):
            def __init__(self, n):
                self.n = n

            def get_read_tasks(self, parallelism):
                per = (self.n + parallelism - 1) // parallelism
                return [src.ReadTask(
                    lambda lo=lo, hi=hi: [B.block_from_rows(
                        [{"i": j, "sq": j * j} for j in range(lo, hi)])],
                    {"num_rows": hi - lo})
                    for lo, hi in ((i * per, min((i + 1) * per, self.n))
                                   for i in range(parallelism)) if lo < hi]

        class ManifestSink(src.Datasink):
            def __init__(self, path):
                self.path = path

            def write(self, block, ctx):
                rows = B.block_to_rows(block)
                fp = f"{self.path}/chunk-{ctx['task_index']}.txt"
                with open(fp, "w") as f:
                    f.writelines(f"{r['i']},{r['sq']}\n" for r in rows)
                return {"file": os.path.basename(fp), "rows": len(rows)}

            def on_write_complete(self, results):
                self.completed = results

        out_dir = tmp_path / rt.__name__
        out_dir.mkdir()
        ds = rd.read_datasource(SquaresSource(30), parallelism=4)
        results = ds.write_datasink(ManifestSink(str(out_dir)))
        files = ds.write_parquet(str(out_dir / "pq"))
        binary = rd.read_binary_files(str(blobs), parallelism=2)
        return [ds.count(), sorted(r["sq"] for r in ds.take_all())[:4],
                results, len(files), rd.read_parquet(
                    str(out_dir / "pq")).count(),
                sorted((os.path.basename(r["path"]), r["bytes"])
                       for r in binary.take_all())]

    with both_runtimes(num_cpus=4):
        out = same(pipeline)
    assert out[:2] == [30, [0, 1, 4, 9]] and out[4] == 30
    assert [len(b) for _, b in out[5]] == [10, 11, 12]


def _consume_splits(its, epochs, read):
    """Every split's rows per epoch, each split read by its own thread
    (as the training workers do)."""
    out = []
    for _ in range(epochs):
        parts = [None] * len(its)

        def consume(i):
            parts[i] = read(its[i])

        ts = [threading.Thread(target=consume, args=(i,))
              for i in range(len(its))]
        [t.start() for t in ts]
        [t.join(timeout=120) for t in ts]
        assert not any(t.is_alive() for t in ts)
        out.append(parts)
    return out


@pytest.mark.parametrize("n", [2, 3])
def test_streaming_split_coverage_over_two_epochs(n):
    """streaming_split(n, equal=True): every row once per epoch, splits
    row-EXACTLY equal, the pipeline re-executed per epoch; ragged blocks
    drop the same remainder in both runtimes."""

    def pipeline(rt, rd):
        ds = rd.range(90, parallelism=9).map(lambda r: {"id": r["id"]})
        its = ds.streaming_split(n, equal=True)
        epochs = _consume_splits(
            its, 2, lambda it: [r["id"] for r in it.iter_rows()])
        its[0].stop()
        ragged = rd.range(100, parallelism=7).streaming_split(n)
        (parts,) = _consume_splits(
            ragged, 1, lambda it: [r["id"] for r in it.iter_rows()])
        ragged[0].stop()
        return [[[len(p) for p in e] for e in epochs],
                [sorted(x for p in e for x in p) == list(range(90))
                 for e in epochs],
                [len(p) for p in parts],
                len({x for p in parts for x in p})]

    with both_runtimes(num_cpus=4):
        sizes, covered, ragged, distinct = same(pipeline)
    assert sizes == [[90 // n] * n] * 2 and covered == [True, True]
    assert ragged == [100 // n] * n and distinct == 100 // n * n


def test_split_iter_torch_batches_bit_equal_to_the_dataset_feed():
    """A split's iter_torch_batches (device="cpu") against the JAX
    Dataset's iter_jax_batches of the same rows: with no stage to run,
    one split streams the blocks in source order, so the batches match
    bit for bit; the split's feed_stats() counts them."""
    import torch

    import ray_tpu.data as jd
    import ray_tpu_torch.data as td

    rng = np.random.default_rng(21)
    arrays = {"tok": rng.integers(0, 32000, (40, 17), dtype=np.int32),
              "row": np.arange(40, dtype=np.int32)}
    with both_runtimes(num_cpus=4):
        want = [{k: np.asarray(v) for k, v in b.items()} for b in
                jd.from_numpy(arrays, parallelism=5).iter_jax_batches(
                    batch_size=6)]
        (it,) = td.from_numpy(arrays, parallelism=5).streaming_split(1)
        try:
            got = list(it.iter_torch_batches(batch_size=6, device="cpu",
                                             prefetch_batches=2))
            stats = it.feed_stats()
            again = [b["row"].tolist() for b in it.iter_torch_batches(
                batch_size=6, device="cpu", prefetch_batches=0)]
        finally:
            it.stop()
    assert all(isinstance(t, torch.Tensor) for b in got for t in b.values())
    assert len(got) == len(want) == 7
    for a, b in zip(got, want):
        for k in b:
            assert a[k].numpy().dtype == b[k].dtype
            assert a[k].numpy().tobytes() == b[k].tobytes()
    assert stats["batches"] == 7 and stats["h2d_bytes"] == 0
    assert sum(again, []) == list(range(40))
