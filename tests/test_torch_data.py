"""The port's Dataset (ray_tpu_torch.data) held against the JAX package's,
case by case: tests/test_data.py and tests/test_data_units.py.

Both runtimes run in this process (tests/torch_data_util.py); every case
drives the same pipeline, on rows made from a numpy seed, under each and
compares the results exactly: rows, orders (a seeded shuffle gives the
same order in both), counts, aggregates, groups and batches. The port's
`iter_torch_batches(device="cpu")` is held bit for bit against the JAX
package's `iter_jax_batches` and its CPU `iter_torch_batches`.
"""

import json
import os

import numpy as np
import pytest

from tests.torch_data_util import PACKAGES, both_runtimes, plain, same


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    with both_runtimes(num_cpus=4):
        yield


def _rows(seed=0, n=60):
    rng = np.random.default_rng(seed)
    return [{"i": i, "x": float(x), "k": int(k)}
            for i, (x, k) in enumerate(zip(rng.normal(size=n),
                                           rng.integers(0, 5, n)))]


def test_range_count_take():
    out = same(lambda rt, rd: [rd.range(100).count(),
                               rd.range(100).take(5),
                               rd.range(10, parallelism=3).take_all()])
    assert out[0] == 100 and out[1] == [{"id": i} for i in range(5)]


def test_map_filter_flat_map():
    def pipeline(rt, rd):
        ds = rd.from_items(_rows(1), parallelism=4)
        return [ds.map(lambda r: {"i": r["i"], "y": r["x"] * 2}).take_all(),
                ds.filter(lambda r: r["k"] == 2).take_all(),
                ds.flat_map(lambda r: [r["i"]] * (r["k"] % 2 + 1)).take_all()]

    out = same(pipeline)
    assert len(out[0]) == 60 and all(r["k"] == 2 for r in out[1])


def test_map_batches_numpy():
    def pipeline(rt, rd):
        ds = rd.from_items(_rows(2), parallelism=4)
        return ds.map_batches(
            lambda b: {"i": b["i"], "z": b["x"] * b["k"]}).take_all()

    assert len(same(pipeline)) == 60


def test_repartition_and_num_blocks():
    out = same(lambda rt, rd: [
        rd.range(50, parallelism=2).repartition(5).num_blocks(),
        sorted(r["id"] for r in
               rd.range(50, parallelism=2).repartition(5).take_all())])
    assert out == [5, list(range(50))]


def test_random_shuffle_seeded_same_order():
    def pipeline(rt, rd):
        ds = rd.from_items(_rows(3, 200), parallelism=8)
        a = [r["i"] for r in ds.random_shuffle(seed=7).take_all()]
        b = [r["i"] for r in ds.random_shuffle(seed=7).take_all()]
        return [a, a == b]

    order, again = same(pipeline)
    assert again and sorted(order) == list(range(200))
    assert order != list(range(200))


def test_sort():
    def pipeline(rt, rd):
        ds = rd.from_items(_rows(4, 120), parallelism=6)
        return [[r["x"] for r in ds.sort("x").take_all()],
                [r["i"] for r in ds.sort("k", descending=True).take_all()]]

    asc, _ = same(pipeline)
    assert asc == sorted(asc)


def test_aggregations():
    def pipeline(rt, rd):
        ds = rd.from_items(_rows(5, 90), parallelism=5)
        return [ds.sum("k"), ds.min("x"), ds.max("x"), ds.mean("k"),
                ds.std("x"), ds.std("x", ddof=0), ds.unique("k"),
                ds.aggregate(rd.Count(), rd.Sum("k"), rd.Mean("x"))]

    out = same(pipeline)
    assert out[6] == [0, 1, 2, 3, 4]


def test_groupby():
    def pipeline(rt, rd):
        ds = rd.from_items(_rows(6, 100), parallelism=5)
        g = ds.groupby("k")
        named = rd.from_items(
            [{"name": f"n{r['k']}", "v": r["i"]} for r in _rows(6, 100)],
            parallelism=4)
        return [g.count().take_all(), g.sum("i").take_all(),
                g.min("x").take_all(), g.max("x").take_all(),
                g.mean("x").take_all(), g.std("x").take_all(),
                g.aggregate(rd.Count(), rd.Sum("i")).take_all(),
                g.map_groups(lambda rows: {"k": rows[0]["k"],
                                           "n": len(rows)}).take_all(),
                sorted(named.groupby("name").sum("v").take_all(),
                       key=lambda r: r["name"])]

    out = same(pipeline)
    assert sum(r["count()"] for r in out[0]) == 100


def test_local_shuffle_and_prefetch_iter():
    def pipeline(rt, rd):
        ds = rd.range(80).repartition(4)
        return [[int(i) for b in ds.iter_batches(
            batch_size=10, local_shuffle_buffer_size=30,
            local_shuffle_seed=3, prefetch_blocks=2) for i in b["id"]],
            [len(b["id"]) for b in ds.iter_batches(batch_size=10,
                                                   prefetch_batches=2)]]

    order, sizes = same(pipeline)
    assert sorted(order) == list(range(80)) and order != list(range(80))
    assert sizes == [10] * 8


def test_iter_batches_rebatching_straddle_and_remainder():
    def pipeline(rt, rd):
        ds = rd.from_numpy({"a": np.arange(23, dtype=np.int32),
                            "b": np.linspace(0, 1, 23)}, parallelism=3)
        return [list(ds.iter_batches(batch_size=7)),
                [t.num_rows for t in ds.iter_batches(
                    batch_size=7, batch_format="pyarrow")]]

    batches, arrow_rows = same(pipeline)
    assert [len(b["a"][1]) for b in batches] == [7, 7, 7, 2]
    assert arrow_rows == [7, 7, 7, 2]


@pytest.mark.parametrize("prefetch", [0, 2])
def test_iter_torch_batches_bit_equal_to_the_jax_feeds(prefetch):
    """The port's feed onto the CPU against the JAX package's
    iter_jax_batches (on its CPU device) and its iter_torch_batches:
    the same batches, bit for bit, tensor columns and dtypes included."""
    import jax
    import torch

    import ray_tpu.data as jd
    import ray_tpu_torch.data as td

    # 32-bit columns: JAX (without x64) would narrow an int64 column on
    # the device, which iter_jax_batches leaves to JAX's dtype policy.
    rng = np.random.default_rng(11)
    arrays = {"tok": rng.integers(0, 1000, (50, 9), dtype=np.int32),
              "f": rng.normal(size=50).astype(np.float32),
              "img": rng.integers(0, 255, (50, 4, 4, 3), dtype=np.uint8)}
    jds = jd.from_numpy(arrays, parallelism=4)
    tds = td.from_numpy(arrays, parallelism=4)
    via_jax = [{k: np.asarray(v) for k, v in b.items()}
               for b in jds.iter_jax_batches(batch_size=16,
                                             prefetch_batches=prefetch)]
    jax_torch = [{k: v.numpy() for k, v in b.items()}
                 for b in jds.iter_torch_batches(batch_size=16)]
    port = list(tds.iter_torch_batches(batch_size=16, device="cpu",
                                       prefetch_batches=prefetch))
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for b in port for t in b.values())
    port = [{k: v.numpy() for k, v in b.items()} for b in port]
    assert isinstance(jax.numpy.zeros(1), jax.Array)
    assert [len(b["f"]) for b in port] == [16, 16, 16, 2]
    for want in (via_jax, jax_torch):
        assert len(port) == len(want)
        for a, b in zip(port, want):
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                assert a[k].tobytes() == b[k].tobytes()
    if prefetch:
        snap = tds._last_feed_stats.snapshot()
        assert snap["batches"] == 4 == jds._last_feed_stats.snapshot()[
            "batches"]


def test_iter_torch_batches_dtypes_and_no_device_raises():
    import torch

    import ray_tpu_torch.data as td

    ds = td.from_numpy({"x": np.arange(8, dtype=np.int32)}, parallelism=2)
    (b,) = ds.iter_torch_batches(batch_size=8, device="cpu",
                                 dtypes={"x": torch.float64})
    assert b["x"].dtype == torch.float64
    assert b["x"].tolist() == list(range(8))
    if not torch.cuda.is_available():
        # No card and no device named: the feed refuses, it never
        # drops to the CPU on its own.
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ds.iter_torch_batches(batch_size=8)
    strings = td.from_items([{"s": "a"}, {"s": "b"}], parallelism=1)
    with pytest.raises(TypeError, match="column 's'"):
        list(strings.iter_torch_batches(batch_size=2, device="cpu",
                                        prefetch_batches=0))


def test_dataset_stats_and_feed_stats_line():
    def pipeline(rt, rd):
        ds = rd.range(40, parallelism=4).map(lambda r: r)
        m = ds.materialize()
        list(ds.iter_batches(batch_size=10, prefetch_batches=2))
        line = ds.stats().splitlines()[-1]
        return [m.stats().count("Stage"), line.startswith("feed: 4 batches")]

    assert same(pipeline) == [1, True]


def test_split_for_training():
    def pipeline(rt, rd):
        shards = rd.range(103, parallelism=7).split(4)
        return [[r["id"] for r in s.take_all()] for s in shards]

    shards = same(pipeline)
    assert [len(s) for s in shards] == [25, 26, 26, 26]


def test_from_numpy_and_tensor_columns():
    def pipeline(rt, rd):
        rng = np.random.default_rng(12)
        x = rng.normal(size=(20, 3, 2)).astype(np.float32)
        ds = rd.from_numpy({"x": x, "y": np.arange(20)}, parallelism=3)
        return [ds.count(), list(ds.iter_batches(batch_size=8)),
                [r["y"] for r in ds.take_all()]]

    out = same(pipeline)
    assert out[0] == 20


@pytest.mark.parametrize("fmt", ["parquet", "csv", "json"])
def test_write_read_roundtrip(tmp_path, fmt):
    def pipeline(rt, rd):
        d = str(tmp_path / f"{rd.__name__}_{fmt}")
        ds = rd.from_items([{"i": r["i"], "x": r["x"], "k": r["k"]}
                            for r in _rows(13, 40)], parallelism=4)
        files = getattr(ds, f"write_{fmt}")(d)
        back = getattr(rd, f"read_{fmt}")(d)
        return [len(files), sorted(back.take_all(), key=lambda r: r["i"]),
                sorted(os.path.basename(f) for f in files)]

    n, rows, _ = same(pipeline)
    assert n == 4 and len(rows) == 40


def test_read_text_and_numpy(tmp_path):
    (tmp_path / "a.txt").write_text("one\ntwo\n")
    (tmp_path / "b.txt").write_text("three\n")
    for i in range(3):
        np.save(tmp_path / f"arr{i}.npy", np.full(4, i, dtype=np.int16))

    def pipeline(rt, rd):
        return [sorted(r["text"] for r in
                       rd.read_text(str(tmp_path)).take_all()),
                sorted((os.path.basename(r["path"]), r["data"])
                       for r in rd.read_numpy(str(tmp_path)).take_all())]

    text, arrays = same(pipeline)
    assert text == ["one", "three", "two"] and len(arrays) == 3


def test_union_limit_and_train_test_split():
    def pipeline(rt, rd):
        a, b = rd.range(10, parallelism=2), rd.range(5, parallelism=1)
        tr, te = rd.range(50, parallelism=5).train_test_split(0.2)
        tr2, te2 = rd.range(50, parallelism=5).train_test_split(
            7, shuffle=True, seed=3)
        return [sorted(r["id"] for r in a.union(b).take_all()),
                rd.range(100, parallelism=4).limit(13).take_all(),
                [r["id"] for r in tr.take_all()],
                [r["id"] for r in te.take_all()],
                [r["id"] for r in tr2.take_all()],
                [r["id"] for r in te2.take_all()]]

    out = same(pipeline)
    assert len(out[1]) == 13 and len(out[3]) == 10 and len(out[5]) == 7


def test_column_ops_sampling_and_zip():
    def pipeline(rt, rd):
        ds = rd.from_items(_rows(14, 50), parallelism=5)
        return [ds.add_column("z", lambda r: r["i"] * 3).take(3),
                ds.drop_columns(["x"]).take(3),
                ds.select_columns(["k"]).take(3),
                [r["i"] for r in ds.random_sample(0.3, seed=5).take_all()],
                ds.select_columns(["i"]).zip(
                    rd.from_items([{"i": j} for j in range(50)],
                                  parallelism=3)).take(4)]

    out = same(pipeline)
    assert out[4][0] == {"i": 0, "i_1": 0}


def test_pandas_arrow_interop():
    import pyarrow as pa

    def pipeline(rt, rd):
        import pandas as pd

        df = pd.DataFrame({"a": np.arange(12), "b": np.arange(12) * 0.5})
        ds = rd.from_pandas(df)
        t = rd.from_arrow(pa.table({"c": list(range(6))})).to_arrow()
        return [sorted(ds.take_all(), key=lambda r: r["a"]),
                ds.to_pandas()["b"].sum(), sorted(t.column("c").to_pylist())]

    out = same(pipeline)
    assert out[2] == list(range(6))


def test_read_images(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(15)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (6, 5, 3), dtype=np.uint8)).save(
            tmp_path / f"im{i}.png")
    Image.fromarray(rng.integers(0, 255, (6, 5), dtype=np.uint8)).save(
        tmp_path / "gray.png")

    def pipeline(rt, rd):
        rows = sorted(rd.read_images(str(tmp_path)).take_all(),
                      key=lambda r: r["path"])
        small = rd.read_images(str(tmp_path), size=(3, 2), mode="L")
        return [[(os.path.basename(r["path"]), r["image"]) for r in rows],
                sorted(r["image"].shape for r in small.take_all())]

    rows, shapes = same(pipeline)
    assert len(rows) == 4 and shapes == [[3, 2]] * 4


def test_cloud_shaped_io_through_a_local_filesystem(tmp_path):
    import pyarrow.fs as pafs

    def pipeline(rt, rd):
        fs = pafs.SubTreeFileSystem(str(tmp_path), pafs.LocalFileSystem())
        uri = f"gs://bucket/{rd.__name__}"
        ds = rd.range(20, parallelism=2)
        files = ds.write_parquet(uri, filesystem=fs)
        back = rd.read_parquet(uri, filesystem=fs)
        return [sorted(files), sorted(r["id"] for r in back.take_all())]

    files, ids = same(lambda rt, rd: (lambda o: [
        [f.replace(rd.__name__, "PKG") for f in o[0]], o[1]])(pipeline(rt, rd)))
    assert ids == list(range(20)) and files[0].startswith("gs://")


# -- tests/test_data_units.py -----------------------------------------------

def test_encode_example_accepts_numpy_scalars_and_arrays():
    from ray_tpu.data import connectors as jc
    from ray_tpu_torch.data import connectors as tc

    row = {"a": np.int64(3), "b": np.float32(0.5), "c": np.arange(3),
           "d": "txt", "e": [np.int32(1), np.int32(2)]}
    assert tc.encode_example(row) == jc.encode_example(row)
    assert tc.decode_example(tc.encode_example(row)) \
        == jc.decode_example(jc.encode_example(row))


def test_numpy_batches_schema_mismatch_is_diagnosed():
    def pipeline(rt, rd):
        ds = rd.from_items([{"a": i} for i in range(3)]
                           + [{"b": i} for i in range(3)], parallelism=2)
        try:
            list(ds.iter_batches(batch_size=4))
        except ValueError as e:
            return str(e)
        return None

    assert "schema mismatch" in same(pipeline)


def test_block_helpers_and_tensor_registration_match():
    import pyarrow as pa

    from ray_tpu.data import block as jb
    from ray_tpu_torch.data import block as tb
    from ray_tpu_torch.data import tensor as tt

    rows = [{"a": 1, "b": "x"}, {"a": 2, "b": "y"}]
    for f in ("block_from_rows", "block_to_rows", "block_schema"):
        assert str(getattr(tb, f)(rows)) == str(getattr(jb, f)(rows))
    tbl = tb.block_from_rows(rows)
    assert plain(tb.block_to_batch(tbl)) == plain(jb.block_to_batch(tbl))
    assert tb.block_to_batch(tbl, "pyarrow") == jb.block_to_batch(
        tbl, "pyarrow")
    # The port's extra format: a pandas frame of the arrow batch.
    assert tb.block_to_batch(rows, "pandas").equals(
        jb.block_to_batch(rows, "pyarrow").to_pandas())
    with pytest.raises(ValueError, match="batch_format"):
        tb.block_to_batch(tbl, "torch")
    # The port's tensor type has a name of its own beside the JAX one, so
    # both register in one process.
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = tt.table_with_tensors({"x": x})
    assert isinstance(t.schema.field("x").type, pa.ExtensionType)
    assert t.schema.field("x").type.extension_name == "ray_tpu_torch.tensor"
    assert json.dumps(plain(tb.block_to_batch(t))) == json.dumps(
        {"x": ["float32", x.tolist()]})
