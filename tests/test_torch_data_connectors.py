"""The port's connectors and tensor columns held against the JAX
package's: tests/test_data_connectors.py.

SQL runs against a real DB-API driver (stdlib sqlite3), Mongo and
BigQuery against injected fakes, TFRecord through each package's own
CRC32C and protobuf codec; both runtimes run in this process and every
case compares the two results exactly.
"""

import importlib
import os
import sqlite3
import struct
import tarfile

import numpy as np
import pytest

from tests.torch_data_util import both_runtimes, same


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    with both_runtimes(num_cpus=4):
        yield


def _sqlite_factory(path):
    def factory():
        import sqlite3

        return sqlite3.connect(path)
    return factory


def _db(path, ddl, rows):
    conn = sqlite3.connect(path)
    conn.execute(ddl)
    conn.executemany(
        f"INSERT INTO t VALUES ({', '.join('?' * len(rows[0]))})", rows)
    conn.commit()
    conn.close()
    return str(path)


def test_read_sql_roundtrip_sharded_and_null_keys(tmp_path):
    rng = np.random.default_rng(0)
    users = _db(tmp_path / "u.db", "CREATE TABLE t (id INTEGER, name TEXT)",
                [(int(i), f"user{i}") for i in rng.permutation(20)])
    nums = _db(tmp_path / "n.db", "CREATE TABLE t (id INTEGER)",
               [(i,) for i in range(30)] + [(None,)] * 3)

    def pipeline(rt, rd):
        whole = rd.read_sql("SELECT * FROM t", _sqlite_factory(users))
        sharded = rd.read_sql("SELECT * FROM t", _sqlite_factory(nums),
                              parallelism=3, shard_column="id")
        return [sorted(whole.take_all(), key=lambda r: r["id"]),
                sorted((r["id"] is None, r["id"] or 0)
                       for r in sharded.take_all())]

    users_out, ids = same(pipeline)
    assert users_out[3] == {"id": 3, "name": "user3"}
    assert len(ids) == 33 and sum(1 for n, _ in ids if n) == 3


def test_write_sql_datasink(tmp_path):
    def pipeline(rt, rd):
        conn_mod = importlib.import_module(rd.__name__ + ".connectors")
        db = str(tmp_path / f"{rd.__name__}.db")
        conn = sqlite3.connect(db)
        conn.execute("CREATE TABLE out (id INTEGER, sq INTEGER)")
        conn.commit()
        conn.close()
        ds = rd.range(10, parallelism=2).map(
            lambda r: {"id": r["id"], "sq": r["id"] ** 2})
        written = ds.write_datasink(conn_mod.SQLDatasink(
            "out", _sqlite_factory(db)))
        conn = sqlite3.connect(db)
        rows = sorted(conn.execute("SELECT id, sq FROM out").fetchall())
        conn.close()
        return [written, rows]

    written, rows = same(pipeline)
    assert written == [5, 5] and rows == [[i, i * i] for i in range(10)]


def test_example_wire_codec_roundtrip():
    from ray_tpu.data import connectors as jc
    from ray_tpu_torch.data import connectors as tc

    features = {"label": 7, "name": b"cat", "weights": [0.25, 0.5],
                "ids": [1, 2, 300000], "neg": -5}
    blob = tc.encode_example(features)
    assert blob == jc.encode_example(features)
    assert tc.decode_example(blob) == jc.decode_example(blob)
    assert tc.decode_example(blob)["ids"] == [1, 2, 300000]
    assert tc._crc32c(b"123456789") == 0xE3069283  # the CRC32C check value
    assert tc._masked_crc(blob) == jc._masked_crc(blob)


def test_tfrecords_write_read_roundtrip_and_layout(tmp_path):
    def pipeline(rt, rd):
        conn_mod = importlib.import_module(rd.__name__ + ".connectors")
        out_dir = str(tmp_path / rd.__name__)
        ds = rd.range(12, parallelism=3).map(
            lambda r: {"id": r["id"], "name": f"row{r['id']}"})
        ds.write_datasink(conn_mod.TFRecordDatasink(out_dir))
        files = sorted(os.listdir(out_dir))
        raw = open(os.path.join(out_dir, files[0]), "rb").read()
        back = rd.read_tfrecords(out_dir, parallelism=3)
        return [files, raw, sorted(back.take_all(), key=lambda r: r["id"])]

    files, raw, rows = same(pipeline)
    assert len(files) == 3 and [r["id"] for r in rows] == list(range(12))
    assert rows[5]["name"] == b"row5"
    from ray_tpu_torch.data.connectors import _masked_crc

    (length,) = struct.unpack_from("<Q", raw, 0)
    assert struct.unpack_from("<I", raw, 8)[0] == _masked_crc(raw[:8])
    assert struct.unpack_from("<I", raw, 12 + length)[0] \
        == _masked_crc(raw[12:12 + length])


def test_read_webdataset(tmp_path):
    from PIL import Image

    shard = tmp_path / "shard-000.tar"
    with tarfile.open(shard, "w") as tar:
        for key in ("a", "b"):
            img_path = tmp_path / f"{key}.png"
            Image.fromarray(np.full((4, 4, 3), ord(key), dtype=np.uint8)
                            ).save(img_path)
            tar.add(img_path, arcname=f"{key}.png")
            cls_path = tmp_path / f"{key}.cls"
            cls_path.write_text(str(ord(key)))
            tar.add(cls_path, arcname=f"{key}.cls")

    rows = same(lambda rt, rd: sorted(
        rd.read_webdataset(str(tmp_path), parallelism=1).take_all(),
        key=lambda r: r["__key__"]))
    assert [r["__key__"] for r in rows] == ["a", "b"]
    assert rows[0]["cls"] == ord("a") and rows[0]["png"][0] == "uint8"


class _FakeMongo:
    """pymongo surface: client[db][coll].find(filter)."""

    def __init__(self, docs):
        self._docs = docs

    def __getitem__(self, db):
        return self

    def find(self, flt):
        return [d for d in self._docs
                if all(d.get(k) == v for k, v in flt.items())]


class _FakeBQ:
    def query(self, sql):
        class _Job:
            def result(self):
                return [{"n": i, "sql_len": len(sql)} for i in range(4)]
        return _Job()


def test_read_mongo_and_bigquery_fakes():
    docs = [{"_id": i, "v": i * 10} for i in range(6)]

    def pipeline(rt, rd):
        return [rd.read_mongo("db", "coll", lambda: _FakeMongo(docs),
                              filter={"v": 30}).take_all(),
                len(rd.read_mongo("db", "coll",
                                  lambda: _FakeMongo(docs)).take_all()),
                rd.read_bigquery("SELECT 1", _FakeBQ()).take_all()]

    one, n, bq = same(pipeline)
    assert one == [{"_id": 3, "v": 30}] and n == 6 and len(bq) == 4


def test_tensor_columns_zero_copy_batches():
    imgs = np.arange(10 * 4 * 4 * 3, dtype=np.float32).reshape(10, 4, 4, 3)

    def pipeline(rt, rd):
        ds = rd.from_numpy({"img": imgs, "y": np.arange(10)}, parallelism=2)
        batches = list(ds.iter_batches(batch_size=5, batch_format="numpy"))
        return [batches, [b["img"].flags.owndata for b in batches]]

    batches, owns = same(pipeline)
    assert owns == [False, False]
    assert [b["img"][1] for b in batches] == [imgs[:5].tolist(),
                                              imgs[5:].tolist()]


def test_tensor_table_roundtrip_through_store():
    arr = np.random.default_rng(0).normal(size=(6, 2, 3)).astype(np.float32)

    def pipeline(rt, rd):
        tensor = importlib.import_module(rd.__name__ + ".tensor")
        out = rt.get(rt.put(tensor.table_with_tensors({"x": arr})))
        back = tensor.tensor_to_numpy(out.column("x"))
        # Each package registers its own extension name.
        name = out.schema.field("x").type.extension_name
        return [back, back.flags.owndata, name == rt.__name__ + ".tensor"]

    back, owns, named = same(pipeline)
    assert back == ["float32", arr.tolist()] and owns is False and named


def test_decode_example_unpacked_int64():
    from ray_tpu_torch.data.connectors import (_len_field, _varint,
                                               decode_example)

    unpacked = (_varint(1 << 3 | 0) + _varint(5)
                + _varint(1 << 3 | 0) + _varint((-2) & (2 ** 64 - 1)))
    entry = _len_field(1, b"ids") + _len_field(2, _len_field(3, unpacked))
    assert decode_example(_len_field(1, _len_field(1, entry)))["ids"] \
        == [5, -2]
