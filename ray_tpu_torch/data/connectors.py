"""Connector datasources/sinks beyond the file formats (the port of
ray_tpu/data/connectors.py).

Fills the breadth slots of the reference's datasource tree
(python/ray/data/datasource/: sql_datasource.py, tfrecords_datasource.py,
webdataset_datasource.py, mongo_datasource.py, bigquery_datasource.py)
on this repo's Datasource/Datasink ABC. Design stance, matching the GKE
provider pattern: every connector's IO goes through an injectable
client/connection factory so the logic is fully testable offline —
SQL tests run against stdlib sqlite3 (a real DB-API driver), Mongo and
BigQuery against recorded fakes.

TFRecord support includes a dependency-free tf.train.Example wire codec
(protobuf wire format is stable and simple: Features is a map field of
oneof bytes/float/int64 lists), so TFRecord files round-trip real
feature dicts without tensorflow in the image.
"""

from __future__ import annotations

import io
import struct
import tarfile
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.data import block as B
from ray_tpu_torch.data.datasource import Datasink, Datasource, FileBasedDatasource, ReadTask


# ---------------------------------------------------------------------------
# SQL (DB-API 2.0)
# ---------------------------------------------------------------------------


class SQLDatasource(Datasource):
    """Rows from a SQL query over any DB-API 2.0 driver (reference:
    data/datasource/sql_datasource.py — same connection_factory seam).

    `shard_column` mode splits the query into parallelism hash-sharded
    reads (WHERE COALESCE(abs(col), 0) % N = i — NULL keys land in
    shard 0, never dropped); without it the query runs as one read task
    (the reference's default too: arbitrary SQL cannot be split
    safely). SQL emitted uses qmark placeholders and AS-aliased
    subqueries — the broadest common DB-API dialect (sqlite3, duckdb,
    mariadb); pyformat-only drivers (psycopg2) need a qmark wrapper."""

    def __init__(self, sql: str, connection_factory: Callable[[], Any],
                 shard_column: Optional[str] = None):
        self.sql = sql
        self.connection_factory = connection_factory
        self.shard_column = shard_column

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        factory, sql = self.connection_factory, self.sql

        def run_query(query: str, params=()):
            conn = factory()
            try:
                cur = conn.cursor()
                cur.execute(query, params)
                names = [d[0] for d in cur.description]
                rows = [dict(zip(names, r)) for r in cur.fetchall()]
                return [B.block_from_rows(rows)]
            finally:
                conn.close()

        if self.shard_column is None or parallelism <= 1:
            return [ReadTask(lambda: run_query(sql))]
        col, n = self.shard_column, parallelism
        tasks = []
        for i in range(n):
            shard_sql = (
                f"SELECT * FROM ({sql}) AS _rt_shard WHERE "  # noqa: S608
                f"COALESCE(abs({col}), 0) % {n} = {i}"
            )
            tasks.append(
                ReadTask(lambda q=shard_sql: run_query(q))
            )
        return tasks


class SQLDatasink(Datasink):
    """INSERTs each block's rows (reference: Dataset.write_sql)."""

    def __init__(self, table: str, connection_factory: Callable[[], Any]):
        self.table = table
        self.connection_factory = connection_factory

    def write(self, blk: Any, ctx: Dict) -> Any:
        rows = B.block_to_rows(blk)
        if not rows:
            return 0
        cols = list(rows[0].keys())
        placeholders = ", ".join("?" for _ in cols)
        sql = (
            f"INSERT INTO {self.table} ({', '.join(cols)}) "  # noqa: S608
            f"VALUES ({placeholders})"
        )
        conn = self.connection_factory()
        try:
            cur = conn.cursor()
            cur.executemany(sql, [tuple(r[c] for c in cols) for r in rows])
            conn.commit()
            return len(rows)
        finally:
            conn.close()


# ---------------------------------------------------------------------------
# TFRecords + tf.train.Example wire codec
# ---------------------------------------------------------------------------

# crc32c (Castagnoli), table-driven; TFRecord frames each record as
# [len u64][masked crc32c(len) u32][data][masked crc32c(data) u32].
_CRC_TABLE = []


def _crc_table():
    if not _CRC_TABLE:
        poly = 0x82F63B78
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def _crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _write_record(out, data: bytes) -> None:
    header = struct.pack("<Q", len(data))
    out.write(header)
    out.write(struct.pack("<I", _masked_crc(header)))
    out.write(data)
    out.write(struct.pack("<I", _masked_crc(data)))


def _iter_records(buf: bytes):
    off = 0
    while off < len(buf):
        (length,) = struct.unpack_from("<Q", buf, off)
        off += 12  # len + len-crc
        yield buf[off:off + length]
        off += length + 4  # data + data-crc


# -- minimal protobuf wire helpers (only what tf.train.Example needs) ----


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _read_varint(buf: bytes, off: int):
    result = shift = 0
    while True:
        b = buf[off]
        off += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, off
        shift += 7


def _len_field(field_no: int, payload: bytes) -> bytes:
    return _varint(field_no << 3 | 2) + _varint(len(payload)) + payload


def encode_example(features: Dict[str, Any]) -> bytes:
    """dict -> serialized tf.train.Example. Values: bytes/str ->
    bytes_list, float -> float_list, int -> int64_list; lists of those
    encode element-wise. Numpy scalars/arrays normalize to their Python
    equivalents first — list-of-rows blocks carry np.int64/np.float32
    straight from map() outputs (Arrow blocks convert via to_pylist,
    but the row path must not reject what the table path accepts)."""
    import numpy as np

    feat_entries = b""
    for name, value in features.items():
        if isinstance(value, np.ndarray):
            value = value.tolist()
        values = value if isinstance(value, (list, tuple)) else [value]
        # np.generic scalars are host memory; .item() here is a pure
        # unboxing (never a device sync).
        values = [v.item() if isinstance(v, np.generic) else v  # rtlint: disable=RT001
                  for v in values]
        if all(isinstance(v, (bytes, str)) for v in values):
            items = b"".join(
                _len_field(1, v.encode() if isinstance(v, str) else v)
                for v in values
            )
            feature = _len_field(1, items)  # Feature.bytes_list
        elif all(isinstance(v, bool) or isinstance(v, int) for v in values):
            packed = b"".join(_varint(int(v) & (2 ** 64 - 1)) for v in values)
            # Int64List.value is packed repeated varint (field 1).
            feature = _len_field(3, _len_field(1, packed))
        elif all(isinstance(v, (int, float)) for v in values):
            packed = b"".join(struct.pack("<f", float(v)) for v in values)
            feature = _len_field(2, _len_field(1, packed))  # FloatList
        else:
            raise TypeError(f"unsupported feature value for {name!r}")
        entry = _len_field(1, name.encode()) + _len_field(2, feature)
        feat_entries += _len_field(1, entry)  # Features.feature map entry
    return _len_field(1, feat_entries)  # Example.features


def decode_example(buf: bytes) -> Dict[str, Any]:
    """Serialized tf.train.Example -> {name: list-of-values}."""

    def fields(b: bytes):
        off = 0
        while off < len(b):
            tag, off = _read_varint(b, off)
            field_no, wire = tag >> 3, tag & 7
            if wire == 2:
                length, off = _read_varint(b, off)
                yield field_no, b[off:off + length]
                off += length
            elif wire == 0:
                value, off = _read_varint(b, off)
                yield field_no, value
            elif wire == 5:
                yield field_no, b[off:off + 4]
                off += 4
            else:  # pragma: no cover - not produced by Example
                raise ValueError(f"unsupported wire type {wire}")

    out: Dict[str, Any] = {}
    for fno, features_buf in fields(buf):
        if fno != 1:
            continue
        for entry_no, entry in fields(features_buf):
            if entry_no != 1:
                continue
            name, feature = None, None
            for k, v in fields(entry):
                if k == 1:
                    name = v.decode()
                elif k == 2:
                    feature = v
            if name is None or feature is None:
                continue
            for list_no, list_buf in fields(feature):
                values: List[Any] = []
                if list_no == 1:  # BytesList
                    values = [v for _, v in fields(list_buf)]
                elif list_no == 2:  # FloatList (packed floats)
                    for _, packed in fields(list_buf):
                        values.extend(
                            struct.unpack_from("<f", packed, i)[0]
                            for i in range(0, len(packed), 4)
                        )
                elif list_no == 3:  # Int64List (packed or unpacked)
                    def _signed(v):
                        return v - 2 ** 64 if v >= 2 ** 63 else v

                    for _, packed in fields(list_buf):
                        if isinstance(packed, int):  # unpacked varint
                            values.append(_signed(packed))
                            continue
                        off = 0
                        while off < len(packed):
                            v, off = _read_varint(packed, off)
                            values.append(_signed(v))
                out[name] = values
    return out


class TFRecordDatasource(FileBasedDatasource):
    """TFRecord files -> one row per record (reference:
    tfrecords_datasource.py). Records decode as tf.train.Example feature
    dicts; single-element lists unwrap to scalars (the reference's
    behavior). Pass raw=True for {"bytes": record} rows instead."""

    _GLOB = "*.tfrecord*"

    def __init__(self, path: str, filesystem=None, raw: bool = False):
        super().__init__(path, filesystem)
        self.raw = raw

    def _read_file(self, path: str):
        with self._open(path) as f:
            data = f.read()
        rows = []
        for rec in _iter_records(data):
            if self.raw:
                rows.append({"bytes": rec})
            else:
                decoded = decode_example(rec)
                rows.append({
                    k: (v[0] if len(v) == 1 else v)
                    for k, v in decoded.items()
                })
        return B.block_from_rows(rows)


class TFRecordDatasink(Datasink):
    """Blocks -> TFRecord shard files of tf.train.Examples (reference:
    Dataset.write_tfrecords)."""

    def __init__(self, path: str):
        import os

        self.path = path
        os.makedirs(path, exist_ok=True)

    def write(self, blk: Any, ctx: Dict) -> Any:
        import os

        rows = B.block_to_rows(blk)
        out_path = os.path.join(
            self.path, f"part-{ctx['task_index']:05d}.tfrecord"
        )
        with open(out_path, "wb") as f:
            for row in rows:
                _write_record(f, encode_example(row))
        return len(rows)


# ---------------------------------------------------------------------------
# WebDataset (tar shards)
# ---------------------------------------------------------------------------


class WebDatasetDatasource(FileBasedDatasource):
    """Tar shards where files sharing a basename stem form one sample
    (reference: webdataset_datasource.py): shard-0.tar containing
    {a.jpg, a.cls, b.jpg, b.cls} yields rows {"__key__": "a", "jpg": ...,
    "cls": ...}. Members decode by suffix: known image suffixes via PIL
    (uint8 arrays), "cls"/"txt"/"json" as text/int/json, everything else
    raw bytes."""

    _GLOB = "*.tar"
    _IMAGE_SUFFIXES = ("jpg", "jpeg", "png", "bmp", "webp")

    def _decode(self, suffix: str, data: bytes):
        if suffix in self._IMAGE_SUFFIXES:
            import numpy as np
            from PIL import Image

            return np.asarray(Image.open(io.BytesIO(data)))
        if suffix == "cls":
            return int(data.decode().strip())
        if suffix in ("txt", "text"):
            return data.decode()
        if suffix == "json":
            import json as _json

            return _json.loads(data)
        return data

    def _read_file(self, path: str):
        with self._open(path) as f:
            raw = io.BytesIO(f.read())
        samples: Dict[str, Dict[str, Any]] = {}
        order: List[str] = []
        with tarfile.open(fileobj=raw, mode="r") as tar:
            for member in tar:
                if not member.isfile():
                    continue
                base = member.name.split("/")[-1]
                stem, _, suffix = base.rpartition(".")
                if not stem:
                    stem, suffix = base, ""
                if stem not in samples:
                    samples[stem] = {"__key__": stem}
                    order.append(stem)
                data = tar.extractfile(member).read()
                samples[stem][suffix.lower()] = self._decode(
                    suffix.lower(), data
                )
        # Rows stay a plain list (ragged ndarray members don't fit an
        # arrow table without the tensor extension).
        return [samples[k] for k in order]


# ---------------------------------------------------------------------------
# Mongo / BigQuery (injectable clients)
# ---------------------------------------------------------------------------


class MongoDatasource(Datasource):
    """Documents from a MongoDB collection (reference:
    mongo_datasource.py). `client_factory() -> client` where
    client[db][collection].find(filter) yields dicts (pymongo's
    surface). Reads run as ONE task: arbitrary filters cannot be
    sharded without server-side cooperation (the reference partitions
    on _id ranges via pymongoarrow, out of scope here)."""

    def __init__(self, db: str, collection: str,
                 client_factory: Callable[[], Any],
                 filter: Optional[Dict] = None):  # noqa: A002 — pymongo name
        self.db = db
        self.collection = collection
        self.client_factory = client_factory
        self.filter = filter or {}

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        factory = self.client_factory
        db, coll, flt = self.db, self.collection, dict(self.filter)

        def read():
            client = factory()
            docs = list(client[db][coll].find(flt))
            return [B.block_from_rows(docs)]

        return [ReadTask(read)]


class BigQueryDatasource(Datasource):
    """Rows from a BigQuery query (reference: bigquery_datasource.py).
    `client.query(sql).result()` yields row dicts (the google-cloud-
    bigquery surface); inject a fake for offline tests."""

    def __init__(self, sql: str, client: Any):
        self.sql = sql
        self.client = client

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        client, sql = self.client, self.sql

        def read():
            rows = [dict(r) for r in client.query(sql).result()]
            return [B.block_from_rows(rows)]

        return [ReadTask(read)]
