"""Datasource / Datasink plugin surface (the port of
ray_tpu/data/datasource.py).

Analog of the reference's pluggable IO layer
(python/ray/data/datasource/datasource.py: Datasource.get_read_tasks /
ReadTask, and datasink.py: Datasink.on_write_start/write/on_write_complete).
A Datasource turns itself into independent read tasks (each a plain
callable producing blocks, executed in remote workers so rows never pass
through the driver); a Datasink receives one write call per block plus
job-level start/complete/failed hooks.

The built-in file formats (parquet/csv/json/text/binary/numpy/range) are
implemented on this surface — the same extension point user formats use.
"""

from __future__ import annotations

import glob as _glob
import os
from abc import ABC, abstractmethod
from typing import Any, Callable, Dict, Iterable, List, Optional

from ray_tpu_torch.data import block as B


class ReadTask:
    """One unit of parallel read work: a no-arg callable returning an
    iterable of blocks, plus optional metadata (row-count/size estimates
    used for scheduling hints)."""

    def __init__(self, read_fn: Callable[[], Iterable[Any]],
                 metadata: Optional[Dict] = None):
        self.read_fn = read_fn
        self.metadata = metadata or {}

    def __call__(self) -> List[Any]:
        return list(self.read_fn())


class Datasource(ABC):
    """Produces ReadTasks for parallel ingestion (reference:
    datasource.py:Datasource)."""

    @abstractmethod
    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        """Split this source into up to `parallelism` independent reads."""

    def estimate_inmemory_data_size(self) -> Optional[int]:
        return None

    def get_name(self) -> str:
        return type(self).__name__


class Datasink(ABC):
    """Receives blocks from parallel write tasks (reference:
    datasink.py:Datasink)."""

    def on_write_start(self) -> None:
        """Driver-side hook before any write task runs."""

    @abstractmethod
    def write(self, block: Any, ctx: Dict) -> Any:
        """Write one block (runs in a remote worker). `ctx` carries
        {"task_index": int}. Returns a result collected by
        on_write_complete."""

    def on_write_complete(self, write_results: List[Any]) -> None:
        """Driver-side hook after every write task succeeded."""

    def on_write_failed(self, error: Exception) -> None:
        """Driver-side hook when any write task failed."""

    def get_name(self) -> str:
        return type(self).__name__


# ---------------------------------------------------------------------------
# File-based sources
# ---------------------------------------------------------------------------


class FileBasedDatasource(Datasource):
    """Shared machinery for one-file-per-read-task formats: expands a
    path or directory glob, one ReadTask per file (reference:
    file_based_datasource.py). Cloud URIs (s3:// gs:// hdfs:// ...)
    resolve through pyarrow.fs — the same layer checkpoint storage and
    spilling ride; an explicit `filesystem` overrides resolution (tests
    inject local fakes for cloud-shaped paths)."""

    _GLOB = "*"

    def __init__(self, path: str, filesystem=None):
        self.path = path
        self.filesystem = filesystem

    def _fs(self):
        """(pyarrow FileSystem, fs-local base path) or (None, local path)."""
        if self.filesystem is not None:
            return self.filesystem, self.path.split("://", 1)[-1]
        if "://" in self.path and not self.path.startswith("file://"):
            import pyarrow.fs as pafs

            return pafs.FileSystem.from_uri(self.path)
        return None, self.path.removeprefix("file://")

    def _paths(self) -> List[str]:
        import fnmatch

        fs, base = self._fs()
        if fs is None:
            if os.path.isdir(base):
                paths = sorted(_glob.glob(os.path.join(base, self._GLOB)))
            else:
                paths = sorted(_glob.glob(base)) or [base]
        else:
            import pyarrow.fs as pafs

            info = fs.get_file_info(base)
            if info.type == pafs.FileType.Directory:
                sel = pafs.FileSelector(base, recursive=False)
                paths = sorted(
                    f.path for f in fs.get_file_info(sel)
                    if f.is_file and fnmatch.fnmatch(
                        os.path.basename(f.path), self._GLOB
                    )
                )
            else:
                paths = [base]
        if not paths:
            raise FileNotFoundError(
                f"no {self._GLOB} files under {self.path!r}"
            )
        return paths

    @abstractmethod
    def _read_file(self, path: str) -> Any:
        """Parse one file into a block (runs in a remote worker). `path`
        is opened through _open (local or pyarrow.fs)."""

    def _open(self, path: str, mode: str = "rb", seekable: bool = False):
        fs, _ = self._fs()
        if fs is None:
            return open(path, mode)
        # Parquet readers need random access; sequential formats stream.
        return (fs.open_input_file(path) if seekable
                else fs.open_input_stream(path))

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        read = self._read_file
        return [
            ReadTask(
                (lambda p=p: [read(p)]),
                {"path": p, "size_bytes": self._safe_size(p)},
            )
            for p in self._paths()
        ]

    def _safe_size(self, p: str) -> Optional[int]:
        fs, _ = self._fs()
        if fs is None:
            return _safe_size(p)
        try:
            info = fs.get_file_info(p)
            return info.size if info.is_file else None
        except Exception:  # noqa: BLE001
            return None

    def estimate_inmemory_data_size(self) -> Optional[int]:
        try:
            return sum(self._safe_size(p) or 0 for p in self._paths())
        except FileNotFoundError:
            return None


def _safe_size(p: str) -> Optional[int]:
    try:
        return os.path.getsize(p)
    except OSError:
        return None


class ParquetDatasource(FileBasedDatasource):
    _GLOB = "*.parquet"

    def _read_file(self, path: str):
        import pyarrow.parquet as pq

        with self._open(path, seekable=True) as f:
            return pq.read_table(f)


class CSVDatasource(FileBasedDatasource):
    _GLOB = "*.csv"

    def _read_file(self, path: str):
        import pyarrow.csv as pacsv

        with self._open(path) as f:
            return pacsv.read_csv(f)


class JSONDatasource(FileBasedDatasource):
    _GLOB = "*.jsonl"

    def _read_file(self, path: str):
        import pyarrow.json as pajson

        with self._open(path) as f:
            return pajson.read_json(f)


class TextDatasource(FileBasedDatasource):
    _GLOB = "*"

    def _read_file(self, path: str):
        import io

        with self._open(path) as f:
            text = io.TextIOWrapper(f, encoding="utf-8") if not isinstance(
                f, io.TextIOBase) else f
            return B.block_from_rows(
                [{"text": line.rstrip("\n")} for line in text]
            )


class BinaryDatasource(FileBasedDatasource):
    """Whole-file bytes rows: {"path", "bytes"} (reference:
    binary_datasource.py)."""

    _GLOB = "*"

    def _read_file(self, path: str):
        with self._open(path) as f:
            return B.block_from_rows([{"path": path, "bytes": f.read()}])


class ImageDatasource(FileBasedDatasource):
    """Decoded image rows: {"path", "image"} as uint8 numpy arrays
    (reference: data/datasource/image_datasource.py). Default mode="RGB"
    so every row is (H, W, 3) regardless of source format (palette GIFs,
    grayscale PNGs, RGBA) — batches stack cleanly; pass mode="L" for
    (H, W) grayscale or mode=None to keep each file's native mode.
    Optional size=(h, w) resizes at read time. Decode happens IN the
    read tasks, so a directory of images streams through the executor
    without driver-side decoding."""

    _GLOB = "*"
    _EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp")

    def __init__(self, path: str, filesystem=None, size=None, mode="RGB"):
        super().__init__(path, filesystem)
        self.size = size
        self.mode = mode

    def _paths(self):
        all_paths = super()._paths()
        paths = [p for p in all_paths if p.lower().endswith(self._EXTS)]
        if not paths:
            raise FileNotFoundError(
                f"no image files ({', '.join(self._EXTS)}) under "
                f"{self.path!r}"
            )
        return paths

    def _read_file(self, path: str):
        import io

        import numpy as np
        from PIL import Image

        with self._open(path) as f:
            img = Image.open(io.BytesIO(f.read()))
            if self.mode is not None:
                img = img.convert(self.mode)
            if self.size is not None:
                img = img.resize((self.size[1], self.size[0]))
            return B.block_from_rows(
                [{"path": path, "image": np.asarray(img)}]
            )


class NpyDatasource(FileBasedDatasource):
    """One row per .npy file: {"path", "data"} (reference:
    numpy_datasource.py reading .npy files)."""

    _GLOB = "*.npy"

    def _read_file(self, path: str):
        import io

        import numpy as np

        with self._open(path) as f:
            arr = np.load(io.BytesIO(f.read()), allow_pickle=False)
        return B.block_from_rows([{"path": path, "data": arr}])


# ---------------------------------------------------------------------------
# Synthetic / in-memory sources
# ---------------------------------------------------------------------------


class RangeDatasource(Datasource):
    """Rows {"id": i} for i in [0, n) generated IN the read tasks — no
    driver-side materialization (reference: range_datasource.py)."""

    def __init__(self, n: int):
        self.n = n

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        parallelism = max(1, min(parallelism, self.n or 1))
        per = (self.n + parallelism - 1) // parallelism
        tasks = []
        for i in range(parallelism):
            lo, hi = i * per, min((i + 1) * per, self.n)
            if lo >= hi and i > 0:
                continue
            tasks.append(ReadTask(
                (lambda lo=lo, hi=hi:
                 [B.block_from_rows([{"id": j} for j in range(lo, hi)])]),
                {"num_rows": hi - lo},
            ))
        return tasks

    def estimate_inmemory_data_size(self) -> Optional[int]:
        return self.n * 8


class NumpyDatasource(Datasource):
    """Columnar numpy arrays split into row-range read tasks."""

    def __init__(self, arrays: Dict[str, Any]):
        self.arrays = arrays

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        keys = list(self.arrays.keys())
        n = len(self.arrays[keys[0]]) if keys else 0
        parallelism = max(1, min(parallelism, n or 1))
        per = (n + parallelism - 1) // parallelism
        arrays = self.arrays

        import numpy as _np

        multi_dim = any(
            getattr(_np.asarray(arrays[k]), "ndim", 1) > 1 for k in keys
        )

        def make(lo, hi):
            def read():
                if multi_dim:
                    # Tensor columns: the slice stays ONE arrow column
                    # (FixedSizeList storage) instead of N row objects —
                    # zero-copy batching then applies to tensors too.
                    from ray_tpu_torch.data.tensor import table_with_tensors

                    return [table_with_tensors(
                        {k: arrays[k][lo:hi] for k in keys}
                    )]
                rows = [
                    {k: _np_item(arrays[k][i]) for k in keys}
                    for i in range(lo, hi)
                ]
                return [B.block_from_rows(rows)]

            return read

        return [
            ReadTask(make(i * per, min((i + 1) * per, n)),
                     {"num_rows": min((i + 1) * per, n) - i * per})
            for i in range(parallelism)
            if i * per < n or i == 0
        ]


def _np_item(v):
    return v.item() if hasattr(v, "item") and getattr(v, "ndim", 1) == 0 else v


# ---------------------------------------------------------------------------
# File-based sinks
# ---------------------------------------------------------------------------


class FileBasedDatasink(Datasink):
    """One file per block under a directory (reference: the
    _FileDatasink write model). Cloud URIs resolve through pyarrow.fs;
    an explicit `filesystem` overrides resolution."""

    _EXT = "bin"

    def __init__(self, path: str, filesystem=None):
        self.filesystem = filesystem
        if filesystem is not None:
            self.path = path.split("://", 1)[-1]
            self._uri_prefix = path.rsplit(self.path, 1)[0]
        elif "://" in path and not path.startswith("file://"):
            import pyarrow.fs as pafs

            self.filesystem, self.path = pafs.FileSystem.from_uri(path)
            self._uri_prefix = path[: len(path) - len(self.path)]
        else:
            self.path = os.path.abspath(path.removeprefix("file://"))
            self._uri_prefix = ""

    def on_write_start(self) -> None:
        if self.filesystem is not None:
            self.filesystem.create_dir(self.path, recursive=True)
        else:
            os.makedirs(self.path, exist_ok=True)

    @abstractmethod
    def _write_rows(self, rows: List[Any], file_path: str) -> None:
        """Persist one block's rows (runs in a remote worker); open the
        target through _open_output."""

    def _open_output(self, file_path: str, text: bool = False):
        if self.filesystem is not None:
            stream = self.filesystem.open_output_stream(file_path)
            if text:
                import io

                return io.TextIOWrapper(stream, encoding="utf-8")
            return stream
        return open(file_path, "w" if text else "wb")

    def write(self, block: Any, ctx: Dict) -> Any:
        rows = B.block_to_rows(block)
        if not rows:
            return None
        fp = f"{self.path}/part-{ctx['task_index']:05d}.{self._EXT}"
        self._write_rows(rows, fp)
        return self._uri_prefix + fp if self._uri_prefix else fp


class ParquetDatasink(FileBasedDatasink):
    _EXT = "parquet"

    def _write_rows(self, rows, file_path):
        import pyarrow as pa
        import pyarrow.parquet as pq

        with self._open_output(file_path) as f:
            pq.write_table(pa.Table.from_pylist(rows), f)


class CSVDatasink(FileBasedDatasink):
    _EXT = "csv"

    def _write_rows(self, rows, file_path):
        import pyarrow as pa
        import pyarrow.csv as pacsv

        with self._open_output(file_path) as f:
            pacsv.write_csv(pa.Table.from_pylist(rows), f)


class JSONDatasink(FileBasedDatasink):
    _EXT = "jsonl"

    def _write_rows(self, rows, file_path):
        import json as _json

        from ray_tpu_torch.data.dataset import _json_fallback

        with self._open_output(file_path, text=True) as f:
            for r in rows:
                f.write(_json.dumps(r, default=_json_fallback) + "\n")
