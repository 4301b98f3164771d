"""External storage for spilled objects.

Analog of the reference's python/ray/_private/external_storage.py
(ExternalStorage ABC :72, FileSystemStorage :246, smart_open/S3 impl :445).
The raylet spills pinned primary copies here when the shared-memory store
passes its high-water mark, and restores them on demand.
"""

from __future__ import annotations

import os
import uuid
from abc import ABC, abstractmethod
from typing import List, Optional


class ExternalStorage(ABC):
    @abstractmethod
    def spill(self, object_id: bytes, data: memoryview) -> str:
        """Write one object; returns a restore URI."""

    @abstractmethod
    def restore(self, uri: str) -> bytes:
        """Read a spilled object back."""

    @abstractmethod
    def delete(self, uris: List[str]) -> None:
        """Best-effort cleanup of spilled objects."""


class FileSystemStorage(ExternalStorage):
    """Spill to a node-local (or network-mounted) directory."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def spill(self, object_id: bytes, data: memoryview) -> str:
        fname = f"{object_id.hex()}-{uuid.uuid4().hex[:8]}.bin"
        path = os.path.join(self.directory, fname)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.rename(tmp, path)
        return "file://" + path

    def restore(self, uri: str) -> bytes:
        path = uri.removeprefix("file://")
        with open(path, "rb") as f:
            return f.read()

    def delete(self, uris: List[str]) -> None:
        for uri in uris:
            try:
                os.unlink(uri.removeprefix("file://"))
            except OSError:
                pass


class UriStorage(ExternalStorage):
    """Spill to any pyarrow.fs-resolvable URI — s3://, gs://, hdfs://,
    mock:// (the same resolution layer train/storage.py drives for
    checkpoints; reference: external_storage.py:445 ExternalStorageSmartOpenImpl).

    An explicit `filesystem` overrides URI resolution (tests inject a
    local fake filesystem for s3://-shaped URIs)."""

    def __init__(self, base_uri: str, filesystem=None, base_path: Optional[str] = None):
        import pyarrow.fs as pafs

        self.base_uri = base_uri.rstrip("/")
        if filesystem is not None:
            self.fs = filesystem
            self.path = (base_path if base_path is not None
                         else self._strip_scheme(self.base_uri))
        else:
            self.fs, self.path = pafs.FileSystem.from_uri(self.base_uri)
        self.fs.create_dir(self.path, recursive=True)

    @staticmethod
    def _strip_scheme(uri: str) -> str:
        rest = uri.split("://", 1)[-1]
        return rest

    def spill(self, object_id: bytes, data: memoryview) -> str:
        fname = f"{object_id.hex()}-{uuid.uuid4().hex[:8]}.bin"
        path = f"{self.path}/{fname}"
        with self.fs.open_output_stream(path) as f:
            f.write(data)
        return f"{self.base_uri}/{fname}"

    def _fs_path(self, uri: str) -> str:
        assert uri.startswith(self.base_uri + "/"), uri
        return f"{self.path}/{uri[len(self.base_uri) + 1:]}"

    def restore(self, uri: str) -> bytes:
        with self.fs.open_input_stream(self._fs_path(uri)) as f:
            return f.read()

    def delete(self, uris: List[str]) -> None:
        for uri in uris:
            try:
                self.fs.delete_file(self._fs_path(uri))
            except Exception:  # noqa: BLE001 — best-effort cleanup
                pass


def create_storage(node_id_hex: str, spill_dir: Optional[str] = None,
                   filesystem=None) -> ExternalStorage:
    base = spill_dir or os.environ.get("RT_SPILL_DIR") or os.path.join(
        os.environ.get("TMPDIR", "/tmp"), "ray_tpu_torch", "spill"
    )
    if "://" in base:
        # s3:// gs:// hdfs:// file:// ... — anything pyarrow.fs resolves
        # (file:// rides UriStorage too, which is the e2e test path for
        # the URI backend without cloud credentials).
        return UriStorage(f"{base.rstrip('/')}/{node_id_hex[:12]}",
                          filesystem=filesystem)
    return FileSystemStorage(os.path.join(base, node_id_hex[:12]))
