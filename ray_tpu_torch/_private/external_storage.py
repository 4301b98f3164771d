"""External storage for spilled objects.

Analog of the reference's python/ray/_private/external_storage.py
(ExternalStorage ABC :72, FileSystemStorage :246).
The raylet spills pinned primary copies here when the shared-memory store
passes its high-water mark, and restores them on demand.
"""

from __future__ import annotations

import os
import uuid
from abc import ABC, abstractmethod
from typing import List, Optional

from ray_tpu_torch._private.not_ported import not_ported


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


def create_storage(node_id_hex: str,
                   spill_dir: Optional[str] = None) -> ExternalStorage:
    base = spill_dir or os.environ.get("RT_SPILL_DIR") or os.path.join(
        os.environ.get("TMPDIR", "/tmp"), "ray_tpu_torch", "spill"
    )
    if "://" in base:
        # s3://, gs://, file:// ... spill through pyarrow.fs, which the
        # port does not carry yet.
        raise not_ported("spilling to a URI")
    return FileSystemStorage(os.path.join(base, node_id_hex[:12]))
