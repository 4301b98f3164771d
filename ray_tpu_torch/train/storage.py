"""Checkpoint persistence to a storage URI via pyarrow.fs (the port of
ray_tpu/train/storage.py).

Analog of the reference's StorageContext (train/_internal/storage.py:348):
RunConfig.storage_path resolves through pyarrow.fs.FileSystem.from_uri so
the same code persists to a local path, file://, s3://, gs://, or
hdfs:// — whatever the pyarrow build supports. Checkpoints upload
per-file (each host pushes only the files it wrote), and
download materializes a remote checkpoint into a local directory for
restoration.
"""

from __future__ import annotations

import os
import posixpath
import shutil
import tempfile
from typing import List, Optional, Tuple

from ray_tpu_torch.train.checkpoint import Checkpoint


def _resolve(uri: str) -> Tuple["pyarrow.fs.FileSystem", str]:  # noqa: F821
    import pyarrow.fs as pafs

    if "://" in uri:
        return pafs.FileSystem.from_uri(uri)
    return pafs.LocalFileSystem(), os.path.abspath(uri)


class StorageContext:
    """Uploads/downloads checkpoint directories under
    <storage_path>/<experiment_name>/."""

    def __init__(self, storage_path: str, experiment_name: str = ""):
        self.storage_path = storage_path
        self.experiment_name = experiment_name
        self.fs, base = _resolve(storage_path)
        self.base = (
            posixpath.join(base, experiment_name) if experiment_name else base
        )

    def _remote_path(self, name: str) -> str:
        return posixpath.join(self.base, name)

    def persist(self, checkpoint: Checkpoint, name: str) -> str:
        """Upload a local checkpoint directory; returns its storage URI
        (reference: StorageContext.persist_current_checkpoint)."""
        dest = self._remote_path(name)
        self.fs.create_dir(dest, recursive=True)
        root = checkpoint.path
        for dirpath, _dirnames, filenames in os.walk(root):
            rel = os.path.relpath(dirpath, root)
            rdir = dest if rel == "." else posixpath.join(
                dest, rel.replace(os.sep, "/")
            )
            if rel != ".":
                self.fs.create_dir(rdir, recursive=True)
            for fname in filenames:
                with open(os.path.join(dirpath, fname), "rb") as src, \
                        self.fs.open_output_stream(
                            posixpath.join(rdir, fname)) as out:
                    # Chunked copy: checkpoint shards can be multi-GB;
                    # a whole-file read() would spike host RSS.
                    shutil.copyfileobj(src, out, length=16 * 1024 * 1024)
        return (
            f"{self.storage_path.rstrip('/')}/"
            + (f"{self.experiment_name}/" if self.experiment_name else "")
            + name
        )

    def download(self, name: str, local_dir: Optional[str] = None) -> Checkpoint:
        """Materialize a persisted checkpoint into a local directory."""
        import pyarrow.fs as pafs

        src = self._remote_path(name)
        local_dir = local_dir or tempfile.mkdtemp(prefix="rt_ckpt_dl_")
        infos = self.fs.get_file_info(
            pafs.FileSelector(src, recursive=True)
        )
        for info in infos:
            rel = posixpath.relpath(info.path, src)
            local = os.path.join(local_dir, *rel.split("/"))
            if info.type == pafs.FileType.Directory:
                os.makedirs(local, exist_ok=True)
                continue
            os.makedirs(os.path.dirname(local), exist_ok=True)
            with self.fs.open_input_stream(info.path) as inp, \
                    open(local, "wb") as out:
                shutil.copyfileobj(inp, out, length=16 * 1024 * 1024)
        return Checkpoint.from_directory(local_dir)

    def delete(self, name: str) -> None:
        """Remove a persisted checkpoint (retention cleanup)."""
        self.fs.delete_dir(self._remote_path(name))

    def list_checkpoints(self) -> List[str]:
        import pyarrow.fs as pafs

        try:
            infos = self.fs.get_file_info(
                pafs.FileSelector(self.base, recursive=False)
            )
        except FileNotFoundError:
            return []
        return sorted(
            posixpath.basename(i.path) for i in infos
            if i.type == pafs.FileType.Directory
        )
