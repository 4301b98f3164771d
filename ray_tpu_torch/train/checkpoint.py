"""Checkpoints: directories, with a flat tensor file for parameter trees
(the port of ray_tpu/train/checkpoint.py).

Analog of the reference's Checkpoint (train/_checkpoint.py:55, a directory
plus a pyarrow-fs handle) and CheckpointManager
(train/_internal/checkpoint_manager.py, top-k retention). Where the JAX
package writes pytrees with orbax, the port writes a tree of tensors as one
flat file: `pytree/index.json` (the tree's structure and, per leaf, its
dtype, shape, device and byte range) beside `pytree/data.bin` (every
leaf's raw bytes, bf16 bit for bit). Nested dicts, lists and tuples are
flattened here in place of jax.tree_util (`flatten_tree`).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import sys
import tempfile
import threading
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._vendor import cloudpickle

logger = logging.getLogger("ray_tpu_torch.train.checkpoint")

_TREE_DIR = "pytree"
_TREE_FORMAT = "ray_tpu_torch.tree/1"
_ALIGN = 64


# -- trees -----------------------------------------------------------------
def flatten_tree(tree: Any) -> Tuple[List[Any], Dict]:
    """The leaves of a nested dict/list/tuple tree, dict keys in sorted
    order as jax.tree_util takes them, and a JSON-able spec that
    `unflatten_tree` rebuilds the tree from. None is an empty subtree, as
    in jax."""
    leaves: List[Any] = []

    def walk(x):
        if isinstance(x, dict):
            return {"d": [[k, walk(x[k])] for k in sorted(x)]}
        if isinstance(x, list):
            return {"l": [walk(v) for v in x]}
        if isinstance(x, tuple):
            return {"t": [walk(v) for v in x]}
        if x is None:
            return {"n": 0}
        leaves.append(x)
        return {"x": len(leaves) - 1}

    return leaves, walk(tree)


def unflatten_tree(spec: Dict, leaves: List[Any]) -> Any:
    if "d" in spec:
        return {k: unflatten_tree(v, leaves) for k, v in spec["d"]}
    if "l" in spec:
        return [unflatten_tree(v, leaves) for v in spec["l"]]
    if "t" in spec:
        return tuple(unflatten_tree(v, leaves) for v in spec["t"])
    if "n" in spec:
        return None
    return leaves[spec["x"]]


def _torch():
    """torch if this process already loaded it, else None: a tree with a
    tensor in it means torch is loaded, and importing this module must not
    load it (a CUDA context made before the zygote forks breaks CUDA in
    every child)."""
    return sys.modules.get("torch")


def _is_tensor(x) -> bool:
    torch = _torch()
    return torch is not None and isinstance(x, torch.Tensor)


def _snapshot(leaves: List[Any]) -> Tuple[List[Any], List[Optional[str]]]:
    """Host copies of the leaves (tensors copied on the caller's stream,
    which waits for the copy) and each tensor's device type."""
    import numpy as np

    host, devices = [], []
    for leaf in leaves:
        if _is_tensor(leaf):
            devices.append(leaf.device.type)
            host.append(leaf.detach().to("cpu", copy=True).contiguous())
        elif isinstance(leaf, (np.ndarray, np.generic)):
            devices.append(None)
            host.append(np.array(leaf))
        elif isinstance(leaf, (bool, int, float, str)):
            devices.append(None)
            host.append(leaf)
        else:
            raise TypeError(f"cannot checkpoint a leaf of type "
                            f"{type(leaf).__name__}")
    return host, devices


def _write_tree(directory: str, spec: Dict, host: List[Any],
                devices: List[Optional[str]]) -> int:
    """Write snapshotted leaves as index.json + data.bin; returns the
    bytes of data.bin. Both files land through a rename, the index last,
    so a reader never sees a partial checkpoint."""
    import numpy as np

    os.makedirs(directory, exist_ok=True)
    data_path = os.path.join(directory, "data.bin")
    entries, offset = [], 0
    with open(data_path + ".tmp", "wb") as f:
        for leaf, dev in zip(host, devices):
            if _is_tensor(leaf):
                torch = _torch()
                raw = leaf.reshape(-1).view(torch.uint8).numpy()
                entry = {"kind": "tensor",
                         "dtype": str(leaf.dtype).removeprefix("torch."),
                         "shape": list(leaf.shape), "device": dev}
            elif isinstance(leaf, np.ndarray):
                a = np.ascontiguousarray(leaf)
                raw = a.reshape(-1).view(np.uint8)
                entry = {"kind": "ndarray", "dtype": a.dtype.str,
                         "shape": list(a.shape)}
            else:
                entries.append({"kind": "scalar", "value": leaf})
                continue
            entry.update(offset=offset, nbytes=int(raw.nbytes))
            f.write(memoryview(raw))
            pad = -raw.nbytes % _ALIGN
            f.write(b"\0" * pad)
            offset += raw.nbytes + pad
            entries.append(entry)
    os.replace(data_path + ".tmp", data_path)
    index_path = os.path.join(directory, "index.json")
    with open(index_path + ".tmp", "w") as f:
        json.dump({"format": _TREE_FORMAT, "spec": spec,
                   "leaves": entries}, f)
    os.replace(index_path + ".tmp", index_path)
    return offset


def save_tree(tree: Any, directory: str) -> int:
    leaves, spec = flatten_tree(tree)
    host, devices = _snapshot(leaves)
    return _write_tree(directory, spec, host, devices)


def load_tree(directory: str, template: Any = None, device=None) -> Any:
    """Read a tree written by `save_tree`. Each tensor goes to `device`,
    else to the device of the template's leaf in its place, else to the
    device type it was saved from (a tensor saved from the card comes
    back on the card)."""
    import numpy as np

    with open(os.path.join(directory, "index.json")) as f:
        index = json.load(f)
    if index.get("format") != _TREE_FORMAT:
        raise ValueError(f"{directory} is not a {_TREE_FORMAT} tree")
    tmpl = None
    if template is not None:
        tmpl, tspec = flatten_tree(template)
        if tspec != index["spec"]:
            raise ValueError("the template's structure differs from the "
                             "checkpoint's")
    data = np.fromfile(os.path.join(directory, "data.bin"), dtype=np.uint8)
    leaves = []
    for i, e in enumerate(index["leaves"]):
        if e["kind"] == "scalar":
            leaves.append(e["value"])
            continue
        raw = data[e["offset"]:e["offset"] + e["nbytes"]]
        if e["kind"] == "ndarray":
            leaves.append(raw.view(np.dtype(e["dtype"]))
                          .reshape(e["shape"]).copy())
            continue
        import torch

        t = torch.from_numpy(raw).view(getattr(torch, e["dtype"]))
        t = t.reshape(e["shape"])
        dev = device
        if dev is None and tmpl is not None and _is_tensor(tmpl[i]):
            dev = tmpl[i].device
        if dev is None:
            dev = e["device"]
        leaves.append(t.to(dev) if torch.device(dev).type != "cpu"
                      else t.clone())
    return unflatten_tree(index["spec"], leaves)


class Checkpoint:
    """A directory full of checkpoint data (reference: from_directory
    train/_checkpoint.py:178)."""

    def __init__(self, path: str):
        self.path = path

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(os.path.abspath(path))

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        d = tempfile.mkdtemp(prefix="rt_ckpt_")
        with open(os.path.join(d, "data.pkl"), "wb") as f:
            cloudpickle.dump(data, f)
        return cls(d)

    def to_dict(self) -> Dict[str, Any]:
        with open(os.path.join(self.path, "data.pkl"), "rb") as f:
            return cloudpickle.load(f)

    def as_directory(self) -> str:
        return self.path

    # -- trees of tensors as one flat file ------------------------------

    @classmethod
    def from_pytree(cls, tree: Any, path: str) -> "Checkpoint":
        """Save a tree (nested dicts/lists/tuples) of tensors, numpy
        arrays and Python scalars."""
        path = os.path.abspath(path)
        save_tree(tree, os.path.join(path, _TREE_DIR))
        return cls(path)

    def to_pytree(self, template: Any = None, device=None) -> Any:
        return load_tree(os.path.join(self.path, _TREE_DIR), template,
                         device)

    def __repr__(self):
        return f"Checkpoint({self.path})"


class CheckpointManager:
    """Top-k retention by score (reference:
    train/_internal/checkpoint_manager.py)."""

    def __init__(
        self,
        directory: str,
        num_to_keep: Optional[int] = None,
        score_attribute: Optional[str] = None,
        score_order: str = "max",
        storage=None,
    ):
        self.directory = directory
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.score_order = score_order
        # Optional StorageContext: registered checkpoints also persist to
        # the run's storage_path URI (reference: per-rank upload through
        # StorageContext, train/_internal/storage.py:348).
        self.storage = storage
        self.registered: List[Dict] = []
        os.makedirs(directory, exist_ok=True)
        self._index = 0
        self._uploaded = 0  # sequential storage names: ordering is meaning

    def next_checkpoint_path(self) -> str:
        path = os.path.join(self.directory, f"checkpoint_{self._index:06d}")
        self._index += 1
        return path

    def register(self, checkpoint: Checkpoint, metrics: Dict) -> None:
        entry = {"checkpoint": checkpoint, "metrics": metrics}
        if self.storage is not None:
            # Sequential names: a local checkpoint dir may be a random
            # tempdir (Checkpoint.from_dict), whose basename would make
            # list_checkpoints() ordering — and "latest" selection —
            # arbitrary.
            name = f"checkpoint_{self._uploaded:06d}"
            self._uploaded += 1
            try:
                entry["uri"] = self.storage.persist(checkpoint, name)
                entry["storage_name"] = name
            except Exception as e:  # noqa: BLE001 — storage outage must
                entry["uri_error"] = str(e)  # not kill the training loop
        self.registered.append(entry)
        self._enforce_retention()
        self._write_index()

    def best_checkpoint(self) -> Optional[Checkpoint]:
        if not self.registered:
            return None
        if self.score_attribute is None:
            return self.registered[-1]["checkpoint"]
        key = lambda e: e["metrics"].get(
            self.score_attribute, float("-inf") if self.score_order == "max" else float("inf")
        )
        best = (max if self.score_order == "max" else min)(self.registered, key=key)
        return best["checkpoint"]

    def latest_checkpoint(self) -> Optional[Checkpoint]:
        return self.registered[-1]["checkpoint"] if self.registered else None

    def _enforce_retention(self):
        if self.num_to_keep is None or len(self.registered) <= self.num_to_keep:
            return
        if self.score_attribute is not None:
            order = sorted(
                self.registered,
                key=lambda e: e["metrics"].get(self.score_attribute, 0),
                reverse=self.score_order == "max",
            )
        else:
            order = list(reversed(self.registered))  # newest first
        keep = order[: self.num_to_keep]
        drop = [e for e in self.registered if e not in keep]
        for e in drop:
            try:
                shutil.rmtree(e["checkpoint"].path, ignore_errors=True)
            except OSError:
                pass
            # Retention applies to the storage URI too — dropping only
            # the local copy would grow remote storage without bound.
            if self.storage is not None and "storage_name" in e:
                try:
                    self.storage.delete(e["storage_name"])
                except Exception:  # noqa: BLE001 — best-effort cleanup
                    # Silent failure here grows remote storage without
                    # bound, so at least leave a trace.
                    logger.warning("retention could not delete %r from "
                                   "storage", e["storage_name"],
                                   exc_info=True)
            self.registered.remove(e)

    def _write_index(self):
        index = [
            {"path": e["checkpoint"].path, "metrics": _json_safe(e["metrics"]),
             **({"uri": e["uri"]} if "uri" in e else {})}
            for e in self.registered
        ]
        with open(os.path.join(self.directory, "checkpoints.json"), "w") as f:
            json.dump(index, f, indent=2)


def _json_safe(d: Dict) -> Dict:
    out = {}
    for k, v in d.items():
        try:
            json.dumps(v)
            out[k] = v
        except TypeError:
            out[k] = str(v)
    return out


def _as_numpy(leaf) -> Tuple[Any, Optional[str]]:
    """A leaf as a host numpy array, with its torch dtype's name when it
    was a tensor (bf16 goes through an int16 view of the same bits:
    numpy has no bfloat16)."""
    import numpy as np

    if _is_tensor(leaf):
        torch = _torch()
        t = leaf.detach().to("cpu")
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy(), name
    return np.asarray(leaf), None


def _from_numpy(arr, torch_dtype: Optional[str]):
    if torch_dtype is None:
        return arr
    import numpy as np
    import torch

    t = torch.from_numpy(np.array(arr))
    return t.view(torch.bfloat16) if torch_dtype == "bfloat16" else t


class ShardRemapPlan:
    """Deterministic old_world → new_world re-shard assignment.

    Every pytree leaf is flattened to 1-D and cut into `world` contiguous
    slices with np.array_split boundaries (the first ``size % world``
    ranks get one extra element), so the slice a rank owns is a pure
    function of (leaf size, world, rank). A plan between two world sizes
    is then a bijection on element positions by construction: each new
    rank's slice is assembled from the (at most two, for any divisor or
    non-divisor pair) old slices it overlaps, and reassembling all new
    slices yields the original tree bit-for-bit.

    Elastic resize executes this plan through the object store: each old
    rank publishes its slices once, each new rank fetches only
    ``sources_for(new_rank)`` — no full gather, no disk round trip.
    """

    def __init__(self, old_world: int, new_world: int, leaf_sizes: List[int],
                 leaf_dtypes: Optional[List] = None):
        if old_world < 1 or new_world < 1:
            raise ValueError("world sizes must be >= 1")
        self.old_world = old_world
        self.new_world = new_world
        self.leaf_sizes = [int(s) for s in leaf_sizes]
        # Per-leaf dtypes keep empty slices typed (a rank whose cut of a
        # scalar leaf is empty has no source shard to infer from).
        self.leaf_dtypes = leaf_dtypes

    @staticmethod
    def bounds(size: int, world: int) -> List[tuple]:
        """(start, stop) of each rank's slice of a flat leaf of `size`."""
        base, extra = divmod(size, world)
        out, start = [], 0
        for r in range(world):
            stop = start + base + (1 if r < extra else 0)
            out.append((start, stop))
            start = stop
        return out

    @classmethod
    def for_tree(cls, tree: Any, old_world: int,
                 new_world: int) -> "ShardRemapPlan":
        leaves = [_as_numpy(l)[0] for l in flatten_tree(tree)[0]]
        return cls(old_world, new_world, [int(l.size) for l in leaves],
                   [l.dtype for l in leaves])

    def segments_for(self, new_rank: int) -> List[tuple]:
        """(leaf, old_rank, src_lo, src_hi, dst_lo) segments that build
        `new_rank`'s slice of every leaf. src offsets are relative to the
        old rank's slice start; dst to the new rank's."""
        segs = []
        for leaf, size in enumerate(self.leaf_sizes):
            old_b = self.bounds(size, self.old_world)
            ds, de = self.bounds(size, self.new_world)[new_rank]
            for old_rank, (os_, oe) in enumerate(old_b):
                lo, hi = max(ds, os_), min(de, oe)
                if lo >= hi:
                    continue
                segs.append((leaf, old_rank, lo - os_, hi - os_, lo - ds))
        return segs

    def sources_for(self, new_rank: int) -> List[int]:
        """Old ranks whose slices `new_rank` needs (sorted, deduped)."""
        return sorted({s[1] for s in self.segments_for(new_rank)})

    def remap(self, new_rank: int, old_shards: Dict[int, List]) -> List:
        """Assemble `new_rank`'s per-leaf slices from old ranks' slices.

        old_shards maps old_rank → per-leaf 1-D arrays (only the ranks in
        sources_for(new_rank) need be present).
        """
        import numpy as np

        out = []
        for leaf, size in enumerate(self.leaf_sizes):
            ds, de = self.bounds(size, self.new_world)[new_rank]
            buf = None
            for l, old_rank, src_lo, src_hi, dst_lo in self.segments_for(new_rank):
                if l != leaf:
                    continue
                src = np.asarray(old_shards[old_rank][leaf])
                if buf is None:
                    buf = np.empty(de - ds, dtype=src.dtype)
                buf[dst_lo:dst_lo + (src_hi - src_lo)] = src[src_lo:src_hi]
            if buf is None:
                dt = (self.leaf_dtypes[leaf]
                      if self.leaf_dtypes is not None else np.float32)
                buf = np.empty(de - ds, dtype=dt)
            out.append(buf)
        return out


class ShardedState:
    """One rank's slice of a sharded pytree (ZeRO-style optimizer state).

    Holds the full tree's structure + leaf shapes/dtypes (the meta every
    rank shares) and this rank's contiguous 1-D slice of each leaf. The
    elastic resize path (train.sync_resize) republishes these slices
    through the object store and rebuilds them under the new world size
    via ShardRemapPlan — bit-for-bit, since remapping only moves bytes.
    """

    def __init__(self, meta: Dict, rank: int, world: int, slices: List):
        # {"spec", "shapes", "dtypes", "torch_dtypes", "sizes", "scalars"}
        self.meta = meta
        self.rank = rank
        self.world = world
        self.slices = slices  # per-leaf 1-D np arrays (this rank's cut)

    @classmethod
    def create(cls, tree: Any, rank: int, world: int) -> "ShardedState":
        """Shard a full pytree: rank keeps only its slice of each leaf."""
        leaves, spec = flatten_tree(tree)
        host = [_as_numpy(l) for l in leaves]
        flats = [a.reshape(-1) for a, _ in host]
        meta = {
            "spec": spec,
            "shapes": [a.shape for a, _ in host],
            "dtypes": [f.dtype for f in flats],
            "torch_dtypes": [td for _, td in host],
            "sizes": [f.size for f in flats],
            "scalars": [isinstance(l, (int, float, bool)) for l in leaves],
        }
        bounds = [ShardRemapPlan.bounds(f.size, world)[rank] for f in flats]
        slices = [f[lo:hi].copy() for f, (lo, hi) in zip(flats, bounds)]
        return cls(meta, rank, world, slices)

    def plan_to(self, new_world: int) -> ShardRemapPlan:
        return ShardRemapPlan(self.world, new_world, self.meta["sizes"],
                              self.meta["dtypes"])

    def remapped(self, new_rank: int, new_world: int,
                 old_shards: Dict[int, List]) -> "ShardedState":
        """This state's meta + new_rank's slices under new_world,
        assembled from old ranks' published slices."""
        plan = self.plan_to(new_world)
        return ShardedState(self.meta, new_rank, new_world,
                            plan.remap(new_rank, old_shards))

    @staticmethod
    def assemble(meta: Dict, shards_by_rank: Dict[int, List]) -> Any:
        """Rebuild the full pytree from every rank's slices."""
        import numpy as np

        world = len(shards_by_rank)
        leaves = []
        for i, size in enumerate(meta["sizes"]):
            flat = np.concatenate(
                [np.asarray(shards_by_rank[r][i]) for r in range(world)]
            ) if size else np.empty(0, dtype=meta["dtypes"][i])
            leaf = flat.astype(meta["dtypes"][i], copy=False).reshape(
                meta["shapes"][i])
            # tolist() on the 0-d array recovers the python scalar
            # (these are host numpy buffers, never device arrays).
            if meta["scalars"][i]:
                leaf = leaf.reshape(()).tolist()
            else:
                leaf = _from_numpy(leaf, meta["torch_dtypes"][i])
            leaves.append(leaf)
        return unflatten_tree(meta["spec"], leaves)

    def full(self, shards_by_rank: Dict[int, List]) -> Any:
        return self.assemble(self.meta, shards_by_rank)

    # -- partial-shard save/load ----------------------------------------
    # Departing ranks persist exactly their slice before exiting through
    # the drain plane; a cold restore (or a debugging session) can
    # reassemble the full tree from whatever subset of ranks survived to
    # disk plus the live remap refs.

    def save(self, directory: str) -> str:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"shard_{self.rank:05d}.pkl")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            cloudpickle.dump(
                {"meta": self.meta, "rank": self.rank, "world": self.world,
                 "slices": self.slices}, f)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, directory: str, rank: int) -> "ShardedState":
        path = os.path.join(directory, f"shard_{rank:05d}.pkl")
        with open(path, "rb") as f:
            d = cloudpickle.load(f)
        return cls(d["meta"], d["rank"], d["world"], d["slices"])

    @classmethod
    def load_all(cls, directory: str) -> Dict[int, "ShardedState"]:
        out = {}
        for name in sorted(os.listdir(directory)):
            if name.startswith("shard_") and name.endswith(".pkl"):
                rank = int(name[len("shard_"):-len(".pkl")])
                out[rank] = cls.load(directory, rank)
        return out


class AsyncCheckpointer:
    """Asynchronous tree checkpointing: save() returns once every tensor
    is copied to host memory (on the caller's stream, which waits for the
    copy), and the file is written on a background thread, so the train
    step keeps the card busy during the write. wait() is the completion
    barrier — call it before REPORTING a checkpoint so a resume can never
    observe a partial write.

    Reference analog: the async upload path of train/_internal/storage.py
    (StorageContext persists checkpoints off the training thread).
    """

    def __init__(self):
        self._threads: List[threading.Thread] = []
        self._errors: List[BaseException] = []
        self._lock = threading.Lock()

    def save(self, path: str, tree: Any) -> "Checkpoint":
        path = os.path.abspath(path)
        leaves, spec = flatten_tree(tree)
        host, devices = _snapshot(leaves)

        def write():
            try:
                _write_tree(os.path.join(path, _TREE_DIR), spec, host,
                            devices)
            except BaseException as e:  # noqa: BLE001 — raised by wait()
                with self._lock:
                    self._errors.append(e)

        t = threading.Thread(target=write, daemon=True,
                             name="rt-async-ckpt")
        t.start()
        with self._lock:
            self._threads.append(t)
        return Checkpoint(path)

    def wait(self):
        """Block until every outstanding save has been committed; raise
        the first write error."""
        with self._lock:
            threads, self._threads = self._threads, []
        for t in threads:
            t.join()
        with self._lock:
            errors, self._errors = self._errors, []
        if errors:
            raise errors[0]

    def close(self):
        try:
            self.wait()
        except Exception:  # noqa: BLE001 — close is best-effort
            logger.debug("async checkpointer close failed",
                         exc_info=True)
