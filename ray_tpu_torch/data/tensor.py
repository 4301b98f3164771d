"""Arrow tensor extension: fixed-shape ndarrays as first-class columns
(the port of ray_tpu/data/tensor.py).

Analog of the reference's ArrowTensorArray/ArrowTensorType
(python/ray/air/util/tensor_extensions/arrow.py): an (N, *shape) ndarray
becomes ONE arrow column (FixedSizeList storage + shape metadata), so
image/tensor datasets ride arrow blocks through the store — which is
what makes the zero-copy batch path (dataset._numpy_batches) apply
to tensors too: batches are reshaped VIEWS over the block's buffer all
the way to the feed's pinned copy.

The extension is registered as "ray_tpu_torch.tensor", a name of its
own, so the port and the JAX package can share a process (the tests
do). Registration happens once per process: a second
pa.register_extension_type of the name raises, and a worker forked from
the zygote imports this module again.
"""

from __future__ import annotations

import json

import numpy as np
import pyarrow as pa


class ArrowTensorType(pa.ExtensionType):
    """Fixed-shape tensor column: storage is FixedSizeList(prod(shape))
    of the element dtype; the element shape rides extension metadata."""

    def __init__(self, shape, value_type):
        self.shape = tuple(int(s) for s in shape)
        size = 1
        for s in self.shape:
            size *= s
        super().__init__(pa.list_(value_type, size), "ray_tpu_torch.tensor")

    def __arrow_ext_serialize__(self) -> bytes:
        return json.dumps(list(self.shape)).encode()

    @classmethod
    def __arrow_ext_deserialize__(cls, storage_type, serialized):
        return cls(json.loads(serialized.decode()),
                   storage_type.value_type)

    def __reduce__(self):
        return (
            ArrowTensorType.__arrow_ext_deserialize__,
            (self.storage_type, self.__arrow_ext_serialize__()),
        )


try:  # idempotent across re-imports (pytest reloads, zygote forks)
    pa.register_extension_type(ArrowTensorType((1,), pa.float32()))
except pa.ArrowKeyError:
    pass


def tensor_array(arr: np.ndarray) -> pa.ExtensionArray:
    """(N, *shape) ndarray -> one tensor extension array (no per-row
    Python objects; the storage buffer is the array's own bytes)."""
    arr = np.ascontiguousarray(arr)
    n = len(arr)
    shape = arr.shape[1:]
    size = int(np.prod(shape)) if shape else 1
    values = pa.array(arr.reshape(-1))
    storage = pa.FixedSizeListArray.from_arrays(values, size)
    return pa.ExtensionArray.from_storage(
        ArrowTensorType(shape, values.type), storage
    )


def tensor_to_numpy(col) -> np.ndarray:
    """Tensor extension column -> (N, *shape) ndarray, zero-copy: a
    reshape of the storage values buffer."""
    if isinstance(col, pa.ChunkedArray):
        if col.num_chunks == 1:
            return tensor_to_numpy(col.chunk(0))
        return np.concatenate(
            [tensor_to_numpy(c) for c in col.chunks]
        )
    shape = col.type.shape
    flat = col.storage.flatten().to_numpy(zero_copy_only=True)
    return flat.reshape(len(col), *shape)


def is_tensor_type(t) -> bool:
    return isinstance(t, ArrowTensorType)


def table_with_tensors(columns: dict) -> pa.Table:
    """dict of name -> ndarray; multi-dim arrays become tensor columns,
    1-D arrays plain columns."""
    arrays, names = [], []
    for name, arr in columns.items():
        arr = np.asarray(arr)
        names.append(name)
        arrays.append(tensor_array(arr) if arr.ndim > 1 else pa.array(arr))
    return pa.Table.from_arrays(arrays, names=names)
