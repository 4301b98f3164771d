"""Blocks: the unit of distributed data (the port of
ray_tpu/data/block.py).

Analog of the reference's block model (python/ray/data/block.py): a block
is a pyarrow Table (columnar rows) or a plain Python list (simple block,
for arbitrary objects). Batches convert to dict-of-numpy for ML feeding.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Union

import numpy as np
import pyarrow as pa

Block = Union[pa.Table, List[Any]]


def block_from_rows(rows: List[Any]) -> Block:
    """Rows of dicts -> arrow table; anything else -> simple block."""
    if rows and all(isinstance(r, dict) for r in rows):
        try:
            return pa.Table.from_pylist(rows)
        except (pa.ArrowInvalid, pa.ArrowTypeError, pa.ArrowNotImplementedError):
            return list(rows)
    return list(rows)


def block_num_rows(block: Block) -> int:
    return block.num_rows if isinstance(block, pa.Table) else len(block)


def block_to_rows(block: Block) -> List[Any]:
    return block.to_pylist() if isinstance(block, pa.Table) else list(block)


def block_slice(block: Block, start: int, end: int) -> Block:
    if isinstance(block, pa.Table):
        return block.slice(start, end - start)
    return block[start:end]


def block_concat(blocks: List[Block]) -> Block:
    if not blocks:
        return []
    if all(isinstance(b, pa.Table) for b in blocks):
        return pa.concat_tables(blocks)
    rows: List[Any] = []
    for b in blocks:
        rows.extend(block_to_rows(b))
    return block_from_rows(rows)


def block_to_batch(block: Block, batch_format: str = "numpy"):
    """Convert a block to a training batch: "numpy" (dict of arrays),
    "pyarrow" (a Table) or "pandas" (a DataFrame; pandas is imported only
    then)."""
    if batch_format == "pandas":
        return block_to_batch(block, "pyarrow").to_pandas()
    if batch_format == "pyarrow":
        if isinstance(block, pa.Table):
            return block
        return pa.Table.from_pylist(
            [r if isinstance(r, dict) else {"item": r} for r in block_to_rows(block)]
        )
    if batch_format == "numpy":
        if isinstance(block, pa.Table):
            from ray_tpu_torch.data.tensor import is_tensor_type, tensor_to_numpy

            out = {}
            for name, col in zip(block.column_names, block.columns):
                if is_tensor_type(col.type):
                    # (N, *shape) view over the storage buffer.
                    out[name] = tensor_to_numpy(col)
                else:
                    out[name] = np.asarray(
                        col.to_numpy(zero_copy_only=False)
                    )
            return out
        rows = block_to_rows(block)
        if rows and isinstance(rows[0], dict):
            keys = rows[0].keys()
            return {k: np.asarray([r[k] for r in rows]) for k in keys}
        return {"item": np.asarray(rows)}
    raise ValueError(f"unknown batch_format {batch_format!r}")


def block_schema(block: Block):
    if isinstance(block, pa.Table):
        return block.schema
    rows = block_to_rows(block)
    if rows and isinstance(rows[0], dict):
        return {k: type(v).__name__ for k, v in rows[0].items()}
    return {"item": type(rows[0]).__name__} if rows else None
