"""Serializability inspection (reference: ray.util.inspect_serializability,
util/check_serialize.py) — walks an object that fails to cloudpickle and
reports WHICH nested member is the culprit, instead of the raw opaque
pickling error users otherwise get from a failed task submission.
"""

from __future__ import annotations

import inspect
from typing import Any, List, Optional, Set, Tuple


def _try_pickle(obj: Any) -> Optional[Exception]:
    from ray_tpu_torch._vendor import cloudpickle

    try:
        cloudpickle.dumps(obj)
        return None
    except Exception as e:  # noqa: BLE001 — the error IS the data here
        return e


def _children(obj: Any) -> List[Tuple[str, Any]]:
    """Nested members worth blaming: closure cells, attributes, items."""
    out: List[Tuple[str, Any]] = []
    if inspect.isfunction(obj):
        if obj.__closure__:
            for name, cell in zip(
                obj.__code__.co_freevars, obj.__closure__
            ):
                try:
                    out.append((f" closure '{name}'", cell.cell_contents))
                except ValueError:  # empty cell
                    pass
        for name, val in (obj.__globals__ or {}).items():
            if name in obj.__code__.co_names and not inspect.ismodule(val):
                out.append((f" global '{name}'", val))
    elif isinstance(obj, dict):
        out.extend((f"[{k!r}]", v) for k, v in obj.items())
    elif isinstance(obj, (list, tuple, set)):
        out.extend((f"[{i}]", v) for i, v in enumerate(obj))
    elif hasattr(obj, "__dict__"):
        out.extend((f".{k}", v) for k, v in vars(obj).items())
    return out


def inspect_serializability(
    obj: Any, name: Optional[str] = None, depth: int = 3, _print=print
) -> Tuple[bool, Set[str]]:
    """Check cloudpickle-ability; on failure, recursively blame the
    smallest unpicklable members. Returns (serializable, failure_set)
    where failure_set names the offending paths (reference signature:
    ray.util.inspect_serializability)."""
    name = name or getattr(obj, "__name__", type(obj).__name__)
    failures: Set[str] = set()

    def visit(o: Any, path: str, d: int):
        err = _try_pickle(o)
        if err is None:
            return
        kids = _children(o) if d > 0 else []
        kid_failed = False
        for label, child in kids:
            child_err = _try_pickle(child)
            if child_err is not None:
                kid_failed = True
                visit(child, f"{path}{label}", d - 1)
        if not kid_failed:
            # This object itself is the leaf culprit.
            failures.add(path)
            _print(f"[serializability] {path}: {type(err).__name__}: {err}")

    visit(obj, name, depth)
    ok = not failures
    if ok:
        _print(f"[serializability] {name}: OK")
    return ok, failures
