"""Structured event log: JSON-line files per component.

Analog of the reference's RAY_EVENT macros (src/ray/util/event.h), which
write structured JSON event files the dashboard's event module tails.
Here any component calls `record_event(...)`; events append to
`<event dir>/events_<source>.log` as one JSON object per line and the
dashboard surfaces the merged tail at /api/events.

Event dir: $RT_EVENT_DIR, else $TMPDIR/ray_tpu_torch/events. Writes are
append-only + line-atomic (single write syscall under PIPE_BUF for
typical event sizes), so concurrent processes can share a file.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List

SEVERITIES = ("DEBUG", "INFO", "WARNING", "ERROR")


def event_dir() -> str:
    d = os.environ.get("RT_EVENT_DIR") or os.path.join(
        os.environ.get("TMPDIR", "/tmp"), "ray_tpu_torch", "events"
    )
    os.makedirs(d, exist_ok=True)
    return d


#: Rotate an event file once it passes this size (one .1 generation kept).
ROTATE_BYTES = 4 * 1024 * 1024
#: Bound how much of each file a reader loads (tail window).
TAIL_BYTES = 256 * 1024


def record_event(source: str, message: str, severity: str = "INFO",
                 **fields: Any) -> None:
    """Append one structured event; never raises (observability must not
    take down the component reporting it)."""
    try:
        entry = {
            "timestamp": time.time(),
            "source": source,
            "severity": severity if severity in SEVERITIES else "INFO",
            "message": message,
            "pid": os.getpid(),
            **fields,
        }
        path = os.path.join(event_dir(), f"events_{source}.log")
        try:
            if os.path.getsize(path) >= ROTATE_BYTES:
                os.replace(path, path + ".1")
        except OSError:
            pass
        with open(path, "a") as f:
            f.write(json.dumps(entry, default=str) + "\n")
    except Exception:  # noqa: BLE001 — best-effort by contract
        pass


def read_events(limit: int = 200, source: str = "") -> List[Dict]:
    """Merged most-recent events across components (dashboard backend)."""
    out: List[Dict] = []
    try:
        d = event_dir()
        for name in os.listdir(d):
            if not name.startswith("events_") or not name.endswith(".log"):
                continue
            if source and name != f"events_{source}.log":
                continue
            path = os.path.join(d, name)
            try:
                with open(path, "rb") as f:
                    # Bounded tail window: the dashboard polls this, so
                    # it must never read a whole (rotated-capped) file.
                    f.seek(0, os.SEEK_END)
                    size = f.tell()
                    f.seek(max(0, size - TAIL_BYTES))
                    chunk = f.read().decode(errors="replace")
                lines = chunk.splitlines()
                if size > TAIL_BYTES and lines:
                    lines = lines[1:]  # first line may be torn
                lines = lines[-limit:]
            except OSError:
                continue
            for line in lines:
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    except Exception:  # noqa: BLE001
        return out
    out.sort(key=lambda e: e.get("timestamp", 0))
    return out[-limit:]
