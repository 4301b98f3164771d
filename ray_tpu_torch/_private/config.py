"""Runtime configuration read by the serving engine.

A copy of the `serve_*` entries of ray_tpu/_private/config.py that the
engine and replica read, with the same defaults and the same `RT_<NAME>`
environment overrides (the verbatim field-name form `RT_<name>` too).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields
from typing import Any


def _env(name: str, default: Any, typ: type) -> Any:
    raw = os.environ.get(f"RT_{name.upper()}")
    if raw is None:
        raw = os.environ.get(f"RT_{name}")
    if raw is None:
        return default
    if typ is bool:
        return raw.lower() in ("1", "true", "yes")
    return typ(raw)


@dataclass
class Config:
    # serve.call()/.result() default completion timeout.
    serve_result_timeout_s: float = 120.0
    # A prefill pass blocking active decode slots longer than this is
    # recorded as a head-of-line event.
    serve_hol_threshold_s: float = 0.05
    # Bound on the engine admission queue (waiting for a decode slot);
    # past it submit() sheds instead of queueing unbounded.
    serve_max_queued_per_engine: int = 64
    # KV layout: "paged" (page pool + block tables + prefix cache, the
    # default) or "slotted" (one row per request). RT_SERVE_KV=slotted.
    serve_kv: str = "paged"
    # Tokens per KV page (clamped to max_len; bit-exactness with the
    # slotted path needs max_len % page_size == 0).
    serve_kv_page_size: int = 16
    # Total pages in the pool, INCLUDING the reserved NULL page. 0 = auto:
    # num_slots * ceil(max_len / page_size) + 1, the slotted cache's size.
    serve_kv_pages: int = 0
    # Prefix cache over full prompt pages.
    serve_prefix_cache: bool = True

    def __post_init__(self):
        for f in fields(self):
            cur = getattr(self, f.name)
            setattr(self, f.name, _env(f.name, cur, type(cur)))


_config: Config | None = None


def get_config() -> Config:
    global _config
    if _config is None:
        _config = Config()
    return _config
