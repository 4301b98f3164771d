"""Chain hashes of KV pages: the prefix cache's keys and the handle's
prefix-affinity routing key. Part of ray_tpu/serve/paged_kv.py in the
JAX package; a module of its own here because the handle (in drivers
and the HTTP proxy) needs it and must not import torch, which
`paged_kv` does. `paged_kv` re-exports both functions."""

from __future__ import annotations

import hashlib
from typing import List, Optional

import numpy as np


def page_hashes(tokens, page_size: int) -> List[str]:
    """Chain hashes of every FULL page of `tokens` (partial tail pages
    are never cached — their rows would change as the request decodes).
    Key i commits to tokens[0 : (i+1)*page_size]."""
    arr = np.asarray(tokens, dtype=np.int32).reshape(-1)
    out: List[str] = []
    parent = b""
    for i in range(len(arr) // page_size):
        h = hashlib.blake2b(
            parent + arr[i * page_size:(i + 1) * page_size].tobytes(),
            digest_size=16,
        )
        parent = h.digest()
        out.append(h.hexdigest())
    return out


def prefix_route_key(tokens, page_size: int) -> Optional[str]:
    """The depth-0 chain key of a prompt (None when the prompt does not
    fill one page) — what the handle matches against replicas'
    advertised `roots` for prefix-affinity routing."""
    arr = np.asarray(tokens, dtype=np.int32).reshape(-1)
    if page_size < 1 or len(arr) < page_size:
        return None
    return hashlib.blake2b(
        arr[:page_size].tobytes(), digest_size=16
    ).hexdigest()
