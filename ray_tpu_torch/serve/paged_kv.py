"""Paged KV cache: the engine's memory plane. Counterpart of
ray_tpu/serve/paged_kv.py.

One page pool `[layers, pages, page_size, kv_heads, head_dim]` and a
per-slot block table `[slots, pages_per_slot]` live on the device. Decode
gathers K/V through the block table; prefill scatters rows into the pages
the table names. The host side — the refcounted free-list allocator
(`PagePool`), the prefix cache over full-page chain hashes
(`PrefixCache`, `page_hashes`, `prefix_route_key`) — is a copy of the JAX
package's, which is plain Python and numpy (vLLM's PagedAttention idea,
arXiv:2309.06180).

Page 0 is reserved as the NULL/scratch page: block-table entries default
to it, inactive-slot decode writes park in it, and prefill padding rows
drop into it — it is never gathered unmasked. Several writes may land on
the same (NULL page, row) in one step; which one wins is unspecified, as
in JAX, and never observable.

Where the JAX package threads the pool through a jitted step with donated
buffers, the port updates it in place (`index_put_`). Each layer's K/V
rows land in the pool before that layer's attention gathers them.

Bit-exactness with the slotted path: when `max_len % page_size == 0` the
gathered attention width equals `max_len` and gathered row i of a slot is
absolute position i, so decode outputs equal the slotted path's bit for
bit.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.transformer import TransformerConfig, layer_params
from ray_tpu_torch.ops import rmsnorm
from ray_tpu_torch.ops.rope import rope_tables
from ray_tpu_torch.serve._prefix_hash import (  # noqa: F401
    page_hashes,
    prefix_route_key,
)

# The reserved NULL/scratch page (see module docstring).
NULL_PAGE = 0


class OutOfPages(RuntimeError):
    """The pool cannot cover an allocation. Admission-time only: the
    engine requeues the request at the front of its tenant queue and
    retries as decoding requests finish and release pages."""

    def __init__(self, needed: int, free: int, total: int):
        super().__init__(
            f"page pool exhausted: need {needed} pages, {free} free of "
            f"{total} usable"
        )
        self.needed = needed
        self.free = free
        self.total = total


class PagePool:
    """Host-side free-list allocator over the device page pool.

    Pure bookkeeping — it never touches device memory. Refcounts make
    prefix sharing safe: a page is returned to the free list only when
    its last holder (request block table or prefix-cache entry)
    releases it. Single-threaded by design: only the engine loop thread
    allocates/releases (admission and eviction both happen there)."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("PagePool needs >= 2 pages (page 0 is reserved)")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        # LIFO free list: recently-freed pages are re-used first (their
        # rows are about to be overwritten anyway).
        self._free: List[int] = list(range(1, self.num_pages))
        self._refs = np.zeros(self.num_pages, dtype=np.int32)

    @property
    def usable(self) -> int:
        return self.num_pages - 1  # page 0 reserved

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.usable - len(self._free)

    def alloc(self, n: int) -> List[int]:
        """Take `n` pages off the free list at refcount 1. All-or-
        nothing: raises OutOfPages without allocating anything when the
        list is short (partial grants would leak on the error path)."""
        if n < 0:
            raise ValueError("alloc of negative page count")
        if n > len(self._free):
            raise OutOfPages(n, len(self._free), self.usable)
        pages = [self._free.pop() for _ in range(n)]
        self._refs[pages] = 1
        return pages

    def ref(self, pages: Sequence[int]) -> None:
        """Add one reference to each page (prefix sharing / cache insert)."""
        for p in pages:
            if self._refs[p] <= 0:
                raise ValueError(f"ref of unallocated page {p}")
            self._refs[p] += 1

    def release(self, pages: Sequence[int]) -> None:
        """Drop one reference from each page; pages reaching zero return
        to the free list."""
        for p in pages:
            r = int(self._refs[p]) - 1
            if r < 0:
                raise ValueError(f"release of unallocated page {p}")
            self._refs[p] = r
            if r == 0:
                self._free.append(p)

    def refcount(self, page: int) -> int:
        return int(self._refs[page])

    def reset(self) -> None:
        """Forget everything (engine failure recovery: the device cache
        was rebuilt, so every outstanding reference is void)."""
        self._free = list(range(1, self.num_pages))
        self._refs[:] = 0


class PrefixCache:
    """Token-hash trie over full-page runs, flattened to one dict.

    Each cached page is keyed by the CHAIN hash of the prompt prefix it
    completes (h_i = blake2b(h_{i-1} || tokens of page i)), so a chain
    key identifies the entire token prefix, not just one page's tokens
    — matching is `for each key: dict probe`, longest resident prefix
    wins, no tree pointers needed. The cache holds its OWN reference on
    every resident page: donors finishing (or dying) cannot invalidate
    sharers, and `evict_pages` under pool pressure releases LRU entries
    deepest-first (an OrderedDict move-to-end on match keeps recency;
    entries of one insertion land in chain order, so popping from the
    front releases stale roots last — a child page is never left
    resident without its parent chain being droppable first is NOT
    required for correctness: a match simply stops at the first missing
    link)."""

    def __init__(self, pool: PagePool):
        self._pool = pool
        # chain-hash key -> (page, depth). Ordered: LRU at the front.
        self._entries: "OrderedDict[str, Tuple[int, int]]" = OrderedDict()

    @property
    def pages_held(self) -> int:
        return len(self._entries)

    def match(self, keys: Sequence[str]) -> List[int]:
        """Longest resident prefix of `keys`, as pages. The caller
        receives ONE reference per returned page (release when the
        request's block table drops them)."""
        pages: List[int] = []
        for k in keys:
            hit = self._entries.get(k)
            if hit is None:
                break
            self._entries.move_to_end(k)
            pages.append(hit[0])
        if pages:
            self._pool.ref(pages)
        return pages

    def insert(self, keys: Sequence[str], pages: Sequence[int]) -> int:
        """Publish a prompt's full pages under their chain keys (called
        at prefill completion, so concurrent requests share as early as
        possible). The cache takes its own reference on each newly
        inserted page; keys already resident just refresh recency.
        Returns the number of pages newly inserted."""
        added = 0
        for depth, (k, p) in enumerate(zip(keys, pages)):
            if k in self._entries:
                self._entries.move_to_end(k)
                continue
            self._pool.ref([p])
            self._entries[k] = (int(p), depth)
            added += 1
        return added

    def evict_pages(self, n: int) -> int:
        """Release up to `n` LRU entries back toward the pool (allocation
        pressure). Returns how many entries were dropped — the caller
        retries its alloc; freed-page count can be lower when a sharer
        still holds a reference."""
        dropped = 0
        while dropped < n and self._entries:
            _, (page, _) = self._entries.popitem(last=False)
            self._pool.release([page])
            dropped += 1
        return dropped

    def flush(self) -> int:
        """Drop every entry (chaos hook / tests). Returns entries dropped."""
        return self.evict_pages(len(self._entries))

    def reset(self) -> None:
        """Forget entries WITHOUT releasing (engine failure recovery:
        the pool was reset, the references no longer exist)."""
        self._entries.clear()

    def roots(self, limit: int = 64) -> List[str]:
        """Most-recently-used depth-0 chain keys — the replica's
        advertised prefix set for affinity routing. Depth 0 only: a
        router match on the FIRST page is what predicts the rest of the
        chain being resident, and it keeps the advertisement bounded."""
        out = [k for k, (_, d) in self._entries.items() if d == 0]
        return out[-limit:]


def init_paged_cache(cfg: TransformerConfig, slots: int, num_pages: int,
                     page_size: int, pages_per_slot: int,
                     device=None, mesh=None) -> Dict:
    """Device state of the paged cache: the page pool, per-slot lengths,
    and the block table (all entries NULL_PAGE). Under a mesh the pool
    holds this rank's KV heads (split over "tp"); lengths and the block
    table are whole on every rank."""
    from ray_tpu_torch.parallel.mesh import axis_size

    device = resolve_device(device)
    shape = (cfg.n_layers, num_pages, page_size,
             cfg.n_kv_heads // axis_size(mesh, "tp"), cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "lengths": torch.zeros((slots,), dtype=torch.int64, device=device),
        "block_tables": torch.zeros((slots, pages_per_slot),
                                    dtype=torch.int64, device=device),
    }


@torch.inference_mode()
def decode_paged(params, tokens, k_pages, v_pages, lengths, active,
                 block_tables, temps, top_ks, top_ps, gen,
                 cfg: TransformerConfig, max_len: int, mesh=None):
    """One decode step for every slot, K/V gathered through the block
    table — the paged twin of llm._decode_slots (same contract plus the
    table). Updates the pool in place; returns (next_tokens [S],
    new_lengths [S]).

    Each active slot writes its new K/V row into page
    `block_tables[slot, lengths[slot] // page_size]` at row
    `lengths[slot] % page_size`; inactive slots park the write in the
    NULL page. Attention gathers the slot's whole table (width =
    pages_per_slot * page_size) and masks by length. Under a mesh the
    pool holds this rank's KV heads and `params` its shards."""
    from ray_tpu_torch.serve.llm import (_embed, _layer_body,  # cycle
                                         _logits, _pick_tokens)

    s_ = tokens.shape[0]
    ps = k_pages.shape[2]
    mp = block_tables.shape[1]
    width = mp * ps
    kvh, hd = k_pages.shape[3], k_pages.shape[4]
    dev = tokens.device
    x = _embed(params, tokens[:, None], cfg, mesh)  # [S, 1, d]
    cos, sin = rope_tables(cfg.head_dim, max_len, cfg.rope_theta, dev)
    positions = lengths[:, None]
    pos_w = torch.where(active, lengths.clamp(max=max_len - 1), 0)
    page_of = (pos_w // ps).clamp(max=mp - 1)
    rows_w = pos_w % ps
    slot_idx = torch.arange(s_, device=dev)
    pages_w = torch.where(active, block_tables[slot_idx, page_of], NULL_PAGE)
    k_pos = torch.arange(width, device=dev)[None, None, :]
    valid = k_pos <= positions[:, :, None]

    def write_kv(kc, vc, k, v):
        kc.index_put_((pages_w, rows_w), k[:, 0].to(kc.dtype))
        vc.index_put_((pages_w, rows_w), v[:, 0].to(vc.dtype))
        k_att = kc[block_tables].reshape(s_, width, kvh, hd)
        v_att = vc[block_tables].reshape(s_, width, kvh, hd)
        return k_att, v_att

    for i, lp in enumerate(layer_params(params)):
        x = _layer_body(x, lp, k_pages[i], v_pages[i], cfg, cos, sin,
                        positions, write_kv, valid, mesh)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(x[:, -1], params, cfg, mesh)
    new_lengths = torch.where(active, lengths + 1, lengths)
    if temps is None:
        next_tokens = torch.argmax(logits, dim=-1)
    else:
        next_tokens = _pick_tokens(logits, temps, top_ks, top_ps, gen)
    return next_tokens, new_lengths


@torch.inference_mode()
def prefill_chunk_paged(params, tokens, n_valid: int, slot: int, offset: int,
                        k_pages, v_pages, lengths, block_tables,
                        cfg: TransformerConfig, max_len: int, mesh=None):
    """Chunked prefill into pages — the paged twin of llm._prefill_chunk.
    Chunk rows scatter into the pages the slot's block-table row names;
    padding rows and anything past `max_len` drop into the NULL page.
    Queries attend causally against the slot's gathered page run. Updates
    the pool and lengths[slot] in place; returns the logits of the
    chunk's last real position [1, vocab].

    Prefix-cache resumption needs nothing special: the engine starts
    `offset` at the shared-prefix boundary and the gathered pages already
    hold the donor's K/V rows below it. Under a mesh, as decode_paged."""
    from ray_tpu_torch.serve.llm import _embed, _layer_body, _logits  # cycle

    _, c = tokens.shape
    ps = k_pages.shape[2]
    mp = block_tables.shape[1]
    width = mp * ps
    kvh, hd = k_pages.shape[3], k_pages.shape[4]
    dev = tokens.device
    x = _embed(params, tokens, cfg, mesh)
    cos, sin = rope_tables(cfg.head_dim, max_len, cfg.rope_theta, dev)
    pos = offset + torch.arange(c, device=dev)
    positions = pos[None, :]
    k_pos = torch.arange(width, device=dev)[None, None, :]
    valid = (k_pos <= positions[:, :, None]) & (k_pos < offset + n_valid)
    bt_row = block_tables[slot]
    in_range = (pos < offset + n_valid) & (pos < max_len)
    page_of = (pos // ps).clamp(max=mp - 1)
    pages_w = torch.where(in_range, bt_row[page_of], NULL_PAGE)
    rows_w = pos % ps

    def write_kv(kc, vc, k, v):
        kc.index_put_((pages_w, rows_w), k[0].to(kc.dtype))
        vc.index_put_((pages_w, rows_w), v[0].to(vc.dtype))
        k_att = kc[bt_row].reshape(1, width, kvh, hd)
        v_att = vc[bt_row].reshape(1, width, kvh, hd)
        return k_att, v_att

    for i, lp in enumerate(layer_params(params)):
        x = _layer_body(x, lp, k_pages[i], v_pages[i], cfg, cos, sin,
                        positions, write_kv, valid, mesh)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(x[:, n_valid - 1], params, cfg, mesh)
    # fill_ runs on the device; `lengths[slot] = n` would copy a host
    # scalar and wait for every step already enqueued.
    lengths[slot].fill_(offset + n_valid)
    return logits


@torch.inference_mode()
def cow_copy_page(k_pages, v_pages, src: int, dst: int):
    """Copy one page's rows across all layers (the copy-on-write fork),
    in place."""
    k_pages[:, dst] = k_pages[:, src]
    v_pages[:, dst] = v_pages[:, src]
    return k_pages, v_pages
