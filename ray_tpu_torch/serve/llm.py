"""Continuous batching for LLM serving. Counterpart of ray_tpu/serve/llm.py.

A decode loop over a slotted or paged KV cache where requests join at any
step boundary, emit tokens as they are produced, and free their slot the
moment they finish (iteration-level scheduling). Prompts prefill in
fixed-size chunks, one chunk per mid-prefill slot between decode steps,
so a long prompt never stalls the other slots for more than a chunk.

How the port differs from the JAX engine:

  * Eager PyTorch instead of jitted steps: each step is a Python loop over
    the layers. The KV cache is updated in place (JAX donated the buffers
    to the jitted step), and each layer's K/V rows land in the cache
    before that layer's attention reads them.
  * The jit-compile counters of `stats()` (`compiles`, `warm_compiles`,
    `recompiles_post_warm`) have no counterpart in eager PyTorch and are
    gone. `forward_passes` (decode steps dispatched plus prefill chunks
    run, warm-up excluded) is new: each pass runs 2 * n_layers + 1
    RMSNorms.
  * The step pipelining stays: dispatch step k+1 (its input tokens are
    step k's on-device pick), start a non-blocking copy of its tokens and
    lengths into a pinned host buffer with a CUDA event behind it, then
    wait on step k's event and hand out its tokens — one event wait per
    step, never one `.item()` per slot.
  * Sampling draws from a `torch.Generator` on the device (Gumbel-max):
    the same distribution as `jax.random.categorical`, not the same bits.
  * Waiting for the runtime slice: the `ray_tpu.util.metrics` export, the
    observatory, chaos injection, the journal/postmortem call of the
    head-of-line watchdog, the tensor-parallel `mesh`, and
    `llm_deployment`. TTFT/TPOT and the head-of-line ledger are kept
    per engine and read through `stats()`.

The engine runs on the device that holds the parameters.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch.exceptions import (
    PromptTooLongError,
    RequestCancelledError,
    ServeOverloadedError,
)
from ray_tpu_torch.models.generate import _sample
from ray_tpu_torch.models.transformer import (
    TransformerConfig,
    _act,
    _embed_tokens,
    layer_params,
    project_logits,
)
from ray_tpu_torch.ops import apply_rope, rmsnorm
from ray_tpu_torch.ops.rope import rope_tables
from ray_tpu_torch.serve import context as request_context
from ray_tpu_torch.serve import paged_kv

NEG_INF = -1e30


def init_slotted_cache(cfg: TransformerConfig, slots: int, max_len: int,
                       device=None) -> Dict:
    """[layers, slots, max_len, kv_heads, head_dim] cache with PER-SLOT
    lengths, so sequences of different ages share one decode batch."""
    device = resolve_device(device)
    shape = (cfg.n_layers, slots, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "lengths": torch.zeros((slots,), dtype=torch.int64, device=device),
    }


def _grouped_attention(q, kf, vf, valid):
    """q [S, Lq, H, D] vs caches [S, Lk, KVH, D]; valid [S, Lq, Lk]."""
    s_, lq, h, d = q.shape
    kvh = kf.shape[2]
    group = h // kvh
    scale = d ** -0.5
    qg = q.reshape(s_, lq, kvh, group, d).float()
    scores = torch.einsum("sqhgd,skhd->shgqk", qg, kf) * scale
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("shgqk,skhd->sqhgd", p, vf).reshape(s_, lq, h, d)
    return out.to(q.dtype)


def _layer_body(x, lp, k_cache_l, v_cache_l, cfg, cos, sin, positions,
                write_kv, valid):
    """One transformer layer shared by decode and prefill, both KV modes.

    The callers differ only in how K/V land in the cache and what the
    attention source is: `write_kv(kc, vc, k, v) -> (k_att, v_att)`
    writes the layer's cache in place and returns what to attend against;
    `valid` is the caller's mask over (B, Lq, Lk_att). Returns x."""
    b, l = x.shape[:2]
    h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    q = (h @ lp["wq"]).reshape(b, l, cfg.n_heads, cfg.head_dim)
    k = (h @ lp["wk"]).reshape(b, l, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ lp["wv"]).reshape(b, l, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(q, lp["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, lp["k_norm"], cfg.norm_eps)
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    k_att, v_att = write_kv(k_cache_l, v_cache_l, k, v)
    attn = _grouped_attention(q, k_att.float(), v_att.float(), valid)
    x = x + (attn.reshape(b, l, -1) @ lp["wo"]).to(x.dtype)
    h = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    gate = _act(cfg)((h @ lp["w_gate"]).float())
    up = (h @ lp["w_up"]).float()
    return x + ((gate * up).to(x.dtype) @ lp["w_down"])


MAX_TOP_K = 64  # per-slot top-k cap


def _pick_tokens(logits, temps, top_ks, top_ps, gen: torch.Generator):
    """Per-slot next-token selection on device: greedy where temp == 0,
    else temperature-scaled sampling with optional per-slot top-k (0 =
    off, capped at MAX_TOP_K) and top-p (1.0 = off) filtering, so mixed
    greedy/sampled requests share one decode batch."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / temps.clamp(min=1e-6)[:, None]
    k = min(MAX_TOP_K, logits.shape[-1])
    topv = torch.topk(scaled, k, dim=-1).values  # [S, K] sorted desc
    idx = (top_ks - 1).clamp(0, k - 1)
    kth = torch.gather(topv, -1, idx[:, None])
    scaled = torch.where((top_ks > 0)[:, None] & (scaled < kth),
                         float("-inf"), scaled)
    sorted_l = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(sorted_l, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_ps[:, None]
    thr = torch.where(keep, sorted_l, float("inf")).amin(dim=-1, keepdim=True)
    scaled = torch.where(scaled < thr, float("-inf"), scaled)
    sampled = _sample(scaled, gen)
    return torch.where(temps > 0, sampled, greedy)


@torch.inference_mode()
def _decode_slots(params, tokens, k_cache, v_cache, lengths, active,
                  temps, top_ks, top_ps, gen, cfg: TransformerConfig):
    """One decode step for every slot at once.

    tokens [S] (last emitted per slot), lengths [S] (valid cache rows per
    slot), active [S] bool. Writes each ACTIVE slot's K/V at its own
    position in place; inactive slots write into their last row (masked
    out forever) and keep their length. Returns (next_tokens [S],
    new_lengths [S]); temps=None picks greedily."""
    s_ = tokens.shape[0]
    lmax = k_cache.shape[2]
    dev = tokens.device
    x = _embed_tokens(params, tokens[:, None], cfg)  # [S, 1, d]
    cos, sin = rope_tables(cfg.head_dim, lmax, cfg.rope_theta, dev)
    positions = lengths[:, None]
    write_at = torch.where(active, lengths.clamp(max=lmax - 1), lmax - 1)
    slot_idx = torch.arange(s_, device=dev)
    k_pos = torch.arange(lmax, device=dev)[None, None, :]
    valid = k_pos <= positions[:, :, None]

    def write_kv(kc, vc, k, v):
        kc.index_put_((slot_idx, write_at), k[:, 0].to(kc.dtype))
        vc.index_put_((slot_idx, write_at), v[:, 0].to(vc.dtype))
        return kc, vc  # attend against the full cache

    for i, lp in enumerate(layer_params(params)):
        x = _layer_body(x, lp, k_cache[i], v_cache[i], cfg, cos, sin,
                        positions, write_kv, valid)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = project_logits(x[:, -1], params, cfg)
    new_lengths = torch.where(active, lengths + 1, lengths)
    if temps is None:
        next_tokens = torch.argmax(logits, dim=-1)
    else:
        next_tokens = _pick_tokens(logits, temps, top_ks, top_ps, gen)
    return next_tokens, new_lengths


@torch.inference_mode()
def _prefill_chunk(params, tokens, n_valid: int, slot: int, offset: int,
                   k_cache, v_cache, lengths, cfg: TransformerConfig):
    """CHUNKED prefill: one fixed-size chunk of a prompt into slot `slot`
    at row `offset`. tokens [1, C] (first n_valid real); writes K/V rows
    [slot, offset:offset+C] in place, dropping rows past the cache end
    (JAX's scatter mode="drop"); queries attend causally to the slot's
    whole cache prefix. Sets lengths[slot] = offset + n_valid and returns
    the logits of the chunk's last REAL position [1, vocab]."""
    _, c = tokens.shape
    lmax = k_cache.shape[2]
    dev = tokens.device
    x = _embed_tokens(params, tokens, cfg)
    cos, sin = rope_tables(cfg.head_dim, lmax, cfg.rope_theta, dev)
    positions = offset + torch.arange(c, device=dev)[None, :]
    k_pos = torch.arange(lmax, device=dev)[None, None, :]
    valid = (k_pos <= positions[:, :, None]) & (k_pos < offset + n_valid)
    keep = max(0, min(c, lmax - offset))

    def write_kv(kc, vc, k, v):
        kc[slot, offset:offset + keep] = k[0, :keep].to(kc.dtype)
        vc[slot, offset:offset + keep] = v[0, :keep].to(vc.dtype)
        return kc[slot:slot + 1], vc[slot:slot + 1]

    for i, lp in enumerate(layer_params(params)):
        x = _layer_body(x, lp, k_cache[i], v_cache[i], cfg, cos, sin,
                        positions, write_kv, valid)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = project_logits(x[:, n_valid - 1], params, cfg)
    # fill_ runs on the device; `lengths[slot] = n` would copy a host
    # scalar and wait for every step already enqueued.
    lengths[slot].fill_(offset + n_valid)
    return logits


class _Latency:
    """Per-engine TTFT/TPOT samples (the JAX engine's process-wide
    histograms belong to the metrics export of the runtime slice)."""

    def __init__(self, keep: int = 4096):
        self._lock = threading.Lock()
        self._samples = {"ttft": deque(maxlen=keep), "tpot": deque(maxlen=keep)}

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            self._samples[name].append(value)

    def summary(self, name: str) -> Dict:
        with self._lock:
            vals = np.asarray(self._samples[name], dtype=np.float64)
        if not len(vals):
            return {"count": 0, "sum": 0.0, "avg": 0.0, "max": 0.0,
                    "p50": None, "p99": None}
        return {"count": int(len(vals)), "sum": float(vals.sum()),
                "avg": float(vals.mean()), "max": float(vals.max()),
                "p50": float(np.percentile(vals, 50)),
                "p99": float(np.percentile(vals, 99))}


class GenerationHandle:
    """Per-request stream: tokens arrive as the engine produces them."""

    def __init__(self, request_id: int):
        self.request_id = request_id
        self._tokens: deque = deque()
        self._done = False
        self._error: Optional[BaseException] = None
        self._cond = threading.Condition()
        # Engine bookkeeping (set at admission).
        self.prompt: Optional[np.ndarray] = None
        self.max_new_tokens = 0
        self.produced = 0
        self.admitted_at_step = -1
        # Sampling params (0 temperature = greedy).
        self.temperature = 0.0
        self.top_k = 0
        self.top_p = 1.0
        # Latency bookkeeping (engine thread only).
        self.submitted_at: Optional[float] = None
        self._first_token_t: Optional[float] = None
        self._latency: Optional[_Latency] = None
        # Survival plane: absolute deadline (0 = none), tenant label for
        # the WFQ admission queue, and the caller-side cancel flag the
        # engine loop polls at step boundaries.
        self.deadline_ts = 0.0
        self.tenant = "default"
        self.cancelled = False

    def cancel(self, reason: str = "client"):
        """Caller-side cancellation: the consumer stops waiting NOW and the
        engine loop evicts the slot at the next step boundary."""
        self.cancelled = True
        self._fail(RequestCancelledError(
            f"request {self.request_id} cancelled ({reason})",
            reason=reason, rid=str(self.request_id),
        ))

    # -- engine side --
    def _push(self, token: int, done: bool):
        now = time.perf_counter()
        first = self._first_token_t is None
        if first:
            self._first_token_t = now
        with self._cond:
            self._tokens.append(int(token))
            self._done = self._done or done
            self._cond.notify_all()
        lat = self._latency
        if lat is not None:
            if first and self.submitted_at is not None:
                lat.observe("ttft", now - self.submitted_at)
            if done and self.produced > 1 and not first:
                lat.observe("tpot", (now - self._first_token_t)
                            / (self.produced - 1))

    def _fail(self, err: BaseException):
        with self._cond:
            if self._done and self._error is None:
                return  # finished cleanly first; late cancel/fail is moot
            self._error = err
            self._done = True
            self._cond.notify_all()

    # -- caller side --
    def __iter__(self):
        # The token is taken under the lock and yielded after releasing it:
        # a consumer that pauses between tokens must not hold the lock the
        # engine thread needs to push (the JAX handle yields inside it).
        while True:
            with self._cond:
                while not self._tokens and not self._done:
                    self._cond.wait(timeout=60.0)
                if self._error is not None:
                    raise self._error
                if not self._tokens:
                    return
                tok = self._tokens.popleft()
            yield tok

    def result(self, timeout: float = 120.0) -> list:
        deadline = time.monotonic() + timeout
        out = []
        with self._cond:
            while not self._done:
                rest = deadline - time.monotonic()
                if rest <= 0:
                    raise TimeoutError("generation timed out")
                self._cond.wait(timeout=rest)
            if self._error is not None:
                raise self._error
            out.extend(self._tokens)
            self._tokens.clear()
        return out


class _StepFetch:
    """Double-buffered device->host copy of one step's [tokens; lengths].

    On the card the copy goes into a pinned buffer without blocking and a
    CUDA event marks its end; `wait` blocks on that event only. Two
    buffers alternate: step k's buffer is read before step k+2 reuses it.
    On the CPU the copy is simply done."""

    def __init__(self, slots: int, device: torch.device):
        self._cuda = device.type == "cuda"
        self._bufs = [torch.empty((2, slots), dtype=torch.int64,
                                  pin_memory=self._cuda) for _ in range(2)]
        self._next = 0

    def start(self, tokens, lengths):
        buf = self._bufs[self._next]
        self._next ^= 1
        buf.copy_(torch.stack([tokens, lengths]), non_blocking=self._cuda)
        ev = None
        if self._cuda:
            ev = torch.cuda.Event()
            ev.record()
        return buf, ev

    @staticmethod
    def wait(pending):
        buf, ev = pending
        if ev is not None:
            ev.synchronize()
        toks, lengths = buf.tolist()
        return toks, lengths


class ContinuousBatchingEngine:
    """Iteration-level scheduler over the slotted or paged cache.

    One background thread runs the decode loop; submit() enqueues a
    request which joins at the next step boundary when a slot frees.
    """

    def __init__(self, params, cfg: TransformerConfig, num_slots: int = 4,
                 max_len: int = 256, eos_id: Optional[int] = None,
                 default_max_new_tokens: int = 32, seed: int = 0,
                 prefill_chunk: int = 64, kv_mode: Optional[str] = None,
                 page_size: Optional[int] = None,
                 kv_pages: Optional[int] = None):
        """prefill_chunk: prompts prefill in fixed chunks of this many
        tokens, ONE chunk per mid-prefill slot between decode steps.

        kv_mode / page_size / kv_pages: the KV memory plane. "paged"
        (default; serve/paged_kv) backs slots with a shared page pool +
        block tables and a prefix cache; "slotted" is one [max_len] row
        per slot. None defers to config (RT_SERVE_KV,
        RT_SERVE_KV_PAGE_SIZE, RT_SERVE_KV_PAGES; kv_pages 0/None = the
        slotted cache's size)."""
        self.params = params
        self.cfg = cfg
        self.device = params["embed"].device
        self.num_slots = num_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.default_max_new_tokens = default_max_new_tokens
        self.prefill_chunk = max(1, min(int(prefill_chunk), max_len))
        rcfg = get_config()
        mode = (kv_mode or rcfg.serve_kv or "paged").lower()
        if mode not in ("paged", "slotted"):
            raise ValueError(
                f"kv_mode must be 'paged' or 'slotted', got {mode!r}"
            )
        self.kv_mode = mode
        self._paged = mode == "paged"
        if self._paged:
            self.page_size = max(
                1, min(int(page_size or rcfg.serve_kv_page_size), max_len)
            )
            self._pages_per_slot = -(-max_len // self.page_size)
            self.kv_pages = int(kv_pages or rcfg.serve_kv_pages or 0)
            if self.kv_pages <= 0:
                self.kv_pages = num_slots * self._pages_per_slot + 1
            self._pool = paged_kv.PagePool(self.kv_pages, self.page_size)
            self._prefix_cache = (
                paged_kv.PrefixCache(self._pool)
                if rcfg.serve_prefix_cache else None
            )
            # Host mirror of the device block table; uploaded as ONE
            # tensor only when admission/eviction changed it.
            self._bt_host = np.zeros(
                (num_slots, self._pages_per_slot), dtype=np.int64
            )
            self._bt_dirty = False
            self._bt_uploads = 0
            self._slot_pages: Dict[int, list] = {}
            self._prefix_hits = 0
            self._prefix_misses = 0
            self._prefill_tok_skipped = 0
        cache = self._fresh_cache()
        self._k, self._v = cache["k"], cache["v"]
        self._lengths = cache["lengths"]
        if self._paged:
            self._bt_dev = cache["block_tables"]
        self._lock = threading.Lock()
        self._work = threading.Event()
        # BOUNDED admission queue with per-tenant weighted-fair service
        # (deficit round robin over one deque per tenant); past
        # serve_max_queued_per_engine, submit() sheds.
        self._waiting: Dict[str, deque] = {}
        self._waiting_n = 0
        self._wfq_rr: deque = deque()
        self._wfq_credit: Dict[str, float] = {}
        self._tenant_weights: Dict[str, float] = {}
        self._shed_total = 0
        self._deadline_expired = 0
        self._slots: Dict[int, GenerationHandle] = {}
        # Mid-prefill requests: slot -> {"h": handle, "offset": rows
        # already prefilled}.
        self._prefilling: Dict[int, Dict] = {}
        self._free = deque(range(num_slots))
        # Next input token per slot, ON DEVICE: each step's pick feeds the
        # next dispatch; results come back one step behind.
        self._tokens_dev = torch.zeros(num_slots, dtype=torch.int64,
                                       device=self.device)
        # Per-slot admission generation: suppresses the one in-flight
        # token a just-evicted slot still produces under the lag.
        self._gen = np.zeros(num_slots, dtype=np.int64)
        # Per-slot sampling params + active mask: host mirrors with
        # device copies the decode step reads, refreshed only when slot
        # membership changes.
        self._temps = np.zeros(num_slots, dtype=np.float32)
        self._top_ks = np.zeros(num_slots, dtype=np.int64)
        self._top_ps = np.ones(num_slots, dtype=np.float32)
        self._active = np.zeros(num_slots, dtype=bool)
        self._param_uploads = 0
        self._upload_sampling_state()
        self._param_uploads = 0  # the initial copy is not a refresh
        # Per-step timing breakdown (loop thread writes, stats() reads).
        self._t_dispatch = 0.0
        self._t_fetch = 0.0
        self._t_host = 0.0
        self._timed_steps = 0
        self._rng = torch.Generator(device=self.device)
        self._rng.manual_seed(seed)
        self._next_id = 0
        self._steps = 0  # drained decode steps
        self._forward_passes = 0  # decode dispatches + prefill chunks
        self._prefill_chunks = 0
        self._latency = _Latency()
        # Head-of-line ledger: prefill passes that stalled active decode
        # slots past serve_hol_threshold_s, blamed on the prefilling
        # request(s) of the pass.
        self._hol_events: deque = deque(maxlen=64)
        self._hol_blocked_s = 0.0
        self._last_prefill_work: list = []
        self._fetch = _StepFetch(num_slots, self.device)
        self._warmup()
        self._stop_evt = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="llm-engine", daemon=True
        )
        self._thread.start()

    # -- device steps (loop thread, and _warmup before it starts) --------
    def _decode(self, sampled: bool):
        gen = self._rng if sampled else None
        temps, top_ks, top_ps = ((self._temps_dev, self._top_ks_dev,
                                  self._top_ps_dev) if sampled
                                 else (None, None, None))
        if self._paged:
            return paged_kv.decode_paged(
                self.params, self._tokens_dev, self._k, self._v,
                self._lengths, self._active_dev, self._bt_dev, temps,
                top_ks, top_ps, gen, self.cfg, self.max_len,
            )
        return _decode_slots(
            self.params, self._tokens_dev, self._k, self._v, self._lengths,
            self._active_dev, temps, top_ks, top_ps, gen, self.cfg,
        )

    def _prefill(self, tokens, n: int, slot: int, off: int):
        if self._paged:
            return paged_kv.prefill_chunk_paged(
                self.params, tokens, n, slot, off, self._k, self._v,
                self._lengths, self._bt_dev, self.cfg, self.max_len,
            )
        return _prefill_chunk(
            self.params, tokens, n, slot, off, self._k, self._v,
            self._lengths, self.cfg,
        )

    def _warmup(self):
        """Run every step kind once before serving — both decode variants
        and one prefill chunk — so the first request does not pay for
        building the kernels or loading the libraries behind them. All
        with `active` all-False: decode writes land in parking rows (or
        the NULL page) and the prefill row is re-written by any real
        occupant before its length exposes it."""
        with torch.inference_mode():
            self._decode(sampled=False)
            self._decode(sampled=True)
            pad = torch.zeros((1, self.prefill_chunk), dtype=torch.int64,
                              device=self.device)
            self._prefill(pad, 1, 0, 0)
            self._lengths.zero_()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # Loop-thread only (and __init__ before the thread starts).
    def _upload_sampling_state(self):
        """ONE host->device refresh of sampling params + active mask,
        only when slot membership changed."""
        self._temps_dev = self._h2d(self._temps)
        self._top_ks_dev = self._h2d(self._top_ks)
        self._top_ps_dev = self._h2d(self._top_ps)
        self._active_dev = self._h2d(self._active)
        self._sampled_active = bool((self._temps[self._active] > 0).any())
        self._params_dirty = False
        self._param_uploads += 1

    def _upload_block_table(self):
        """ONE host->device refresh of the block table, only when slot
        membership changed (admission reserves every page up front)."""
        self._bt_dev = self._h2d(self._bt_host)
        self._bt_dirty = False
        self._bt_uploads += 1

    def _h2d(self, arr: np.ndarray) -> torch.Tensor:
        """A device copy of a host array that the host may then change.
        On the card the copy goes through pinned memory without blocking:
        a pageable copy would wait for every step already enqueued."""
        t = torch.from_numpy(np.array(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _fresh_cache(self) -> Dict:
        if self._paged:
            return paged_kv.init_paged_cache(
                self.cfg, self.num_slots, self.kv_pages, self.page_size,
                self._pages_per_slot, device=self.device,
            )
        return init_slotted_cache(self.cfg, self.num_slots, self.max_len,
                                  device=self.device)

    # -- public API ------------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               temperature: float = 0.0, top_k: Optional[int] = None,
               top_p: Optional[float] = None) -> GenerationHandle:
        """temperature=0 decodes greedily (the default); >0 samples,
        optionally filtered by per-request top_k (<= MAX_TOP_K) and
        top_p — mixed greedy/sampled requests share one decode batch."""
        if top_k is not None and not 0 < top_k <= MAX_TOP_K:
            raise ValueError(f"top_k must be in (0, {MAX_TOP_K}]")
        if top_p is not None and not 0.0 < top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        prompt = np.asarray(prompt, dtype=np.int64).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        limit = self.max_len - 2
        detail = f"max_len - 2 = {self.max_len - 2} positions"
        if self._paged:
            # The pool must hold the whole prompt plus one generated
            # token (+1 margin row for the pipelined in-flight step).
            pool_limit = self._pool.usable * self.page_size - 2
            if pool_limit < limit:
                limit = pool_limit
                detail = (
                    f"page pool = {self._pool.usable} pages x "
                    f"{self.page_size} tokens - 2 = {pool_limit}"
                )
        if len(prompt) > limit:
            raise PromptTooLongError(
                f"prompt length {len(prompt)} exceeds this engine's "
                f"limit of {limit} tokens ({detail})",
                prompt_len=len(prompt), max_prompt_len=limit,
            )
        if max_new_tokens is None:
            max_new_tokens = self.default_max_new_tokens
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        meta = request_context.current()
        tenant = (meta.tenant if meta is not None else "") or "default"
        deadline_ts = meta.deadline_ts if meta is not None else 0.0
        cfg = get_config()
        if deadline_ts and time.time() > deadline_ts:
            with self._lock:
                self._deadline_expired += 1
            raise RequestCancelledError(
                "deadline expired before engine admission",
                reason="deadline", rid=meta.rid if meta else "",
            )
        with self._lock:
            if self._waiting_n >= cfg.serve_max_queued_per_engine:
                self._shed_total += 1
                retry = min(5.0, max(
                    0.1, 0.05 * self._waiting_n / max(1, self.num_slots)
                ))
                raise ServeOverloadedError(
                    f"engine admission queue full "
                    f"({self._waiting_n} waiting >= "
                    f"{cfg.serve_max_queued_per_engine})",
                    tenant=tenant, reason="queue_full", retry_after_s=retry,
                )
            h = GenerationHandle(self._next_id)
            self._next_id += 1
            h.submitted_at = time.perf_counter()
            h._latency = self._latency
            h.prompt = prompt
            h.max_new_tokens = int(max_new_tokens)
            h.temperature = float(temperature)
            h.top_k = int(top_k or 0)
            h.top_p = float(1.0 if top_p is None else top_p)
            h.tenant = tenant
            h.deadline_ts = deadline_ts
            q = self._waiting.get(tenant)
            if q is None:
                q = self._waiting[tenant] = deque()
                self._wfq_rr.append(tenant)
            q.append(h)
            self._waiting_n += 1
        self._work.set()
        return h

    def set_tenant_weight(self, tenant: str, weight: float) -> None:
        """Give a tenant a WFQ share (> 1 admits proportionally more per
        rotation, < 1 less; default 1.0 — equal shares)."""
        if weight <= 0:
            raise ValueError("tenant weight must be > 0")
        with self._lock:
            self._tenant_weights[tenant or "default"] = float(weight)

    def _kv_stats_locked(self) -> Dict:
        if not self._paged:
            return {"mode": "slotted", "page_size": 0}
        lookups = self._prefix_hits + self._prefix_misses
        cache_pages = (self._prefix_cache.pages_held
                       if self._prefix_cache is not None else 0)
        return {
            "mode": "paged",
            "page_size": self.page_size,
            "pages_total": self._pool.usable,
            "pages_in_use": self._pool.in_use,
            "pages_free": self._pool.free_pages,
            "util": self._pool.in_use / max(1, self._pool.usable),
            "prefix_cache_pages": cache_pages,
            "prefix_hits": self._prefix_hits,
            "prefix_misses": self._prefix_misses,
            "prefix_hit_rate": (self._prefix_hits / lookups
                                if lookups else None),
            "prefill_tokens_skipped": self._prefill_tok_skipped,
            "bt_uploads": self._bt_uploads,
            "roots": (self._prefix_cache.roots()
                      if self._prefix_cache is not None else []),
        }

    def stats(self) -> Dict:
        with self._lock:
            ts = max(self._timed_steps, 1)
            return {
                "kv": self._kv_stats_locked(),
                "steps": self._steps,
                "forward_passes": self._forward_passes,
                "prefill_chunks": self._prefill_chunks,
                "active": len(self._slots),
                "waiting": self._waiting_n,
                "waiting_tenants": {
                    t: len(q) for t, q in self._waiting.items() if q
                },
                "shed_total": self._shed_total,
                "deadline_expired": self._deadline_expired,
                "prefilling": len(self._prefilling),
                "free_slots": len(self._free),
                "param_uploads": self._param_uploads,
                # Host wall time per engine step: dispatch (enqueueing the
                # step's kernels), fetch (waiting on the previous step's
                # copy) and host (scheduling, token hand-out).
                "timing": {
                    "steps_timed": self._timed_steps,
                    "dispatch_ms_avg": self._t_dispatch / ts * 1e3,
                    "fetch_ms_avg": self._t_fetch / ts * 1e3,
                    "host_ms_avg": self._t_host / ts * 1e3,
                    "dispatch_ms_total": self._t_dispatch * 1e3,
                    "fetch_ms_total": self._t_fetch * 1e3,
                    "host_ms_total": self._t_host * 1e3,
                },
                "latency": {
                    "ttft": self._latency.summary("ttft"),
                    "tpot": self._latency.summary("tpot"),
                    "occupancy": len(self._slots) / self.num_slots,
                },
                "hol": {
                    "blocked_slot_seconds": self._hol_blocked_s,
                    "events": list(self._hol_events),
                },
            }

    def shutdown(self):
        self._stop_evt.set()
        self._work.set()
        self._thread.join(timeout=30)
        # Outstanding handles must resolve: a streaming consumer blocked
        # in __iter__ would otherwise wait forever.
        err = RuntimeError("engine shut down")
        with self._lock:
            pending = (list(self._slots.values())
                       + self._drain_waiting_locked()
                       + [e["h"] for e in self._prefilling.values()])
            for h in pending:
                h._fail(err)
            self._slots.clear()
            self._prefilling.clear()

    # -- engine loop -----------------------------------------------------
    def _drain_waiting_locked(self) -> list:
        """Flatten and empty every tenant queue (shutdown/failure)."""
        out: list = []
        for q in self._waiting.values():
            out.extend(q)
        self._waiting.clear()
        self._wfq_rr.clear()
        self._wfq_credit.clear()
        self._waiting_n = 0
        return out

    def _pop_waiting_locked(self) -> Optional[GenerationHandle]:
        """Next request under deficit-round-robin over tenant queues: each
        rotation a tenant earns its weight in credits; one credit admits
        one request; a tenant whose queue empties leaves the rotation."""
        while self._wfq_rr:
            t = self._wfq_rr.popleft()
            q = self._waiting.get(t)
            if not q:
                self._waiting.pop(t, None)
                self._wfq_credit.pop(t, None)
                continue
            credit = (self._wfq_credit.get(t, 0.0)
                      + self._tenant_weights.get(t, 1.0))
            h = None
            if credit >= 1.0:
                h = q.popleft()
                self._waiting_n -= 1
                credit -= 1.0
            self._wfq_credit[t] = credit
            self._wfq_rr.append(t)
            if h is not None:
                return h
        return None

    def _admit_locked(self):
        """Assign free slots to waiting requests; their prompts then
        prefill ONE chunk per loop iteration. Requests whose deadline
        expired while queued (or that the caller cancelled) are dropped
        here instead of taking a slot."""
        now = time.time()
        while self._free and self._waiting_n:
            h = self._pop_waiting_locked()
            if h is None:
                break
            if h.cancelled:
                continue  # cancel() already failed the handle
            if h.deadline_ts and now > h.deadline_ts:
                self._deadline_expired += 1
                h._fail(RequestCancelledError(
                    f"deadline expired in admission queue "
                    f"(request {h.request_id})",
                    reason="deadline", rid=str(h.request_id),
                ))
                continue
            # The loop cuts a sequence at lengths >= max_len - 2, so a
            # prompt of P rows can emit max_len - 1 - P tokens.
            h.max_new_tokens = min(
                h.max_new_tokens, self.max_len - 1 - len(h.prompt)
            )
            res = None
            if self._paged:
                # Reserve EVERY page the request can ever touch now:
                # decode then never allocates.
                res = self._reserve_paged_locked(h)
                if res is None:
                    # Pool pressure: back to the FRONT of its tenant queue.
                    q = self._waiting.get(h.tenant)
                    if q is None:
                        q = self._waiting[h.tenant] = deque()
                        self._wfq_rr.append(h.tenant)
                    q.appendleft(h)
                    self._waiting_n += 1
                    break
            slot = self._free.popleft()
            entry = {"h": h, "offset": 0}
            if self._paged:
                entry["offset"] = res["skip"]
                entry["pages"] = res["pages"]
                entry["hashes"] = res["hashes"]
                row = self._bt_host[slot]
                row[:] = 0
                row[:len(res["pages"])] = res["pages"]
                self._bt_dirty = True
            self._prefilling[slot] = entry

    def _reserve_paged_locked(self, h) -> Optional[Dict]:
        """Pages for one admission: shared prefix pages from the cache
        (refcount bump, prefill skipped below `skip`) plus freshly
        allocated pages covering the rest of the request's maximum
        footprint. None = pool exhausted even after LRU-evicting cache
        entries; the caller requeues."""
        ps = self.page_size
        p_len = len(h.prompt)
        hashes = (paged_kv.page_hashes(h.prompt, ps)
                  if self._prefix_cache is not None else [])
        shared = self._prefix_cache.match(hashes) if hashes else []
        # Footprint: prompt + generated tokens + one margin row for the
        # pipelined in-flight step, capped by addressable positions.
        rows = min(p_len + h.max_new_tokens + 1, self.max_len)
        need = -(-rows // ps) - len(shared)
        try:
            own = self._pool.alloc(need)
        except paged_kv.OutOfPages:
            own = None
            if self._prefix_cache is not None and self._prefix_cache.pages_held:
                self._prefix_cache.evict_pages(
                    need - self._pool.free_pages
                )
                try:
                    own = self._pool.alloc(need)
                except paged_kv.OutOfPages:
                    own = None
        if own is None:
            if shared:
                self._pool.release(shared)
            return None
        pages = shared + own
        # Always recompute at least the final prompt token: its logits
        # seed the first generated token.
        skip = min(len(shared) * ps, p_len - 1)
        if hashes:
            if shared:
                self._prefix_hits += 1
            else:
                self._prefix_misses += 1
        if skip > 0:
            self._prefill_tok_skipped += skip
        fw = skip // ps
        if skip and fw < len(shared):
            # Full-prefix hit: the recomputed final token's K/V lands in
            # the LAST shared page — fork it copy-on-write first
            # (refcount > 1 pages are never written).
            try:
                fork = self._pool.alloc(1)[0]
            except paged_kv.OutOfPages:
                self._pool.release(pages)
                return None
            paged_kv.cow_copy_page(self._k, self._v, pages[fw], fork)
            self._pool.release([pages[fw]])
            pages[fw] = fork
        return {"pages": pages, "hashes": hashes, "skip": skip}

    def _release_slot_pages_locked(self, slot: int):
        """Return a decoding slot's page references to the pool (prefix-
        cache entries keep their own references)."""
        pages = self._slot_pages.pop(slot, None)
        if pages:
            self._pool.release(pages)

    def _evict_locked(self, s: int):
        del self._slots[s]
        self._free.append(s)
        self._gen[s] += 1
        self._active[s] = False
        self._temps[s] = 0.0
        self._top_ks[s] = 0
        self._top_ps[s] = 1.0
        self._params_dirty = True
        if self._paged:
            self._release_slot_pages_locked(s)

    def _advance_prefills(self):
        """One prefill chunk for every mid-prefill slot. A request whose
        final chunk lands emits its first token and joins the decode set.
        First tokens stay on the device for the decode loop; ONE batched
        copy delivers this round's first tokens to their handles."""
        c = self.prefill_chunk
        if self._paged and self._bt_dirty:
            self._upload_block_table()
        self._last_prefill_work = [
            {
                "request_id": e["h"].request_id,
                "prompt_tokens": int(len(e["h"].prompt)),
                "offset": int(e["offset"]),
            }
            for e in self._prefilling.values()
        ]
        finished = []  # (slot, handle, first-token device tensor, entry)
        now_wall = time.time()
        for slot, entry in list(self._prefilling.items()):
            h, off = entry["h"], entry["offset"]
            if h.cancelled or (h.deadline_ts and now_wall > h.deadline_ts):
                # Abandon the partial prefill.
                if not h.cancelled:
                    h._fail(RequestCancelledError(
                        f"deadline expired mid-prefill "
                        f"(request {h.request_id})",
                        reason="deadline", rid=str(h.request_id),
                    ))
                with self._lock:
                    self._deadline_expired += int(not h.cancelled)
                    del self._prefilling[slot]
                    self._free.append(slot)
                    if self._paged:
                        self._pool.release(entry["pages"])
                continue
            chunk = h.prompt[off:off + c]
            n = len(chunk)
            padded = np.zeros((1, c), dtype=np.int64)
            padded[0, :n] = chunk
            logits = self._prefill(self._h2d(padded), n, slot, off)
            self._forward_passes += 1
            self._prefill_chunks += 1
            entry["offset"] = off + n
            if entry["offset"] < len(h.prompt):
                continue
            # Final chunk: first token under the request's sampling.
            if h.temperature > 0:
                dev = self.device
                tok_dev = _pick_tokens(
                    logits,
                    torch.full((1,), h.temperature, device=dev),
                    torch.full((1,), h.top_k, dtype=torch.int64, device=dev),
                    torch.full((1,), h.top_p, device=dev),
                    self._rng,
                )
            else:
                tok_dev = torch.argmax(logits, dim=-1)
            # Feed the decode loop device-side, into a new tensor as JAX's
            # `.at[].set` makes one (the old one may still be read).
            self._tokens_dev = self._tokens_dev.clone()
            self._tokens_dev[slot] = tok_dev[0]
            finished.append((slot, h, tok_dev, entry))
        if not finished:
            return
        toks = torch.cat([t for _, _, t, _ in finished]).tolist()
        for (slot, h, _, entry), tok in zip(finished, toks):
            h.produced = 1
            # admitted_at_step must be visible before the push wakes a
            # consumer. _steps is only written by this thread.
            h.admitted_at_step = self._steps
            done = (tok == self.eos_id if self.eos_id is not None
                    else False) or h.produced >= h.max_new_tokens
            h._push(tok, done)
            with self._lock:
                if self._paged and self._prefix_cache is not None:
                    # Publish the prompt's full pages NOW: a concurrent
                    # same-prefix request admitted next tick shares them.
                    hashes = entry.get("hashes") or []
                    if hashes:
                        self._prefix_cache.insert(
                            hashes, entry["pages"][:len(hashes)]
                        )
                del self._prefilling[slot]
                if done:
                    self._free.append(slot)
                    if self._paged:
                        self._pool.release(entry["pages"])
                else:
                    if self._paged:
                        self._slot_pages[slot] = entry["pages"]
                    self._slots[slot] = h
                    self._gen[slot] += 1
                    self._temps[slot] = h.temperature
                    self._top_ks[slot] = h.top_k
                    self._top_ps[slot] = h.top_p
                    self._active[slot] = True
                    self._params_dirty = True

    def _note_hol(self, prefill_s: float, n_active: int):
        """Attribute a slow prefill pass to the decode slots it stalled.
        prefill_s is host time: on the card it is the time to enqueue the
        pass, plus any wait the pass forced."""
        if n_active <= 0 or prefill_s < get_config().serve_hol_threshold_s:
            return
        blocked = prefill_s * n_active  # slot-seconds of stalled decode
        with self._lock:
            self._hol_blocked_s += blocked
            self._hol_events.append({
                "ts": time.time(),
                "prefill_s": prefill_s,
                "victims": n_active,
                "blocked_slot_seconds": blocked,
                "culprits": self._last_prefill_work,
            })

    def _loop(self):
        """Pipelined decode loop: dispatch step k+1 (inputs from step k's
        on-device pick), start the non-blocking copy of its outputs, then
        wait for step k's copy — started a full iteration earlier — and
        hand out its tokens. Eviction lags one step (a finished slot
        rides one suppressed step before its slot frees)."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.inference_mode():
            self._run_loop()

    def _run_loop(self):
        inflight = None  # (snapshot [(slot, gen, handle)], pending fetch)
        while not self._stop_evt.is_set():
            try:
                t_iter = time.perf_counter()
                with self._lock:
                    self._admit_locked()
                if self._prefilling:
                    n_active = len(self._slots)
                    t_pf = time.perf_counter()
                    self._advance_prefills()
                    self._note_hol(time.perf_counter() - t_pf, n_active)
                with self._lock:
                    snapshot = [
                        (s, int(self._gen[s]), h)
                        for s, h in self._slots.items()
                    ]
                dispatch_s = 0.0
                if snapshot:
                    if self._params_dirty:
                        self._upload_sampling_state()
                    if self._paged and self._bt_dirty:
                        self._upload_block_table()
                    t0 = time.perf_counter()
                    next_dev, self._lengths = self._decode(
                        sampled=self._sampled_active)
                    self._forward_passes += 1
                    self._tokens_dev = next_dev
                    # Start the D2H copy NOW: it lands while this thread
                    # hands out the previous step's tokens.
                    pending = self._fetch.start(next_dev, self._lengths)
                    dispatch_s = time.perf_counter() - t0
                    new_inflight = (snapshot, pending)
                else:
                    new_inflight = None
                fetch_s = 0.0
                if inflight is not None:
                    prev_snapshot, prev_pending = inflight
                    t0 = time.perf_counter()
                    toks, lengths_np = self._fetch.wait(prev_pending)
                    fetch_s = time.perf_counter() - t0
                    now_wall = time.time()
                    with self._lock:
                        self._steps += 1
                        for s, gen, h in prev_snapshot:
                            if (self._gen[s] != gen
                                    or self._slots.get(s) is not h):
                                continue  # evicted under the lag
                            if h.cancelled or (
                                h.deadline_ts and now_wall > h.deadline_ts
                            ):
                                # Dead work never holds a slot: evict,
                                # fail the handle (cancel() already did
                                # for the cancelled case).
                                if not h.cancelled:
                                    self._deadline_expired += 1
                                    h._fail(RequestCancelledError(
                                        f"deadline expired mid-decode "
                                        f"(request {h.request_id}, "
                                        f"{h.produced} tokens produced)",
                                        reason="deadline",
                                        rid=str(h.request_id),
                                    ))
                                self._evict_locked(s)
                                continue
                            tok = int(toks[s])
                            h.produced += 1
                            done = (
                                (self.eos_id is not None
                                 and tok == self.eos_id)
                                or h.produced >= h.max_new_tokens
                                # One in-flight step may still write:
                                # keep a row of margin.
                                or int(lengths_np[s]) >= self.max_len - 2
                            )
                            h._push(tok, done)
                            if done:
                                self._evict_locked(s)
                inflight = new_inflight
                if snapshot:
                    host_s = max(
                        time.perf_counter() - t_iter - dispatch_s - fetch_s,
                        0.0,
                    )
                    with self._lock:
                        self._t_dispatch += dispatch_s
                        self._t_fetch += fetch_s
                        self._t_host += host_s
                        self._timed_steps += 1
                if inflight is None and not self._prefilling:
                    self._work.wait(timeout=0.5)
                    self._work.clear()
            except Exception as e:  # noqa: BLE001 — fail all, keep serving
                with self._lock:
                    pending = (
                        list(self._slots.values())
                        + self._drain_waiting_locked()
                        + [en["h"] for en in self._prefilling.values()]
                    )
                    for h in pending:
                        h._fail(e)
                    self._slots.clear()
                    self._prefilling.clear()
                    self._free = deque(range(self.num_slots))
                    # A failed step may have left the cache half written:
                    # rebuild it before serving again.
                    cache = self._fresh_cache()
                    self._k, self._v = cache["k"], cache["v"]
                    self._lengths = cache["lengths"]
                    if self._paged:
                        # Every page reference pointed into the dead cache.
                        self._bt_dev = cache["block_tables"]
                        self._pool.reset()
                        if self._prefix_cache is not None:
                            self._prefix_cache.reset()
                        self._slot_pages.clear()
                        self._bt_host[:] = 0
                        self._bt_dirty = False
                    self._tokens_dev = torch.zeros(
                        self.num_slots, dtype=torch.int64, device=self.device
                    )
                    self._gen += 1  # orphan any in-flight snapshot
                    self._active[:] = False
                    self._temps[:] = 0.0
                    self._top_ks[:] = 0
                    self._top_ps[:] = 1.0
                    self._params_dirty = True
                inflight = None
                time.sleep(0.1)


class LLMReplica:
    """Replica class wrapping the engine: blocking generate, token
    streaming, and engine stats. `model_loader()` returns (params, cfg);
    the engine runs on the device that holds the params."""

    def __init__(self, model_loader, num_slots: int = 4, max_len: int = 256,
                 eos_id: Optional[int] = None,
                 default_max_new_tokens: int = 32,
                 prefill_chunk: int = 64, kv_mode: Optional[str] = None,
                 page_size: Optional[int] = None,
                 kv_pages: Optional[int] = None):
        loaded = model_loader()
        if len(loaded) != 2:
            raise ValueError(
                "model_loader must return (params, cfg); tensor-parallel "
                "serving (a mesh) is not ported yet")
        params, cfg = loaded
        self.engine = ContinuousBatchingEngine(
            params, cfg, num_slots=num_slots, max_len=max_len,
            eos_id=eos_id, default_max_new_tokens=default_max_new_tokens,
            prefill_chunk=prefill_chunk, kv_mode=kv_mode,
            page_size=page_size, kv_pages=kv_pages,
        )

    def __call__(self, prompt, max_new_tokens: Optional[int] = None,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None):
        # A propagated deadline bounds the blocking wait too.
        budget = request_context.remaining_budget()
        timeout = get_config().serve_result_timeout_s
        if budget != float("inf"):
            timeout = max(0.01, min(timeout, budget))
        return self.engine.submit(
            prompt, max_new_tokens, temperature=temperature,
            top_k=top_k, top_p=top_p,
        ).result(timeout=timeout)

    def stream(self, prompt, max_new_tokens: Optional[int] = None,
               temperature: float = 0.0, top_k: Optional[int] = None,
               top_p: Optional[float] = None):
        h = self.engine.submit(
            prompt, max_new_tokens, temperature=temperature,
            top_k=top_k, top_p=top_p,
        )
        try:
            yield from h
        except GeneratorExit:
            # The consumer abandoned the stream: free the decode slot.
            h.cancel("client")
            raise

    def stats(self):
        return self.engine.stats()

    def shutdown(self):
        self.engine.shutdown()
