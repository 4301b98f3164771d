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
  * The `util.metrics` export (`_engine_metrics`), the observatory's
    per-request stamps, the chaos hooks and the head-of-line watchdog's
    journal and postmortem calls are the JAX engine's. `stats()`'s
    TTFT/TPOT summaries come from the engine's own samples (`_Latency`,
    with p50 and p99), not from the process-wide histograms.
  * Tensor parallelism. The JAX engine is one controller over a mesh
    and GSPMD inserts the collectives. The port's mesh is one process per
    rank (parallel/mesh.py), so every tp rank builds the engine on its
    shards (heads, MLP and vocabulary split over "tp", the KV pool
    holding the rank's KV heads) and runs each device step in lockstep:
    rank 0 owns the scheduler, the handles and the streams, and before
    each device call it broadcasts one fixed-size plan over the tp group
    (the call's kind, its slots, tokens, offsets and sampling parameters,
    or the host arrays it uploads); the followers make the same call on
    their shards. Partial products, the embedding and the logits are
    summed over tp, so every rank picks the same tokens from the same
    logits and keeps its next inputs on its own device.
    `LLMReplica` starts the followers itself, one per further card the
    raylet granted it, and stops them with it.

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
from ray_tpu_torch._private import chaos
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
from ray_tpu_torch.parallel._comm import sum_over
from ray_tpu_torch.parallel.mesh import axis_index, axis_size
from ray_tpu_torch.serve import context as request_context
from ray_tpu_torch.serve import observatory, paged_kv

NEG_INF = -1e30

_STEP_MS_BOUNDARIES = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                       100.0, 250.0)
_metrics_lock = threading.Lock()
_metrics: Optional[Dict] = None


def _engine_metrics() -> Dict:
    """Module-level serving metrics (ray_tpu_torch.util.metrics): one set
    per process, shared by every engine, flushed to GCS/Prometheus by the
    metrics flusher. Created lazily so importing llm.py never spins up
    the flusher thread. The JAX engine's `serve_llm_recompiles_total`
    has no counterpart in eager PyTorch."""
    global _metrics
    with _metrics_lock:
        if _metrics is None:
            from ray_tpu_torch.util import metrics as _mx
            from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

            _metrics = {
                "dispatch_ms": Histogram(
                    "serve_llm_step_dispatch_ms",
                    "Decode-step dispatch time (enqueue the step's kernels)",
                    boundaries=_STEP_MS_BOUNDARIES,
                ),
                "fetch_ms": Histogram(
                    "serve_llm_step_fetch_ms",
                    "Blocking time draining the previous step's async "
                    "device->host token copy",
                    boundaries=_STEP_MS_BOUNDARIES,
                ),
                "host_ms": Histogram(
                    "serve_llm_step_host_ms",
                    "Host-side engine work per step (scheduling, token "
                    "distribution, locking)",
                    boundaries=_STEP_MS_BOUNDARIES,
                ),
                "param_uploads": Counter(
                    "serve_llm_param_uploads_total",
                    "Host->device sampling-param/active-mask refreshes "
                    "(only on slot admission/eviction, never per step)",
                ),
                # Request-level latency: TTFT is submit->first token
                # (queue wait + prefill), TPOT the mean inter-token
                # interval after the first.
                "ttft_s": Histogram(
                    "serve_llm_ttft_seconds",
                    "Time to first token: submit() to the first pushed "
                    "token, per request",
                    boundaries=_mx.LATENCY_BOUNDARIES_WIDE,
                ),
                "tpot_s": Histogram(
                    "serve_llm_tpot_seconds",
                    "Time per output token after the first (decode-rate "
                    "inverse), per finished request",
                    boundaries=_mx.LATENCY_BOUNDARIES,
                ),
                "occupancy": Gauge(
                    "serve_llm_batch_occupancy",
                    "Decoding slots in use / total slots, sampled every "
                    "engine step (how full the continuous batch runs)",
                ),
                "waiting": Gauge(
                    "serve_llm_waiting_requests",
                    "Requests enqueued but not yet granted a decode slot "
                    "(admission queue depth; the backlog half of the "
                    "autoscaling signal next to occupancy)",
                ),
                "admission_wait_s": Histogram(
                    "serve_llm_admission_wait_seconds",
                    "submit() enqueue to decode-slot grant, per request "
                    "(pure queueing: saturation shows here before TTFT)",
                    boundaries=_mx.LATENCY_BOUNDARIES,
                ),
                "hol_s": Counter(
                    "serve_hol_blocked_seconds_total",
                    "Decode-slot-seconds stalled behind prefill passes "
                    "crossing serve_hol_threshold_s (head-of-line "
                    "blocking attributed to the long prefill causing it)",
                ),
                # Paged KV memory plane (serve/paged_kv.py).
                "kv_pages": Gauge(
                    "serve_kv_pages_in_use",
                    "KV page-pool pages currently referenced (request "
                    "block tables + prefix-cache entries), sampled every "
                    "engine step",
                ),
                "prefix_hits": Counter(
                    "serve_prefix_cache_hits_total",
                    "Admissions whose prompt prefix was resident in the "
                    "page-level prefix cache (>= 1 full page shared)",
                ),
                "prefix_misses": Counter(
                    "serve_prefix_cache_misses_total",
                    "Admissions that found no resident prompt prefix "
                    "(every prefill chunk recomputed)",
                ),
                "prefill_skipped": Counter(
                    "serve_prefill_tokens_skipped_total",
                    "Prompt tokens NOT re-prefilled because their pages "
                    "were shared from the prefix cache",
                ),
            }
        return _metrics


def init_slotted_cache(cfg: TransformerConfig, slots: int, max_len: int,
                       device=None, mesh=None) -> Dict:
    """[layers, slots, max_len, kv_heads, head_dim] cache with PER-SLOT
    lengths, so sequences of different ages share one decode batch. Under
    a mesh it holds this rank's KV heads (split over "tp")."""
    device = resolve_device(device)
    shape = (cfg.n_layers, slots, max_len,
             cfg.n_kv_heads // axis_size(mesh, "tp"), cfg.head_dim)
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


def _embed(params, tokens, cfg: TransformerConfig, mesh=None):
    """The embedding rows of `tokens`. Under tp each rank holds a block of
    the vocabulary: it contributes the rows it holds and zeros elsewhere,
    and the sum over tp is every row exactly."""
    if axis_size(mesh, "tp") == 1:
        return _embed_tokens(params, tokens, cfg)
    table = params["embed"]
    rows = table.shape[0]
    local = tokens - axis_index(mesh, "tp") * rows
    hit = (local >= 0) & (local < rows)
    x = torch.where(hit[..., None], table[local.clamp(0, rows - 1)],
                    torch.zeros((), dtype=table.dtype, device=table.device))
    x = sum_over(x, mesh, ("tp",)).to(cfg.dtype)
    if cfg.scale_embeddings:  # as _embed_tokens scales
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype,
                             device=x.device)
    return x


def _logits(x, params, cfg: TransformerConfig, mesh=None):
    """Logits over the whole vocabulary on every rank: under tp each rank
    projects onto its vocabulary block and the blocks are summed into
    place."""
    local = project_logits(x, params, cfg)
    tp = axis_size(mesh, "tp")
    if tp == 1:
        return local
    v = local.shape[-1]
    r = axis_index(mesh, "tp")
    full = local.new_zeros(local.shape[:-1] + (v * tp,))
    full[..., r * v:(r + 1) * v] = local
    return sum_over(full, mesh, ("tp",))


def _layer_body(x, lp, k_cache_l, v_cache_l, cfg, cos, sin, positions,
                write_kv, valid, mesh=None):
    """One transformer layer shared by decode and prefill, both KV modes.

    The callers differ only in how K/V land in the cache and what the
    attention source is: `write_kv(kc, vc, k, v) -> (k_att, v_att)`
    writes the layer's cache in place and returns what to attend against;
    `valid` is the caller's mask over (B, Lq, Lk_att). Under a mesh the
    layer computes this rank's heads and MLP columns and sums the output
    projections over tp. Returns x."""
    b, l = x.shape[:2]
    h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    q = (h @ lp["wq"]).reshape(b, l, -1, cfg.head_dim)
    k = (h @ lp["wk"]).reshape(b, l, -1, cfg.head_dim)
    v = (h @ lp["wv"]).reshape(b, l, -1, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(q, lp["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, lp["k_norm"], cfg.norm_eps)
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    k_att, v_att = write_kv(k_cache_l, v_cache_l, k, v)
    attn = _grouped_attention(q, k_att.float(), v_att.float(), valid)
    x = x + sum_over(attn.reshape(b, l, -1) @ lp["wo"], mesh,
                     ("tp",)).to(x.dtype)
    h = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    gate = _act(cfg)((h @ lp["w_gate"]).float())
    up = (h @ lp["w_up"]).float()
    return x + sum_over((gate * up).to(x.dtype) @ lp["w_down"], mesh,
                        ("tp",))


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
                  temps, top_ks, top_ps, gen, cfg: TransformerConfig,
                  mesh=None):
    """One decode step for every slot at once.

    tokens [S] (last emitted per slot), lengths [S] (valid cache rows per
    slot), active [S] bool. Writes each ACTIVE slot's K/V at its own
    position in place; inactive slots write into their last row (masked
    out forever) and keep their length. Returns (next_tokens [S],
    new_lengths [S]); temps=None picks greedily. Under a mesh, the caches
    hold this rank's KV heads and `params` its shards."""
    s_ = tokens.shape[0]
    lmax = k_cache.shape[2]
    dev = tokens.device
    x = _embed(params, tokens[:, None], cfg, mesh)  # [S, 1, d]
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
def _prefill_chunk(params, tokens, n_valid: int, slot: int, offset: int,
                   k_cache, v_cache, lengths, cfg: TransformerConfig,
                   mesh=None):
    """CHUNKED prefill: one fixed-size chunk of a prompt into slot `slot`
    at row `offset`. tokens [1, C] (first n_valid real); writes K/V rows
    [slot, offset:offset+C] in place, dropping rows past the cache end
    (JAX's scatter mode="drop"); queries attend causally to the slot's
    whole cache prefix. Sets lengths[slot] = offset + n_valid and returns
    the logits of the chunk's last REAL position [1, vocab]."""
    _, c = tokens.shape
    lmax = k_cache.shape[2]
    dev = tokens.device
    x = _embed(params, tokens, cfg, mesh)
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
                        positions, write_kv, valid, mesh)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(x[:, n_valid - 1], params, cfg, mesh)
    # fill_ runs on the device; `lengths[slot] = n` would copy a host
    # scalar and wait for every step already enqueued.
    lengths[slot].fill_(offset + n_valid)
    return logits


# The kinds of device call a tp leader broadcasts to its followers; a plan
# is one float64 tensor: [kind, a0..a6, payload...] (float64 carries the
# token ids, page ids and f32 sampling parameters exactly).
_PLAN_STOP, _PLAN_DECODE, _PLAN_PREFILL, _PLAN_SAMPLING, _PLAN_TABLE, \
    _PLAN_COW, _PLAN_RESET = range(7)
_PLAN_HEAD = 8


class _Latency:
    """Per-engine TTFT/TPOT samples, read by `stats()` (the process-wide
    histograms of `_engine_metrics` keep no percentiles)."""

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
        # Observatory stamp card (set by submit() from the request
        # thread's context; engine thread writes marks into it).
        self.obs = None
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
        # Observe outside the condition: a blocked consumer wakes without
        # waiting on the metrics registry lock.
        m = _engine_metrics()
        lat = self._latency
        if first and self.submitted_at is not None:
            m["ttft_s"].observe(now - self.submitted_at)
            if lat is not None:
                lat.observe("ttft", now - self.submitted_at)
        if done and self.produced > 1 and not first:
            tpot = (now - self._first_token_t) / (self.produced - 1)
            m["tpot_s"].observe(tpot)
            if lat is not None:
                lat.observe("tpot", tpot)
        obs = self.obs
        if obs is not None:
            if first:
                obs.marks["first_token"] = now
            if done:
                obs.marks["engine_done"] = now
                obs.tokens_out = self.produced

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
                 kv_pages: Optional[int] = None, mesh=None):
        """mesh: a DeviceMesh with a "tp" axis for tensor-parallel serving
        (parallel.build_mesh; params already this rank's shards, by
        parallel.shard_params). Every tp rank builds the engine; rank 0
        serves and the others follow it step by step (module docstring).

        prefill_chunk: prompts prefill in fixed chunks of this many
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
        self.mesh = mesh
        if mesh is not None:
            if "tp" not in (mesh.mesh_dim_names or ()):
                raise ValueError(
                    "the engine's mesh needs a \"tp\" axis (KV heads "
                    f"shard over it); got axes {mesh.mesh_dim_names}"
                )
            if cfg.n_kv_heads % axis_size(mesh, "tp"):
                raise ValueError(
                    f"the mesh's tp={axis_size(mesh, 'tp')} must divide "
                    f"n_kv_heads={cfg.n_kv_heads}"
                )
        if cfg.mla:
            raise ValueError(
                "the serving engine does not run multi-head latent "
                "attention (MLA): it has no latent KV cache; the config "
                f"has kv_lora_rank={cfg.kv_lora_rank}")
        self._tp = axis_size(mesh, "tp")
        self.tp_rank = axis_index(mesh, "tp")
        # Plans flow only once both sides have warmed up alike.
        self._mirror = False
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
            self._chaos_held: list = []
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
        if self._tp > 1:
            import torch.distributed as dist

            self._tp_group = mesh.get_group("tp")
            self._tp_root = dist.get_global_rank(self._tp_group, 0)
            width = max(4 * num_slots, self.prefill_chunk, 2)
            if self._paged:
                width = max(width, num_slots * self._pages_per_slot)
            self._plan_len = _PLAN_HEAD + width
        self._warmup()
        self._stop_evt = threading.Event()
        self._mirror = self._tp > 1
        self._thread = threading.Thread(
            target=self._follow if self.tp_rank else self._loop,
            name="llm-engine", daemon=True
        )
        self._thread.start()

    # -- tensor-parallel plans -------------------------------------------
    def _plan(self, kind: int, *args, payload=None):
        """Rank 0 of a tp group: broadcast the device call about to run.
        A no-op without followers, and while the engine warms up (every
        rank warms up alike)."""
        if not self._mirror or self.tp_rank:
            return
        import torch.distributed as dist

        plan = np.zeros(self._plan_len, dtype=np.float64)
        plan[0] = kind
        plan[1:1 + len(args)] = args
        if payload is not None:
            flat = np.asarray(payload, dtype=np.float64).reshape(-1)
            plan[_PLAN_HEAD:_PLAN_HEAD + flat.size] = flat
        t = torch.from_numpy(plan).to(self.device)
        dist.broadcast(t, src=self._tp_root, group=self._tp_group)

    def _follow(self):
        """A follower rank's loop: take each plan rank 0 broadcasts and
        make the same device call on this rank's shards, until STOP."""
        import torch.distributed as dist

        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        s_ = self.num_slots
        buf = torch.empty(self._plan_len, dtype=torch.float64,
                          device=self.device)
        with torch.inference_mode():
            while True:
                dist.broadcast(buf, src=self._tp_root, group=self._tp_group)
                plan = buf.cpu().numpy()
                kind, a = int(plan[0]), plan[1:_PLAN_HEAD]
                body = plan[_PLAN_HEAD:]
                if kind == _PLAN_STOP:
                    return
                if kind == _PLAN_DECODE:
                    self._decode_step(bool(a[0]))
                elif kind == _PLAN_PREFILL:
                    c = self.prefill_chunk
                    pick = (None if not a[3] else
                            (float(np.float32(a[4])), int(a[5]),
                             float(np.float32(a[6]))))
                    self._prefill_step(body[:c].astype(np.int64)[None],
                                       int(a[2]), int(a[0]), int(a[1]), pick)
                elif kind == _PLAN_SAMPLING:
                    self._temps[:] = body[:s_]
                    self._top_ks[:] = body[s_:2 * s_]
                    self._top_ps[:] = body[2 * s_:3 * s_]
                    self._active[:] = body[3 * s_:4 * s_] != 0
                    self._upload_sampling_state()
                elif kind == _PLAN_TABLE:
                    self._bt_host[:] = body[:self._bt_host.size].reshape(
                        self._bt_host.shape)
                    self._upload_block_table()
                elif kind == _PLAN_COW:
                    paged_kv.cow_copy_page(self._k, self._v, int(a[0]),
                                           int(a[1]))
                elif kind == _PLAN_RESET:
                    self._reset_device_state()

    # -- device steps (loop thread, and _warmup before it starts) --------
    def _decode_step(self, sampled: bool):
        """One decode dispatch: its picks become the next inputs."""
        self._plan(_PLAN_DECODE, int(sampled))
        next_dev, self._lengths = self._decode(sampled=sampled)
        self._forward_passes += 1
        self._tokens_dev = next_dev
        return next_dev

    def _prefill_step(self, padded: np.ndarray, n: int, slot: int, off: int,
                      pick):
        """One prefill chunk of `slot`; on the prompt's last chunk `pick`
        is (temperature, top_k, top_p) and the first token is picked on
        the device, fed to the decode loop, and returned."""
        if pick is None:
            self._plan(_PLAN_PREFILL, slot, off, n, 0, payload=padded)
        else:
            self._plan(_PLAN_PREFILL, slot, off, n, 1, *pick,
                       payload=padded)
        logits = self._prefill(self._h2d(padded), n, slot, off)
        self._forward_passes += 1
        self._prefill_chunks += 1
        if pick is None:
            return None
        temperature, top_k, top_p = pick
        if temperature > 0:
            dev = self.device
            tok_dev = _pick_tokens(
                logits,
                torch.full((1,), temperature, device=dev),
                torch.full((1,), top_k, dtype=torch.int64, device=dev),
                torch.full((1,), top_p, device=dev),
                self._rng,
            )
        else:
            tok_dev = torch.argmax(logits, dim=-1)
        # Feed the decode loop device-side, into a new tensor as JAX's
        # `.at[].set` makes one (the old one may still be read).
        self._tokens_dev = self._tokens_dev.clone()
        self._tokens_dev[slot] = tok_dev[0]
        return tok_dev

    def _decode(self, sampled: bool):
        gen = self._rng if sampled else None
        temps, top_ks, top_ps = ((self._temps_dev, self._top_ks_dev,
                                  self._top_ps_dev) if sampled
                                 else (None, None, None))
        if self._paged:
            return paged_kv.decode_paged(
                self.params, self._tokens_dev, self._k, self._v,
                self._lengths, self._active_dev, self._bt_dev, temps,
                top_ks, top_ps, gen, self.cfg, self.max_len, self.mesh,
            )
        return _decode_slots(
            self.params, self._tokens_dev, self._k, self._v, self._lengths,
            self._active_dev, temps, top_ks, top_ps, gen, self.cfg,
            self.mesh,
        )

    def _prefill(self, tokens, n: int, slot: int, off: int):
        if self._paged:
            return paged_kv.prefill_chunk_paged(
                self.params, tokens, n, slot, off, self._k, self._v,
                self._lengths, self._bt_dev, self.cfg, self.max_len,
                self.mesh,
            )
        return _prefill_chunk(
            self.params, tokens, n, slot, off, self._k, self._v,
            self._lengths, self.cfg, self.mesh,
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
        self._plan(_PLAN_SAMPLING, payload=np.concatenate([
            self._temps, self._top_ks, self._top_ps, self._active]))
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
        self._plan(_PLAN_TABLE, payload=self._bt_host)
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

    def _apply_kv_chaos(self):
        """Consume pending paged-KV chaos injections (RT_CHAOS=1 only):
        a one-shot prefix-cache flush, and a persistent pool-pressure
        target — the engine holds `frac` of the usable pages hostage,
        adjusting toward the target as pages free up, until the frac is
        set back to 0."""
        if self._prefix_cache is not None and chaos.take_flush_prefix_cache():
            with self._lock:
                self._prefix_cache.flush()
        frac = chaos.kv_exhaust_frac()
        if frac is None and not self._chaos_held:
            return
        target = int(round((frac or 0.0) * self._pool.usable))
        with self._lock:
            if len(self._chaos_held) > target:
                give_back = self._chaos_held[target:]
                del self._chaos_held[target:]
                self._pool.release(give_back)
            elif len(self._chaos_held) < target:
                grab = min(target - len(self._chaos_held),
                           self._pool.free_pages)
                if grab > 0:
                    self._chaos_held.extend(self._pool.alloc(grab))

    def _fresh_cache(self) -> Dict:
        if self._paged:
            return paged_kv.init_paged_cache(
                self.cfg, self.num_slots, self.kv_pages, self.page_size,
                self._pages_per_slot, device=self.device, mesh=self.mesh,
            )
        return init_slotted_cache(self.cfg, self.num_slots, self.max_len,
                                  device=self.device, mesh=self.mesh)

    # -- public API ------------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               temperature: float = 0.0, top_k: Optional[int] = None,
               top_p: Optional[float] = None) -> GenerationHandle:
        """temperature=0 decodes greedily (the default); >0 samples,
        optionally filtered by per-request top_k (<= MAX_TOP_K) and
        top_p — mixed greedy/sampled requests share one decode batch."""
        if self.tp_rank:
            raise RuntimeError(
                f"tp rank {self.tp_rank} follows rank 0's engine; submit "
                f"requests to rank 0")
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
        obs = observatory.current()
        meta = request_context.current()
        tenant = (meta.tenant if meta is not None else "") or "default"
        deadline_ts = meta.deadline_ts if meta is not None else 0.0
        cfg = get_config()
        if deadline_ts and time.time() > deadline_ts:
            with self._lock:
                self._deadline_expired += 1
            observatory.record_deadline_expired("", "engine_admission")
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
                observatory.record_shed("", tenant, "queue_full")
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
            # Adopt the request thread's stamp card: engine admission
            # wait is measured from THIS enqueue, not from slot grant.
            h.obs = obs
            if obs is not None:
                obs.marks["engine_enqueue"] = h.submitted_at
                obs.tokens_in = len(prompt)
            q = self._waiting.get(tenant)
            if q is None:
                q = self._waiting[tenant] = deque()
                self._wfq_rr.append(tenant)
            q.append(h)
            self._waiting_n += 1
            _engine_metrics()["waiting"].set(float(self._waiting_n))
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
            "chaos_held_pages": len(self._chaos_held),
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

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the engine's loop ends (a follower's ends when rank
        0's engine stops); True when it has."""
        self._thread.join(timeout)
        return not self._thread.is_alive()

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
        admitted = bool(self._waiting_n and self._free)
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
                observatory.record_deadline_expired("", "engine_admission")
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
            grant_t = time.perf_counter()
            if h.submitted_at is not None:
                _engine_metrics()["admission_wait_s"].observe(
                    grant_t - h.submitted_at
                )
            if h.obs is not None:
                h.obs.marks["slot_grant"] = grant_t
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
        if admitted:
            _engine_metrics()["waiting"].set(float(self._waiting_n))

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
        m = _engine_metrics()
        if hashes:
            if shared:
                self._prefix_hits += 1
                m["prefix_hits"].inc(1)
            else:
                self._prefix_misses += 1
                m["prefix_misses"].inc(1)
        if skip > 0:
            self._prefill_tok_skipped += skip
            m["prefill_skipped"].inc(skip)
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
            self._plan(_PLAN_COW, pages[fw], fork)
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
        # Chaos hook: a deterministic stretch stands in for a huge
        # prompt, inside the timed window so the HOL watchdog sees it.
        injected = chaos.take_prefill_delay()
        if injected:
            time.sleep(injected)
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
                    observatory.record_deadline_expired("", "engine_decode")
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
            entry["offset"] = off + n
            # The last chunk picks the first token under the request's
            # sampling.
            pick = (None if entry["offset"] < len(h.prompt)
                    else (h.temperature, h.top_k, h.top_p))
            tok_dev = self._prefill_step(padded, n, slot, off, pick)
            if tok_dev is not None:
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
        _engine_metrics()["hol_s"].inc(blocked)
        from ray_tpu_torch.util import journal

        journal.emit("serve.hol", prefill_s=round(prefill_s, 4),
                     victims=n_active,
                     blocked_slot_seconds=round(blocked, 4))
        journal.trigger_postmortem(
            "hol_blocking", prefill_s=round(prefill_s, 4),
            victims=n_active)

    def _reset_device_state(self):
        """A fresh cache and zero next inputs (after a failed step)."""
        cache = self._fresh_cache()
        self._k, self._v = cache["k"], cache["v"]
        self._lengths = cache["lengths"]
        if self._paged:
            self._bt_dev = cache["block_tables"]
        self._tokens_dev = torch.zeros(self.num_slots, dtype=torch.int64,
                                       device=self.device)

    def _loop(self):
        """Pipelined decode loop: dispatch step k+1 (inputs from step k's
        on-device pick), start the non-blocking copy of its outputs, then
        wait for step k's copy — started a full iteration earlier — and
        hand out its tokens. Eviction lags one step (a finished slot
        rides one suppressed step before its slot frees)."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.inference_mode():
            try:
                self._run_loop()
            finally:
                self._plan(_PLAN_STOP)  # the followers' loops end too

    def _run_loop(self):
        inflight = None  # (snapshot [(slot, gen, handle)], pending fetch)
        while not self._stop_evt.is_set():
            try:
                t_iter = time.perf_counter()
                if self._paged:
                    self._apply_kv_chaos()
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
                        _engine_metrics()["param_uploads"].inc(1)
                    if self._paged and self._bt_dirty:
                        self._upload_block_table()
                    t0 = time.perf_counter()
                    next_dev = self._decode_step(self._sampled_active)
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
                                    observatory.record_deadline_expired(
                                        "", "engine_decode"
                                    )
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
                    m = _engine_metrics()
                    m["dispatch_ms"].observe(dispatch_s * 1e3)
                    m["fetch_ms"].observe(fetch_s * 1e3)
                    m["host_ms"].observe(host_s * 1e3)
                    m["occupancy"].set(len(snapshot) / self.num_slots)
                    m["waiting"].set(float(self._waiting_n))
                    if self._paged:
                        m["kv_pages"].set(float(self._pool.in_use))
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
                    self._plan(_PLAN_RESET)
                    self._reset_device_state()
                    if self._paged:
                        # Every page reference pointed into the dead cache.
                        self._pool.reset()
                        if self._prefix_cache is not None:
                            self._prefix_cache.reset()
                        self._slot_pages.clear()
                        self._chaos_held = []
                        self._bt_host[:] = 0
                        self._bt_dirty = False
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
    streaming (rides the replica generator protocol -> SSE at the
    proxy), and engine stats. `model_loader()` runs in the replica and
    returns (params, cfg), or (params, cfg, mesh) for tensor-parallel
    serving; the engine runs on the device that holds the params, so a
    loader that builds them on `cuda` makes the CUDA context in the
    replica process.

    A replica granted more than one card (ray_actor_options num_gpus=tp)
    serves with tp ranks: it starts a follower process on each further
    card (serve/tp.py), joins them in a process group, and then every
    rank runs the loader, which builds the mesh (parallel.build_mesh)
    and returns the rank's shards. A loader that wants a one-rank mesh
    on one card starts its own one-rank group."""

    def __init__(self, model_loader, num_slots: int = 4, max_len: int = 256,
                 eos_id: Optional[int] = None,
                 default_max_new_tokens: int = 32,
                 prefill_chunk: int = 64, kv_mode: Optional[str] = None,
                 page_size: Optional[int] = None,
                 kv_pages: Optional[int] = None):
        from ray_tpu_torch.serve import tp

        engine_kw = dict(num_slots=num_slots, max_len=max_len,
                         eos_id=eos_id,
                         default_max_new_tokens=default_max_new_tokens,
                         prefill_chunk=prefill_chunk, kv_mode=kv_mode,
                         page_size=page_size, kv_pages=kv_pages)
        self._followers = tp.start_followers(model_loader, engine_kw)
        try:
            # (params, cfg) or (params, cfg, mesh) — a mesh cannot cross
            # the actor boundary, so tensor-parallel serving builds it
            # (and shards params) inside the loader, in every rank.
            loaded = model_loader()
            mesh = None
            if len(loaded) == 3:
                params, cfg, mesh = loaded
            else:
                params, cfg = loaded
            tp_size = 1 if mesh is None else axis_size(mesh, "tp")
            ranks = (1 if self._followers is None
                     else len(self._followers.procs) + 1)
            if tp_size != ranks:
                raise ValueError(
                    f"the replica holds {ranks} card(s) but its loader's "
                    f"mesh has tp={tp_size}: ask for num_gpus={tp_size}")
            self.engine = ContinuousBatchingEngine(params, cfg, mesh=mesh,
                                                   **engine_kw)
        except BaseException:
            if self._followers is not None:
                self._followers.stop(timeout=5)
            raise

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
        if self._followers is not None:
            self._followers.stop()

    def __del__(self):
        # A dropped replica stops its engine, whose thread holds the
        # engine (not the replica) and with it the weights and the KV
        # cache. At interpreter teardown modules may be half unloaded,
        # and raising from __del__ only prints noise.
        try:
            self.shutdown()
        except Exception:  # noqa: BLE001
            pass


def llm_deployment(model_loader, *, num_slots: int = 4, max_len: int = 256,
                   eos_id: Optional[int] = None,
                   default_max_new_tokens: int = 32, num_replicas: int = 1,
                   max_ongoing_requests: int = 64,
                   ray_actor_options: Optional[dict] = None,
                   prefill_chunk: int = 64, kv_mode: Optional[str] = None,
                   page_size: Optional[int] = None,
                   kv_pages: Optional[int] = None):
    """A ready-to-run continuous-batching LLM application.

        app = llm_deployment(loader, num_slots=8,
                             ray_actor_options={"num_gpus": 1})
        handle = serve.run(app, name="llm")
        tokens = handle.remote([1, 2, 3]).result()   # blocking generate
        for t in handle.options(stream=True, method_name="stream") \
                .remote([1, 2, 3]): ...              # token stream

    `loader()` runs in the replica and returns (params, cfg), or (params,
    cfg, mesh) in every rank of a tensor-parallel replica
    (ray_actor_options num_gpus=tp; see LLMReplica).
    max_ongoing_requests defaults high: admission control lives in the
    engine (waiting queue + slots), not the router."""
    from ray_tpu_torch.serve.deployment import deployment

    dep = deployment(
        LLMReplica,
        name="LLMReplica",
        num_replicas=num_replicas,
        max_ongoing_requests=max_ongoing_requests,
        ray_actor_options=ray_actor_options or {},
    )
    return dep.bind(
        model_loader, num_slots=num_slots, max_len=max_len, eos_id=eos_id,
        default_max_new_tokens=default_max_new_tokens,
        prefill_chunk=prefill_chunk, kv_mode=kv_mode,
        page_size=page_size, kv_pages=kv_pages,
    )
