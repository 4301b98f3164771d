"""Autoregressive generation with a KV cache. Counterpart of
ray_tpu/models/generate.py.

Prefill runs the prompt once and fills a preallocated cache; each decode
step appends one token and attends against it. Where the JAX package
scans over layers inside one compiled program, this is an eager loop over
the layer views, and the cache is updated in place (JAX threaded it
through the scan as a new value). `cache["length"]` is a host integer.

`_cached_forward` is the forward over a KV cache of both generation and
the serving engine (serve/llm.py, serve/paged_kv.py): the training
model's layer (models/transformer.py) with an attention that writes the
caller's cache and attends against it (`_cached_attention`); each caller
brings its cache write, its mask and its pick of the next tokens.

Sampling draws from a `torch.Generator` by the Gumbel-max trick — the
same distribution as `jax.random.categorical`, never the same bits.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.transformer import (
    TransformerConfig,
    _embed_tokens,
    _layer_body,
    layer_params,
    project_logits,
)
from ray_tpu_torch.ops import rmsnorm
from ray_tpu_torch.ops.rope import rope_tables
from ray_tpu_torch.parallel._comm import sum_over
from ray_tpu_torch.parallel.mesh import axis_index, axis_size

NEG_INF = -1e30
MAX_TOP_K = 64  # per-slot top-k cap of the serving engine's pick


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int,
                  device=None) -> Dict:
    """Preallocated [layers, batch, max_len, kv_heads, head_dim] cache."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "length": 0,
    }


def _check_cached(cfg: TransformerConfig) -> None:
    """Refuse a config whose layers the KV caches cannot serve: generation
    and the serving engine cache per-head keys and values of dense
    layers."""
    if cfg.mla:
        raise ValueError(
            "generation and serving do not run multi-head latent attention "
            "(MLA): the KV cache holds no latent; the config has "
            f"kv_lora_rank={cfg.kv_lora_rank}")
    if cfg.num_experts:
        raise ValueError(
            "generation and serving run dense layers only, not mixture-of-"
            f"experts ones: the config has num_experts={cfg.num_experts}")


def _cached_attention(q, k, v, valid):
    """q [B, Lq, H, D] against k, v [B, Lk, KVH, D] where `valid`
    [B or 1, Lq, Lk] holds; GQA by a grouped einsum, in f32. A group of
    one takes the plain einsum, which dispatches fewer views (the same
    products)."""
    b, lq, h, d = q.shape
    kvh = k.shape[2]
    group = h // kvh
    scale = d ** -0.5
    kf, vf = k.float(), v.float()
    if group == 1:
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
        s = torch.where(valid[:, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)
    qg = q.reshape(b, lq, kvh, group, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, vf).reshape(b, lq, h, d)
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


def _cached_forward(params, tokens, cfg: TransformerConfig, positions,
                    rope_len: int, write_kv, valid, row: int, mesh=None):
    """The decoder over `tokens` [B, L] at `positions` against a KV cache,
    for generation and for the serving engine's four device calls: embed,
    rope tables of `rope_len` positions, models/transformer.py's layer
    over every layer, the final norm, and the logits of position `row`
    [B, vocab].

    Layer i's attention calls `write_kv(i, k, v) -> (k_att, v_att)`,
    which writes the layer's K/V rows into the caller's cache in place and
    returns what to attend against, then `_cached_attention` under the
    caller's mask `valid` [B or 1, L, Lk_att]. Under a mesh with a "tp"
    axis the layer computes this rank's heads and MLP columns, and the
    embedding and logits are whole on every rank."""
    _check_cached(cfg)
    x = _embed(params, tokens, cfg, mesh)
    cos, sin = rope_tables(cfg.head_dim, rope_len, cfg.rope_theta, x.device)
    for i, lp in enumerate(layer_params(params)):
        def attend(q, k, v):
            return _cached_attention(q, *write_kv(i, k, v), valid)

        x, _ = _layer_body(cfg, x, lp, cos, sin, positions, attend, mesh)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits(x[:, row], params, cfg, mesh)


def _forward_with_cache(params, tokens, cache, cfg: TransformerConfig):
    """Forward over `tokens` appended at cache['length']; returns (logits
    of the final position, cache). The cache is updated in place."""
    lq = tokens.shape[1]
    lmax = cache["k"].shape[2]
    start = cache["length"]
    if start + lq > lmax:
        raise ValueError(f"cache holds {lmax} positions, {start + lq} needed")
    dev = tokens.device
    positions = start + torch.arange(lq, device=dev)[None, :]
    k_pos = torch.arange(lmax, device=dev)[None, None, :]
    valid = (k_pos <= positions[:, :, None]) & (k_pos < start + lq)

    def write_kv(i, k, v):
        kc, vc = cache["k"][i], cache["v"][i]
        kc[:, start:start + lq] = k.to(kc.dtype)
        vc[:, start:start + lq] = v.to(vc.dtype)
        return kc, vc

    logits = _cached_forward(params, tokens, cfg, positions, lmax, write_kv,
                             valid, -1)
    cache["length"] = start + lq
    return logits, cache


@torch.inference_mode()
def prefill(params, tokens, cache, cfg: TransformerConfig):
    """Run the prompt through the model, filling the cache.
    Returns (last-position logits [B, vocab], cache)."""
    return _forward_with_cache(params, tokens, cache, cfg)


@torch.inference_mode()
def decode_step(params, token, cache, cfg: TransformerConfig):
    """One incremental decode step. token: [B]."""
    return _forward_with_cache(params, token[:, None], cache, cfg)


def _filter_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask all but the k highest logits to -inf."""
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, float("-inf"), logits)


def _filter_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest prefix of the probability-
    sorted vocab whose mass reaches p; mask the rest to -inf."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # Position i is kept while the mass BEFORE it is < p.
    keep = (cum - probs) < p
    threshold = torch.where(keep, sorted_logits, float("inf")).amin(
        dim=-1, keepdim=True)
    return torch.where(logits < threshold, float("-inf"), logits)


def _sample(logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One categorical draw per row (Gumbel-max), as int64."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device,
                   dtype=torch.float32)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits.float() - torch.log(-torch.log(u)), dim=-1)


def _pick_tokens(logits, temps, top_ks, top_ps, gen: torch.Generator):
    """Per-slot next-token selection on device: greedy where temp == 0 (or
    for every slot where temps is None), else temperature-scaled sampling
    with optional per-slot top-k (0 = off, capped at MAX_TOP_K) and top-p
    (1.0 = off) filtering, so mixed greedy/sampled requests share one
    decode batch."""
    if temps is None:
        return torch.argmax(logits, dim=-1)
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
def generate(
    params,
    prompt,  # [B, Lp] ints
    cfg: TransformerConfig,
    max_new_tokens: int = 32,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    seed: int = 0,
    eos_id: Optional[int] = None,
) -> torch.Tensor:
    """Greedy (temperature=0) or sampled generation with optional top-k /
    nucleus (top-p) filtering; returns [B, max_new_tokens] generated ids
    (int64, padded with eos after stopping), on the parameters' device."""
    device = params["embed"].device
    prompt = torch.as_tensor(prompt, dtype=torch.int64, device=device)
    b, lp = prompt.shape
    if max_new_tokens <= 0:
        return torch.zeros((b, 0), dtype=torch.int64, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def pick(logits):
        if temperature and temperature > 0.0:
            logits = logits / temperature
            if top_k is not None:
                logits = _filter_top_k(logits, top_k)
            if top_p is not None and top_p < 1.0:
                logits = _filter_top_p(logits, top_p)
            return _sample(logits, gen)
        return torch.argmax(logits, dim=-1)

    cache = init_kv_cache(cfg, b, lp + max_new_tokens, device=device)
    logits, cache = _forward_with_cache(params, prompt, cache, cfg)
    token = pick(logits)
    done = (token == eos_id) if eos_id is not None else None
    out = [token]
    for _ in range(max_new_tokens - 1):
        logits, cache = _forward_with_cache(params, token[:, None], cache, cfg)
        token = pick(logits)
        if eos_id is not None:
            token = torch.where(done, eos_id, token)
            done = done | (token == eos_id)
        out.append(token)
    return torch.stack(out, dim=1)
