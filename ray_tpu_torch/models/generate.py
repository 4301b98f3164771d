"""Autoregressive generation with a KV cache. Counterpart of
ray_tpu/models/generate.py.

Prefill runs the prompt once and fills a preallocated cache; each decode
step appends one token and attends against it. Where the JAX package
scans over layers inside one compiled program, this is an eager loop over
the layer views, and the cache is updated in place (JAX threaded it
through the scan as a new value). `cache["length"]` is a host integer.

Sampling draws from a `torch.Generator` by the Gumbel-max trick — the
same distribution as `jax.random.categorical`, never the same bits.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.transformer import (
    TransformerConfig,
    _act,
    _embed_tokens,
    layer_params,
    project_logits,
)
from ray_tpu_torch.ops import apply_rope, rmsnorm
from ray_tpu_torch.ops.rope import rope_tables

NEG_INF = -1e30


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


def _cached_attention(q, k_cache, v_cache, cache_len: int):
    """q: [B, Lq, H, D] against cache [B, Lmax, KVH, D] (first cache_len
    valid); GQA by a grouped einsum, causal by absolute position, in f32."""
    b, lq, h, d = q.shape
    kvh = k_cache.shape[2]
    group = h // kvh
    lmax = k_cache.shape[1]
    scale = d ** -0.5
    dev = q.device
    q_pos = cache_len - lq + torch.arange(lq, device=dev)[:, None]
    k_pos = torch.arange(lmax, device=dev)[None, :]
    valid = (k_pos <= q_pos) & (k_pos < cache_len)
    kf = k_cache.float()
    vf = v_cache.float()
    if group == 1:
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
        s = torch.where(valid[None, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)
    qg = q.reshape(b, lq, kvh, group, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
    s = torch.where(valid[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, vf).reshape(b, lq, h, d)
    return out.to(q.dtype)


def _forward_with_cache(params, tokens, cache, cfg: TransformerConfig):
    """Forward over `tokens` appended at cache['length']; returns (logits
    of the final position, cache). The cache is updated in place."""
    if cfg.num_experts:
        raise ValueError("generation supports dense configs (MoE TBD)")
    x = _embed_tokens(params, tokens, cfg)
    b, lq = tokens.shape
    lmax = cache["k"].shape[2]
    start = cache["length"]
    if start + lq > lmax:
        raise ValueError(f"cache holds {lmax} positions, {start + lq} needed")
    cos, sin = rope_tables(cfg.head_dim, lmax, cfg.rope_theta, x.device)
    positions = start + torch.arange(lq, device=x.device)[None, :]
    act = _act(cfg)
    for i, lp in enumerate(layer_params(params)):
        h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q = (h @ lp["wq"]).reshape(b, lq, cfg.n_heads, cfg.head_dim)
        k = (h @ lp["wk"]).reshape(b, lq, cfg.n_kv_heads, cfg.head_dim)
        v = (h @ lp["wv"]).reshape(b, lq, cfg.n_kv_heads, cfg.head_dim)
        if cfg.qk_norm:
            q = rmsnorm(q, lp["q_norm"], cfg.norm_eps)
            k = rmsnorm(k, lp["k_norm"], cfg.norm_eps)
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
        kc, vc = cache["k"][i], cache["v"][i]
        kc[:, start:start + lq] = k.to(kc.dtype)
        vc[:, start:start + lq] = v.to(vc.dtype)
        attn = _cached_attention(q, kc, vc, start + lq)
        x = x + (attn.reshape(b, lq, -1) @ lp["wo"]).to(x.dtype)
        h = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
        gate = act((h @ lp["w_gate"]).float())
        up = (h @ lp["w_up"]).float()
        x = x + ((gate * up).to(x.dtype) @ lp["w_down"])
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = project_logits(x[:, -1], params, cfg)
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
