"""The plain reference of a latent-attention (MLA) model with
DeepSeek-V3-style experts (Mistral-Small-4's text decoder): float32, TF32
off, no kernel, cache or batching of the program's.

It follows the published equations (DeepSeek-V3, arXiv:2412.19437, as
transformers' DeepSeek-V3 model computes them; YaRN, arXiv:2309.00071):

* attention: q = W_qb RMSNorm(W_qa h); [c_kv, k_pe] = W_kva h;
  [k_nope, v] = W_kvb RMSNorm(c_kv), per head; rope with YaRN's
  frequencies on the qk_rope dimensions of q and on the one k_pe head,
  the checkpoint's interleaved pairs rotated (de-interleave, then
  rotate-half), k_pe broadcast to every head; q = [q_nope, q_pe],
  k = [k_nope, k_pe]; queries scaled by llama-4's 1 + beta * ln(1 +
  floor(pos / original_max)); causal softmax at (qk dim)^-0.5 times
  YaRN's mscale_all_dim temperature squared; computed a block of
  queries at a time (each block under activation checkpointing), so the
  [batch, heads, seq, seq] scores never exist;
* experts: sigmoid scores over all experts, the top-k of the scores
  plus the correction bias chosen, the chosen scores over their sum
  times routed_scaling_factor the gates; the experts this card holds
  compute their SwiGLU on their tokens; the shared expert's SwiGLU on
  every token is added once.

Departures from the published model, as the program is asked to run it
(the configuration file lists them): each expert holds at most
int(capacity_factor * tokens * k / experts) tokens, filled pass by pass
in token order, and drops the rest (DeepSeek-V3 drops none); the
correction bias stays zero, with no update rule; no balance loss; text
only; the experts outside the card's share add nothing.

The weights are the seed's draws (`portbench.mla`), made again here.
`Precision` (from `portbench.reference.model`) rounds the inputs of
every matrix product: float32 leaves them, float8 is the control.

Imports nothing of the program and nothing of JAX.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench import mla
from portbench.reference.model import (Precision, _adamw_, first_ids, rms,
                                       strict_float32)
from portbench.weights import diff_norm

QUERY_BLOCK = 512


# -- rope ------------------------------------------------------------------

def _mscale(scale: float, m: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def yarn_cos_sin(dm: Dict, length: int, device):
    """(cos, sin) [length, rope] in float32, each half of the rope
    dimensions repeated: YaRN's frequencies (extrapolated where a
    dimension turns more than beta_fast times over the original context,
    interpolated by the factor where fewer than beta_slow, a linear ramp
    between), times its attention factor."""
    dim, base = dm["rope"], dm["rope_theta"]
    factor, orig = dm["rope_factor"], dm["rope_original_max"]

    def corr(rotations):
        return dim * math.log(orig / (rotations * 2 * math.pi)) / (
            2 * math.log(base))

    low = max(math.floor(corr(dm["beta_fast"])), 0)
    high = min(math.ceil(corr(dm["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    i = torch.arange(dim // 2, dtype=torch.float64, device=device)
    extrapolated = 1.0 / base ** (2 * i / dim)
    ramp = ((i - low) / (high - low)).clamp(0, 1)
    inv = extrapolated / factor * ramp + extrapolated * (1 - ramp)
    ang = torch.arange(length, dtype=torch.float64, device=device)[:, None] \
        * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    att = _mscale(factor, dm["mscale"]) / _mscale(factor,
                                                  dm["mscale_all_dim"])
    return (ang.cos() * att).float(), (ang.sin() * att).float()


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
         interleaved: bool) -> torch.Tensor:
    """Rotate x [B, L, H, d] by cos, sin [L, d]: pairs (i, i + d/2), or,
    interleaved, pairs (2i, 2i + 1), whose even features are put first
    before the rotation (transformers' apply_rotary_pos_emb_interleave)."""
    B, L, H, d = x.shape
    if interleaved:
        x = x.reshape(B, L, H, d // 2, 2).transpose(-1, -2).reshape(
            B, L, H, d)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    rotated = torch.cat([-x2, x1], dim=-1)
    return x * cos[None, :, None, :] + rotated * sin[None, :, None, :]


# -- the layer -------------------------------------------------------------------

def _attend(q, k, v, q0: int, scale: float, prec: Precision):
    """Queries q0.. of q [B, lq, H, d] over keys 0..q0+lq-1."""
    s = torch.einsum("bqhd,bkhd->bhqk", prec(q), prec(k)) * scale
    rows = q0 + torch.arange(q.shape[1], device=q.device)
    keep = rows[:, None] >= torch.arange(k.shape[1], device=q.device)[None]
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", prec(p), prec(v))


def attention(q, k, v, scale: float, prec: Precision,
              block: int = QUERY_BLOCK) -> torch.Tensor:
    """Causal softmax attention, a block of queries at a time."""
    outs = []
    for q0 in range(0, q.shape[1], block):
        q1 = min(q0 + block, q.shape[1])
        args = (q[:, q0:q1], k[:, :q1], v[:, :q1], q0, scale, prec)
        outs.append(checkpoint(_attend, *args, use_reentrant=False)
                    if torch.is_grad_enabled() else _attend(*args))
    return torch.cat(outs, dim=1)


def softmax_scale(dm: Dict) -> float:
    return (dm["nope"] + dm["rope"]) ** -0.5 * _mscale(
        dm["rope_factor"], dm["mscale_all_dim"]) ** 2


def _swiglu(h, w_gate, w_up, w_down, prec: Precision):
    return prec.mm(F.silu(prec.mm(h, w_gate)) * prec.mm(h, w_up), w_down)


def moe(h: torch.Tensor, lp: Dict, dm: Dict, prec: Precision,
        index: int = 0) -> torch.Tensor:
    """The held experts' part of the routed sum over tokens h [T, D]."""
    T = h.shape[0]
    E, k = dm["experts"], dm["top_k"]
    lo, hi = dm["held"]
    cap = max(1, int(dm["capacity_factor"] * T * k / E))
    scores = torch.sigmoid(prec.mm(h, lp["router"]))
    pick = scores.detach() + lp["router_bias"].detach()
    choice = prec.route((index, 0), torch.topk(pick, k, dim=-1).indices)
    gates = scores.gather(-1, choice)
    if dm["norm_topk"]:
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
    gates = gates * dm["routed_scale"]
    fill = torch.zeros(E, dtype=torch.long, device=h.device)
    keep = torch.zeros_like(choice, dtype=torch.bool)
    for j in range(k):
        c = choice[:, j]
        onehot = F.one_hot(c, E)
        rank = (onehot.cumsum(0) - 1).gather(-1, c[:, None])[:, 0]
        keep[:, j] = rank + fill[c] < cap
        fill = fill + (onehot * keep[:, j, None]).sum(0)
    out = torch.zeros_like(h)
    for e in range(lo, hi):
        tok, j = torch.nonzero((choice == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = _swiglu(h[tok], lp["w_gate"][e - lo], lp["w_up"][e - lo],
                    lp["w_down"][e - lo], prec)
        out = out.index_add(0, tok, gates[tok, j, None] * y)
    return out


def layer(x: torch.Tensor, lp: Dict, dm: Dict, prec: Precision,
          index: int = 0) -> torch.Tensor:
    """Decoder layer `index` on x [B, L, D] at positions 0..L-1."""
    B, L, D = x.shape
    H, dn, dr, dv, eps = dm["heads"], dm["nope"], dm["rope"], dm["v"], \
        dm["eps"]
    h = rms(x, lp["attn_norm"], eps)
    q = prec.mm(rms(prec.mm(h, lp["wq_a"]), lp["q_a_norm"], eps),
                lp["wq_b"]).view(B, L, H, dn + dr)
    kv = prec.mm(h, lp["wkv_a"])
    c_kv, k_pe = kv[..., :dm["kv_rank"]], kv[..., dm["kv_rank"]:]
    kvb = prec.mm(rms(c_kv, lp["kv_a_norm"], eps), lp["wkv_b"]).view(
        B, L, H, dn + dv)
    cos, sin = yarn_cos_sin(dm, L, x.device)
    q_pe = rope(q[..., dn:], cos, sin, dm["interleave"])
    k_pe = rope(k_pe.reshape(B, L, 1, dr), cos, sin,
                dm["interleave"]).expand(B, L, H, dr)
    q = torch.cat([q[..., :dn], q_pe], dim=-1)
    k = torch.cat([kvb[..., :dn], k_pe], dim=-1)
    pos = torch.arange(L, device=x.device, dtype=torch.float64)
    q = q * (1 + dm["llama4_beta"] * torch.log1p(torch.floor(
        pos / dm["rope_original_max"]))).float()[None, :, None, None]
    a = attention(q, k, kvb[..., dn:], softmax_scale(dm), prec)
    x = x + prec.mm(a.reshape(B, L, H * dv), lp["wo"])
    h = rms(x, lp["mlp_norm"], eps)
    out = moe(h.reshape(B * L, D), lp, dm, prec, index).view(B, L, D)
    if dm["shared"]:
        out = out + _swiglu(h, lp["w_shared_gate"], lp["w_shared_up"],
                            lp["w_shared_down"], prec)
    return x + out


def _layer_f32(params: Dict, i: int, grad: bool = False) -> Dict:
    return {k: v[i].float().requires_grad_(grad and k != "router_bias")
            for k, v in params["layers"].items()}


# -- training ------------------------------------------------------------------

def train_readings(dm: Dict, seed: int, batches: Sequence[torch.Tensor],
                   opt: Dict, device, prec: Optional[Precision] = None,
                   rows: Optional[int] = None) -> Dict:
    """The reference's first len(batches) AdamW steps from the seed's
    weights, as `portbench.reference.model.train_readings` reads them:
    each step's loss, each trained leaf's first-gradient norm, its change
    over all the steps and its first gradient on the sampled elements,
    and the first gradient's embedding rows of the first batch's ids.
    Layer by layer: the forward keeps each layer's input, the backward
    recomputes one layer at a time and updates its weights as soon as
    their gradient is known. `rows` keeps the first rows of each batch
    only (a fault that drops the rest)."""
    prec = prec or Precision()
    names = mla.trained_leaves(dm)
    params = mla.make_weights(dm, seed, device)

    def leaf(tree, name):
        return tree["layers"][name[7:]] if name.startswith("layers.") \
            else tree[name]

    m = {n: torch.zeros_like(leaf(params, n)) for n in names}
    v = {n: torch.zeros_like(leaf(params, n)) for n in names}
    L, D = dm["layers"], dm["d"]
    losses, grad_sq = [], {n: 0.0 for n in names}
    samples = {n: [None] * (L if n.startswith("layers.") else 1)
               for n in names}
    ids = first_ids(batches[0])
    embed_rows = None
    for t, tokens in enumerate(batches, start=1):
        if rows is not None:
            tokens = tokens[:rows]
        inp, lab = tokens[:, :-1], tokens[:, 1:]
        xs = []
        with torch.no_grad():
            x = params["embed"][inp].float()
            for i in range(L):
                xs.append(x)
                x = layer(x, _layer_f32(params, i), dm, prec, i)

        def update(name, g, index=None):
            if t == 1:
                grad_sq[name] += float(g.double().square().sum())
                samples[name][index or 0] = g.reshape(-1)[
                    mla.sample_index(dm, seed, name, device)].float().cpu()
            p = leaf(params, name)
            sel = (lambda a: a) if index is None else (lambda a: a[index])
            _adamw_(sel(p), g, sel(m[name]), sel(v[name]), t, opt)

        x = x.requires_grad_(True)
        fn = params["final_norm"].float().requires_grad_(True)
        head = params["lm_head"].float().requires_grad_(True)
        logits = prec.mm(rms(x, fn, dm["eps"]), head)
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             lab.reshape(-1))
        ce.backward()
        losses.append(float(ce.detach()))
        dx = x.grad
        del logits, ce, x
        update("final_norm", fn.grad)
        update("lm_head", head.grad)
        del fn, head
        for i in reversed(range(L)):
            xi = xs[i].requires_grad_(True)
            lp = _layer_f32(params, i, grad=True)
            layer(xi, lp, dm, prec, i).backward(dx)
            dx = xi.grad
            xs[i] = None
            for k, w in lp.items():
                if w.grad is not None:
                    update("layers." + k, w.grad, index=i)
            del lp, xi
        g_embed = torch.zeros(params["embed"].shape, dtype=torch.float32,
                              device=dx.device)
        g_embed.index_add_(0, inp.reshape(-1), dx.reshape(-1, D))
        if t == 1:
            embed_rows = g_embed[ids].cpu()
        update("embed", g_embed)
        del g_embed, dx
    change = {n: diff_norm(leaf(params, n), mla.make_leaf(dm, seed, n,
                                                          device))
              for n in names}
    return {"losses": losses,
            "grad_norms": {n: math.sqrt(s) for n, s in grad_sq.items()},
            "grad_samples": samples, "change_norms": change,
            "embed_rows": embed_rows}
