"""The plain reference: the decoder of a configuration file in float32
(TF32 off), with no kernel, cache or batching of the program's.

It follows the configuration as the program is asked to run it: pre-norm
RMSNorm, rotate-half RoPE, causal GQA softmax attention, a SwiGLU MLP or,
with experts, top-k routing over a softmax of the router logits with a
per-expert capacity of int(capacity_factor * tokens * k / experts) filled
in token order pass by pass (the GShard formulation), the gates being the
softmax probabilities, with a Switch-style load-balancing loss. The
weights are the seed's draws (`portbench.weights`), made again here, never
taken from the program.

`Precision` rounds the inputs of every matrix product. In float32 it does
nothing; in float8 (e4m3, per-tensor scale) it is the control, the step
below the bfloat16 the configurations state; in bfloat16 it is a witness
of what rounding to the configurations' own type does. It can also record
each MoE layer's top-k choices, or follow choices recorded by another
run: a diagnosis of how much of a gap routing flips make, never part of
a cell's comparison.

Imports nothing of the program and nothing of JAX.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.weights import (diff_norm, get_leaf, leaf_names, make_leaf,
                               make_weights, sample_index)

FP8_MAX = 448.0


def strict_float32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Precision:
    """Rounds a matrix product's inputs: "float32" leaves them, "bfloat16"
    rounds them to bfloat16, "float8" to e4m3 with a per-tensor scale (each
    straight through for the gradient).

    `routes`, where given, maps (layer, pass) to the experts a MoE layer
    chose for each token: filled in by the run, or, with `follow`, the
    choices the run takes instead of its own."""

    def __init__(self, kind: str = "float32", routes: Optional[Dict] = None,
                 follow: bool = False):
        if kind not in ("float32", "bfloat16", "float8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind
        self.routes = routes
        self.follow = follow

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.kind == "float32":
            return t
        if self.kind == "bfloat16":
            q = t.detach().to(torch.bfloat16).float()
        else:
            scale = FP8_MAX / t.detach().abs().amax().clamp_min(1e-30)
            q = (t.detach() * scale).to(torch.float8_e4m3fn).float() / scale
        return t + (q - t.detach())

    def route(self, key, choice: torch.Tensor) -> torch.Tensor:
        if self.routes is None:
            return choice
        if self.follow:
            return self.routes[key]
        self.routes[key] = choice
        return choice

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self(a) @ self(b)


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, L, H, hd], positions [L]: rotate-half pairs (i, i + hd/2)."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=x.device) / hd)
    ang = positions.to(torch.float64)[:, None] * inv[None, :]
    cos = ang.cos().float()[None, :, None, :]
    sin = ang.sin().float()[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, prec: Precision) -> torch.Tensor:
    """Causal softmax attention; q [B, L, H, hd], k, v [B, L, KVH, hd]."""
    group = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    L = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", prec(q), prec(k)) * q.shape[-1] ** -0.5
    mask = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", prec(p), prec(v))


def moe(h: torch.Tensor, lp: Dict, dims: Dict, prec: Precision,
        index: int = 0):
    """(out [T, D], aux) of the routed experts over tokens h [T, D] in
    layer `index`."""
    T = h.shape[0]
    E, k = dims["experts"], dims["top_k"]
    cap = max(1, int(dims["capacity_factor"] * T * k / E))
    probs = torch.softmax(prec.mm(h, lp["router"]), dim=-1)
    top1 = probs.argmax(-1)
    aux = E * torch.sum(probs.mean(0) * F.one_hot(top1, E).float().mean(0))
    out = torch.zeros_like(h)
    remaining = probs
    fill = torch.zeros(E, dtype=torch.long, device=h.device)
    for j in range(k):
        choice = prec.route((index, j), remaining.argmax(-1))
        gate = remaining.gather(-1, choice[:, None])[:, 0]
        onehot = F.one_hot(choice, E)
        rank = (onehot.cumsum(0) - 1).gather(-1, choice[:, None])[:, 0]
        keep = rank + fill[choice] < cap
        for e in range(E):
            idx = torch.nonzero((choice == e) & keep)[:, 0]
            if idx.numel() == 0:
                continue
            xe = h[idx]
            y = prec.mm(F.silu(prec.mm(xe, lp["w_gate"][e]))
                        * prec.mm(xe, lp["w_up"][e]), lp["w_down"][e])
            out = out.index_add(0, idx, gate[idx, None] * y)
        fill = fill + (onehot * keep[:, None]).sum(0)
        remaining = remaining * (1.0 - onehot.float())
    return out, aux


def layer(x: torch.Tensor, lp: Dict, dims: Dict, prec: Precision,
          index: int = 0):
    """Decoder layer `index` on x [B, L, D] at positions 0..L-1; (x, aux)."""
    B, L, D = x.shape
    H, KVH, hd = dims["heads"], dims["kv_heads"], dims["head_dim"]
    pos = torch.arange(L, device=x.device)
    h = rms(x, lp["attn_norm"], dims["eps"])
    q = rope(prec.mm(h, lp["wq"]).view(B, L, H, hd), pos, dims["rope_theta"])
    k = rope(prec.mm(h, lp["wk"]).view(B, L, KVH, hd), pos, dims["rope_theta"])
    v = prec.mm(h, lp["wv"]).view(B, L, KVH, hd)
    a = attention(q, k, v, prec).reshape(B, L, H * hd)
    x = x + prec.mm(a, lp["wo"])
    h = rms(x, lp["mlp_norm"], dims["eps"])
    if dims["experts"]:
        out, aux = moe(h.reshape(B * L, D), lp, dims, prec, index)
        return x + out.view(B, L, D), aux
    mlp = prec.mm(F.silu(prec.mm(h, lp["w_gate"])) * prec.mm(h, lp["w_up"]),
                  lp["w_down"])
    return x + mlp, torch.zeros((), device=x.device)


def _layer_f32(params: Dict, i: int, grad: bool = False) -> Dict:
    return {k: v[i].float().requires_grad_(grad)
            for k, v in params["layers"].items()}


# -- training ------------------------------------------------------------------

def _adamw_(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
            v: torch.Tensor, t: int, opt: Dict, chunk: int = 1 << 26) -> None:
    """AdamW on stored tensors p, m, v (the configuration's dtype), in
    float32 arithmetic, chunk by chunk over the flattened leaf."""
    lr, (b1, b2), eps, wd = opt["lr"], opt["betas"], opt["eps"], \
        opt["weight_decay"]
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    pf, gf, mf, vf = (x.view(-1) for x in (p, g, m, v))
    for s in range(0, pf.numel(), chunk):
        sl = slice(s, s + chunk)
        pp, gg = pf[sl].float(), gf[sl].float()
        mm, vv = mf[sl].float(), vf[sl].float()
        pp.mul_(1 - lr * wd)
        mm.mul_(b1).add_(gg, alpha=1 - b1)
        vv.mul_(b2).addcmul_(gg, gg, value=1 - b2)
        pp.addcdiv_(mm, (vv.sqrt() / math.sqrt(bc2)).add_(eps),
                    value=-lr / bc1)
        pf[sl].copy_(pp)
        mf[sl].copy_(mm)
        vf[sl].copy_(vv)


def train_readings(dims: Dict, seed: int, batches: Sequence[torch.Tensor],
                   opt: Dict, device, prec: Optional[Precision] = None,
                   rows: Optional[int] = None) -> Dict:
    """The reference's first len(batches) AdamW steps from the seed's
    weights: each step's loss, each leaf's first-gradient norm, and each
    leaf's change over all the steps, the first gradient on each leaf's
    sampled elements (weights.sample_index), and the first gradient's
    embedding rows of the ids in the first batch (embed_rows, in the order
    of first_ids: each row is the input gradient of the tokens with that
    id). Layer by layer: the forward keeps each layer's input, the backward
    recomputes one layer at a time and updates its weights as soon as their
    gradient is known. `rows` keeps the first rows of each batch only (a
    fault that drops the rest)."""
    prec = prec or Precision()
    params = make_weights(dims, seed, device)
    m = {n: torch.zeros_like(get_leaf(params, n)) for n in leaf_names(dims)}
    v = {n: torch.zeros_like(get_leaf(params, n)) for n in leaf_names(dims)}
    L, D, coef = dims["layers"], dims["d"], dims["aux_coef"]
    losses, grad_sq = [], {n: 0.0 for n in leaf_names(dims)}
    samples = {n: [None] * (L if n.startswith("layers.") else 1)
               for n in leaf_names(dims)}
    ids = first_ids(batches[0])
    embed_rows = None
    for t, tokens in enumerate(batches, start=1):
        if rows is not None:
            tokens = tokens[:rows]
        inp, lab = tokens[:, :-1], tokens[:, 1:]
        xs = []
        aux_total = 0.0
        with torch.no_grad():
            x = params["embed"][inp].float()
            for i in range(L):
                xs.append(x)
                x, aux = layer(x, _layer_f32(params, i), dims, prec, i)
                aux_total += float(aux)

        def update(name, g, index=None):
            if t == 1:
                grad_sq[name] += float(g.double().square().sum())
                samples[name][index or 0] = g.reshape(-1)[
                    sample_index(dims, seed, name, device)].float().cpu()
            p = get_leaf(params, name)
            sel = (lambda a: a) if index is None else (lambda a: a[index])
            _adamw_(sel(p), g, sel(m[name]), sel(v[name]), t, opt)

        x = x.requires_grad_(True)
        fn = params["final_norm"].float().requires_grad_(True)
        head = params["lm_head"].float().requires_grad_(True)
        logits = prec.mm(rms(x, fn, dims["eps"]), head)
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             lab.reshape(-1))
        ce.backward()
        losses.append(float(ce.detach()) + coef * aux_total)
        dx = x.grad
        del logits
        update("final_norm", fn.grad)
        update("lm_head", head.grad)
        for i in reversed(range(L)):
            xi = xs[i].requires_grad_(True)
            lp = _layer_f32(params, i, grad=True)
            out, aux = layer(xi, lp, dims, prec, i)
            if aux.requires_grad:
                torch.autograd.backward(
                    [out, aux], [dx, torch.tensor(coef, device=out.device)])
            else:
                out.backward(dx)
            dx = xi.grad
            xs[i] = None
            for k, w in lp.items():
                update("layers." + k, w.grad, index=i)
            del lp, out, aux, xi
        g_embed = torch.zeros(params["embed"].shape, dtype=torch.float32,
                              device=dx.device)
        g_embed.index_add_(0, inp.reshape(-1), dx.reshape(-1, D))
        if t == 1:
            embed_rows = g_embed[ids].cpu()
        update("embed", g_embed)
        del g_embed, dx
    change = {}
    for n in leaf_names(dims):
        change[n] = diff_norm(get_leaf(params, n),
                              make_leaf(dims, seed, n, device))
    return {"losses": losses,
            "grad_norms": {n: math.sqrt(s) for n, s in grad_sq.items()},
            "grad_samples": samples, "change_norms": change,
            "embed_rows": embed_rows}


def first_ids(tokens: torch.Tensor) -> torch.Tensor:
    """The distinct input ids of a batch [B, L + 1], ascending."""
    return tokens[:, :-1].reshape(-1).unique()


# -- serving ---------------------------------------------------------------------

def served_gaps(dims: Dict, seed: int, seqs: Sequence[Tuple[List[int], List[int]]],
                device, control: bool = False) -> Dict:
    """Over each (prompt, served tokens): the widest gap by which a served
    token's reference logit lies below the reference's best at its
    position; with control, also the widest such gap of the token the
    float8 control puts first. Layer by layer over all sequences."""
    params = make_weights(dims, seed, device)
    precs = [Precision("float32")] + ([Precision("float8")] if control else [])
    xs = [[params["embed"][torch.tensor(p + s[:-1], device=device)]
           .float()[None] for p, s in seqs] for _ in precs]
    with torch.no_grad():
        for i in range(dims["layers"]):
            lp = _layer_f32(params, i)
            for j, prec in enumerate(precs):
                xs[j] = [layer(x, lp, dims, prec)[0] for x in xs[j]]
            del lp
        head = params["lm_head"].float()
        fn = params["final_norm"].float()
        widest = {"served": 0.0, "control": 0.0}
        tokens = 0
        for n, (p, s) in enumerate(seqs):
            at = slice(len(p) - 1, len(p) - 1 + len(s))
            ref = rms(xs[0][n][0, at], fn, dims["eps"]) @ head
            best = ref.amax(-1)
            served = torch.tensor(s, device=device)
            gap = best - ref.gather(-1, served[:, None])[:, 0]
            widest["served"] = max(widest["served"], float(gap.max()))
            tokens += len(s)
            if control:
                ctl = precs[1].mm(rms(xs[1][n][0, at], fn, dims["eps"]), head)
                pick = ctl.argmax(-1)
                cgap = best - ref.gather(-1, pick[:, None])[:, 0]
                widest["control"] = max(widest["control"], float(cgap.max()))
    widest["tokens"] = tokens
    return widest
