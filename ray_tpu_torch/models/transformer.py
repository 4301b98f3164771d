"""Llama-family decoder-only transformer: configuration and parameters.

Counterpart of ray_tpu/models/transformer.py. Parameters are a plain
dictionary of tensors with the JAX package's keys and its layer-stacked
`[L, ...]` layout, so a JAX parameter tree converts leaf by leaf
(models/convert.py) and the serving code indexes layer i as `[i]`.

`forward` and `loss_fn` (the training path, with the flash-attention
kernels) come with the training slice; serving needs only what is here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    d_ff: int = 11008
    max_seq: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    # MoE (0 experts = dense)
    num_experts: int = 0
    experts_per_token: int = 2
    # Training-path knobs, kept so every named config maps field for
    # field; the serving slice does not read them.
    attn_impl: str = "flash"
    attn_block_q: int = 256
    attn_block_k: int = 512
    remat: bool = True
    remat_policy: str = "full"
    pp_microbatches: int = 0
    ce_chunk: int = 0
    # Family knobs beyond Llama (Gemma, arXiv:2403.08295): MLP activation
    # ("silu" = SwiGLU, "gelu" = GeGLU), tanh softcap on final logits
    # (0 = off), input/output embedding tying, sqrt(d_model) embedding
    # scaling.
    activation: str = "silu"
    final_logit_softcap: float = 0.0
    tie_embeddings: bool = False
    scale_embeddings: bool = False
    # Qwen3-style QK-norm (arXiv:2505.09388) and an explicit head width.
    qk_norm: bool = False
    custom_head_dim: int = 0

    @property
    def head_dim(self) -> int:
        return self.custom_head_dim or self.d_model // self.n_heads


def _dense_init(gen: torch.Generator, shape, scale: float, dtype,
                device) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * scale).to(dtype)


def param_shapes(cfg: TransformerConfig) -> Dict:
    """The parameter tree's shapes: key -> (shape, init scale), where a
    scale of None means ones (the norm weights). Layer leaves carry the
    stacked leading [L] axis."""
    d, h, kvh, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.head_dim, cfg.d_ff)
    L = cfg.n_layers
    scale = d ** -0.5
    out_scale = scale * (2 * L) ** -0.5
    layer = {
        "attn_norm": ((L, d), None),
        "wq": ((L, d, h * hd), scale),
        "wk": ((L, d, kvh * hd), scale),
        "wv": ((L, d, kvh * hd), scale),
        "wo": ((L, h * hd, d), out_scale),
        "mlp_norm": ((L, d), None),
    }
    if cfg.qk_norm:
        layer["q_norm"] = ((L, hd), None)
        layer["k_norm"] = ((L, hd), None)
    if cfg.num_experts == 0:
        layer["w_gate"] = ((L, d, ff), scale)
        layer["w_up"] = ((L, d, ff), scale)
        layer["w_down"] = ((L, ff, d), out_scale)
    else:
        E = cfg.num_experts
        layer["router"] = ((L, d, E), scale)
        layer["w_gate"] = ((L, E, d, ff), scale)
        layer["w_up"] = ((L, E, d, ff), scale)
        layer["w_down"] = ((L, E, ff, d), out_scale)
    shapes = {
        "embed": ((cfg.vocab_size, d), 1.0),
        "layers": layer,
        "final_norm": ((d,), None),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = ((d, cfg.vocab_size), scale)
    return shapes


def init_params(cfg: TransformerConfig, seed: int = 0, device=None) -> Dict:
    """Random parameters from `seed` (layers stacked on axis 0), drawn by a
    torch.Generator on `device` — on the card when no device is given.
    They do not reproduce jax.random's draws: parity tests convert a JAX
    tree with convert.params_from_jax instead."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def leaf(shape, scale, stacked):
        if scale is None:
            return torch.ones(shape, dtype=cfg.dtype, device=device)
        if not stacked:
            return _dense_init(gen, shape, scale, cfg.dtype, device)
        # One layer at a time: the f32 draw never exists for the stack.
        out = torch.empty(shape, dtype=cfg.dtype, device=device)
        for i in range(shape[0]):
            out[i] = _dense_init(gen, shape[1:], scale, cfg.dtype, device)
        return out

    shapes = param_shapes(cfg)
    params = {k: leaf(*v, stacked=False)
              for k, v in shapes.items() if k != "layers"}
    params["layers"] = {k: leaf(*v, stacked=True)
                        for k, v in shapes["layers"].items()}
    return params


def layer_params(params: Dict):
    """Per-layer views of the stacked layer tensors: a list of L dicts."""
    layers = params["layers"]
    keys = list(layers)
    return [dict(zip(keys, vals))
            for vals in zip(*(layers[k].unbind(0) for k in keys))]


def _act(cfg: TransformerConfig):
    if cfg.activation == "silu":
        return F.silu
    if cfg.activation == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {cfg.activation!r}")


def _embed_tokens(params, tokens: torch.Tensor, cfg: TransformerConfig):
    x = params["embed"][tokens].to(cfg.dtype)
    if cfg.scale_embeddings:
        # The scale is rounded to the working dtype first, as jnp.asarray
        # does in the reference.
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype,
                             device=x.device)
    return x


def lm_head_weight(params, cfg: TransformerConfig) -> torch.Tensor:
    """[D, V] output projection (the embedding transposed when tied)."""
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def project_logits(x: torch.Tensor, params, cfg: TransformerConfig):
    logits = x @ lm_head_weight(params, cfg)
    if cfg.final_logit_softcap:
        cap = cfg.final_logit_softcap
        logits = cap * torch.tanh(logits.float() / cap)
    return logits
