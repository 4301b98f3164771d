"""Llama-family decoder-only transformer: configuration, parameters and the
training forward and loss.

Counterpart of ray_tpu/models/transformer.py. Parameters are a plain
dictionary of tensors with the JAX package's keys and its layer-stacked
`[L, ...]` layout, so a JAX parameter tree converts leaf by leaf
(models/convert.py) and the serving code indexes layer i as `[i]`.

`forward` and `loss_fn` are the training path: the reference's
`lax.scan` over layers becomes a Python loop over per-layer views of the
stacked leaves (so gradients land on the stacked tensors), its
`jax.checkpoint` policies become `torch.utils.checkpoint` with the same
three policies, and every RMSNorm and attention runs the hand-written
CUDA kernels on a CUDA tensor. MoE layers run parallel/moe.py.

Under a mesh (parallel.build_mesh) each rank passes its local shards
(parallel.shard_params with param_logical_axes) and its block of the
tokens, and the layers issue what GSPMD inserts in the reference: the
batch splits over dp/fsdp and the sequence over sp (ring or Ulysses
attention by cfg.attn_impl); heads and MLP split over tp, with an
all-reduce after wo and w_down; experts split over ep; every other
sharded parameter dimension is gathered for use (fsdp's, whose backward
reduce-scatters, and the vocabulary's tp blocks); the layer stack splits
over pp in forward_pipelined. Gradients come out as the unsharded
program's, each on the rank's shard.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.ops import apply_rope, flash_attention, rmsnorm
from ray_tpu_torch.ops.cross_entropy import (chunked_lm_head_ce,
                                             softmax_cross_entropy)
from ray_tpu_torch.ops.rope import (deinterleave, rope_tables, yarn_mscale,
                                    yarn_tables)
from ray_tpu_torch.parallel import _comm
from ray_tpu_torch.parallel.mesh import (axis_index, axis_size,
                                         local_shard, logical_to_physical,
                                         spec_axes)
from ray_tpu_torch.parallel.moe import moe_layer
from ray_tpu_torch.parallel.pipeline import pipeline_stages
from ray_tpu_torch.parallel.ring_attention import ring_attention
from ray_tpu_torch.parallel.ulysses import ulysses_attention
from ray_tpu_torch.util.profiling import device_span


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
    # Training-path knobs; the serving slice does not read them. Attention
    # under an sp mesh: "flash" | "ring" | "ulysses". The Pallas block
    # sizes are kept so every named config maps field for field.
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
    # Multi-head latent attention (DeepSeek-V2/V3, arXiv:2405.04434), on
    # where kv_lora_rank > 0: keys and values from a kv_lora_rank-wide
    # latent, queries from a q_lora_rank-wide one;
    # q/k heads are qk_nope_dim + qk_rope_dim wide (rope on the last
    # qk_rope_dim, k's rope part one head broadcast to all), v heads
    # v_head_dim wide.
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # RoPE scaling: "default", or "yarn" (arXiv:2309.00071) with its
    # factor, original context, ramp (beta_fast, beta_slow) and
    # temperatures (mscale, mscale_all_dim; the softmax scale takes
    # mscale_all_dim's squared). rope_interleave: the checkpoint rotates
    # interleaved pairs. llama4_scaling_beta: queries at position p are
    # scaled by 1 + beta * ln(1 + floor(p / rope_original_max)).
    rope_type: str = "default"
    rope_factor: float = 1.0
    rope_original_max: int = 0
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0
    rope_interleave: bool = False
    llama4_scaling_beta: float = 0.0
    # MoE beyond Mixtral's: shared experts beside the routed ones, expert
    # width (0: d_ff), the router ("softmax" or DeepSeek-V3's
    # "sigmoid_bias"), renormalised and scaled gates, and the block of
    # expert ids this card holds (None: all of them).
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    router: str = "softmax"
    norm_topk_prob: bool = False
    routed_scaling_factor: float = 1.0
    experts_held: Optional[range] = None

    @property
    def head_dim(self) -> int:
        return self.custom_head_dim or self.d_model // self.n_heads

    @property
    def mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def n_experts_held(self) -> int:
        return (self.num_experts if self.experts_held is None
                else len(self.experts_held))


def _dense_init(gen: torch.Generator, shape, scale: float, dtype,
                device) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * scale).to(dtype)


def param_shapes(cfg: TransformerConfig) -> Dict:
    """The parameter tree's shapes: key -> (shape, init scale), where a
    scale of None means ones (the norm weights) and 0.0 zeros (the
    router's correction bias). Layer leaves carry the stacked leading [L]
    axis; the experts' leaves hold the experts the card holds."""
    d, h, kvh, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.head_dim, cfg.d_ff)
    L = cfg.n_layers
    scale = d ** -0.5
    out_scale = scale * (2 * L) ** -0.5
    if cfg.mla:
        qk, q_rank, kv_rank = (cfg.qk_nope_dim + cfg.qk_rope_dim,
                               cfg.q_lora_rank, cfg.kv_lora_rank)
        layer = {
            "attn_norm": ((L, d), None),
            "wq_a": ((L, d, q_rank), scale),
            "q_a_norm": ((L, q_rank), None),
            "wq_b": ((L, q_rank, h * qk), q_rank ** -0.5),
            "wkv_a": ((L, d, kv_rank + cfg.qk_rope_dim), scale),
            "kv_a_norm": ((L, kv_rank), None),
            "wkv_b": ((L, kv_rank, h * (cfg.qk_nope_dim + cfg.v_head_dim)),
                      kv_rank ** -0.5),
            "wo": ((L, h * cfg.v_head_dim, d), out_scale),
            "mlp_norm": ((L, d), None),
        }
    else:
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
        E, held, fe = cfg.num_experts, cfg.n_experts_held, cfg.expert_d_ff
        layer["router"] = ((L, d, E), scale)
        if cfg.router == "sigmoid_bias":
            layer["router_bias"] = ((L, E), 0.0)  # zeros, never trained
        layer["w_gate"] = ((L, held, d, fe), scale)
        layer["w_up"] = ((L, held, d, fe), scale)
        layer["w_down"] = ((L, held, fe, d), out_scale)
        if cfg.n_shared_experts:
            fs = cfg.n_shared_experts * fe
            layer["w_shared_gate"] = ((L, d, fs), scale)
            layer["w_shared_up"] = ((L, d, fs), scale)
            layer["w_shared_down"] = ((L, fs, d), out_scale)
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
        if scale == 0.0:
            return torch.zeros(shape, dtype=cfg.dtype, device=device)
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


def param_logical_axes(cfg: TransformerConfig) -> Dict:
    """Logical sharding axes mirroring init_params' tree.

    Mapped through parallel.mesh.DEFAULT_RULES: "embed"->fsdp, "mlp"/
    "heads"/"vocab"->tp, "expert"->ep, layer-stack axis -> "stage" (pp).
    """
    if cfg.mla:
        layer = {
            "attn_norm": ("stage", None),
            "wq_a": ("stage", "embed", None),
            "q_a_norm": ("stage", None),
            "wq_b": ("stage", None, "heads"),
            "wkv_a": ("stage", "embed", None),
            "kv_a_norm": ("stage", None),
            "wkv_b": ("stage", None, "heads"),
            "wo": ("stage", "heads", "embed"),
            "mlp_norm": ("stage", None),
        }
    else:
        layer = {
            "attn_norm": ("stage", None),
            "wq": ("stage", "embed", "heads"),
            "wk": ("stage", "embed", "heads"),
            "wv": ("stage", "embed", "heads"),
            "wo": ("stage", "heads", "embed"),
            "mlp_norm": ("stage", None),
        }
    if cfg.qk_norm:
        layer["q_norm"] = ("stage", None)
        layer["k_norm"] = ("stage", None)
    if cfg.num_experts == 0:
        layer.update(
            {
                "w_gate": ("stage", "embed", "mlp"),
                "w_up": ("stage", "embed", "mlp"),
                "w_down": ("stage", "mlp", "embed"),
            }
        )
    else:
        layer.update(
            {
                "router": ("stage", "embed", None),
                "w_gate": ("stage", "expert", "embed", "mlp"),
                "w_up": ("stage", "expert", "embed", "mlp"),
                "w_down": ("stage", "expert", "mlp", "embed"),
            }
        )
        if cfg.router == "sigmoid_bias":
            layer["router_bias"] = ("stage", None)
        if cfg.n_shared_experts:
            layer.update({"w_shared_gate": ("stage", "embed", "mlp"),
                          "w_shared_up": ("stage", "embed", "mlp"),
                          "w_shared_down": ("stage", "mlp", "embed")})
    axes = {
        "embed": ("vocab", "embed"),
        "layers": layer,
        "final_norm": (None,),
    }
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


# Parameter dimensions a layer computes split (heads and MLP over tp,
# experts over ep): they stay local. Every other sharded dimension is
# gathered for use.
_SPLIT_COMPUTE = ("heads", "mlp", "expert")


def _usable_leaf(p, logical, mesh, data_axes, keep=()):
    """One parameter shard made ready to use under `mesh`: each dimension
    sharded over an axis is gathered unless the layer computes it split
    (_SPLIT_COMPUTE, plus `keep`). A gather over a data axis transposes
    to a reduce-scatter (ZeRO-3); over a model axis, to the rank's slice.
    A leaf replicated over a data axis in `data_axes` has its gradient
    summed over that axis, as the reference's batch gradients are."""
    spec = logical_to_physical(logical)
    used = {a for entry in spec for a in spec_axes(entry)}
    p = _comm.reduce_grad(p, mesh, [a for a in data_axes if a not in used])
    for dim, (name, entry) in enumerate(zip(logical, spec)):
        if name in _SPLIT_COMPUTE or name in keep:
            continue
        for axis in reversed(spec_axes(entry)):  # the minor axis first
            p = _comm.all_gather(p, mesh, (axis,), dim,
                                 sum_grads=axis in _comm.DATA_AXES)
    return p


def _usable_params(params: Dict, cfg: TransformerConfig, mesh, data_axes,
                   keep=()) -> Dict:
    """_usable_leaf over the whole tree."""
    axes = param_logical_axes(cfg)
    out = {k: _usable_leaf(v, axes[k], mesh, data_axes, keep)
           for k, v in params.items() if k != "layers"}
    out["layers"] = {k: _usable_leaf(v, axes["layers"][k], mesh, data_axes,
                                     keep)
                     for k, v in params["layers"].items()}
    return out


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


def _embed_span(params, tokens: torch.Tensor, cfg: TransformerConfig):
    """_embed_tokens in the "model.embed" span. The ids carry no gradient,
    so the span's backward ends at the weight's."""
    with device_span("model.embed") as sp:
        w = sp.entry(params["embed"])
        return sp.exit(_embed_tokens({"embed": w}, tokens, cfg))


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


def _attention(cfg: TransformerConfig, q, k, v, mesh, seq_sharded: bool):
    """Causal attention of this rank's heads. With the sequence split over
    sp: ring or Ulysses attention by cfg.attn_impl, else the flash kernel
    on the gathered sequence."""
    if not seq_sharded:
        return flash_attention(q, k, v, causal=True)
    if cfg.attn_impl in ("ring", "ulysses"):
        if k.shape[2] != q.shape[2]:  # GQA: one kv head per q head
            group = q.shape[2] // k.shape[2]
            k = k.repeat_interleave(group, dim=2)
            v = v.repeat_interleave(group, dim=2)
        fn = ring_attention if cfg.attn_impl == "ring" else ulysses_attention
        return fn(q, k, v, mesh, axis_name="sp", causal=True)
    q, k, v = (_comm.all_gather(t, mesh, ("sp",), 1, sum_grads=True)
               for t in (q, k, v))
    return local_shard(flash_attention(q, k, v, causal=True),
                       (None, "sp"), mesh)


@functools.lru_cache(maxsize=None)
def _expert_products(dtype: str):
    """`moe_expert_products_total` and its series key for one operand
    dtype, made at the first MoE call so that importing the model starts
    no metrics flusher."""
    from ray_tpu_torch.util.metrics import Counter, get_or_create

    counter = get_or_create(
        Counter, "moe_expert_products_total",
        "Calls of the MoE experts' SwiGLU (one per MoE layer and pass: "
        "forward, remat's recompute), by the products' operand dtype",
        tag_keys=("dtype",))
    return counter, counter._key({"dtype": dtype})


def _moe_experts(w, xin, act, mesh=None):
    """The experts' SwiGLU on their slots: xin [E, C, D] f32 -> [E, C, D]
    f32, summed over tp.

    The products take their operands in bf16 where the expert weights are
    bf16, with f32 accumulation, and the activation and gating stay f32:
    the dense MLP's casts, and how XLA runs the reference's einsums on the
    MXU. A slot holds one token's row of the bf16 RMSNorm output, or
    zeros, so casting xin to bf16 is exact. Any other weights take f32
    operands, the reference's einsums as jnp.einsum promotes them with the
    f32 xin: every f32 parity test against the JAX package runs there."""
    dt = torch.bfloat16 if w["down"].dtype == torch.bfloat16 \
        else torch.float32
    counter, key = _expert_products(str(dt).removeprefix("torch."))
    counter.inc_keyed(key)
    xin = _comm.reduce_grad(xin, mesh, ("tp",)).to(dt)
    g = act(torch.einsum("ecd,edf->ecf", xin, w["gate"].to(dt)).float())
    u = torch.einsum("ecd,edf->ecf", xin, w["up"].to(dt)).float()
    out = torch.einsum("ecf,efd->ecd", (g * u).to(dt), w["down"].to(dt))
    return _comm.all_reduce(out.float(), mesh, ("tp",))


def _swiglu(cfg: TransformerConfig, h, w_gate, w_up, w_down, mesh):
    """The dense MLP with the reference's casts: products in the weights'
    dtype, the activation and gating in f32; split over tp, with the
    all-reduce after w_down."""
    act = _act(cfg)
    h_in = _comm.reduce_grad(h, mesh, ("tp",))
    gate = act((h_in @ w_gate).float())
    up = (h_in @ w_up).float()
    return _comm.all_reduce((gate * up).to(h.dtype) @ w_down, mesh, ("tp",))


def _moe_mlp(cfg: TransformerConfig, h, lp, mesh, seq_sharded: bool):
    """The MoE MLP. Routing, dispatch and combine run in f32, as the
    reference runs them; the expert products in the weights' dtype where
    that is bf16 (`_moe_experts`). Routing and capacity are over the whole
    batch: the tokens are gathered over the data axes in global order, and
    this rank keeps its block of the output. The shared experts run on
    this rank's tokens, as the dense MLP does."""
    h_local = h
    token_spec = (("dp", "fsdp"), "sp" if seq_sharded else None)
    for dim, entry in enumerate(token_spec):
        h = _comm.all_gather(h, mesh, spec_axes(entry), dim, sum_grads=True)
    b, l, d = h.shape
    out, aux = moe_layer(
        h.reshape(b * l, d).float(), lp["router"].float(),
        functools.partial(_moe_experts, act=_act(cfg), mesh=mesh),
        {"gate": lp["w_gate"], "up": lp["w_up"], "down": lp["w_down"]},
        k=cfg.experts_per_token, mesh=mesh, router=cfg.router,
        router_bias=lp.get("router_bias"),
        norm_topk_prob=cfg.norm_topk_prob,
        routed_scaling_factor=cfg.routed_scaling_factor,
        experts_held=cfg.experts_held)
    out = local_shard(out.reshape(b, l, d), token_spec, mesh)
    if cfg.n_shared_experts:
        with device_span("moe.shared") as sp:
            shared = sp.exit(_swiglu(cfg, sp.entry(h_local),
                                     lp["w_shared_gate"], lp["w_shared_up"],
                                     lp["w_shared_down"], mesh))
        out = out + shared
    return out, aux


def _layer_body(cfg: TransformerConfig, x, lp, cos, sin, positions,
                mesh=None, seq_sharded: bool = False):
    """One decoder layer, with the reference's casts. Returns (x, aux)."""
    with device_span("model.attention") as sp:
        x = sp.entry(x)
        x = sp.exit(x + _attention_block(cfg, x, lp, cos, sin, positions,
                                         mesh, seq_sharded).to(x.dtype))
    with device_span("model.mlp") as sp:
        x = sp.entry(x)
        h = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
        if cfg.num_experts:
            mlp_out, aux = _moe_mlp(cfg, h, lp, mesh, seq_sharded)
            return sp.exit(x + mlp_out.to(x.dtype), aux)
        mlp_out = _swiglu(cfg, h, lp["w_gate"], lp["w_up"], lp["w_down"],
                          mesh)
        return (sp.exit(x + mlp_out),
                torch.zeros((), dtype=torch.float32, device=x.device))


def _attention_block(cfg: TransformerConfig, x, lp, cos, sin, positions,
                     mesh, seq_sharded: bool):
    """attn norm -> q/k/v -> rope -> attention -> out projection: the
    layer's attention output, before the residual add."""
    h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    if cfg.mla:
        return _mla_block(cfg, h, lp, cos, sin, mesh, seq_sharded)
    b, l, _ = h.shape
    tp = axis_size(mesh, "tp")
    if cfg.n_heads % tp:
        raise ValueError(f"{cfg.n_heads} heads do not split over tp={tp}")
    wk, wv = lp["wk"], lp["wv"]
    kv_split = cfg.n_kv_heads % tp == 0
    if not kv_split:
        # Fewer kv heads than tp splits: every rank projects them all and
        # keeps, per q head, its kv head; the ranks' gradients of the
        # gathered weights (each from its own heads) are summed.
        wk, wv = (_comm.all_gather(w, mesh, ("tp",), 1, sum_grads=True)
                  for w in (wk, wv))
    n_kv = cfg.n_kv_heads // tp if kv_split else cfg.n_kv_heads
    h_in = _comm.reduce_grad(h, mesh, ("tp",))
    q = (h_in @ lp["wq"]).reshape(b, l, cfg.n_heads // tp, cfg.head_dim)
    k = (h_in @ wk).reshape(b, l, n_kv, cfg.head_dim)
    v = (h_in @ wv).reshape(b, l, n_kv, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(q, lp["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, lp["k_norm"], cfg.norm_eps)
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    if not kv_split:
        group = cfg.n_heads // cfg.n_kv_heads
        k, v = (local_shard(t.repeat_interleave(group, dim=2),
                            (None, None, "tp"), mesh) for t in (k, v))
    attn = _attention(cfg, q, k, v, mesh, seq_sharded)
    return _comm.all_reduce(attn.reshape(b, l, -1) @ lp["wo"], mesh, ("tp",))


def _mla_block(cfg: TransformerConfig, h, lp, cos, sin, mesh,
               seq_sharded: bool):
    """Multi-head latent attention on the normed h [b, l, d], as
    DeepSeek-V3 computes it: q = W_qb RMSNorm(W_qa h); [c_kv, k_pe] =
    W_kva h; [k_nope, v] = W_kvb RMSNorm(c_kv), per head; rope on the
    last qk_rope_dim of q and on k_pe, one head broadcast to all; q and k
    are [nope, rope]. cos, sin: tables of the rope dimensions for
    positions 0..l-1."""
    if axis_size(mesh, "tp") > 1 or seq_sharded:
        raise ValueError("latent attention (MLA) runs without a tp or sp "
                         "split")
    b, l, _ = h.shape
    H, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    eps = cfg.norm_eps
    with device_span("mla.latent") as sp:
        h = sp.entry(h)
        q = rmsnorm(h @ lp["wq_a"], lp["q_a_norm"], eps) @ lp["wq_b"]
        q_nope, q_pe = q.view(b, l, H, dn + dr).split([dn, dr], dim=-1)
        c_kv, k_pe = (h @ lp["wkv_a"]).split([cfg.kv_lora_rank, dr], dim=-1)
        kv = rmsnorm(c_kv, lp["kv_a_norm"], eps) @ lp["wkv_b"]
        k_nope, v = kv.view(b, l, H, dn + dv).split([dn, dv], dim=-1)
        q_pe, k_pe = (apply_rope(deinterleave(t) if cfg.rope_interleave
                                 else t, cos, sin)
                      for t in (q_pe, k_pe.view(b, l, 1, dr)))
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe.expand(b, l, H, dr)], dim=-1)
        if cfg.llama4_scaling_beta and l > cfg.rope_original_max:
            pos = torch.arange(l, device=h.device)
            q = q * (1 + cfg.llama4_scaling_beta * torch.log1p(torch.div(
                pos, cfg.rope_original_max, rounding_mode="floor")
                .float()))[None, :, None, None].to(q.dtype)
        q, k, v = sp.exit(q, k, v)
    attn = flash_attention(q, k, v, causal=True, scale=mla_softmax_scale(cfg))
    return attn.reshape(b, l, H * dv) @ lp["wo"]


def mla_softmax_scale(cfg: TransformerConfig) -> float:
    """(qk_nope_dim + qk_rope_dim)^-0.5, times YaRN's mscale_all_dim
    temperature squared (DeepSeek-V3's softmax scale)."""
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    if cfg.rope_type == "yarn" and cfg.mscale_all_dim:
        scale *= yarn_mscale(cfg.rope_factor, cfg.mscale_all_dim) ** 2
    return scale


def _rope_cos_sin(cfg: TransformerConfig, length: int, device):
    """The rope tables a forward over positions 0..length-1 uses: YaRN's
    over the rope dimensions, built for the job's positions, or the
    default tables of the whole head up to max_seq."""
    if cfg.rope_type == "yarn":
        return yarn_tables(cfg.qk_rope_dim if cfg.mla else cfg.head_dim,
                           length, cfg.rope_theta, cfg.rope_factor,
                           cfg.rope_original_max, cfg.beta_fast,
                           cfg.beta_slow, cfg.mscale, cfg.mscale_all_dim,
                           device)
    if cfg.rope_type != "default":
        raise ValueError(f"unknown rope_type {cfg.rope_type!r}")
    return rope_tables(cfg.qk_rope_dim if cfg.mla else cfg.head_dim,
                       cfg.max_seq, cfg.rope_theta, device)


# Ops whose outputs each remat policy saves; everything else is recomputed
# in the backward (the flash forward included, as the Pallas call is under
# JAX's policies). "dots_nobatch" is jax's dots_with_no_batch_dims_saveable:
# the projections, which reach aten.mm; "dots" also keeps batched products.
_SAVED_OPS = {
    "dots_nobatch": (torch.ops.aten.mm.default,),
    "dots": (torch.ops.aten.mm.default, torch.ops.aten.bmm.default),
}


def _save_policy(saved, ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in saved
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(body, cfg: TransformerConfig):
    """body under activation checkpointing with cfg.remat_policy: "full"
    recomputes everything, the others save what _SAVED_OPS lists."""
    if cfg.remat_policy == "full":
        context_fn = noop_context_fn
    elif cfg.remat_policy in _SAVED_OPS:
        context_fn = functools.partial(
            create_selective_checkpoint_contexts,
            functools.partial(_save_policy, _SAVED_OPS[cfg.remat_policy]))
    else:
        raise ValueError(
            f"unknown remat_policy {cfg.remat_policy!r}: "
            "expected 'full', 'dots', or 'dots_nobatch'")
    return functools.partial(checkpoint, body, use_reentrant=False,
                             context_fn=context_fn)


def _trunk(params: Dict, tokens: torch.Tensor, cfg: TransformerConfig,
           mesh=None, positions: Optional[torch.Tensor] = None):
    """The embedding and the layer stack. Returns (the parameters ready to
    use, the residual stream before the final norm, aux_loss)."""
    seq_sharded = axis_size(mesh, "sp") > 1
    if mesh is not None:
        params = _usable_params(params, cfg, mesh, _comm.DATA_AXES)
    if cfg.rope_type == "yarn" and (positions is not None or seq_sharded):
        raise ValueError("YaRN rope tables are built for positions "
                         "0..L-1 of an unsplit sequence")
    x = _embed_span(params, tokens, cfg)
    cos, sin = _rope_cos_sin(cfg, tokens.shape[1], x.device)
    if positions is None and seq_sharded:
        # RoPE and the causal mask take global positions.
        b, l = tokens.shape
        start = axis_index(mesh, "sp") * l
        positions = (start + torch.arange(l, device=x.device)).expand(b, l)
    body = functools.partial(_layer_body, cfg, mesh=mesh,
                             seq_sharded=seq_sharded)
    if cfg.remat:
        body = _remat(body, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in layer_params(params):
        x, layer_aux = body(x, lp, cos, sin, positions)
        aux = aux + layer_aux
    return params, x, aux


def _head(x, used, cfg: TransformerConfig, tail=None):
    """The model's head in the "model.head" span: the final norm, then
    `tail` on its output (the loss), or without one the logits. `used`:
    the parameters ready to use."""
    with device_span("model.head") as sp:
        x = rmsnorm(sp.entry(x), used["final_norm"], cfg.norm_eps)
        return sp.exit(project_logits(x, used, cfg) if tail is None
                       else tail(x))


def forward(params: Dict, tokens: torch.Tensor, cfg: TransformerConfig,
            mesh=None, positions: Optional[torch.Tensor] = None,
            return_hidden: bool = False):
    """Returns (logits [B, L, vocab], aux_loss scalar); with return_hidden,
    the pre-lm_head hidden states [B, L, D] instead of logits.
    tokens: [B, L] integers.

    Under a mesh, `params` are the rank's shards and `tokens` its block
    ([B/(dp*fsdp), L/sp]); the logits (whole vocabulary) are its block
    too, and aux_loss the whole batch's, the same on every rank."""
    params, x, aux = _trunk(params, tokens, cfg, mesh, positions)
    return _head(x, params, cfg, (lambda h: h) if return_hidden else None), aux


def _pipelined_trunk(params: Dict, tokens: torch.Tensor,
                     cfg: TransformerConfig, mesh, num_microbatches=None):
    """forward_pipelined up to the final norm: (the parameters ready to
    use, the residual stream). The layer stack shards over "pp" stages.

    Each pp rank holds n_layers/S contiguous layers (its shards from
    shard_params) and its batch block of the tokens ([B/(dp*fsdp), L]);
    microbatches of that block stream through the GPipe schedule of
    parallel.pipeline.pipeline_stages. Embedding and the LM head run on
    every rank. The microbatch count and its errors are the reference's,
    from the global batch B.
    """
    S = axis_size(mesh, "pp")
    dp_extent = axis_size(mesh, "dp") * axis_size(mesh, "fsdp")
    b_local, l = tokens.shape
    b = b_local * dp_extent
    M = num_microbatches or cfg.pp_microbatches
    if not M:
        # Auto: prefer 2*S microbatches, but each microbatch's batch dim
        # must still split over dp/fsdp.
        for cand in (2 * S, S, 1):
            if b % cand == 0 and (b // cand) % dp_extent == 0:
                M = cand
                break
        else:
            raise ValueError(
                f"batch {b} cannot form pp microbatches divisible by the "
                f"dp extent {dp_extent}; pick batch = k * {S} * {dp_extent}"
            )
    if b % M != 0:
        raise ValueError(f"batch {b} not divisible by {M} pp microbatches")
    if (b // M) % dp_extent != 0:
        raise ValueError(
            f"microbatch size {b // M} not divisible by dp extent "
            f"{dp_extent} (batch {b}, {M} microbatches)"
        )
    if cfg.n_layers % S != 0:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by pp={S}")
    if cfg.num_experts:
        raise ValueError(
            "pipeline parallelism currently supports dense layers only "
            "(the MoE aux loss does not thread through the pp schedule)"
        )

    # Inside the pipeline the sequence stays whole: only dp/fsdp split
    # the tokens.
    params = _usable_params(params, cfg, mesh, ("dp", "fsdp"),
                            keep=("stage",))
    x = _embed_span(params, tokens, cfg)
    cos, sin = _rope_cos_sin(cfg, l, x.device)
    body = functools.partial(_layer_body, cfg, mesh=mesh)
    if cfg.remat:
        body = _remat(body, cfg)

    def stage_fn(stage_layers, act):
        # stage_layers: leaves [n_layers/S, ...] — this rank's stage.
        for lp in layer_params({"layers": stage_layers}):
            act, _ = body(act, lp, cos, sin, None)
        return act

    d = x.shape[-1]
    xm = x.reshape(M, b_local // M, l, d)
    ym = pipeline_stages(stage_fn, params["layers"], xm, mesh, axis_name="pp")
    return params, ym.reshape(b_local, l, d)


def forward_pipelined(params: Dict, tokens: torch.Tensor,
                      cfg: TransformerConfig, mesh, num_microbatches=None):
    """Pipeline-parallel forward: the layer stack shards over "pp" stages
    (_pipelined_trunk); returns (logits, a zero aux_loss)."""
    params, x = _pipelined_trunk(params, tokens, cfg, mesh, num_microbatches)
    return (_head(x, params, cfg),
            torch.zeros((), dtype=torch.float32, device=x.device))


def loss_fn(params: Dict, tokens: torch.Tensor, cfg: TransformerConfig,
            mesh=None, aux_weight: float = 0.01) -> torch.Tensor:
    """Next-token LM loss (f32 scalar). tokens: [B, L]; predicts
    tokens[:, 1:] from tokens[:, :-1].

    Under a mesh, `tokens` is the rank's batch block [B/(dp*fsdp), L]
    with the whole sequence (the shift crosses sp blocks); every rank
    returns the whole batch's loss, and its backward gives the rank's
    shards the unsharded gradient. With pp > 1 the forward runs the
    GPipe microbatch pipeline and its backward differentiates through it.
    """
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    pipelined = axis_size(mesh, "pp") > 1
    data_axes = ("dp", "fsdp") if pipelined else _comm.DATA_AXES
    if pipelined:
        used, x = _pipelined_trunk(params, inputs, cfg, mesh)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        if axis_size(mesh, "sp") > 1:
            inputs, labels = (local_shard(t, (None, "sp"), mesh)
                              for t in (inputs, labels))
        used, x, aux = _trunk(params, inputs, cfg, mesh)
    # Every rank's block holds as many tokens, so the mean over the batch
    # is the sum over the data axes of each block's mean over their count.
    # aux is the whole batch's on every rank: each carries its share.
    n = 1
    for a in data_axes:
        n *= axis_size(mesh, a)

    def tail(h):
        if cfg.ce_chunk and not pipelined:
            head = lm_head_weight(params, cfg)
            if mesh is not None:
                head = _usable_leaf(head, ("embed", "vocab"), mesh,
                                    _comm.DATA_AXES)
            loss = chunked_lm_head_ce(h, head, labels, cfg.ce_chunk,
                                      softcap=cfg.final_logit_softcap)
        else:
            loss = softmax_cross_entropy(project_logits(h, used, cfg),
                                         labels).mean()
        return _comm.all_reduce((loss + aux_weight * aux) / n, mesh,
                                data_axes)

    return _head(x, used, cfg, tail)
