"""Sizes, weights and FLOPs of a latent-attention (MLA) model with
DeepSeek-V3-style experts, from its configuration file, whatever
implements it: the leaves in the port's stacked layout, their seeded
draws (as `portbench.weights` makes the other configurations'), the
parameters a token runs through and the model FLOPs of a training step.

Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from portbench.weights import leaf_seed
from portbench.yardstick import causal_pairs


def dims(doc: Dict) -> Dict:
    """The sizes a configuration file states, under short names. The file
    states the experts held here (`n_routed_experts`, from
    `experts_held`); the router's width is the published count."""
    rope = doc["rope_parameters"]
    held = doc["experts_held"]
    experts = int(doc.get("published", {}).get("n_routed_experts",
                                               doc["n_routed_experts"]))
    if held[1] - held[0] != int(doc["n_routed_experts"]):
        raise ValueError(f"experts_held {held} is not n_routed_experts "
                         f"{doc['n_routed_experts']} experts")
    return {
        "d": int(doc["hidden_size"]),
        "layers": int(doc["num_hidden_layers"]),
        "heads": int(doc["num_attention_heads"]),
        "q_rank": int(doc["q_lora_rank"]),
        "kv_rank": int(doc["kv_lora_rank"]),
        "nope": int(doc["qk_nope_head_dim"]),
        "rope": int(doc["qk_rope_head_dim"]),
        "v": int(doc["v_head_dim"]),
        "experts": experts,
        "held": (int(held[0]), int(held[1])),
        "top_k": int(doc["num_experts_per_tok"]),
        "moe_ff": int(doc["moe_intermediate_size"]),
        "shared": int(doc["n_shared_experts"]),
        "norm_topk": bool(doc["norm_topk_prob"]),
        "routed_scale": float(doc["routed_scaling_factor"]),
        "capacity_factor": float(doc["capacity_factor"]),
        "vocab": int(doc["vocab_size"]),
        "eps": float(doc["rms_norm_eps"]),
        "init_std": float(doc["initializer_range"]),
        "rope_theta": float(rope["rope_theta"]),
        "rope_factor": float(rope["factor"]),
        "rope_original_max": int(rope["original_max_position_embeddings"]),
        "beta_fast": float(rope["beta_fast"]),
        "beta_slow": float(rope["beta_slow"]),
        "mscale": float(rope["mscale"]),
        "mscale_all_dim": float(rope["mscale_all_dim"]),
        "llama4_beta": float(rope["llama_4_scaling_beta"]),
        "interleave": bool(doc["rope_interleave"]),
        "max_seq": int(doc["max_position_embeddings"]),
    }


def leaf_shapes(dm: Dict) -> Dict[str, Tuple[Tuple[int, ...],
                                             Optional[float]]]:
    """Every weight leaf in the port's stacked layout with the std of its
    normal draw (None: ones, the norm weights; 0.0: zeros, the router's
    correction bias). Layer leaves lead with [layers]; the expert leaves
    hold the experts held here."""
    d, L, H, std = dm["d"], dm["layers"], dm["heads"], dm["init_std"]
    qk = dm["nope"] + dm["rope"]
    held = dm["held"][1] - dm["held"][0]
    ff, fs = dm["moe_ff"], dm["shared"] * dm["moe_ff"]
    return {
        "embed": ((dm["vocab"], d), std),
        "lm_head": ((d, dm["vocab"]), std),
        "final_norm": ((d,), None),
        "layers.attn_norm": ((L, d), None),
        "layers.wq_a": ((L, d, dm["q_rank"]), std),
        "layers.q_a_norm": ((L, dm["q_rank"]), None),
        "layers.wq_b": ((L, dm["q_rank"], H * qk), std),
        "layers.wkv_a": ((L, d, dm["kv_rank"] + dm["rope"]), std),
        "layers.kv_a_norm": ((L, dm["kv_rank"]), None),
        "layers.wkv_b": ((L, dm["kv_rank"], H * (dm["nope"] + dm["v"])),
                         std),
        "layers.wo": ((L, H * dm["v"], d), std),
        "layers.mlp_norm": ((L, d), None),
        "layers.router": ((L, d, dm["experts"]), std),
        "layers.router_bias": ((L, dm["experts"]), 0.0),
        "layers.w_gate": ((L, held, d, ff), std),
        "layers.w_up": ((L, held, d, ff), std),
        "layers.w_down": ((L, held, ff, d), std),
        "layers.w_shared_gate": ((L, d, fs), std),
        "layers.w_shared_up": ((L, d, fs), std),
        "layers.w_shared_down": ((L, fs, d), std),
    }


def trained_leaves(dm: Dict):
    """The leaves the optimizer updates: all but the correction bias."""
    return [n for n, (_, std) in leaf_shapes(dm).items() if std != 0.0]


# -- weights -------------------------------------------------------------------

def make_leaf(dm: Dict, seed: int, name: str, device,
              dtype=torch.bfloat16) -> torch.Tensor:
    shapes = leaf_shapes(dm)
    shape, std = shapes[name]
    if std is None:
        return torch.ones(shape, dtype=dtype, device=device)
    if std == 0.0:
        return torch.zeros(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, list(shapes).index(name)))
    out = torch.empty(shape, dtype=dtype, device=device)
    return out.normal_(0.0, std, generator=gen)


def make_weights(dm: Dict, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """{"embed", "lm_head", "final_norm", "layers": {...}}, as the port's
    parameter tree."""
    tree: Dict = {"layers": {}}
    for name in leaf_shapes(dm):
        t = make_leaf(dm, seed, name, device, dtype)
        if name.startswith("layers."):
            tree["layers"][name.split(".", 1)[1]] = t
        else:
            tree[name] = t
    return tree


def sample_index(dm: Dict, seed: int, name: str, device,
                 k: int = 1 << 16) -> torch.Tensor:
    """k element indices into each layer's slice of a leaf (the whole leaf
    where it has no layer axis), drawn from the seed."""
    shapes = leaf_shapes(dm)
    shape, _ = shapes[name]
    numel = math.prod(shape[1:]) if name.startswith("layers.") else \
        math.prod(shape)
    gen = torch.Generator().manual_seed(
        leaf_seed(seed, 1000 + list(shapes).index(name)))
    return torch.randint(0, numel, (k,), generator=gen).to(device)


# -- parameters and FLOPs ------------------------------------------------------

def param_count(dm: Dict) -> int:
    """Every weight held here, the correction bias left out."""
    shapes = leaf_shapes(dm)
    return sum(math.prod(shapes[n][0]) for n in trained_leaves(dm))


def held_expert_params(dm: Dict) -> int:
    held = dm["held"][1] - dm["held"][0]
    return 3 * held * dm["d"] * dm["moe_ff"] * dm["layers"]


def active_params(dm: Dict) -> float:
    """Parameters an average token runs through on this card, the input
    embedding left out: all but the held experts, plus the held experts
    at k * held / experts of one expert each (k / experts of the tokens
    choose each expert)."""
    held = dm["held"][1] - dm["held"][0]
    experts = held_expert_params(dm)
    one = experts / held
    return (param_count(dm) - experts - dm["vocab"] * dm["d"]
            + one * dm["top_k"] * held / dm["experts"])


def train_step_flops(dm: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 active parameters a token, plus
    the attention products over the kept causal pairs (q.k over
    qk_nope + qk_rope, p.v over v_head_dim), forward and backward (3x the
    forward); recomputation not counted."""
    per_pair = 2 * (dm["nope"] + dm["rope"]) + 2 * dm["v"]
    attention = (3.0 * batch * dm["layers"] * dm["heads"] * per_pair
                 * causal_pairs(seq, seq))
    return 6.0 * active_params(dm) * batch * seq + attention
