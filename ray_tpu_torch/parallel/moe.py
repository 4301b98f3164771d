"""Mixture-of-experts with expert parallelism.

Counterpart of ray_tpu/parallel/moe.py: tokens are routed top-k with a
capacity factor (the Switch/GShard formulation), each (token, choice)
getting its expert, its slot in that expert's queue and its gate
(`route`). The layer then moves rows by index: dispatch gathers each
slot's token row into `[experts, capacity, d]` and combine adds each
slot's gate-weighted output back into its token's row. A slot holds one
token, so the gather is the reference's one-hot dispatch einsum exactly;
the combine sums a token's k terms. `top_k_routing` is the reference's
dense form of the same routing (one-hot `[tokens, experts, capacity]`
masks), kept for the parity tests; no layer builds it.

Routing, dispatch and combine take the dtype of `x` (the model passes
f32); `expert_fn` chooses its own: the model's (models/transformer.py
`_moe_experts`) takes the products in bf16 with f32 accumulation where
the expert weights are bf16 (a slot copies one token of the bf16 model's
activations, so its cast to bf16 is exact), and in f32 for any other
weights, as the reference's promoted einsums.

Two routers: "softmax" (the reference's: gates from the softmax over all
experts, k passes of the first maximum, a Switch-style balance loss) and
"sigmoid_bias" (DeepSeek-V3, arXiv:2412.19437: sigmoid scores, the top-k
of the scores plus a per-expert correction bias that steers the choice
only, gates the chosen scores; no balance loss). Either may renormalise
the chosen gates and scale them.

A layer holds a block of the experts (`experts_held`, all of them by
default): it routes every token over all experts, fills every expert's
capacity, and computes its own experts' part of the output. Under an
"ep" mesh axis each rank holds its block of that range and the partial
outputs are summed over ep. Routing and capacity are over the whole
token set the layer is given, as under GSPMD, so every rank routes
every token alike.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.parallel import _comm
from ray_tpu_torch.parallel.mesh import axis_index, axis_size
from ray_tpu_torch.util.profiling import device_span, device_spans_on

ROUTERS = ("softmax", "sigmoid_bias")


def _slots(expert: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Each (pass, token)'s place in its expert's queue, the queue filled
    pass by pass and in token order within a pass. expert: [k, T]."""
    flat = expert.reshape(-1)
    by_expert, order = torch.sort(flat, stable=True)
    # Where each expert's run starts (no count whose size the host needs).
    starts = torch.searchsorted(by_expert, torch.arange(
        num_experts, device=flat.device, dtype=flat.dtype))
    ranks = torch.arange(flat.numel(), device=flat.device) - starts[by_expert]
    return torch.empty_like(flat).scatter_(0, order, ranks).view_as(expert)


def route(router_logits: torch.Tensor, k: int, capacity: int,
          router: str = "softmax", bias: Optional[torch.Tensor] = None,
          norm_topk_prob: bool = False, scaling: float = 1.0):
    """Top-k routing in slot form. router_logits: [tokens, experts].

    Returns (expert, slot, gate, aux_loss): expert [k, tokens] int64,
    slot [k, tokens] int64 (the place in the expert's queue; the pair is
    dropped where it is `capacity` or more), gate [k, tokens] in the
    logits' dtype, and the balance loss (0 for "sigmoid_bias").

    "softmax": each of the k passes takes the first maximum of the
    probabilities not yet chosen (as jnp.argmax does). "sigmoid_bias":
    the top-k of sigmoid(logits) + bias, largest first; the bias steers
    the choice and never the gate."""
    tokens, num_experts = router_logits.shape
    if router == "softmax":
        probs = torch.softmax(router_logits, dim=-1)
        # Load-balance loss: mean prob * mean assignment fraction.
        top1 = torch.argmax(probs, dim=-1)
        me = probs.mean(dim=0)
        ce = F.one_hot(top1, num_experts).to(probs.dtype).mean(dim=0)
        aux_loss = num_experts * torch.sum(me * ce)
        remaining, experts, gates = probs, [], []
        for _ in range(k):
            choice = torch.argmax(remaining, dim=-1)
            experts.append(choice)
            gates.append(remaining.gather(-1, choice[:, None])[:, 0])
            remaining = remaining.scatter(-1, choice[:, None], 0.0)
        expert, gate = torch.stack(experts), torch.stack(gates)
    elif router == "sigmoid_bias":
        scores = torch.sigmoid(router_logits)
        pick = scores.detach()
        if bias is not None:
            pick = pick + bias.detach().to(pick.dtype)
        idx = torch.topk(pick, k, dim=-1).indices
        expert, gate = idx.T, scores.gather(-1, idx).T
        aux_loss = torch.zeros((), dtype=scores.dtype,
                               device=scores.device)
    else:
        raise ValueError(f"unknown router {router!r}; have {ROUTERS}")
    if norm_topk_prob:
        gate = gate / (gate.sum(dim=0, keepdim=True) + 1e-20)
    if scaling != 1.0:
        gate = gate * scaling
    return expert, _slots(expert, num_experts), gate, aux_loss


def dense_masks(expert: torch.Tensor, slot: torch.Tensor, gate: torch.Tensor,
                num_experts: int, capacity: int):
    """The slot form as the reference's one-hot tensors: (dispatch,
    combine), each [tokens, experts, capacity]."""
    k, tokens = expert.shape
    keep = (slot < capacity).to(gate.dtype)
    index = (torch.arange(tokens, device=expert.device).expand(k, tokens)
             .reshape(-1), expert.reshape(-1),
             slot.clamp(max=capacity - 1).reshape(-1))
    zeros = torch.zeros((tokens, num_experts, capacity), dtype=gate.dtype,
                        device=gate.device)
    dispatch = zeros.index_put(index, keep.reshape(-1), accumulate=True)
    combine = zeros.index_put(index, (keep * gate).reshape(-1),
                              accumulate=True)
    return dispatch, combine


def top_k_routing(
    router_logits: torch.Tensor,  # [tokens, num_experts]
    k: int,
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's routing in its dense form.

    Returns:
      dispatch: [tokens, num_experts, capacity] one-hot dispatch mask
      combine:  [tokens, num_experts, capacity] combine weights
      aux_loss: load-balancing auxiliary loss (Switch-style)

    `route`'s softmax routing, expanded by `dense_masks`.
    """
    expert, slot, gate, aux_loss = route(router_logits, k, capacity)
    return (*dense_masks(expert, slot, gate, router_logits.shape[-1],
                         capacity), aux_loss)


_top_k_routing = top_k_routing


# (token, choice) pairs that chose one of the layer's held experts, kept
# and dropped: summed on the card while device spans record, read by
# `routed_assignments`.
_assigned: Dict[torch.device, torch.Tensor] = {}


def _count_assignments(mine: torch.Tensor, kept: torch.Tensor) -> None:
    acc = _assigned.get(kept.device)
    if acc is None:
        acc = _assigned[kept.device] = torch.zeros(
            2, dtype=torch.int64, device=kept.device)
    acc += torch.stack([kept.sum(), (mine & ~kept).sum()])


def routed_assignments() -> Dict[str, int]:
    """The held-expert assignments counted since the last read, {"kept",
    "dropped"}, added to `moe_routed_assignments_total`. Counting runs
    while device spans record (a step a profiler records) and reading
    waits for the card."""
    kept = dropped = 0
    for acc in _assigned.values():
        kept_t, dropped_t = acc.tolist()
        kept, dropped = kept + kept_t, dropped + dropped_t
        acc.zero_()
    if kept or dropped:
        counter = _assignments_counter()
        for fate, n in (("kept", kept), ("dropped", dropped)):
            if n:
                counter.inc(float(n), tags={"fate": fate})
    return {"kept": kept, "dropped": dropped}


@functools.lru_cache(maxsize=None)
def _assignments_counter():
    """`moe_routed_assignments_total`, made at its first read so that
    importing the layer starts no metrics flusher."""
    from ray_tpu_torch.util.metrics import Counter, get_or_create

    return get_or_create(
        Counter, "moe_routed_assignments_total",
        "(token, choice) pairs routed to an expert the layer holds, by "
        "fate: kept, or dropped past the expert's capacity",
        tag_keys=("fate",))


def _slot_tables(expert, slot, gate, lo: int, hi: int, capacity: int):
    """(slot_token, slot_gate), [(hi - lo) * capacity] each: the token each
    slot of the experts [lo, hi) holds (-1: empty) and its gate (0 where
    empty)."""
    k, tokens = expert.shape
    mine = (expert >= lo) & (expert < hi)
    kept = mine & (slot < capacity)
    if device_spans_on() and torch._C._current_graph_task_id() == -1:
        _count_assignments(mine, kept)  # not again in remat's recompute
    n_slots = (hi - lo) * capacity
    dest = torch.where(kept, (expert - lo) * capacity + slot,
                       n_slots).reshape(-1)  # the last entry: discarded
    tok = torch.arange(tokens, device=expert.device).expand(k, tokens)
    slot_token = torch.full((n_slots + 1,), -1, dtype=torch.int64,
                            device=expert.device)
    slot_token = slot_token.scatter(0, dest, tok.reshape(-1))[:n_slots]
    slot_gate = gate.new_zeros(n_slots + 1).scatter(
        0, dest, gate.reshape(-1))[:n_slots]
    return slot_token, slot_gate


def moe_layer(
    x: torch.Tensor,  # [tokens, d_model]
    router_w: torch.Tensor,  # [d_model, num_experts]
    expert_fn: Callable,  # (expert_params, [experts, capacity, d]) -> same
    expert_params,  # leaves with a leading experts axis (the held ones)
    k: int = 2,
    capacity_factor: float = 1.25,
    mesh=None,
    axis_name: str = "ep",
    router: str = "softmax",
    router_bias: Optional[torch.Tensor] = None,
    norm_topk_prob: bool = False,
    routed_scaling_factor: float = 1.0,
    experts_held: Optional[range] = None,
):
    """MoE layer routed by `route` and moved by index. Returns (out [T, D],
    aux_loss).

    `x` and `router_w` are whole on every rank. `experts_held` (a range of
    expert ids, all of them by default) are the experts this layer holds;
    `expert_params` hold this rank's block of them along `axis_name` of
    `mesh`. Each rank computes its experts' part of the output, and the
    parts are summed over the axis; the experts outside `experts_held`
    add nothing.
    """
    tokens, d_model = x.shape
    num_experts = router_w.shape[-1]
    capacity = max(1, int(capacity_factor * tokens * k / num_experts))
    held = range(num_experts) if experts_held is None else experts_held
    n = axis_size(mesh, axis_name)
    if len(held) % n:
        raise ValueError(f"{len(held)} experts do not split over "
                         f"{axis_name}={n}")
    lo = held.start + axis_index(mesh, axis_name) * (len(held) // n)
    hi = lo + len(held) // n

    # The device spans name the layer's parts in a profile and time them.
    with device_span("moe.routing") as sp:
        logits = sp.entry(x) @ router_w
        if router == "softmax" and top_k_routing is not _top_k_routing:
            # A replaced top_k_routing (the benchmark's routing witness,
            # portbench/controls.py) still sees every softmax routing.
            top_k_routing(logits.detach(), k, capacity)
        expert, slot, gate, aux_loss = route(
            logits, k, capacity, router, router_bias, norm_topk_prob,
            routed_scaling_factor)
        # This rank's gates and inputs feed only its part of the output:
        # the backward sums those gradients over the axis.
        gate = _comm.reduce_grad(gate, mesh, (axis_name,))
        slot_token, slot_gate = _slot_tables(expert, slot, gate, lo, hi,
                                             capacity)
        slot_gate, aux_loss = sp.exit(slot_gate, aux_loss)
    x = _comm.reduce_grad(x, mesh, (axis_name,))

    index = slot_token.clamp(min=0)
    with device_span("moe.dispatch") as sp:  # [E, C, D]
        rows = sp.entry(x).index_select(0, index)
        expert_in = sp.exit(torch.where((slot_token >= 0)[:, None], rows,
                                        0.0).view(hi - lo, capacity,
                                                  d_model))
    with device_span("moe.experts") as sp:
        expert_out = sp.exit(expert_fn(expert_params, sp.entry(expert_in)))
    with device_span("moe.combine") as sp:  # [T, D]
        y, g = sp.entry(expert_out, slot_gate)
        out = sp.exit(x.new_zeros((tokens, d_model)).index_add(
            0, index, y.reshape(-1, d_model) * g[:, None]))
    return _comm.all_reduce(out, mesh, (axis_name,)), aux_loss
