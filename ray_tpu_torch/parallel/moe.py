"""Mixture-of-experts with expert parallelism.

Counterpart of ray_tpu/parallel/moe.py: tokens are routed top-k with a
capacity factor and dispatched through one-hot dispatch and combine
tensors (the Switch/GShard formulation). Dispatch and combine stay the
reference's dense einsums, so every expert slot sums the same terms as
there. Routing, dispatch and combine take the dtype of `x` (the model
passes f32); `expert_fn` chooses its own: the model's
(models/transformer.py `_moe_experts`) takes the products in bf16 with
f32 accumulation where the expert weights are bf16 (a slot copies one
token of the bf16 model's activations, so its cast to bf16 is exact),
and in f32 for any other weights, as the reference's promoted einsums.
Under an "ep" mesh axis each rank holds E/ep experts: it runs its own
experts' slots and the expert outputs are summed over ep. Routing and
capacity are over the whole token set the layer is given, as under
GSPMD, so every rank routes every token alike.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.parallel import _comm
from ray_tpu_torch.parallel.mesh import axis_index, axis_size
from ray_tpu_torch.util.profiling import device_span


def top_k_routing(
    router_logits: torch.Tensor,  # [tokens, num_experts]
    k: int,
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k token->expert assignment with per-expert capacity.

    Returns:
      dispatch: [tokens, num_experts, capacity] one-hot dispatch mask
      combine:  [tokens, num_experts, capacity] combine weights
      aux_loss: load-balancing auxiliary loss (Switch-style)

    Each of the k passes takes the first maximum (as jnp.argmax does);
    a token's slot is its place among the pass's tokens for that expert
    in token order after the slots earlier passes filled; tokens past
    the capacity are dropped.
    """
    tokens, num_experts = router_logits.shape
    probs = torch.softmax(router_logits, dim=-1)

    # Load-balance loss: mean prob * mean assignment fraction per expert.
    top1 = torch.argmax(probs, dim=-1)
    me = probs.mean(dim=0)
    ce = F.one_hot(top1, num_experts).to(probs.dtype).mean(dim=0)
    aux_loss = num_experts * torch.sum(me * ce)

    dev = probs.device
    dispatch = torch.zeros((tokens, num_experts, capacity), dtype=probs.dtype,
                           device=dev)
    combine = torch.zeros_like(dispatch)
    remaining = probs
    fill = torch.zeros((num_experts,), dtype=torch.int64, device=dev)
    tok_idx = torch.arange(tokens, device=dev)
    for _ in range(k):
        choice = torch.argmax(remaining, dim=-1)  # [tokens]
        gate = remaining.gather(-1, choice[:, None])[:, 0]
        onehot = F.one_hot(choice, num_experts)
        # Position of each token within its chosen expert's queue.
        pos_in_expert = (torch.cumsum(onehot, dim=0) - 1) * onehot
        pos = pos_in_expert.sum(dim=-1) + fill[choice]
        keep = pos < capacity
        pos = pos.clamp(0, capacity - 1)
        keep_f = keep.to(probs.dtype)
        index = (tok_idx, choice, pos)
        dispatch = dispatch.index_put(index, keep_f, accumulate=True)
        combine = combine.index_put(index, keep_f * gate, accumulate=True)
        fill = fill + (onehot * keep[:, None]).sum(dim=0)
        # Mask out the chosen expert for the next pick.
        remaining = remaining * (1.0 - onehot.to(probs.dtype))
    return dispatch, combine, aux_loss


def moe_layer(
    x: torch.Tensor,  # [tokens, d_model]
    router_w: torch.Tensor,  # [d_model, num_experts]
    expert_fn: Callable,  # (expert_params, [experts, capacity, d]) -> same
    expert_params,  # leaves with a leading experts axis (this rank's E/ep)
    k: int = 2,
    capacity_factor: float = 1.25,
    mesh=None,
    axis_name: str = "ep",
):
    """Dense-dispatch MoE layer (GShard formulation). Returns (out [T, D],
    aux_loss).

    `x` and `router_w` are whole on every rank; `expert_params` hold this
    rank's block of the experts along `axis_name` of `mesh` (all of them
    without a mesh). Each rank dispatches to its experts only and the
    partial outputs are summed over the axis.
    """
    tokens, d_model = x.shape
    num_experts = router_w.shape[-1]
    capacity = max(1, int(capacity_factor * tokens * k / num_experts))

    # The device spans name the layer's parts in a profile and time them.
    with device_span("moe.routing") as sp:
        logits = sp.entry(x) @ router_w
        dispatch, combine, aux_loss = sp.exit(
            *top_k_routing(logits, k, capacity))

    n = axis_size(mesh, axis_name)
    if num_experts % n:
        raise ValueError(f"{num_experts} experts do not split over "
                         f"{axis_name}={n}")
    if n > 1:
        # This rank's experts. Their inputs and gates feed only its part
        # of the output: the backward sums those gradients over the axis.
        mine = slice(axis_index(mesh, axis_name) * (num_experts // n),
                     (axis_index(mesh, axis_name) + 1) * (num_experts // n))
        dispatch = dispatch[:, mine]
        combine = _comm.reduce_grad(combine, mesh, (axis_name,))[:, mine]
        x = _comm.reduce_grad(x, mesh, (axis_name,))

    with device_span("moe.dispatch") as sp:  # [E, C, D]
        expert_in = sp.exit(torch.einsum("tec,td->ecd", dispatch,
                                         sp.entry(x)))
    with device_span("moe.experts") as sp:
        expert_out = sp.exit(expert_fn(expert_params, sp.entry(expert_in)))
    with device_span("moe.combine") as sp:  # [T, D]
        out = sp.exit(torch.einsum("tec,ecd->td",
                                   *sp.entry(combine, expert_out)))
    return _comm.all_reduce(out, mesh, (axis_name,)), aux_loss
