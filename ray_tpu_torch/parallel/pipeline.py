"""Pipeline parallelism: the GPipe microbatch schedule over a mesh axis.

Counterpart of ray_tpu/parallel/pipeline.py. Each rank of the "pp" axis
holds one stage (a contiguous block of the stacked layers). With S stages
and M microbatches the schedule runs S + M - 1 ticks: stage 0 takes
microbatch t at tick t, every stage runs its layers, activations move one
stage on, and the last stage emits microbatch t - (S - 1). Stage s is
busy on ticks [s, s + M); the reference also computes its idle ticks on
activations it then drops, which the port skips (they reach no output).
Bubble fraction (S - 1) / (S + M - 1).

The schedule is written out tick for tick rather than taken from
`torch.distributed.pipelining`, whose schedules order the work
differently. It is one autograd Function: torch's sends carry no
gradient, so the backward runs the ticks in reverse, each stage
differentiating its saved tick graph and sending the input's gradient
one stage back, so the ranks' sends pair up by construction.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from ray_tpu_torch.parallel import _comm
from ray_tpu_torch.parallel.mesh import axis_index, axis_size


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, spec, mesh, axis_name, xs, *leaves):
        S, s = axis_size(mesh, axis_name), axis_index(mesh, axis_name)
        M = xs.shape[0]
        ticks = S + M - 1
        params_d = [p.detach().requires_grad_(p.requires_grad)
                    for p in leaves]
        params = tree_unflatten(params_d, spec)
        state = torch.zeros_like(xs[0])
        outputs = torch.zeros_like(xs)
        saved = {}
        for t in range(ticks):
            if s <= t < s + M:
                # Stage 0 ingests microbatch t; the others take the
                # activation the previous stage sent.
                inp = xs[t] if s == 0 else state
                inp = inp.detach().requires_grad_(True)
                with torch.enable_grad():
                    out_t = stage_fn(params, inp)
                saved[t] = (inp, out_t)
                out = out_t.detach()
                if s == S - 1:
                    outputs[t - (S - 1)] = out
            else:
                out = torch.zeros_like(state)
            if t < ticks - 1:
                (state,) = _comm.shift([out], mesh, axis_name)
        ctx.saved = saved
        ctx.params_d = params_d
        ctx.args = (mesh, axis_name, S, s, M)
        # Only the last stage holds real outputs: every pp rank gets them.
        return _comm.broadcast(outputs, mesh, axis_name, S - 1)

    @staticmethod
    def backward(ctx, g_out):
        mesh, axis_name, S, s, M = ctx.args
        saved, params_d = ctx.saved, ctx.params_d
        want = [p for p in params_d if p.requires_grad]
        g_params = [torch.zeros_like(p) for p in want]
        g_xs = torch.zeros_like(g_out)
        g_recv = None
        for t in reversed(range(S + M - 1)):
            if t in saved:
                inp, out_t = saved.pop(t)
                g = g_out[t - (S - 1)] if s == S - 1 else g_recv
                grads = torch.autograd.grad(out_t, [inp] + want, g,
                                            allow_unused=True)
                g_in = grads[0]
                for acc, gp in zip(g_params, grads[1:]):
                    if gp is not None:
                        acc += gp
                if s == 0:
                    g_xs[t] = g_in
            else:
                g_in = torch.zeros_like(g_out[0])
            if t > 0:
                # Send the input's gradient one stage back; receive the
                # next stage's, the gradient of this tick-1 output.
                (g_recv,) = _comm.shift([g_in], mesh, axis_name, step=-1)
        ctx.saved = ctx.params_d = None
        # The microbatches are replicated over the axis and only stage 0
        # reads them: their gradient is the sum over the axis.
        g_xs = _comm.sum_over(g_xs, mesh, (axis_name,))
        it = iter(g_params)
        g_leaves = [next(it) if p.requires_grad else None for p in params_d]
        return (None, None, None, None, g_xs, *g_leaves)


def pipeline_stages(stage_fn: Callable, params_stacked,
                    x_microbatches: torch.Tensor, mesh,
                    axis_name: str = "pp") -> torch.Tensor:
    """Run a stage-stacked pipeline.

    Args:
      stage_fn: (stage_params, activation) -> activation of the same
        shape. One stage's compute on this rank's `params_stacked`.
      params_stacked: this rank's stage: a tensor or a nested dict of
        tensors whose leading axis holds its layers (stack_len / S of
        them), so a stage of several layers loops over them in stage_fn.
      x_microbatches: [M, microbatch, ...] input microbatches, the same
        on every rank of the axis.
      mesh: mesh with the `axis_name` axis of size S.

    Returns [M, microbatch, ...]: the final stage's outputs, on every rank
    of the axis. Differentiable in the microbatches and the parameters.
    """
    leaves, spec = tree_flatten(params_stacked)
    return _GPipe.apply(stage_fn, spec, mesh, axis_name, x_microbatches,
                        *leaves)
