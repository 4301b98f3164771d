"""Collectives over one mesh axis, with the gradients the reference's SPMD
program has.

Under GSPMD a rank's backward is the transpose of its forward; here each
forward collective is a `torch.autograd.Function` whose backward is that
transpose, so `loss.backward()` on every rank yields the gradient of the
unsharded program for the rank's shards. Two kinds of axis differ in it:

  * a data axis (dp, fsdp, sp) splits the tokens, so ranks along it add
    different terms to the loss: a gather's transpose sums the ranks'
    gradients (reduce-scatter);
  * a model axis (tp, ep, pp) splits the work on the same tokens: a
    gather whose result every rank then uses alike transposes to taking
    the rank's own slice.

Every function returns its input unchanged at axis size 1 and sends
nothing.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.mesh import axis_index, axis_size

DATA_AXES = ("dp", "fsdp", "sp")

_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _live(mesh, axes: Iterable[str]) -> List[str]:
    return [a for a in axes if axis_size(mesh, a) > 1]


def _gather(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    _all_gather(out, x, group=group)
    return torch.cat(out.view((n,) + tuple(x.shape)).unbind(0), dim=dim)


def _reduce_scatter_dim(x: torch.Tensor, group, n: int,
                        dim: int) -> torch.Tensor:
    blocks = torch.stack(x.chunk(n, dim=dim))  # [n, *block]
    out = blocks.new_empty(blocks.shape[1:])
    _reduce_scatter(out, blocks.reshape((-1,) + tuple(out.shape[1:])),
                    group=group)
    return out


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, idx, dim, sum_grads):
        ctx.args = (group, n, idx, dim, sum_grads)
        return _gather(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        group, n, idx, dim, sum_grads = ctx.args
        if sum_grads:
            return _reduce_scatter_dim(g, group, n, dim), *([None] * 5)
        return g.chunk(n, dim=dim)[idx].contiguous(), *([None] * 5)


class _ReduceGrad(torch.autograd.Function):
    """Identity forward, all-reduce-sum backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllReduce(torch.autograd.Function):
    """All-reduce-sum forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split_dim, concat_dim):
        ctx.args = (group, n, split_dim, concat_dim)
        return _all_to_all(x, group, n, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, n, split_dim, concat_dim = ctx.args
        return _all_to_all(g, group, n, concat_dim, split_dim), None, None, \
            None, None


def _all_to_all(x, group, n, split_dim, concat_dim):
    if x.shape[split_dim] % n:
        raise ValueError(f"dimension {split_dim} of size {x.shape[split_dim]} "
                         f"does not split over {n} ranks")
    inp = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    return torch.cat(out.unbind(0), dim=concat_dim)


def all_gather(x: torch.Tensor, mesh, axes: Sequence[str], dim: int,
               sum_grads: bool) -> torch.Tensor:
    """Gather `x` along `dim` over `axes` (the first axis major, as in a
    partition spec). sum_grads: the backward reduce-scatters (sums the
    ranks' gradients) instead of taking the rank's slice — where ranks
    use the gathered tensor for different terms of the loss (different
    tokens over a data axis, or different heads)."""
    for axis in reversed(_live(mesh, axes)):
        x = _Gather.apply(x, mesh.get_group(axis), axis_size(mesh, axis),
                          axis_index(mesh, axis), dim, sum_grads)
    return x


def reduce_grad(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """The identity, whose backward sums the gradient over `axes`: where
    ranks along them use `x` for different terms of the loss."""
    for axis in _live(mesh, axes):
        x = _ReduceGrad.apply(x, mesh.get_group(axis))
    return x


def all_reduce(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Sum `x` over `axes` (the partial sums of a split product); the
    gradient passes through unchanged."""
    for axis in _live(mesh, axes):
        x = _AllReduce.apply(x, mesh.get_group(axis))
    return x


def all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """jax.lax.all_to_all(tiled=True): split `split_dim` into one block
    per rank, send block j to rank j, concatenate the blocks received
    along `concat_dim` in rank order. The backward is the inverse."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    return _AllToAll.apply(x, mesh.get_group(axis), n, split_dim,
                           concat_dim)


def shift(tensors: Sequence[torch.Tensor], mesh, axis: str,
          step: int = 1) -> List[torch.Tensor]:
    """Send each tensor to the rank `step` further along `axis` (around
    the ring) and return the ones received from the rank `step` behind.
    No autograd: the ring schedules write their own backward."""
    n = axis_size(mesh, axis)
    if n == 1:
        return list(tensors)
    group = mesh.get_group(axis)
    me = axis_index(mesh, axis)
    dst = dist.get_global_rank(group, (me + step) % n)
    src = dist.get_global_rank(group, (me - step) % n)
    sends = [t.contiguous() for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    ops = [dist.P2POp(dist.isend, t, dst, group) for t in sends]
    ops += [dist.P2POp(dist.irecv, t, src, group) for t in recvs]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recvs


def broadcast(x: torch.Tensor, mesh, axis: str, src: int) -> torch.Tensor:
    """`x` of the rank at coordinate `src` along `axis`, on every rank of
    the axis (in place into `x`'s storage)."""
    if axis_size(mesh, axis) == 1:
        return x
    group = mesh.get_group(axis)
    x = x.contiguous()
    dist.broadcast(x, src=dist.get_global_rank(group, src), group=group)
    return x


def sum_over(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """A plain (no autograd) sum over `axes`."""
    for axis in _live(mesh, axes):
        x = _all_reduce(x, mesh.get_group(axis))
    return x
