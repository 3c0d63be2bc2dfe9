"""Collectives over a ``torch.distributed`` process group, each an
``autograd.Function`` with its backward written out.

What the reference gets from GSPMD (a sharding constraint, and autodiff
through it) is spelt out here on plain ``torch.distributed`` calls:

- ``all_reduce_mean``: SUM all-reduce divided by the group's size, forward
  and backward (``lax.pmean`` and its transpose): SyncBN's moments.
- ``copy_to_group`` / ``gather_from_group``: Megatron's pair for a
  column-parallel layer.  The input enters as the identity and its gradient
  is SUM all-reduced (each rank's gradient covers only its output
  channels); the output channels are all-gathered and the gradient is
  sliced back (every rank holds the same downstream gradient, so a
  reduce-scatter SUM would be ``size`` times too large).  The same gather
  reassembles a sharded weight for a layer that runs replicated.
- ``gather_batch``: all-gather of the batch axis whose downstream runs on
  every rank with each rank's own loss, so the gradient is reduce-scattered
  (SUM): the Gather layer (gather_layer.cpp).

A group of one rank makes every function the identity up to copies, so a
world of one is bit-equal to no group at all.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return dist.get_world_size(group)


def group_rank(group) -> int:
    return dist.get_rank(group)


def _sum(x, group):
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


def _gather(x, dim: int, group):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _chunk(x, dim: int, group):
    return x.chunk(group_size(group), dim=dim)[group_rank(group)].contiguous()


class _AllReduceMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group) / group_size(group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group) / group_size(ctx.group), None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.dim, ctx.group), None, None


class _GatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, 0, group)

    @staticmethod
    def backward(ctx, g):
        return _chunk(_sum(g, ctx.group), 0, ctx.group), None


def all_reduce_mean(x, group):
    """Mean over the group's ranks; its gradient is the mean of theirs."""
    return _AllReduceMean.apply(x, group)


def copy_to_group(x, group):
    """The identity; the gradient is SUM all-reduced over the group."""
    return _CopyToGroup.apply(x, group)


def gather_from_group(x, dim: int, group):
    """Each rank's chunk concatenated along ``dim`` in rank order; the
    gradient is sliced back to the rank's chunk."""
    return _GatherFromGroup.apply(x, dim % x.ndim, group)


def gather_batch(x, group):
    """The batch axis all-gathered; the gradient is reduce-scattered (SUM)."""
    return _GatherBatch.apply(x, group)


def split_to_group(x, dim: int, group):
    """The rank's chunk of ``x`` along ``dim`` (autograd pads the gradient
    with zeros): the inverse of ``gather_batch``, the Scatter layer."""
    return x.chunk(group_size(group), dim=dim)[group_rank(group)]


def all_gather(x, dim: int, group):
    """All-gather with no gradient (outputs, state, snapshots)."""
    with torch.no_grad():
        return _gather(x, dim % max(x.ndim, 1), group)


def all_reduce_sum(x, group):
    """SUM all-reduce into a new tensor, with no gradient."""
    with torch.no_grad():
        return _sum(x, group)
