"""Collectives with their gradients, over ``torch.distributed`` process groups.

GSPMD and ``shard_map`` insert the JAX package's collectives and
differentiate them (``psum`` transposes to a broadcast, ``ppermute`` to the
reverse permutation). Here each is explicit, and where a gradient flows
through one it is a ``torch.autograd.Function``:

  - ``copy_to_group`` / ``reduce_from_group``: Megatron's f and g pair for
    tensor parallelism. The first is the identity whose backward sums the
    partial input gradients of a column-parallel layer; the second sums a
    row-parallel layer's partial outputs, and its backward is the identity
    (every rank then computes the same thing, so its gradient is already
    whole);
  - ``gather_channels``: the channel slices of a column-parallel layer
    joined on every rank; the backward keeps this rank's slice of the
    (whole) gradient;
  - ``all_reduce_sum``: a sum over the group used by different work on each
    rank (the time-sharded InstanceNorm statistics); its backward sums the
    gradients too;
  - ``neighbor_exchange``: a tensor to the right neighbour and one to the
    left, for halos and shifts along a time-sharded axis (no wraparound:
    the first and last rank receive zeros); its backward sends the
    gradients back the way the values came.

Every function is the identity (or zeros from a missing neighbour) on a
group of one rank and does no communication there.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over ``group`` (no gradient)."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (no gradient)."""
    n = group_size(group)
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def local_slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's equal slice of ``x`` along ``dim``."""
    n = group_size(group)
    if n == 1:
        return x
    size = x.shape[dim] // n
    return x.narrow(dim, group_rank(group) * size, size)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return local_slice(g, ctx.group, ctx.dim).contiguous(), None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _ReduceFromGroup.apply(x, group)


def gather_channels(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    return x if group_size(group) == 1 else _GatherChannels.apply(x, group, dim)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _AllReduceSum.apply(x, group)


def _zeros(like: torch.Tensor) -> torch.Tensor:
    """Contiguous zeros of ``like``'s shape (a receive buffer)."""
    return torch.zeros(like.shape, dtype=like.dtype, device=like.device)


def _exchange(to_right, to_left, group):
    """Send ``to_right`` to rank + 1 and ``to_left`` to rank - 1 of
    ``group``; returns (from_left, from_right): what rank - 1 sent right
    and what rank + 1 sent left, zeros where there is no such rank. Either
    tensor may be None (nothing sent that way, None received)."""
    n, r = group_size(group), group_rank(group)
    from_left = None if to_right is None else _zeros(to_right)
    from_right = None if to_left is None else _zeros(to_left)
    ops = []

    def peer(i):
        return dist.get_global_rank(group, i)

    if to_right is not None:
        if r + 1 < n:
            ops.append(dist.P2POp(dist.isend, to_right.contiguous(), peer(r + 1), group))
        if r > 0:
            ops.append(dist.P2POp(dist.irecv, from_left, peer(r - 1), group))
    if to_left is not None:
        if r > 0:
            ops.append(dist.P2POp(dist.isend, to_left.contiguous(), peer(r - 1), group))
        if r + 1 < n:
            ops.append(dist.P2POp(dist.irecv, from_right, peer(r + 1), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_left, from_right


class _NeighborExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, to_right, to_left, group):
        ctx.group = group
        ctx.has = (to_right is not None, to_left is not None)
        return _exchange(to_right, to_left, group)

    @staticmethod
    def backward(ctx, g_from_left, g_from_right):
        # the value from the left came from that rank's to_right: its
        # gradient goes back left, and the one from the right goes back right
        has_r, has_l = ctx.has
        gl = g_from_left.contiguous() if has_r else None
        gr = g_from_right.contiguous() if has_l else None
        back_from_left, back_from_right = _exchange(gr, gl, ctx.group)
        return back_from_right, back_from_left, None


def neighbor_exchange(to_right, to_left, group):
    """(from_left, from_right), differentiable; see ``_exchange``."""
    if group_size(group) == 1:
        return (None if to_right is None else _zeros(to_right),
                None if to_left is None else _zeros(to_left))
    return _NeighborExchange.apply(to_right, to_left, group)
