"""Collectives over one axis of the mesh, and the autograd operators that
tensor and sequence parallelism are built from.

JAX inserts these itself (GSPMD, ``shard_map``); the port writes them out.
A group of ``None`` is an axis of size 1, where every operator here is the
identity.

gloo reduces and broadcasts CUDA tensors, but gathers and sends only CPU
ones. ``all_gather_cat`` therefore gathers a CUDA tensor over gloo as one
``all_reduce`` of a zero buffer in which each rank writes its own slice:
exact, since every element has one non-zero term.

The autograd pairs follow Megatron-LM. A computation downstream of them
runs on every rank of the group alike (replicated), so each rank's loss
already holds the whole gradient of a replicated tensor:

- ``copy_to``: identity forward, gradient summed over the group backward
  (the input of a layer whose weight is split by output columns);
- ``reduce_from``: partial results summed forward, identity backward
  (the output of a layer whose weight is split by input rows);
- ``split_to``: the rank's chunk forward, chunks gathered backward;
- ``gather_from``: chunks gathered forward, the rank's chunk backward.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _is_gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over the group in place; returns it."""
    if group_size(group) > 1:
        dist.all_reduce(x, group=group)
    return x


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors of ``x``'s shape, concatenated along ``dim`` in
    rank order."""
    n = group_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    if x.is_cuda and _is_gloo(group):
        moved = x.movedim(dim, 0)
        buf = torch.zeros((n, *moved.shape), dtype=x.dtype, device=x.device)
        buf[group_rank(group)] = moved
        dist.all_reduce(buf, group=group)
        return buf.flatten(0, 1).movedim(0, dim)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _chunk(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x.chunk(group_size(group), dim=dim)[group_rank(group)].contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _chunk(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.group, ctx.dim), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.group, ctx.dim), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _ReduceFrom.apply(x, group)


def split_to(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x if group_size(group) == 1 else _SplitTo.apply(x, group, dim)


def gather_from(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x if group_size(group) == 1 else _GatherFrom.apply(x, group, dim)
