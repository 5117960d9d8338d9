# -*- coding: utf-8 -*-
"""The few collectives the port runs, each in one call over its group.

Only ``all_reduce``, ``all_gather`` and ``broadcast`` are used: gloo takes
them on CUDA tensors (staged through the host), so two ranks can share one
card, and NCCL takes them on a card each.  A group of one rank costs no
call.  Many small tensors go as one flat buffer: through the host every call
has a fixed cost.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return dist.get_world_size(group) if group is not None or dist.is_initialized() else 1


def _gather(x: torch.Tensor, group, order=None) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts if order is None else [parts[k] for k in order])


class _GatherRows(torch.autograd.Function):
    """Forward: the group's row blocks concatenated in block order.
    Backward: the whole gradient summed over the group, then this rank's
    block: every rank's loss reads every row, and a row's owner receives the
    gradient of all of them."""

    @staticmethod
    def forward(ctx, x, group, order):
        ctx.group, ctx.n = group, x.shape[0]
        me = dist.get_rank(group)
        ctx.index = me if order is None else list(order).index(me)
        return _gather(x, group, order)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.index * ctx.n:(ctx.index + 1) * ctx.n], None, None


def gather_rows(x: torch.Tensor, group, order=None) -> torch.Tensor:
    """[b, ...] on each rank of ``group`` -> the group's [n * b, ...], the
    blocks in ``order`` (the group ranks in block order; group-rank order by
    default); differentiable (:class:`_GatherRows`)."""
    if group_size(group) == 1:
        return x
    return _GatherRows.apply(x, group, order)


def sum_grads_(params: Sequence[torch.nn.Parameter], group, extra: torch.Tensor,
               divide: int = 1):
    """Sum the gradients of ``params`` over ``group`` in place, and the 0-d
    float32 ``extra`` (the loss) with them, as one flat buffer, divided by
    ``divide``; returns the result for ``extra``.  Every rank receives the
    same bits.  Parameters without a gradient are left out: every rank runs
    the same graph, so every rank leaves out the same ones."""
    if group_size(group) == 1:
        return extra
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads] + [extra.reshape(1).to(torch.float32)])
    dist.all_reduce(flat, group=group)
    if divide != 1:
        flat /= divide
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return flat[-1]


def sum_exact_(tensors: Sequence[torch.Tensor], group) -> list:
    """The sum over ``group`` of tensors of which at most one rank holds a
    nonzero element at every position, bit for bit and in one call: the
    bytes of all of them are summed as uint8 (a byte plus zero bytes is that
    byte), so every dtype travels in one buffer and no float is rounded."""
    if group_size(group) == 1:
        return list(tensors)
    flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in tensors])
    dist.all_reduce(flat, group=group)
    out, offset = [], 0
    for t in tensors:
        n = t.numel() * t.element_size()
        out.append(flat[offset:offset + n].view(t.dtype).view(t.shape))
        offset += n
    return out


def broadcast_(tensors: Sequence[torch.Tensor], src: int, group) -> None:
    """Overwrite ``tensors`` on every rank of ``group`` with global rank
    ``src``'s, one call a dtype."""
    if group_size(group) == 1:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, src, group=group)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
