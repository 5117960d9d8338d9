# -*- coding: utf-8 -*-
"""The few collectives the port runs, each in one call over its group.

Only ``all_reduce`` (a sum, or the maximum of :func:`any_over`),
``all_gather``, ``broadcast`` and ``reduce`` are used: gloo takes them on
CUDA tensors (staged through the host; ``reduce`` was probed on the card,
two ranks, float32, bfloat16 and uint8; ``tools/gloo_probe.py`` probes the
maximum too), so two ranks can share one card, and NCCL takes them on a
card each.  (The serving
front also sends each call's description with ``broadcast_object_list``.)
A group of one rank costs no call.  Many small tensors go as one flat buffer:
through the host every call has a fixed cost.

**Gradients over the mesh.**  One rule holds for every parameter and for
every tensor that several ranks compute alike (a replicated tensor): a
rank's backward yields its *share* of the gradient of the global loss, and
the train step sums the shares over the whole mesh, with no division
(:func:`sum_grads_`).  The collectives below are built so that the shares
add up to the gradient:

  * :func:`gather_rows` (the data axis): every rank's loss reads every row,
    so its backward sums the gradient over the group, then keeps this rank's
    block.
  * :func:`gather_blocks` (the model axis, the candidate slices' scores):
    every rank of the model group holds the same loss over the gathered
    scores, so its backward keeps this rank's block of the gradient and sums
    nothing; summing would multiply it by the model width.
  * :func:`all_sum` (the model axis, the mention means' message sums): the
    sum feeds every rank's replicated mention vertices, so its backward sums
    the gradient over the group.
  * :func:`any_over` (the model axis, MELHI's image gate over every
    candidate) carries no gradient: a gate is a comparison.

Every model computes its entity side over this rank's block of the
candidates and its mention side whole, replicated along the model axis
(DRIN, GHMFC offline and online, MELHI).  The replicated mention tower's
gradient reaches it only through this rank's block of the scores (the
score gather's backward keeps the block), so each rank holds the share of
its block, and the sum over the mesh is the whole gradient; a parameter
that both towers read (the online model's BERT, MELHI's image map) sums
both towers' shares alike.  A model whose compute is replicated along the
model axis as a whole (the model axis does not divide its candidate or
sentence dim: ``train.trainer.candidate_split``) holds the whole gradient on
each of its ``n_model`` ranks: its share is the gradient of the loss over
``n_model`` (the trainer scales it).  One step never mixes the two rules.
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


class _GatherBlocks(torch.autograd.Function):
    """Forward: the group's blocks concatenated along ``dim`` in ``order``.
    Backward: this rank's block of the gradient, with no sum: every rank of
    the group holds the same loss over the gathered tensor, so each already
    holds the whole gradient of its own block."""

    @staticmethod
    def forward(ctx, x, group, order, dim):
        ctx.dim, ctx.n = dim, x.shape[dim]
        me = dist.get_rank(group)
        ctx.index = me if order is None else list(order).index(me)
        parts = [torch.empty_like(x) for _ in range(group_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts if order is None else [parts[k] for k in order], dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None, None


def gather_blocks(x: torch.Tensor, group, order=None, dim: int = 1) -> torch.Tensor:
    """This rank's block ``x`` -> the group's blocks concatenated along
    ``dim`` in ``order`` (the group ranks in block order); differentiable
    (:class:`_GatherBlocks`: the backward keeps this rank's block)."""
    if group_size(group) == 1:
        return x
    return _GatherBlocks.apply(x, group, order, dim)


class _AllSum(torch.autograd.Function):
    """Forward: the sum of ``x`` over the group.  Backward: the sum of the
    gradient over the group: every rank's loss reads the sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, every rank receiving the same bits;
    differentiable (:class:`_AllSum`)."""
    if group_size(group) == 1:
        return x
    return _AllSum.apply(x, group)


def any_over(flag: torch.Tensor, group) -> torch.Tensor:
    """The logical OR of the bool tensor ``flag`` over ``group``, every rank
    receiving the same bits; no gradient.  One ``all_reduce`` of the maximum
    of a uint8 copy: no float is reduced."""
    if group_size(group) == 1:
        return flag
    x = flag.detach().to(torch.uint8).contiguous()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x.bool()


def sum_grads_(params: Sequence[torch.nn.Parameter], group, extra: torch.Tensor):
    """Sum the gradients of ``params`` over ``group`` in place, and the 0-d
    float32 ``extra`` (the loss's share) with them, as one flat buffer;
    returns the sum of ``extra``.  Each rank holds its share of the gradient
    (the module's rule), so the sum is the gradient.  Every rank receives
    the same bits.  Parameters without a gradient are left out: every rank
    runs the same graph, so every rank leaves out the same ones."""
    if group_size(group) == 1:
        return extra
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads] + [extra.reshape(1).to(torch.float32)])
    dist.all_reduce(flat, group=group)
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


def reduce_scatter_exact_(tensors: Sequence[torch.Tensor], group, order=None) -> list:
    """The sum over ``group`` of tensors of which at most one rank holds a
    nonzero element at every position (as :func:`sum_exact_`), each rank
    receiving only its block: every tensor is [n * k, ...], n blocks along
    dim 0, and the rank at block index i (``order``: the group ranks in
    block order; group-rank order by default) receives block i of each,
    [k, ...].  The bytes are summed as uint8, so no float is rounded.

    A reduce-scatter built of ``reduce`` calls, block i reduced onto its
    owner in place: gloo's ``reduce_scatter_tensor`` clones its whole input
    before it sums it (``tools/gloo_probe.py`` reads the copy), which on a
    gathered table of ~1.4 GB doubles the gather's memory.  ``reduce``
    stages through the host without a copy on the device.  The inputs are
    overwritten, and each result is a view of its input's block."""
    n = group_size(group)
    if n == 1:
        return list(tensors)
    import torch.distributed as dist

    me = dist.get_rank(group)
    owners = list(range(n)) if order is None else list(order)
    out = []
    for t in tensors:
        blocks = t.contiguous().reshape(n, -1).view(torch.uint8)
        for i, owner in enumerate(owners):
            dst = owner if group is None else dist.get_global_rank(group, owner)
            dist.reduce(blocks[i], dst, group=group)
        mine = blocks[owners.index(me)].view(t.dtype)
        out.append(mine.view((t.shape[0] // n,) + tuple(t.shape[1:])))
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
