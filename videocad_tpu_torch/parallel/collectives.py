"""The collectives of the parallel layer, and the only module that calls
``torch.distributed``'s communication.

Under JAX, GSPMD inserts the collectives of a sharded program; in the port
they are placed by hand around the layers and the hand-written kernels
(Megatron's tensor-parallel regions):

  * :func:`copy_to_model`: identity forward, all-reduce backward: the
    replicated input of column-split products, whose gradient each model
    rank holds only a part of (once an input: an attention's query, key
    and value share one);
  * :func:`reduce_from_model`: all-reduce forward, identity backward: the
    partial sums of a row-split product;
  * :func:`gather_along`: the shards of a tensor concatenated along a dim
    in the forward, this rank's slice of the gradient in the backward: the
    column-split parameter head's logits, and a sharded weight that a
    fused kernel reads whole.

Beside them: the no-grad reductions of counters and loss denominators over
the data group (:func:`all_reduce`), the stop flag's global OR
(:func:`any_over`), a barrier, and the data-parallel gradients' summing
hook for DDP (:func:`sum_gradients_hook`).

A gather is an all-gather, except between ranks that share a card over
gloo, which gathers only host tensors: there it is an all-reduce of
zero-padded shards, about twice the bytes, and exact (a sum with zeros
keeps the shards' bits). With ``group`` None (one process) every function
is the identity.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``x`` reduced over ``group`` (a new tensor, no gradient): "sum" or
    "max"."""
    out = x.detach().clone()
    if group_size(group) > 1:
        dist.all_reduce(out, op={"sum": dist.ReduceOp.SUM,
                                 "max": dist.ReduceOp.MAX}[op], group=group)
    return out


def any_over(flag: bool, group, device) -> bool:
    """The global OR of a host flag over ``group``: an all-reduce max,
    which every rank of the group must call at the same point."""
    if group_size(group) == 1:
        return bool(flag)
    value = torch.tensor([1.0 if flag else 0.0], device=device)
    return bool(all_reduce(value, group, "max").item() > 0)


def barrier(group) -> None:
    """Wait for every rank of ``group``."""
    if group_size(group) > 1:
        dist.barrier(group=group)


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = group_size(group)
    if n == 1:
        return x
    if x.is_cuda and dist.get_backend(group) == "gloo":
        shape = list(x.shape)
        width = shape[dim]
        shape[dim] = width * n
        out = x.new_zeros(shape)
        out.narrow(dim, group_rank(group) * width, width).copy_(x)
        dist.all_reduce(out, group=group)
        return out
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def _slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = group_size(group)
    if n == 1:
        return x
    width = x.shape[dim] // n
    return x.narrow(dim, group_rank(group) * width, width).contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x.contiguous(), dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _slice(grad, ctx.dim, ctx.group), None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over the model group."""
    if group_size(group) == 1:
        return x
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the model group; identity backward."""
    if group_size(group) == 1:
        return x
    return _ReduceFromModel.apply(x, group)


def gather_along(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The model group's shards of ``x`` joined along ``dim`` in rank
    order; the backward keeps this rank's slice of the gradient."""
    if group_size(group) == 1:
        return x
    return _GatherAlong.apply(x, dim % x.dim(), group)


def gather_tensor(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """:func:`gather_along` without autograd: for checkpoints and the
    rollout's weights."""
    return _gather(x.detach().contiguous(), dim % x.dim(), group)


def shard_tensor(x: torch.Tensor, dim: int, rank: int, size: int
                 ) -> torch.Tensor:
    """Slice ``rank`` of ``size`` equal slices of ``x`` along ``dim`` (no
    communication)."""
    width = x.shape[dim] // size
    return x.narrow(dim, rank * width, width).contiguous()


def sum_gradients_hook(group: Optional[dist.ProcessGroup], bucket):
    """A DDP communication hook that sums the bucket over the data group.

    DDP's own hook divides by the group's size, which is the global mean
    only when every rank's loss is a mean over an equal share. The
    objective divides each rank's numerator by the global denominator
    instead (``train/objective.py``), so the gradients are summed."""
    buffer = bucket.buffer()
    fut = dist.all_reduce(buffer, group=group, async_op=True).get_future()
    return fut.then(lambda f: f.value()[0])
