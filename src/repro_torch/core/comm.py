"""Collectives of the port's multi-device paths, over ``torch.distributed``.

Every collective of parfor, the sharded train step and the sharded
checkpoints goes through this module, which

counts each call and its bytes by op (:data:`STATS`; the chip smoke run
reads collective calls and bytes per step from it), and hands every tensor
to the backend on its own device.

Nothing is staged through the host: gloo takes CUDA tensors for every op
used here (``all_reduce`` sum and max, ``all_gather_into_tensor``,
``reduce_scatter_tensor``, float32 and bfloat16; it copies them through the
host inside the call), ``tools/gloo_cuda_probe.py`` on an NVIDIA H100 80GB
HBM3 at 700.00 W with torch 2.11.0+cu128, where a copy to the host and back
around the op was 1.55-1.98x slower than handing gloo the CUDA tensor.
NCCL takes every op on CUDA tensors.

:class:`AllGatherDim` is the FSDP parameter gather as an autograd function:
its forward all-gathers the shards along one dim, its backward
reduce-scatters the full gradient back to this rank's block, summing over
the ranks in the gradient's dtype (under sequence parallelism, also the
gather of a layer's sequence shards). :class:`AllReduceMean` is the mean
over the ranks with its gradient (the MoE load-balance statistics of a
train step over a data mesh).

The model axis (tensor, sequence and expert parallelism) uses Megatron's
conjugate pairs, each over the model group: :class:`CopyToGroup`
(identity forward, all-reduce backward: where a tensor every rank holds
enters per-shard work) and :class:`ReduceFromGroup` (all-reduce forward,
identity backward: the partial sums of a row-parallel product); under
sequence parallelism :class:`AllGatherDim` and :class:`ReduceScatterDim`
(reduce-scatter forward, all-gather backward) in their places. Where every
rank runs the same work on a gathered tensor, :class:`AllGatherSlice`
(all-gather forward, this rank's block of the gradient backward) and
:class:`SliceDim` (this rank's block forward, all-gather backward). Each
collective over a group of one rank is skipped and not counted.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Dict

import torch
import torch.distributed as dist

# op -> calls, op -> bytes of the tensor each rank contributes, and op ->
# bytes a rank's link carries under the reference's per-chip convention
# (``repro/launch/hlo_analysis.py``: an all-gather its result, an
# all-reduce twice its result, a reduce-scatter its result times the group)
STATS: Dict[str, Counter] = {"calls": Counter(), "bytes": Counter(), "traffic": Counter()}
_TRAFFIC = {"all_gather": lambda n, world: n * world, "all_reduce": lambda n, world: 2 * n,
            "reduce_scatter": lambda n, world: n}


def reset_stats() -> None:
    for c in STATS.values():
        c.clear()


def _count(op: str, t: torch.Tensor, world: int) -> None:
    nbytes = t.numel() * t.element_size()
    STATS["calls"][op] += 1
    STATS["bytes"][op] += nbytes
    STATS["traffic"][op] += _TRAFFIC[op](nbytes, world)


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclass(frozen=True)
class TraceGroup:
    """A group of ``size`` ranks seen from rank ``rank``, where no process
    group exists: the collectives of this module count their calls and
    bytes over it and send nothing."""

    size: int
    rank: int = 0

    def __post_init__(self):
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} is not in a group of {self.size}")


def world_size(group=None) -> int:
    """The ranks of ``group`` (a process group, None for the default one,
    or a :class:`TraceGroup`)."""
    return group.size if isinstance(group, TraceGroup) else dist.get_world_size(group)


def rank_in(group=None) -> int:
    """This rank's index in ``group``."""
    return group.rank if isinstance(group, TraceGroup) else dist.get_rank(group)


def all_reduce_(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """``t`` reduced over ``group`` in place (``op``: sum | max)."""
    world = world_size(group)
    if world == 1:
        return t
    _count("all_reduce", t, world)
    if not isinstance(group, TraceGroup):
        dist.all_reduce(t, op=_REDUCE_OPS[op], group=group)
    return t


def all_gather_dim(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order."""
    world = world_size(group)
    if world == 1:
        return t
    t = t.contiguous()
    _count("all_gather", t, world)
    # flat buffers: backends split the output's first dim into the ranks' parts
    if isinstance(group, TraceGroup):
        flat = t.reshape(-1).repeat(world)
    else:
        flat = torch.empty(world * t.numel(), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(flat, t.reshape(-1), group=group)
    out = flat.view(world, *t.shape)
    if dim == 0:
        return out.reshape(world * t.shape[0], *t.shape[1:])
    return out.movedim(0, dim).reshape(*t.shape[:dim], world * t.shape[dim], *t.shape[dim + 1:])


def reduce_scatter_dim(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The sum over ranks of ``t``, split along ``dim``: this rank's block."""
    world = world_size(group)
    if world == 1:
        return t
    n = t.shape[dim] // world
    if n * world != t.shape[dim]:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split {world} ways")
    blocks = t.unflatten(dim, (world, n)).movedim(dim, 0).contiguous()
    _count("reduce_scatter", blocks, world)
    if isinstance(group, TraceGroup):
        return blocks[group.rank].clone()
    out = torch.empty(blocks[0].numel(), dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, blocks.reshape(-1), group=group)
    return out.view(blocks.shape[1:])


class AllGatherDim(torch.autograd.Function):
    """``all_gather_dim`` whose backward is the reduce-scatter of the
    gradient (summed over the ranks in the gradient's dtype)."""

    @staticmethod
    def forward(ctx, shard, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(shard, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_dim(grad, ctx.dim, ctx.group), None, None


class AllReduceMean(torch.autograd.Function):
    """The mean of ``t`` over the ranks. Every rank's loss reads the mean,
    so its gradient is the mean over the ranks of the gradients reaching
    it (each rank's loss already weighted by its share)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(t.detach().clone(), group=group).div_(world_size(group))

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), group=ctx.group).div_(world_size(ctx.group)), None


def block_of(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """This rank's block of ``t`` split evenly along ``dim`` over ``group``
    (a contiguous copy)."""
    world = world_size(group)
    n = t.shape[dim] // world
    if n * world != t.shape[dim]:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split {world} ways")
    return t.narrow(dim, rank_in(group) * n, n).contiguous()


class CopyToGroup(torch.autograd.Function):
    """Identity forward; backward, the gradient summed over the group. A
    tensor that every rank of the group holds whole enters work that each
    rank does on its own shard: each rank's gradient is a part of the
    whole one."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), group=ctx.group), None


class ReduceFromGroup(torch.autograd.Function):
    """Forward, the sum over the group (a row-parallel product's partial
    sums); backward, identity: every rank receives the whole gradient."""

    @staticmethod
    def forward(ctx, t, group):
        return all_reduce_(t.contiguous().clone(), group=group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class ReduceScatterDim(torch.autograd.Function):
    """``reduce_scatter_dim`` whose backward all-gathers the gradient: a
    row-parallel product's partial sums leaving for this rank's sequence
    shard."""

    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter_dim(t, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return all_gather_dim(grad, ctx.dim, ctx.group), None, None


class AllGatherSlice(torch.autograd.Function):
    """``all_gather_dim`` for work every rank of the group repeats in full:
    each rank's gradient is already the whole one, so the backward takes
    this rank's block of it and sums nothing."""

    @staticmethod
    def forward(ctx, shard, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(shard, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return block_of(grad, ctx.dim, ctx.group), None, None


class SliceDim(torch.autograd.Function):
    """This rank's block of a tensor every rank of the group holds whole
    (forward, no collective); the backward all-gathers the blocks'
    gradients into the whole one."""

    @staticmethod
    def forward(ctx, full, dim, group):
        ctx.dim, ctx.group = dim, group
        return block_of(full, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return all_gather_dim(grad, ctx.dim, ctx.group), None, None
