"""The port's collectives, every one an `all_reduce`.

`all_reduce` and `broadcast` are the only gloo collectives that take CUDA
tensors, and NCCL refuses two ranks on one GPU, so a check with two ranks
sharing one card runs gloo; writing every collective as an `all_reduce`
lets that check, the CPU tests (gloo) and real multi-card runs (NCCL)
share this code. A gather is an `all_reduce` of a zero-filled buffer into
which each rank writes its own rows.

Megatron's two autograd functions carry tensor parallelism:
  * `copy_to_tp`: identity forward, `all_reduce` of the gradient over the
    tp group backward. It stands before every column-parallel product
    whose input is replicated, and on each replicated parameter that feeds
    such a product inside a fused kernel (K3's and K4's LayerNorm), so
    that their gradients are whole on every rank;
  * `reduce_from_tp`: `all_reduce` forward, identity backward. It completes
    a row-parallel product's partial sum; the bias (and a residual) are
    added once, after it.

`gather_last` (column shards -> the whole last axis) has the local slice
as its backward: its consumer is replicated or takes its input through
`copy_to_tp`, so the gradient that reaches it is already whole.

`STATS` counts the `all_reduce` calls and bytes; with `STATS["timed"]`
set, each call is bracketed by device synchronisations and its seconds
summed (a gloo reduce of CUDA tensors runs through the host, so on one
card that time says nothing of NCCL between cards).
"""
from __future__ import annotations

import time
from typing import List, Optional

import torch
import torch.distributed as dist

STATS = {"calls": 0, "bytes": 0, "seconds": 0.0, "timed": False}


def reset_stats() -> None:
    STATS.update(calls=0, bytes=0, seconds=0.0)


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` over `group` in place (no-op without a group)."""
    if group is None:
        return t
    STATS["calls"] += 1
    STATS["bytes"] += t.numel() * t.element_size()
    if STATS["timed"]:
        _sync(t)
        t0 = time.perf_counter()
        dist.all_reduce(t, group=group)
        _sync(t)
        STATS["seconds"] += time.perf_counter() - t0
    else:
        dist.all_reduce(t, group=group)
    return t


def all_reduce_many(tensors: List[torch.Tensor], group, bucket: int = 1 << 26) -> None:
    """Sum same-dtype tensors over `group` in place, through flat buckets of
    up to `bucket` elements (one collective a bucket)."""
    i = 0
    while i < len(tensors):
        j, n = i, 0
        while j < len(tensors) and (j == i or n + tensors[j].numel() <= bucket):
            n += tensors[j].numel()
            j += 1
        flat = torch.cat([t.reshape(-1) for t in tensors[i:j]])
        all_reduce_(flat, group)
        off = 0
        for t in tensors[i:j]:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
        i = j


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: Optional[torch.Tensor], mesh) -> Optional[torch.Tensor]:
    """Identity forward; the gradient summed over the tp group backward."""
    if x is None or mesh is None or mesh.tp == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _CopyToTP.apply(x, mesh.tp_group)
    return x


def reduce_from_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum of the tp ranks' partial results; identity backward."""
    if mesh is None or mesh.tp == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromTP.apply(x, mesh.tp_group)
    return all_reduce_(x.contiguous(), mesh.tp_group)


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, rank):
        n = x.shape[-1]
        ctx.rank, ctx.n = rank, n
        buf = x.new_zeros((*x.shape[:-1], n * size))
        buf[..., rank * n:(rank + 1) * n] = x
        return all_reduce_(buf, group)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n].contiguous(), None, None, None


def gather_last(x: torch.Tensor, mesh) -> torch.Tensor:
    """The tp ranks' column shards of `x`, joined in rank order on the
    last axis (an `all_reduce` of a zero-filled buffer)."""
    if mesh is None or mesh.tp == 1:
        return x
    return _GatherLast.apply(x, mesh.tp_group, mesh.tp, mesh.tp_rank)


def tp_slice_last(x: torch.Tensor, mesh) -> torch.Tensor:
    """This tp rank's contiguous slice of the last axis of a replicated
    tensor (the input of a row-parallel product), through `copy_to_tp`."""
    n = x.shape[-1] // mesh.tp
    return copy_to_tp(x, mesh)[..., mesh.tp_rank * n:(mesh.tp_rank + 1) * n]
