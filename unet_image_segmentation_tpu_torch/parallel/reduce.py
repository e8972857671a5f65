"""Sums over a process group, with the gradients a sharded step needs.

Port of the JAX package's ``psum`` uses in its ``shard_map`` train step:

* :func:`all_sum`: the sum over the group's ranks, outside autograd (the
  fused chains' BatchNorm sums, the gradient sum);
* :func:`all_sum_grad`: the same, differentiable, its cotangent summed over
  the group too (``psum``'s transpose under ``check_vma=False``: the
  composed BatchNorm's moments over a mesh);
* :func:`replicated_sum`: the sum forward, the identity backward (JAX
  ``_psum_replicated_cotangent``: the head sums of a row-sharded step,
  whose loss every rank of the row computes alike from the summed values).

A group of None is one rank: each returns its input.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def all_sum(t: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """``t`` summed over the ranks of ``group``, in a new tensor."""
    if group is None:
        return t
    t = t.detach().contiguous().clone()
    dist.all_reduce(t, group=group)
    return t


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_sum(t, group)

    @staticmethod
    def backward(ctx, g):
        return all_sum(g, ctx.group), None


def all_sum_grad(t: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """:func:`all_sum` whose backward sums the cotangent over ``group``."""
    return t if group is None else _AllSum.apply(t, group)


def replicated_sum(t: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """:func:`all_sum` forward, the identity backward: the cotangent of the
    sum is every rank's alike, so each rank's part takes it once."""
    if group is None:
        return t
    return t + (all_sum(t, group) - t.detach())
