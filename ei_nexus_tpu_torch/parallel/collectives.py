"""Differentiable collectives: the reductions XLA inserts into the JAX
package's sharded steps, written out as `torch.autograd.Function`s.

 - `all_reduce_sum`: the sum over a group forward, and the sum of the
   gradients backward (every rank's loss reads the global sum): the global
   BatchNorm statistics;
 - `copy_to_group` / `reduce_from_group`: the conjugate pair of tensor
   parallelism over the model group. A replicated input enters a
   head-sliced computation through `copy_to_group` (identity forward; its
   gradient, partial on each rank, summed backward), and the partial
   products leave through `reduce_from_group` (summed forward; the
   replicated gradient passed through backward);
 - `global_sum`: a sum over a group without gradient (a loss's count).

A None group is a group of one rank: each is then the identity.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist


def _summed(x: torch.Tensor, group: Any) -> torch.Tensor:
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return y


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group), None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_reduce_sum(x: torch.Tensor, group: Any) -> torch.Tensor:
    """The sum of `x` over `group`; backward, the sum of the gradients."""
    return x if group is None else _AllReduceSum.apply(x, group)


def copy_to_group(x: torch.Tensor, group: Any) -> torch.Tensor:
    """`x` unchanged; backward, the sum of the gradients over `group`."""
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group: Any) -> torch.Tensor:
    """The sum of `x` over `group`; backward, the gradient unchanged."""
    return x if group is None else _ReduceFromGroup.apply(x, group)


def global_sum(x: torch.Tensor, group: Any) -> torch.Tensor:
    """The sum of `x` over `group`, detached (no gradient flows)."""
    x = x.detach()
    return x if group is None else _summed(x, group)
