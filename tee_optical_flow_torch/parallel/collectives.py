"""The collectives of the trainer's ('data', 'model') mesh, as autograd
functions (port only: in the JAX package XLA inserts them from the
sharding annotations).

The loss convention, one for the whole port: rank r backpropagates its
share l_r = (B_r / B) * combined_loss(its rows), so that the global loss
is the sum of the shares over the data group, and the gradient of a
parameter is the sum of the ranks' gradients over the data group. The
ranks of one model group hold the same rows and compute the same loss;
each backpropagates it once, so a value that every rank of the model
group holds whole already carries its whole gradient there.

Under that convention (y the output, g its upstream gradient):

  all_reduce_sum(x, group)     y = sum_r x_r; g_x = sum_r g_r
      (a value summed over the data group, such as a batch norm's sums:
      every rank's share of the loss depends on every rank's x)
  copy_to_group(x, group)      y = x;         g_x = sum_r g_r
      (Megatron's f: a whole input entering a split product; each rank
      returns the gradient of its part)
  reduce_from_group(x, group)  y = sum_r x_r; g_x = g
      (Megatron's g: the partial products of a row-parallel layer; the
      sum is whole on every rank, and so is its gradient)
  gather_from_group(x, group)  y = [x_0, ..., x_{n-1}] along ``dim``;
                               g_x = g[block r]
      (a column-parallel output made whole: an all-reduce of the
      zero-padded blocks, which is exact)

Only all-reduce and broadcast are used: gloo has no CUDA all_gather.
Half-precision values are summed in float32. ``TALLY`` counts the calls,
bytes and host seconds of each kind since its last ``reset_tally()``
(the seconds are the all-reduces' own under gloo, which returns when the
sum is done; nccl's returns once the sum is queued).
"""

from __future__ import annotations

import time
from typing import List, Optional

import torch
import torch.distributed as dist


KINDS = ("sum", "copy", "reduce", "gather", "grads", "values", "broadcast")
TALLY = {k: {"calls": 0, "bytes": 0, "seconds": 0.0} for k in KINDS}


def reset_tally() -> None:
    for v in TALLY.values():
        v.update(calls=0, bytes=0, seconds=0.0)


def _tallied(kind: str, y: torch.Tensor, op) -> None:
    t0 = time.perf_counter()
    op(y)
    tally = TALLY[kind]
    tally["calls"] += 1
    tally["bytes"] += y.numel() * y.element_size()
    tally["seconds"] += time.perf_counter() - t0


def _all_reduce(y: torch.Tensor, group, kind: str) -> None:
    _tallied(kind, y, lambda t: dist.all_reduce(t, op=dist.ReduceOp.SUM,
                                                group=group))


def _sum(x: torch.Tensor, group, kind: str) -> torch.Tensor:
    """The sum over ``group`` of ``x`` (a new tensor; ``x`` unchanged)."""
    wide = x.dtype in (torch.float16, torch.bfloat16)
    y = x.detach().to(torch.float32 if wide else x.dtype).clone()
    _all_reduce(y, group, kind)
    return y.to(x.dtype) if wide else y


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group, "sum")

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group, "sum"), None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group, "copy"), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group, "reduce")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.width = dim, x.shape[dim]
        ctx.rank = dist.get_rank(group=group)
        return gather_blocks(x.detach(), group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.width, ctx.width), None, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``; the backward sums the upstream gradients."""
    return _AllReduceSum.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the backward sums the gradients over ``group``."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``; identity backward."""
    return _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, group, dim: int = -1
                      ) -> torch.Tensor:
    """The ranks' equal blocks joined along ``dim`` in rank order; the
    backward keeps this rank's block of the gradient."""
    return _GatherFromGroup.apply(x, group, dim % x.ndim)


def gather_blocks(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' equal blocks of ``x`` joined along ``dim`` (no autograd):
    every rank writes its block into zeros, then one sum over ``group``."""
    n, k = dist.get_world_size(group=group), dist.get_rank(group=group)
    shape = list(x.shape)
    width = shape[dim]
    shape[dim] = width * n
    full = torch.zeros(shape, dtype=x.dtype, device=x.device)
    full.narrow(dim, k * width, width).copy_(x)
    return _sum(full, group, "gather")


def sum_values(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (no autograd: metrics)."""
    return _sum(x, group, "values")


def _flat(tensors: List[torch.Tensor], op) -> None:
    """``op`` on one flat buffer per dtype of ``tensors``, copied back."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        op(flat)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def sum_flat(tensors: List[torch.Tensor], group) -> None:
    """Sum ``tensors`` over ``group`` in place, as one flat buffer per
    dtype (one all-reduce each)."""
    _flat(tensors, lambda f: _all_reduce(f, group, "grads"))


def broadcast_flat(tensors: List[torch.Tensor], src: int, group) -> None:
    """Global rank ``src``'s ``tensors`` on every rank of ``group``, in
    place, as one flat buffer per dtype (one broadcast each)."""
    _flat(tensors, lambda f: _tallied(
        "broadcast", f, lambda t: dist.broadcast(t, src=src, group=group)))


def broadcast_values(values: List[float], src: int = 0,
                     device: Optional[torch.device] = None) -> List[float]:
    """Global rank ``src``'s floats on every rank (float64, one
    broadcast over the world)."""
    t = torch.tensor(values, dtype=torch.float64, device=device)
    dist.broadcast(t, src=src)
    return t.tolist()
