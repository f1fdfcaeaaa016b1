"""The collectives of the mesh path, written on `all_reduce` and
`broadcast` alone, the two that gloo carries for CUDA tensors, so the
same code runs over NCCL on cards of their own, over gloo on ranks that
share one card, and over gloo on the CPU:

- `all_sum`: the sum over an axis. Reduced in f32: a bf16 or f16 input
  is widened first and rounded back once, on every backend; an integer
  input stays in its dtype (exact);
- `all_max`: the maximum over an axis (exact in any dtype);
- `all_gather`: each rank writes its tensor into its slot of a
  zero-filled [size, ...] buffer, and the buffer's sum over the axis is
  every rank's tensor (0 + x is x, so the gather is exact);
- `broadcast_object`: a picklable host object (a micro-batch of
  requests) from the axis' first rank;
- the autograd forms the train step needs: `sum_with_grad` (the sum
  forward and backward, for statistics over the data axis),
  `reduce_from_model` (the sum forward, identity backward: a Megatron
  row-parallel output) and `copy_to_model` (identity forward, the sum
  backward: the input of a column-parallel product).

An axis of size 1 calls nothing. Every rank of an axis must make the
same calls in the same order.
"""

from __future__ import annotations

import pickle
from typing import Any, Optional

import torch
import torch.distributed as dist

from multimodal_rare_disease_tpu_torch.parallel.mesh import Axis

_WIDEN = (torch.bfloat16, torch.float16)


def _reduce_(buf: torch.Tensor, axis: Axis) -> torch.Tensor:
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=axis.group)
    return buf


def all_sum(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """Σ over the axis of each rank's x (a new tensor, x's dtype)."""
    if axis is None or axis.size == 1:
        return x
    buf = x.detach().to(torch.float32 if x.dtype in _WIDEN else x.dtype,
                        copy=True).contiguous()
    return _reduce_(buf, axis).to(x.dtype)


def all_max(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """max over the axis of each rank's x (a new tensor, x's dtype)."""
    if axis is None or axis.size == 1:
        return x
    buf = x.detach().clone().contiguous()
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=axis.group)
    return buf


def all_gather(x: torch.Tensor, axis: Optional[Axis], dim: int = 0
               ) -> torch.Tensor:
    """Each rank's x, concatenated along `dim` in rank order."""
    if axis is None or axis.size == 1:
        return x
    return torch.cat(tuple(gather_stack(x, axis).unbind(0)), dim)


def gather_stack(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """[size, *x.shape]: every rank's x, stacked in rank order."""
    wide = torch.float32 if x.dtype in _WIDEN else x.dtype
    buf = torch.zeros((axis.size,) + tuple(x.shape), dtype=wide,
                      device=x.device)
    buf[axis.rank].copy_(x.detach())
    return _reduce_(buf, axis).to(x.dtype)


def broadcast_object(obj: Any, axis: Optional[Axis],
                     device: torch.device) -> Any:
    """The axis' first rank's `obj` on every rank of the axis (the
    others pass anything). `device`: where the bytes travel, the CPU for
    gloo, the rank's card for NCCL."""
    if axis is None or axis.size == 1:
        return obj
    src = dist.get_global_rank(axis.group, 0) \
        if axis.group is not None and axis.group != dist.group.WORLD else 0
    if axis.rank == 0:
        data = torch.frombuffer(bytearray(pickle.dumps(obj)),
                                dtype=torch.uint8).to(device)
        size = torch.tensor([data.numel()], dtype=torch.int64, device=device)
    else:
        size = torch.zeros(1, dtype=torch.int64, device=device)
    dist.broadcast(size, src=src, group=axis.group)
    if axis.rank != 0:
        data = torch.empty(int(size.item()), dtype=torch.uint8,
                           device=device)
    dist.broadcast(data, src=src, group=axis.group)
    if axis.rank == 0:
        return obj
    return pickle.loads(data.cpu().numpy().tobytes())


def object_device(axis: Optional[Axis], device: torch.device
                  ) -> torch.device:
    """The CPU for a gloo axis, the rank's device otherwise (NCCL moves
    only CUDA tensors)."""
    if axis is None or axis.size == 1:
        return torch.device("cpu")
    if dist.get_backend(axis.group) == "nccl":
        return device
    return torch.device("cpu")


class _SumWithGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_sum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return all_sum(g.contiguous(), ctx.axis), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_sum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_sum(g.contiguous(), ctx.axis), None


def sum_with_grad(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """Σ over the axis, whose gradient is the sum of each rank's
    gradient: the statistics of a batch split over the data axis."""
    if axis is None or axis.size == 1:
        return x
    return _SumWithGrad.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: Optional[Axis]
                      ) -> torch.Tensor:
    """Σ of the partial products over the model axis; every rank's
    gradient passes through unchanged."""
    if axis is None or axis.size == 1:
        return x
    return _ReduceFromModel.apply(x, axis)


def copy_to_model(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """x itself; its gradient is summed over the model axis (each rank
    holds the part that flows back through its shard)."""
    if axis is None or axis.size == 1 or not torch.is_grad_enabled():
        return x
    return _CopyToModel.apply(x, axis)
