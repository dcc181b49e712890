"""Differentiable collectives over one mesh axis.

Counterparts of `jax.lax.psum`, `all_gather(tiled=True)`, `ppermute` (the
ring shift), `pmin` / `pmax` and `pmean` inside the JAX package's
`shard_map` steps. Each is a `torch.autograd.Function` whose backward is
the exact transpose of its forward:

    psum        y_i = sum_j x_j            dx_j = sum_i dy_i (a psum)
    all_gather  y_i = concat_j x_j         dx_j = (sum_i dy_i)[block j]
    ring_shift  y_{i+1} = x_i              dx_i = dy_{i+1} (the shift back)
    pmax, pmin  y_i = max_j x_j            dx_j = (sum_i dy_i) where x_j == y

With exact transposes, a backward from a loss that every rank holds
replicated gives each rank the gradient of (world size x loss) with
respect to its copy of the parameters; `Trainer` sums the copies over the
world and divides by its size, which is the single-device gradient.

They are built from `all_reduce` and `all_gather`, and point-to-point
sends for the ring: gloo has no `reduce_scatter` or `all_to_all` on CUDA
tensors. gloo sends and receives host memory only, so under gloo the ring
shift stages CUDA tensors through host copies (`stages_through_host`);
every other collective takes them as they are. On an axis of size 1, and
with no axis (None: a module that is not graph-parallel), each is the
identity.

Under nccl every collective here, the ring's sends and receives included,
is enqueued on the card and can be captured into a CUDA graph with the
kernels of a step; under gloo they run on the host and cannot.
`captures_collectives(mesh)` tells the two apart for a trainer's steps.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from typing import Optional

from matten_tpu_torch.parallel.sharding import Axis, Mesh

__all__ = ["psum", "pmean", "all_gather", "ring_shift", "pmax", "pmin", "stages_through_host",
           "captures_collectives"]


def _all_reduce(x: torch.Tensor, axis: Axis, op=dist.ReduceOp.SUM) -> torch.Tensor:
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=axis.group)
    return y


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.rows = axis, x.shape[0]
        x = x.detach().contiguous()
        parts = [torch.empty_like(x) for _ in range(axis.size)]
        dist.all_gather(parts, x, group=axis.group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis).narrow(0, ctx.axis.index * ctx.rows, ctx.rows), None


def stages_through_host(x: torch.Tensor, axis: Axis) -> bool:
    """Whether `ring_shift` copies x through the host: CUDA tensors under
    gloo, whose point-to-point transport reads host memory only."""
    return x.is_cuda and axis.group is not None and dist.get_backend(axis.group) == "gloo"


def captures_collectives(mesh: Optional[Mesh]) -> bool:
    """Whether a CUDA graph can capture the collectives of a step on `mesh`:
    every group a step uses is nccl's, the world's (the gradient
    all-reduce) and each axis's of more than one rank. gloo's collectives
    run on the host, and its ring shift stages through host memory, so a
    mesh with a gloo step group runs its steps eagerly. No mesh, or one of
    one rank, has no collectives. `Mesh.barrier`'s host group is never in
    a step."""
    if mesh is None or mesh.size == 1:
        return True
    groups = [None] + [a.group for a in (mesh.data, mesh.graph) if a.group is not None]
    return all(dist.get_backend(g) == "nccl" for g in groups)


def _shift(x: torch.Tensor, axis: Axis, step: int) -> torch.Tensor:
    """Send x to the rank `step` places on along the axis and return what
    the rank `step` places back sent."""
    n, i = axis.size, axis.index
    send = x.detach().contiguous()
    staged = stages_through_host(send, axis)
    if staged:
        send = send.cpu()
    recv = torch.empty_like(send)
    ops = [
        dist.P2POp(dist.isend, send, axis.ranks[(i + step) % n], group=axis.group),
        dist.P2POp(dist.irecv, recv, axis.ranks[(i - step) % n], group=axis.group),
    ]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(x.device) if staged else recv


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _shift(x, axis, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.axis, -1), None


class _PExtreme(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, op):
        ctx.axis = axis
        y = _all_reduce(x, axis, op)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return _all_reduce(g, ctx.axis) * (x == y).to(g.dtype), None, None


def _identity(axis: Optional[Axis]) -> bool:
    return axis is None or axis.size == 1


def psum(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """Sum over the axis, the same result on every rank of it."""
    return x if _identity(axis) else _PSum.apply(x, axis)


def pmean(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    return x if _identity(axis) else _PSum.apply(x, axis) / axis.size


def all_gather(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """Every rank's x along dim 0, in axis order (`all_gather(tiled=True)`)."""
    return x if _identity(axis) else _AllGather.apply(x, axis)


def ring_shift(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """x passed one rank on around the axis: rank i gets rank i-1's
    (`ppermute` with the permutation i -> i+1)."""
    return x if _identity(axis) else _RingShift.apply(x, axis)


def pmax(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    return x if _identity(axis) else _PExtreme.apply(x, axis, dist.ReduceOp.MAX)


def pmin(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    return x if _identity(axis) else _PExtreme.apply(x, axis, dist.ReduceOp.MIN)
