"""Tensor parallelism: the collectives of the mesh's "model" axis.

In JAX a sharding constraint splits one axis of a volume over "model"
(``P("data", "model")`` on the plane-sweep volume's depth,
``P("data", None, None, "model", None)`` on the Vernier voxel's length)
and GSPMD partitions every op that reads it, inserting halo exchanges,
reductions and gathers.  The port writes those collectives out, each an
autograd function whose backward is its forward's adjoint, over the
model group of a process-group mesh (parallel/api.py):

* ``shard``: this rank's slab of a tensor every model rank holds whole
  (``narrow``, whose backward pads the gradient with zeros: the
  adjoint);
* ``gather``: the slabs of every model rank, concatenated; its backward
  sums the incoming gradients over the model group and keeps this
  rank's slab (a reduce-scatter);
* ``halo_exchange``: the slab widened by ``lo`` planes of the rank
  before and ``hi`` of the rank after, zeros beyond the outer ranks (the
  SAME padding); its backward returns each halo's gradient to the rank
  that owns the planes, which adds it;
* ``model_sum``: the sum over the model group (``AllReduceSum``, whose
  backward is an all-reduce too); ``model_max``: the maximum, no
  gradient (the softmax's shift).

The ranks of a model group hold equal contiguous slabs, rank ``m`` the
``m``-th: the split extent must be a multiple of ``n_model``, and of
``n_model x 2^levels`` under an hourglass of ``levels`` stride-2 steps
(``check_split``).

Both exchanges go through ``all_gather`` of the edge planes in the model
group: gloo's ``send`` / ``recv`` take CPU tensors only, and two ranks
sharing one GPU can only use gloo, whose ``all_gather`` takes CUDA
tensors (copied through the host).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from snvc_tpu_torch.parallel.api import AllReduceSum, Mesh


def split_range(extent: int, mesh: Mesh) -> Tuple[int, int]:
    """(first, end) of this rank's slab of an axis of ``extent``."""
    n = mesh.n_model
    if extent % n:
        raise ValueError(f"an extent of {extent} does not split over "
                         f"{n} model ranks")
    m = extent // n
    return m * mesh.model_index, m * (mesh.model_index + 1)


def check_split(name: str, extent: int, mesh: Mesh, levels: int) -> None:
    """Raises unless ``extent`` splits into slabs that stay whole at every
    stride of an hourglass of ``levels`` stride-2 steps: a multiple of
    ``n_model x 2^levels``."""
    unit = mesh.n_model * 2 ** levels
    if extent % unit:
        raise ValueError(
            f"{name} = {extent} must be a multiple of n_model x 2^levels = "
            f"{mesh.n_model} x {2 ** levels} = {unit}, so that each model "
            "rank's slab stays whole at every stride of its hourglass "
            "(uneven slabs are not ported)")


def shard(x: torch.Tensor, axis: int, mesh: Mesh) -> torch.Tensor:
    """This rank's slab of ``x`` (whole on every model rank) along
    ``axis``."""
    a, b = split_range(x.shape[axis], mesh)
    return x.narrow(axis, a, b - a)


def _all_gather(x: torch.Tensor, group, n: int):
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh, ctx.length = axis, mesh, x.shape[axis]
        return torch.cat(_all_gather(x, mesh.model_group, mesh.n_model),
                         dim=axis)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.model_group)
        m = ctx.mesh.model_index
        return g.narrow(ctx.axis, m * ctx.length, ctx.length), None, None


def gather(x: torch.Tensor, axis: int, mesh: Mesh) -> torch.Tensor:
    """The model group's slabs of ``x`` along ``axis``, in rank order: the
    whole tensor on every model rank."""
    return _Gather.apply(x, axis, mesh)


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, lo, hi, mesh):
        ctx.axis, ctx.lo, ctx.hi, ctx.mesh = axis, lo, hi, mesh
        L, n, m = x.shape[axis], mesh.n_model, mesh.model_index
        # each rank offers its first hi and last lo planes
        edges = torch.cat([x.narrow(axis, 0, hi), x.narrow(axis, L - lo, lo)],
                          dim=axis)
        parts = _all_gather(edges, mesh.model_group, n)
        zeros = x.new_zeros
        shape = list(x.shape)
        if m > 0:
            below = parts[m - 1].narrow(axis, hi, lo)
        else:
            below = zeros(shape[:axis] + [lo] + shape[axis + 1:])
        if m < n - 1:
            above = parts[m + 1].narrow(axis, 0, hi)
        else:
            above = zeros(shape[:axis] + [hi] + shape[axis + 1:])
        return torch.cat([below, x, above], dim=axis)

    @staticmethod
    def backward(ctx, g):
        axis, lo, hi, mesh = ctx.axis, ctx.lo, ctx.hi, ctx.mesh
        L = g.shape[axis] - lo - hi
        n, m = mesh.n_model, mesh.model_index
        # the halos' gradients, each to the rank that owns the planes
        parts = _all_gather(torch.cat([g.narrow(axis, 0, lo),
                                       g.narrow(axis, lo + L, hi)], dim=axis),
                            mesh.model_group, n)
        dx = g.narrow(axis, lo, L).clone()
        if m < n - 1:  # the next rank's lower halo is my last lo planes
            dx.narrow(axis, L - lo, lo).add_(parts[m + 1].narrow(axis, 0, lo))
        if m > 0:  # the previous rank's upper halo is my first hi planes
            dx.narrow(axis, 0, hi).add_(parts[m - 1].narrow(axis, lo, hi))
        return dx, None, None, None, None


def halo_exchange(x: torch.Tensor, axis: int, lo: int, hi: int,
                  mesh: Mesh) -> torch.Tensor:
    """``x``'s slab along ``axis`` widened by the ``lo`` last planes of the
    previous model rank and the ``hi`` first planes of the next one, zeros
    beyond the first and the last rank: [.., lo + L + hi, ..]."""
    if lo == hi == 0:
        return x
    L = x.shape[axis]
    if max(lo, hi) > L:
        raise ValueError(f"a halo of ({lo}, {hi}) planes is wider than the "
                         f"slab's {L}")
    return _HaloExchange.apply(x, axis, lo, hi, mesh)


def model_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed over the model group, differentiably."""
    return AllReduceSum.apply(x, mesh.model_group)


def model_max(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the model group, detached."""
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=mesh.model_group)
    return y
