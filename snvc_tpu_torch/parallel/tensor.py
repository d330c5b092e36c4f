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

A position of a one-process mesh (parallel/local.py) meets the other
positions at its ``Rendezvous`` instead, where each collective is plain
differentiable ops over every position's tensor.

The slab rule (``slab_bounds``): an axis split under an hourglass of
``levels`` stride-2 steps is cut into units of ``2^levels`` planes, and
its ``k`` units are spread over the ``n`` model positions as
``np.array_split`` spreads them: contiguous slabs, the first ``k mod n``
positions one unit more.  So every slab starts on a stride at every
level and no position crops (``layers._crop_to``): GSPMD pads an extent
that does not split evenly, the port gives its slabs unequal lengths.
``check_split`` refuses the splits that cannot run, each with its
reason: an extent that is not a whole number of units, a position with
no unit (an exchange across an empty neighbour), and a slab narrower
than a halo its convs read.

Both exchanges of the rank form go through ``all_gather`` of the edge
planes in the model group (equal shapes whatever the slabs' lengths;
``gather`` pads the slabs to the widest and trims): gloo's ``send`` /
``recv`` take CPU tensors only, and two ranks sharing one GPU can only
use gloo, whose ``all_gather`` takes CUDA tensors (copied through the
host).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist

from snvc_tpu_torch.parallel.api import AllReduceSum, Mesh


def slab_bounds(extent: int, n: int, unit: int = 1) -> List[int]:
    """The ``n + 1`` bounds of the slabs of an axis of ``extent`` planes
    over ``n`` model positions, in whole units of ``unit`` planes spread
    as ``np.array_split`` spreads them (see the module docstring)."""
    k = extent // unit
    return [unit * (m * (k // n) + min(m, k % n)) for m in range(n + 1)]


def split_range(extent: int, mesh: Mesh, unit: int = 1) -> Tuple[int, int]:
    """(first, end) of this position's slab of an axis of ``extent``."""
    b = slab_bounds(extent, mesh.n_model, unit)
    return b[mesh.model_index], b[mesh.model_index + 1]


def check_split(name: str, extent: int, mesh: Mesh, levels: int,
                halo: int = 1) -> None:
    """Raises unless ``extent`` splits over the model positions into
    slabs that stay whole at every stride of an hourglass of ``levels``
    stride-2 steps (whole units of ``2^levels`` planes), each with at
    least one unit and no narrower than ``halo`` planes (the widest halo
    the split convs read)."""
    n, unit = mesh.n_model, 2 ** levels
    if extent % unit:
        raise ValueError(
            f"{name} = {extent} is not a multiple of 2^levels = {unit}: "
            "the model's hourglass would crop it, and a slab could not "
            "start on a stride at every level")
    if extent // unit < n:
        raise ValueError(
            f"{name} = {extent} holds {extent // unit} units of 2^levels = "
            f"{unit} planes, fewer than the {n} model positions: a "
            "position would hold no plane, and an exchange would cross an "
            "empty neighbour")
    b = slab_bounds(extent, n, unit)
    narrow = min(b[m + 1] - b[m] for m in range(n))
    if narrow < halo:
        raise ValueError(
            f"{name} = {extent} over {n} model positions gives a slab of "
            f"{narrow} planes, narrower than the {halo}-plane halo its "
            "convs read")


def shard(x: torch.Tensor, axis: int, mesh: Mesh,
          unit: int = 1) -> torch.Tensor:
    """This position's slab of ``x`` (whole on every model position)
    along ``axis``."""
    a, b = split_range(x.shape[axis], mesh, unit)
    return x.narrow(axis, a, b - a)


def _all_gather(x: torch.Tensor, group, n: int):
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, bounds):
        ctx.axis, ctx.mesh, ctx.bounds = axis, mesh, bounds
        widest = max(b - a for a, b in zip(bounds, bounds[1:]))
        pad = list(x.shape)
        pad[axis] = widest - x.shape[axis]
        parts = _all_gather(torch.cat([x, x.new_zeros(pad)], dim=axis),
                            mesh.model_group, mesh.n_model)
        return torch.cat([p.narrow(axis, 0, b - a) for p, a, b in
                          zip(parts, bounds, bounds[1:])], dim=axis)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.model_group)
        m, b = ctx.mesh.model_index, ctx.bounds
        return g.narrow(ctx.axis, b[m], b[m + 1] - b[m]), None, None, None


def gather(x: torch.Tensor, axis: int, mesh: Mesh, extent: int,
           unit: int = 1) -> torch.Tensor:
    """The model group's slabs of ``x`` along ``axis`` (an axis of
    ``extent`` split in units of ``unit``: ``slab_bounds``), in position
    order: the whole tensor on every model position."""
    if mesh.local is not None:
        return mesh.local.gather(x, axis, mesh.rank)
    return _Gather.apply(x, axis, mesh,
                         slab_bounds(extent, mesh.n_model, unit))


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
    if mesh.local is not None:
        return mesh.local.halo(x, axis, lo, hi, mesh.rank)
    return _HaloExchange.apply(x, axis, lo, hi, mesh)


def model_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed over the model group, differentiably."""
    if mesh.local is not None:
        return mesh.local.sum(x, "model", mesh.rank)
    return AllReduceSum.apply(x, mesh.model_group)


def model_max(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the model group, detached."""
    if mesh.local is not None:
        return mesh.local.max(x, mesh.rank)
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=mesh.model_group)
    return y
