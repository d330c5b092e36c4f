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

The slab rule (``slab_bounds``): an axis of ``extent`` planes split
under an hourglass of ``levels`` stride-2 steps is cut into ``k =
ceil(extent / 2^levels)`` units of ``2^levels`` planes, of which only the
last may be short, and the units are spread over the ``n`` model
positions as ``np.array_split`` spreads them: contiguous slabs, the
first ``k mod n`` positions one unit more, and the positions from ``k``
on hold no plane when ``k < n``.  So every slab starts on a stride at
every level, only the last slab that holds planes can be short, and
beyond it lies the volume's edge: a halo that reaches past a short or an
empty neighbour is zeros, as GSPMD's padded split (and the unsplit
volume) has it.  At level ``l`` a short slab of ``r`` planes holds
``ceil(r / 2^l)``, and the slabs' planes sum to the whole extent's
``ceil(extent / 2^l)``, so the crops of ``layers._crop_to`` fall on the
last slab alone, as on the whole volume.  ``check_split`` refuses one
split only: a slab of whole units narrower than a halo its convs read
(a neighbour's halo would then reach past it into planes it does not
hold).  No model of the port reaches it: every hourglass has at least 2
levels, so units hold at least 4 planes, and the widest halo is 4
(the BEV_type2 / BEV_type3 prelude's k5 d2 conv).

An empty position takes part in every collective, forward and backward,
in the same order as the others: its layers make 0-plane outputs that
still depend on their (halo-widened) inputs, launch no kernel, and add
zeros to the sums (``model_sum``), ``-inf`` to the maxima (the caller's
``amax`` over no plane: ``slab_amax``) and nothing to a ``gather``.

Both exchanges of the rank form go through ``all_gather`` of the edge
planes in the model group (equal shapes whatever the slabs' lengths: a
slab shorter than a halo offers what it has and zeros beyond; ``gather``
pads the slabs to the widest and trims): gloo's ``send`` /
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
    over ``n`` model positions: ``ceil(extent / unit)`` units of ``unit``
    planes (the last may be short) spread as ``np.array_split`` spreads
    them, positions beyond the units empty (the module docstring)."""
    k = -(-extent // unit)
    return [min(extent, unit * (m * (k // n) + min(m, k % n)))
            for m in range(n + 1)]


def split_range(extent: int, mesh: Mesh, unit: int = 1) -> Tuple[int, int]:
    """(first, end) of this position's slab of an axis of ``extent``;
    first == end on a position that holds no plane."""
    b = slab_bounds(extent, mesh.n_model, unit)
    return b[mesh.model_index], b[mesh.model_index + 1]


def check_split(name: str, extent: int, mesh: Mesh, levels: int,
                halo: int = 1) -> None:
    """Raises if a slab of whole units of ``2^levels`` planes (any slab
    but the last that holds planes) is narrower than ``halo``, the widest
    halo the split convs read: a neighbour's halo would reach past it.
    Every other split runs: a short last unit, positions with no plane
    (the module docstring).  No model of the port reaches the refusal
    (units of at least 4 planes, halos of at most 4)."""
    b = slab_bounds(extent, mesh.n_model, 2 ** levels)
    widths = [hi - lo for lo, hi in zip(b, b[1:]) if hi > lo]
    narrow = min(widths[:-1], default=halo)
    if narrow < halo:
        raise ValueError(
            f"{name} = {extent} over {mesh.n_model} model positions gives "
            f"a slab of {narrow} planes, narrower than the {halo}-plane "
            "halo its convs read")


def slab_amax(x: torch.Tensor, axis: int) -> torch.Tensor:
    """``x.amax(axis, keepdim=True)``, ``-inf`` on a slab of no plane
    (its part of a ``model_max``)."""
    if x.shape[axis]:
        return x.amax(axis, keepdim=True)
    shape = list(x.shape)
    shape[axis] = 1
    return x.new_full(shape, float("-inf"))


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


def _edge(x: torch.Tensor, axis: int, first: bool, n: int):
    """The first (``first``) or last ``n`` planes of ``x`` along ``axis``,
    zeros beyond the slab's planes when it holds fewer."""
    L = x.shape[axis]
    have = min(n, L)
    part = x.narrow(axis, 0 if first else L - have, have)
    if have == n:
        return part
    shape = list(x.shape)
    shape[axis] = n - have
    zeros = x.new_zeros(shape)
    return torch.cat([part, zeros] if first else [zeros, part], dim=axis)


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, lo, hi, mesh):
        ctx.axis, ctx.lo, ctx.hi, ctx.mesh = axis, lo, hi, mesh
        n, m = mesh.n_model, mesh.model_index
        # each rank offers its first hi and last lo planes (zeros beyond a
        # slab shorter than that)
        edges = torch.cat([_edge(x, axis, True, hi),
                           _edge(x, axis, False, lo)], dim=axis)
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
        a, b = min(lo, L), min(hi, L)  # the planes of mine in each halo
        if m < n - 1:  # the next rank's lower halo ends with my last planes
            dx.narrow(axis, L - a, a).add_(
                parts[m + 1].narrow(axis, lo - a, a))
        if m > 0:  # the previous rank's upper halo starts with my first
            dx.narrow(axis, 0, b).add_(parts[m - 1].narrow(axis, lo, b))
        return dx, None, None, None, None


def halo_exchange(x: torch.Tensor, axis: int, lo: int, hi: int,
                  mesh: Mesh) -> torch.Tensor:
    """``x``'s slab along ``axis`` widened by the ``lo`` last planes of the
    previous model position and the ``hi`` first planes of the next one:
    [.., lo + L + hi, ..].  Zeros beyond the first and the last position,
    and beyond the planes of a neighbour that holds fewer (a short or an
    empty last slab: the volume's edge).  A one-process mesh checks at
    the meeting that no halo reaches past a slab of whole units; a
    process group relies on ``check_split``, which the models call before
    their first collective."""
    if lo == hi == 0:
        return x
    if mesh.local is not None:
        return mesh.local.halo(x, axis, lo, hi, mesh.rank)
    return _HaloExchange.apply(x, axis, lo, hi, mesh)


def model_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed over the model group, differentiably."""
    if mesh.local is not None:
        return mesh.local.sum(x, "model", mesh.rank)
    return AllReduceSum.apply(x, mesh.model_group)


def model_max(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the model group, detached
    (a position of no plane offers ``-inf``: ``slab_amax``)."""
    if mesh.local is not None:
        return mesh.local.max(x, mesh.rank)
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=mesh.model_group)
    return y
