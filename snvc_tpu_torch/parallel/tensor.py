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
* ``halo_exchange``: the slab widened by the ``lo`` planes below it and
  the ``hi`` above it, from as many ranks as they reach, zeros past the
  volume's ends (the SAME padding); its backward returns each halo
  plane's gradient to the rank that owns the plane, which adds it;
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
beyond it lies the volume's edge: a halo that reaches past the last
slab that holds planes is zeros, as GSPMD's padded split (and the
unsplit volume) has it.  At level ``l`` a short slab of ``r`` planes
holds ``ceil(r / 2^l)``, and the slabs' planes sum to the whole extent's
``ceil(extent / 2^l)``, so the crops of ``layers._crop_to`` fall on the
last slab alone, as on the whole volume.  Every split runs: a halo wider
than a neighbour's slab takes its planes from the slabs beyond it
(``halo_sources``), as GSPMD's halo exchange would.

An empty position takes part in every collective, forward and backward,
in the same order as the others: its layers make 0-plane outputs that
still depend on their (halo-widened) inputs, launch no kernel, and add
zeros to the sums (``model_sum``), ``-inf`` to the maxima (the caller's
``amax`` over no plane: ``slab_amax``) and nothing to a ``gather``.

Both exchanges of the rank form go through ``all_gather`` in the model
group, of equal shapes whatever the slabs' lengths: a rank offers its
first ``hi`` and last ``lo`` planes (zeros beyond a slab shorter than
that) and its length, which tells the others which planes are real
(one host sync a halo exchange); ``gather`` pads the slabs to the widest
and trims.  Gloo's ``send`` / ``recv`` take CPU tensors only, and two
ranks sharing one GPU can only use gloo, whose ``all_gather`` takes CUDA
tensors (copied through the host).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

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


def halo_sources(lengths: Sequence[int], m: int, lo: int, hi: int):
    """Where slab ``m``'s halos come from, the axis cut into slabs of
    ``lengths`` planes in position order: (side, j, p, t, k) for each run
    of ``k`` planes from plane ``p`` of slab ``j`` to plane ``t`` of the
    halo below (side 0, ``lo`` planes) or above (side 1, ``hi``), in
    order of ``t``.  A halo wider than a neighbour's slab reaches on into
    the next; the planes no slab holds (past the volume's ends) are
    zeros, and appear in no run.  The runs below read the last ``lo``
    planes of a slab, the runs above its first ``hi``."""
    starts = [0]
    for L in lengths:
        starts.append(starts[-1] + L)
    runs = []
    for side, a in ((0, starts[m] - lo), (1, starts[m + 1])):
        b = a + (hi if side else lo)
        for j, L in enumerate(lengths):
            s, e = max(a, starts[j]), min(b, starts[j] + L)
            if j != m and s < e:
                runs.append((side, j, s - starts[j], s - a, e - s))
    return runs


def fill_planes(parts, n: int, axis: int, like: torch.Tensor):
    """``n`` planes along ``axis``: each (t, tensor) of ``parts`` (in order
    of t) at plane t, zeros (of ``like``'s other dims, dtype and device)
    in the planes between and beyond them."""
    out, at = [], 0
    shape = list(like.shape)
    for t, part in parts:
        if t > at:
            shape[axis] = t - at
            out.append(like.new_zeros(shape))
        out.append(part)
        at = t + part.shape[axis]
    if n > at or not out:
        shape[axis] = n - at
        out.append(like.new_zeros(shape))
    return out[0] if len(out) == 1 else torch.cat(out, dim=axis)


def _all_gather_sized(x: torch.Tensor, length: int, group, n: int):
    """The model group's ``x`` (one shape on every rank) and each rank's
    ``length``, in one ``all_gather`` of their bytes; the lengths read
    on the host."""
    size = torch.full((1,), length, dtype=torch.int64, device=x.device)
    parts = _all_gather(torch.cat([size.view(torch.uint8),
                                   x.contiguous().view(-1)
                                   .view(torch.uint8)]), group, n)
    lengths = torch.stack([p[:8] for p in parts]).view(torch.int64)
    return ([p[8:].view(x.dtype).view(x.shape) for p in parts],
            lengths.flatten().tolist())


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, lo, hi, mesh):
        n, m = mesh.n_model, mesh.model_index
        # each rank offers its first hi and last lo planes (zeros beyond a
        # slab shorter than that) and its length
        edges = torch.cat([_edge(x, axis, True, hi),
                           _edge(x, axis, False, lo)], dim=axis)
        parts, lengths = _all_gather_sized(edges, x.shape[axis],
                                           mesh.model_group, n)
        ctx.axis, ctx.lo, ctx.hi, ctx.mesh = axis, lo, hi, mesh
        ctx.lengths = lengths
        sides: tuple = ([], [])
        for side, j, p, t, k in halo_sources(lengths, m, lo, hi):
            # slab j's plane p: at p in its first hi planes, at
            # hi + p - (L - lo) in its last lo
            at = p if side else hi + p - (lengths[j] - lo)
            sides[side].append((t, parts[j].narrow(axis, at, k)))
        return torch.cat([fill_planes(sides[0], lo, axis, x), x,
                          fill_planes(sides[1], hi, axis, x)], dim=axis)

    @staticmethod
    def backward(ctx, g):
        axis, lo, hi, mesh = ctx.axis, ctx.lo, ctx.hi, ctx.mesh
        n, m = mesh.n_model, mesh.model_index
        L = ctx.lengths[m]
        # every rank's halos' gradients; each adds those of its planes
        parts = _all_gather(torch.cat([g.narrow(axis, 0, lo),
                                       g.narrow(axis, lo + L, hi)], dim=axis),
                            mesh.model_group, n)
        dx = g.narrow(axis, lo, L).clone()
        for i in range(n):
            for side, j, p, t, k in halo_sources(ctx.lengths, i, lo, hi):
                if j == m:
                    dx.narrow(axis, p, k).add_(
                        parts[i].narrow(axis, t + (lo if side else 0), k))
        return dx, None, None, None, None


def halo_exchange(x: torch.Tensor, axis: int, lo: int, hi: int,
                  mesh: Mesh) -> torch.Tensor:
    """``x``'s slab along ``axis`` widened by the ``lo`` planes below it
    and the ``hi`` planes above it: [.., lo + L + hi, ..].  A halo wider
    than a neighbour's slab reaches on into the slabs beyond; zeros past
    the volume's ends (before the first plane, after the last slab that
    holds planes)."""
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
