"""Data and tensor parallelism (port of snvc_tpu/parallel/api.py).

JAX runs one program over a device mesh: under ``jit`` with data
shardings a step computes the single-device step on the global batch,
and XLA inserts the collectives.  The port has the "data" axis in two
forms, both a ``Mesh``:

* ``make_mesh(n_data, devices)``: one process drives every device of the
  axis.  The serving runners (``RefineRunner``, ``DetectRunner``)
  replicate the model on each device, split a request as
  ``shard_instance_batch`` / ``shard_batch`` split it, run the shards
  one after another with no host sync between them, and gather the
  outputs in order.
* ``initialize_multihost(backend, device, n_model)``: one process per
  position (``torchrun``).  The training steps take the global batch on
  every rank, built from the same seed, keep their own rows and reduce
  over the data axis.

The reductions of the training steps are one mechanism, ``global_sum``:
the sum of a tensor over the data axis, as an autograd function whose
backward sums the incoming gradients over those ranks too, so a gradient
flows through the reduction as through the one-process sum.  A
rank-local step equals the global one where every quantity that sums
over the batch is summed over the ranks:

* loss denominators (masked counts, ``num_pos``): each rank divides its
  own numerator by the global count, so the global loss is the sum of
  the ranks' losses (``models/losses.py``, ``models/stereo_losses.py``);
* BatchNorm's per-channel sums, sums of squares and counts
  (``models/layers.BatchNorm``);
* the gradients after the backward, summed (the losses are already
  global means, so no average) in one flat bucket (``reduce_gradients``).

Random draws keyed to the batch (the bbox head's dropout) draw the global
batch's rows and keep the rank's (``global_rows``).

The "model" axis is tensor parallelism (parallel/tensor.py): it splits
the plane-sweep volume on its depth axis (``DetectRunner``,
``make_stereo_train_step``) and the Vernier voxel on its length axis
(``make_train_step``) over the positions of one data index, each holding
its slab and a halo.  A mesh of ``n_data x n_model`` positions, "model"
fastest as in JAX (``position = data_index * n_model + model_index``),
comes in two forms:

* ``initialize_multihost(backend, device, n_model)`` under a launcher:
  one process per position (a rank), each on its device.  The ranks of a
  data index form its model group, the ranks of a model index its data
  group; ``global_sum`` and the data-parallel reductions run in the data
  group, the gradients are summed over the whole world
  (``reduce_gradients``).
* ``make_mesh(n_data, devices, n_model > 1)``: one process drives every
  position, as JAX's one-process mesh does (parallel/local.py): a thread
  a position, each position's collectives meeting at a rendezvous, one
  backward over every position's graph.  A device may repeat (two
  positions on one card).  ``DetectRunner``, ``make_train_step`` and
  ``make_stereo_train_step`` take it; ``RefineRunner`` splits its
  instances over the data axis only and serves on the first device of
  each data position, as JAX replicates its model over "model".
  ``cfg.remat`` holds here too: a rematerialized block's recompute
  replays what its forward's collectives received
  (``local.collective_log``).
"""

from __future__ import annotations

import atexit
import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from snvc_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A "data" x "model" mesh, one device per position.

    ``rank`` is None when this process drives every device (``make_mesh``);
    otherwise the position this mesh stands for: this process's in a
    process group of ``n_data x n_model`` ranks, one device each
    (``initialize_multihost``), or one thread's of a one-process run
    (``local``, its ``parallel.local.Rendezvous``), "model" fastest.
    ``groups`` holds the process groups of this rank's data and model
    positions (None: the whole world, or no group of more than one
    rank)."""

    devices: Tuple[torch.device, ...]
    rank: Optional[int] = None
    n_model: int = 1
    groups: Tuple[Any, Any] = dataclasses.field(
        default=(None, None), compare=False, repr=False)
    local: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def n_data(self) -> int:
        return len(self.devices) // self.n_model

    @property
    def data_index(self) -> int:
        """This rank's position on the data axis."""
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        """This rank's position on the model axis."""
        return self.rank % self.n_model

    @property
    def data_group(self):
        """The ranks of this rank's model index (None: the world)."""
        return self.groups[0]

    @property
    def model_group(self):
        """The ranks of this rank's data index."""
        return self.groups[1]


def make_mesh(n_data: int, devices: Sequence, n_model: int = 1) -> Mesh:
    """The first ``n_data x n_model`` of ``devices`` as one process's
    mesh, "model" fastest; ``n_data = -1`` takes ``len(devices) //
    n_model`` (JAX's ``make_mesh``).  A device may repeat (``["cuda:0",
    "cuda:0"]``: two positions on one card)."""
    if n_model < 1:
        raise ValueError(f"n_model={n_model}")
    if n_data == -1:
        n_data = len(devices) // n_model
    if not 1 <= n_data * n_model <= len(devices):
        raise ValueError(f"mesh {n_data}x{n_model} needs more than "
                         f"{len(devices)} devices")
    return Mesh(tuple(torch.device(d) for d in devices[:n_data * n_model]),
                n_model=n_model)


def initialize_multihost(backend: str, device,
                         n_model: int = 1) -> Optional[Mesh]:
    """The mesh of a run with one process per device: ``world / n_model``
    data positions of ``n_model`` ranks each, "model" fastest, so the
    ranks of one model group are neighbours (on one host under a
    launcher).

    Joins the process group the launcher describes (``torchrun`` or
    ``python -m torch.distributed.run`` set ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``) with ``backend``:
    "nccl" for one GPU per rank, "gloo" on the CPU or for ranks that share
    a GPU (NCCL refuses a duplicate GPU).  A group the process has already
    joined is used as it is.  ``device`` is this rank's device; "cuda"
    without an index means ``cuda:LOCAL_RANK``.  Returns the mesh of every
    rank's device.  In a process with no launcher and no group (one
    process, as JAX's single-process case) it returns None with
    ``n_model`` 1, and with ``n_model > 1`` the one-process mesh
    (``make_mesh(-1, ..., n_model)``) over every visible device of
    ``device``'s type.  ``n_model`` must divide the world size and, under
    a launcher that gives ``LOCAL_WORLD_SIZE``, stay within one host (JAX
    refuses a model axis that would cross hosts)."""
    dev = torch.device(device)
    if not dist.is_initialized() and "RANK" not in os.environ:
        if n_model == 1:
            return None
        visible = _visible_devices(dev.type)
        if n_model > len(visible):
            raise ValueError(f"model axis {n_model} would cross host "
                             f"boundaries (local devices: {len(visible)})")
        return make_mesh(-1, visible, n_model)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend)
        atexit.register(dist.destroy_process_group)
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"not {backend}")
    world = dist.get_world_size()
    if n_model < 1 or world % n_model:
        raise ValueError(f"n_model={n_model} does not divide the world of "
                         f"{world} ranks")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if n_model > local:
        raise ValueError(f"model axis {n_model} would cross host "
                         f"boundaries (local ranks: {local})")
    names = [None] * world
    dist.all_gather_object(names, str(dev))
    rank = dist.get_rank()
    return Mesh(tuple(torch.device(n) for n in names), rank=rank,
                n_model=n_model, groups=_mesh_groups(world, n_model, rank))


def _visible_devices(kind: str) -> List[str]:
    """Every device of ``kind`` this process sees: the GPUs, or the one
    CPU."""
    if kind == "cuda":
        return [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return [kind]


def _mesh_groups(world: int, n_model: int, rank: int) -> Tuple[Any, Any]:
    """(data group, model group) of ``rank``; every rank creates every
    group, in one order, as ``dist.new_group`` requires."""
    if n_model == 1:
        return None, None
    n_data = world // n_model
    data = [dist.new_group([d * n_model + m for d in range(n_data)])
            for m in range(n_model)]
    model = [dist.new_group(list(range(d * n_model, (d + 1) * n_model)))
             for d in range(n_data)]
    return data[rank % n_model], model[rank // n_model]


def process_index() -> int:
    """This process's rank, 0 without a process group (as
    ``jax.process_index``): rank 0 alone writes checkpoints and logs."""
    return dist.get_rank() if dist.is_initialized() else 0


# Per-field layout of an InstanceBatch: instance-indexed arrays split over
# "data"; the frame images and projections are replicated (each position
# gathers its own ROIs from the same frames).
_INSTANCE_FIELDS = ("image_idx", "trans_l", "trans_r", "samples", "valid",
                    "gt_boxes", "points", "points_valid")
_FRAME_FIELDS = ("images_left", "images_right", "P_left", "P_right")


def instance_batch_specs() -> Dict[str, Tuple[str, ...]]:
    """Each InstanceBatch field's partition spec, as JAX's
    ``PartitionSpec`` tuples: ("data",) splits the leading axis, ()
    replicates."""
    specs = {k: ("data",) for k in _INSTANCE_FIELDS}
    specs.update({k: () for k in _FRAME_FIELDS})
    return specs


def _rows(name: str, a, n: int, index: int):
    rows = a.shape[0]
    if rows % n:
        raise ValueError(f"{name}: {rows} rows do not split over {n} data "
                         "positions")
    m = rows // n
    return a[index * m:(index + 1) * m]


def shard_instance_batch(arrays: Dict[str, Any], mesh: Mesh,
                         index: int) -> Dict[str, Any]:
    """Position ``index``'s part of an instance batch (numpy arrays or
    tensors): its contiguous rows of the instance fields, the frame
    fields whole.  ``max_instances % n_data`` must be 0."""
    specs = instance_batch_specs()
    return {k: _rows(k, v, mesh.n_data, index) if specs[k] else v
            for k, v in arrays.items()}


def shard_batch(arrays: Dict[str, Any], mesh: Mesh,
                index: int) -> Dict[str, Any]:
    """Position ``index``'s contiguous rows of every field (a stereo
    batch: frames on the leading axis).  The batch size % n_data must be
    0."""
    return {k: _rows(k, v, mesh.n_data, index) for k, v in arrays.items()}


def runner_devices(device, mesh: Optional[Mesh],
                   model_axis: bool = False) -> List[torch.device]:
    """The devices a serving runner drives: those of ``mesh`` (one process
    drives them all: ``make_mesh``), or ``device`` alone.  A runner that
    splits its model (``model_axis``: ``DetectRunner``) drives every
    position of the mesh, and also takes a process group's mesh of one
    data position and ``n_model > 1``: this rank's device.  One that does
    not (``RefineRunner``) drives the first device of each data position:
    JAX replicates its model over "model"."""
    if mesh is None:
        return [resolve_device(device)]
    if mesh.rank is not None:
        if not model_axis or mesh.n_model == 1:
            raise ValueError("a serving runner drives every device of its "
                             "mesh: pass make_mesh's mesh")
        if mesh.n_data != 1:
            raise ValueError(f"a tensor-parallel runner serves one data "
                             f"position, not {mesh.n_data}")
        return [resolve_device(mesh.devices[mesh.rank])]
    devs = mesh.devices if model_axis else mesh.devices[::mesh.n_model]
    return [resolve_device(d) for d in devs]


class AllReduceSum(torch.autograd.Function):
    """The sum over the ranks of ``group`` (None: the world), whose
    backward sums the incoming gradients over them too (its adjoint)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def global_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``x`` summed over the data axis of ``mesh`` (a position's mesh: a
    rank's, or a thread's of a one-process run), differentiably (see the
    module docstring); ``x`` itself without a mesh or with one data
    position."""
    if mesh is None or mesh.n_data == 1:
        return x
    if mesh.local is not None:
        return mesh.local.sum(x, "data", mesh.rank)
    return AllReduceSum.apply(x, mesh.data_group)


def world_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed over every position of ``mesh``, differentiably."""
    if mesh.local is not None:
        return mesh.local.sum(x, "world", mesh.rank)
    return AllReduceSum.apply(x, None)


def global_rows(n_local: int, mesh: Optional[Mesh]) -> Tuple[int, int]:
    """(rows of the global batch, this rank's first row) for a batch of
    ``n_local`` rows a rank."""
    if mesh is None:
        return n_local, 0
    return n_local * mesh.n_data, n_local * mesh.data_index


def global_metrics(metrics: Dict[str, torch.Tensor],
                   mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """0-d per-position parts (each data position's loss over the global
    denominator, its own count) summed over the data axis, in one
    all-reduce."""
    if mesh is None:
        return metrics
    total = global_sum(torch.stack([v.float() for v in metrics.values()]),
                       mesh)
    return dict(zip(metrics, total.unbind()))


def reduce_gradients(grads: Sequence[torch.Tensor],
                     mesh: Optional[Mesh]) -> None:
    """Sums ``grads`` over every rank of the world in place, in one flat
    bucket (one all-reduce a step, after the backward)."""
    if mesh is None:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def check_training_mesh(mesh: Optional[Mesh], device) -> None:
    """A training step holds one position of a process group (the mesh of
    ``initialize_multihost``), or every position of a one-process mesh
    with a model axis (``make_mesh(n_data, devices, n_model > 1)``; the
    "data" axis alone runs a process a position), on ``device``: the
    rank's, or the mesh's first."""
    if mesh is None:
        return
    if mesh.rank is None and mesh.n_model == 1:
        raise ValueError("a data-parallel training step runs one process "
                         "per data position: pass initialize_multihost's "
                         "mesh, or make_mesh's with n_model > 1")
    own = mesh.devices[mesh.rank or 0]
    if own != torch.device(device):
        raise ValueError(f"position {mesh.rank or 0} holds {own}, not "
                         f"{device}")
