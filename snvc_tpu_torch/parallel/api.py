"""Data parallelism (port of snvc_tpu/parallel/api.py).

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
* ``initialize_multihost(backend, device)``: one process per position
  (``torchrun``).  The training steps take the global batch on every
  rank, built from the same seed, keep their own rows and reduce over
  the ranks.

The reductions of the training steps are one mechanism, ``global_sum``:
the sum of a tensor over the ranks, as an autograd function whose
backward sums the incoming gradients over the ranks too, so a gradient
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

The "model" axis (tensor parallelism over the Vernier voxel's length and
the plane-sweep volume's depth) is not ported: ``make_mesh`` refuses
``n_model > 1`` (ROADMAP.md, Queue 1).
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
    """The "data" axis: one device per position ("model" is 1).

    ``rank`` is None when this process drives every device (``make_mesh``:
    the serving runners); otherwise the position this process holds in a
    process group of ``n_data`` ranks, one device each
    (``initialize_multihost``: the training steps)."""

    devices: Tuple[torch.device, ...]
    rank: Optional[int] = None

    @property
    def n_data(self) -> int:
        return len(self.devices)


def make_mesh(n_data: int, devices: Sequence, n_model: int = 1) -> Mesh:
    """The first ``n_data`` of ``devices`` as one process's data axis.  A
    device may repeat (``["cuda:0", "cuda:0"]``: two replicas on one
    card)."""
    if n_model != 1:
        raise NotImplementedError(
            f"n_model={n_model}: the 'model' axis (tensor parallelism) is "
            "not ported; see ROADMAP.md, Queue 1")
    if not 1 <= n_data <= len(devices):
        raise ValueError(f"mesh of {n_data} needs more than "
                         f"{len(devices)} devices")
    return Mesh(tuple(torch.device(d) for d in devices[:n_data]))


def initialize_multihost(backend: str, device) -> Optional[Mesh]:
    """The data axis of a run with one process per device.

    Joins the process group the launcher describes (``torchrun`` or
    ``python -m torch.distributed.run`` set ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``) with ``backend``:
    "nccl" for one GPU per rank, "gloo" on the CPU or for ranks that share
    a GPU (NCCL refuses a duplicate GPU).  A group the process has already
    joined is used as it is.  ``device`` is this rank's device; "cuda"
    without an index means ``cuda:LOCAL_RANK``.  Returns the mesh of every
    rank's device, or None in a process with no launcher and no group
    (one process, as JAX's single-process case)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if not dist.is_initialized():
        if "RANK" not in os.environ:
            return None
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend)
        atexit.register(dist.destroy_process_group)
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"not {backend}")
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, str(dev))
    return Mesh(tuple(torch.device(n) for n in names), rank=dist.get_rank())


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


def runner_devices(device, mesh: Optional[Mesh]) -> List[torch.device]:
    """The devices a serving runner drives: every device of ``mesh`` (one
    process drives them all: ``make_mesh``), or ``device`` alone."""
    if mesh is None:
        return [resolve_device(device)]
    if mesh.rank is not None:
        raise ValueError("a serving runner drives every device of its "
                         "mesh: pass make_mesh's mesh")
    return [resolve_device(d) for d in mesh.devices]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def global_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``x`` summed over the ranks of ``mesh`` (a process group's mesh,
    as ``check_training_mesh`` holds the steps to), differentiably (see
    the module docstring); ``x`` itself without a mesh."""
    if mesh is None:
        return x
    return _AllReduceSum.apply(x)


def global_rows(n_local: int, mesh: Optional[Mesh]) -> Tuple[int, int]:
    """(rows of the global batch, this rank's first row) for a batch of
    ``n_local`` rows a rank."""
    if mesh is None:
        return n_local, 0
    return n_local * mesh.n_data, n_local * mesh.rank


def global_metrics(metrics: Dict[str, torch.Tensor],
                   mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """0-d per-rank parts (each rank's loss over the global denominator,
    its own count) summed over the ranks, in one all-reduce."""
    if mesh is None:
        return metrics
    total = global_sum(torch.stack([v.float() for v in metrics.values()]),
                       mesh)
    return dict(zip(metrics, total.unbind()))


def reduce_gradients(grads: Sequence[torch.Tensor],
                     mesh: Optional[Mesh]) -> None:
    """Sums ``grads`` over the ranks in place, in one flat bucket (one
    all-reduce a step, after the backward)."""
    if mesh is None:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def check_training_mesh(mesh: Optional[Mesh], device) -> None:
    """A training step holds one position of a process group: the mesh of
    ``initialize_multihost``, on ``device``."""
    if mesh is None:
        return
    if mesh.rank is None:
        raise ValueError("a training step runs one process per data "
                         "position: pass initialize_multihost's mesh")
    if mesh.devices[mesh.rank] != torch.device(device):
        raise ValueError(f"rank {mesh.rank} holds {mesh.devices[mesh.rank]}"
                         f", not {device}")
