"""Refinement serving runner (port of snvc_tpu/inference/refine.py:89-118,
:126-311, ``RefineRunner.step`` and ``run``), on one device or a mesh, and
``refinement_step`` (refine.py:39-61), the same step as one function.

One step has the JAX runner's three parts:
  1. ``encode``: ``assemble_instances`` (ROI warps + grid projections) and
     ``VernierEncoder`` (HRNet on both views + stereo voxel sampler, K1);
  2. ``heads``: ``VernierHead`` (BEV_type2 / BEV_type3: its large-tap
     convs run K2; BEV runs no K2);
  3. ``finalize``: ``ncf_to_update`` -> refined boxes (heads without
     ``coordinates`` decode the NCF by argmax even under
     ``ncf_decode="coordinates"``, as JAX does), and with
     ``with_targets`` the training targets and ``vernier_losses`` against
     the batch's GT boxes and LiDAR (validation losses).

``refinement_step`` runs assemble -> the model's forward -> ``finalize``
on one device; the runner keeps its split (it gathers the head outputs
of a mesh before ``finalize``), and both call the one ``finalize``.

``run`` serves a ``RefinementPipeline`` into a ``PredictionWriter``, with
up to ``prefetch`` batches queued on the card before the oldest one's
outputs are pulled to the host.

With a mesh (``parallel.make_mesh``) the model is replicated once on each
of its devices; a request's instances are split as
``shard_instance_batch`` splits them (the frames whole on every device),
``encode`` and ``heads`` run on each device's part with no host sync
between devices, and the head outputs are gathered in order on the
mesh's first device, where ``finalize`` runs on the whole request (its
losses then have the one-device normalizers).  A mesh with a model axis
(``make_mesh(n_data, devices, n_model)``) is served as JAX serves it:
its instances split over "data" only and the model replicated over
"model", so the runner drives the first device of each data position.

``cost_stats`` (JAX refine.py:226-251) gives the work of one step,
{"flops", "bytes_accessed"}, as ``utils.cost`` counts it: the three
parts on the runner's device over the whole batch, each kernel by the
work it declares (``cost_counter`` keeps the per-kernel shares).

The ``3D`` head's fields [N, P, nh, nw, nl] have no pose update: JAX's
``_finalize`` fails on them in ``hard_argmax_2d``'s 4-D unpack
(snvc_tpu/ops/heatmaps.py:67).  ``step`` and ``cost_stats`` refuse such
a model with a ``ValueError`` before any device work.
"""

from __future__ import annotations

import copy
from collections import deque
from typing import Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from snvc_tpu_torch.config import VernierConfig
from snvc_tpu_torch.data.pipeline import InstanceBatch
from snvc_tpu_torch.models.losses import vernier_losses
from snvc_tpu_torch.models.vernier import VernierScale
from snvc_tpu_torch.ops.assemble import (
    assemble_instances,
    make_grid_local,
    make_targets,
)
from snvc_tpu_torch.ops.registration import ncf_to_update
from snvc_tpu_torch.parallel.api import (
    Mesh,
    runner_devices,
    shard_instance_batch,
)
from snvc_tpu_torch.utils.cost import CostCounter, count_cost
from snvc_tpu_torch.utils.device import to_device

_BATCH_KEYS = ("images_left", "images_right", "P_left", "P_right",
               "image_idx", "trans_l", "trans_r", "samples")
# what the losses read besides
_TARGET_KEYS = ("valid", "gt_boxes", "points", "points_valid")


class RefineRunner:
    """Drives the refinement pipeline on ``device`` (default "cuda", which
    raises without a GPU), or on every device of ``mesh`` (a
    ``parallel.make_mesh``; ``device`` is then its first).  The model is
    moved to that device."""

    # outputs copied to the host as numpy by default: the serving payload
    # (and the losses, with targets)
    HOST_OUTPUTS = ("one_part", "all_parts", "confidence", "keep", "losses")

    def __init__(self, model: VernierScale, cfg: VernierConfig,
                 device="cuda", mesh: Optional[Mesh] = None):
        self.mesh = mesh
        devs = runner_devices(device, mesh)
        self.device = devs[0]
        self.cfg = cfg
        self.model = model.to(self.device).eval()
        self.grid_local = torch.from_numpy(make_grid_local(cfg)).to(self.device)
        if mesh is not None:
            # (device, model, object grid) of each position
            self.replicas = [(self.device, self.model, self.grid_local)] + [
                (d, copy.deepcopy(self.model).to(d), self.grid_local.to(d))
                for d in devs[1:]]

    def _to_device(self, batch, with_targets: bool
                   ) -> Dict[str, torch.Tensor]:
        arrays = batch.arrays() if isinstance(batch, InstanceBatch) else batch
        keys = _BATCH_KEYS + (_TARGET_KEYS if with_targets else ())
        return {k: to_device(arrays[k], self.device) for k in keys}

    def encode(self, arrays: Mapping[str, torch.Tensor]) -> torch.Tensor:
        return _encode(self.model, self.grid_local, arrays, self.cfg)

    def heads(self, voxel: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.model.head(voxel)

    def _sharded_heads(self, arrays: Mapping[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        """``heads(encode(arrays))`` with each mesh position's instances
        on its own replica, gathered in order on the first device."""
        parts = []
        for i, (dev, model, grid) in enumerate(self.replicas):
            shard = {k: v.to(dev, non_blocking=True) for k, v in
                     shard_instance_batch(arrays, self.mesh, i).items()}
            parts.append(model.head(_encode(model, grid, shard, self.cfg)))
        return {k: None if parts[0][k] is None else torch.cat(
            [p[k].to(self.device, non_blocking=True) for p in parts])
            for k in parts[0]}

    def step(self, batch: Union[InstanceBatch, Mapping[str, np.ndarray]],
             with_targets: bool = False, host_outputs=None) -> Dict:
        """One refinement request.  Returns the outputs dict; the keys in
        ``host_outputs`` (default ``HOST_OUTPUTS``) come back as numpy, the
        dense NCF / occupancy stay tensors on the device.  With
        ``host_outputs=()`` nothing waits for the card: the work is only
        queued.  ``with_targets`` adds ``losses``, ``vernier_losses``
        against the batch's ``gt_boxes`` and LiDAR ``points`` (a dict of
        0-d values).  Raises ValueError for the ``3D`` head."""
        self._refuse_3d()
        with torch.inference_mode():
            arrays = self._to_device(batch, with_targets)
            outputs = (self.heads(self.encode(arrays)) if self.mesh is None
                       else self._sharded_heads(arrays))
            out = finalize(outputs, arrays, self.cfg, self.grid_local,
                           with_targets)
        wanted = self.HOST_OUTPUTS if host_outputs is None else host_outputs
        return to_host(out, wanted)

    def _refuse_3d(self):
        if self.cfg.vernier_type == "3D":
            raise ValueError("vernier_type '3D' gives 5-D NCF fields "
                             "[N, P, nh, nw, nl], which have no pose update "
                             "(ncf_to_update decodes [N, P, nl, nw] BEV maps)")

    def cost_counter(self, batch: Union[InstanceBatch,
                                        Mapping[str, np.ndarray]],
                     with_targets: bool = False) -> CostCounter:
        """One step's ``encode``, ``heads`` and ``finalize`` run under a
        ``utils.cost`` counter, which is returned (its ``by_kernel`` holds
        K1's and K2's declared shares).  The batch is moved to the device
        first, outside the count, as JAX's programs take it as
        arguments.  On a mesh the step runs on the first device over the
        whole batch, so the count is the whole batch's work."""
        self._refuse_3d()
        with torch.inference_mode():
            arrays = self._to_device(batch, with_targets)
            with count_cost() as c:
                outputs = self.heads(self.encode(arrays))
                finalize(outputs, arrays, self.cfg, self.grid_local,
                         with_targets)
        return c

    def cost_stats(self, batch: Union[InstanceBatch,
                                      Mapping[str, np.ndarray]],
                   with_targets: bool = False) -> Dict[str, float]:
        """The work of one refinement step, {"flops", "bytes_accessed"}
        (JAX refine.py:226-251, which sums XLA's cost analysis of its
        three programs; ``utils.cost`` says how the port counts).  Never
        None.  The step runs once."""
        return self.cost_counter(batch, with_targets).totals()

    def run(self, pipeline, writer=None, with_targets: bool = False,
            progress: bool = True, max_batches: Optional[int] = None,
            prefetch: int = 0) -> List[Dict[str, float]]:
        """Serve every batch of ``pipeline`` (a ``RefinementPipeline``) and
        hand each batch's host outputs to ``writer.add_batch``, in batch
        order.  ``prefetch > 0`` keeps that many batches queued on the card
        before the oldest one's outputs are pulled, so the host builds the
        next batches while the card works.  With ``with_targets`` each
        batch's losses are printed (with ``progress``) and returned, one
        dict a batch."""
        loss_log = []

        def finish(bi, batch, out):
            out = to_host(out, self.HOST_OUTPUTS)
            if writer is not None:
                writer.add_batch(batch, out)
            msg = f"batch {bi}"
            if with_targets:
                loss_log.append({k: float(v)
                                 for k, v in out["losses"].items()})
                msg += ": " + ", ".join(f"{k}={v:.4f}"
                                        for k, v in loss_log[-1].items())
            if progress:
                print(msg)

        pending = deque()
        for bi, batch in enumerate(pipeline.batches()):
            if max_batches is not None and bi >= max_batches:
                break
            pending.append((bi, batch, self.step(
                batch, with_targets=with_targets, host_outputs=())))
            while len(pending) > max(prefetch, 0):
                finish(*pending.popleft())
        while pending:
            finish(*pending.popleft())
        return loss_log


def refinement_step(model: VernierScale, batch: Mapping[str, torch.Tensor],
                    cfg: VernierConfig, grid_local: torch.Tensor,
                    with_targets: bool = False) -> Dict[str, torch.Tensor]:
    """One refinement step as one function (JAX refine.py:39-61, the
    training / dry-run path): ``assemble_instances`` -> ``model`` ->
    ``finalize``, on the tensors of ``batch`` (the arrays of an
    ``InstanceBatch`` on the model's device; with ``with_targets`` also
    ``valid``, ``gt_boxes``, ``points`` and ``points_valid``).  Takes the
    port's module where JAX takes ``params``; differentiable when grad
    mode is on.  ``RefineRunner.step`` serves the same three parts."""
    left, right, gpl, gpr = _assemble(grid_local, batch, cfg)
    return finalize(model(left, right, gpl, gpr), batch, cfg, grid_local,
                    with_targets)


def finalize(outputs, arrays: Mapping[str, torch.Tensor],
             cfg: VernierConfig, grid_local: torch.Tensor,
             with_targets: bool = False) -> Dict[str, torch.Tensor]:
    """Head outputs -> the refined boxes (``ncf_to_update``: one_part,
    all_parts, confidence, keep) beside the dense outputs, and with
    ``with_targets`` the ``losses`` against the batch's GT and LiDAR
    (JAX refine.py:_finalize)."""
    upd = ncf_to_update(
        outputs["ncf"], arrays["samples"], cfg.x_range, cfg.z_range,
        coordinates=outputs.get("coordinates"),
        filter_min=cfg.filter_min, filter_max=cfg.filter_max,
        decode=cfg.ncf_decode)
    out = dict(one_part=upd.one_part, all_parts=upd.all_parts,
               confidence=upd.confidence, keep=upd.keep,
               occupancy=outputs.get("occupancy"), ncf=outputs["ncf"],
               coordinates=outputs.get("coordinates"))
    if with_targets:
        targets = make_targets(arrays["samples"], arrays["gt_boxes"],
                               arrays["points"], arrays["points_valid"],
                               grid_local, cfg)
        out["losses"] = vernier_losses(outputs, targets, arrays["valid"], cfg)
    return out


def _assemble(grid_local: torch.Tensor, arrays: Mapping[str, torch.Tensor],
              cfg: VernierConfig):
    return assemble_instances(
        arrays["images_left"], arrays["images_right"],
        arrays["image_idx"], arrays["trans_l"], arrays["trans_r"],
        arrays["samples"], arrays["P_left"], arrays["P_right"],
        grid_local, cfg)


def _encode(model: VernierScale, grid_local: torch.Tensor,
            arrays: Mapping[str, torch.Tensor],
            cfg: VernierConfig) -> torch.Tensor:
    return model.encoder(*_assemble(grid_local, arrays, cfg))


def to_host(out: Mapping, wanted) -> Dict:
    """``out`` with the tensors under the keys in ``wanted`` as numpy (a
    dict of tensors, such as ``losses``, as a dict of numpy; bfloat16,
    which numpy lacks, as float32)."""
    def host(v):
        if isinstance(v, torch.Tensor):
            if v.dtype == torch.bfloat16:
                v = v.float()
            return v.cpu().numpy()
        if isinstance(v, dict):
            return {k: host(x) for k, x in v.items()}
        return v

    return {k: (host(v) if k in wanted else v) for k, v in out.items()}
