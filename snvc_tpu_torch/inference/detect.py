"""Global-model serving: stereo pair -> StereoNet -> proposals (port of
snvc_tpu/inference/detect.py: ``corners24_to_box3d``,
``decode_proposals``, ``DetectRunner.forward`` and
``proposals_to_kitti``).

One request runs ``StereoEncoder`` (2D features of both views),
``StereoHead`` (cost volume K3, 3D stack, frustum resample K4, BEV head)
and ``decode_proposals`` (scores, corner decode, a top pool, rotated NMS,
top-k), all on the runner's device.  ``DetectRunner.run`` detects a
KITTI split into proposal files, with up to ``prefetch`` frames queued on
the card before the oldest one's proposals are pulled to the host.

With a mesh (``parallel.make_mesh``) the model is replicated once on each
of its devices, a request's frames are split as ``shard_batch`` splits
them (``batch_size % n_data == 0``, as in JAX), each device runs its
frames through the model and ``decode_proposals`` with no host sync
between devices, and the proposals are gathered in order on the mesh's
first device.  With a process group's mesh of one data position and
``n_model > 1`` (``parallel.initialize_multihost``) every rank serves the
request on its own device with the stereo volume split on its depth axis
over the ranks (tensor parallelism, models/stereonet.py), and every rank
returns the same proposals.  With a one-process mesh of ``n_model > 1``
(``parallel.make_mesh(n_data, devices, n_model)``) every position runs
in its own thread on its replica of the model (parallel/local.py): each
data position's frames are split in depth over its model positions, and
the proposals of each data position's first model position are gathered
in order on the mesh's first device.
"""

from __future__ import annotations

import copy
import os
from collections import deque
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from snvc_tpu_torch.config import StereoConfig
from snvc_tpu_torch.data.stereo import (
    check_stereo_projections,
    normalize_images,
)
from snvc_tpu_torch.data.stereo_pipeline import StereoPipeline
from snvc_tpu_torch.geometry import boxes as gbox
from snvc_tpu_torch.inference.kitti_writer import instance_line
from snvc_tpu_torch.models.layers import tensor_parallel
from snvc_tpu_torch.models.stereonet import StereoNet, bev_locations
from snvc_tpu_torch.ops.nms import rotated_nms_bev, top_k_boxes
from snvc_tpu_torch.ops.rotated_iou import bev_from_box3d
from snvc_tpu_torch.parallel.api import Mesh, runner_devices, shard_batch
from snvc_tpu_torch.parallel.local import Replicas, run_positions
from snvc_tpu_torch.utils.device import constant, to_device


def corners24_to_box3d(corners):
    """[..., 24] corner coordinates (offsets + anchor) -> box3d [..., 7].

    Bottom 4 corners then top 4; each dimension and the heading average
    the four parallel edges (the heading as a vector sum, wrap-safe)."""
    c = corners.reshape(corners.shape[:-1] + (8, 3))
    bottom, top = c[..., :4, :], c[..., 4:, :]
    center_xz = c[..., ::2].mean(dim=-2)  # x and z; a list index would sync
    y_bottom = bottom[..., 1].mean(dim=-1)
    h = (bottom[..., 1] - top[..., 1]).mean(dim=-1)
    e_l = ((c[..., 0, :] - c[..., 3, :]) + (c[..., 1, :] - c[..., 2, :])
           + (c[..., 4, :] - c[..., 7, :]) + (c[..., 5, :] - c[..., 6, :]))
    e_w = ((c[..., 0, :] - c[..., 1, :]) + (c[..., 3, :] - c[..., 2, :])
           + (c[..., 4, :] - c[..., 5, :]) + (c[..., 7, :] - c[..., 6, :]))
    length = torch.linalg.norm(e_l[..., ::2], dim=-1) / 4.0
    width = torch.linalg.norm(e_w[..., ::2], dim=-1) / 4.0
    ry = torch.atan2(-e_l[..., 2], e_l[..., 0])
    return torch.stack([h, width, length, center_xz[..., 0], y_bottom,
                        center_xz[..., 1], ry], dim=-1)


def decode_proposals(outputs: Mapping, cfg: StereoConfig,
                     max_boxes: int = 128, score_threshold: float = 0.1,
                     nms_iou: float = 0.25,
                     locations: Optional[torch.Tensor] = None):
    """RPN outputs of a batch -> padded proposal sets: boxes3d
    [N, max_boxes, 7], scores [N, max_boxes], classes [N, max_boxes]
    (int32 class slots) and valid [N, max_boxes].  ``locations`` are the
    BEV anchors ``bev_locations(cfg)`` on the outputs' device (made here
    when not given)."""
    A, K = cfg.num_angles, cfg.num_classes
    cls_all = outputs["cls"]
    dev = cls_all.device
    if locations is None:
        locations = constant(bev_locations(cfg), dev)
    L = locations.shape[0]
    anchors_y = constant(cfg.anchors_y, dev).expand(K)
    anchor3d = torch.stack([locations[:, 0:1].expand(L, K),
                            anchors_y[None, :].expand(L, K),
                            locations[:, 1:2].expand(L, K)], dim=-1)
    anchor24 = anchor3d.repeat(1, 1, 8)[:, None]  # [L, 1, K, 24]
    kidx = torch.arange(K, dtype=torch.int32, device=dev).repeat(L * A)
    pool = min(4 * max_boxes, L * A * K)
    res = []
    for cls, reg, ctr in zip(cls_all, outputs["reg"], outputs["centerness"]):
        score = (torch.sigmoid(cls.reshape(L, A, K))
                 * torch.sigmoid(ctr.reshape(L, A))[..., None]).reshape(-1)
        corners = reg.reshape(L, A, K, 24) + anchor24
        boxes = corners24_to_box3d(corners).reshape(L * A * K, 7)
        idx = torch.argsort(-score, stable=True)[:pool]
        bsel, ssel, ksel = boxes[idx], score[idx], kidx[idx]
        keep = rotated_nms_bev(bev_from_box3d(bsel), ssel,
                               ssel > score_threshold, nms_iou)
        b, s, v = top_k_boxes(bsel, ssel, keep, max_boxes)
        kk = top_k_boxes(ksel, ssel, keep, max_boxes)[0]
        res.append((b, s, kk, v))
    return tuple(torch.stack(t) for t in zip(*res))


_BATCH_KEYS = ("images_left", "images_right", "P_left", "P_right")


class DetectRunner:
    """Serves the global model on ``device`` (default "cuda", which raises
    without a GPU), on every device of ``mesh`` (a ``parallel.make_mesh``;
    ``device`` is then its first), or split over the model axis of a
    process group's ``mesh`` (``parallel.initialize_multihost`` with
    ``n_model > 1`` and one data position; this rank's device) or a
    one-process mesh's positions (``make_mesh(n_data, devices, n_model >
    1)``): ``forward`` takes one request (the arrays of
    ``StereoBatch.arrays()``) and returns the padded proposals as tensors
    on the device.  The model is moved to that device."""

    def __init__(self, model: StereoNet, cfg: StereoConfig,
                 max_boxes: int = 8, score_threshold: float = 0.02,
                 nms_iou: float = 0.25, device="cuda",
                 mesh: Optional[Mesh] = None):
        self.mesh = mesh
        devs = runner_devices(device, mesh, model_axis=True)
        # tensor-parallel: this rank's part of a model split over ranks
        self.split = mesh is not None and mesh.rank is not None
        self.device = devs[0]
        self.cfg = cfg
        self.model = model.to(self.device).eval()
        self.max_boxes = max_boxes
        self.score_threshold = score_threshold
        self.nms_iou = nms_iou
        self.locations = torch.from_numpy(bev_locations(cfg)).to(self.device)
        # one process drives every position of a data x model mesh
        self.positions = (mesh is not None and not self.split
                          and mesh.n_model > 1)
        if self.positions:
            with torch.no_grad():  # the replicas' own copies, once
                self.replicas = Replicas(self.model, mesh)
        elif mesh is not None and not self.split:
            # (device, model, BEV anchors) of each position
            self.replicas = [(self.device, self.model, self.locations)] + [
                (d, copy.deepcopy(self.model).to(d), self.locations.to(d))
                for d in devs[1:]]

    def _to_device(self, arrays: Mapping) -> Dict[str, torch.Tensor]:
        check_stereo_projections(arrays["P_left"], arrays["P_right"])
        return {k: to_device(arrays[k], self.device) for k in _BATCH_KEYS}

    def forward(self, batch_arrays: Mapping
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
        """One request -> (boxes3d [N, max_boxes, 7], scores, classes,
        valid), on the device."""
        with torch.inference_mode():
            b = self._to_device(batch_arrays)
            if self.split:
                with tensor_parallel(self.model, self.mesh):
                    return self._detect(self.model, self.locations, b)
            if self.mesh is None:
                return self._detect(self.model, self.locations, b)
            if self.positions:
                return self._positions(b)
            parts = []
            for i, (dev, model, locations) in enumerate(self.replicas):
                shard = {k: v.to(dev, non_blocking=True) for k, v in
                         shard_batch(b, self.mesh, i).items()}
                parts.append(self._detect(model, locations, shard))
            return tuple(torch.cat([p[j].to(self.device, non_blocking=True)
                                    for p in parts])
                         for j in range(len(parts[0])))

    def _positions(self, b: Mapping[str, torch.Tensor]):
        """``forward`` on a one-process mesh: every position in its
        thread on its replica, its data position's frames split in depth
        over the model axis."""
        mesh = self.mesh

        def position(pos):
            dev = pos.devices[pos.rank]
            model = self.replicas[pos.rank]
            shard = {k: v.to(dev, non_blocking=True) for k, v in
                     shard_batch(b, mesh, pos.data_index).items()}
            with tensor_parallel(model, pos):
                return self._detect(model, self.locations.to(dev), shard)

        parts = run_positions(mesh, position)[::mesh.n_model]
        return tuple(torch.cat([p[j].to(self.device, non_blocking=True)
                                for p in parts])
                     for j in range(len(parts[0])))

    def _detect(self, model: StereoNet, locations: torch.Tensor,
                b: Mapping[str, torch.Tensor]):
        out = model(normalize_images(b["images_left"]),
                    normalize_images(b["images_right"]),
                    b["P_left"].float(), b["P_right"].float())
        return decode_proposals(
            out, self.cfg, max_boxes=self.max_boxes,
            score_threshold=self.score_threshold, nms_iou=self.nms_iou,
            locations=locations)

    def run(self, ds, out_dir: str, batch_size: int = 1, prefetch: int = 4,
            max_frames: Optional[int] = None,
            log: Optional[Callable[[str], None]] = None) -> int:
        """Detect every frame of ``ds`` (a ``KittiDataset``) into KITTI
        files under ``out_dir/data``; returns the proposal count.  A
        padded tail batch repeats a frame, which is written once."""
        pipe = StereoPipeline(ds, self.cfg, batch_size=batch_size,
                              training=False)
        data_dir = os.path.join(out_dir, "data")
        os.makedirs(data_dir, exist_ok=True)
        total = 0
        written = set()

        def finish(names, out):
            nonlocal total
            boxes, scores, classes, valid = (t.cpu().numpy() for t in out)
            for i, name in enumerate(names):
                if name in written:
                    continue
                written.add(name)
                lines = proposals_to_kitti(
                    boxes[i], scores[i], valid[i],
                    ds.scene(int(name)).calibration("left"),
                    classes=classes[i], class_names=self.cfg.class_names)
                total += len(lines)
                with open(os.path.join(data_dir, name + ".txt"), "w") as f:
                    f.write("\n".join(lines) + ("\n" if lines else ""))

        pending = deque()
        for bi, batch in enumerate(pipe.batches()):
            if max_frames is not None and bi * batch_size >= max_frames:
                break
            pending.append((batch.scene_names, self.forward(batch.arrays())))
            while len(pending) > max(prefetch, 0):
                finish(*pending.popleft())
        while pending:
            finish(*pending.popleft())
        if log is not None:
            log(f"decoded {total} proposals over {len(written)} frames")
        return total


def proposals_to_kitti(boxes3d: np.ndarray, scores: np.ndarray,
                       valid: np.ndarray, calib, image_hw=(375, 1242),
                       cls_name: str = "Car", classes: np.ndarray = None,
                       class_names=None):
    """Decoded proposals of one frame (numpy) -> KITTI label lines with
    the projected 2D boxes.  With ``classes`` and ``class_names`` each
    line carries its class; otherwise every line is ``cls_name``."""
    lines = []
    H, W = image_hw
    for i, (b, s, v) in enumerate(zip(boxes3d, scores, valid)):
        if not v or not np.isfinite(s):
            continue
        uv = calib.rect_to_image(gbox.box_corners_cam(b))
        box2d = np.array([uv[:, 0].min(), uv[:, 1].min(), uv[:, 0].max(),
                          uv[:, 1].max()])
        box2d = np.clip(box2d, 0, [W - 1, H - 1, W - 1, H - 1])
        name = cls_name
        if classes is not None and class_names is not None:
            name = class_names[int(classes[i])]
        lines.append(instance_line(b, box2d, float(s), name))
    return lines
