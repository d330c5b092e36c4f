"""Frame-level batching for the global stereo detector (port of
snvc_tpu/data/stereo_pipeline.py).

Host work per frame: decode the stereo pair, downscale and pad to the
static input size (the views of a batch that fit it decode in one
native batch, ``data/native_loader.py``), parse calib / labels, and rasterize a
sparse GT depth map from LiDAR (``data/stereo.rasterize_depth``).  With
``augment_flip`` a training frame may be flipped exactly: the world and
both images mirrored, the views swapped.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from snvc_tpu_torch.config import StereoConfig
from snvc_tpu_torch.data import native_loader
from snvc_tpu_torch.data.kitti import KittiDataset, KittiScene
from snvc_tpu_torch.data.png import png_size
from snvc_tpu_torch.data.stereo import rasterize_depth
from snvc_tpu_torch.geometry.calib import CLASS_IDS, filter_annotations


@dataclass
class StereoBatch:
    images_left: np.ndarray  # [B, H, W, 3] uint8
    images_right: np.ndarray
    P_left: np.ndarray  # [B, 3, 4]
    P_right: np.ndarray
    gt_boxes: np.ndarray  # [B, G, 7]
    gt_valid: np.ndarray  # [B, G]
    gt_classes: np.ndarray  # [B, G]
    depth_gt: np.ndarray  # [B, H/4, W/4] (-1 where unobserved)
    scene_names: List[str] = None

    def arrays(self) -> Dict[str, np.ndarray]:
        return dict(
            images_left=self.images_left,
            images_right=self.images_right,
            P_left=self.P_left,
            P_right=self.P_right,
            gt_boxes=self.gt_boxes,
            gt_valid=self.gt_valid,
            gt_classes=self.gt_classes,
            depth_gt=self.depth_gt,
        )


def load_views_scaled(views: Sequence[Tuple[KittiScene, str]], out_hw
                      ) -> List[Tuple[np.ndarray, float]]:
    """``scene.load_image_scaled(camera, out_hw)`` of each (scene, camera):
    the views that fit the canvas (s = 1) decode in one
    ``decode_batch_padded`` call, the others one at a time through
    ``load_image_scaled``'s area downscale."""
    fits = [h <= out_hw[0] and w <= out_hw[1] for h, w in
            (png_size(sc.image_path(cam)) for sc, cam in views)]
    direct = native_loader.decode_batch_padded(
        [sc.image_path(cam) if f else None
         for (sc, cam), f in zip(views, fits)], out_hw)
    return [(direct[i], 1.0) if f else sc.load_image_scaled(cam, out_hw)
            for i, ((sc, cam), f) in enumerate(zip(views, fits))]


class StereoPipeline:
    def __init__(
        self,
        dataset: KittiDataset,
        cfg: StereoConfig,
        batch_size: int = 1,
        max_gt: int = 24,
        training: bool = True,
        valid_classes=None,
        augment_flip: bool = False,
        seed: int = 0,
    ):
        self.ds = dataset
        self.cfg = cfg
        self.batch_size = batch_size
        self.max_gt = max_gt
        self.training = training
        # class slots follow cfg.class_names (KITTI ids via CLASS_IDS);
        # an explicit valid_classes overrides the id filter only
        if len(cfg.class_names) != cfg.num_classes:
            raise ValueError(
                f"StereoConfig.class_names {cfg.class_names} must have "
                f"num_classes={cfg.num_classes} entries"
            )
        ids = [CLASS_IDS[n] for n in cfg.class_names]
        self.valid_classes = (
            tuple(valid_classes) if valid_classes is not None else tuple(ids)
        )
        self._id_to_slot = {cid: slot for slot, cid in enumerate(ids)}
        self.augment_flip = augment_flip and training
        self._flip_rng = np.random.default_rng(seed + 101)

    def __len__(self):
        return int(np.ceil(len(self.ds) / self.batch_size))

    def index_groups(self) -> List[List[int]]:
        """Sequential frame-index groups, one per batch, the last padded
        by repeating its final frame (JAX stereo_pipeline.py:102-113): for
        callers that build batches with explicit ``flips``, such as both
        orientations of every frame for replayed training."""
        groups = []
        for s in range(0, len(self.ds), self.batch_size):
            idxs = list(self.ds.indices[s:s + self.batch_size])
            groups.append(idxs + [idxs[-1]] * (self.batch_size - len(idxs)))
        return groups

    def batches(self, shuffle: bool = False, seed: int = 0) -> Iterator[StereoBatch]:
        order = np.arange(len(self.ds))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for s in range(0, len(order), self.batch_size):
            idxs = [self.ds.indices[i] for i in order[s : s + self.batch_size]]
            if len(idxs) < self.batch_size:
                idxs = idxs + [idxs[-1]] * (self.batch_size - len(idxs))
            flips = (
                self._flip_rng.random(len(idxs)) < 0.5
                if self.augment_flip else None
            )
            yield self.make_batch(idxs, flips=flips)

    def make_batch(
        self, frame_indices: Sequence[int], flips=None
    ) -> StereoBatch:
        cfg = self.cfg
        H, W = cfg.input_size
        B = len(frame_indices)
        G = self.max_gt
        il = np.zeros((B, H, W, 3), np.uint8)
        ir = np.zeros((B, H, W, 3), np.uint8)
        Pl = np.zeros((B, 3, 4), np.float32)
        Pr = np.zeros((B, 3, 4), np.float32)
        boxes = np.zeros((B, G, 7), np.float32)
        valid = np.zeros((B, G), bool)
        classes = np.zeros((B, G), np.int32)
        depth = np.full((B, H // 4, W // 4), -1.0, np.float32)
        names = []
        scenes = [self.ds.scene(idx) for idx in frame_indices]
        # aspect-preserving downscale when the target resolution is below
        # native, with the projection scaled to match (reduced-resolution
        # training keeps full-frame geometry)
        views = load_views_scaled(
            [(sc, cam) for cam in ("left", "right") for sc in scenes], (H, W))
        for b, scene in enumerate(scenes):
            names.append(scene.name)
            flip = bool(flips[b]) if flips is not None else False
            (iml, s), (imr, _) = views[b], views[B + b]
            cl = scene.calibration("left")
            cr = scene.calibration("right")
            S = np.diag([s, s, 1.0]).astype(np.float32)
            if flip:
                # EXACT stereo flip: mirror the world (x -> -x) and both
                # images, then swap views — the mirrored right camera
                # lands LEFT of the mirrored left camera, so the swapped
                # pair is again rectified with positive disparity.  The
                # mirror axis is the CONTENT width (the canvas is
                # right/bottom zero-padded), and the new projections are
                # F @ P_other @ M so all downstream geometry (plane-sweep
                # baseline, frustum resampling) stays consistent without
                # assuming a canonical rig.
                nh, nw = scene.native_image_size()
                wc = int(round(nw * s))
                F = np.array(
                    [[-1.0, 0.0, wc - 1.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
                    np.float32,
                )
                M = np.diag([-1.0, 1.0, 1.0, 1.0]).astype(np.float32)

                def mirror(img):
                    out = img.copy()
                    out[:, :wc] = img[:, wc - 1 :: -1]
                    return out

                il[b], ir[b] = mirror(imr), mirror(iml)
                Pl[b] = F @ (S @ cr.as_array()) @ M
                Pr[b] = F @ (S @ cl.as_array()) @ M
            else:
                il[b], ir[b] = iml, imr
                Pl[b] = S @ cl.as_array()
                Pr[b] = S @ cr.as_array()
            if self.training and scene.label_dir:
                _, b3, cls, _ = filter_annotations(
                    scene.labels(),
                    valid_classes=self.valid_classes,
                    depth_range=(cfg.z_min, cfg.z_max),
                )
                b3 = np.array(b3, np.float32).reshape(-1, 7)
                if flip and len(b3):
                    b3[:, 3] *= -1.0
                    b3[:, 6] = (np.pi - b3[:, 6] + np.pi) % (2 * np.pi) - np.pi
                n = min(len(b3), G)
                boxes[b, :n] = b3[:n]
                valid[b, :n] = True
                # KITTI class id -> model class slot (cfg.class_names order)
                classes[b, :n] = [
                    self._id_to_slot[int(c)] for c in cls[:n]
                ]
                pc = scene.lidar()[:, :3]
                pc_rect = cl.velo_to_rect(pc).astype(np.float32)
                if flip:
                    pc_rect = pc_rect * np.array([-1, 1, 1], np.float32)
                depth[b] = rasterize_depth(pc_rect, Pl[b], (H, W))
        return StereoBatch(
            images_left=il, images_right=ir, P_left=Pl, P_right=Pr,
            gt_boxes=boxes, gt_valid=valid, gt_classes=classes,
            depth_gt=depth, scene_names=names,
        )
