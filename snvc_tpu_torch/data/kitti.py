"""KITTI on-disk dataset access (port of snvc_tpu/data/kitti.py).

One index-addressed accessor over the standard KITTI object layout:

    root/
      training/ image_2/ image_3/ calib/ label_2/ velodyne/
      testing/  image_2/ image_3/ calib/ velodyne/
      train.txt val.txt trainval.txt test.txt

Images are decoded by the native loader (``data/native_loader.py``,
``csrc/dataloader.cpp``: zlib, no cv2, no libpng) straight into their
padded canvases, as the JAX package's ``load_image_padded`` decodes them
with its libpng loader: the same pixels for KITTI's 8-bit PNGs.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from snvc_tpu_torch.data import native_loader
from snvc_tpu_torch.data.png import png_size, resize_area
from snvc_tpu_torch.geometry.calib import Calibration, KittiLabel, read_label


def read_split(path: str) -> List[int]:
    with open(path, "r") as f:
        return [int(x) for x in (ln.strip() for ln in f) if x]


def _place(src: np.ndarray, out_hw) -> np.ndarray:
    """``src`` in the top-left corner of a zero [out_h, out_w, 3] canvas,
    cropped where it is larger."""
    out = np.zeros((out_hw[0], out_hw[1], 3), np.uint8)
    h = min(src.shape[0], out_hw[0])
    w = min(src.shape[1], out_hw[1])
    out[:h, :w] = src[:h, :w]
    return out


@dataclass
class KittiScene:
    """Paths + lazy accessors for one frame."""

    index: int
    image_dir: str
    right_image_dir: str
    calib_dir: str
    lidar_dir: str
    label_dir: Optional[str]

    @property
    def name(self) -> str:
        return f"{self.index:06d}"

    @property
    def left_image_path(self) -> str:
        return os.path.join(self.image_dir, self.name + ".png")

    @property
    def right_image_path(self) -> str:
        return os.path.join(self.right_image_dir, self.name + ".png")

    @property
    def lidar_path(self) -> str:
        return os.path.join(self.lidar_dir, self.name + ".bin")

    @property
    def calib_path(self) -> str:
        return os.path.join(self.calib_dir, self.name + ".txt")

    def calibration(self, camera: str = "left") -> Calibration:
        return Calibration.from_file(self.calib_path, camera)

    def labels(self) -> List[KittiLabel]:
        if self.label_dir is None:
            raise ValueError(f"scene {self.name}: the split has no labels")
        return read_label(os.path.join(self.label_dir, self.name + ".txt"))

    def lidar(self) -> np.ndarray:
        """[N, 4] velodyne points (x, y, z, reflectance)."""
        return np.fromfile(self.lidar_path, dtype=np.float32).reshape(-1, 4)

    def native_image_size(self) -> Tuple[int, int]:
        """(H, W) of the stored left image, from the PNG header (no
        decode).  FOV checks gate on it, not on the padded canvas."""
        if not hasattr(self, "_native_hw"):
            self._native_hw = png_size(self.left_image_path)
        return self._native_hw

    def image_path(self, camera: str) -> str:
        return (self.left_image_path if camera == "left"
                else self.right_image_path)

    def load_image(self, camera: str = "left") -> np.ndarray:
        """RGB uint8 [H, W, 3]."""
        path = self.image_path(camera)
        return native_loader.decode_png_padded(path, png_size(path))

    def load_image_padded(self, camera: str, out_hw) -> np.ndarray:
        """RGB uint8 [out_h, out_w, 3], zero padded / cropped, decoded
        straight into the canvas by the native loader."""
        return native_loader.decode_png_padded(self.image_path(camera),
                                               out_hw)

    def load_image_scaled(self, camera: str, out_hw):
        """(RGB uint8 [out_h, out_w, 3], s): an aspect-preserving area
        downscale by s when the image exceeds the target (s = 1
        otherwise), then zero padding.  The matching projection is
        diag(s, s, 1) @ P."""
        src = self.load_image(camera)
        h, w = src.shape[:2]
        s = min(out_hw[0] / h, out_hw[1] / w)
        if s < 1.0:
            src = resize_area(src, (int(round(h * s)), int(round(w * s))))
        else:
            s = 1.0
        return _place(src, out_hw), s


class KittiDataset:
    """Split-aware KITTI object dataset."""

    def __init__(self, root: str, split: str = "train"):
        self.root = root
        self.split = split
        folder = "testing" if split == "test" else "training"
        base = os.path.join(root, folder)
        self.image_dir = os.path.join(base, "image_2")
        self.right_image_dir = os.path.join(base, "image_3")
        self.calib_dir = os.path.join(base, "calib")
        self.lidar_dir = os.path.join(base, "velodyne")
        self.label_dir = (
            os.path.join(base, "label_2") if split != "test" else None
        )
        split_file = os.path.join(root, split + ".txt")
        if os.path.exists(split_file):
            self.indices = read_split(split_file)
        else:
            names = (sorted(os.listdir(self.image_dir))
                     if os.path.isdir(self.image_dir) else [])
            self.indices = [int(n.split(".")[0]) for n in names
                            if n.endswith(".png")]

    def __len__(self) -> int:
        return len(self.indices)

    def scene(self, index: int) -> KittiScene:
        return KittiScene(
            index=index,
            image_dir=self.image_dir,
            right_image_dir=self.right_image_dir,
            calib_dir=self.calib_dir,
            lidar_dir=self.lidar_dir,
            label_dir=self.label_dir,
        )

    def scenes(self) -> List[KittiScene]:
        return [self.scene(i) for i in self.indices]
