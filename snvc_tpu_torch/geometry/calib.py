"""KITTI calibration and label parsing (port of
snvc_tpu/geometry/calib.py, a numpy copy: the port imports nothing of the
JAX package).

Conventions of the KITTI devkit:

  * rect camera frame: x right, y down, z forward,
  * velodyne frame: x forward, y left, z up,
  * labels live in the rect frame; image coords are 0-based pixels,
  * ``P`` is the 3x4 projection from rect coords to image pixels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Labels
# ---------------------------------------------------------------------------

# class-id mapping used across the framework
# (reference: snvc/dataset/KITTILoader3D.py:29-35)
CLASS_IDS = {
    "Pedestrian": 1,
    "Person_sitting": 1,
    "Car": 2,
    "Van": 2,
    "Cyclist": 3,
    "DontCare": 4,
}
SKIP_TYPES = frozenset(["Misc", "Tram", "Truck"])


@dataclass
class KittiLabel:
    """One KITTI label/prediction line (reference: kitti_util.py:12-67).

    ``box3d`` here uses the *reordered* convention produced by the
    reference's annotation filter (KITTILoader3D.py:59):
    ``[h, w, l, x, y, z, ry]`` with (x, y, z) the *bottom-center* in the
    rect camera frame.
    """

    type: str
    truncation: float
    occlusion: int
    alpha: float
    box2d: np.ndarray  # [4] x1 y1 x2 y2
    box3d: np.ndarray  # [7] h w l x y z ry
    score: Optional[float] = None

    @property
    def h(self):
        return self.box3d[0]

    @property
    def w(self):
        return self.box3d[1]

    @property
    def l(self):
        return self.box3d[2]

    @property
    def location(self):
        return self.box3d[3:6]

    @property
    def ry(self):
        return self.box3d[6]


def parse_label_line(line: str) -> KittiLabel:
    parts = line.strip().split(" ")
    vals = [float(v) for v in parts[1:]]
    return KittiLabel(
        type=parts[0],
        truncation=vals[0],
        occlusion=int(vals[1]),
        alpha=vals[2],
        box2d=np.array(vals[3:7], dtype=np.float32),
        box3d=np.array(
            [vals[7], vals[8], vals[9], vals[10], vals[11], vals[12], vals[13]],
            dtype=np.float32,
        ),
        score=vals[14] if len(vals) >= 15 else None,
    )


def read_label(path: str) -> List[KittiLabel]:
    with open(path, "r") as f:
        lines = [ln for ln in (l.strip() for l in f) if ln]
    return [parse_label_line(ln) for ln in lines]


def format_label(lab: KittiLabel, precision: int = 8) -> str:
    """KITTI-format output line (reference: kitti_util.py:90-99)."""
    h, w, l, x, y, z, ry = [float(v) for v in lab.box3d]
    x1, y1, x2, y2 = [float(v) for v in lab.box2d]
    fields = [
        lab.type,
        f"{lab.truncation:.1f}",
        f"{lab.occlusion:d}",
        f"{lab.alpha:.6f}",
        f"{x1:.6f}",
        f"{y1:.6f}",
        f"{x2:.6f}",
        f"{y2:.6f}",
        f"{h:.6f}",
        f"{w:.6f}",
        f"{l:.6f}",
        f"{x:.6f}",
        f"{y:.6f}",
        f"{z:.6f}",
        f"{ry:.6f}",
    ]
    if lab.score is not None:
        fields.append(f"{lab.score:.{precision}f}")
    return " ".join(fields)


def filter_annotations(
    labels: Sequence[KittiLabel],
    valid_classes: Sequence[int] = (1, 2, 3, 4),
    depth_range=None,
    truncation_threshold: float = 0.98,
    ignore_truncation: bool = True,
):
    """Filter raw labels into (box2d [N,4], box3d [N,7], class [N], score [N]).

    Reproduces the reference annotation filter
    (snvc/dataset/KITTILoader3D.py:5-82): class mapping, truncation gating
    (over-truncated boxes become DontCare), and depth-range filtering.
    """
    boxes2d, boxes3d, classes, scores = [], [], [], []
    valid = set(valid_classes)
    for lab in labels:
        if lab.type in SKIP_TYPES:
            continue
        typ = CLASS_IDS.get(lab.type)
        if typ is None:
            raise ValueError(f"invalid label type {lab.type!r}")
        if typ != 4 and typ not in (valid - {4}):
            continue
        if ignore_truncation and lab.truncation >= truncation_threshold:
            typ = 4
        if typ not in valid:
            continue
        z = lab.box3d[5]
        if depth_range is not None and (z < depth_range[0] or z > depth_range[1]):
            continue
        boxes2d.append(lab.box2d)
        boxes3d.append(lab.box3d)
        classes.append(typ)
        scores.append(lab.score if lab.score is not None else np.nan)
    n = len(boxes3d)
    return (
        np.asarray(boxes2d, dtype=np.float32).reshape(n, 4),
        np.asarray(boxes3d, dtype=np.float32).reshape(n, 7),
        np.asarray(classes, dtype=np.int32),
        np.asarray(scores, dtype=np.float32),
    )


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------


def _invert_rigid(tr: np.ndarray) -> np.ndarray:
    """Invert a 3x4 [R|t] rigid transform (reference: kitti_util.py:348-355)."""
    out = np.zeros_like(tr)
    out[:3, :3] = tr[:3, :3].T
    out[:3, 3] = -tr[:3, :3].T @ tr[:3, 3]
    return out


class Calibration:
    """KITTI camera calibration with vectorized projections.

    Mirrors the reference API surface (kitti_util.py:104-346) that the rest
    of the pipeline depends on: rect<->velo transforms, rect->image
    projection, and image+depth -> rect back-projection.
    """

    def __init__(self, P, V2C=None, R0=None):
        self.P = np.asarray(P, dtype=np.float64).reshape(3, 4)
        self.V2C = (
            np.asarray(V2C, dtype=np.float64).reshape(3, 4)
            if V2C is not None
            else np.array([[0.0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0]])
        )
        self.C2V = _invert_rigid(self.V2C)
        self.R0 = (
            np.asarray(R0, dtype=np.float64).reshape(3, 3)
            if R0 is not None
            else np.eye(3)
        )
        self.c_u = self.P[0, 2]
        self.c_v = self.P[1, 2]
        self.f_u = self.P[0, 0]
        self.f_v = self.P[1, 1]
        self.b_x = self.P[0, 3] / (-self.f_u)
        self.b_y = self.P[1, 3] / (-self.f_v)

    # -- constructors ----------------------------------------------------
    @staticmethod
    def read_calib_file(path: str) -> Dict[str, np.ndarray]:
        data = {}
        with open(path, "r") as f:
            for line in f:
                line = line.rstrip()
                if not line or ":" not in line:
                    continue
                key, value = line.split(":", 1)
                try:
                    data[key] = np.array([float(x) for x in value.split()])
                except ValueError:
                    pass
        return data

    @classmethod
    def from_file(cls, path: str, camera: str = "left") -> "Calibration":
        d = cls.read_calib_file(path)
        P = d["P2"] if camera == "left" else d["P3"]
        return cls(P, d.get("Tr_velo_to_cam"), d.get("R0_rect"))

    @classmethod
    def default(cls) -> "Calibration":
        """A plausible KITTI calibration for tests (kitti_util.py:188-203)."""
        P = np.array(
            [
                [707.0493, 0.0, 604.0814, 45.75831],
                [0.0, 707.0493, 180.5066, -0.3454157],
                [0.0, 0.0, 1.0, 0.004981016],
            ]
        )
        return cls(P)

    @classmethod
    def default_right(cls) -> "Calibration":
        """Right camera: same intrinsics with stereo baseline ~0.54m."""
        P = np.array(
            [
                [707.0493, 0.0, 604.0814, -337.2877],
                [0.0, 707.0493, 180.5066, 2.199936],
                [0.0, 0.0, 1.0, 0.002729905],
            ]
        )
        return cls(P)

    @property
    def baseline(self) -> float:
        """Stereo baseline if this is paired with a reference camera at b_x=0."""
        return float(self.b_x)

    # -- 3d <-> 3d -------------------------------------------------------
    def _hom(self, pts):
        pts = np.asarray(pts, dtype=np.float64)
        return np.concatenate([pts, np.ones_like(pts[:, :1])], axis=1)

    def velo_to_rect(self, pts_velo):
        ref = self._hom(pts_velo) @ self.V2C.T
        return ref @ self.R0.T

    def rect_to_velo(self, pts_rect):
        ref = np.asarray(pts_rect) @ np.linalg.inv(self.R0).T
        return self._hom(ref) @ self.C2V.T

    # -- 3d -> 2d --------------------------------------------------------
    def rect_to_image(self, pts_rect, keep_z: bool = False):
        """Project [N,3] rect points to [N,2] pixels (kitti_util.py:282-293)."""
        uvw = self._hom(pts_rect) @ self.P.T
        uv = uvw[:, :2] / uvw[:, 2:3]
        if keep_z:
            return np.concatenate([uv, uvw[:, 2:3]], axis=1)
        return uv

    # -- 2d -> 3d --------------------------------------------------------
    def image_to_rect(self, uv_depth):
        """Back-project [N,3] (u, v, depth) to rect (kitti_util.py:305-317)."""
        uv_depth = np.asarray(uv_depth, dtype=np.float64)
        x = (uv_depth[:, 0] - self.c_u) * uv_depth[:, 2] / self.f_u + self.b_x
        y = (uv_depth[:, 1] - self.c_v) * uv_depth[:, 2] / self.f_v + self.b_y
        return np.stack([x, y, uv_depth[:, 2]], axis=1)

    # compact array form for feeding devices
    def as_array(self) -> np.ndarray:
        return self.P.astype(np.float32)


def ry_to_alpha(x: float, z: float, ry: float) -> float:
    """Egocentric -> allocentric angle in [-pi, pi]
    (reference: tools/inference_agnostic.py:337-344)."""
    a = ry - np.arctan2(-z, x) - 0.5 * np.pi
    return float((a + np.pi) % (2 * np.pi) - np.pi)


def alpha_to_ry(x: float, z: float, alpha: float) -> float:
    a = alpha + np.arctan2(-z, x) + 0.5 * np.pi
    return float((a + np.pi) % (2 * np.pi) - np.pi)
