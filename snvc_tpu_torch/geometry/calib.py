"""KITTI camera calibration (the part of snvc_tpu/geometry/calib.py the
serving paths use): the default stereo pair, rect -> image projection and
the egocentric -> allocentric angle."""

from __future__ import annotations

import numpy as np


class Calibration:
    """A 3x4 rect -> image projection ``P`` (KITTI devkit convention)."""

    def __init__(self, P):
        self.P = np.asarray(P, dtype=np.float64).reshape(3, 4)

    @classmethod
    def default(cls) -> "Calibration":
        """A plausible KITTI left-camera calibration (kitti_util.py:188-203)."""
        return cls([[707.0493, 0.0, 604.0814, 45.75831],
                    [0.0, 707.0493, 180.5066, -0.3454157],
                    [0.0, 0.0, 1.0, 0.004981016]])

    @classmethod
    def default_right(cls) -> "Calibration":
        """Right camera: same intrinsics, stereo baseline ~0.54 m."""
        return cls([[707.0493, 0.0, 604.0814, -337.2877],
                    [0.0, 707.0493, 180.5066, 2.199936],
                    [0.0, 0.0, 1.0, 0.002729905]])

    def rect_to_image(self, pts_rect) -> np.ndarray:
        """[N, 3] rect points -> [N, 2] pixels."""
        pts = np.asarray(pts_rect, dtype=np.float64)
        uvw = np.concatenate([pts, np.ones_like(pts[:, :1])], axis=1) @ self.P.T
        return uvw[:, :2] / uvw[:, 2:3]

    def as_array(self) -> np.ndarray:
        return self.P.astype(np.float32)


def ry_to_alpha(x: float, z: float, ry: float) -> float:
    """Egocentric -> allocentric angle in [-pi, pi]
    (reference: tools/inference_agnostic.py:337-344)."""
    a = ry - np.arctan2(-z, x) - 0.5 * np.pi
    return float((a + np.pi) % (2 * np.pi) - np.pi)
