"""Affine ROI-crop math and heatmaps, host numpy (port of
snvc_tpu/geometry/imgproc.py): keypoints -> crop box -> 2x3 source->ROI
affine, the inverse and application of 2x3 affines, and the dense 2D
gaussian dot."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def points_to_crop(kpts, enlarge: float = 1.1, aspect_ratio: float = 1.0):
    """2D keypoints [N, 2] -> (center [2], size [2] = (w, h)): the bounding
    box enlarged by ``enlarge``, the smaller side grown to the aspect."""
    kpts = np.asarray(kpts, dtype=np.float64)
    lo, hi = kpts.min(axis=0), kpts.max(axis=0)
    center = 0.5 * (lo + hi)
    w, h = (hi - lo) * enlarge
    if h / max(w, 1e-12) > aspect_ratio:
        w = h / aspect_ratio
    else:
        h = w * aspect_ratio
    return center, np.array([w, h])


def crop_affine(center, size, out_hw: Tuple[int, int]) -> np.ndarray:
    """2x3 affine: uniform scale out_w / crop_w about the crop center."""
    out_h, out_w = out_hw
    k = out_w / size[0]
    return np.array([[k, 0.0, 0.5 * out_w - k * center[0]],
                     [0.0, k, 0.5 * out_h - k * center[1]]])


def roi_crop_transform(kpts_2d, out_hw: Tuple[int, int],
                       enlarge: float = 1.1) -> np.ndarray:
    """Keypoints -> 2x3 source->ROI affine, using out_hw's aspect ratio."""
    c, s = points_to_crop(kpts_2d, enlarge, out_hw[0] / out_hw[1])
    return crop_affine(c, s, out_hw)


def invert_affine(t: np.ndarray) -> np.ndarray:
    """Invert a 2x3 affine."""
    Ai = np.linalg.inv(t[:, :2])
    return np.concatenate([Ai, (-Ai @ t[:, 2])[:, None]], axis=1)


def apply_affine(pts, t) -> np.ndarray:
    """Apply 2x3 affine(s) t [..., 2, 3] to points [..., N, 2] ->
    [..., N, 2] (row-major points, where the reference returns [2, N])."""
    pts, t = np.asarray(pts), np.asarray(t)
    return (np.einsum("...ij,...nj->...ni", t[..., :2], pts)
            + t[..., None, :, 2])


def gaussian_heatmap_2d(shape_hw, center_xy, sigma: float) -> np.ndarray:
    """Dense 2D gaussian dot exp(-d^2 / (2 sigma^2)) over an (h, w) grid,
    zero outside the square |dx|, |dy| <= 3 sigma, the window the
    reference blits (KITTIRefinement_dataset.py:666-702)."""
    h, w = shape_hw
    ys = np.arange(h).reshape(h, 1)
    xs = np.arange(w).reshape(1, w)
    mx, my = center_xy
    dx2 = (xs - mx) ** 2
    dy2 = (ys - my) ** 2
    g = np.exp(-(dx2 + dy2) / (2.0 * sigma ** 2))
    r2 = float((3 * sigma) ** 2)
    return np.where((dx2 <= r2) & (dy2 <= r2), g, 0.0)
