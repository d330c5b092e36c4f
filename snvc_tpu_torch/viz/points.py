"""What the port's renders share of snvc_tpu/viz/points.py: the cuboid edge
list and the BEV footprints of ``plot_bev_boxes``, drawn into image arrays
with ``geometry/raster.line_pixels`` instead of onto matplotlib axes.

JAX's axes helpers (``plot_3d_points``, ``plot_lines``, ``plot_3d_bbox``,
``plot_2d_bbox``, ``set_3d_axe_limits``, ``plot_lidar_bev``) draw on
matplotlib figures and stay JAX-only: no path of the port calls them.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from snvc_tpu_torch.geometry import boxes as gbox
from snvc_tpu_torch.geometry.raster import line_pixels

# edges between the 8 box corners (the framework's part order 1..8,
# 0-based; JAX viz/points.py:20-26)
BOX_EDGES = np.array([[0, 1], [0, 2], [1, 3], [2, 3],
                      [4, 5], [5, 7], [4, 6], [6, 7],
                      [0, 4], [1, 5], [2, 6], [3, 7]])

# pixels on, then off, along a dashed / dotted segment
DASH = (4, 3)
DOT = (1, 2)


def bev_footprints(boxes3d) -> np.ndarray:
    """[N, 4, 2] (x, z) of the bottom corners of box3d [N, 7], in ring
    order (the odd part indices, JAX ``plot_bev_boxes``)."""
    boxes3d = np.asarray(boxes3d).reshape(-1, 7)
    corners = gbox.box_corners_cam(boxes3d)
    return corners[:, [1, 3, 7, 5]][..., [0, 2]]


def draw_segment(img: np.ndarray, p0, p1, color: Sequence[int],
                 pattern=None) -> None:
    """Draw the 8-connected segment p0 -> p1 ((x, y) pixel points, rounded)
    into ``img`` [H, W, 3] in place.  ``pattern`` = (on, off) pixel counts
    dashes it; both end pixels are always drawn."""
    h, w = img.shape[:2]
    a = (int(round(float(p0[0]))), int(round(float(p0[1]))))
    b = (int(round(float(p1[0]))), int(round(float(p1[1]))))
    ys, xs = line_pixels((w, h), a, b)
    if pattern is not None and len(ys):
        on, off = pattern
        keep = (np.arange(len(ys)) % (on + off)) < on
        keep[0] = keep[-1] = True
        ys, xs = ys[keep], xs[keep]
    img[ys, xs] = np.asarray(color, img.dtype)


def draw_ring(img: np.ndarray, pts, color: Sequence[int],
              pattern=None) -> None:
    """A closed polygon of (x, y) pixel points, each side by
    ``draw_segment``."""
    pts = np.asarray(pts, np.float64).reshape(-1, 2)
    for i in range(len(pts)):
        draw_segment(img, pts[i], pts[(i + 1) % len(pts)], color, pattern)
