"""LiDAR top views (port of snvc_tpu/viz/lidar.py, numpy; held to JAX bit
for bit by tests/test_torch_viz.py).

The reference's legacy LiDAR view (snvc/visualization/kitti_util.py:
418-530, ``lidar_to_top`` / ``lidar_to_top_coords``; :696-752,
``draw_top_image`` / ``draw_box3d_on_top``): the multi-channel BEV "top
tensor" of a scan and a uint8 top-view image with box footprints drawn on
it.

Encoding: a velodyne-frame point cloud is binned on an (x, y) grid; the
tensor has ``nz + 2`` channels:

* channels ``0..nz-1``: per-z-slice max height above the slice bottom
  (in units of ``z_division``),
* channel ``nz``: reflectance of the highest point in the cell,
* channel ``nz + 1``: ``min(1, log(count + 1) / log(32))`` point density.

Row 0 of the image is the far +x edge and column 0 the +y (left) edge, so
the ego vehicle sits at the bottom center, facing up.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "TopViewSpec",
    "lidar_to_top",
    "top_coords",
    "top_view_image",
    "draw_boxes_on_top",
]


@dataclass(frozen=True)
class TopViewSpec:
    """Grid extents for the top-view tensor (velodyne frame, meters).

    Defaults mirror the reference constants
    (snvc/visualization/kitti_util.py:13-23).
    """

    x_range: tuple = (0.0, 100.0)   # forward
    y_range: tuple = (-30.0, 30.0)  # left
    z_range: tuple = (-3.5, 0.6)    # up
    xy_division: float = 0.2
    z_division: float = 0.3

    @property
    def nx(self) -> int:
        return int((self.x_range[1] - self.x_range[0]) / self.xy_division) + 1

    @property
    def ny(self) -> int:
        return int((self.y_range[1] - self.y_range[0]) / self.xy_division) + 1

    @property
    def nz(self) -> int:
        return int((self.z_range[1] - self.z_range[0]) / self.z_division)


def top_coords(x, y, spec: TopViewSpec = TopViewSpec()):
    """Velodyne (x, y) -> (row, col) in the flipped top-view image.

    Vectorized equivalent of the reference's ``lidar_to_top_coords``
    (kitti_util.py:418-426) with explicit (clean) flips instead of
    negative indexing.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    qx = np.floor((x - spec.x_range[0]) / spec.xy_division).astype(np.int64)
    qy = np.floor((y - spec.y_range[0]) / spec.xy_division).astype(np.int64)
    row = spec.nx - 1 - qx
    col = spec.ny - 1 - qy
    return row, col


def lidar_to_top(points: np.ndarray, spec: TopViewSpec = TopViewSpec()):
    """Encode an ``[N, 4]`` velodyne scan as an ``[nx, ny, nz + 2]`` tensor.

    Same channel semantics as the reference's ``lidar_to_top``
    (kitti_util.py:428-515) but fully vectorized (bincount / maximum.at
    over flat cell ids instead of the reference's per-cell triple loop).
    """
    points = np.asarray(points, dtype=np.float32)
    if points.ndim != 2 or points.shape[1] < 3:
        raise ValueError(f"expected [N, >=3] points, got {points.shape}")
    if points.shape[1] == 3:  # tolerate xyz-only clouds: zero reflectance
        points = np.concatenate(
            [points, np.zeros((len(points), 1), np.float32)], axis=1
        )

    (x0, x1), (y0, y1), (z0, z1) = spec.x_range, spec.y_range, spec.z_range
    m = (
        (points[:, 0] > x0) & (points[:, 0] < x1)
        & (points[:, 1] > y0) & (points[:, 1] < y1)
        & (points[:, 2] > z0) & (points[:, 2] < z1)
    )
    pts = points[m]
    nx, ny, nz = spec.nx, spec.ny, spec.nz
    top = np.zeros((nx, ny, nz + 2), dtype=np.float32)
    if len(pts) == 0:
        return top

    qx = ((pts[:, 0] - x0) // spec.xy_division).astype(np.int64)
    qy = ((pts[:, 1] - y0) // spec.xy_division).astype(np.int64)
    qz = (pts[:, 2] - z0) / spec.z_division  # fractional slice coordinate
    refl = pts[:, 3]
    # flipped image layout (see module docstring)
    row = nx - 1 - qx
    col = ny - 1 - qy
    cell = row * ny + col

    # density channel
    counts = np.bincount(cell, minlength=nx * ny).astype(np.float32)
    dens = np.minimum(1.0, np.log1p(counts) / np.log(32.0))
    dens[counts == 0] = 0.0
    top[:, :, nz + 1] = dens.reshape(nx, ny)

    # intensity of the per-cell highest point: sort by (cell, qz) and keep
    # the last entry of every cell run
    order = np.lexsort((qz, cell))
    cs, zs, rs = cell[order], qz[order], refl[order]
    last = np.ones(len(cs), dtype=bool)
    last[:-1] = cs[1:] != cs[:-1]
    inten = np.zeros(nx * ny, dtype=np.float32)
    inten[cs[last]] = rs[last]
    top[:, :, nz] = inten.reshape(nx, ny)

    # per-slice max height above the slice bottom
    sl = np.clip(np.floor(qz).astype(np.int64), 0, nz - 1)
    flat = np.zeros(nz * nx * ny, dtype=np.float32)
    np.maximum.at(flat, sl * (nx * ny) + cell, (qz - sl).astype(np.float32))
    top[:, :, :nz] = flat.reshape(nz, nx, ny).transpose(1, 2, 0)
    return top


def top_view_image(top: np.ndarray) -> np.ndarray:
    """Collapse a top tensor to a uint8 grayscale RGB image.

    Equivalent of the reference's ``draw_top_image`` (kitti_util.py:696-702):
    channel sum, min-max normalize, replicate to 3 channels.
    """
    img = np.sum(np.asarray(top, dtype=np.float32), axis=2)
    lo, hi = float(img.min()), float(img.max())
    img = (img - lo) / (hi - lo) * 255.0 if hi > lo else np.zeros_like(img)
    return np.repeat(img.astype(np.uint8)[:, :, None], 3, axis=2)


def _draw_segment(img, r0, c0, r1, c1, color):
    """Rasterize one line segment into an HxWx3 uint8 image (pure numpy)."""
    n = int(max(abs(r1 - r0), abs(c1 - c0))) + 1
    rr = np.round(np.linspace(r0, r1, n)).astype(np.int64)
    cc = np.round(np.linspace(c0, c1, n)).astype(np.int64)
    ok = (rr >= 0) & (rr < img.shape[0]) & (cc >= 0) & (cc < img.shape[1])
    img[rr[ok], cc[ok]] = color


def draw_boxes_on_top(
    image: np.ndarray,
    corners_velo: np.ndarray,
    spec: TopViewSpec = TopViewSpec(),
    color=(255, 255, 255),
    scores=None,
    gt_color=(0, 255, 0),
    is_gt: bool = False,
) -> np.ndarray:
    """Draw BEV box footprints onto a top-view image.

    Equivalent of the reference's ``draw_box3d_on_top``
    (kitti_util.py:704-748).  ``corners_velo`` is ``[N, K>=4, 2 or 3]``
    velodyne-frame corners; the first four are the BEV footprint ring.
    ``scores`` (if given) shade non-GT boxes from dim to bright.
    """
    corners_velo = np.asarray(corners_velo, dtype=np.float64)
    img = np.array(image, copy=True)
    base = np.array(gt_color if is_gt else color, dtype=np.float64)
    for n in range(len(corners_velo)):
        ring = corners_velo[n, :4, :2]
        rows, cols = top_coords(ring[:, 0], ring[:, 1], spec)
        c = base
        if scores is not None and not is_gt:
            c = base * (0.3 + 0.7 * float(np.clip(scores[n], 0.0, 1.0)))
        c = tuple(int(v) for v in np.clip(c, 0, 255))
        for a in range(4):
            b = (a + 1) % 4
            _draw_segment(img, rows[a], cols[a], rows[b], cols[b], c)
    return img
