"""TraceBox: 3D cuboids over a frame with ray-traced hidden lines (port of
snvc_tpu/viz/tracebox.py; the reference's tools/visualize.py:248-459).

Each box is cut into 12 triangles and every corner is tested for
occlusion by casting the camera -> corner ray against all triangles
(``ray_hits_triangles``, ``vertex_visibility``: numpy, held to JAX bit for
bit).  An edge with both ends visible is drawn solid, any other dashed.
JAX draws on matplotlib axes; the port draws into the image array with
``geometry/raster.line_pixels`` and writes PNGs with
``data/png.encode_png`` (the card's machine has no matplotlib).  The
pixels are not matplotlib's: an edge is the 8-connected line between its
corners' projections rounded to the nearest pixel.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from snvc_tpu_torch.data.png import encode_png
from snvc_tpu_torch.geometry import boxes as gbox
from snvc_tpu_torch.geometry.calib import Calibration, KittiLabel, read_label
from snvc_tpu_torch.viz.points import BOX_EDGES, DASH, draw_segment

# triangles over the 8 box corners (two per face, 6 faces)
_FACE_QUADS = [
    (0, 1, 3, 2),  # +x (front)
    (4, 5, 7, 6),  # -x (back)
    (0, 1, 5, 4),  # +z
    (2, 3, 7, 6),  # -z
    (0, 2, 6, 4),  # top (-y)
    (1, 3, 7, 5),  # bottom
]
BOX_TRIANGLES = np.array(
    [(a, b, c) for (a, b, c, d) in _FACE_QUADS for _ in (0,)]
    + [(a, c, d) for (a, b, c, d) in _FACE_QUADS]
)

# matplotlib's tab10 colours in JAX's order (``plt_color``), as RGB
PALETTE = ((214, 39, 40), (31, 119, 180), (44, 160, 44), (255, 127, 14),
           (148, 103, 189), (23, 190, 207), (188, 189, 34), (227, 119, 194))
# corners nearer than this (m) are not projected: behind the camera the
# pinhole projection flips
MIN_DEPTH = 0.1
GRID_PAD = 4  # pixels between the images of a grid


def ray_hits_triangles(origin, targets, tri_a, tri_b, tri_c, eps=1e-9):
    """For each target point, does the segment origin->target hit any
    triangle strictly before the target?

    targets: [N, 3]; tri_*: [T, 3].  Returns [N] bool.
    """
    d = targets - origin  # [N, 3]
    e1 = tri_b - tri_a  # [T, 3]
    e2 = tri_c - tri_a
    p = np.cross(d[:, None, :], e2[None, :, :])  # [N, T, 3]
    det = np.einsum("tk,ntk->nt", e1, p)
    inv = np.where(np.abs(det) > eps, 1.0 / np.where(det == 0, 1.0, det), 0.0)
    s = origin[None, None, :] - tri_a[None, :, :]  # [1, T, 3]
    u = np.einsum("ntk,ntk->nt", s.repeat(len(d), 0), p) * inv
    q = np.cross(s, e1[None, :, :])  # [1, T, 3]
    v = np.einsum("nk,ntk->nt", d, q) * inv
    t = np.einsum("tk,ntk->nt", e2, q.repeat(len(d), 0)) * inv
    hit = (
        (np.abs(det) > eps)
        & (u >= -eps)
        & (v >= -eps)
        & (u + v <= 1 + eps)
        & (t > eps)
        & (t < 1.0 - 1e-4)  # strictly before the vertex itself
    )
    return hit.any(axis=1)


def vertex_visibility(all_corners: np.ndarray) -> np.ndarray:
    """all_corners: [B, 8, 3] camera-frame corners of all boxes.
    Returns [B, 8] bool visibility from the origin (camera center)."""
    B = all_corners.shape[0]
    tri = all_corners[:, BOX_TRIANGLES]  # [B, 24, 3, 3]
    tri = tri.reshape(-1, 3, 3)
    origin = np.zeros(3)
    targets = all_corners.reshape(-1, 3)
    hidden = ray_hits_triangles(
        origin, targets, tri[:, 0], tri[:, 1], tri[:, 2]
    )
    return ~hidden.reshape(B, 8)


def box_edges_2d(boxes3d: np.ndarray, calib: Calibration) -> List:
    """The edges to draw of box3d [B, 7]: a list of (box index, uv0, uv1,
    solid) with the two corners' image points (float) and whether both
    corners are visible.  Edges with a corner nearer than ``MIN_DEPTH``
    are left out."""
    boxes3d = np.asarray(boxes3d).reshape(-1, 7)
    if len(boxes3d) == 0:
        return []
    corners = gbox.box_corners_cam(boxes3d)  # [B, 8, 3]
    visible = vertex_visibility(corners)
    edges = []
    for bi in range(len(boxes3d)):
        uv = calib.rect_to_image(corners[bi])
        for e0, e1 in BOX_EDGES:
            if min(corners[bi, e0, 2], corners[bi, e1, 2]) < MIN_DEPTH:
                continue
            edges.append((bi, uv[e0], uv[e1],
                          bool(visible[bi, e0] and visible[bi, e1])))
    return edges


def render_frame(image: np.ndarray, labels: Sequence[KittiLabel],
                 calib: Calibration, save_path: Optional[str] = None,
                 colors: Optional[Sequence] = None) -> np.ndarray:
    """Every labelled box over the frame (the reference's ``show``,
    tools/visualize.py:374-421): solid edges between visible corners,
    dashed otherwise, box k in ``colors[k]`` (default ``PALETTE``).
    Returns the drawn uint8 [H, W, 3] copy of ``image``; with
    ``save_path`` also writes it as a PNG."""
    img = np.array(image, np.uint8, copy=True)
    boxes = (np.stack([lb.box3d for lb in labels]) if labels
             else np.zeros((0, 7)))
    for bi, uv0, uv1, solid in box_edges_2d(boxes, calib):
        c = (colors[bi] if colors is not None
             else PALETTE[bi % len(PALETTE)])
        draw_segment(img, uv0, uv1, c, None if solid else DASH)
    if save_path:
        encode_png(save_path, img)
    return img


def image_grid(images: Sequence[np.ndarray], cols: int = 2) -> np.ndarray:
    """uint8 [H, W, 3] images tiled ``cols`` a row on white, ``GRID_PAD``
    pixels apart, each cell the largest image's size."""
    pad = GRID_PAD
    n = len(images)
    rows = -(-n // cols)
    h = max(im.shape[0] for im in images)
    w = max(im.shape[1] for im in images)
    grid = np.full((rows * (h + pad) + pad, cols * (w + pad) + pad, 3), 255,
                   np.uint8)
    for i, im in enumerate(images):
        r, c = divmod(i, cols)
        y, x = pad + r * (h + pad), pad + c * (w + pad)
        grid[y:y + im.shape[0], x:x + im.shape[1]] = im[..., :3]
    return grid


def save_image_grid(images: Sequence[np.ndarray], save_path: str,
                    cols: int = 2) -> np.ndarray:
    """Batch grid writer (the reference's save_batch_image,
    visualize.py:437-459): ``image_grid`` as a PNG; returns the grid."""
    grid = image_grid(images, cols)
    os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
    encode_png(save_path, grid)
    return grid


def visualize_predictions(pred_dir: str, data_root: str, out_dir: str,
                          split: str = "val",
                          max_frames: Optional[int] = None) -> int:
    """The reference's tools/visualize.py flow: every prediction file
    rendered over its frame into ``out_dir/<index>.png``; returns the
    frame count."""
    from snvc_tpu_torch.data.kitti import KittiDataset

    ds = KittiDataset(data_root, split)
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    for fn in sorted(os.listdir(pred_dir)):
        if not fn.endswith(".txt"):
            continue
        if max_frames is not None and count >= max_frames:
            break
        idx = int(fn.split(".")[0])
        scene = ds.scene(idx)
        render_frame(scene.load_image("left"),
                     read_label(os.path.join(pred_dir, fn)),
                     scene.calibration("left"),
                     os.path.join(out_dir, f"{idx:06d}.png"))
        count += 1
    return count
