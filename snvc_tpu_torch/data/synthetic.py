"""Synthetic KITTI data (port of snvc_tpu/data/synthetic.py): random boxes
in front of the default stereo calibration, the textured-cuboid renderer
and the KITTI trees it writes (``make_synthetic_kitti``, a static split;
``make_synthetic_sequence``, one car moving), noisy proposals, random
images, LiDAR-like points on each car's surface and a fake detector's
proposal files.

The draws are the JAX module's, in its order, so one seed gives the same
arrays and files in both.  The renderer needs no cv2: its perspective
warps, polygon fills and outlines are ``geometry/raster``'s, which give
OpenCV's bits, so the images equal the JAX package's byte for byte.
Images are written with ``data/png.encode_png``: the files' bytes differ
from ``cv2.imwrite``'s, the decoded pixels do not.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from snvc_tpu_torch.data.pipeline import crop_transforms, select_points
from snvc_tpu_torch.data.png import encode_png
from snvc_tpu_torch.geometry import raster
from snvc_tpu_torch.geometry.boxes import box_corners_cam, rot_y
from snvc_tpu_torch.geometry.calib import (
    Calibration,
    KittiLabel,
    format_label,
    ry_to_alpha,
)

IMG_H, IMG_W = 375, 1242  # KITTI's native frame
GROUND_Y = 1.7  # ground-plane height (rect frame); renderer + LiDAR agree
# bumped on any change to the renderer's output: reuse stamps embed it, so
# a stale tree re-renders (JAX's value: the two packages' trees are one)
SYNTH_VERSION = 3


def calib_text() -> str:
    """The KITTI calib file of the default stereo pair (JAX
    ``_calib_text``, synthetic.py:33)."""
    P2 = "7.070493e+02 0.000000e+00 6.040814e+02 4.575831e+01 0.000000e+00 7.070493e+02 1.805066e+02 -3.454157e-01 0.000000e+00 0.000000e+00 1.000000e+00 4.981016e-03"
    P3 = "7.070493e+02 0.000000e+00 6.040814e+02 -3.372877e+02 0.000000e+00 7.070493e+02 1.805066e+02 2.199936e+00 0.000000e+00 0.000000e+00 1.000000e+00 2.729905e-03"
    V2C = "0.0 -1.0 0.0 0.0 0.0 0.0 -1.0 0.0 1.0 0.0 0.0 0.0"
    R0 = "1.0 0.0 0.0 0.0 1.0 0.0 0.0 0.0 1.0"
    P0 = "7.070493e+02 0.000000e+00 6.040814e+02 0.000000e+00 0.000000e+00 7.070493e+02 1.805066e+02 0.000000e+00 0.000000e+00 0.000000e+00 1.000000e+00 0.000000e+00"
    return (
        f"P0: {P0}\nP1: {P0}\nP2: {P2}\nP3: {P3}\n"
        f"R0_rect: {R0}\nTr_velo_to_cam: {V2C}\n"
    )


# per-class dimension priors [h, w, l] low/high
_DIM_PRIORS = {
    "Car": ((1.4, 1.5, 3.3), (1.7, 1.8, 4.3)),
    "Pedestrian": ((1.6, 0.5, 0.5), (1.9, 0.7, 0.8)),
    "Cyclist": ((1.6, 0.5, 1.6), (1.9, 0.7, 1.9)),
}


def random_box(rng: np.random.Generator, cls: str = "Car") -> np.ndarray:
    """[h, w, l, x, y, z, ry] bottom-centered, in front of the camera."""
    lo, hi = _DIM_PRIORS[cls]
    z = rng.uniform(12.0, 35.0)
    x = rng.uniform(-0.25, 0.25) * z * 0.5
    return np.array([rng.uniform(lo[0], hi[0]), rng.uniform(lo[1], hi[1]),
                     rng.uniform(lo[2], hi[2]), x, 1.65 + rng.normal() * 0.05,
                     z, rng.uniform(-np.pi, np.pi)], dtype=np.float32)


def random_car_box(rng: np.random.Generator) -> np.ndarray:
    return random_box(rng, "Car")


def box2d_of(box3d: np.ndarray, calib: Calibration) -> np.ndarray:
    """The image box [x1, y1, x2, y2] of a 3D box's projected corners,
    clipped to the KITTI frame."""
    uv = calib.rect_to_image(box_corners_cam(box3d))
    box2d = np.array([uv[:, 0].min(), uv[:, 1].min(), uv[:, 0].max(),
                      uv[:, 1].max()])
    return np.clip(box2d, 0, [IMG_W - 1, IMG_H - 1, IMG_W - 1, IMG_H - 1])


def write_predictions(out_dir: str, all_boxes: List[np.ndarray],
                      noise: float = 0.25, seed: int = 1) -> None:
    """Noisy copies of the GT as a fake detector's proposal files
    (JAX synthetic.py:421)."""
    rng = np.random.default_rng(seed)
    cl = Calibration.default()
    os.makedirs(out_dir, exist_ok=True)
    for fi, boxes in enumerate(all_boxes):
        lines = []
        for b in boxes:
            p = b.copy()
            p[3] += rng.normal() * noise
            p[5] += rng.normal() * noise
            p[6] += rng.normal() * 0.08
            lab = KittiLabel(
                type="Car", truncation=0.0, occlusion=0,
                alpha=ry_to_alpha(p[3], p[5], p[6]),
                box2d=box2d_of(p, cl).astype(np.float32), box3d=p,
                score=float(rng.uniform(0.5, 1.0)))
            lines.append(format_label(lab))
        with open(os.path.join(out_dir, f"{fi:06d}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")


def surface_points(box: np.ndarray, rng, n: int = 400) -> np.ndarray:
    """LiDAR-like points on the camera-facing surfaces of a box, rect frame
    (JAX synthetic.py:206)."""
    h, w, l = box[0], box[1], box[2]
    u = rng.uniform(-0.5, 0.5, size=(n, 2))
    face = rng.integers(0, 3, size=n)
    pts = np.zeros((n, 3))
    # object frame: x along length, y from -h to 0, z along width
    pts[:, 0] = np.where(face == 0, -0.5 * l, u[:, 0] * l)
    pts[:, 2] = np.where(face == 1, -0.5 * w, u[:, 1] * w * 0.5)
    pts[:, 1] = np.where(face != 2, (u[:, 1] - 0.5) * h, -h)
    return (rot_y(box[6]) @ pts.T).T + box[3:6]


def _face_texture(tex_id: int, face_idx: int, size: int = 64) -> np.ndarray:
    """The speckle texture [size, size] of face ``face_idx`` of the object
    ``tex_id``, seeded by identity, not by view: both cameras warp one
    canonical pattern through their own projection of the face, so the
    stereo pair is geometrically consistent.  ``tex_id`` is unique per
    (frame, box) in detection data, and kept by a tracked object across
    its sequence (JAX synthetic.py:76)."""
    trng = np.random.default_rng(tex_id * 1000003 + face_idx * 97 + 13)
    t = trng.uniform(0.55, 1.45, size=(size // 4, size // 4))
    t = np.kron(t, np.ones((4, 4)))  # 4-px blocks: survives downscale
    t += trng.uniform(-0.12, 0.12, size=(size, size))
    return t


# corner index quads of the six faces (corners alternate top / bottom, as
# geometry.boxes orders them): +l, -l, +w side, -w side, top, bottom
_FACES = ((0, 1, 3, 2), (4, 5, 7, 6), (0, 1, 5, 4), (2, 3, 7, 6),
          (0, 2, 6, 4), (1, 3, 7, 5))
_TEX = 64  # face texture side
_GROUND_TEX = 560  # ground texture side
_background_cache: Dict[bytes, np.ndarray] = {}


def _background(calib: Calibration) -> np.ndarray:
    """The sky gradient and the textured ground plane at y = GROUND_Y as
    ``calib``'s camera sees them, float32 [IMG_H, IMG_W, 3].  It depends
    on the camera alone, so each camera's is computed once a process."""
    key = np.asarray(calib.P, np.float64).tobytes()
    if key in _background_cache:
        return _background_cache[key]
    yy = np.mgrid[0:IMG_H, 0:IMG_W][0]
    img = (55 + 25 * yy / IMG_H).astype(np.float32)
    img = np.stack([img, img * 1.05, img * 0.95], axis=-1)
    # a world-anchored texture: disparity, hence depth, is consistent
    grng = np.random.default_rng(777)
    gt_tex = grng.uniform(0.6, 1.4, size=(_GROUND_TEX // 4, _GROUND_TEX // 4))
    gt_tex = np.kron(gt_tex, np.ones((4, 4)))
    gx0, gx1, gz0, gz1 = -30.0, 30.0, 3.0, 70.0
    plane_xz = np.array([[gx0, gz1], [gx1, gz1], [gx1, gz0], [gx0, gz0]],
                        np.float32)
    plane_pts = np.stack([plane_xz[:, 0], np.full(4, GROUND_Y, np.float32),
                          plane_xz[:, 1]], axis=1)
    plane_uv = calib.rect_to_image(plane_pts).astype(np.float32)
    g = _GROUND_TEX - 1
    tex_quad = np.array([[0, 0], [g, 0], [g, g], [0, g]], np.float32)
    Hg = raster.perspective_transform(tex_quad, plane_uv)
    gwarp = raster.warp_perspective(gt_tex.astype(np.float32), Hg,
                                    (IMG_W, IMG_H), border_value=0.0)
    gmask = gwarp > 0.0
    gval = np.clip(70.0 * gwarp[gmask], 0, 255)
    img[gmask] = np.stack([gval, gval * 1.02, gval * 0.98], axis=-1)
    _background_cache[key] = img
    return img


def render_scene(boxes3d: np.ndarray, calib: Calibration, rng,
                 tex_ids=None) -> np.ndarray:
    """The uint8 RGB [IMG_H, IMG_W, 3] image of textured cuboids over the
    background, as ``calib``'s camera sees them (JAX synthetic.py:99).

    Boxes are drawn far to near.  Each face that looks toward the camera
    is filled as its projected convex quad, shaded by a directional light
    and a per-face tint, modulated by its canonical texture warped through
    the quad's homography, and outlined.  Gaussian noise (``rng``'s one
    draw) goes over the whole image last."""
    img = _background(calib).copy()
    order = np.argsort(-boxes3d[:, 5])  # far to near
    t = _TEX - 1
    tex_corners = np.array([[0, 0], [t, 0], [t, t], [0, t]], np.float32)
    if tex_ids is None:
        tex_ids = list(range(len(boxes3d)))
    for bi in order:
        box = boxes3d[bi]
        tid = int(tex_ids[bi])
        corners = box_corners_cam(box)  # [8, 3]
        uv = calib.rect_to_image(corners)
        base = 90 + 110 * ((tid * 2654435761) % 97) / 97.0
        center = corners.mean(axis=0)
        for fi, f in enumerate(_FACES):
            p3 = corners[list(f)]
            n = np.cross(p3[1] - p3[0], p3[3] - p3[0])
            fc = p3.mean(axis=0)
            if np.dot(n, fc - center) < 0:
                n = -n
            if np.dot(n, -fc) <= 0:  # back-face cull
                continue
            nn = n / (np.linalg.norm(n) + 1e-9)
            lam = 0.55 + 0.45 * max(0.0, float(np.dot(nn, [0.3, -0.8, -0.52])))
            shade = np.clip(base * lam * (0.85 + 0.06 * fi), 0, 255)
            poly = np.round(uv[list(f)]).astype(np.int32)
            mask = np.zeros((IMG_H, IMG_W), np.uint8)
            raster.fill_convex_poly(mask, poly, 1)
            m = mask.astype(bool)
            rows, cols = np.nonzero(m.any(axis=1))[0], np.nonzero(m.any(axis=0))[0]
            if len(rows):
                # the warp is read inside the face only: compute its box
                y0, y1, x0, x1 = rows[0], rows[-1] + 1, cols[0], cols[-1] + 1
                H = raster.perspective_transform(
                    tex_corners, uv[list(f)].astype(np.float32))
                tex = raster.warp_perspective(
                    _face_texture(tid, fi, _TEX).astype(np.float32), H,
                    (IMG_W, IMG_H), border_value=1.0,
                    window=(y0, y1, x0, x1))
                val = np.clip(shade * tex[m[y0:y1, x0:x1]], 0, 255)
                img[m] = np.stack([val, val * 1.04, val * 0.96], axis=-1)
            raster.polylines(img, poly, (shade * 0.4, shade * 0.4, shade * 0.4))
    img += rng.normal(size=img.shape) * 4.0
    return np.clip(img, 0, 255).astype(np.uint8)


def _label_line(box: np.ndarray, cls: str, calib: Calibration) -> str:
    return format_label(KittiLabel(
        type=cls, truncation=0.0, occlusion=0,
        alpha=ry_to_alpha(box[3], box[5], box[6]),
        box2d=box2d_of(box, calib).astype(np.float32), box3d=box))


def _write_frame(base: str, name: str, boxes: np.ndarray,
                 classes: Sequence[str], rng, tex_ids) -> None:
    """Renders and writes one frame of a KITTI tree: both views, calib,
    labels and LiDAR (box surfaces and the ground plane), drawing from
    ``rng`` in JAX's order."""
    cl, cr = Calibration.default(), Calibration.default_right()
    img_l = render_scene(boxes, cl, rng, tex_ids=tex_ids)
    img_r = render_scene(boxes, cr, rng, tex_ids=tex_ids)
    encode_png(os.path.join(base, "image_2", name + ".png"), img_l)
    encode_png(os.path.join(base, "image_3", name + ".png"), img_r)
    with open(os.path.join(base, "calib", name + ".txt"), "w") as f:
        f.write(calib_text())
    lines = [_label_line(b, c, cl) for b, c in zip(boxes, classes)]
    with open(os.path.join(base, "label_2", name + ".txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    pts_rect = np.concatenate(
        [surface_points(b, rng) for b in boxes]
        + [np.stack([rng.uniform(-20, 20, 2000), np.full(2000, GROUND_Y),
                     rng.uniform(5, 45, 2000)], axis=1)])
    pts_velo = cl.rect_to_velo(pts_rect)
    pc = np.zeros((len(pts_velo), 4), np.float32)
    pc[:, :3] = pts_velo
    pc[:, 3] = 0.5
    pc.tofile(os.path.join(base, "velodyne", name + ".bin"))


def _make_dirs(root: str) -> str:
    base = os.path.join(root, "training")
    for d in ("image_2", "image_3", "calib", "label_2", "velodyne"):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    return base


def _write_split(root: str, split: str, num_frames: int) -> None:
    with open(os.path.join(root, split + ".txt"), "w") as f:
        f.write("\n".join(f"{i:06d}" for i in range(num_frames)) + "\n")


def make_synthetic_kitti(root: str, num_frames: int = 2,
                         boxes_per_frame: int = 3, seed: int = 0,
                         split: str = "val", reuse: bool = True,
                         classes: Tuple[str, ...] = ("Car",)
                         ) -> List[np.ndarray]:
    """Writes a synthetic KITTI tree under ``root`` and returns each
    frame's GT boxes [boxes_per_frame, 7] (JAX synthetic.py:208).

    Box k of a frame is of class ``classes[k % len(classes)]``.  With
    ``reuse``, a complete tree rendered with the same parameters is read
    back instead: ``<split>.stamp.json`` records the seed, the box count,
    the frame count, ``SYNTH_VERSION`` and (when not Car alone) the
    classes, and any difference re-renders."""
    base = os.path.join(root, "training")
    split_file = os.path.join(root, split + ".txt")
    stamp_file = os.path.join(root, split + ".stamp.json")
    stamp = {"seed": int(seed), "boxes_per_frame": int(boxes_per_frame),
             "num_frames": int(num_frames), "renderer": SYNTH_VERSION}
    if tuple(classes) != ("Car",):
        # stamped only when not the default, as JAX does
        stamp["classes"] = list(classes)
    if reuse and os.path.isfile(split_file) and os.path.isfile(stamp_file):
        with open(stamp_file) as f:
            have = json.load(f)
        with open(split_file) as f:
            names = [ln.strip() for ln in f if ln.strip()]
        last = names[-1] if names else ""
        if have == stamp and len(names) == num_frames and os.path.isfile(
                os.path.join(base, "image_3", last + ".png")):
            # KITTI label columns 8..14 = h w l x y z ry
            return [np.loadtxt(os.path.join(base, "label_2", name + ".txt"),
                               usecols=range(8, 15), ndmin=2,
                               dtype=np.float32) for name in names]

    rng = np.random.default_rng(seed)
    base = _make_dirs(root)
    all_boxes = []
    for fi in range(num_frames):
        box_cls = [classes[i % len(classes)] for i in range(boxes_per_frame)]
        boxes = np.stack([random_box(rng, c) for c in box_cls])
        all_boxes.append(boxes)
        # unique texture ids per (frame, box): detection must read stereo
        # geometry, not memorize recurring patterns
        tex_ids = rng.integers(0, 2**31 - 1, size=len(boxes))
        _write_frame(base, f"{fi:06d}", boxes, box_cls, rng, tex_ids)
    _write_split(root, split, num_frames)
    with open(stamp_file, "w") as f:
        json.dump(stamp, f)
    return all_boxes


def make_synthetic_sequence(root: str, num_frames: int = 8, seed: int = 0,
                            split: str = "val",
                            velocity=(0.15, 0.0, -0.45),
                            yaw_rate: float = 0.02) -> List[np.ndarray]:
    """A moving-object sequence: one car translating by ``velocity``
    m/frame (rect frame) with a yaw drift of ``yaw_rate`` rad/frame,
    keeping one texture, written as make_synthetic_kitti writes a tree
    (JAX synthetic.py:349).  Returns each frame's GT box [1, 7]."""
    rng = np.random.default_rng(seed)
    base = _make_dirs(root)
    box = random_car_box(rng)
    box[3:6] = [0.5, 1.65, 18.0]  # start near the image center
    vel = np.asarray(velocity, np.float32)
    all_boxes = []
    for fi in range(num_frames):
        boxes = box[None].copy()
        all_boxes.append(boxes.copy())
        _write_frame(base, f"{fi:06d}", boxes, ["Car"], rng, [seed + 17])
        box = box.copy()
        box[3:6] += vel
        box[6] += yaw_rate
    _write_split(root, split, num_frames)
    return all_boxes


def synthetic_batch_arrays(cfg, seed: int = 0,
                           frames: int = 1) -> Dict[str, np.ndarray]:
    """A geometry-consistent instance batch as a dict of numpy arrays, with
    the keys of ``InstanceBatch.arrays()`` (``points`` [I, 1024, 3])."""
    rng = np.random.default_rng(seed)
    I = cfg.max_instances
    img_h, img_w = cfg.image_size
    cl, cr = Calibration.default(), Calibration.default_right()
    images_left = rng.integers(0, 255, size=(frames, img_h, img_w, 3),
                               dtype=np.uint8)
    images_right = rng.integers(0, 255, size=(frames, img_h, img_w, 3),
                                dtype=np.uint8)
    samples = np.zeros((I, 7), np.float32)
    gt_boxes = np.zeros((I, 7), np.float32)
    trans_l = np.tile(np.eye(2, 3, dtype=np.float32), (I, 1, 1))
    trans_r = trans_l.copy()
    Np = 1024
    points = np.zeros((I, Np, 3), np.float32)
    points_valid = np.zeros((I, Np), bool)
    for k in range(I):
        gt = random_box(rng)
        prop = gt.copy()
        prop[3] += rng.normal() * 0.2
        prop[5] += rng.normal() * 0.2
        prop[6] += rng.normal() * 0.05
        gt_boxes[k] = gt
        samples[k] = prop
        trans_l[k], trans_r[k] = crop_transforms(prop, cl, cr, cfg)
        pc = surface_points(gt, rng, n=600).astype(np.float32)
        points[k], points_valid[k] = select_points(pc, prop, cfg, Np)
    return dict(
        images_left=images_left, images_right=images_right,
        P_left=np.tile(cl.as_array()[None], (frames, 1, 1)),
        P_right=np.tile(cr.as_array()[None], (frames, 1, 1)),
        image_idx=rng.integers(0, frames, size=I).astype(np.int32),
        trans_l=trans_l, trans_r=trans_r, samples=samples,
        valid=np.ones(I, bool), gt_boxes=gt_boxes, points=points,
        points_valid=points_valid)
