"""KITTI label lines (the part of snvc_tpu/inference/kitti_writer.py that
proposal writing uses)."""

from __future__ import annotations

from snvc_tpu_torch.geometry.calib import ry_to_alpha


def instance_line(box3d, box2d, score, cls_name: str = "Car") -> str:
    """One KITTI label line: type, truncation and occlusion (-1), alpha,
    the 2D box, h w l, x y z, ry and the score."""
    alpha = ry_to_alpha(float(box3d[3]), float(box3d[5]), float(box3d[6]))
    f = [cls_name, "-1.0", "-1.0", f"{alpha:.6f}"]
    f += [f"{v:.6f}" for v in box2d[:4]]
    f += [f"{v:.6f}" for v in box3d[:7]]
    f.append(f"{score:.8f}")
    return " ".join(f)
