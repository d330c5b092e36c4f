"""Prediction visualizer (port of tools/visualize.py; the reference's
tools/visualize.py): KITTI-format predictions drawn over their frames as
cuboids with ray-traced hidden lines (``viz/tracebox``), or with
``--top_view`` as LiDAR top views with the GT footprints green and the
predictions' shaded by score (``viz/lidar``; the reference's legacy viz,
snvc/visualization/kitti_util.py:428-530, 696-752).

  python -m snvc_tpu_torch.tools.visualize --pred_dir outputs/all_parts/data \
      --data_path data/kitti --split val --out_dir viz --max_frames 20

Host numpy only: no model, no card.  PNGs are written with
``data/png.encode_png``: ``<out_dir>/<index>.png`` (the frame's size) or
``<out_dir>/<index>_top.png`` (``TopViewSpec()``: 501 x 301).
"""

from __future__ import annotations

import argparse
import os


def rings_velo(labels, calib):
    """[N, 4, 2] velodyne (x, y) BEV footprints of the non-DontCare
    labels (JAX tools/visualize.py:36-46)."""
    import numpy as np

    from snvc_tpu_torch.geometry.boxes import bev_box_corners, box3d_to_bev

    rings = []
    for lb in labels:
        if lb.type == "DontCare":
            continue
        ring = bev_box_corners(box3d_to_bev(lb.box3d))  # [4, 2] cam (x, z)
        cam = np.stack([ring[:, 0], np.full(4, lb.box3d[4]), ring[:, 1]],
                       axis=1)
        rings.append(calib.rect_to_velo(cam)[:, :2])
    return np.array(rings).reshape(-1, 4, 2)


def visualize_top_views(pred_dir, data_root, out_dir, split,
                        max_frames=None) -> int:
    """LiDAR top views with the GT (green) and the predictions (shaded by
    score) into ``out_dir/<index>_top.png``; returns the frame count."""
    from snvc_tpu_torch.data.kitti import KittiDataset
    from snvc_tpu_torch.data.png import encode_png
    from snvc_tpu_torch.geometry.calib import read_label
    from snvc_tpu_torch.viz.lidar import (
        TopViewSpec,
        draw_boxes_on_top,
        lidar_to_top,
        top_view_image,
    )

    ds = KittiDataset(data_root, split)
    os.makedirs(out_dir, exist_ok=True)
    spec = TopViewSpec()
    count = 0
    for fn in sorted(os.listdir(pred_dir)):
        if not fn.endswith(".txt"):
            continue
        if max_frames is not None and count >= max_frames:
            break
        idx = int(fn.split(".")[0])
        scene = ds.scene(idx)
        calib = scene.calibration("left")
        img = top_view_image(lidar_to_top(scene.lidar(), spec))
        gt = [lb for lb in scene.labels() if lb.type != "DontCare"]
        if gt:
            img = draw_boxes_on_top(img, rings_velo(gt, calib), spec,
                                    is_gt=True)
        preds = read_label(os.path.join(pred_dir, fn))
        if preds:
            scores = [lb.score if lb.score is not None else 1.0
                      for lb in preds]
            img = draw_boxes_on_top(img, rings_velo(preds, calib), spec,
                                    scores=scores)
        encode_png(os.path.join(out_dir, f"{idx:06d}_top.png"), img)
        count += 1
    return count


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pred_dir", required=True)
    p.add_argument("--data_path", required=True)
    p.add_argument("--split", default="val")
    p.add_argument("--out_dir", default="viz")
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--top_view", action="store_true",
                   help="render LiDAR BEV top views instead of the "
                   "cuboids over the camera frames")
    return p.parse_args(argv)


def main(argv=None) -> int:
    """Returns the number of frames rendered."""
    args = parse_args(argv)
    if args.top_view:
        n = visualize_top_views(args.pred_dir, args.data_path, args.out_dir,
                                args.split, args.max_frames)
    else:
        from snvc_tpu_torch.viz.tracebox import visualize_predictions

        n = visualize_predictions(args.pred_dir, args.data_path,
                                  args.out_dir, args.split, args.max_frames)
    print(f"rendered {n} frames into {args.out_dir}")
    return n


if __name__ == "__main__":
    main()
