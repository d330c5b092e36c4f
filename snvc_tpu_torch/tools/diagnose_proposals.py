"""Generalization probe of the global model: proposal error on train vs val
(port of tools/diagnose_proposals.py).

Loads a stage-1 (StereoNet) checkpoint, decodes proposals on both the train
and the val split of a synthetic KITTI work directory, and reports per
split the recall proxy and the median center / x / z / yaw / size errors
against the nearest GT box, and the proposals' LiDAR coverage
(``eval/coverage.py``, RoI-aware pooling).  A detector that learned stereo
geometry errs alike on both splits; one that memorized appearance shows a
train / val gap.

  python -m snvc_tpu_torch.tools.diagnose_proposals --work_dir runs/two_stage

The work directory is ``demo_two_stage``'s: ``stereo_ckpt/`` (loaded as
``demo_two_stage --reuse_stereo`` loads it: the model built from
``demo_two_stage.stereo_config`` of these flags, which must match the
checkpoint's architecture: ``--classes``, ``--num_hourglasses``,
``--depth_offset``, ``--smoke``; ``demo_two_stage`` trains with
``--depth_offset`` by default), ``kitti_train/``, ``kitti_val/``; the
proposals go to ``diag_<split>_props/data``.  The card by default;
``--device cpu`` runs the plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import json
import os


def load_stage1(args, device):
    """(model with the latest stage-1 checkpoint, config, step)."""
    from snvc_tpu_torch.models.stereonet import StereoNet
    from snvc_tpu_torch.tools.demo_two_stage import stereo_config
    from snvc_tpu_torch.training.train import load_checkpoint

    cfg = stereo_config(args)
    model = StereoNet(cfg, device=device)
    tree, step = load_checkpoint(os.path.join(args.work_dir, "stereo_ckpt"))
    model.load_state_dict(tree["model"], strict=True)
    return model, cfg, step


def split_stats(ds, pred_dir, device="cuda") -> dict:
    """Proposal counts, median errors against the nearest GT and (with a
    LiDAR directory) the coverage medians of the proposals under
    ``pred_dir/data`` (JAX diagnose_proposals.py:41-93: the same keys and
    rounding)."""
    import numpy as np

    from snvc_tpu_torch.config import VernierConfig
    from snvc_tpu_torch.data.instance_db import (
        attach_nearest_gt,
        build_db_from_predictions,
    )

    cfg = VernierConfig()
    db = attach_nearest_gt(
        build_db_from_predictions(ds, cfg, os.path.join(pred_dir, "data")),
        cfg)
    n_gt = sum(len(ds.scene(i).labels()) for i in range(len(ds)))
    d = {"n_proposals": len(db), "n_gt": n_gt}
    rows = []
    for rec in db:
        if rec.label is None:
            continue
        dc = float(np.linalg.norm(rec.pred[[3, 5]] - rec.label[[3, 5]]))
        dyaw = (rec.pred[6] - rec.label[6] + np.pi / 2) % np.pi - np.pi / 2
        rows.append((
            dc,
            abs(float(rec.pred[3] - rec.label[3])),
            abs(float(rec.pred[5] - rec.label[5])),
            abs(float(np.degrees(dyaw))),
            # signed size errors: negative medians are the signature of
            # heading-averaged (shrunken) corners
            float(rec.pred[2] - rec.label[2]),  # dl
            float(rec.pred[1] - rec.label[1]),  # dw
        ))
    if rows:
        a = np.array(rows)
        med = np.median(a, axis=0)
        d.update(
            center_med_m=round(float(med[0]), 3),
            x_med_m=round(float(med[1]), 3),
            z_med_m=round(float(med[2]), 3),
            yaw_med_deg=round(float(med[3]), 1),
            dl_med_m=round(float(med[4]), 3),
            dw_med_m=round(float(med[5]), 3),
            # recall proxy: matched proposals within 1 m of a GT center
            within_1m=int((a[:, 0] < 1.0).sum()),
        )
    # RoI-aware LiDAR coverage: a well-localized proposal captures about
    # the GT box's point mass (ratio near 1)
    if rows and os.path.isdir(ds.lidar_dir):
        from snvc_tpu_torch.eval.coverage import proposal_lidar_coverage

        d.update(proposal_lidar_coverage(db, device=device))
    return d


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--work_dir", required=True)
    p.add_argument("--max_proposals", type=int, default=8)
    p.add_argument("--score_threshold", type=float, default=0.02)
    p.add_argument("--nms_iou", type=float, default=0.25)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--smoke", action="store_true")
    # demo_two_stage.stereo_config's fields: classes, num_hourglasses and
    # depth_offset shape the model and must match the checkpoint; the
    # loss-only ones (reg_heading_sym, photo_aug, depth_loss) change
    # nothing of the forward
    p.add_argument("--reg_heading_sym", action="store_true")
    p.add_argument("--classes", default="Car")
    p.add_argument("--photo_aug", action="store_true")
    p.add_argument("--num_hourglasses", type=int, default=1)
    p.add_argument("--depth_loss", default="sl1", choices=["sl1", "w1"])
    p.add_argument("--depth_offset", action="store_true")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns (and prints as JSON) {split: split_stats} for each split
    directory present."""
    args = parse_args(argv)

    from snvc_tpu_torch.data.kitti import KittiDataset
    from snvc_tpu_torch.inference.detect import DetectRunner
    from snvc_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    model, cfg, step = load_stage1(args, dev)
    print(f"loaded step {step}", flush=True)
    runner = DetectRunner(model, cfg, max_boxes=args.max_proposals,
                          score_threshold=args.score_threshold,
                          nms_iou=args.nms_iou, device=dev)
    out = {}
    for split, sub in (("train", "kitti_train"), ("val", "kitti_val")):
        root = os.path.join(args.work_dir, sub)
        if not os.path.isdir(root):
            continue
        pred_dir = os.path.join(args.work_dir, f"diag_{split}_props")
        ds = KittiDataset(root, split)
        runner.run(ds, pred_dir, log=lambda m: print(m, flush=True))
        out[split] = split_stats(ds, pred_dir, device=dev)
        print(f"{split.upper()}: {out[split]}", flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
