"""Refinement decode diagnosis: which part-position source helps? (port of
tools/diagnose_refinement.py)

Loads the Vernier model a two-stage run saved (``work_dir/vernier_ckpt``,
a model directory of the port: ``<step>.pt`` beside ``config.json``, or
``checkpoints/<step>.pt``), refines the run's stage-1 proposals
(``work_dir/proposals/data``) over its val tree (``work_dir/kitti_val``)
with each requested ``ncf_decode`` ("coordinates": the part-coordinate
head; "argmax" / "soft-argmax": the NCF heatmap decode) and reports, per
decode and pred type:

  * the median centre (BEV) / yaw error against the nearest GT and the
    median |update| (a mean-collapsed head shows |update| << the
    proposals' error);
  * Car AP3D / APBEV (AP40) at IoU 0.7 and AP3D at 0.5.

Outputs go to ``work_dir/refined_diag/<decode>/<pred_type>`` and
``work_dir/refined_diag/report.json`` (JAX's keys).

  python -m snvc_tpu_torch.tools.diagnose_refinement \
      --work_dir runs/two_stage --decodes coordinates argmax soft-argmax

The card by default; ``--device cpu`` runs the plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import json
import os


def box_errors(pred_rows, gt_rows):
    """Median center (BEV) / yaw-mod-pi errors of matched boxes."""
    import numpy as np

    cerr, yerr = [], []
    for r in pred_rows:
        g = gt_rows
        if not len(g):
            continue
        d = np.linalg.norm(g[:, [3, 5]] - r[[3, 5]][None], axis=1)
        i = int(np.argmin(d))
        if d[i] > 3.0:
            continue
        cerr.append(float(d[i]))
        dy = (r[6] - g[i, 6] + np.pi / 2) % np.pi - np.pi / 2
        yerr.append(abs(float(dy)))
    return cerr, yerr


def load_kitti_boxes(d):
    import glob

    import numpy as np

    out = {}
    for f in sorted(glob.glob(os.path.join(d, "*.txt"))):
        rows = []
        for line in open(f):
            p = line.split()
            if p:
                rows.append([float(v) for v in p[8:15]])
        out[os.path.basename(f)[:-4]] = np.array(rows, np.float32).reshape(-1, 7)
    return out


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--work_dir", required=True)
    p.add_argument("--decodes", nargs="+",
                   default=["coordinates", "argmax", "soft-argmax"],
                   choices=["coordinates", "argmax", "soft-argmax"])
    p.add_argument("--pred_types", nargs="+",
                   default=["one_part", "all_parts"])
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns the report written to ``refined_diag/report.json``."""
    args = parse_args(argv)

    import numpy as np

    from snvc_tpu_torch.config import VernierConfig
    from snvc_tpu_torch.data.instance_db import build_db_from_predictions
    from snvc_tpu_torch.data.kitti import KittiDataset
    from snvc_tpu_torch.data.pipeline import RefinementPipeline
    from snvc_tpu_torch.eval.kitti_ap import run_kitti_eval
    from snvc_tpu_torch.inference.kitti_writer import PredictionWriter
    from snvc_tpu_torch.inference.refine import RefineRunner
    from snvc_tpu_torch.models.vernier import VernierScale
    from snvc_tpu_torch.tools._model_dir import load_model
    from snvc_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg, model, step = load_model(os.path.join(args.work_dir, "vernier_ckpt"),
                                  VernierConfig, VernierScale, dev)
    print(f"vernier checkpoint at step {step}", flush=True)

    val_root = os.path.join(args.work_dir, "kitti_val")
    pred_dir = os.path.join(args.work_dir, "proposals", "data")
    vds = KittiDataset(val_root, "val")
    gt = load_kitti_boxes(vds.label_dir)
    prop = load_kitti_boxes(pred_dir)

    def stats(pred_boxes, name, res_dir=None):
        cerr, yerr, moves = [], [], []
        for frame, rows in pred_boxes.items():
            c, y = box_errors(rows, gt.get(frame, np.zeros((0, 7))))
            cerr += c
            yerr += y
            pr = prop.get(frame)
            if pr is not None and len(pr) == len(rows):
                moves += list(np.linalg.norm(rows[:, 3:6] - pr[:, 3:6],
                                             axis=1))
        row = {
            "center_med_m": float(np.median(cerr)) if cerr else None,
            "yaw_med_deg": (float(np.degrees(np.median(yerr))) if yerr
                            else None),
            "update_med_m": float(np.median(moves)) if moves else 0.0,
            "n": len(cerr),
        }
        if res_dir is not None:
            ap7 = run_kitti_eval(vds.label_dir, res_dir)["car"]
            ap5 = run_kitti_eval(vds.label_dir, res_dir,
                                 car_min_iou=0.5)["car"]
            row["ap3d"] = ap7["detection_3d"]["ap40"]
            row["apbev"] = ap7["detection_ground"]["ap40"]
            row["ap3d_iou50"] = ap5["detection_3d"]["ap40"]
        print(f"{name}: " + json.dumps(row), flush=True)
        return row

    report = {"step": step,
              "proposals": stats(prop, "proposals",
                                 os.path.join(args.work_dir, "proposals"))}

    base_cfg = cfg.replace(usage="inference", sup_type="real", augment=False,
                           pred_type=tuple(args.pred_types))
    for decode in args.decodes:
        infer_cfg = base_cfg.replace(ncf_decode=decode)
        vdb = build_db_from_predictions(vds, infer_cfg, pred_dir)
        vpipe = RefinementPipeline(vdb, infer_cfg, training=False,
                                   load_lidar=False)
        writer = PredictionWriter(infer_cfg)
        RefineRunner(model, infer_cfg, device=dev).run(
            vpipe, writer=writer, progress=False)
        out_dir = os.path.join(args.work_dir, "refined_diag", decode)
        writer.write(out_dir)
        for t in args.pred_types:
            d = os.path.join(out_dir, t)
            report[f"{decode}/{t}"] = stats(
                load_kitti_boxes(os.path.join(d, "data")), f"{decode}/{t}", d)

    with open(os.path.join(args.work_dir, "refined_diag", "report.json"),
              "w") as f:
        json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
