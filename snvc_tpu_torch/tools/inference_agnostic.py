"""Model-agnostic refinement (port of tools/inference_agnostic.py): refine
the 3D proposals of any detector's KITTI txt files with the Vernier model,
write refined KITTI predictions, optionally score them.

  python -m snvc_tpu_torch.tools.inference_agnostic \
      --model_dir runs/vernier --data_path data/kitti --split val \
      --pred_dir proposals/stereonet/data --output_dir outputs --evaluate

``--model_dir`` holds ``config.json`` (a VernierConfig) and the
checkpoints: ``checkpoints/<step>.pt`` as ``train_vernier`` writes them,
or ``<step>.pt`` beside the config.  ``--report_loss`` attaches each
proposal's nearest GT box and prints the validation losses per batch.
Runs on the card; ``--device cpu`` runs the plain PyTorch versions.  The
JAX CLI's ``--debug`` (matplotlib renders of the NCF, occupancy and
update, ``viz/debug.py``) is not ported: it waits for the visualisation
item of ROADMAP.md's Queue 1, which draws without matplotlib.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model_dir", required=True,
                   help="directory with config.json and checkpoints/ (or "
                   "<step>.pt)")
    p.add_argument("--data_path", required=True, help="KITTI root")
    p.add_argument("--split", default="val")
    p.add_argument("--pred_dir", required=True,
                   help="directory of KITTI-format proposal txt files")
    p.add_argument("--output_dir", default="outputs")
    p.add_argument("--pred_type", nargs="+", default=["all_parts"])
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--prefetch", type=int, default=4,
                   help="batches queued on the device before the oldest "
                   "one's outputs are pulled (0 = synchronous)")
    p.add_argument("--report_loss", action="store_true",
                   help="also compute val losses against GT")
    p.add_argument("--evaluate", action="store_true",
                   help="run the KITTI AP evaluator on the output")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns {pred_type: evaluator dict} with ``--evaluate``, and
    {"losses": one dict of losses a batch} with ``--report_loss``."""
    args = parse_args(argv)

    from snvc_tpu_torch.config import VernierConfig
    from snvc_tpu_torch.data.instance_db import (
        attach_nearest_gt,
        build_db_from_predictions,
    )
    from snvc_tpu_torch.data.kitti import KittiDataset
    from snvc_tpu_torch.data.pipeline import RefinementPipeline
    from snvc_tpu_torch.inference.kitti_writer import PredictionWriter
    from snvc_tpu_torch.inference.refine import RefineRunner
    from snvc_tpu_torch.models.vernier import VernierScale
    from snvc_tpu_torch.tools._model_dir import load_model
    from snvc_tpu_torch.utils.logging import get_logger

    log = get_logger()
    cfg, model, step = load_model(args.model_dir, VernierConfig,
                                  VernierScale, args.device)
    cfg = cfg.replace(pred_dir=args.pred_dir, output_dir=args.output_dir,
                      pred_type=tuple(args.pred_type))
    log.info(f"loaded checkpoint step {step}")
    log.info("number of model parameters: "
             f"{sum(p.numel() for p in model.parameters())}")

    ds = KittiDataset(args.data_path, args.split)
    db = build_db_from_predictions(ds, cfg, args.pred_dir)
    if args.report_loss:
        db = attach_nearest_gt(db, cfg)
    log.info(f"{len(db)} proposal instances from {args.pred_dir}")
    pipe = RefinementPipeline(db, cfg, training=False, seed=args.seed,
                              load_lidar=args.report_loss)
    runner = RefineRunner(model, cfg, device=args.device)
    writer = PredictionWriter(cfg)
    losses = runner.run(pipe, writer=writer, with_targets=args.report_loss,
                        max_batches=args.max_batches, prefetch=args.prefetch)
    calib_dir = ds.calib_dir if args.split == "test" else None
    out = writer.write(args.output_dir, calib_dir=calib_dir)
    log.info(f"wrote predictions under {out}")

    scores = {"losses": losses} if args.report_loss else {}
    if args.evaluate:
        from snvc_tpu_torch.eval.kitti_ap import run_kitti_eval

        for t in cfg.pred_type:
            scores[t] = run_kitti_eval(ds.label_dir,
                                       os.path.join(args.output_dir, t))
            log.info(f"[{t}] {scores[t]}")
    return scores


if __name__ == "__main__":
    main()
