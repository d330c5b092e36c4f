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
``--debug`` refines one batch only and renders its NCF, occupancy and
BEV update panels as PNGs under ``<output_dir>/debug``
(``viz/debug.render_debug_batch``, no matplotlib).  Runs on the card;
``--device cpu`` runs the plain PyTorch versions.
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
    p.add_argument("--debug", action="store_true",
                   help="cap to 1 batch and render NCF / occupancy / update "
                   "PNGs under <output_dir>/debug")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns {pred_type: evaluator dict} with ``--evaluate``,
    {"losses": one dict of losses a batch} with ``--report_loss`` and
    {"debug": {panel: PNG path}} with ``--debug``."""
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
    if args.debug:
        from snvc_tpu_torch.viz.debug import render_debug_batch

        batch = next(iter(pipe.batches()))
        out = runner.step(batch, with_targets=args.report_loss,
                          host_outputs=runner.HOST_OUTPUTS
                          + ("ncf", "occupancy"))
        writer.add_batch(batch, out)
        paths = render_debug_batch(batch, out,
                                   os.path.join(args.output_dir, "debug"))
        log.info(f"debug renders: {sorted(paths.values())}")
        losses = ([{k: float(v) for k, v in out["losses"].items()}]
                  if args.report_loss else [])
        if losses:
            log.info("losses: " + ", ".join(f"{k}={v:.4f}"
                                            for k, v in losses[0].items()))
    else:
        losses = runner.run(pipe, writer=writer,
                            with_targets=args.report_loss,
                            max_batches=args.max_batches,
                            prefetch=args.prefetch)
    calib_dir = ds.calib_dir if args.split == "test" else None
    out = writer.write(args.output_dir, calib_dir=calib_dir)
    log.info(f"wrote predictions under {out}")

    scores = {"losses": losses} if args.report_loss else {}
    if args.debug:
        scores["debug"] = paths
    if args.evaluate:
        from snvc_tpu_torch.eval.kitti_ap import run_kitti_eval

        for t in cfg.pred_type:
            scores[t] = run_kitti_eval(ds.label_dir,
                                       os.path.join(args.output_dir, t))
            log.info(f"[{t}] {scores[t]}")
    return scores


if __name__ == "__main__":
    main()
