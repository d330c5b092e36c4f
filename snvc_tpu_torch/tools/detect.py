"""Run the global stereo detector over a KITTI split and write KITTI
proposal files (port of tools/detect.py).

The two-stage pipeline end to end:
  python -m snvc_tpu_torch.tools.detect --model_dir runs/stereo \
      --data_path data/kitti --split val --output_dir proposals/stereonet
  python -m snvc_tpu_torch.tools.inference_agnostic --model_dir runs/vernier \
      --data_path data/kitti --pred_dir proposals/stereonet/data ...
  python -m snvc_tpu_torch.tools.evaluate data/kitti/training/label_2 \
      outputs/all_parts

``--model_dir`` holds ``config.json`` (a StereoConfig) and the
checkpoints: ``checkpoints/<step>.pt`` as ``train_stereo`` writes them, or
``<step>.pt`` beside the config.
Runs on the card; ``--device cpu`` runs the plain PyTorch versions.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model_dir", required=True)
    p.add_argument("--data_path", required=True)
    p.add_argument("--split", default="val")
    p.add_argument("--output_dir", default="proposals")
    p.add_argument("--score_threshold", type=float, default=0.1)
    p.add_argument("--nms_iou", type=float, default=0.25)
    p.add_argument("--max_boxes", type=int, default=64)
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--prefetch", type=int, default=4,
                   help="frames queued on the device (0 = synchronous)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> int:
    """Returns the number of proposals written."""
    args = parse_args(argv)

    from snvc_tpu_torch.config import StereoConfig
    from snvc_tpu_torch.data.kitti import KittiDataset
    from snvc_tpu_torch.inference.detect import DetectRunner
    from snvc_tpu_torch.models.stereonet import StereoNet
    from snvc_tpu_torch.tools._model_dir import load_model
    from snvc_tpu_torch.utils.logging import get_logger

    log = get_logger()
    cfg, model, step = load_model(args.model_dir, StereoConfig, StereoNet,
                                  args.device)
    log.info(f"loaded checkpoint step {step}")
    ds = KittiDataset(args.data_path, args.split)
    runner = DetectRunner(model, cfg, max_boxes=args.max_boxes,
                          score_threshold=args.score_threshold,
                          nms_iou=args.nms_iou, device=args.device)
    return runner.run(ds, args.output_dir, prefetch=args.prefetch,
                      max_frames=args.max_frames, log=log.info)


if __name__ == "__main__":
    main()
