"""Release-checkpoint validation in one command: tar -> convert -> refine ->
AP (port of tools/validate_epoch80.py).

  python -m snvc_tpu_torch.tools.validate_epoch80 --checkpoint epoch_80.tar \\
      --data_path /data/kitti --split val --pred_dir /data/proposals

Steps:
  1. load the reference's torch ``.tar`` (docs/INFERENCE.md:9-12) and
     detect its optional heads from the key prefixes (``part_reg_head.``,
     ``bbox_head.``);
  2. build the port's VernierScale at the release configuration
     (``release_config``) and convert the checkpoint onto it
     (``utils/convert_torch``: nothing unmatched on either side), loaded
     with ``strict=True``;
  3. refine the proposal directory (``RefinementPipeline`` ->
     ``RefineRunner.run`` -> ``PredictionWriter``; reference
     tools/inference_agnostic.py:366-432);
  4. score the proposals and each refined type with the KITTI evaluator
     and write ``validation.json`` under ``--out_dir`` (JAX's keys).

``--selftest`` runs the same steps without the real checkpoint: a
release-shaped random state_dict for a small config saved as a torch
``.tar``, a synthetic KITTI val tree with noisy-GT proposals, then steps
1-4 under ``--work_dir`` (the AP means nothing; the run proves the path).
The card by default; ``--device cpu`` runs the plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def release_config(args):
    """The released model's recovered configuration (SURVEY.md §5):
    BEV_type3, hrnet-w48, a 32x192x192 grid, 256x256 ROIs."""
    from snvc_tpu_torch.config import BackboneConfig, VernierConfig

    return VernierConfig(
        vernier_type="BEV_type3",
        backbone=BackboneConfig(name=args.backbone),
        grid_resolution=(32, 192, 192),
        x_range=(-1.6, 1.6),
        y_range=(-1.0, 1.0),
        z_range=(-1.6, 1.6),
        resolution=(256, 256),
        gn=args.gn,
        usage="inference",
        sup_type="real",
        max_instances=8,
        image_size=(384, 1280),
        pred_type=("one_part", "all_parts"),
        compute_dtype=args.dtype,
    )


def detect_heads(state_dict) -> tuple:
    """(part-offset head, bbox head) present in a reference state_dict."""
    return (any(k.startswith("part_reg_head.") for k in state_dict),
            any(k.startswith("bbox_head.") for k in state_dict))


def convert(args, cfg, state_dict, log):
    """(model on ``args.device`` with the converted weights, config with the
    detected heads)."""
    from snvc_tpu_torch.models.vernier import VernierScale
    from snvc_tpu_torch.utils.convert_torch import convert_vernier_checkpoint

    use_part_reg, use_bbox = detect_heads(state_dict)
    cfg = cfg.replace(use_part_reg_head=use_part_reg, use_bbox_head=use_bbox)
    log(f"detected heads: part_reg={use_part_reg}, bbox={use_bbox}")
    model = VernierScale(cfg, device=args.device)
    t = time.perf_counter()
    sd = convert_vernier_checkpoint(state_dict, model.state_dict(),
                                    use_part_reg_head=use_part_reg,
                                    use_bbox_head=use_bbox)
    model.load_state_dict(sd, strict=True)
    log(f"converted {len(state_dict)} torch tensors, zero unmatched "
        f"({time.perf_counter() - t:.2f} s)")
    return model, cfg


def run(args, cfg, model, data_path, split, pred_dir, out_dir, log):
    """Refine every proposal of ``pred_dir`` into ``out_dir/<pred_type>``;
    returns the dataset."""
    from snvc_tpu_torch.data.instance_db import build_db_from_predictions
    from snvc_tpu_torch.data.kitti import KittiDataset
    from snvc_tpu_torch.data.pipeline import RefinementPipeline
    from snvc_tpu_torch.inference.kitti_writer import PredictionWriter
    from snvc_tpu_torch.inference.refine import RefineRunner

    ds = KittiDataset(data_path, split)
    db = build_db_from_predictions(ds, cfg, pred_dir)
    log(f"{len(db)} proposal instances over {len(ds)} frames")
    pipe = RefinementPipeline(db, cfg, training=False, load_lidar=False)
    runner = RefineRunner(model, cfg, device=args.device)
    writer = PredictionWriter(cfg)
    runner.run(pipe, writer=writer, progress=True)
    writer.write(out_dir)
    return ds


def evaluate(args, ds, pred_dir, out_dir, log) -> dict:
    """AP3D / APBEV (AP40) of the raw proposals and of each refined type."""
    from snvc_tpu_torch.eval.kitti_ap import run_kitti_eval

    gt_dir = ds.label_dir
    # the raw proposals as the baseline (they double as a result dir)
    base_res = os.path.join(out_dir, "_proposals_as_results")
    os.makedirs(os.path.join(base_res, "data"), exist_ok=True)
    for f in os.listdir(pred_dir):
        if f.endswith(".txt"):
            with open(os.path.join(pred_dir, f)) as src, open(
                    os.path.join(base_res, "data", f), "w") as dst:
                dst.write(src.read())
    result = {}
    for name, d in [("proposals", base_res)] + [
            (t, os.path.join(out_dir, t)) for t in ("one_part", "all_parts")]:
        if not os.path.isdir(d):
            continue
        ap = run_kitti_eval(gt_dir, d)
        result[name] = {
            "ap3d_40": ap["car"]["detection_3d"]["ap40"],
            "apbev_40": ap["car"]["detection_ground"]["ap40"],
        }
        what = "proposals" if name == "proposals" else f"refined/{name}"
        log(f"AP3D({what}) e/m/h: {result[name]['ap3d_40']}")
    return result


def selftest(args, log) -> tuple:
    """The same path on a fabricated checkpoint and a synthetic tree:
    (refined output directory, ``evaluate``'s result)."""
    import torch

    from snvc_tpu_torch.config import tiny_vernier_config
    from snvc_tpu_torch.data.synthetic import (
        make_synthetic_kitti,
        write_predictions,
    )
    from snvc_tpu_torch.models.vernier import VernierScale
    from snvc_tpu_torch.utils.convert_torch import (
        fabricate_vernier_state_dict,
        load_torch_checkpoint,
    )

    work = args.work_dir
    os.makedirs(work, exist_ok=True)
    cfg = tiny_vernier_config(
        usage="inference", sup_type="real", max_instances=4,
        image_size=(384, 1248), pred_type=("one_part", "all_parts"))
    # the shapes come from the port's own model (on the CPU: only its
    # state_dict's shapes are read)
    sd = fabricate_vernier_state_dict(
        VernierScale(cfg, device="cpu").state_dict())
    tar = os.path.join(work, "fake_epoch_80.tar")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}},
               tar)
    log(f"fabricated checkpoint: {len(sd)} tensors -> {tar}")

    val_root = os.path.join(work, "kitti_val")
    boxes = make_synthetic_kitti(val_root, 2, 2, seed=1, split="val")
    pred_dir = os.path.join(work, "proposals")
    write_predictions(pred_dir, boxes, noise=0.2)

    state_dict = load_torch_checkpoint(tar)
    model, cfg = convert(args, cfg, state_dict, log)
    out_dir = os.path.join(work, "refined")
    ds = run(args, cfg, model, val_root, "val", pred_dir, out_dir, log)
    return out_dir, evaluate(args, ds, pred_dir, out_dir, log)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", help="reference epoch_80.tar path")
    p.add_argument("--data_path", help="KITTI object root")
    p.add_argument("--split", default="val")
    p.add_argument("--pred_dir",
                   help="detector proposal txt dir (IDA-3D / RTS-3D / ours)")
    p.add_argument("--out_dir", default="outputs/epoch80_validation")
    p.add_argument("--backbone", default="hrnet-w48")
    p.add_argument("--gn", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="GroupNorm 3D/BEV stacks (release default); "
                   "--no-gn for BatchNorm-stack checkpoints")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--work_dir", default="runs/validate_epoch80")
    p.add_argument("--selftest", action="store_true",
                   help="run the full harness on a fabricated checkpoint + "
                   "synthetic data (no real inputs needed)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns the result printed: {"proposals" | "one_part" | "all_parts":
    {"ap3d_40", "apbev_40"}} (with ``"selftest": "ok"`` first under
    ``--selftest``); the AP part is also written to ``validation.json``
    under the output directory."""
    args = parse_args(argv)
    from snvc_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)

    def log(m):
        print(m, flush=True)

    if args.selftest:
        out_dir, result = selftest(args, log)
        printed = {"selftest": "ok", **result}
    else:
        if not (args.checkpoint and args.data_path and args.pred_dir):
            raise SystemExit("need --checkpoint, --data_path, --pred_dir "
                             "(or --selftest)")
        from snvc_tpu_torch.utils.convert_torch import load_torch_checkpoint

        state_dict = load_torch_checkpoint(args.checkpoint)
        log(f"loaded {len(state_dict)} tensors from {args.checkpoint}")
        model, cfg = convert(args, release_config(args), state_dict, log)
        out_dir = args.out_dir
        ds = run(args, cfg, model, args.data_path, args.split,
                 args.pred_dir, out_dir, log)
        result = printed = evaluate(args, ds, args.pred_dir, out_dir, log)
    print(json.dumps(printed))
    with open(os.path.join(out_dir, "validation.json"), "w") as f:
        json.dump(result, f, indent=2)
    return printed


if __name__ == "__main__":
    main()
