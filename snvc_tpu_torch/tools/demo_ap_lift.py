"""End-metric demonstration: refinement lifts 3D AP over noisy proposals
(port of tools/demo_ap_lift.py).

Trains the Vernier model with synthetic supervision (proposals sampled
around the GT) on a synthetic KITTI train split, refines noisy proposals
on a held-out synthetic val split and scores both with the KITTI
evaluator: AP3D(refined) > AP3D(proposals) is the check that the whole
loop (data, model, losses, pose update, writer, evaluator) learns.

  python -m snvc_tpu_torch.tools.demo_ap_lift --work_dir runs/ap_lift \
      --steps 600

Writes under ``--work_dir``: the two trees, the proposals and their copy
as a result directory (``baseline/``), the refined predictions, the
trained model as a flat model directory (``<step>.pt`` + ``config.json``,
which the serving CLIs and ``tools/track`` take) and ``ap_lift.json``
with JAX's keys.  The card by default, ``--device cpu`` for the plain
PyTorch versions.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def build_config(args):
    from snvc_tpu_torch.config import BackboneConfig, VernierConfig

    return VernierConfig(
        backbone=BackboneConfig(name="hrnet-tiny"),
        grid_resolution=(8, 48, 48),
        resolution=(128, 128),
        gn_groups=4,
        max_instances=8,
        sigma=2,
        usage="train",
        sup_type="synthetic",
        image_size=(384, 1248),
        # the perturbation matches the val proposals' noise
        # (write_predictions: location sigma = --noise, yaw 0.08 rad)
        std_loc=(args.noise, 0.05, args.noise),
        std_rot=5.0,
        ncf_loss="mse_weighted",
        ncf_subvoxel=args.ncf_subvoxel,
        ncf_decode=args.ncf_decode,
        rot_aug=True,
        loc_aug=True,
        compute_dtype=args.dtype,
        remat=False,
    )


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--work_dir", default="runs/ap_lift")
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--train_frames", type=int, default=48)
    p.add_argument("--val_frames", type=int, default=8)
    p.add_argument("--boxes_per_frame", type=int, default=3)
    p.add_argument("--noise", type=float, default=0.25,
                   help="proposal location noise (m) on the val split")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--ncf_subvoxel", action="store_true",
                   help="draw NCF targets at fractional voxel coordinates "
                   "instead of floored ones; pair with --ncf_decode "
                   "soft-argmax")
    p.add_argument("--ncf_decode", default="coordinates",
                   choices=["coordinates", "argmax", "soft-argmax"])
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def success(result: dict) -> bool:
    """JAX's test: the best update type lifts AP3D at moderate."""
    best = max(result[f"ap3d_refined_{t}"][1] for t in ("one_part",
                                                        "all_parts"))
    return best > result["ap3d_proposals"][1]


def main(argv=None) -> dict:
    """Returns the result dict written to ``ap_lift.json``."""
    args = parse_args(argv)

    import numpy as np
    import torch

    from snvc_tpu_torch.config import TrainConfig, save_config
    from snvc_tpu_torch.data.instance_db import attach_nearest_gt
    from snvc_tpu_torch.data.pipeline import RefinementPipeline
    from snvc_tpu_torch.data.synthetic import (
        make_synthetic_kitti,
        write_predictions,
    )
    from snvc_tpu_torch.eval.kitti_ap import run_kitti_eval
    from snvc_tpu_torch.tools._demo import (
        car_ap,
        center_errors,
        copy_dir,
        inference_config,
        new_refiner,
        refine_split,
        train_refiner,
    )
    from snvc_tpu_torch.training.train import save_checkpoint
    from snvc_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg = build_config(args)
    os.makedirs(args.work_dir, exist_ok=True)
    save_config(cfg, os.path.join(args.work_dir, "config.json"))

    train_root = os.path.join(args.work_dir, "kitti_train")
    val_root = os.path.join(args.work_dir, "kitti_val")
    make_synthetic_kitti(train_root, args.train_frames, args.boxes_per_frame,
                         seed=args.seed, split="train")
    val_boxes = make_synthetic_kitti(val_root, args.val_frames,
                                     args.boxes_per_frame,
                                     seed=args.seed + 1000, split="val")
    prop_dir = os.path.join(args.work_dir, "proposals")
    write_predictions(prop_dir, val_boxes, noise=args.noise,
                      seed=args.seed + 1)
    # the proposal files double as a KITTI result dir for the baseline AP
    base_res = os.path.join(args.work_dir, "baseline")
    copy_dir(prop_dir, os.path.join(base_res, "data"))

    # --- train with synthetic supervision ---------------------------------
    tc = TrainConfig(lr=args.lr, warmup_steps=50, total_steps=args.steps,
                     seed=args.seed)
    state = new_refiner(cfg, tc, args.seed, dev)
    train_refiner(state, cfg, tc, train_root, args.seed, args.log_every,
                  lambda m: print(m, flush=True))
    save_checkpoint(args.work_dir, state, cfg, state.step)

    # --- refine the val proposals and score -------------------------------
    infer_cfg = inference_config(cfg, pred_type=("one_part", "all_parts"))
    out_dir = os.path.join(args.work_dir, "refined")
    vds, vdb, runner = refine_split(state.model, infer_cfg, val_root,
                                    prop_dir, out_dir, dev)

    # --- diagnostics: did the boxes move toward the GT? -------------------
    diag_pipe = RefinementPipeline(attach_nearest_gt(list(vdb), infer_cfg),
                                   infer_cfg, training=False,
                                   load_lidar=False)
    d_prop, d_ref = [], []
    for batch in diag_pipe.batches():
        out = runner.step(batch)
        arr = batch.arrays()
        m = arr["valid"]
        gt = arr["gt_boxes"][m]
        d_prop += list(center_errors(arr["samples"][m], gt))
        d_ref += list(center_errors(np.asarray(out["all_parts"])[m], gt))
    diag = {"mean_center_err_proposal_m": float(np.mean(d_prop)),
            "mean_center_err_refined_m": float(np.mean(d_ref))}
    print("diagnostics:", json.dumps(diag))
    del runner
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    gt_dir = vds.label_dir
    ap_base = run_kitti_eval(gt_dir, base_res)
    b3 = car_ap(ap_base)
    result = {"ap3d_proposals": b3,
              "apbev_proposals": car_ap(ap_base, "detection_ground"),
              "steps": args.steps, "noise_m": args.noise}
    best = None
    for t in infer_cfg.pred_type:
        ap_ref = run_kitti_eval(gt_dir, os.path.join(out_dir, t))
        r3 = car_ap(ap_ref)
        result[f"ap3d_refined_{t}"] = r3
        result[f"apbev_refined_{t}"] = car_ap(ap_ref, "detection_ground")
        if best is None or r3[1] > best:
            best = r3[1]
    # the moderate lift of the best update type
    result["lift_3d_moderate"] = round(best - b3[1], 2)
    result.update(diag)
    print(json.dumps(result))
    with open(os.path.join(args.work_dir, "ap_lift.json"), "w") as f:
        json.dump(result, f, indent=2)
    if not success(result):
        print("WARNING: no AP lift at moderate difficulty", file=sys.stderr)
    return result


if __name__ == "__main__":
    sys.exit(0 if success(main()) else 1)
