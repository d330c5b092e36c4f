"""Two-stage end-metric demonstration: detect -> refine -> evaluate with
both stages trained (port of tools/demo_two_stage.py), on synthetic KITTI:

  1. train the global StereoNet on a synthetic train split (RPN3D and
     depth losses).  JAX splits its step into several programs
     (``make_stereo_train_step_split``) to bound compile memory; the port
     runs the one fused step of ``training/train_stereo``, whose
     gradients are the same function;
  2. decode its proposals on a held-out val split (rotated NMS) and score
     them with the KITTI evaluator: AP3D(proposals);
  3. train the Vernier refinement model with synthetic supervision whose
     noise matches the measured stage-1 proposal error;
  4. refine the stage-1 proposals and score them: AP3D(refined).

Success = AP3D(proposals) > 0 and AP3D(refined) > AP3D(proposals) at
moderate (printed, as in JAX).

  python -m snvc_tpu_torch.tools.demo_two_stage --work_dir runs/two_stage \
      --stereo_steps 1500 --vernier_steps 800

Checkpoints go to ``work_dir/stereo_ckpt`` and ``work_dir/vernier_ckpt``
(``<step>.pt`` + ``config.json``: model directories the serving CLIs
take); a rerun resumes from them.  ``two_stage.json`` (``stage1.json``
with ``--stage1_only``) has JAX's keys.  The card by default,
``--device cpu`` for the plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def stereo_config(args):
    from snvc_tpu_torch.config import StereoConfig, tiny_stereo_config

    classes = tuple(args.classes.split(","))
    fields = dict(reg_heading_sym=args.reg_heading_sym,
                  photometric_aug=args.photo_aug,
                  num_classes=len(classes), class_names=classes,
                  num_hourglasses=args.num_hourglasses,
                  depth_loss=args.depth_loss,
                  depth_offset=args.depth_offset)
    if args.smoke:
        # a CPU-runnable mechanics check (AP not meaningful)
        return tiny_stereo_config(z_max=38.0, max_depth=40.0,
                                  compute_dtype=args.dtype).replace(**fields)
    # full input resolution (depth precision through the cost volume is
    # resolution-bound), the BEV cropped to where the synthetic boxes live
    # (z 12..35 m, |x| <= ~0.125 z); every grid size divides by 4:
    # features 96x312, depth 64, BEV 180x120
    return StereoConfig(backbone="reslike-det-small", input_size=(384, 1248),
                        num_depths=64, min_depth=4.0, max_depth=40.0,
                        z_min=4.0, z_max=40.0, x_min=-12.0, x_max=12.0,
                        voxel_x=0.2, voxel_y=0.2, voxel_z=0.2,
                        compute_dtype=args.dtype, **fields)


def vernier_config(args, noise_loc, noise_rot_deg):
    from snvc_tpu_torch.config import BackboneConfig, VernierConfig

    return VernierConfig(
        backbone=BackboneConfig(name="hrnet-tiny"),
        grid_resolution=(8, 24, 24) if args.smoke else (8, 48, 48),
        resolution=(64, 64) if args.smoke else (128, 128),
        gn_groups=4,
        max_instances=8,
        sigma=2,
        usage="train",
        sup_type="synthetic",
        image_size=(384, 1248),
        std_loc=(noise_loc, 0.05, noise_loc),
        std_rot=noise_rot_deg,
        ncf_loss="mse_weighted",
        ncf_subvoxel=args.ncf_subvoxel,
        rot_aug=True,
        loc_aug=True,
        compute_dtype=args.dtype,
        remat=False,
    )


def _has_checkpoint(ckpt_dir: str) -> bool:
    return os.path.isdir(ckpt_dir) and any(
        f.endswith(".pt") for f in os.listdir(ckpt_dir))


def train_stereo_stage(args, train_root, log, device):
    """Trains (or resumes, or with ``--reuse_stereo`` reloads) stage 1;
    returns (model, state, config)."""
    import numpy as np

    from snvc_tpu_torch.config import TrainConfig
    from snvc_tpu_torch.data.kitti import KittiDataset
    from snvc_tpu_torch.data.stereo_pipeline import StereoPipeline
    from snvc_tpu_torch.models.stereonet import StereoNet
    from snvc_tpu_torch.tools._demo import fit
    from snvc_tpu_torch.training.train import (
        load_checkpoint,
        save_checkpoint,
    )
    from snvc_tpu_torch.training.train_stereo import (
        create_stereo_state,
        make_stereo_train_step,
        stereo_batch_to_device,
    )
    from snvc_tpu_torch.utils.seeding import reset_seed

    cfg = stereo_config(args)
    tc = TrainConfig(lr=args.stereo_lr, warmup_steps=100,
                     total_steps=args.stereo_steps)
    ds = KittiDataset(train_root, "train")
    pipe = StereoPipeline(ds, cfg, batch_size=args.stereo_batch)
    model = StereoNet(cfg, device=device, generator=reset_seed(args.seed))
    state = create_stereo_state(model, tc)
    ckpt_dir = os.path.join(args.work_dir, "stereo_ckpt")
    if _has_checkpoint(ckpt_dir):
        load_checkpoint(ckpt_dir, state)
        if args.reuse_stereo or state.step >= args.stereo_steps:
            log(f"reusing stage-1 checkpoint at step {state.step}")
            return model, state, cfg
        # a periodic checkpoint of a cut run: resume rather than retrain
        log(f"resuming stage-1 training from step {state.step}")
    step0 = state.step
    step_fn = make_stereo_train_step(cfg, tc, model.device)
    # every batch built once and replayed each pass (uint8 images: ~3 MB a
    # frame); with --augment_flip the pool also holds each batch's exact
    # stereo flip
    groups = pipe.index_groups()
    flips = [False] + ([True] if args.augment_flip else [])
    batches = []
    for flip in flips:
        for bi, g in enumerate(groups):
            batches.append(pipe.make_batch(
                g, flips=[flip] * len(g) if flip else None).arrays())
            if (bi + 1) % 256 == 0:
                log(f"built {bi + 1}/{len(groups)} "
                    f"{'flipped ' if flip else ''}batches")
    log(f"stage 1: {len(ds)} frames, {len(batches)} batches/epoch")
    # a resumed run reshuffles with a step-dependent seed, as in JAX
    order_rng = np.random.default_rng(args.seed + 31 + step0)
    t0 = time.time()

    def epoch():
        for i in order_rng.permutation(len(batches)):
            yield stereo_batch_to_device(batches[i], model.device)

    def after_step(step):
        if step == step0 + 1:
            log(f"first step (warm-up included): {time.time() - t0:.1f}s")
        if step % args.ckpt_every == 0 and step < args.stereo_steps:
            save_checkpoint(ckpt_dir, state, cfg, step)
            log(f"checkpoint saved at step {step}")

    fit(state, step_fn, epoch, args.stereo_steps, args.log_every, log,
        prefix="stereo step", after_step=after_step)
    save_checkpoint(ckpt_dir, state, cfg, state.step)
    return model, state, cfg


def detect_stage(args, model, cfg, val_root, out_dir, log, device,
                 split="val"):
    """Stage 1's proposals for every frame of ``split`` under
    ``out_dir/data``; returns the split."""
    from snvc_tpu_torch.data.kitti import KittiDataset
    from snvc_tpu_torch.inference.detect import DetectRunner

    ds = KittiDataset(val_root, split)
    runner = DetectRunner(model, cfg, max_boxes=args.max_proposals,
                          score_threshold=args.score_threshold,
                          nms_iou=args.nms_iou, device=device)
    n_total = runner.run(ds, out_dir, prefetch=4)
    log(f"stage 1 proposals: {n_total} over {len(ds)} {split} frames")
    return ds


def measure_proposal_error(ds, pred_dir, log, rot_cap_deg=15.0):
    """Mean centre / yaw error of the proposals against their nearest GT
    (which sets the Vernier training noise): (gaussian location std,
    rotation std in degrees, the [K, 7] bank of deltas pred - GT with the
    yaw wrapped mod pi, or None).  Deltas off the refinement grid or
    turned by more than ``rot_cap_deg`` stay out of the bank."""
    import numpy as np

    from snvc_tpu_torch.config import VernierConfig
    from snvc_tpu_torch.data.instance_db import (
        attach_nearest_gt,
        build_db_from_predictions,
    )

    cfg = VernierConfig()
    db = attach_nearest_gt(build_db_from_predictions(ds, cfg, pred_dir), cfg)
    # the nearest GT has no distance cutoff: a false positive far from any
    # GT would inject an error the refiner can never correct, so the bank
    # is bounded by the grid's half extent
    max_dx = 0.5 * (cfg.x_range[1] - cfg.x_range[0])
    max_dz = 0.5 * (cfg.z_range[1] - cfg.z_range[0])
    rot_cap = np.radians(rot_cap_deg)
    d_loc, d_rot, bank = [], [], []
    n_far, n_spun = 0, 0
    for rec in db:
        if rec.label is None:
            continue
        d_loc.append(float(np.linalg.norm(rec.pred[[3, 5]]
                                          - rec.label[[3, 5]])))
        # mod pi: a heading flip leaves the footprint (and IoU) unchanged
        dr = (rec.pred[6] - rec.label[6] + np.pi / 2) % np.pi - np.pi / 2
        d_rot.append(abs(float(dr)))
        delta = (rec.pred - rec.label).astype(np.float64)
        delta[6] = dr
        if abs(delta[3]) > max_dx or abs(delta[5]) > max_dz:
            n_far += 1
            continue
        if abs(dr) > rot_cap:
            n_spun += 1
            continue
        bank.append(delta)
    if not d_loc:
        return 0.25, 5.0, None
    loc = float(np.mean(d_loc))
    rot = float(np.degrees(np.mean(d_rot)))
    log(f"proposal error vs GT: center {loc:.3f} m, yaw {rot:.1f} deg")
    if n_far or n_spun:
        log(f"noise bank: dropped {n_far} off-grid (>±{max_dx:.1f} m) and "
            f"{n_spun} over-rotated (>±{rot_cap_deg:.0f} deg) of "
            f"{len(d_loc)} matched proposals")
    # the gaussian std whose mean |2d offset| matches: sigma sqrt(pi / 2)
    return (max(0.1, loc / 1.25), min(max(3.0, rot), rot_cap_deg),
            np.stack(bank) if bank else None)


def train_and_refine(args, vcfg, train_root, val_root, pred_dir, out_dir,
                     log, device, noise_bank=None):
    """Trains (or resumes) the Vernier model, then refines the proposals
    of ``pred_dir`` into ``out_dir``; returns the val split."""
    from snvc_tpu_torch.config import TrainConfig
    from snvc_tpu_torch.tools._demo import (
        inference_config,
        new_refiner,
        refine_split,
        train_refiner,
    )
    from snvc_tpu_torch.training.train import (
        load_checkpoint,
        save_checkpoint,
    )

    tc = TrainConfig(lr=args.vernier_lr, warmup_steps=50,
                     total_steps=args.vernier_steps, seed=args.seed)
    state = new_refiner(vcfg, tc, args.seed, device)
    ckpt_dir = os.path.join(args.work_dir, "vernier_ckpt")
    if _has_checkpoint(ckpt_dir):
        load_checkpoint(ckpt_dir, state)
        log(f"resuming vernier training from step {state.step}")

    def after_step(step):
        if step % args.vernier_ckpt_every == 0 and step < args.vernier_steps:
            save_checkpoint(ckpt_dir, state, vcfg, step)
            log(f"vernier checkpoint saved at step {step}")

    train_refiner(state, vcfg, tc, train_root, args.seed, args.log_every,
                  log, noise_bank=noise_bank, prefix="vernier step",
                  after_step=after_step)
    if not os.path.isfile(os.path.join(ckpt_dir, f"{state.step}.pt")):
        save_checkpoint(ckpt_dir, state, vcfg, state.step)
    infer_cfg = inference_config(vcfg, pred_type=("one_part", "all_parts"),
                                 ncf_decode=args.ncf_decode)
    vds, _, _ = refine_split(state.model, infer_cfg, val_root, pred_dir,
                             out_dir, device)
    return vds


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--work_dir", default="runs/two_stage")
    p.add_argument("--train_frames", type=int, default=192)
    p.add_argument("--val_frames", type=int, default=16)
    p.add_argument("--boxes_per_frame", type=int, default=3)
    p.add_argument("--classes", default="Car",
                   help="comma-separated KITTI classes to render and "
                   "detect (e.g. Car,Pedestrian,Cyclist); stage 1 trains "
                   "one class slot per entry")
    p.add_argument("--stereo_steps", type=int, default=6000)
    p.add_argument("--stereo_lr", type=float, default=3e-4)
    p.add_argument("--stereo_batch", type=int, default=1)
    p.add_argument("--vernier_steps", type=int, default=1500)
    p.add_argument("--vernier_lr", type=float, default=1e-3)
    p.add_argument("--max_proposals", type=int, default=8)
    # AP ranks: a low threshold adds low-score false positives but raises
    # the recall ceiling
    p.add_argument("--score_threshold", type=float, default=0.02)
    p.add_argument("--nms_iou", type=float, default=0.25)
    p.add_argument("--noise_mode", default="gaussian",
                   choices=["gaussian", "empirical"],
                   help="vernier training perturbations: gaussians matched "
                   "to the measured error scale, or draws from the "
                   "measured proposal-minus-GT deltas")
    p.add_argument("--noise_rot_cap", type=float, default=15.0,
                   help="ceiling on the vernier training rotation noise "
                   "(deg)")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--ckpt_every", type=int, default=2000,
                   help="periodic stage-1 checkpoint cadence (steps)")
    p.add_argument("--vernier_ckpt_every", type=int, default=500,
                   help="periodic stage-2 checkpoint cadence (steps)")
    p.add_argument("--ncf_subvoxel", action="store_true",
                   help="continuous-offset NCF peaks; pair with "
                   "--ncf_decode soft-argmax")
    p.add_argument("--ncf_decode", default="argmax",
                   choices=["coordinates", "argmax", "soft-argmax"],
                   help="part-position source of the pose update: the "
                   "coordinate head or the NCF heatmap decode")
    p.add_argument("--photo_aug", action="store_true",
                   help="view-consistent photometric jitter in stage 1")
    p.add_argument("--reg_heading_sym", action="store_true",
                   help="heading-symmetric corner regression")
    p.add_argument("--augment_flip", action="store_true",
                   help="double the stage-1 batch pool with exact stereo "
                   "flips")
    p.add_argument("--num_hourglasses", type=int, default=1)
    p.add_argument("--depth_loss", default="w1", choices=["sl1", "w1"])
    p.add_argument("--depth_offset", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--stage1_only", action="store_true",
                   help="stop after scoring the stage-1 proposals")
    p.add_argument("--smoke", action="store_true",
                   help="tiny CPU-runnable mechanics check (AP not "
                   "meaningful)")
    p.add_argument("--reuse_stereo", action="store_true",
                   help="load work_dir/stereo_ckpt instead of training "
                   "stage 1")
    p.add_argument("--reuse_proposals", action="store_true",
                   help="skip stage 1 and use the proposals already in "
                   "work_dir/proposals")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def success(result: dict, stage1_only: bool = False) -> bool:
    """JAX's test: stage 1 detects, and refinement lifts AP3D moderate."""
    p3 = result["ap3d_proposals"][1]
    if stage1_only:
        return p3 > 0
    best = result["ap3d_moderate_refined_best"]
    return p3 > 0 and best is not None and best > p3


def main(argv=None) -> dict:
    """Returns the result dict written to ``two_stage.json`` (or
    ``stage1.json``)."""
    args = parse_args(argv)

    from snvc_tpu_torch.data.kitti import KittiDataset
    from snvc_tpu_torch.data.synthetic import make_synthetic_kitti
    from snvc_tpu_torch.eval.kitti_ap import run_kitti_eval
    from snvc_tpu_torch.tools._demo import car_ap
    from snvc_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    os.makedirs(args.work_dir, exist_ok=True)

    def log(msg):
        print(msg, flush=True)

    train_root = os.path.join(args.work_dir, "kitti_train")
    val_root = os.path.join(args.work_dir, "kitti_val")
    classes = tuple(args.classes.split(","))
    make_synthetic_kitti(train_root, args.train_frames, args.boxes_per_frame,
                         seed=args.seed, split="train", classes=classes)
    make_synthetic_kitti(val_root, args.val_frames, args.boxes_per_frame,
                         seed=args.seed + 1000, split="val", classes=classes)

    # ---- stage 1: train + detect + score --------------------------------
    prop_res = os.path.join(args.work_dir, "proposals")
    prop_data = os.path.join(prop_res, "data")
    if (args.reuse_proposals and os.path.isdir(prop_data)
            and len(os.listdir(prop_data)) >= args.val_frames):
        log(f"reusing proposals in {prop_data}")
        vds = KittiDataset(val_root, "val")
    else:
        smodel, _, scfg = train_stereo_stage(args, train_root, log, dev)
        vds = detect_stage(args, smodel, scfg, val_root, prop_res, log, dev)
        del smodel
    gt_dir = vds.label_dir
    ap_prop = run_kitti_eval(gt_dir, prop_res)
    p3, pb = car_ap(ap_prop), car_ap(ap_prop, "detection_ground")
    log(f"AP3D(proposals)  e/m/h: {p3}")
    log(f"APBEV(proposals) e/m/h: {pb}")
    # a diagnostic readout at IoU 0.5 beside the official 0.7
    p3_50 = car_ap(run_kitti_eval(gt_dir, prop_res, car_min_iou=0.5))
    log(f"AP3D@0.5(proposals) e/m/h: {p3_50}")
    per_class = {}
    for c in classes:
        row = ap_prop.get(c.lower(), {}).get("detection_3d")
        if row is not None:
            per_class[c] = row["ap40"]
            if c != "Car":
                log(f"AP3D(proposals/{c}) e/m/h: {row['ap40']}")
    if args.stage1_only:
        result = {"ap3d_proposals": p3, "apbev_proposals": pb,
                  "ap3d_proposals_iou50": p3_50,
                  "stereo_steps": args.stereo_steps,
                  "num_hourglasses": args.num_hourglasses,
                  "depth_loss": args.depth_loss,
                  "depth_offset": args.depth_offset}
        if len(classes) > 1:
            result["per_class_ap3d_proposals"] = per_class
        print(json.dumps(result))
        with open(os.path.join(args.work_dir, "stage1.json"), "w") as f:
            json.dump(result, f, indent=2)
        return result

    # ---- stage 2: train vernier with matched noise, refine, score -------
    noise_loc, noise_rot, noise_bank = measure_proposal_error(
        vds, prop_data, log, rot_cap_deg=args.noise_rot_cap)
    vcfg = vernier_config(args, noise_loc, noise_rot)
    refined_dir = os.path.join(args.work_dir, "refined")
    train_and_refine(
        args, vcfg, train_root, val_root, prop_data, refined_dir, log, dev,
        noise_bank=noise_bank if args.noise_mode == "empirical" else None)

    result = {"ap3d_proposals": p3, "apbev_proposals": pb,
              "ap3d_proposals_iou50": p3_50,
              "stereo_steps": args.stereo_steps,
              "vernier_steps": args.vernier_steps,
              "proposal_noise_loc_m": noise_loc,
              "proposal_noise_rot_deg": noise_rot,
              "ncf_decode": args.ncf_decode,
              "ncf_subvoxel": args.ncf_subvoxel}
    if len(classes) > 1:
        result["per_class_ap3d_proposals"] = per_class
    best = None
    for t in ("one_part", "all_parts"):
        d = os.path.join(refined_dir, t)
        if not os.path.isdir(d):
            continue
        ap_ref = run_kitti_eval(gt_dir, d)
        r3 = car_ap(ap_ref)
        result[f"ap3d_refined_{t}"] = r3
        result[f"apbev_refined_{t}"] = car_ap(ap_ref, "detection_ground")
        result[f"ap3d_refined_{t}_iou50"] = car_ap(
            run_kitti_eval(gt_dir, d, car_min_iou=0.5))
        log(f"AP3D(refined/{t}) e/m/h: {r3}  @0.5: "
            f"{result[f'ap3d_refined_{t}_iou50']}")
        if best is None or r3[1] > best:
            best = r3[1]
    result["ap3d_moderate_proposals"] = p3[1]
    result["ap3d_moderate_refined_best"] = best
    result["lift_3d_moderate"] = round((best or 0.0) - p3[1], 2)
    print(json.dumps(result))
    with open(os.path.join(args.work_dir, "two_stage.json"), "w") as f:
        json.dump(result, f, indent=2)
    if not success(result):
        print("WARNING: two-stage success criteria not met", file=sys.stderr)
    return result


if __name__ == "__main__":
    args_ = parse_args()
    sys.exit(0 if success(main(), args_.stage1_only) else 1)
