"""Tracking end-metric demonstration on a synthetic moving-object sequence
(port of tools/demo_tracking.py).

  1. train the Vernier model with synthetic supervision (the AP-lift
     recipe, noise matched to the per-frame motion), or load a trained
     one (``--load_ckpt``);
  2. render a sequence where one car moves ~0.5 m a frame;
  3. track it from the frame-0 GT box: each frame's proposal is the
     previous frame's refined pose (``--motion static``) or its
     constant-velocity extrapolation (``--motion cv``);
  4. the baseline is the static prior, the frame-0 box held fixed, which
     falls behind the car by its speed each frame.

Success (printed, as in JAX, not raised): the tracker's largest centre
error stays under max(2 x speed, 0.6 m) while the static prior's final
error exceeds 3 x the tracker's mean.  Writes
``work_dir/tracking.json`` with JAX's keys.

  python -m snvc_tpu_torch.tools.demo_tracking --work_dir runs/tracking \
      --steps 600

``--load_ckpt`` takes a model of the port: a model directory
(``config.json`` beside ``<step>.pt`` or ``checkpoints/<step>.pt``) or a
``<step>.pt`` file with its ``config.json`` beside it.  A JAX (Orbax)
checkpoint is converted first with ``scripts/convert_jax_checkpoint.py``.
The card by default, ``--device cpu`` for the plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def build_config(args):
    from snvc_tpu_torch.config import BackboneConfig, VernierConfig

    # perturbation noise ~ the per-frame motion the tracker must absorb
    speed = float(abs(args.vz)) + float(abs(args.vx))
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
        std_loc=(0.7 * speed, 0.05, 0.7 * speed),
        std_rot=5.0,
        ncf_loss="mse_weighted",
        rot_aug=True,
        loc_aug=True,
        compute_dtype=args.dtype,
        remat=False,
    )


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--work_dir", default="runs/tracking_demo")
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--train_frames", type=int, default=48)
    p.add_argument("--boxes_per_frame", type=int, default=3)
    p.add_argument("--seq_frames", type=int, default=10)
    p.add_argument("--vx", type=float, default=0.15)
    p.add_argument("--vz", type=float, default=-0.45)
    p.add_argument("--yaw_rate", type=float, default=0.02)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--ncf_decode", default="argmax",
                   choices=["coordinates", "argmax", "soft-argmax"])
    p.add_argument("--motion", default="static", choices=["static", "cv"],
                   help="proposal prior: the previous refined pose "
                   "(static) or a constant-velocity extrapolation (cv)")
    p.add_argument("--beta", type=float, default=0.5,
                   help="EMA damping of the cv velocity estimate")
    p.add_argument("--load_ckpt", default=None,
                   help="a trained Vernier model of the port (a model "
                   "directory or a <step>.pt beside its config.json): skip "
                   "training and track with it")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def success(result: dict, speed: float) -> bool:
    """JAX's test (tools/demo_tracking.py:240): bounded tracker error, a
    drifting prior."""
    return (result["tracker_err_max_m"] < max(2 * speed, 0.6)
            and result["static_prior_err_final_m"]
            > 3 * result["tracker_err_mean_m"])


def load_refiner(path: str, cfg, device):
    """(config, model, step) of the port checkpoint at ``path`` (a model
    directory or a ``<step>.pt``).  The checkpoint's config.json sets the
    architecture (a difference from ``cfg`` is printed); the
    training-noise, dtype and usage fields stay ``cfg``'s, as in JAX.  A
    JAX (Orbax) directory raises SystemExit naming the converter."""
    from snvc_tpu_torch.config import VernierConfig
    from snvc_tpu_torch.models.vernier import VernierScale
    from snvc_tpu_torch.tools._model_dir import read_model_dir

    try:
        ckpt_cfg, tree, step = read_model_dir(path, VernierConfig)
    except FileNotFoundError as e:
        raise SystemExit(str(e)) from e
    arch = ("grid_resolution", "resolution", "gn_groups", "num_parts",
            "vernier_type", "use_bbox_head", "backbone")
    mismatch = [f"{f}: ckpt={getattr(ckpt_cfg, f)} vs local="
                f"{getattr(cfg, f)}" for f in arch
                if getattr(ckpt_cfg, f) != getattr(cfg, f)]
    if mismatch:
        print("checkpoint architecture differs from the default tracking "
              "config; building the model from the checkpoint's "
              "config.json:\n  " + "\n  ".join(mismatch), flush=True)
    cfg = ckpt_cfg.replace(std_loc=cfg.std_loc, std_rot=cfg.std_rot,
                           compute_dtype=cfg.compute_dtype, usage=cfg.usage,
                           sup_type=cfg.sup_type)
    model = VernierScale(cfg, device=device)
    model.load_state_dict(tree["model"], strict=True)
    return cfg, model, step


def main(argv=None) -> dict:
    """Returns the result dict written to ``tracking.json``."""
    args = parse_args(argv)

    import numpy as np

    from snvc_tpu_torch.config import TrainConfig
    from snvc_tpu_torch.data.kitti import KittiDataset
    from snvc_tpu_torch.data.synthetic import (
        make_synthetic_kitti,
        make_synthetic_sequence,
    )
    from snvc_tpu_torch.inference.refine import RefineRunner
    from snvc_tpu_torch.inference.track import Tracker
    from snvc_tpu_torch.tools._demo import (
        inference_config,
        new_refiner,
        train_refiner,
    )
    from snvc_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg = build_config(args)
    os.makedirs(args.work_dir, exist_ok=True)

    if args.load_ckpt:
        cfg, model, train_steps = load_refiner(args.load_ckpt, cfg, dev)
        print(f"loaded refiner checkpoint at step {train_steps} from "
              f"{args.load_ckpt}", flush=True)
    else:
        # --- train (synthetic supervision, static random scenes) ----------
        train_root = os.path.join(args.work_dir, "kitti_train")
        make_synthetic_kitti(train_root, args.train_frames,
                             args.boxes_per_frame, seed=args.seed,
                             split="train")
        tc = TrainConfig(lr=args.lr, warmup_steps=50, total_steps=args.steps,
                         seed=args.seed)
        state = new_refiner(cfg, tc, args.seed, dev)
        train_refiner(state, cfg, tc, train_root, args.seed, args.log_every,
                      lambda m: print(m, flush=True))
        model, train_steps = state.model, args.steps

    # --- moving sequence + tracking --------------------------------------
    seq_root = os.path.join(args.work_dir, "sequence")
    gt_per_frame = make_synthetic_sequence(
        seq_root, num_frames=args.seq_frames, seed=args.seed + 99,
        velocity=(args.vx, 0.0, args.vz), yaw_rate=args.yaw_rate)
    # argmax decode: under small per-frame motion the coordinate head
    # collapses to the mean ("no change"); the NCF peak stays informative
    infer_cfg = inference_config(cfg, max_instances=1,
                                 ncf_decode=args.ncf_decode)
    tracker = Tracker(RefineRunner(model, infer_cfg, device=dev), infer_cfg)
    scenes = KittiDataset(seq_root, "val").scenes()
    init = gt_per_frame[0][0].copy()
    states = tracker.track(scenes, init, motion=args.motion, beta=args.beta)

    err_track, err_prior, kept = [], [], []
    prior = init.copy()
    for fi, st in enumerate(states):
        gt = gt_per_frame[fi][0]
        err_track.append(float(np.linalg.norm(st.box[[3, 5]] - gt[[3, 5]])))
        err_prior.append(float(np.linalg.norm(prior[[3, 5]] - gt[[3, 5]])))
        kept.append(bool(st.kept))
        print(f"frame {fi}: tracker err {err_track[-1]:.3f} m, "
              f"static prior err {err_prior[-1]:.3f} m, kept={st.kept}",
              flush=True)

    speed = float(np.hypot(args.vx, args.vz))
    result = {
        "seq_frames": args.seq_frames,
        "motion_m_per_frame": speed,
        "tracker_err_m": err_track,
        "static_prior_err_m": err_prior,
        "tracker_err_mean_m": float(np.mean(err_track)),
        "tracker_err_max_m": float(np.max(err_track)),
        "static_prior_err_final_m": err_prior[-1],
        "kept_frames": int(np.sum(kept)),
        "train_steps": train_steps,
        "motion": args.motion,
    }
    print(json.dumps(result))
    with open(os.path.join(args.work_dir, "tracking.json"), "w") as f:
        json.dump(result, f, indent=2)
    if not success(result, speed):
        print("WARNING: tracking success criteria not met", file=sys.stderr)
    return result


if __name__ == "__main__":
    res = main()
    sys.exit(0 if success(res, res["motion_m_per_frame"]) else 1)
