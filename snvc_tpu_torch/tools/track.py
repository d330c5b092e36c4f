"""Track one object across a KITTI frame sequence from an initial cuboid
with the Vernier model (port of tools/track.py):

  python -m snvc_tpu_torch.tools.track --model_dir runs/vernier \
      --data_path data/kitti --frames 0 1 2 3 \
      --init_box 1.5 1.6 3.8 2.0 1.65 20.0 0.0

``--model_dir`` holds ``config.json`` (a VernierConfig) and the
checkpoints: ``checkpoints/<step>.pt`` as ``train_vernier`` writes them,
or ``<step>.pt`` beside the config.  Runs on the card; ``--device cpu``
runs the plain PyTorch versions.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model_dir", required=True)
    p.add_argument("--data_path", required=True)
    p.add_argument("--split", default="val")
    p.add_argument("--frames", type=int, nargs="+", required=True)
    p.add_argument("--init_box", type=float, nargs=7, required=True,
                   help="h w l x y z ry (KITTI rect frame, bottom center)")
    p.add_argument("--update", default="all_parts",
                   choices=["all_parts", "one_part"])
    p.add_argument("--motion", default="static", choices=["static", "cv"],
                   help="proposal prior between frames: the previous pose, "
                   "or a constant-velocity extrapolation (EMA-damped) so "
                   "the refiner corrects only the residual")
    p.add_argument("--motion_beta", type=float, default=0.5,
                   help="EMA damping of the velocity estimate (cv prior)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> list:
    """Returns the ``TrackState`` of each frame."""
    args = parse_args(argv)

    import numpy as np

    from snvc_tpu_torch.config import VernierConfig
    from snvc_tpu_torch.data.kitti import KittiDataset
    from snvc_tpu_torch.inference.refine import RefineRunner
    from snvc_tpu_torch.inference.track import Tracker
    from snvc_tpu_torch.models.vernier import VernierScale
    from snvc_tpu_torch.tools._model_dir import load_model

    cfg, model, _ = load_model(args.model_dir, VernierConfig, VernierScale,
                               args.device)
    cfg = cfg.replace(max_instances=1)
    ds = KittiDataset(args.data_path, args.split)
    tracker = Tracker(RefineRunner(model, cfg, device=args.device), cfg,
                      update=args.update)
    states = tracker.track([ds.scene(i) for i in args.frames],
                           np.array(args.init_box), motion=args.motion,
                           beta=args.motion_beta)
    for fi, st in zip(args.frames, states):
        print(f"frame {fi:06d}: kept={st.kept} conf={st.confidence:.3f} "
              f"box=[{', '.join(f'{v:.3f}' for v in st.box)}]")
    return states


if __name__ == "__main__":
    main()
