"""Train the global (main-scale) stereo detector from a KITTI tree (port
of tools/train_stereo.py).

  python -m snvc_tpu_torch.tools.train_stereo --model_dir runs/stereo \
      --data_path data/kitti --split train --steps 50000 \
      --augment_flip --photometric_aug

``--model_dir`` becomes an experiment directory (``config.json``,
``training.log``, ``metrics.jsonl``, ``checkpoints/<step>.pt``), which
the detect CLI takes as ``--model_dir``.  The card by default,
``--device cpu`` for the plain PyTorch versions.  Under a launcher
(``torchrun --nproc_per_node N -m snvc_tpu_torch.tools.train_stereo
...``) every rank trains data-parallel, as JAX's CLI uses every local
device: ``--batch_size`` is the global batch, each rank runs on
``cuda:LOCAL_RANK`` over NCCL (gloo with ``--device cpu``), and rank 0
alone logs and writes the directory.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model_dir", required=True)
    p.add_argument("--data_path", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--config", default=None,
                   help="JSON StereoConfig file; defaults to the flagship "
                   "config")
    p.add_argument("--steps", type=int, default=50000)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=20)
    p.add_argument("--monolithic", action="store_true",
                   help="accepted for the JAX CLI's sake: JAX chooses "
                   "between one fused program and a split step with the "
                   "same gradients; the port runs the fused step either "
                   "way")
    p.add_argument("--max_frames", type=int, default=None,
                   help="cap the number of training frames")
    p.add_argument("--augment_flip", action="store_true",
                   help="exact stereo flip augmentation (mirror world + "
                   "swap mirrored views)")
    p.add_argument("--photometric_aug", action="store_true",
                   help="per-step view-consistent color jitter + PCA "
                   "lighting")
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest checkpoint in "
                   "model_dir (params, optimizer state, step counter)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns the run's record (``tools/_train_loop.train``)."""
    args = parse_args(argv)

    import torch

    from snvc_tpu_torch.config import StereoConfig, TrainConfig, load_config
    from snvc_tpu_torch.data.kitti import KittiDataset
    from snvc_tpu_torch.data.stereo_pipeline import StereoPipeline
    from snvc_tpu_torch.models.stereonet import StereoNet
    from snvc_tpu_torch.tools._train_loop import join_data_group, train
    from snvc_tpu_torch.training.train_stereo import (
        create_stereo_state,
        make_stereo_train_step,
        stereo_batch_to_device,
    )
    from snvc_tpu_torch.utils.logging import Experimenter
    from snvc_tpu_torch.utils.seeding import reset_seed

    mesh, device = join_data_group(args.device)
    cfg = load_config(args.config, StereoConfig) if args.config \
        else StereoConfig()
    if args.photometric_aug:
        cfg = cfg.replace(photometric_aug=True)
    tc = TrainConfig(lr=args.lr, total_steps=args.steps)
    exp = Experimenter(args.model_dir, config=cfg)
    if mesh is not None:
        exp.logger.info(f"data parallel over {mesh.n_data} ranks "
                        f"({torch.distributed.get_backend()})")

    ds = KittiDataset(args.data_path, args.split)
    if args.max_frames is not None:
        ds.indices = ds.indices[: args.max_frames]
    pipe = StereoPipeline(ds, cfg, batch_size=args.batch_size,
                          augment_flip=args.augment_flip, seed=args.seed)
    gen = reset_seed(args.seed)
    state = create_stereo_state(
        StereoNet(cfg, device=device, generator=gen), tc)
    dev = state.model.device
    step_fn = make_stereo_train_step(cfg, tc, dev, mesh=mesh)

    def epoch(step):
        # the pass's order is drawn from seed + its first step, as in JAX
        for batch in pipe.batches(shuffle=True, seed=args.seed + step):
            yield stereo_batch_to_device(batch.arrays(), dev)

    return train(exp, state, cfg, tc, step_fn, epoch, args.resume,
                 args.log_every)


if __name__ == "__main__":
    main()
