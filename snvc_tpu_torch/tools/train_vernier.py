"""Train the Vernier (instance refinement) model from a KITTI tree (port
of tools/train_vernier.py): synthetic supervision, proposals drawn
around the GT boxes with gaussian noise.

  python -m snvc_tpu_torch.tools.train_vernier --model_dir runs/vernier \
      --data_path data/kitti --split train --steps 80000

``--config`` takes a config.json of either package: any head, backbone
or aggregation.  ``--model_dir`` becomes an experiment directory
(``config.json``, ``training.log``, ``metrics.jsonl``,
``checkpoints/<step>.pt``), which the serving CLIs take as
``--model_dir``.  The card by default, ``--device cpu`` for the plain
PyTorch versions.  Under a launcher every rank trains data-parallel, as
JAX's CLI uses every local device: ``--batch_instances`` is the global
batch, each rank runs on ``cuda:LOCAL_RANK`` over NCCL (gloo with
``--device cpu``), and rank 0 alone logs and writes the directory:

  torchrun --nproc_per_node 2 -m snvc_tpu_torch.tools.train_vernier \
      --model_dir runs/vernier --data_path data/kitti --steps 80000
"""

from __future__ import annotations

import argparse


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model_dir", required=True)
    p.add_argument("--data_path", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--config", default=None,
                   help="JSON config file; defaults to the flagship config")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--batch_instances", type=int, default=None)
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest checkpoint in model_dir")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=20)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns the run's record (``tools/_train_loop.train``)."""
    args = parse_args(argv)

    import torch

    from snvc_tpu_torch.config import TrainConfig, VernierConfig, load_config
    from snvc_tpu_torch.data.instance_db import build_db_from_gt
    from snvc_tpu_torch.data.kitti import KittiDataset
    from snvc_tpu_torch.data.pipeline import RefinementPipeline
    from snvc_tpu_torch.models.vernier import VernierScale
    from snvc_tpu_torch.tools._train_loop import join_data_group, train
    from snvc_tpu_torch.training.train import (
        batch_to_device,
        create_train_state,
        make_train_step,
    )
    from snvc_tpu_torch.utils.logging import Experimenter
    from snvc_tpu_torch.utils.seeding import reset_seed

    mesh, device = join_data_group(args.device)
    if args.config:
        cfg = load_config(args.config, VernierConfig)
    else:
        cfg = VernierConfig(usage="train", sup_type="synthetic")
    if args.batch_instances:
        cfg = cfg.replace(max_instances=args.batch_instances)
    # the seed also seeds the bbox head's dropout (train.dropout_generator)
    tc = TrainConfig(lr=args.lr or TrainConfig.lr,
                     total_steps=args.steps or TrainConfig.total_steps,
                     seed=args.seed)
    exp = Experimenter(args.model_dir, config=cfg)
    if mesh is not None:
        exp.logger.info(f"data parallel over {mesh.n_data} ranks "
                        f"({torch.distributed.get_backend()})")

    ds = KittiDataset(args.data_path, args.split)
    db = build_db_from_gt(ds, cfg)
    exp.logger.info(f"{len(db)} GT instances for training")
    pipe = RefinementPipeline(db, cfg, training=True, seed=args.seed)

    gen = reset_seed(args.seed)
    state = create_train_state(
        VernierScale(cfg, device=device, generator=gen), cfg, tc)
    dev = state.model.device
    step_fn = make_train_step(cfg, tc, dev, mesh=mesh)

    def epoch(step):
        for batch in pipe.batches(shuffle=True):
            yield batch_to_device(batch.arrays(), dev)

    return train(exp, state, cfg, tc, step_fn, epoch, args.resume,
                 args.log_every)


if __name__ == "__main__":
    main()
