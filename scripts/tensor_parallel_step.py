"""Steps of the port's tensor parallelism (the mesh's "model" axis)
under a launcher: every rank of ``torchrun`` joins a data x model mesh
(``parallel.initialize_multihost(..., n_model)``) and trains ``--steps``
steps of either model, or serves as many requests, with the volume split
over the model axis; each rank prints one JSON line: the last step's
metrics, each step's ms (the card synchronized) and, on the card, its
peak memory.  ``--n_model 1`` on one rank is the one-process step.
``--positions`` runs the one-process form of the mesh instead, with no
launcher (``parallel.make_mesh(-1, devices, n_model)``: a thread a
position, parallel/local.py), and prints one line for the process.

    # two ranks on one card (gloo: NCCL refuses two ranks on one GPU)
    torchrun --nproc_per_node 2 scripts/tensor_parallel_step.py \\
        --model stereo --backend gloo
    # one GPU a rank (NCCL), or ranks on the CPU
    torchrun --nproc_per_node 4 scripts/tensor_parallel_step.py \\
        --model vernier --n_model 2
    torchrun --nproc_per_node 2 scripts/tensor_parallel_step.py \\
        --model stereo --device cpu --tiny
    # the one-process form: two positions on one card, no launcher
    python scripts/tensor_parallel_step.py --model vernier \\
        --positions cuda:0,cuda:0

The models are seeded and random; ``--tiny`` takes the small test
configs, otherwise ``StereoConfig()`` (batch: a frame a data position)
and the flagship Vernier grid at ``TrainConfig().batch_size`` instances.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> dict:
    from snvc_tpu_torch.config import (
        StereoConfig,
        TrainConfig,
        flagship_vernier_config,
        tiny_stereo_config,
        tiny_vernier_config,
    )
    from snvc_tpu_torch.data.stereo import synthetic_stereo_request
    from snvc_tpu_torch.data.synthetic import synthetic_batch_arrays
    from snvc_tpu_torch.inference.detect import DetectRunner
    from snvc_tpu_torch.models.stereonet import StereoNet
    from snvc_tpu_torch.models.vernier import VernierScale
    from snvc_tpu_torch.parallel.api import initialize_multihost, make_mesh
    from snvc_tpu_torch.training.train import (
        batch_to_device,
        create_train_state,
        make_train_step,
    )
    from snvc_tpu_torch.training.train_stereo import (
        create_stereo_state,
        make_stereo_train_step,
        stereo_batch_to_device,
    )

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=("stereo", "vernier"),
                    default="stereo")
    ap.add_argument("--serve", action="store_true",
                    help="one DetectRunner request instead of a step "
                         "(stereo, one data position)")
    ap.add_argument("--n_model", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None,
                    help="nccl on the card, gloo on the CPU (default)")
    ap.add_argument("--positions", default=None,
                    help="comma-separated devices of a one-process mesh, "
                         "n_model of them a data position (no launcher)")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=1)
    args = ap.parse_args(argv)
    on_card = torch.device(args.device).type == "cuda"
    backend = args.backend or ("nccl" if on_card else "gloo")
    if args.positions:
        mesh = make_mesh(-1, args.positions.split(","), args.n_model)
    else:
        mesh = initialize_multihost(backend, args.device,
                                    n_model=args.n_model)
        if mesh is None:
            raise SystemExit("run under a launcher: torchrun "
                             "--nproc_per_node N, or pass --positions")
    dev = mesh.devices[mesh.rank or 0]
    cards = set(mesh.devices) if mesh.rank is None else {dev}
    on_card = dev.type == "cuda"
    gen = torch.Generator().manual_seed(0)
    tc = TrainConfig(warmup_steps=2)
    if args.model == "stereo":
        cfg = tiny_stereo_config() if args.tiny else StereoConfig()
        model = StereoNet(cfg, device=dev, generator=gen)
        if args.serve:
            runner = DetectRunner(model, cfg, device=dev,
                                  mesh=mesh if mesh.n_model > 1 else None)

            def step():
                out = runner.forward(synthetic_stereo_request(cfg, seed=1))
                return dict(proposals=out[3].sum(), top_score=out[1].max())
        else:
            state = create_stereo_state(model, tc)
            batch = stereo_batch_to_device(synthetic_stereo_request(
                cfg, seed=0, frames=mesh.n_data, boxes_per_frame=4), dev)
            train = make_stereo_train_step(cfg, tc, dev, mesh)

            def step():
                return train(state, batch)
    else:
        cfg = (tiny_vernier_config(max_instances=4) if args.tiny else
               flagship_vernier_config(max_instances=tc.batch_size))
        state = create_train_state(VernierScale(cfg, device=dev,
                                                generator=gen), cfg, tc)
        batch = batch_to_device(synthetic_batch_arrays(cfg, seed=0), dev)
        train = make_train_step(cfg, tc, dev, mesh)

        def step():
            return train(state, batch)
    ms = []
    for _ in range(args.steps):
        t = time.perf_counter()
        metrics = {k: float(v) for k, v in step().items()}
        if on_card:  # every card this process drives
            for d in cards:
                torch.cuda.synchronize(d)
        ms.append((time.perf_counter() - t) * 1e3)
    where = (dict(positions=len(mesh.devices)) if mesh.rank is None else
             dict(rank=mesh.rank, data=mesh.data_index,
                  model=mesh.model_index))
    rec = dict(**where, n_model=mesh.n_model, step_ms=ms, **metrics)
    if on_card:
        rec["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
