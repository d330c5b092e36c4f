"""Per-stage timing of the Vernier refinement step (port of
tools/profile_vernier.py, with its stage names and order).

  python -m snvc_tpu_torch.tools.profile_vernier --config flagship \\
      --batch 4 --iters 8          # on the card (--device cuda, default)

Each stage is a child of one seeded ``VernierScale(cfg)``, run alone on
fresh seeded random inputs: each layer block of the BEV_type2 / BEV_type3
head (JAX vernier.py's head, in the reference's order; the hourglasses
the model chose by grid width), HRNet over both ROI views, and the whole
encoder (HRNet + the stereo voxel sampler, K1).  The three large-tap
convs of the head run K2 on the card in bf16.  A stage is called
``--iters`` + 2 times, the first 2 as a warm-up; on the card each call is
timed with CUDA events and synchronized, on the CPU with the host clock.
The median of each stage is printed in ms, one line a stage, then one JSON
object of every stage, ``sum_of_stages_ms`` (the head's blocks and the
encoder) and ``batch``.

Configs: ``flagship`` (``config.flagship_vernier_config``: hrnet-w32,
32x192x192, 256x256 ROIs, bf16), ``small`` (hrnet-w32, 16x96x96, 256x256
ROIs, bf16) and ``tiny`` (``tiny_vernier_config``, batch 1: a smoke of
the mechanics, its numbers mean nothing).
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import torch

from snvc_tpu_torch.config import (
    BackboneConfig,
    VernierConfig,
    flagship_vernier_config,
    tiny_vernier_config,
)
from snvc_tpu_torch.models.layers import Hourglass
from snvc_tpu_torch.models.vernier import VernierScale
from snvc_tpu_torch.utils.device import compute_dtype, resolve_device
from snvc_tpu_torch.utils.profiling import WARMUP, median_seconds


def build(config: str) -> VernierConfig:
    if config == "flagship":
        return flagship_vernier_config()
    if config == "small":
        return VernierConfig(backbone=BackboneConfig(name="hrnet-w32"),
                             grid_resolution=(16, 96, 96),
                             resolution=(256, 256), max_instances=16,
                             compute_dtype="bfloat16", remat=True)
    if config == "tiny":
        return tiny_vernier_config(max_instances=4, image_size=(128, 256))
    raise ValueError(f"unknown config {config!r}")


def main(argv=None) -> Dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--config", default="flagship",
                   choices=["flagship", "small", "tiny"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.iters < 1:
        p.error("--iters must be at least 1")

    dev = resolve_device(args.device)
    cfg = build(args.config)
    if cfg.vernier_type not in ("BEV_type2", "BEV_type3"):
        p.error("the head's stages are BEV_type2 / BEV_type3 blocks")
    B = args.batch if args.config != "tiny" else 1
    nh, nw, nl = cfg.grid_resolution
    Hr, Wr = cfg.resolution
    dim = cfg.backbone.output_channel  # the voxel carries 2 * dim
    dt = compute_dtype(cfg.compute_dtype)
    n = args.iters + WARMUP
    gen = torch.Generator(device=dev).manual_seed(0)
    model = VernierScale(cfg, device=dev,
                         generator=torch.Generator().manual_seed(0))
    head, enc = model.head, model.encoder

    def randn(shape, dtype=dt):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    stages: Dict[str, float] = {}

    def record(name: str, t: float) -> None:
        stages[name] = round(t * 1000, 2)
        print(f"{name:28s} {t * 1000:8.2f} ms", flush=True)

    def stage(name, mod, shape):
        def fwd(x):
            y = mod(x, None, None) if isinstance(mod, Hourglass) else mod(x)
            return y[0] if isinstance(y, tuple) else y

        record(name, median_seconds(fwd, lambda i: (randn(shape),), n, dev))

    vox_shape = (B, nh, nw, nl, 2 * dim)
    mid_shape = (B, nh, nw, nl, dim)

    # --- head blocks (reference vernier.py:249-313 structure) ---------
    stage("head.conv1_k7 (2C->C)", head.ConvNorm3d_1, vox_shape)
    stage("head.conv2_k5", head.ConvNorm3d_2, mid_shape)
    stage("head.conv3_k5_d2", head.ConvNorm3d_3, mid_shape)
    stage("head.hourglass3d", getattr(head, head._hg3), mid_shape)
    stage("head.hourglass2d", getattr(head, head._hg2), (B, nw, nl, 64))
    stage("head.occ_conv_k3", head.ConvNorm3d_4, mid_shape)
    stage("head.conv4_k3 (2C->C)", getattr(head, head._post), vox_shape)
    stage("head.bev_conv", head.ConvNorm_0, (B, nw, nl, (nh // 4) * dim))

    # --- encoder: HRNet (both views stacked) and the full voxel build --
    stage("enc.hrnet_2views", enc.HRNet_0, (2 * B, Hr, Wr, 3))
    P = nh * nw * nl
    # the grid projections: fixed, uniform over the ROI (JAX's)
    gl = torch.rand((B, P, 2), generator=gen, device=dev) * Wr
    gr = torch.rand((B, P, 2), generator=gen, device=dev) * Wr
    record("encoder_full", median_seconds(
        lambda a, b: enc(a, b, gl, gr),
        lambda i: (randn((B, Hr, Wr, 3)), randn((B, Hr, Wr, 3))), n, dev))

    total = sum(v for k, v in stages.items()
                if k.startswith("head.")) + stages["encoder_full"]
    stages["sum_of_stages_ms"] = round(total, 2)
    stages["batch"] = B
    print(json.dumps(stages), flush=True)
    return stages


if __name__ == "__main__":
    main()
