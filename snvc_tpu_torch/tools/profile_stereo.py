"""Per-stage timing of the global stereo model (port of
tools/profile_stereo.py, with its stage keys).

  python -m snvc_tpu_torch.tools.profile_stereo      # StereoConfig(), bf16,
                                                     # on the card

Each stage is the real ``StereoNet``'s own code, one seeded model
(``StereoNet(cfg)``, batch 1), run alone on fresh seeded random inputs:
the backbone (``encoder.StereoFeatureNet_0``; it runs twice a frame),
the plane-sweep cost volume (K3 on the card), then ``head.stack3d``
(two ConvNorm3d, the hourglasses and their residuals),
``head.depth_head`` (the k3 Conv3d costs, the softmax expectation over
the planes), ``head.frustum`` (the frustum -> BEV resample, K4 on the
card, at the default calibration) and ``head.bev_head``, then the whole
model.  A stage is called ``--iters`` + 2 times, the first 2 as a
warm-up; on the card each call is timed with CUDA events and
synchronized, on the CPU with the host clock.  Prints one JSON object of
the median ms of each stage (``*_ms``) and ``accounted_ms`` (twice the
backbone plus the other stages).  ``--config tiny`` takes
``tiny_stereo_config``, a smoke of the mechanics whose numbers mean
nothing.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import torch

from snvc_tpu_torch.config import StereoConfig, tiny_stereo_config
from snvc_tpu_torch.geometry.calib import Calibration
from snvc_tpu_torch.models.stereo_backbone import _VARIANTS
from snvc_tpu_torch.models.stereonet import StereoNet, plane_shifts
from snvc_tpu_torch.ops.cost_volume import plane_sweep_volume_k3
from snvc_tpu_torch.utils.device import compute_dtype, resolve_device
from snvc_tpu_torch.utils.profiling import WARMUP, median_seconds


def main(argv=None) -> Dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--config", default="default", choices=["default", "tiny"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.iters < 1:
        p.error("--iters must be at least 1")

    dev = resolve_device(args.device)
    cfg = (StereoConfig() if args.config == "default"
           else tiny_stereo_config()).replace(compute_dtype=args.dtype)
    if not cfg.rpn3d_enable:
        p.error("the BEV stages need rpn3d_enable")
    dt = compute_dtype(args.dtype)
    H, W = cfg.input_size
    Hf, Wf = H // 4, W // 4
    D = cfg.num_depths
    nz, nx = cfg.bev_size
    cv = _VARIANTS[cfg.backbone][4][1]  # cost-volume feature channels
    n = args.iters + WARMUP
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, dtype=dt):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    model = StereoNet(cfg, device=dev,
                      generator=torch.Generator().manual_seed(0))
    head = model.head
    Pl = torch.from_numpy(Calibration.default().as_array()[None]).to(dev)
    Pr = torch.from_numpy(Calibration.default_right().as_array()[None]).to(dev)
    shifts = plane_shifts(Pl, Pr, head.depths)
    report = {}

    # --- stage 1: backbone (runs twice per frame) -------------------------
    report["backbone_ms"] = median_seconds(
        lambda x: model.encoder.StereoFeatureNet_0(x.to(dt)),
        lambda i: (randn((1, H, W, 3), torch.float32),), n, dev)

    # --- stage 2: plane-sweep cost volume (K3) ----------------------------
    report["cost_volume_ms"] = median_seconds(
        lambda lt, rt: plane_sweep_volume_k3(lt, rt, shifts),
        lambda i: (randn((1, Hf, Wf, cv)), randn((1, Hf, Wf, cv))), n, dev)

    # --- stage 3: 3D conv stack (2x ConvNorm3d + hourglasses) -------------
    report["stack3d_ms"] = median_seconds(
        head.stack3d, lambda i: (randn((1, D, Hf, Wf, 2 * cv)),), n, dev)

    # --- stage 4: depth head (k3 Conv3d costs -> softmax expectation) -----
    report["depth_head_ms"] = median_seconds(
        head.depth_head, lambda i: ([randn((1, D, Hf, Wf, 32))
                                     for _ in range(head._n_hg)],), n, dev)

    # --- stage 5: frustum -> voxel (K4) -----------------------------------
    report["frustum_ms"] = median_seconds(
        lambda v: head.frustum(v, Pl),
        lambda i: (randn((1, D, Hf, Wf, 32)),), n, dev)

    # --- stage 6: BEV head ------------------------------------------------
    report["bev_head_ms"] = median_seconds(
        lambda v, img: head.bev_head(v, img, Pl),
        lambda i: (randn((1, nz, nx, cfg.ny, 32)),
                   randn((1, Hf, Wf, cfg.rpn_convdim))), n, dev)

    # --- full model (split-free reference point) --------------------------
    report["full_model_ms"] = median_seconds(
        lambda lt, rt: model(lt, rt, Pl, Pr),
        lambda i: (randn((1, H, W, 3), torch.float32),
                   randn((1, H, W, 3), torch.float32)), n, dev)

    report = {k: v * 1e3 for k, v in report.items()}
    report["accounted_ms"] = (
        2 * report["backbone_ms"] + report["cost_volume_ms"]
        + report["stack3d_ms"] + report["depth_head_ms"]
        + report["frustum_ms"] + report["bev_head_ms"])
    report = {k: round(v, 2) for k, v in report.items()}
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
