"""Useful model FLOPs of one unit of work, counted on the plain reference.

``torch.utils.flop_counter.FlopCounterMode`` counts the convolutions and
matmuls of the reference's forward at the cell's shapes on the meta
device (no memory, no device): one refined instance (both views' HRNet,
the voxel head and the coordinate head), or one detected pair (both
views' backbone, the stack, the BEV head; not the right view's RPN
feature, which the program computes and drops).  Padded instance slots
and the program's own extra work are not in it.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import stereo as ref_stereo
from portbench.reference import vernier as ref_vernier


def _count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def refine_flops_per_instance(cfg: Dict) -> float:
    with torch.device("meta"):
        model = ref_vernier.VernierScale(cfg)
    nh, nw, nl = cfg["grid_resolution"]
    H, W = cfg["resolution"]

    def fwd():
        with torch.device("meta"):
            roi = torch.empty(1, H, W, 3)
            proj = torch.empty(1, nh * nw * nl, 2)
            model.head(model.encoder(roi, roi, proj, proj))

    return float(_count(fwd))


def detect_flops_per_pair(cfg: Dict) -> float:
    with torch.device("meta"):
        model = ref_stereo.StereoNet(cfg)
    H, W = cfg["input_size"]

    def fwd():
        with torch.device("meta"):
            img = torch.empty(1, H, W, 3)
            P = torch.empty(1, 3, 4)
            lf, rf, rpn = model.encoder(img, img)
            head = model.head
            vol = torch.empty(1, cfg["num_depths"], H // 4, W // 4, 64)
            base = head.ConvNorm3d_1(head.ConvNorm3d_0(vol))
            v = base + head.Hourglass_0(base)[0]
            head.Conv3d_0(v)
            nz, nx, ny = ref_stereo.bev_size(cfg)
            bev = head.ConvNorm_0(torch.empty(1, nz, nx, ny * 32))
            bev = head.ConvNorm_1(torch.empty(1, nz, nx, 64 + rpn.shape[-1]))
            bev = bev + head.Hourglass_1(bev)[0]
            head.Conv_0(bev), head.Conv_1(bev), head.Conv_2(bev)

    return float(_count(fwd))
