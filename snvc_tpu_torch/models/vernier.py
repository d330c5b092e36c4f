"""Vernier-scale instance refinement network (port of
snvc_tpu/models/vernier.py:89-314, the ``BEV_type3`` head with ``concat``
aggregation).

Voxel volumes are NDHWC [N, nh, nw, nl, C]; heatmaps come out as
[N, P, nl, nw]; outputs are float32 whatever the compute dtype.  The
stereo voxel is sampled by ``stereo_voxel_sample`` (kernel K1 on the card)
and the head's conv1_k7 / conv2_k5 / conv3_k5_d2 run through
``Conv3d`` -> ``conv3d_large_tap`` (kernel K2 on the card).

Child names follow the Flax modules (``ConvNorm3d_0`` ...), see
models/layers.py.  The ``3D``, ``BEV`` and ``BEV_type2`` heads are not
ported yet and raise ``NotImplementedError``.

The module's mode is the JAX ``train`` flag: in train mode BatchNorm uses
batch statistics (over both views stacked, as the encoder runs one HRNet
pass over both) and, with ``cfg.remat``, the 3D hourglass is
rematerialized in the backward (``torch.utils.checkpoint``), as JAX's
``nn.remat`` does (vernier.py:188-202).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from snvc_tpu_torch.config import VernierConfig
from snvc_tpu_torch.models.fc_model import FCModel
from snvc_tpu_torch.models.hrnet import BasicBlock, HRNet
from snvc_tpu_torch.models.layers import (
    Conv3d,
    ConvNorm,
    ConvNorm3d,
    Hourglass,
    HourglassDeep,
    avg_pool_height,
    conv2d_nhwc,
    frozen_batch_stats,
    init_weights,
)
from snvc_tpu_torch.ops.stereo_sample_cuda import stereo_voxel_sample
from snvc_tpu_torch.utils.device import compute_dtype, resolve_device


class CoordHead(nn.Module):
    """Heatmaps (+ coord-conv maps) -> normalized part coordinates
    (JAX vernier.py:44).  Strided BasicBlocks until the length axis is at
    most 6, then a VALID conv over the remaining extent, then sigmoid.
    The extent is computed from the grid at construction (torch needs the
    kernel size up front; JAX reads it from the traced shape)."""

    def __init__(self, num_parts: int, nl: int, nw: int):
        super().__init__()
        ch = num_parts * 2
        self.num_parts = num_parts
        blocks = [BasicBlock(num_parts + 2, ch, stride=2)]
        h, w = (nl + 1) // 2, (nw + 1) // 2
        while h > 6:
            blocks.append(BasicBlock(ch, ch, stride=2))
            h, w = (h + 1) // 2, (w + 1) // 2
        for i, b in enumerate(blocks):
            self.add_module(f"BasicBlock_{i}", b)
        self.blocks = blocks
        self.Conv_0 = nn.Conv2d(ch, ch, (h, w), bias=True)

    def forward(self, x):
        for b in self.blocks:
            x = b(x)
        x = torch.sigmoid(conv2d_nhwc(x, self.Conv_0))
        return x.reshape(x.shape[0], self.num_parts, 2)


def _coord_maps(n: int, nl: int, nw: int, dtype, device):
    """[N, nl, nw, 2]: x in [0, 1] along width, z in [0, 1] along length."""
    xm = torch.linspace(0.0, 1.0, nw, device=device)[None, :].expand(nl, nw)
    zm = torch.linspace(0.0, 1.0, nl, device=device)[:, None].expand(nl, nw)
    m = torch.stack([xm, zm], dim=-1).to(dtype)
    return m[None].expand(n, nl, nw, 2)


class VernierEncoder(nn.Module):
    """ROIs -> object-centric voxel: a shared HRNet over both views, then
    the stereo voxel sampler (JAX vernier.py:89)."""

    def __init__(self, cfg: VernierConfig):
        super().__init__()
        if cfg.feature_aggregation != "concat":
            raise NotImplementedError(cfg.feature_aggregation)
        self.cfg = cfg
        self.HRNet_0 = HRNet(cfg.backbone)

    def forward(self, left_roi, right_roi, grid_proj_left, grid_proj_right):
        dt = compute_dtype(self.cfg.compute_dtype)
        n = left_roi.shape[0]
        both = torch.cat([left_roi.to(dt), right_roi.to(dt)], dim=0)
        feats = self.HRNet_0(both).contiguous()
        return stereo_voxel_sample(
            feats[:n], feats[n:], grid_proj_left.float().contiguous(),
            grid_proj_right.float().contiguous(), self.cfg.resolution,
            self.cfg.grid_resolution)


class VernierHead(nn.Module):
    """Voxel -> NCF / occupancy / coordinates, ``BEV_type3``
    (JAX vernier.py:149, ``_head_bev_type23``)."""

    def __init__(self, cfg: VernierConfig, voxel_channels: int):
        super().__init__()
        if cfg.vernier_type != "BEV_type3":
            raise NotImplementedError(
                f"vernier_type {cfg.vernier_type!r} is not ported")
        self.cfg = cfg
        nh, nw, nl = cfg.grid_resolution
        two_dim = voxel_channels
        dim = two_dim // 2
        g, gn = cfg.gn_groups, cfg.gn
        self.ConvNorm3d_0 = ConvNorm3d(two_dim, dim, 1, 1, 1, gn, g)  # vimg
        self.ConvNorm3d_1 = ConvNorm3d(two_dim, dim, 7, 1, 1, gn, g)  # conv1_k7
        self.ConvNorm3d_2 = ConvNorm3d(dim, dim, 5, 1, 1, gn, g)  # conv2_k5
        self.ConvNorm3d_3 = ConvNorm3d(dim, dim, 5, 1, 2, gn, g)  # conv3_k5_d2
        # hourglass choice by grid width (JAX _hg3d/_hg2d); the JAX model's
        # nn.remat renames the 3D one "Checkpoint<cls>_0", and the 2D one
        # then takes index 0 of its own class
        deep = cfg.n_sample_w > 16
        cls = HourglassDeep if deep else Hourglass
        hg3 = cls.__name__ + "_0"
        if cfg.remat:
            hg3, hg2 = "Checkpoint" + hg3, cls.__name__ + "_0"
        else:
            hg2 = cls.__name__ + "_1"
        self.add_module(hg3, cls(dim, ndim=3, gn=gn))
        self.ConvNorm3d_4 = ConvNorm3d(dim, dim, 3, 1, 1, gn, g)  # occupancy
        self.Conv3d_0 = Conv3d(dim, 1, (3, 3, 3))
        k = 5
        if cfg.use_part_reg_head:
            self.ConvNorm3d_5 = ConvNorm3d(dim, dim, 3, 1, 1, gn, g)
            self.Conv3d_1 = Conv3d(dim, 27, (1, 1, 1))
            k = 6
        self.add_module(f"ConvNorm3d_{k}",
                        ConvNorm3d(2 * dim, dim, 3, 1, 1, gn, g))
        self.ConvNorm_0 = ConvNorm((nh // 4) * dim, 64, 3, gn=gn, groups=g)
        self.add_module(hg2, cls(64, ndim=2, gn=gn))
        self.Conv_0 = nn.Conv2d(64, cfg.num_parts, 3, padding=1, bias=False)
        self.CoordHead_0 = CoordHead(cfg.num_parts, nl, nw)
        if cfg.use_bbox_head:
            self.FCModel_0 = FCModel(cfg.num_parts * 2, num_neurons=128,
                                     num_blocks=1, output_size=5)
        # child names, looked up at call time (an attribute holding the
        # module itself would register it twice)
        self._hg3, self._hg2, self._post = hg3, hg2, f"ConvNorm3d_{k}"

    def forward(self, voxel) -> Dict[str, Optional[torch.Tensor]]:
        cfg = self.cfg
        vimg = F.relu(self.ConvNorm3d_0(voxel))
        x = F.relu(self.ConvNorm3d_1(voxel))
        x = F.relu(self.ConvNorm3d_2(x)) + x
        x = F.relu(self.ConvNorm3d_3(x)) + x
        hg3 = getattr(self, self._hg3)
        if isinstance(hg3, HourglassDeep):
            run_hg3 = hg3
        else:
            def run_hg3(t):
                return hg3(t, None, None)[0]
        if cfg.remat and self.training and torch.is_grad_enabled():
            # the recompute must not move BatchNorm's running statistics
            x = checkpoint(run_hg3, x, use_reentrant=False,
                           context_fn=lambda: (contextlib.nullcontext(),
                                               frozen_batch_stats(hg3))) + x
        else:
            x = run_hg3(x) + x

        occ = F.relu(self.ConvNorm3d_4(x))
        occ = torch.sigmoid(self.Conv3d_0(occ))  # [N, nh, nw, nl, 1]
        occupancy = occ[..., 0]
        offset = None
        if cfg.use_part_reg_head:
            off = self.Conv3d_1(F.relu(self.ConvNorm3d_5(x)))
            offset = off.movedim(-1, 1)

        x = torch.cat([x, vimg * occ], dim=-1)
        x = F.relu(getattr(self, self._post)(x))
        x = avg_pool_height(x, 4)
        N, H, W, L, C = x.shape
        bev = x.permute(0, 2, 3, 1, 4).reshape(N, W, L, H * C)
        bev = F.relu(self.ConvNorm_0(bev))
        hg2 = getattr(self, self._hg2)
        if isinstance(hg2, HourglassDeep):
            hm = hg2(bev)
        else:
            hm = hg2(bev, None, None)[0]
        hm = hm.permute(0, 2, 1, 3)  # [N, L, W, 64]
        ncf_maps = conv2d_nhwc(hm, self.Conv_0)  # [N, nl, nw, P]
        ncf = ncf_maps.movedim(-1, 1)

        aug = torch.cat([ncf_maps, _coord_maps(N, ncf_maps.shape[1],
                                               ncf_maps.shape[2],
                                               ncf_maps.dtype, x.device)],
                        dim=-1)
        coordinates = self.CoordHead_0(aug)
        bbox = None
        if cfg.use_bbox_head:
            bbox = self.FCModel_0(coordinates.reshape(N, cfg.num_parts * 2))
        out = dict(ncf=ncf, occupancy=occupancy, offset=offset,
                   coordinates=coordinates, bbox=bbox)
        return {k: (v.float() if v is not None else None)
                for k, v in out.items()}


class VernierScale(nn.Module):
    """Encoder + head (JAX VernierScale).  ``device`` defaults to "cuda" and
    raises without a GPU; ``generator`` seeds the weights."""

    def __init__(self, cfg: VernierConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.encoder = VernierEncoder(cfg)
        self.head = VernierHead(cfg, 2 * cfg.backbone.output_channel)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights(self, generator)
        self.to(dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward(self, left_roi, right_roi, grid_proj_left, grid_proj_right):
        voxel = self.encoder(left_roi, right_roi, grid_proj_left,
                             grid_proj_right)
        return self.head(voxel)
