"""Plain float32 reference of one refinement request.

A frozen copy of the serving path of ``snvc_tpu_torch`` (``inference/
refine.py``: ``assemble_instances`` -> ``VernierEncoder`` ->
``VernierHead`` -> ``ncf_to_update``) for the ``BEV_type2`` /
``BEV_type3`` heads with ``concat`` aggregation, written with library
calls: ``F.grid_sample`` samples the stereo voxel (the program's kernel
K1), ``F.conv3d`` runs the large-tap convs (the program's kernel K2).
It reads the configuration as a plain dict (the ``vernier`` entry of a
``portbench/configs`` file) and imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.layers import (
    BasicBlock,
    Conv2d,
    Conv3d,
    ConvNorm,
    ConvNorm3d,
    Hourglass,
    HourglassDeep,
    HRNet,
    avg_pool_height,
)

# HRNet stages: (num_modules, num_branches, block, num_blocks, channels)
_STAGES = {
    "hrnet-w48": ((1, 1, "bottleneck", (4,), (64,)),
                  (1, 2, "basic", (4, 4), (48, 96)),
                  (4, 3, "basic", (4, 4, 4), (48, 96, 192)),
                  (3, 4, "basic", (4, 4, 4, 4), (48, 96, 192, 384))),
    "hrnet-w32": ((1, 1, "bottleneck", (4,), (64,)),
                  (1, 2, "basic", (4, 4), (32, 64)),
                  (4, 3, "basic", (4, 4, 4), (32, 64, 128)),
                  (3, 4, "basic", (4, 4, 4, 4), (32, 64, 128, 256))),
    "hrnet-tiny": ((1, 1, "bottleneck", (1,), (16,)),
                   (1, 2, "basic", (1, 1), (8, 16)),
                   (1, 3, "basic", (1, 1, 1), (8, 16, 32)),
                   (1, 4, "basic", (1, 1, 1, 1), (8, 16, 32, 64))),
}

PART_X = (0.0, 0.5, 0.5, 0.5, 0.5, -0.5, -0.5, -0.5, -0.5)
PART_Z = (0.0, 0.5, 0.5, -0.5, -0.5, 0.5, 0.5, -0.5, -0.5)


def stages(name):
    keys = ("num_modules", "num_branches", "block", "num_blocks",
            "num_channels")
    return [dict(zip(keys, s)) for s in _STAGES[name]]


def check_supported(cfg: Dict) -> None:
    if cfg["vernier_type"] not in ("BEV_type2", "BEV_type3"):
        raise NotImplementedError(cfg["vernier_type"])
    for key, want in (("feature_aggregation", "concat"),
                      ("use_bbox_head", False), ("use_part_reg_head", False)):
        if cfg.get(key, want) != want:
            raise NotImplementedError(f"{key}={cfg[key]!r}")
    if cfg["backbone"].get("add_xy", False):
        raise NotImplementedError("add_xy")


class CoordHead(nn.Module):
    def __init__(self, P, nl, nw):
        super().__init__()
        ch = P * 2
        self.P = P
        blocks = [BasicBlock(P + 2, ch, stride=2)]
        h, w = (nl + 1) // 2, (nw + 1) // 2
        while h > 6:
            blocks.append(BasicBlock(ch, ch, stride=2))
            h, w = (h + 1) // 2, (w + 1) // 2
        for i, b in enumerate(blocks):
            self.add_module(f"BasicBlock_{i}", b)
        self.n = len(blocks)
        self.Conv_0 = Conv2d(ch, ch, (h, w), bias=True)

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"BasicBlock_{i}")(x)
        x = torch.sigmoid(self.Conv_0(x))
        return x.reshape(x.shape[0], self.P, 2)


class Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.HRNet_0 = HRNet(stages(cfg["backbone"]["name"]))

    def forward(self, left, right, gpl, gpr):
        n = left.shape[0]
        feats = self.HRNet_0(torch.cat([left, right]).float())
        H, W = self.cfg["resolution"]
        nh, nw, nl = self.cfg["grid_resolution"]
        scale = torch.tensor([2.0 / W, 2.0 / H], device=left.device)
        views = []
        for f, g in ((feats[:n], gpl), (feats[n:], gpr)):
            grid = (g.float() * scale - 1.0)[:, None]  # [N, 1, P, 2]
            s = F.grid_sample(f.permute(0, 3, 1, 2), grid, mode="bilinear",
                              padding_mode="zeros", align_corners=False)
            views.append(s[:, :, 0].permute(0, 2, 1))  # [N, P, C]
        vox = torch.cat(views, dim=-1)
        return vox.reshape(n, nh, nw, nl, vox.shape[-1])


class Head(nn.Module):
    """The ``BEV_type2`` / ``BEV_type3`` head (no offset, no bbox head)."""

    def __init__(self, cfg, two_dim):
        super().__init__()
        nh, nw, nl = cfg["grid_resolution"]
        dim = two_dim // 2
        g, gn = cfg["gn_groups"], cfg["gn"]
        self.with_coords = cfg["vernier_type"] == "BEV_type3"
        self.ConvNorm3d_0 = ConvNorm3d(two_dim, dim, 1, 1, 1, gn, g)
        self.ConvNorm3d_1 = ConvNorm3d(two_dim, dim, 7, 1, 1, gn, g)
        self.ConvNorm3d_2 = ConvNorm3d(dim, dim, 5, 1, 1, gn, g)
        self.ConvNorm3d_3 = ConvNorm3d(dim, dim, 5, 1, 2, gn, g)
        self.deep = nw > 16
        cls = HourglassDeep if self.deep else Hourglass
        hg3 = cls.__name__ + "_0"
        if cfg["remat"]:
            hg3, hg2 = "Checkpoint" + hg3, cls.__name__ + "_0"
        else:
            hg2 = cls.__name__ + "_1"
        self.add_module(hg3, cls(dim, ndim=3, gn=gn))
        self.ConvNorm3d_4 = ConvNorm3d(dim, dim, 3, 1, 1, gn, g)
        self.Conv3d_0 = Conv3d(dim, 1, 3)
        self.ConvNorm3d_5 = ConvNorm3d(2 * dim, dim, 3, 1, 1, gn, g)
        self.ConvNorm_0 = ConvNorm((nh // 4) * dim, 64, 3, gn=gn, groups=g)
        self.add_module(hg2, cls(64, ndim=2, gn=gn))
        self.Conv_0 = Conv2d(64, cfg["num_parts"], 3, pad=1)
        if self.with_coords:
            self.CoordHead_0 = CoordHead(cfg["num_parts"], nl, nw)
        self.hg3, self.hg2 = hg3, hg2

    def _hourglass(self, name, x):
        hg = getattr(self, name)
        return hg(x) if self.deep else hg(x)[0]

    def forward(self, voxel) -> Dict[str, torch.Tensor]:
        vimg = F.relu(self.ConvNorm3d_0(voxel))
        x = F.relu(self.ConvNorm3d_1(voxel))
        x = F.relu(self.ConvNorm3d_2(x)) + x
        x = F.relu(self.ConvNorm3d_3(x)) + x
        x = self._hourglass(self.hg3, x) + x
        occ = torch.sigmoid(self.Conv3d_0(F.relu(self.ConvNorm3d_4(x))))
        x = torch.cat([x, vimg * occ], dim=-1)
        x = avg_pool_height(F.relu(self.ConvNorm3d_5(x)), 4)
        N, H, W, L, C = x.shape
        bev = F.relu(self.ConvNorm_0(
            x.permute(0, 2, 3, 1, 4).reshape(N, W, L, H * C)))
        hm = self._hourglass(self.hg2, bev).permute(0, 2, 1, 3)
        ncf_maps = self.Conv_0(hm)  # [N, nl, nw, P]
        out = dict(ncf=ncf_maps.movedim(-1, 1), occupancy=occ[..., 0])
        if self.with_coords:
            nl, nw = ncf_maps.shape[1:3]
            dev = ncf_maps.device
            xm = torch.linspace(0.0, 1.0, nw, device=dev)[None].expand(nl, nw)
            zm = torch.linspace(0.0, 1.0, nl, device=dev)[:, None].expand(
                nl, nw)
            maps = torch.stack([xm, zm], -1)[None].expand(N, nl, nw, 2)
            out["coordinates"] = self.CoordHead_0(
                torch.cat([ncf_maps, maps], dim=-1))
        return out


class VernierScale(nn.Module):
    """Encoder + head, with the program's child names."""

    def __init__(self, cfg):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        c = _STAGES[cfg["backbone"]["name"]][1][4][0]
        self.head = Head(cfg, 2 * c)


# --- inputs -> model inputs (assembly) ----------------------------------


def grid_local(cfg) -> torch.Tensor:
    """Object-frame grid [nh*nw*nl, 3] (x = w, y = h, z = l), h-major."""
    nh, nw, nl = cfg["grid_resolution"]
    ys = np.linspace(*cfg["y_range"], nh)
    xs = np.linspace(*cfg["x_range"], nw)
    zs = np.linspace(*cfg["z_range"], nl)
    gy, gx, gz = np.meshgrid(ys, xs, zs, indexing="ij")
    g = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32)
    return torch.from_numpy(g)


def _project(samples, P, trans, grid):
    ry = samples[:, 6:7] + 0.5 * math.pi
    c, s = torch.cos(ry), torch.sin(ry)
    gx, gy, gz = (grid[None, :, i] for i in range(3))
    cam = torch.stack([gx * c + gz * s + samples[:, 3:4],
                       gy + (samples[:, 4:5] - 0.5 * samples[:, 0:1]),
                       -gx * s + gz * c + samples[:, 5:6]], dim=-1)
    uvw = cam @ P[:, :, :3].transpose(1, 2) + P[:, None, :, 3]
    uv = uvw[..., :2] / uvw[..., 2:3]
    return uv @ trans[:, :, :2].transpose(1, 2) + trans[:, None, :, 2]


def _roi(images, trans, out_hw):
    """Bilinear crop (cv2.warpAffine INTER_LINEAR, zero border) of each
    image by its diagonal source->ROI affine."""
    N, H, W, _ = images.shape
    oh, ow = out_hw
    a, tx = trans[:, 0, 0], trans[:, 0, 2]
    e, ty = trans[:, 1, 1], trans[:, 1, 2]
    dev = images.device
    sx = (torch.arange(ow, device=dev)[None] - tx[:, None]) / a[:, None]
    sy = (torch.arange(oh, device=dev)[None] - ty[:, None]) / e[:, None]
    Ax = (1 - (sx[..., None] - torch.arange(W, device=dev)).abs()).clamp_min(0)
    Ay = (1 - (sy[..., None] - torch.arange(H, device=dev)).abs()).clamp_min(0)
    return torch.einsum("npw,nowc->nopc", Ax,
                        torch.einsum("noh,nhwc->nowc", Ay, images))


def assemble(cfg, req, grid):
    """(left ROIs, right ROIs, left projections, right projections) of a
    request (tensors on one device)."""
    idx = req["image_idx"].long()
    mean = torch.tensor(cfg["img_mean"], device=grid.device)
    std = torch.tensor(cfg["img_std"], device=grid.device)
    out = []
    for k in ("left", "right"):
        imgs = req[f"images_{k}"][idx].float() / 255.0
        out.append((_roi(imgs, req[f"trans_{k[0]}"].float(),
                         cfg["resolution"]) - mean) / std)
    for k in ("left", "right"):
        out.append(_project(req["samples"].float(),
                            req[f"P_{k}"][idx].float(),
                            req[f"trans_{k[0]}"].float(), grid))
    return out


# --- head outputs -> refined boxes --------------------------------------


def _rigid(src, dst, w):
    """Weighted 2D rigid fit of dst [N, 2, P] to src; (R [N, 2, 2], t)."""
    xs = src - src.mean(-1, keepdim=True)
    xd = dst - dst.mean(-1, keepdim=True)
    a = (w * (xs[:, 0] * xd[:, 0] + xs[:, 1] * xd[:, 1])).sum(-1)
    b = (w * (xs[:, 0] * xd[:, 1] - xs[:, 1] * xd[:, 0])).sum(-1)
    th = torch.atan2(b, a)
    c, s = torch.cos(th), torch.sin(th)
    R = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)
    t = dst.mean(-1, keepdim=True) - R @ src.mean(-1, keepdim=True)
    return R, t


def finalize(cfg, out, samples) -> Dict[str, torch.Tensor]:
    """``ncf_to_update`` under ``ncf_decode="coordinates"``: the refined
    boxes (one_part, all_parts), confidence and keep."""
    ncf = out["ncf"]
    N, P = ncf.shape[:2]
    flat = ncf.reshape(N, P, -1)
    confidence = flat.max(-1).values
    keep = ((flat >= cfg["filter_min"]) & (flat <= cfg["filter_max"])
            ).all(2).all(1)
    (x0, x1), (z0, z1) = cfg["x_range"], cfg["z_range"]
    coords = out["coordinates"]
    off_x = x0 + coords[..., 0] * (x1 - x0)
    off_z = z0 + coords[..., 1] * (z1 - z0)
    h, w, l, ry = samples[:, 0], samples[:, 1], samples[:, 2], samples[:, 6]
    c, s = torch.cos(ry)[:, None], torch.sin(ry)[:, None]
    cx, cz = samples[:, 3:4], samples[:, 5:6]
    cam_x = -off_x * s + off_z * c
    cam_z = -off_x * c - off_z * s
    one = samples.clone()
    one[:, 3] = samples[:, 3] + cam_x[:, 0]
    one[:, 5] = samples[:, 5] + cam_z[:, 0]
    dev = ncf.device
    sx = torch.tensor(PART_X[:P], device=dev)[None] * l[:, None]
    sz = torch.tensor(PART_Z[:P], device=dev)[None] * w[:, None]
    src = torch.stack([sx * c + sz * s + cx, -sx * s + sz * c + cz], 1)
    dst = torch.stack([cx + cam_x, cz + cam_z], 1)
    R, t = _rigid(src, dst, confidence)
    moved = R @ src + t
    Rc, _ = _rigid(torch.stack([sx, sz], 1), moved, torch.ones_like(sx))
    allp = samples.clone()
    allp[:, 3] = moved[:, 0, 0]
    allp[:, 5] = moved[:, 1, 0]
    allp[:, 6] = -torch.atan2(Rc[:, 1, 0], Rc[:, 0, 0])
    k = keep[:, None]
    return dict(one_part=torch.where(k, one, samples),
                all_parts=torch.where(k, allp, samples),
                confidence=confidence, keep=keep)


def refine(model: VernierScale, req, grid, block: int = 1):
    """The reference outputs of a request's instances, ``block`` at a
    time: ncf, occupancy, coordinates and finalize's outputs (float32)."""
    cfg = model.cfg
    left, right, gpl, gpr = assemble(cfg, req, grid)
    parts = []
    for a in range(0, left.shape[0], block):
        sl = slice(a, a + block)
        with torch.no_grad():
            o = model.head(model.encoder(left[sl], right[sl], gpl[sl],
                                         gpr[sl]))
            o.update(finalize(cfg, o, req["samples"][sl].float()))
        parts.append({k: v.cpu() for k, v in o.items()})
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
