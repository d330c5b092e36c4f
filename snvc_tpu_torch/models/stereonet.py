"""Global main-scale stereo detector ``StereoNet`` (port of
snvc_tpu/models/stereonet.py), for serving and training.

  stereo pair -> StereoEncoder (one StereoFeatureNet shared by both views)
              -> plane-sweep cost volume over the depth hypotheses (K3)
              -> 3D conv stack + hourglasses -> softmax depth expectation
              -> frustum -> BEV voxel resample (K4)
              -> BEV conv head (+ the RPN image feature projected to BEV)
              -> cls / reg / centerness maps.

Layouts as in JAX: images NHWC, cost volume [N, D, H/4, W/4, 2C], voxels
[N, nz, nx, ny, C] collapsed to BEV channels-last [N, nz, nx, ny*C].
Children carry the Flax names (``encoder``, ``head``,
``StereoFeatureNet_0``, ``ConvNorm3d_i``, ``Hourglass_i``, ``Conv3d_i``,
``ConvNorm_i``, ``Conv_i``), so JAX variables load by path.

The K4 resample assumes a rectified projection (P[:, 2, :2] == 0, true of
every KITTI P2/P3); the caller checks its host copy
(``data/stereo.check_stereo_projections``).  K3 and K4 carry gradients to
the encoder and the 3D stack; in train mode (``model.train()``) the
BatchNorm stem of the backbones whose first width is below 32 normalizes
with batch statistics and moves its running averages, as flax's does.

Under ``layers.tensor_parallel`` with a mesh of ``n_model > 1`` the head
splits the volume on its depth axis D as JAX's ``volume_sharding``
(``P("data", "model")``) does: K3 builds this position's planes (whole
units of 4 planes, the hourglass's 2^levels, spread as
``np.array_split`` spreads them: 24 / 20 / 20 of 64 over three, 4 / 4 /
0 of 8 over three; see parallel/tensor.py.  D is a multiple of 4, as in
JAX, so no stereo slab is short; a position beyond D's units holds no
plane, launches no K3, and adds -inf to the softmax's maximum and
zeros to its sums), the 3D stack and the hourglasses run on the slab
(halo exchanges along D), the depth softmax and its expectations reduce over the model group
(the shift is the group's maximum), ``depth_prob`` and the per-plane
outputs come back whole, and the post-stack volume is gathered once for
K4 (JAX's sharded path takes its XLA resample there: the same numbers).
The BEV head runs whole on every model position.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from snvc_tpu_torch.config import StereoConfig
from snvc_tpu_torch.models.layers import (
    Conv3d,
    ConvNorm,
    ConvNorm3d,
    Hourglass,
    conv2d_nhwc,
    init_weights,
)
from snvc_tpu_torch.models.stereo_backbone import _VARIANTS, StereoFeatureNet
from snvc_tpu_torch.ops.cost_volume import plane_sweep_volume_k3
from snvc_tpu_torch.ops.frustum import _hat, frustum_tables, frustum_to_voxel_k4
from snvc_tpu_torch.parallel.tensor import (
    gather,
    model_max,
    model_sum,
    slab_amax,
    split_range,
)
from snvc_tpu_torch.utils.device import compute_dtype, resolve_device


def depth_hypotheses(cfg: StereoConfig) -> np.ndarray:
    """Uniform depth planes in [min_depth, max_depth], float32."""
    return np.linspace(cfg.min_depth, cfg.max_depth, cfg.num_depths).astype(
        np.float32)


def _bev_axes(cfg: StereoConfig):
    """BEV cell centers (zs, xs, ys) in float64."""
    nz, nx = cfg.bev_size
    zs = cfg.z_min + (np.arange(nz) + 0.5) * cfg.voxel_z
    xs = cfg.x_min + (np.arange(nx) + 0.5) * cfg.voxel_x
    ys = cfg.y_min + (np.arange(cfg.ny) + 0.5) * cfg.voxel_y
    return zs, xs, ys


def voxel_grid_centers(cfg: StereoConfig) -> np.ndarray:
    """Rect-frame voxel centers [Z*X*Y, 3], BEV-major (z, x, y) ravel."""
    zs, xs, ys = _bev_axes(cfg)
    gz, gx, gy = np.meshgrid(zs, xs, ys, indexing="ij")
    return np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32)


def bev_locations(cfg: StereoConfig) -> np.ndarray:
    """BEV anchor locations [Z*X, 2] (x, z)."""
    zs, xs, _ = _bev_axes(cfg)
    gz, gx = np.meshgrid(zs, xs, indexing="ij")
    return np.stack([gx, gz], axis=-1).reshape(-1, 2).astype(np.float32)


def plane_shifts(P_left, P_right, depths):
    """Per-sample disparity of each depth plane in feature pixels, [N, D]
    float32: f * B / z / 4, with the baseline B = b_x(right) - b_x(left)
    and b_x = P[0, 3] / (-f)."""
    Pl, Pr = P_left.float(), P_right.float()
    fu = Pl[:, 0, 0]
    baseline = Pr[:, 0, 3] / (-Pr[:, 0, 0]) - Pl[:, 0, 3] / (-Pl[:, 0, 0])
    return ((fu[:, None] * baseline[:, None] / depths[None, :]) / 4.0
            ).contiguous()


class StereoEncoder(nn.Module):
    """One ``StereoFeatureNet`` over both views -> (lf, rf, rpn_img)."""

    def __init__(self, cfg: StereoConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = compute_dtype(cfg.compute_dtype)
        self.StereoFeatureNet_0 = StereoFeatureNet(
            backbone=cfg.backbone, gn=cfg.gn, branch=cfg.branch,
            plane_sweep=cfg.plane_sweep_volume,
            rpn_feature=cfg.rpn3d_enable and cfg.cat_img_feature,
            rpn_convdim=cfg.rpn_convdim)

    def forward(self, left, right):
        net = self.StereoFeatureNet_0
        lf, rpn_img = net(left.to(self.dtype))
        rf, _ = net(right.to(self.dtype))
        return lf, rf, rpn_img


def frustum_img_to_bev(img_feat, P_mat, cfg: StereoConfig):
    """Sample the RPN image feature [N, Hf, Wf, C] at each BEV cell's
    anchor-height point (bilinear, zeros outside) -> [N, nz, nx, C].

    For a rectified P the image row depends on the BEV row only and the
    column on (row, x), so the sample is two hat-weight einsums in
    float32.  The cell centers are made in float32 on the feature's
    device, as the JAX function makes them in numpy float32."""
    nz, nx = cfg.bev_size
    dev = img_feat.device
    zs = cfg.z_min + (torch.arange(nz, dtype=torch.float32, device=dev)
                      + 0.5) * cfg.voxel_z
    xs = cfg.x_min + (torch.arange(nx, dtype=torch.float32, device=dev)
                      + 0.5) * cfg.voxel_x
    y = float(cfg.anchors_y[0])
    out = []
    for f, P in zip(img_feat, P_mat.float()):
        Hf, Wf = f.shape[0], f.shape[1]
        w = zs + P[2, 3]
        u = (P[0, 0] * xs[None, :] + P[0, 2] * zs[:, None] + P[0, 3]) \
            / w[:, None] / 4.0
        v = (P[1, 1] * y + P[1, 2] * zs + P[1, 3]) / w / 4.0
        t = torch.einsum("zh,hwc->zwc", _hat(v, Hf), f.float())
        out.append(torch.einsum("zxw,zwc->zxc", _hat(u, Wf), t).to(f.dtype))
    return torch.stack(out)


class StereoHead(nn.Module):
    """Cost volume -> 3D stack -> depth regression + BEV RPN head.  The 3D
    stack splits the volume's depth axis (1) under a model axis (see the
    module docstring)."""

    split_axis = 1
    unit = 2 ** Hourglass.levels  # of the depth slabs under a model axis

    def __init__(self, cfg: StereoConfig):
        super().__init__()
        nz, nx = cfg.bev_size
        for name, v in (("num_depths", cfg.num_depths),
                        ("BEV nz ((z_max-z_min)/voxel_z)", nz),
                        ("BEV nx ((x_max-x_min)/voxel_x)", nx)):
            _check_div4(name, v)
        self.cfg = cfg
        self.dtype = compute_dtype(cfg.compute_dtype)
        self.tp_mesh = None  # see layers.tensor_parallel
        cv = _VARIANTS[cfg.backbone][4][1]  # cost-volume feature channels
        g = 32
        d = self.split_axis
        self.ConvNorm3d_0 = ConvNorm3d(2 * cv, 32, 3, gn=cfg.gn, groups=g,
                                       split_axis=d)
        self.ConvNorm3d_1 = ConvNorm3d(32, 32, 3, gn=cfg.gn, groups=g,
                                       split_axis=d)
        nh = max(1, cfg.num_hourglasses)
        for i in range(nh):
            self.add_module(f"Hourglass_{i}",
                            Hourglass(32, 3, cfg.gn, split_axis=d))
            self.add_module(f"Conv3d_{i}",
                            Conv3d(32, 1, (3, 3, 3), split_axis=d))
        self._n_hg = nh
        if cfg.depth_offset:
            self.add_module(f"Conv3d_{nh}",
                            Conv3d(32, 1, (3, 3, 3), split_axis=d))
        depths = depth_hypotheses(cfg)
        self.register_buffer("depths", torch.from_numpy(depths),
                             persistent=False)
        if cfg.rpn3d_enable:
            zs, xs, ys = _bev_axes(cfg)
            d0, fd = frustum_tables(depths, zs)
            for name, a in (("bev_d0", d0), ("bev_fd", fd),
                            ("bev_zs", zs.astype(np.float32)),
                            ("bev_xs", xs.astype(np.float32)),
                            ("bev_ys", ys.astype(np.float32))):
                self.register_buffer(name, torch.from_numpy(a),
                                     persistent=False)
            self.ConvNorm_0 = ConvNorm(cfg.ny * 32, 64, 3, gn=cfg.gn,
                                       groups=g)
            self.cat_img = cfg.cat_img_feature
            if self.cat_img:
                self.ConvNorm_1 = ConvNorm(64 + cfg.rpn_convdim, 64, 3,
                                           gn=cfg.gn, groups=g)
            self.add_module(f"Hourglass_{nh}", Hourglass(64, 2, cfg.gn))
            A, K = cfg.num_angles, cfg.num_classes
            self.Conv_0 = nn.Conv2d(64, A * K, 3, padding=1)
            self.Conv_1 = nn.Conv2d(64, A * K * 24, 3, padding=1)
            self.Conv_2 = nn.Conv2d(64, A, 3, padding=1)

    def forward(self, lf, rf, rpn_img, P_left, P_right) -> Dict:
        cfg = self.cfg
        for name, v in (("feature height (input_size[0]/4)", lf.shape[1]),
                        ("feature width (input_size[1]/4)", lf.shape[2])):
            _check_div4(name, v)
        Pl = P_left.float()
        shifts = plane_shifts(Pl, P_right, self.depths)
        mesh = self.tp_mesh
        levels = None
        if mesh is not None:
            d0, d1 = split_range(cfg.num_depths, mesh, self.unit)
            shifts, levels = shifts[:, d0:d1].contiguous(), self.depths[d0:d1]
        vol = plane_sweep_volume_k3(lf.contiguous(), rf.contiguous(), shifts)
        vols = self.stack3d(vol)
        out = self.depth_head(vols, levels)
        if cfg.rpn3d_enable:
            vol = vols[-1]
            if mesh is not None:
                vol = gather(vol, 1, mesh, cfg.num_depths, self.unit)
            out.update(self.bev_head(self.frustum(vol, Pl), rpn_img, Pl))
        return out

    # the stages of forward, also timed one by one by
    # tools/profile_stereo.py
    def stack3d(self, vol) -> List[torch.Tensor]:
        """Cost volume -> two ConvNorm3d, then each hourglass on the last
        output: the outputs (base + hourglass), one a hourglass."""
        base = F.relu(self.ConvNorm3d_0(vol))
        base = F.relu(self.ConvNorm3d_1(base))
        vols, vol_i, pre1, post1 = [], base, None, None
        for i in range(self._n_hg):
            hg = getattr(self, f"Hourglass_{i}")
            hg_out, pre_i, post_i = hg(vol_i, pre1, post1)
            if i == 0:
                pre1, post1 = pre_i, post_i
            vol_i = base + hg_out
            vols.append(vol_i)
        return vols

    def depth_head(self, vols, levels=None) -> Dict:
        """The stack's outputs -> depth: each output's k3 Conv3d cost
        (summed over the hourglasses so far), the optional depth offset,
        the softmax expectation over the planes (``levels``: this rank's
        planes under a model axis)."""
        cfg = self.cfg
        mesh = self.tp_mesh
        depths = self.depths
        if levels is None:
            levels = depths
        cost, costs = None, []
        for i, v in enumerate(vols):
            c = getattr(self, f"Conv3d_{i}")(v)[..., 0].float()
            cost = c if cost is None else cost + c  # [N, D, Hf, Wf]
            costs.append(cost)
        depth_offset = None
        if cfg.depth_offset:
            depth_offset = getattr(self, f"Conv3d_{self._n_hg}")(vols[-1])[
                ..., 0].float()

        def expectation(c, off=None):
            lvl = levels[None, :, None, None]
            if off is not None:
                lvl = lvl + off
            if mesh is None:
                p = torch.softmax(c, dim=1)
                return p, (p * lvl).sum(dim=1)
            # the softmax over every rank's planes
            e = torch.exp(c - model_max(slab_amax(c, 1), mesh))
            p = e / model_sum(e.sum(1, keepdim=True), mesh)
            return p, model_sum((p * lvl).sum(dim=1), mesh)

        prob, depth = expectation(cost, depth_offset)
        if mesh is not None:
            prob = gather(prob, 1, mesh, cfg.num_depths, self.unit)
            if depth_offset is not None:
                depth_offset = gather(depth_offset, 1, mesh, cfg.num_depths,
                                      self.unit)
        out = {"depth": depth, "depth_prob": prob, "depth_levels": depths}
        if depth_offset is not None:
            out["depth_offset"] = depth_offset
        out["depth_preds"] = tuple(
            expectation(c)[1] for c in costs[:-1]) + (depth,)
        return out

    def frustum(self, vol, Pl) -> torch.Tensor:
        """The whole volume [N, D, Hf, Wf, 32] -> BEV voxels (K4)."""
        return frustum_to_voxel_k4(
            vol.contiguous(), Pl.contiguous(), self.bev_d0, self.bev_fd,
            self.bev_zs, self.bev_xs, self.bev_ys, 4)

    def bev_head(self, voxels, rpn_img, Pl) -> Dict:
        """BEV voxels -> ConvNorm, the RPN image feature sampled to the BEV
        cells and joined, ConvNorm, 2D hourglass + residual, the cls / reg
        / centerness convs (float32)."""
        cfg = self.cfg
        nz, nx = cfg.bev_size
        C = voxels.shape[-1]
        bev = voxels.reshape(-1, nz, nx, cfg.ny * C).to(self.dtype)
        bev = F.relu(self.ConvNorm_0(bev))
        if self.cat_img and rpn_img is not None:
            img_bev = frustum_img_to_bev(rpn_img, Pl, cfg)
            bev = torch.cat([bev, img_bev.to(self.dtype)], dim=-1)
            bev = F.relu(self.ConvNorm_1(bev))
        hg2, _, _ = getattr(self, f"Hourglass_{self._n_hg}")(bev)
        bev = bev + hg2
        return {"cls": conv2d_nhwc(bev, self.Conv_0).float(),
                "reg": conv2d_nhwc(bev, self.Conv_1).float(),
                "centerness": conv2d_nhwc(bev, self.Conv_2).float()}


def _check_div4(name: str, v: int) -> None:
    """The two-level hourglasses (stride-2 down twice, deconv up twice)
    round-trip only sizes divisible by 4."""
    if v % 4 != 0:
        raise ValueError(
            f"StereoConfig: {name} = {v} must be divisible by 4 "
            "(two-level hourglass down/up round-trip)")


class StereoNet(nn.Module):
    """Encoder + head (JAX StereoNet).  ``device`` defaults to "cuda" and
    raises without a GPU; ``generator`` seeds the weights.

    forward(left, right, P_left, P_right): left/right [N, H, W, 3]
    normalized images, P_* [N, 3, 4].  Returns depth [N, H/4, W/4],
    depth_prob [N, D, H/4, W/4], cls [N, Z, X, A*K], reg [N, Z, X, A*K*24],
    centerness [N, Z, X, A] (float32), and depth_levels / depth_preds."""

    def __init__(self, cfg: StereoConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.encoder = StereoEncoder(cfg)
        self.head = StereoHead(cfg)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights(self, generator)
        self.to(dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward(self, left, right, P_left, P_right):
        lf, rf, rpn_img = self.encoder(left, right)
        return self.head(lf, rf, rpn_img, P_left, P_right)
