"""Plain float32 reference of one detection request.

A frozen copy of the serving path of ``snvc_tpu_torch`` (``inference/
detect.py``: ``StereoEncoder`` -> ``StereoHead`` -> ``decode_proposals``)
written with library calls: the plane-sweep volume (the program's
kernel K3) as an index gather, the frustum resample (kernel K4) as a
depth lerp and two hat-weight einsums.  The right view's RPN feature,
which the program computes and drops, is not computed.  It reads the
configuration as a plain dict (the ``stereo`` entry of a
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
    Conv2d,
    Conv3d,
    ConvNorm,
    ConvNorm3d,
    Hourglass,
    ResBlock2d,
)

# name: (first_dim, dims, blocks, branch_dim, lastconv_dims)
_VARIANTS = {
    "reslike-det-small": (64, (32, 64, 128, 192), (3, 6, 12, 4), 32,
                          (256, 32)),
    "reslike50-det-tiny": (8, (16, 32, 64, 128), (3, 4, 6, 3), 32,
                           (128, 32)),
}
_POOLS = (64, 32, 16, 8)
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def bev_size(cfg):
    nz = int(round((cfg["z_max"] - cfg["z_min"]) / cfg["voxel_z"]))
    nx = int(round((cfg["x_max"] - cfg["x_min"]) / cfg["voxel_x"]))
    ny = int(round((cfg["y_max"] - cfg["y_min"]) / cfg["voxel_y"]))
    return nz, nx, ny


def bev_axes(cfg):
    nz, nx, ny = bev_size(cfg)
    return (cfg["z_min"] + (np.arange(nz) + 0.5) * cfg["voxel_z"],
            cfg["x_min"] + (np.arange(nx) + 0.5) * cfg["voxel_x"],
            cfg["y_min"] + (np.arange(ny) + 0.5) * cfg["voxel_y"])


def depth_rows(cfg):
    """The depth planes (float32) and, for each BEV row, the lower plane
    d0 of its z and the blend fd toward d0 + 1."""
    depths = np.linspace(cfg["min_depth"], cfg["max_depth"],
                         cfg["num_depths"]).astype(np.float32)
    zs = bev_axes(cfg)[0]
    d = depths.astype(np.float64)
    d0 = np.clip(np.searchsorted(d, zs, side="right") - 1, 0, len(d) - 2)
    fd = np.clip((zs - d[d0]) / np.maximum(d[d0 + 1] - d[d0], 1e-6), 0.0,
                 1.0)
    return depths, d0, fd.astype(np.float32)


def check_supported(cfg: Dict) -> None:
    for key, want in (("gn", True), ("branch", True),
                      ("plane_sweep_volume", True), ("cat_img_feature", True),
                      ("rpn3d_enable", True), ("num_hourglasses", 1),
                      ("depth_offset", False)):
        if cfg[key] != want:
            raise NotImplementedError(f"{key}={cfg[key]!r}")


def _avgpool(x, k):
    N, H, W, C = x.shape
    Ho, Wo = H // k, W // k
    return x[:, :Ho * k, :Wo * k].reshape(N, Ho, k, Wo, k, C).mean((2, 4))


def _resize(x, hw):
    """Bilinear upsample, align_corners=True."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=hw, mode="bilinear",
                      align_corners=True)
    return y.permute(0, 2, 3, 1)


class FeatureNet(nn.Module):
    """Trunk + SPP branches -> (cost-volume feature, RPN image feature)."""

    def __init__(self, cfg):
        super().__init__()
        first, dims, blocks, bdim, last = _VARIANTS[cfg["backbone"]]
        gn = cfg["gn"]
        gn0 = gn if first >= 32 else False
        self._n_conv = self._n_res = 0
        self.stem = [self._conv(3, first, 3, 2, 1, gn0),
                     self._conv(first, first, 3, 1, 1, gn0),
                     self._conv(first, first, 3, 1, 1, gn0)]
        cin, self.layers = first, []
        for f, n, stride, dil, g in (
                (dims[0], blocks[0], 1, 1, gn if dims[0] >= 32 else False),
                (dims[1], blocks[1], 2, 1, gn), (dims[2], blocks[2], 1, 1, gn),
                (dims[3], blocks[3], 1, 2, gn)):
            layer = []
            for i in range(n):
                layer.append(self._res(cin, f, stride if i == 0 else 1, dil,
                                       g))
                cin = f
            self.layers.append(layer)
        self.branches = [self._conv(dims[3], bdim, 1, 1, 1, gn, min(32, bdim))
                         for _ in _POOLS]
        concat = dims[1] + dims[2] + dims[3] + len(_POOLS) * bdim
        # a dict: an attribute would register the module a second time
        self.out = {"cv": self._conv(concat, last[0], 3, 1, 1, gn)}
        self.Conv_0 = Conv2d(last[0], last[1], 1)
        rpn = cfg["rpn_convdim"]
        self.out["rpn"] = self._conv(concat, rpn, 3, 1, 1, gn,
                                     32 if rpn % 32 == 0 else 16)

    def _conv(self, cin, f, k, stride, dilation, gn, groups=32):
        m = ConvNorm(cin, f, k, stride, dilation, gn, groups)
        self.add_module(f"ConvNorm_{self._n_conv}", m)
        self._n_conv += 1
        return m

    def _res(self, cin, f, stride, dilation, gn):
        m = ResBlock2d(cin, f, stride, dilation, gn)
        self.add_module(f"ResBlock2d_{self._n_res}", m)
        self._n_res += 1
        return m

    def forward(self, x, with_rpn: bool):
        h = x
        for m in self.stem:
            h = F.relu(m(h))
        outs = []
        for layer in self.layers:
            for m in layer:
                h = m(h)
            outs.append(h)
        skip = outs[3]
        hw = skip.shape[1:3]
        feats = outs[1:]
        for k, m in zip(_POOLS, self.branches):
            kk = min(k, hw[0], hw[1])
            feats.append(_resize(F.relu(m(_avgpool(skip, kk))), tuple(hw)))
        concat = torch.cat(feats, dim=-1)
        cv = self.Conv_0(F.relu(self.out["cv"](concat)))
        return cv, (F.relu(self.out["rpn"](concat)) if with_rpn else None)


class Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.StereoFeatureNet_0 = FeatureNet(cfg)

    def forward(self, left, right):
        lf, rpn = self.StereoFeatureNet_0(left, True)
        rf, _ = self.StereoFeatureNet_0(right, False)
        return lf, rf, rpn


def plane_sweep(left, right, shifts):
    """[N, D, H, W, 2C]: the left features beside the right ones read at
    x - shift (linear in x, zeros left of column 0)."""
    N, H, W, C = left.shape
    D = shifts.shape[1]
    xs = torch.arange(W, device=left.device, dtype=torch.float32)
    src = xs[None, None] - shifts[..., None]  # [N, D, W]
    x0 = torch.floor(src)
    frac = (src - x0)[:, :, None, :, None]
    x0 = x0.long()

    def tap(xi):
        ok = ((xi >= 0) & (xi < W)).float()[:, :, None, :, None]
        idx = xi.clamp(0, W - 1)
        g = torch.stack([right[n][:, idx[n]] for n in range(N)])
        return g.permute(0, 2, 1, 3, 4) * ok  # [N, D, H, W, C]

    r = tap(x0) * (1 - frac) + tap(x0 + 1) * frac
    return torch.cat([left[:, None].expand(N, D, H, W, C), r], dim=-1)


def _hat(p, size):
    idx = torch.arange(size, dtype=torch.float32, device=p.device)
    return (1.0 - (p[..., None] - idx).abs()).clamp_min(0.0)


class Head(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        nz, nx, ny = bev_size(cfg)
        cv = _VARIANTS[cfg["backbone"]][4][1]
        gn = cfg["gn"]
        self.ConvNorm3d_0 = ConvNorm3d(2 * cv, 32, 3, gn=gn, groups=32)
        self.ConvNorm3d_1 = ConvNorm3d(32, 32, 3, gn=gn, groups=32)
        self.Hourglass_0 = Hourglass(32, 3, gn)
        self.Conv3d_0 = Conv3d(32, 1, 3)
        self.ConvNorm_0 = ConvNorm(ny * 32, 64, 3, gn=gn, groups=32)
        self.ConvNorm_1 = ConvNorm(64 + cfg["rpn_convdim"], 64, 3, gn=gn,
                                   groups=32)
        self.Hourglass_1 = Hourglass(64, 2, gn)
        A, K = cfg["num_angles"], cfg["num_classes"]
        self.Conv_0 = Conv2d(64, A * K, 3, pad=1, bias=True)
        self.Conv_1 = Conv2d(64, A * K * 24, 3, pad=1, bias=True)
        self.Conv_2 = Conv2d(64, A, 3, pad=1, bias=True)

    def depths(self, dev):
        return torch.from_numpy(depth_rows(self.cfg)[0]).to(dev)

    def frustum(self, vol, P):
        """[N, D, Hf, Wf, C] -> BEV voxels [N, nz, nx, ny, C]: for each
        cell, the volume lerped between the depth planes around its z, then
        bilinear at its projection (zeros outside)."""
        cfg = self.cfg
        N, D, Hf, Wf, C = vol.shape
        _, d0, fd = depth_rows(cfg)
        zs, xs, ys = bev_axes(cfg)
        dev = vol.device
        d0 = torch.from_numpy(d0).to(dev)
        f = torch.from_numpy(fd).to(dev)[None, :, None, None, None]
        volz = vol[:, d0] * (1 - f) + vol[:, d0 + 1] * f  # [N, nz, Hf, Wf, C]
        z = torch.from_numpy(zs.astype(np.float32)).to(dev)
        x = torch.from_numpy(xs.astype(np.float32)).to(dev)
        y = torch.from_numpy(ys.astype(np.float32)).to(dev)

        def at(i, j):
            return P[:, i, j][:, None, None]

        w = z[None, :, None] + at(2, 3)
        u = (at(0, 0) * x[None, None] + at(0, 2) * z[None, :, None]
             + at(0, 3)) / w / 4.0
        v = (at(1, 1) * y[None, None] + at(1, 2) * z[None, :, None]
             + at(1, 3)) / w / 4.0
        t = torch.einsum("nzyh,nzhwc->nzywc", _hat(v, Hf), volz)
        return torch.einsum("nzxw,nzywc->nzxyc", _hat(u, Wf), t)

    def img_to_bev(self, feat, P):
        cfg = self.cfg
        zs, xs, _ = bev_axes(cfg)
        dev = feat.device
        z = torch.from_numpy(zs.astype(np.float32)).to(dev)
        x = torch.from_numpy(xs.astype(np.float32)).to(dev)
        y = float(cfg["anchors_y"][0])
        out = []
        for f, p in zip(feat, P):
            w = z + p[2, 3]
            u = (p[0, 0] * x[None] + p[0, 2] * z[:, None] + p[0, 3]) \
                / w[:, None] / 4.0
            v = (p[1, 1] * y + p[1, 2] * z + p[1, 3]) / w / 4.0
            t = torch.einsum("zh,hwc->zwc", _hat(v, f.shape[0]), f)
            out.append(torch.einsum("zxw,zwc->zxc", _hat(u, f.shape[1]), t))
        return torch.stack(out)

    def forward(self, lf, rf, rpn, P_left, P_right):
        cfg = self.cfg
        Pl, Pr = P_left.float(), P_right.float()
        fu = Pl[:, 0, 0]
        base = Pr[:, 0, 3] / (-Pr[:, 0, 0]) - Pl[:, 0, 3] / (-Pl[:, 0, 0])
        shifts = fu[:, None] * base[:, None] / self.depths(lf.device)[None] \
            / 4.0
        vol = plane_sweep(lf.float(), rf.float(), shifts)
        base3 = F.relu(self.ConvNorm3d_1(F.relu(self.ConvNorm3d_0(vol))))
        vol = base3 + self.Hourglass_0(base3)[0]
        del base3
        cost = self.Conv3d_0(vol)[..., 0]
        depth = (torch.softmax(cost, 1)
                 * self.depths(cost.device)[None, :, None, None]).sum(1)
        nz, nx, ny = bev_size(cfg)
        vox = self.frustum(vol, Pl)
        bev = F.relu(self.ConvNorm_0(vox.reshape(-1, nz, nx, ny * 32)))
        bev = torch.cat([bev, self.img_to_bev(rpn.float(), Pl)], dim=-1)
        bev = F.relu(self.ConvNorm_1(bev))
        bev = bev + self.Hourglass_1(bev)[0]
        return dict(depth=depth, cls=self.Conv_0(bev), reg=self.Conv_1(bev),
                    centerness=self.Conv_2(bev))


class StereoNet(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.head = Head(cfg)

    def forward(self, left_u8, right_u8, P_left, P_right):
        dev = left_u8.device
        mean = torch.tensor(MEAN, device=dev)
        std = torch.tensor(STD, device=dev)
        left = (left_u8.float() / 255.0 - mean) / std
        right = (right_u8.float() / 255.0 - mean) / std
        return self.head(*self.encoder(left, right), P_left, P_right)


def detect(model: StereoNet, req, device, block: int = 1):
    """The reference RPN maps (depth, cls, reg, centerness) of a request's
    pairs, ``block`` pairs at a time, on the host."""
    parts = []
    n = req["images_left"].shape[0]
    for a in range(0, n, block):
        sl = slice(a, a + block)
        with torch.no_grad():
            o = model(*(torch.as_tensor(req[k][sl]).to(device) for k in
                        ("images_left", "images_right", "P_left",
                         "P_right")))
        parts.append({k: v.cpu() for k, v in o.items()})
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


# --- RPN maps -> proposals ------------------------------------------------


def bev_locations(cfg):
    zs, xs, _ = bev_axes(cfg)
    gz, gx = np.meshgrid(zs, xs, indexing="ij")
    return np.stack([gx, gz], -1).reshape(-1, 2).astype(np.float32)


def corners_to_box(c):
    """[..., 24] corners -> [..., 7] (h, w, l, x, y, z, ry)."""
    c = c.reshape(c.shape[:-1] + (8, 3))
    bottom, top = c[..., :4, :], c[..., 4:, :]
    cx = c[..., 0].mean(-1)
    cz = c[..., 2].mean(-1)
    yb = bottom[..., 1].mean(-1)
    h = (bottom[..., 1] - top[..., 1]).mean(-1)
    e_l = (c[..., 0, :] - c[..., 3, :]) + (c[..., 1, :] - c[..., 2, :]) \
        + (c[..., 4, :] - c[..., 7, :]) + (c[..., 5, :] - c[..., 6, :])
    e_w = (c[..., 0, :] - c[..., 1, :]) + (c[..., 3, :] - c[..., 2, :]) \
        + (c[..., 4, :] - c[..., 5, :]) + (c[..., 7, :] - c[..., 6, :])
    length = torch.sqrt(e_l[..., 0] ** 2 + e_l[..., 2] ** 2) / 4.0
    width = torch.sqrt(e_w[..., 0] ** 2 + e_w[..., 2] ** 2) / 4.0
    ry = torch.atan2(-e_l[..., 2], e_l[..., 0])
    return torch.stack([h, width, length, cx, yb, cz, ry], -1)


def _corners_bev(b):
    """[..., 5] (cx, cz, w, h, angle) -> [..., 4, 2], counter-clockwise."""
    ox = torch.tensor([0.5, -0.5, -0.5, 0.5], dtype=b.dtype, device=b.device)
    oy = torch.tensor([0.5, 0.5, -0.5, -0.5], dtype=b.dtype, device=b.device)
    x4, y4 = b[..., 2:3] * ox, b[..., 3:4] * oy
    c, s = torch.cos(b[..., 4:5]), torch.sin(b[..., 4:5])
    return torch.stack([x4 * c - y4 * s + b[..., 0:1],
                        x4 * s + y4 * c + b[..., 1:2]], -1)


def _clip(poly, a, b):
    """Sutherland-Hodgman: ``poly`` (a list of points) clipped to the
    left of the directed edge a -> b."""
    def side(p):
        return (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0])

    out = []
    for i, p in enumerate(poly):
        q = poly[(i + 1) % len(poly)]
        sp, sq = side(p), side(q)
        if sp >= 0:
            out.append(p)
        if (sp >= 0) != (sq >= 0):
            t = sp / (sp - sq)
            out.append((p[0] + t * (q[0] - p[0]), p[1] + t * (q[1] - p[1])))
    return out


def _area(poly):
    return 0.5 * abs(sum(p[0] * q[1] - q[0] * p[1] for p, q in
                         zip(poly, poly[1:] + poly[:1])))


def _iou(ci, cj, ai, aj):
    """Rotated IoU of two BEV corner lists (float64, polygon clipping)."""
    poly = ci
    for k in range(4):
        if not poly:
            break
        poly = _clip(poly, cj[k], cj[(k + 1) % 4])
    inter = _area(poly) if len(poly) >= 3 else 0.0
    return inter / max(ai + aj - inter, 1e-8)


def nms(boxes_bev, alive, iou_threshold, max_keep):
    """Greedy rotated NMS over BEV boxes [N, 5] in descending score order
    (``alive``: above the score threshold): the first ``max_keep`` kept
    indices.  Pairs whose circumscribed circles do not meet overlap by
    nothing and are skipped."""
    b = boxes_bev.double().cpu()
    corners = _corners_bev(b).tolist()
    area = [_area(c) for c in corners]
    centre = b[:, :2].numpy()
    radius = 0.5 * torch.sqrt(b[:, 2] ** 2 + b[:, 3] ** 2).numpy()
    alive = alive.copy()
    kept = []
    for i in range(len(corners)):
        if not alive[i]:
            continue
        kept.append(i)
        if len(kept) == max_keep:
            break
        near = np.flatnonzero(
            alive & (np.hypot(*(centre - centre[i]).T) < radius + radius[i]))
        for j in near[near > i]:
            if _iou(corners[i], corners[j], area[i], area[j]) > iou_threshold:
                alive[j] = False
    return kept


def decode(cfg, maps, max_boxes, score_threshold, nms_iou):
    """RPN maps of one pair (host tensors) -> (boxes [max_boxes, 7],
    scores, valid): scores, corner decode, the 4 x max_boxes best, greedy
    rotated NMS, the best ``max_boxes`` kept, padded (-inf scores)."""
    A, K = cfg["num_angles"], cfg["num_classes"]
    loc = torch.from_numpy(bev_locations(cfg))
    L = loc.shape[0]
    anchor = torch.stack([loc[:, 0:1].expand(L, K),
                          torch.tensor(cfg["anchors_y"][:1]).expand(L, K),
                          loc[:, 1:2].expand(L, K)], -1)
    score = (torch.sigmoid(maps["cls"].reshape(L, A, K))
             * torch.sigmoid(maps["centerness"].reshape(L, A))[..., None]
             ).reshape(-1)
    corners = maps["reg"].reshape(L, A, K, 24) + anchor.repeat(1, 1, 8)[:, None]
    boxes = corners_to_box(corners).reshape(L * A * K, 7)
    pool = min(4 * max_boxes, L * A * K)
    idx = torch.argsort(-score, stable=True)[:pool]
    b, s = boxes[idx], score[idx]
    bev = torch.stack([b[:, 3], b[:, 5], b[:, 2], b[:, 1], -b[:, 6]], -1)
    kept = nms(bev, (s > score_threshold).numpy(), nms_iou, max_boxes)
    out_b = torch.zeros(max_boxes, 7)
    out_s = torch.full((max_boxes,), -math.inf)
    out_b[:len(kept)] = b[kept]
    out_s[:len(kept)] = s[kept]
    valid = torch.zeros(max_boxes, dtype=torch.bool)
    valid[:len(kept)] = True
    return out_b, out_s, valid
