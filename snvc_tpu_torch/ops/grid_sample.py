"""Bilinear stereo voxel sampling: the plain PyTorch version of kernel K1
(port of snvc_tpu/ops/grid_sample.py).

Semantics of ``torch.nn.functional.grid_sample`` with zeros padding and
``align_corners=False``: a normalized coordinate g in [-1, 1] maps to pixel
x = ((g + 1) * S - 1) / 2; each of the four taps outside the image
contributes zero.  Coordinates and interpolation weights are float32;
the weighted sum is taken in float32 and rounded once to the feature dtype
(the CUDA kernel does the same).  Layout is NHWC, as in JAX.
``aggregate="concat-atten"`` gates both halves by the clamped cosine
similarity of the two views (``cosine_gate``), outside the sampling.

The backward's plain version (``sample_stereo_voxel_bwd``) is written out
as the CUDA backward computes it: each tap's weighted output gradient is
scatter-added into a float32 copy of the feature map, which is rounded
once; the grid gradient is the weights' derivatives times the tap values.
"""

from __future__ import annotations

import torch


def _gather_hw(feat_flat, iy, ix, H: int, W: int):
    """feat_flat [N, H*W, C]; iy, ix [N, P] int64 -> [N, P, C] float32,
    zero where (iy, ix) lies outside the image."""
    valid = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
    idx = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1))
    C = feat_flat.shape[-1]
    vals = torch.gather(feat_flat, 1, idx[..., None].expand(-1, -1, C))
    return vals.float() * valid[..., None]


def grid_sample_2d(feat, grid):
    """feat [N, H, W, C]; grid [N, P, 2] normalized (x, y).  Returns
    [N, P, C] in feat's dtype."""
    N, H, W, C = feat.shape
    g = grid.float()
    x = ((g[..., 0] + 1.0) * W - 1.0) * 0.5
    y = ((g[..., 1] + 1.0) * H - 1.0) * 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()
    flat = feat.reshape(N, H * W, C)
    out = _gather_hw(flat, y0i, x0i, H, W) * ((1 - fy) * (1 - fx))
    out = out + _gather_hw(flat, y0i, x0i + 1, H, W) * ((1 - fy) * fx)
    out = out + _gather_hw(flat, y0i + 1, x0i, H, W) * (fy * (1 - fx))
    out = out + _gather_hw(flat, y0i + 1, x0i + 1, H, W) * (fy * fx)
    return out.to(feat.dtype)


def _taps(feat, grid):
    """The four bilinear taps of every point: [(iy, ix, weight, d weight /
    dx, d weight / dy)], indices int64 [N, P], weights float32 [N, P]."""
    N, H, W, C = feat.shape
    g = grid.float()
    x = ((g[..., 0] + 1.0) * W - 1.0) * 0.5
    y = ((g[..., 1] + 1.0) * H - 1.0) * 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0i, y0i = x0.long(), y0.long()
    return [(y0i, x0i, (1 - fy) * (1 - fx), -(1 - fy), -(1 - fx)),
            (y0i, x0i + 1, (1 - fy) * fx, 1 - fy, -fx),
            (y0i + 1, x0i, fy * (1 - fx), -fy, 1 - fx),
            (y0i + 1, x0i + 1, fy * fx, fy, fx)]


def grid_sample_2d_bwd(feat, grid, gout, need_grid: bool):
    """Backward of ``grid_sample_2d``: gout [N, P, C] -> (dfeat [N, H, W, C]
    in feat's dtype, dgrid [N, P, 2] float32 or None)."""
    N, H, W, C = feat.shape
    go = gout.float()
    flat = feat.reshape(N, H * W, C)
    dfeat = torch.zeros((N, H * W, C), dtype=torch.float32,
                        device=feat.device)
    ddx = torch.zeros(go.shape[:2], dtype=torch.float32, device=feat.device)
    ddy = torch.zeros_like(ddx)
    for iy, ix, wt, wx, wy in _taps(feat, grid):
        valid = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
        idx = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
        dfeat.scatter_add_(1, idx[..., None].expand(-1, -1, C),
                           go * (wt * valid)[..., None])
        if need_grid:
            dot = (go * _gather_hw(flat, iy, ix, H, W)).sum(-1)
            ddx = ddx + wx * dot
            ddy = ddy + wy * dot
    dgrid = None
    if need_grid:  # x = ((g + 1) * W - 1) / 2
        dgrid = torch.stack([ddx * (0.5 * W), ddy * (0.5 * H)], dim=-1)
    return dfeat.reshape(N, H, W, C).to(feat.dtype), dgrid


def normalize_projections(grid_proj, roi_hw):
    """ROI-pixel coordinates -> normalized [-1, 1] (vernier.py:335-338)."""
    H, W = roi_hw
    scale = torch.tensor([2.0 / W, 2.0 / H], dtype=torch.float32,
                         device=grid_proj.device)
    return grid_proj.float() * scale - 1.0


def cosine_gate(sl, sr):
    """[..., C] x2 -> [..., 1]: the cosine similarity of the two views'
    features clamped at 0 (JAX grid_sample.py:95-115, vernier.py:140-146;
    reference vernier.py:341-344), in their dtype."""
    num = (sl * sr).sum(-1, keepdim=True)
    den = (torch.linalg.vector_norm(sl, dim=-1, keepdim=True)
           * torch.linalg.vector_norm(sr, dim=-1, keepdim=True))
    return (num / den.clamp_min(1e-8)).clamp_min(0.0)


def sample_stereo_voxel(left_feat, right_feat, grid_proj_left,
                        grid_proj_right, roi_hw, grid_resolution,
                        aggregate: str = "concat"):
    """Object-centric voxel from both views.

    left_feat/right_feat: [N, Hf, Wf, C]; grid_proj_*: [N, P, 2] projected
    grid points in ROI pixels (h-major ravel of (nh, nw, nl)); roi_hw: the
    ROI (H, W) used for normalization.  Returns [N, nh, nw, nl, 2C], left
    view first; ``aggregate`` "concat" or "concat-atten" (both halves
    times ``cosine_gate``).
    """
    nh, nw, nl = grid_resolution
    sl = grid_sample_2d(left_feat, normalize_projections(grid_proj_left, roi_hw))
    sr = grid_sample_2d(right_feat,
                        normalize_projections(grid_proj_right, roi_hw))
    if aggregate == "concat-atten":
        gate = cosine_gate(sl, sr)
        sl, sr = sl * gate, sr * gate
    elif aggregate != "concat":
        raise NotImplementedError(aggregate)
    vox = torch.cat([sl, sr], dim=-1)
    return vox.reshape(vox.shape[0], nh, nw, nl, vox.shape[-1])


def sample_stereo_voxel_bwd(left_feat, right_feat, grid_proj_left,
                            grid_proj_right, gvox, roi_hw,
                            need_grid: bool = True):
    """Backward of ``sample_stereo_voxel``: gvox [N, nh, nw, nl, 2C] ->
    (dleft, dright) in the feature dtype and (dproj_left, dproj_right)
    float32 [N, P, 2], or None when ``need_grid`` is false."""
    N, C = left_feat.shape[0], left_feat.shape[-1]
    g = gvox.reshape(N, -1, 2 * C)
    H, W = roi_hw
    scale = torch.tensor([2.0 / W, 2.0 / H], dtype=torch.float32,
                         device=left_feat.device)
    outs = []
    for feat, proj, go in ((left_feat, grid_proj_left, g[..., :C]),
                           (right_feat, grid_proj_right, g[..., C:])):
        dfeat, dgrid = grid_sample_2d_bwd(
            feat, normalize_projections(proj, roi_hw), go, need_grid)
        outs.append((dfeat, None if dgrid is None else dgrid * scale))
    (dl, dpl), (dr, dpr) = outs
    return dl, dr, dpl, dpr
