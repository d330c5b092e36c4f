"""NCF heatmap targets and decoding (port of snvc_tpu/ops/heatmaps.py:
``bev_part_heatmaps`` and ``heatmaps_3d`` for training, the decoders for
serving)."""

from __future__ import annotations

import torch


def bev_part_heatmaps(centers_xz, grid_wl, sigma, quantize: bool = True):
    """Gaussian BEV heatmaps of the parts (JAX heatmaps.py:15).

    centers_xz [N, P, 2]: part positions in voxel index units (x along nw,
    z along nl); grid_wl = (nw, nl).  Returns [N, P, nl, nw] float32 (rows
    along length, columns along width), zero outside 3 sigma per axis.
    ``quantize`` floors the centers first, as the reference's integer
    blits do."""
    nw, nl = grid_wl
    c = torch.floor(centers_xz) if quantize else centers_xz
    cx = c[..., 0][..., None, None]
    cz = c[..., 1][..., None, None]
    xs = torch.arange(nw, dtype=torch.float32, device=c.device)[None, :]
    zs = torch.arange(nl, dtype=torch.float32, device=c.device)[:, None]
    dx2 = (xs - cx) ** 2
    dz2 = (zs - cz) ** 2
    g = torch.exp(-(dx2 + dz2) / (2.0 * float(sigma) ** 2))
    r2 = float((3 * sigma) ** 2)
    return torch.where((dx2 <= r2) & (dz2 <= r2), g, torch.zeros_like(g))


def heatmaps_3d(centers_yxz, grid_hwl, sigma, quantize: bool = True):
    """Gaussian 3D part fields (JAX heatmaps.py:41; grid_type "3D").

    centers_yxz [N, P, 3]: part positions in voxel index units (y along
    nh, x along nw, z along nl); grid_hwl = (nh, nw, nl).  Returns
    [N, P, nh, nw, nl] float32, zero outside 3 sigma per axis;
    ``quantize`` floors the centers first."""
    nh, nw, nl = grid_hwl
    c = torch.floor(centers_yxz) if quantize else centers_yxz
    cy, cx, cz = (c[..., i][..., None, None, None] for i in range(3))
    f32 = dict(dtype=torch.float32, device=c.device)
    ys = torch.arange(nh, **f32)[:, None, None]
    xs = torch.arange(nw, **f32)[None, :, None]
    zs = torch.arange(nl, **f32)[None, None, :]
    dy2 = (ys - cy) ** 2
    dx2 = (xs - cx) ** 2
    dz2 = (zs - cz) ** 2
    g = torch.exp(-(dy2 + dx2 + dz2) / (2.0 * float(sigma) ** 2))
    r2 = float((3 * sigma) ** 2)
    inside = (dy2 <= r2) & (dx2 <= r2) & (dz2 <= r2)
    return torch.where(inside, g, torch.zeros_like(g))


def hard_argmax_2d(heatmaps):
    """heatmaps [N, P, Hm, Wm] -> (xy [N, P, 2] float (x=col, y=row),
    maxval [N, P]).  First maximum wins, as in np/jnp.argmax."""
    N, P, Hm, Wm = heatmaps.shape
    flat = heatmaps.reshape(N, P, -1)
    maxval = flat.max(dim=-1).values
    idx = flat.argmax(dim=-1)
    y = torch.div(idx, Wm, rounding_mode="floor").float()
    x = (idx % Wm).float()
    return torch.stack([x, y], dim=-1), maxval


def soft_argmax_2d(heatmaps, temperature: float = 1.0):
    """Differentiable soft-argmax (JAX heatmaps.py:76): the softmax of
    ``heatmaps * temperature`` over each map, the expectation of the
    (x, y) index grids.  Returns (xy [N, P, 2], maxval [N, P])."""
    N, P, Hm, Wm = heatmaps.shape
    flat = heatmaps.reshape(N, P, -1)
    maxval = flat.max(dim=-1).values
    w = torch.softmax(flat * temperature, dim=-1).reshape(N, P, Hm, Wm)
    xs = torch.arange(Wm, dtype=torch.float32, device=flat.device)[None, :]
    ys = torch.arange(Hm, dtype=torch.float32, device=flat.device)[:, None]
    x = (w * xs).sum(dim=(-1, -2))
    y = (w * ys).sum(dim=(-1, -2))
    return torch.stack([x, y], dim=-1), maxval


def soft_argmax_2d_ref(heatmaps):
    """Reference soft-argmax (img_proc.soft_arg_max): weights
    exp(relu(h - 0.01)) - 1 normalized to sum 1; heatmaps with no weight
    fall back to the hard argmax.  Returns (xy [N, P, 2], maxval [N, P])."""
    N, P, Hm, Wm = heatmaps.shape
    flat = heatmaps.reshape(N, P, -1).float()
    maxval = flat.max(dim=-1).values
    w = torch.exp(torch.relu(flat - 0.01)) - 1.0
    wsum = w.sum(dim=-1, keepdim=True)
    w = (w / wsum.clamp_min(1e-12)).reshape(N, P, Hm, Wm)
    xs = torch.arange(Wm, dtype=torch.float32, device=flat.device)[None, :]
    ys = torch.arange(Hm, dtype=torch.float32, device=flat.device)[:, None]
    x = (w * xs).sum(dim=(-1, -2))
    y = (w * ys).sum(dim=(-1, -2))
    soft = torch.stack([x, y], dim=-1)
    hard, _ = hard_argmax_2d(heatmaps)
    flat_mask = (wsum[..., 0] <= 0.0)[..., None]
    return torch.where(flat_mask, hard, soft), maxval
