"""Device-side affine ROI extraction (port of snvc_tpu/ops/warp.py):
cv2.warpAffine(INTER_LINEAR, BORDER_CONSTANT) semantics.  For the
scale+translate crop affines it is two interpolation matmuls
roi = A_y @ img @ A_x^T (``affine_resample_batch``, the serving path);
``affine_resample(separable=False)`` takes any affine through a per-pixel
four-tap gather."""

from __future__ import annotations

import torch


def invert_affine(t):
    """Invert 2x3 affine(s) [..., 2, 3]."""
    a, b, c = t[..., 0, 0], t[..., 0, 1], t[..., 0, 2]
    d, e, f = t[..., 1, 0], t[..., 1, 1], t[..., 1, 2]
    det = a * e - b * d
    ia, ib = e / det, -b / det
    id_, ie = -d / det, a / det
    ic = -(ia * c + ib * f)
    if_ = -(id_ * c + ie * f)
    return torch.stack([torch.stack([ia, ib, ic], dim=-1),
                        torch.stack([id_, ie, if_], dim=-1)], dim=-2)


def _bilinear_matrix(src, size: int):
    """[B, P] fractional source coordinates -> [B, P, size] two-tap weights
    max(0, 1 - |src - i|); out-of-range coordinates give zero rows."""
    idx = torch.arange(size, dtype=src.dtype, device=src.device)
    return torch.clamp(1.0 - (src[..., None] - idx).abs(), min=0.0)


def affine_resample_batch(imgs, trans, out_hw):
    """imgs [N, H, W, C] float; trans [N, 2, 3] diagonal source->ROI
    affines, one ROI per image.  Returns [N, oh, ow, C]."""
    N, H, W, C = imgs.shape
    oh, ow = out_hw
    inv = invert_affine(trans)
    oy = torch.arange(oh, dtype=imgs.dtype, device=imgs.device)
    ox = torch.arange(ow, dtype=imgs.dtype, device=imgs.device)
    sy = inv[:, 1, 1:2] * oy[None] + inv[:, 1, 2:3]  # [N, oh]
    sx = inv[:, 0, 0:1] * ox[None] + inv[:, 0, 2:3]  # [N, ow]
    Ay = _bilinear_matrix(sy, H)  # [N, oh, H]
    Ax = _bilinear_matrix(sx, W)  # [N, ow, W]
    tmp = torch.einsum("noh,nhwc->nowc", Ay, imgs)
    return torch.einsum("npw,nowc->nopc", Ax, tmp)


def _gather_hw(flat, iy, ix, H: int, W: int):
    """flat [H*W, C] at (iy, ix) [P], zero outside the image."""
    valid = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
    idx = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
    return flat[idx] * valid[:, None].to(flat.dtype)


def _resample_gather(img, inv_t, out_hw):
    """img [H, W, C]; inv_t [2, 3] output-pixel -> source-pixel affine, any
    affine: each output pixel a bilinear four-tap gather, weights in the
    image's dtype (JAX warp.py:19)."""
    H, W, C = img.shape
    oh, ow = out_hw
    oy, ox = torch.meshgrid(
        torch.arange(oh, dtype=torch.float32, device=img.device),
        torch.arange(ow, dtype=torch.float32, device=img.device),
        indexing="ij")
    inv_t = inv_t.float()
    sx = inv_t[0, 0] * ox + inv_t[0, 1] * oy + inv_t[0, 2]
    sy = inv_t[1, 0] * ox + inv_t[1, 1] * oy + inv_t[1, 2]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx = (sx - x0).reshape(-1).to(img.dtype)[:, None]
    fy = (sy - y0).reshape(-1).to(img.dtype)[:, None]
    x0i = x0.reshape(-1).long()
    y0i = y0.reshape(-1).long()
    flat = img.reshape(H * W, C)
    out = (_gather_hw(flat, y0i, x0i, H, W) * ((1 - fy) * (1 - fx))
           + _gather_hw(flat, y0i, x0i + 1, H, W) * ((1 - fy) * fx)
           + _gather_hw(flat, y0i + 1, x0i, H, W) * (fy * (1 - fx))
           + _gather_hw(flat, y0i + 1, x0i + 1, H, W) * (fy * fx))
    return out.reshape(oh, ow, C)


def affine_resample(img, trans, out_hw, separable: bool = True):
    """ROIs of one image: img [H, W, C] float, trans [R, 2, 3]
    source->ROI affines (``geometry.imgproc.crop_affine``), out_hw static.
    Returns [R, oh, ow, C].  ``separable`` (default) takes diagonal
    affines, the ROI crops', through ``affine_resample_batch``; False
    takes any affine through a per-pixel gather."""
    if separable:
        R = trans.shape[0]
        return affine_resample_batch(img[None].expand(R, *img.shape), trans,
                                     out_hw)
    inv = invert_affine(trans)
    return torch.stack([_resample_gather(img, t, out_hw) for t in inv])
