"""Kernel K1: the stereo voxel sampler as a hand-written CUDA gather.

Replaces the Pallas kernel of snvc_tpu/ops/grid_sample_pallas.py
(``_sample_stereo_voxel_impl`` -> ``full_call`` / ``banded_call``,
:217 and :281), which builds a hat-weighted interpolation matrix and runs
it on the TPU's matrix unit because the TPU has no hardware gather.  The
H100 has one, so the CUDA kernel (csrc/stereo_voxel_sample.cu) is a plain
gather: one thread per (point, view, 8-channel group).

Bound: memory.  Per flagship request it reads two [4, 64, 64, 32] bf16
feature maps and two [4, 1.18M, 2] f32 projection arrays and writes the
[4, 32, 192, 192, 64] bf16 voxel, ~0.68 GB; the gathers themselves hit
L1/L2 (each feature map is 256 KB).  The design writes each point's 2C
channels as 16-byte stores from neighbouring threads, so the output
stream is fully coalesced.

Backward (``StereoVoxelSample``, a ``torch.autograd.Function``; JAX takes
the VJP of ``ops/grid_sample.sample_stereo_voxel`` through XLA,
grid_sample_pallas.py:329-342): the same kernel library's
``snvc_stereo_voxel_sample_bwd`` scatters each voxel's gradient into
float32 copies of both feature maps with atomicAdd (bound: memory and
atomic contention; ~36 adds land on each pixel-tap at the training shape)
and, when either projection grid needs it, gives the grids' gradient.
In training the grids come from the samples, the projection matrices and
the crop affines, which are not parameters, so it is skipped there.

Each wrapper sends a CPU tensor to its plain version (ops/grid_sample.py)
and a CUDA tensor to its kernel, or raises.
"""

from __future__ import annotations

import ctypes

import torch

from snvc_tpu_torch.ops.grid_sample import (
    sample_stereo_voxel,
    sample_stereo_voxel_bwd,
)

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def _check(t, name, dtype, ndim):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_all(left_feat, right_feat, grid_proj_left, grid_proj_right, P):
    """Raises unless the operands are what the kernels take."""
    dt = left_feat.dtype
    if dt not in _DTYPES:
        raise TypeError(f"stereo_voxel_sample takes bf16 or f32, got {dt}")
    _check(left_feat, "left_feat", dt, 4)
    _check(right_feat, "right_feat", dt, 4)
    _check(grid_proj_left, "grid_proj_left", torch.float32, 3)
    _check(grid_proj_right, "grid_proj_right", torch.float32, 3)
    if right_feat.shape != left_feat.shape:
        raise ValueError("left and right features differ in shape")
    N, Hf, Wf, C = left_feat.shape
    for g in (grid_proj_left, grid_proj_right):
        if tuple(g.shape) != (N, P, 2):
            raise ValueError(f"projections must be [{N}, {P}, 2], got "
                             f"{tuple(g.shape)}")
    vec = 8 if dt == torch.bfloat16 else 4  # 16-byte channel groups
    if C % vec:
        raise ValueError(f"C={C} must be a multiple of {vec}")
    devs = {t.device for t in (left_feat, right_feat, grid_proj_left,
                               grid_proj_right)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {devs}")


def _forward(left_feat, right_feat, grid_proj_left, grid_proj_right, roi_hw,
             grid_resolution):
    if not left_feat.is_cuda:
        return sample_stereo_voxel(left_feat, right_feat, grid_proj_left,
                                   grid_proj_right, roi_hw, grid_resolution)
    nh, nw, nl = grid_resolution
    P = nh * nw * nl
    _check_all(left_feat, right_feat, grid_proj_left, grid_proj_right, P)
    dt = left_feat.dtype
    N, Hf, Wf, C = left_feat.shape
    out = torch.empty((N, nh, nw, nl, 2 * C), dtype=dt,
                      device=left_feat.device)
    from snvc_tpu_torch._build import error_string, load_library

    lib = load_library("stereo_voxel_sample")
    H, W = roi_hw
    stream = torch.cuda.current_stream(left_feat.device).cuda_stream
    err = lib.snvc_stereo_voxel_sample(
        left_feat.data_ptr(), right_feat.data_ptr(),
        grid_proj_left.data_ptr(), grid_proj_right.data_ptr(),
        out.data_ptr(), N, P, Hf, Wf, C,
        ctypes.c_float(2.0 / W), ctypes.c_float(2.0 / H), _DTYPES[dt],
        stream)
    if err != 0:
        raise RuntimeError(f"stereo_voxel_sample launch failed: "
                           f"{error_string(lib, err)}")
    stereo_voxel_sample.launches += 1
    return out


def stereo_voxel_sample_bwd(left_feat, right_feat, grid_proj_left,
                            grid_proj_right, gvox, roi_hw,
                            need_grid: bool = True):
    """Backward of the sampler: gvox [N, nh, nw, nl, 2C] -> (dleft,
    dright) in the feature dtype and (dproj_left, dproj_right) float32
    [N, P, 2] or None when ``need_grid`` is false."""
    if not left_feat.is_cuda:
        return sample_stereo_voxel_bwd(left_feat, right_feat, grid_proj_left,
                                       grid_proj_right, gvox, roi_hw,
                                       need_grid)
    N, Hf, Wf, C = left_feat.shape
    P = grid_proj_left.shape[1]
    _check_all(left_feat, right_feat, grid_proj_left, grid_proj_right, P)
    dt = left_feat.dtype
    gvox = gvox.to(dt).contiguous()
    if gvox.numel() != N * P * 2 * C or gvox.device != left_feat.device:
        raise ValueError(f"gradient {tuple(gvox.shape)} does not match the "
                         f"[{N}, {P}, {2 * C}] voxel")
    dev = left_feat.device
    dl = torch.zeros((N, Hf, Wf, C), dtype=torch.float32, device=dev)
    dr = torch.zeros_like(dl)
    dpl = dpr = None
    if need_grid:
        dpl = torch.zeros((N, P, 2), dtype=torch.float32, device=dev)
        dpr = torch.zeros_like(dpl)
    from snvc_tpu_torch._build import error_string, load_library

    lib = load_library("stereo_voxel_sample")
    H, W = roi_hw
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.snvc_stereo_voxel_sample_bwd(
        left_feat.data_ptr(), right_feat.data_ptr(),
        grid_proj_left.data_ptr(), grid_proj_right.data_ptr(),
        gvox.data_ptr(), dl.data_ptr(), dr.data_ptr(),
        None if dpl is None else dpl.data_ptr(),
        None if dpr is None else dpr.data_ptr(), N, P, Hf, Wf, C,
        ctypes.c_float(2.0 / W), ctypes.c_float(2.0 / H), _DTYPES[dt],
        stream)
    if err != 0:
        raise RuntimeError(f"stereo_voxel_sample_bwd launch failed: "
                           f"{error_string(lib, err)}")
    stereo_voxel_sample_bwd.launches += 1
    return dl.to(dt), dr.to(dt), dpl, dpr


class StereoVoxelSample(torch.autograd.Function):
    """The sampler with its backward; the grids' gradient only when
    either grid needs it."""

    @staticmethod
    def forward(ctx, left_feat, right_feat, grid_proj_left, grid_proj_right,
                roi_hw, grid_resolution):
        ctx.save_for_backward(left_feat, right_feat, grid_proj_left,
                              grid_proj_right)
        ctx.roi_hw = roi_hw
        return _forward(left_feat, right_feat, grid_proj_left,
                        grid_proj_right, roi_hw, grid_resolution)

    @staticmethod
    def backward(ctx, gvox):
        lf, rf, gl, gr = ctx.saved_tensors
        need = ctx.needs_input_grad
        dl, dr, dpl, dpr = stereo_voxel_sample_bwd(
            lf, rf, gl, gr, gvox, ctx.roi_hw, need_grid=need[2] or need[3])
        return (dl if need[0] else None, dr if need[1] else None,
                dpl if need[2] else None, dpr if need[3] else None,
                None, None)


def stereo_voxel_sample(left_feat, right_feat, grid_proj_left,
                        grid_proj_right, roi_hw, grid_resolution):
    """[N, Hf, Wf, C] features x2, [N, P, 2] ROI-pixel projections x2 ->
    voxel [N, nh, nw, nl, 2C] (left view first), differentiable.  See
    module docstring."""
    return StereoVoxelSample.apply(left_feat, right_feat, grid_proj_left,
                                   grid_proj_right, roi_hw, grid_resolution)


stereo_voxel_sample.launches = 0
stereo_voxel_sample_bwd.launches = 0
