"""Kernel K1: the stereo voxel sampler as hand-written CUDA.

Replaces the Pallas kernel of snvc_tpu/ops/grid_sample_pallas.py
(``_sample_stereo_voxel_impl`` -> ``full_call`` / ``banded_call``,
:217 and :281), which builds a hat-weighted interpolation matrix and runs
it on the TPU's matrix unit because the TPU has no hardware gather.  The
H100 has one, so the forward (csrc/stereo_voxel_sample.cu) is a plain
gather: one thread per (view, 16 bytes of channels) of four points, the
threads of a point side by side, the instance from the grid's second
axis.

Forward bound: bytes.  Per flagship request it reads two [4, 64, 64, 32]
bf16 feature maps and two [4, 1.18M, 2] f32 projection arrays and writes
the [4, 32, 192, 192, 64] bf16 voxel, ~0.68 GB; each point's 2C channels
go out as neighbouring 16-byte stores, so the output stream is fully
coalesced, and no thread divides to find its point.

Backward (``StereoVoxelSample``, a ``torch.autograd.Function``; JAX takes
the VJP of ``ops/grid_sample.sample_stereo_voxel`` through XLA,
grid_sample_pallas.py:329-342): ``snvc_stereo_voxel_sample_bwd`` scatters
each voxel's gradient into the feature maps' gradient.  At the training
shape ~144 adds land on each of 2.1M float32 addresses, so the scatter
runs in shared memory: a block owns one (instance, view, channel slice)
of the map gradient; walkers of a few lanes (two channels a lane) take
contiguous runs of points along the grid axis that moves the projection
least and add a tap cell's sums once the run leaves the cell; the point
range is split over the blocks of a thread-block cluster, and the
cluster sums its partial maps through distributed shared memory and
writes them in the feature dtype (``k1_bwd_tiling`` picks the slice and
the split).  Bound: bytes, the 151 MB output gradient, read once.  When
either projection grid needs it, it also gives the grids' gradient.  In
training the grids come from the samples, the projection matrices and
the crop affines, which are not parameters, so that part is skipped
there.

Each wrapper sends a CPU tensor to its plain version (ops/grid_sample.py)
and a CUDA tensor to its kernel, or raises.  A grid of no point (the
slab of a model position that holds no length) returns the empty voxel
or zero gradients without a launch.  Both branches declare the work of
``k1_work`` / ``k1_bwd_work`` to an open ``utils.cost`` counter.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from snvc_tpu_torch.ops.conv3d_fold import SMEM_LIMIT
from snvc_tpu_torch.ops.grid_sample import (
    sample_stereo_voxel,
    sample_stereo_voxel_bwd,
)
from snvc_tpu_torch.utils.cost import Work, declare_kernel

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

# an H100 SM's shared memory (228 KB, 1 KB of it reserved per resident
# block); a block's is SMEM_LIMIT (227 KB)
SMEM_PER_SM = 233472
BWD_THREADS = 1024  # threads of a backward block (the kernel's kBwdThreads)
BWD_SLICES = (8, 4, 2, 1)  # the kernel's instantiated channel slices
MAX_CLUSTER = 8  # the portable thread-block cluster size


class K1BwdTiling(NamedTuple):
    """The backward kernel's launch: ``slice`` channels per block (its
    float32 map in ``smem`` bytes of shared memory), ``splits`` blocks per
    cluster, each scattering 1/splits of the points, ``blocks`` in all."""
    slice: int
    splits: int
    smem: int
    blocks: int


def channel_stride(HW: int, cs: int) -> int:
    """Float32 words between two channels of the backward's shared map:
    HW rounded up to 32 / cs (mod 32), so that the cs channels of one pixel
    lie on cs banks (the kernel's channel_stride)."""
    return HW if cs == 1 else HW + (32 // cs - HW) % 32


def k1_bwd_tiling(N: int, Hf: int, Wf: int, C: int,
                  sms: int = 132) -> K1BwdTiling:
    """The widest channel slice (8, 4, 2 or 1, dividing C) whose float32
    [slice, Hf * Wf] map (channel-major, padded: ``channel_stride``) and
    the 16 bytes of the walk order fit a block's shared memory, and as
    many point splits (at most 8, a cluster) as keep every block of the
    grid resident at once on ``sms`` SMs.  Raises ValueError when even
    one channel's map does not fit."""
    for cs in BWD_SLICES:
        smem = cs * channel_stride(Hf * Wf, cs) * 4 + 16  # + the walk order
        if C % cs == 0 and smem <= SMEM_LIMIT:
            break
    else:
        raise ValueError(
            f"stereo_voxel_sample_bwd: a float32 {Hf}x{Wf} feature map "
            f"({Hf * Wf * 4} bytes a channel) exceeds a block's "
            f"{SMEM_LIMIT} bytes of shared memory")
    per_sm = min(2048 // BWD_THREADS, SMEM_PER_SM // (smem + 1024))
    units = N * 2 * (C // cs)
    splits = max(1, min(MAX_CLUSTER, sms * per_sm // max(units, 1)))
    return K1BwdTiling(cs, splits, smem, units * splits)


def k1_work(N: int, P: int, Hf: int, Wf: int, C: int,
            itemsize: int) -> Work:
    """K1's work for [N, Hf, Wf, C] feature maps of ``itemsize`` bytes and
    [N, P, 2] float32 projections: both maps and both grids read once, the
    [N, P, 2C] voxel written once; float32 operations: 4 taps x (multiply
    + add) per voxel element."""
    out = N * P * 2 * C
    return Work(8.0 * out, (2 * N * Hf * Wf * C + out) * itemsize
                + 2 * N * P * 2 * 4)


def k1_bwd_work(N: int, P: int, Hf: int, Wf: int, C: int, itemsize: int,
                need_grid: bool) -> Work:
    """K1's backward: the voxel gradient and both grids read, both feature
    gradients written; 4 taps x (multiply + add) per gradient element.
    With ``need_grid`` also both feature maps read, each tap's value
    dotted with the gradient (another 4 x 2 per element) and both grid
    gradients written."""
    g = N * P * 2 * C
    feats = 2 * N * Hf * Wf * C * itemsize
    grids = 2 * N * P * 2 * 4
    if need_grid:
        return Work(16.0 * g, g * itemsize + 2 * feats + 2 * grids)
    return Work(8.0 * g, g * itemsize + feats + grids)


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
    N, Hf, Wf, C = left_feat.shape
    with declare_kernel("K1", k1_work, N, math.prod(grid_resolution), Hf,
                        Wf, C, left_feat.element_size()):
        return _k1_forward(left_feat, right_feat, grid_proj_left,
                           grid_proj_right, roi_hw, grid_resolution)


def _k1_forward(left_feat, right_feat, grid_proj_left, grid_proj_right,
                roi_hw, grid_resolution):
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
    if out.numel() == 0:  # a slab of no length: no launch
        return out
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
    N, Hf, Wf, C = left_feat.shape
    with declare_kernel("K1_bwd", k1_bwd_work, N, grid_proj_left.shape[1],
                        Hf, Wf, C, left_feat.element_size(), need_grid):
        return _k1_bwd(left_feat, right_feat, grid_proj_left,
                       grid_proj_right, gvox, roi_hw, need_grid)


def _k1_bwd(left_feat, right_feat, grid_proj_left, grid_proj_right, gvox,
            roi_hw, need_grid):
    if not left_feat.is_cuda:
        return sample_stereo_voxel_bwd(left_feat, right_feat, grid_proj_left,
                                       grid_proj_right, gvox, roi_hw,
                                       need_grid)
    N, Hf, Wf, C = left_feat.shape
    P = grid_proj_left.shape[1]
    _check_all(left_feat, right_feat, grid_proj_left, grid_proj_right, P)
    dt = left_feat.dtype
    if P == 0:  # no point sampled: zero gradients, no launch
        dl = torch.zeros_like(left_feat)
        dpl = torch.zeros_like(grid_proj_left) if need_grid else None
        return (dl, torch.zeros_like(dl), dpl,
                None if dpl is None else torch.zeros_like(dpl))
    # the grid's [nh, nw, nl] from a [N, nh, nw, nl, 2C] gradient (the
    # kernel walks l or w fastest); a flat [N, P, 2C] one walks in order
    nw, nl = gvox.shape[2:4] if gvox.ndim == 5 else (1, P)
    gvox = gvox.to(dt).contiguous()
    if (gvox.numel() != N * P * 2 * C or P % (nw * nl)
            or gvox.device != left_feat.device):
        raise ValueError(f"gradient {tuple(gvox.shape)} does not match the "
                         f"[{N}, {P}, {2 * C}] voxel")
    dev = left_feat.device
    t = k1_bwd_tiling(
        N, Hf, Wf, C,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    dl = torch.empty((N, Hf, Wf, C), dtype=dt, device=dev)
    dr = torch.empty_like(dl)
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
        None if dpr is None else dpr.data_ptr(), N, P, nw, nl, Hf, Wf, C,
        t.slice, t.splits, ctypes.c_float(2.0 / W), ctypes.c_float(2.0 / H),
        _DTYPES[dt], stream)
    if err != 0:
        raise RuntimeError(f"stereo_voxel_sample_bwd launch failed: "
                           f"{error_string(lib, err)}")
    stereo_voxel_sample_bwd.launches += 1
    return dl, dr, dpl, dpr


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
