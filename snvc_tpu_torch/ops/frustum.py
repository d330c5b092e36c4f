"""Frustum volume -> rect-frame voxel grid (port of snvc_tpu/ops/frustum.py
and of the contract of snvc_tpu/ops/frustum_pallas.py), and kernel K4.

Each voxel center (x, y, z) projects to the image point (u, v) = P(x, y, z)
/ stride and to the fractional depth plane d(z); its feature is the
trilinear sample of the [D, Hf, Wf, C] frustum volume (depth clamps at the
edge planes, zeros outside the image).

  * ``depth_plane_coords``, ``sample_frustum``, ``frustum_to_voxel``: the
    JAX package's 8-tap gather form, for any projection.
  * ``frustum_tables`` + ``frustum_to_voxel_separable``: the plain version
    of K4, the contract of the Pallas kernels ``_kernel`` (pallas_call at
    snvc_tpu/ops/frustum_pallas.py:125) and ``_kernel_v2`` (:230).  For a
    rectified projection (P[2, 0] == P[2, 1] == 0) the depth pair (d0, fd)
    depends on the BEV row z only and is a static host table, u depends
    on (z, x) and v on (z, y), so the sample is a depth lerp and two hat
    weightings, accumulated in float32 and rounded once.
  * ``frustum_to_voxel_k4``: the wrapper of the CUDA kernel
    (csrc/frustum_to_voxel.cu), differentiable in the volume through
    ``FrustumK4``.  A CPU tensor goes to ``frustum_to_voxel_separable``; a
    CUDA tensor goes to the kernel or raises.
  * ``frustum_to_voxel_separable_bwd`` / ``frustum_to_voxel_k4_bwd``: the
    backward with respect to the volume, plain and kernel.
  * ``frustum_to_voxel_dP``: the backward with respect to P.  JAX takes
    the XLA VJP of the gather form (frustum_pallas.py:271-289) for both
    gradients, not a Pallas kernel; the port takes P's the same way,
    through autograd of ``frustum_to_voxel`` with the volume detached, so
    that every entry of P gets JAX's gradient, P[:, 2, :2] too, which
    the separable form assumes zero.  It runs only when P requires a
    gradient.

The TPU kernels express the hats as dense matmuls and select channels with
a mod-C 0/1 matrix: matrix-unit shapes for a chip with no gather.  The CUDA
kernel keeps the separable order instead.  A block owns one BEV row
(n, z) and a tile of x cells; it projects u for the tile and v for the ny
cells once, with the round-to-nearest intrinsics in the plain version's
order (so floor() falls on the same side), then sums the depth lerp and
the v hat once per image column of the tile's window into shared memory
(stage 1) and the u hat over those sums per output (stage 2), in float32,
rounded once.  Neighbouring x cells of far rows read the same columns and
share them there.  Where the window is wider than shared memory holds
(near rows, whose cells span many columns), the block gathers each
output's 8 taps directly, in the same order.  ``k4_tiling`` picks the
tile.  One launch covers the batch.

Bound: bytes.  At the serving shape (volume [1, 64, 96, 312, 32] bf16, BEV
288 x 300 x 20) it writes 110.6 MB and reads at most the 122.7 MB volume
once, ~0.070 ms at 3.35 TB/s.

The backward gathers rather than scatters, so it needs no atomics, in two
launches.  A plan kernel, a block a plane, finds each plane's BEV rows (a
contiguous range of the static table), projects their u and v once and
marks the (sample, plane, feature row)s that receive any gradient (about
a third at the training shape; ``k4_bwd_plan`` is its plain version).
The main kernel's block owns two feature rows and a tile of image columns
of one (sample, plane), far planes first: for a row pair with no work it
writes zeros; otherwise, per piece of x cells of the plane's BEV rows
(near rows' few cells packed together), it sums each cell's gradient over
the y cells whose v hat reaches the rows, for both rows at once, into
float32 shared memory (16 bytes a thread; the next piece's loads issued
before this one's last phases), finds each column's run of cells whose u
hat reaches it, and adds the hats' weights times those sums into float32
sums per column (``k4_bwd_tiling``).  Bound: bytes, the same in reverse
(~0.070 ms at the training shape).

Both branches of the forward and of the volume's backward declare
``k4_work`` / ``k4_bwd_work`` to an open ``utils.cost`` counter
(``frustum_to_voxel_dP`` is plain PyTorch and is counted as such).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from snvc_tpu_torch.ops.stereo_sample_cuda import SMEM_LIMIT
from snvc_tpu_torch.utils.cost import Work, declare_kernel


def depth_plane_coords(z, depths):
    """Metric depth z [...] -> fractional plane index over the ascending
    depth hypotheses [D] (clamped to [0, D - 1])."""
    D = depths.shape[0]
    idx = torch.searchsorted(depths, z.contiguous(), right=True) - 1
    idx = idx.clamp(0, D - 2)
    d0 = depths[idx]
    d1 = depths[idx + 1]
    frac = (z - d0) / torch.clamp(d1 - d0, min=1e-6)
    return idx.to(torch.float32) + frac.clamp(0.0, 1.0)


def _gather_dvu(vol_flat, d, v, u, D, H, W):
    valid = (d >= 0) & (d < D) & (v >= 0) & (v < H) & (u >= 0) & (u < W)
    flat = (d.clamp(0, D - 1) * H + v.clamp(0, H - 1)) * W + u.clamp(0, W - 1)
    return vol_flat[flat] * valid[:, None].to(vol_flat.dtype)


def sample_frustum(volume, d, v, u):
    """Trilinear sample of one volume [D, H, W, C] at fractional (plane,
    row, col) coordinates [P] -> [P, C]; taps outside contribute 0.
    Weights are in the volume's dtype, as in JAX."""
    D, H, W, C = volume.shape
    flat = volume.reshape(D * H * W, C)
    d0 = torch.floor(d).to(torch.int64)
    v0 = torch.floor(v).to(torch.int64)
    u0 = torch.floor(u).to(torch.int64)
    fd = (d - d0).to(volume.dtype)[:, None]
    fv = (v - v0).to(volume.dtype)[:, None]
    fu = (u - u0).to(volume.dtype)[:, None]
    acc = 0.0
    for dd in (0, 1):
        for dv in (0, 1):
            for du in (0, 1):
                w = ((fd if dd else 1 - fd) * (fv if dv else 1 - fv)
                     * (fu if du else 1 - fu))
                acc = acc + w * _gather_dvu(flat, d0 + dd, v0 + dv, u0 + du,
                                            D, H, W)
    return acc


def frustum_to_voxel(volume, P_mat, depths, voxel_centers,
                     feature_stride: int = 4):
    """Gather form (JAX ``frustum_to_voxel``): volume [N, D, Hf, Wf, C],
    P_mat [N, 3, 4], depths [D], voxel_centers [V, 3] rect-frame (x, y, z)
    shared by the batch.  Returns [N, V, C]."""
    d = depth_plane_coords(voxel_centers[:, 2], depths)
    return _frustum_to_voxel_at(volume, P_mat, d, voxel_centers,
                                feature_stride)


def _frustum_to_voxel_at(volume, P_mat, d, voxel_centers,
                         feature_stride: int):
    """``frustum_to_voxel`` at the fractional planes d [V] of the cells."""
    out = []
    for vol, P in zip(volume, P_mat):
        uvw = voxel_centers @ P[:, :3].T + P[:, 3]
        u = uvw[:, 0] / uvw[:, 2] / feature_stride
        v = uvw[:, 1] / uvw[:, 2] / feature_stride
        out.append(sample_frustum(vol, d, v, u))
    return torch.stack(out)


def frustum_tables(depths: np.ndarray,
                   bev_zs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The static depth-plane table of the BEV z rows (JAX
    frustum_pallas.py:88-91): lower plane d0 [nz] int32 in [0, D - 2] and
    the blend fd [nz] float32 in [0, 1]."""
    depths = np.asarray(depths)
    D = len(depths)
    d0 = np.clip(np.searchsorted(depths, bev_zs, side="right") - 1, 0, D - 2)
    span = np.maximum(depths[d0 + 1] - depths[d0], 1e-6)
    fd = np.clip((bev_zs - depths[d0]) / span, 0.0, 1.0).astype(np.float32)
    return d0.astype(np.int32), fd


def _hat(p, size: int):
    """[..., size] hat weights relu(1 - |p - i|), i = 0..size-1."""
    idx = torch.arange(size, dtype=torch.float32, device=p.device)
    return torch.clamp(1.0 - (p[..., None] - idx).abs(), min=0.0)


def _project_uv(P, zs, xs, ys, feature_stride):
    """u [N, nz, nx] and v [N, nz, ny] in feature pixels for a rectified
    P [N, 3, 4] (the homogeneous w depends on z only: w = z + P[2, 3])."""
    P = P.float()

    def at(i, j):
        return P[:, i, j][:, None, None]

    w = zs[None, :, None] + at(2, 3)
    u = (at(0, 0) * xs[None, None, :] + at(0, 2) * zs[None, :, None]
         + at(0, 3)) / w / feature_stride
    v = (at(1, 1) * ys[None, None, :] + at(1, 2) * zs[None, :, None]
         + at(1, 3)) / w / feature_stride
    return u, v


def frustum_to_voxel_separable(volume, P_mat, d0, fd, zs, xs, ys,
                               feature_stride: int = 4):
    """Plain version of K4 (the Pallas contract).

    volume [N, D, Hf, Wf, C]; P_mat [N, 3, 4] rectified; d0 [nz] int,
    fd [nz] (``frustum_tables``); zs [nz], xs [nx], ys [ny] float32 BEV
    cell centers.  Depth lerp, then the hat over v, then the hat over u,
    in float32; rounded once.  Returns [N, nz, nx, ny, C]."""
    N, D, Hf, Wf, C = volume.shape
    u, v = _project_uv(P_mat, zs, xs, ys, feature_stride)
    d0 = d0.long()
    f = fd.float()[None, :, None, None, None]
    volz = volume[:, d0].float() * (1.0 - f) + volume[:, d0 + 1].float() * f
    t = torch.einsum("nzyh,nzhwc->nzywc", _hat(v, Hf), volz)
    out = torch.einsum("nzxw,nzywc->nzxyc", _hat(u, Wf), t)
    return out.to(volume.dtype)


def frustum_to_voxel_separable_bwd(grad, P_mat, d0, fd, zs, xs, ys,
                                   depth_hw, feature_stride: int = 4):
    """Plain backward of K4 with respect to the volume: grad
    [N, nz, nx, ny, C] -> [N, D, Hf, Wf, C] in grad's dtype, for the
    volume's (D, Hf, Wf) = ``depth_hw``.  The transpose of
    ``frustum_to_voxel_separable``: the hat over u, then the hat over v,
    then the depth lerp into planes d0 and d0 + 1, in float32, rounded
    once."""
    D, Hf, Wf = depth_hw
    N, nz, nx, ny, C = grad.shape
    u, v = _project_uv(P_mat, zs, xs, ys, feature_stride)
    t = torch.einsum("nzxw,nzxyc->nzywc", _hat(u, Wf), grad.float())
    t = torch.einsum("nzyh,nzywc->nzhwc", _hat(v, Hf), t)
    f = fd.float()[None, :, None, None, None]
    d0 = d0.long()
    out = torch.zeros((N, D, Hf, Wf, C), dtype=torch.float32,
                      device=grad.device)
    out.index_add_(1, d0, t * (1.0 - f))
    out.index_add_(1, d0 + 1, t * f)
    return out.to(grad.dtype)


_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
K4_THREADS = 256  # threads a block aims for
K4_MAX_THREADS = 1024  # the kernel's __launch_bounds__
K4_TILE_X = 16  # x cells a block owns
HAT_BYTES = 12  # the kernel's Hat: lower tap (int32) and two weights


class K4Tiling(NamedTuple):
    """The kernel's launch: ``block`` = (G, ny, L) threads (G 16-byte
    channel groups, the BEV y, L lanes over the tile's x cells),
    ``tile_x`` x cells per block, ``ncol`` image columns whose stage-1
    sums a block holds, ``smem`` bytes of shared memory, ``blocks`` =
    N * nz * ceil(nx / tile_x) on a grid (ceil(nx / tile_x), nz, N)."""
    block: Tuple[int, int, int]
    tile_x: int
    ncol: int
    smem: int
    blocks: int


def k4_table_bytes(tile_x: int, ny: int) -> int:
    """Shared-memory bytes of the u and v hats and the column window,
    rounded up to 16 (the kernel's table_bytes)."""
    return -(-((tile_x + ny) * HAT_BYTES + 8) // 16) * 16


def k4_tiling(N: int, nz: int, nx: int, ny: int, C: int, dtype,
              sms: int = 132) -> K4Tiling:
    """The launch of K4 for an [N, nz, nx, ny, C] output of ``dtype`` on
    a card of ``sms`` SMs: tiles of 16 x cells, halved while the grid has
    fewer blocks than SMs, L = 256 / (G * ny) lanes (at least 1), and room
    for the stage-1 sums of tile_x + 2 columns (a window that wide shares
    columns between the tile's x cells; a wider one gathers directly).
    Raises ValueError when G * ny exceeds a block's 1024 threads."""
    esize = dtype.itemsize
    vec = 16 // esize
    if C % vec:
        raise ValueError(f"C={C} must be a multiple of {vec}")
    G = C // vec
    if G * ny > K4_MAX_THREADS:
        raise ValueError(f"frustum_to_voxel: {G} channel groups x {ny} BEV "
                         f"cells exceed a block's {K4_MAX_THREADS} threads")
    lanes = max(1, K4_THREADS // (G * ny))
    tile_x = max(1, min(K4_TILE_X, nx))
    while tile_x > 1 and N * nz * -(-nx // tile_x) < sms:
        tile_x //= 2
    table = k4_table_bytes(tile_x, ny)
    ncol = min(tile_x + 2, (SMEM_LIMIT - table) // (ny * C * 4))
    smem = table + ncol * ny * C * 4
    return K4Tiling((G, ny, lanes), tile_x, ncol, smem,
                    N * nz * -(-nx // tile_x))


def k4_planes(d0) -> int:
    """The depth planes a K4 forward reads: each BEV row's d0 and
    d0 + 1 (``d0`` read back to the host)."""
    lo = set(torch.as_tensor(d0).tolist())
    return len(lo | {i + 1 for i in lo})


def k4_work(volume_shape, d0, out_shape, itemsize: int) -> Work:
    """K4's work for a [N, D, Hf, Wf, C] volume of ``itemsize`` bytes and
    the [N, nz, nx, ny, C] output: the planes the table ``d0`` uses
    (``k4_planes``) read once, the output written once; float32
    operations per output element: 4 (row, column) taps of a depth lerp
    (3) and a weighted add (2), then 2 weighted adds over u (4)."""
    N, _, Hf, Wf, C = volume_shape
    out = math.prod(out_shape)
    return Work(24.0 * out, (N * k4_planes(d0) * Hf * Wf * C + out)
                * itemsize)


def k4_bwd_work(grad_shape, depth_hw, itemsize: int) -> Work:
    """K4's backward with respect to the volume: the [N, nz, nx, ny, C]
    gradient read once, the [N, D, Hf, Wf, C] volume's written once;
    float32 operations per gradient element: its 8 taps' weights and
    adds."""
    N, C = grad_shape[0], grad_shape[-1]
    g = math.prod(grad_shape)
    return Work(24.0 * g, (g + N * math.prod(depth_hw) * C) * itemsize)


def _f2v_forward(volume, P_mat, d0, fd, zs, xs, ys, feature_stride):
    """The forward of ``FrustumK4``: the plain version on the CPU, the
    kernel on the card."""
    if not volume.is_cuda:
        return frustum_to_voxel_separable(volume, P_mat, d0, fd, zs, xs, ys,
                                          feature_stride)
    dt = volume.dtype
    if dt not in _DTYPES:
        raise TypeError(f"frustum_to_voxel_k4 takes bf16 or f32, got {dt}")
    if volume.ndim != 5:
        raise ValueError(f"volume must be [N, D, Hf, Wf, C], got "
                         f"{tuple(volume.shape)}")
    N, D, Hf, Wf, C = volume.shape
    nz, nx, ny = zs.shape[0], xs.shape[0], ys.shape[0]
    _check_tables(volume, P_mat, d0, fd, zs, xs, ys, N)
    if D < 2:
        raise ValueError(f"the volume needs at least 2 depth planes, got {D}")
    if volume.data_ptr() % 16:
        raise ValueError("the volume must be 16-byte aligned")
    t = k4_tiling(N, nz, nx, ny, C, dt, torch.cuda.get_device_properties(
        volume.device).multi_processor_count)
    out = torch.empty((N, nz, nx, ny, C), dtype=dt, device=volume.device)
    from snvc_tpu_torch._build import error_string, load_library

    lib = load_library("frustum_to_voxel")
    stream = torch.cuda.current_stream(volume.device).cuda_stream
    err = lib.snvc_frustum_to_voxel(
        volume.data_ptr(), P_mat.data_ptr(), d0.data_ptr(), fd.data_ptr(),
        zs.data_ptr(), xs.data_ptr(), ys.data_ptr(), out.data_ptr(),
        N, D, Hf, Wf, C, nz, nx, ny, float(feature_stride), t.tile_x,
        t.block[2], t.ncol, _DTYPES[dt], stream)
    if err != 0:
        raise RuntimeError(f"frustum_to_voxel launch failed: "
                           f"{error_string(lib, err)}")
    frustum_to_voxel_k4.launches += 1
    return out


def _check_tables(t0, P_mat, d0, fd, zs, xs, ys, N):
    """Raises unless P and the tables are what the kernels take, on
    ``t0``'s CUDA device and contiguous like it."""
    nz, nx, ny = zs.shape[0], xs.shape[0], ys.shape[0]
    want = ((P_mat, torch.float32, (N, 3, 4)), (d0, torch.int32, (nz,)),
            (fd, torch.float32, (nz,)), (zs, torch.float32, (nz,)),
            (xs, torch.float32, (nx,)), (ys, torch.float32, (ny,)))
    for i, (t, dtype, shape) in enumerate(want):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"argument {i + 2} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    tensors = (t0,) + tuple(t for t, _, _ in want)
    if not all(t.is_cuda and t.device == t0.device for t in tensors):
        raise ValueError("every argument must lie on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("every argument must be contiguous")


K4_BWD_THREADS = 256  # threads of a backward block (the kernel's kBwdThreads)
K4_BWD_ROWS = 2  # feature rows a backward block owns (kBwdRows)
K4_BWD_Z = 16  # BEV rows whose tables a block holds at once (kBwdZ)
K4_BWD_SLOTS = 2  # float4 slots of the tile a thread owns (kBwdSlots)
K4_BWD_SUMS = 30720  # bytes of float32 v-hat sums a block stages
XHAT_BYTES = 16  # the kernel's XHat: a staged x cell's u hat
BWD_ROW_BYTES = 24  # the kernel's BwdRow


class K4BwdTiling(NamedTuple):
    """The backward's two launches.  The plan: ``plan_grid`` = (D, N)
    blocks of 256 threads, ``plan_smem`` bytes (an int a feature row).  The
    main kernel: blocks of 256 threads own 2 feature rows and ``tw`` =
    2 * 256 / (C / 4) image columns of one (sample, plane) on
    ``grid`` = (ceil(Wf / tw), ceil(Hf / 2), N * D), ``blocks`` of them,
    staging the v-hat sums of ``xcap`` x cells at once in ``smem``
    bytes."""
    tw: int
    xcap: int
    smem: int
    grid: Tuple[int, int, int]
    blocks: int
    plan_grid: Tuple[int, int]
    plan_smem: int


def k4_bwd_smem(xcap: int, C: int, ny: int, tw: int) -> int:
    """Shared-memory bytes of a backward block (the kernel's
    bwd_smem_bytes): for each of ``xcap`` staged x cells the float32 v-hat
    sums of 2 rows of C channels and its u hat (16 bytes); the float32
    sums of the block's 2 x ``tw`` outputs; then for each of 16 BEV rows a
    piece's row entry (16 bytes), the row's tables (24 bytes), a float32
    weight pair per y and each column's first and last staged cell (two
    int16)."""
    return (xcap * (K4_BWD_ROWS * C * 4 + XHAT_BYTES)
            + K4_BWD_ROWS * tw * C * 4
            + K4_BWD_Z * (16 + BWD_ROW_BYTES + ny * 8 + tw * 4))


def k4_bwd_tiling(N: int, D: int, Hf: int, Wf: int, C: int, nz: int,
                  ny: int) -> K4BwdTiling:
    """The launches of K4's backward for an [N, D, Hf, Wf, C] gradient
    (bf16 or float32) and nz BEV rows of ny cells: 2 float4 slots a thread
    of 256, so tw = 2 * 256 / (C / 4) columns a block (64 at C = 32), and
    the v-hat sums of as many x cells staged at once as 30 KB hold (120
    at C = 32, a far row's ~112 cells of a 64-column tile whole).  Raises
    ValueError when C is not a multiple of 8 or exceeds a block, or shared
    memory or the grid exceed the card's limits."""
    if C % 8 or C // 4 > K4_BWD_THREADS:
        raise ValueError(f"frustum_to_voxel_bwd: C={C} must be a multiple of "
                         f"8 and at most {4 * K4_BWD_THREADS}")
    if N * D > 65535 or -(-Hf // K4_BWD_ROWS) > 65535 or N > 65535:
        raise ValueError(f"frustum_to_voxel_bwd: a grid of {N * D} planes x "
                         f"{Hf} rows exceeds 65535")
    xcap = K4_BWD_SUMS // (K4_BWD_ROWS * C * 4)
    tw = K4_BWD_SLOTS * K4_BWD_THREADS // (C // 4)
    smem = k4_bwd_smem(xcap, C, ny, tw)
    plan_smem = 4 * Hf
    if max(smem, plan_smem) > SMEM_LIMIT:
        raise ValueError(f"frustum_to_voxel_bwd: {xcap} staged x cells and "
                         f"tables for ny={ny} ({smem} bytes, C={C}) or the "
                         f"plan's {plan_smem} (Hf={Hf}) exceed a block's "
                         f"{SMEM_LIMIT} bytes of shared memory")
    grid = (-(-Wf // tw), -(-Hf // K4_BWD_ROWS), N * D)
    return K4BwdTiling(tw, xcap, smem, grid,
                       grid[0] * grid[1] * grid[2], (D, N), plan_smem)


def k4_bwd_scratch_bytes(N: int, D: int, Hf: int, nz: int, nx: int,
                         ny: int) -> int:
    """Bytes of the plan's scratch (the kernel's BwdScratch): u [N, nz, nx]
    and v [N, nz, ny] float32, each plane's BEV rows [N, D, 2] int32, the
    feature rows with work [N, D, Hf] uint8."""
    return 4 * (N * nz * nx + N * nz * ny + 2 * N * D) + N * D * Hf


def _floor_hat(p, size: int):
    """The kernels' hat of p: lower tap floor(p) clamped to [-2, size + 1],
    weights 1 - f and f with f = p - floor(p)."""
    pf = torch.floor(p)
    f = p - pf
    return pf.clamp(-2, size + 1).long(), 1.0 - f, f


def k4_plane_weights(d0, fd, D: int):
    """[D, nz] float32: the weight of each BEV row on each plane (1 - fd on
    plane d0, fd on d0 + 1, with d0 clamped to [0, D - 2] as the kernels
    do)."""
    dz = d0.long().clamp(0, D - 2)[None]
    f = fd.float()[None]
    planes = torch.arange(D, device=d0.device)[:, None]
    zero = torch.zeros((), device=f.device)
    return torch.where(dz == planes, 1.0 - f,
                       torch.where(dz + 1 == planes, f, zero))


def k4_bwd_plan(u, v, d0, fd, depth_hw):
    """Plain version of the backward's plan: for u [N, nz, nx] and v
    [N, nz, ny] (``_project_uv``) and the volume's (D, Hf, Wf), each
    plane's first and last BEV row with a nonzero weight on it, [N, D, 2]
    int32 ((0, -1) for none), and which feature rows of each plane receive
    any gradient, [N, D, Hf] uint8: a row with a weight on the plane, some
    x whose u hat puts a nonzero weight on a column of the image and some y
    whose v hat puts one on the row."""
    D, Hf, Wf = depth_hw
    N, nz = u.shape[:2]
    reach = k4_plane_weights(d0, fd, D) != 0  # [D, nz]
    z = torch.arange(nz, device=u.device)
    first = torch.where(reach, z, nz).amin(1)
    last = torch.where(reach, z, -1).amax(1)
    empty = first > last
    zr = torch.stack([torch.where(empty, 0, first),
                      torch.where(empty, -1, last)], -1).to(torch.int32)
    u0, wu0, wu1 = _floor_hat(u, Wf)
    inside = (((wu0 != 0) & (u0 >= 0) & (u0 < Wf))
              | ((wu1 != 0) & (u0 + 1 >= 0) & (u0 + 1 < Wf))).any(-1)
    v0, wv0, wv1 = _floor_hat(v, Hf)
    h = torch.arange(Hf, device=v.device)
    rows = (((v0[..., None] == h) & (wv0[..., None] != 0))
            | ((v0[..., None] + 1 == h) & (wv1[..., None] != 0))).any(2)
    rows &= inside[..., None]  # [N, nz, Hf]
    work = torch.einsum("dz,nzh->ndh", reach.float(), rows.float()) > 0
    return zr[None].expand(N, D, 2).contiguous(), work.to(torch.uint8)


def _k4_bwd_plan_scratch(lib, P_mat, d0, fd, zs, xs, ys, depth_hw,
                         feature_stride, stream):
    """Launches the plan kernel into a new scratch (``BwdScratch``) and
    returns it: what the main kernel reads."""
    from snvc_tpu_torch._build import error_string

    D, Hf, Wf = depth_hw
    N = P_mat.shape[0]
    nz, nx, ny = zs.shape[0], xs.shape[0], ys.shape[0]
    scratch = torch.empty(k4_bwd_scratch_bytes(N, D, Hf, nz, nx, ny),
                          dtype=torch.uint8, device=P_mat.device)
    err = lib.snvc_frustum_to_voxel_bwd_plan(
        P_mat.data_ptr(), d0.data_ptr(), fd.data_ptr(), zs.data_ptr(),
        xs.data_ptr(), ys.data_ptr(), scratch.data_ptr(), N, D, Hf, Wf,
        nz, nx, ny, float(feature_stride), stream)
    if err != 0:
        raise RuntimeError(f"frustum_to_voxel_bwd plan launch failed: "
                           f"{error_string(lib, err)}")
    return scratch


def _k4_bwd_scratch_views(scratch, N, D, Hf, nz, nx, ny):
    """(u, v, zr, work) of the plan's scratch."""
    sizes = (4 * N * nz * nx, 4 * N * nz * ny, 8 * N * D, N * D * Hf)
    u, v, zr, work = torch.split(scratch, sizes)
    return (u.view(torch.float32).view(N, nz, nx),
            v.view(torch.float32).view(N, nz, ny),
            zr.view(torch.int32).view(N, D, 2), work.view(N, D, Hf))


def frustum_to_voxel_k4_bwd_plan(P_mat, d0, fd, zs, xs, ys, depth_hw,
                                 feature_stride: int = 4):
    """The backward's plan (u, v, zr, work) as ``_project_uv`` and
    ``k4_bwd_plan`` give it: on the CPU those plain versions, on the card
    the plan kernel (what ``frustum_to_voxel_k4_bwd`` launches first)."""
    if not P_mat.is_cuda:
        u, v = _project_uv(P_mat, zs, xs, ys, feature_stride)
        return (u, v) + k4_bwd_plan(u, v, d0, fd, depth_hw)
    _check_tables(P_mat, P_mat, d0, fd, zs, xs, ys, P_mat.shape[0])
    from snvc_tpu_torch._build import load_library

    scratch = _k4_bwd_plan_scratch(
        load_library("frustum_to_voxel"), P_mat, d0, fd, zs, xs, ys,
        depth_hw, feature_stride,
        torch.cuda.current_stream(P_mat.device).cuda_stream)
    return _k4_bwd_scratch_views(scratch, P_mat.shape[0], *depth_hw[:2],
                                 zs.shape[0], xs.shape[0], ys.shape[0])


def frustum_to_voxel_k4_bwd(grad, P_mat, d0, fd, zs, xs, ys, depth_hw,
                            feature_stride: int = 4):
    """Backward of K4 with respect to the volume, same arguments and
    result as ``frustum_to_voxel_separable_bwd``.  A CPU tensor goes to
    that plain version; a CUDA tensor to the plan kernel and the main
    kernel, or raises.  The kernel inverts the affine map x -> u to bound
    the x cells a tile reads, so ``xs`` must be evenly spaced
    (``_bev_axes`` makes them so); P is rectified, as for the forward."""
    with declare_kernel("K4_bwd", k4_bwd_work, tuple(grad.shape),
                        tuple(depth_hw), grad.element_size()):
        return _k4_bwd(grad, P_mat, d0, fd, zs, xs, ys, depth_hw,
                       feature_stride)


def _k4_bwd(grad, P_mat, d0, fd, zs, xs, ys, depth_hw, feature_stride):
    if not grad.is_cuda:
        return frustum_to_voxel_separable_bwd(grad, P_mat, d0, fd, zs, xs,
                                              ys, depth_hw, feature_stride)
    dt = grad.dtype
    if dt not in _DTYPES:
        raise TypeError(f"frustum_to_voxel_k4_bwd takes bf16 or f32, got "
                        f"{dt}")
    if grad.ndim != 5:
        raise ValueError(f"grad must be [N, nz, nx, ny, C], got "
                         f"{tuple(grad.shape)}")
    D, Hf, Wf = depth_hw
    N, nz, nx, ny, C = grad.shape
    if (zs.shape[0], xs.shape[0], ys.shape[0]) != (nz, nx, ny):
        raise ValueError(f"grad {tuple(grad.shape)} does not match the "
                         f"tables' {nz} x {nx} x {ny} cells")
    _check_tables(grad, P_mat, d0, fd, zs, xs, ys, N)
    if D < 2:
        raise ValueError(f"the volume needs at least 2 depth planes, got {D}")
    if grad.data_ptr() % 16:
        raise ValueError("grad must be 16-byte aligned")
    t = k4_bwd_tiling(N, D, Hf, Wf, C, nz, ny)
    from snvc_tpu_torch._build import error_string, load_library

    lib = load_library("frustum_to_voxel")
    stream = torch.cuda.current_stream(grad.device).cuda_stream
    scratch = _k4_bwd_plan_scratch(lib, P_mat, d0, fd, zs, xs, ys, depth_hw,
                                   feature_stride, stream)
    dvol = torch.empty((N, D, Hf, Wf, C), dtype=dt, device=grad.device)
    err = lib.snvc_frustum_to_voxel_bwd(
        grad.data_ptr(), d0.data_ptr(), fd.data_ptr(), scratch.data_ptr(),
        dvol.data_ptr(), N, D, Hf, Wf, C, nz, nx, ny, t.xcap, _DTYPES[dt],
        stream)
    if err != 0:
        raise RuntimeError(f"frustum_to_voxel_bwd launch failed: "
                           f"{error_string(lib, err)}")
    frustum_to_voxel_k4_bwd.launches += 1
    return dvol


def frustum_to_voxel_dP(grad, volume, P_mat, d0, fd, zs, xs, ys,
                        feature_stride: int = 4):
    """K4's gradient with respect to P [N, 3, 4] for the output gradient
    ``grad`` [N, nz, nx, ny, C]: autograd of the gather form
    (``frustum_to_voxel``) at the cell centres of (zs, xs, ys) and the
    planes d0 + fd, the volume detached, as JAX's VJP
    (frustum_pallas.py:271-289).  Plain PyTorch on either device."""
    nz, nx, ny = zs.shape[0], xs.shape[0], ys.shape[0]
    gz, gx, gy = torch.meshgrid(zs, xs, ys, indexing="ij")
    centers = torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)
    d = (d0.float() + fd)[:, None, None].expand(nz, nx, ny).reshape(-1)
    with torch.enable_grad():
        P = P_mat.detach().requires_grad_()
        out = _frustum_to_voxel_at(volume.detach(), P, d, centers,
                                   feature_stride)
        dP, = torch.autograd.grad(out, P, grad.reshape(out.shape))
    return dP


class FrustumK4(torch.autograd.Function):
    """K4 with its backward: the volume's on the backward kernel, P's
    (``frustum_to_voxel_dP``) only when P requires a gradient."""

    @staticmethod
    def forward(ctx, volume, P_mat, d0, fd, zs, xs, ys, feature_stride):
        # the volume is kept only for P's gradient
        ctx.save_for_backward(P_mat, d0, fd, zs, xs, ys,
                              volume if ctx.needs_input_grad[1] else None)
        ctx.depth_hw = tuple(volume.shape[1:4])
        ctx.stride = feature_stride
        return _f2v_forward(volume, P_mat, d0, fd, zs, xs, ys, feature_stride)

    @staticmethod
    def backward(ctx, grad):
        *tables, volume = ctx.saved_tensors
        grad = grad.contiguous()
        dvol = dP = None
        if ctx.needs_input_grad[0]:
            dvol = frustum_to_voxel_k4_bwd(grad, *tables, ctx.depth_hw,
                                           ctx.stride)
        if ctx.needs_input_grad[1]:
            dP = frustum_to_voxel_dP(grad, volume, *tables, ctx.stride)
        return (dvol, dP) + (None,) * 6


def frustum_to_voxel_k4(volume, P_mat, d0, fd, zs, xs, ys,
                        feature_stride: int = 4):
    """Kernel K4, same arguments and result as
    ``frustum_to_voxel_separable``, differentiable in the volume (the
    backward kernel) and in P (``frustum_to_voxel_dP``).  The kernel
    assumes P[:, 2, :2] == 0 and does not check it (that would read P
    back from the card): the caller checks its host copy
    (``data/stereo.check_stereo_projections``).  See module docstring."""
    N = volume.shape[0]
    out_shape = (N, zs.shape[0], xs.shape[0], ys.shape[0], volume.shape[-1])
    with declare_kernel("K4", k4_work, tuple(volume.shape), d0, out_shape,
                        volume.element_size()):
        return FrustumK4.apply(volume, P_mat, d0, fd, zs, xs, ys,
                               feature_stride)


frustum_to_voxel_k4.launches = 0
frustum_to_voxel_k4_bwd.launches = 0
