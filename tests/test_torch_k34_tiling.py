"""The launch arithmetic of kernels K3 (ops/cost_volume.py: ``k3_tiling``)
and K4 (ops/frustum.py: ``k4_tiling``), on the CPU.

At the tiny, small and ``StereoConfig()`` shapes, in float32 and bf16:
every (row, plane) slab of K3 and every (z, x) cell of K4 is covered by
exactly one block (and, inside it, every column / x cell and channel group
by exactly one thread), each block fits the card's shared memory, and the
grid gives every SM work.  The shapes each tiling refuses raise
ValueError.

K4's two-stage order (stage 1: the depth lerp and the v hat once per
image column of a tile's window; stage 2: the u hat over those sums; the
direct 8-tap gather where the window is wider than the tile's room) is
emulated here in float32 torch, tile by tile, and held to the plain
version ``frustum_to_voxel_separable`` at a small shape whose tiles
straddle the image's edges: both sum the same nonzero products, the plain
version by einsum over hat matrices, so they differ by float32 rounding
of those sums, at most a few ulp of the largest value (4 * 2^-23 of it,
the card test's float32 rule).

K4's backward is emulated the same way, block by block: the plan's zero
rows, then per BEV row the v-hat sums of a block's two feature rows for
each x cell (stage 1, in chunks of ``xcap`` cells, the cells bounded by
the inverted x -> u map as the kernel bounds them), then the u hat over
those sums per column of the tile (stage 2) over each column's run of
staged cells as the kernel finds it; held to the plain backward
``frustum_to_voxel_separable_bwd``, and the runs to a brute-force count.
"""

import math

import numpy as np
import pytest
import torch

from snvc_tpu_torch.config import StereoConfig, tiny_stereo_config
from snvc_tpu_torch.models.stereo_backbone import _VARIANTS
from snvc_tpu_torch.ops.cost_volume import K3_MAX_PLANES, K3_WAVES, k3_tiling
from snvc_tpu_torch.ops.frustum import (
    _project_uv,
    frustum_tables,
    frustum_to_voxel_k4_bwd_plan,
    frustum_to_voxel_separable,
    frustum_to_voxel_separable_bwd,
    k4_plane_weights,
    k4_table_bytes,
    k4_tiling,
)
from snvc_tpu_torch.ops.stereo_sample_cuda import SMEM_LIMIT, SMEM_PER_SM

H100_SMS = 132
DTYPES = [torch.float32, torch.bfloat16]


def _k3_shape(cfg):
    """(N, D, H, W, C) of the plane sweep: quarter-resolution features of
    the backbone's cost-volume width."""
    return (1, cfg.num_depths, cfg.input_size[0] // 4,
            cfg.input_size[1] // 4, _VARIANTS[cfg.backbone][4][1])


def _k4_shape(cfg):
    """(N, nz, nx, ny, C) of the resample: the BEV grid of the 3D stack's
    32-channel volume."""
    nz, nx = cfg.bev_size
    return (1, nz, nx, cfg.ny, 32)


K3_SHAPES = {"tiny": _k3_shape(tiny_stereo_config()),
             "small": (2, 9, 8, 24, 16),  # chip_smoke's small K3 case
             "ragged": (2, 13, 5, 37, 16),
             "default": _k3_shape(StereoConfig())}
K4_SHAPES = {"tiny": _k4_shape(tiny_stereo_config()),
             "small": (2, 10, 12, 4, 16),  # chip_smoke's small K4 case
             "ragged": (2, 7, 37, 3, 8),
             "default": _k4_shape(StereoConfig())}


def _resident(threads, smem):
    """Blocks an H100 SM holds at once (threads, shared memory, 32)."""
    return min(2048 // threads, SMEM_PER_SM // (smem + 1024), 32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(K3_SHAPES))
def test_k3_tiling_covers_every_slab_once(name, dtype):
    N, D, H, W, C = K3_SHAPES[name]
    t = k3_tiling(N, D, H, W, C, dtype, H100_SMS)
    G, by = t.block
    assert G * (16 // dtype.itemsize) == C
    assert 1 <= t.planes <= K3_MAX_PLANES and by <= W
    groups = -(-D // t.planes)
    assert t.blocks == N * H * groups
    seen = np.zeros((N, H, D), np.int64)
    for n in range(N):  # grid (H, N, groups)
        for h in range(H):
            for z in range(groups):
                seen[n, h, z * t.planes:min(D, (z + 1) * t.planes)] += 1
    assert (seen == 1).all()
    # inside a block: thread (g, ty) takes columns ty, ty + by, ...
    cols = np.zeros((W, G), np.int64)
    for ty in range(by):
        cols[ty::by] += 1
    assert (cols == 1).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(K3_SHAPES))
def test_k3_tiling_fits_and_fills_the_card(name, dtype):
    N, D, H, W, C = K3_SHAPES[name]
    t = k3_tiling(N, D, H, W, C, dtype, H100_SMS)
    esize = dtype.itemsize
    assert t.smem == 2 * W * C * esize <= SMEM_LIMIT
    per_sm = _resident(t.block[0] * t.block[1], t.smem)
    assert per_sm >= 1
    assert t.blocks >= min(H100_SMS, N * H * D)
    # the plane group grows only while every resident slot keeps 4 blocks
    if t.planes > 1:
        assert t.blocks >= K3_WAVES * H100_SMS * per_sm


def test_k3_tiling_at_the_serving_shape():
    t = k3_tiling(*K3_SHAPES["default"], torch.bfloat16, H100_SMS)
    # 19.5 KB rows x2, 256 threads: 5 blocks an SM, 660 slots; 96 rows x 32
    # groups of 2 planes, 4.65 blocks a slot
    assert t.block == (4, 64) and t.smem == 39936
    assert _resident(256, t.smem) == 5
    assert (t.planes, t.blocks) == (2, 3072)


def test_k3_tiling_raises_on_what_does_not_fit():
    with pytest.raises(ValueError, match="exceed a block's 232448 bytes"):
        k3_tiling(1, 4, 2, 2000, 32, torch.float32)
    with pytest.raises(ValueError, match="1024 threads"):
        k3_tiling(1, 4, 2, 2, 8200, torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        k3_tiling(1, 4, 2, 8, 12, torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(K4_SHAPES))
def test_k4_tiling_covers_every_cell_once(name, dtype):
    N, nz, nx, ny, C = K4_SHAPES[name]
    t = k4_tiling(N, nz, nx, ny, C, dtype, H100_SMS)
    G, bny, lanes = t.block
    assert bny == ny and G * (16 // dtype.itemsize) == C
    tiles = -(-nx // t.tile_x)
    assert t.blocks == N * nz * tiles
    seen = np.zeros((N, nz, nx), np.int64)
    for n in range(N):  # grid (tiles, nz, N)
        for z in range(nz):
            for b in range(tiles):
                x0 = b * t.tile_x
                ntx = min(t.tile_x, nx - x0)
                for lane in range(lanes):  # lane walks the tile L apart
                    seen[n, z, x0 + np.arange(lane, ntx, lanes)] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(K4_SHAPES))
def test_k4_tiling_fits_and_fills_the_card(name, dtype):
    N, nz, nx, ny, C = K4_SHAPES[name]
    t = k4_tiling(N, nz, nx, ny, C, dtype, H100_SMS)
    threads = t.block[0] * t.block[1] * t.block[2]
    assert threads <= 1024
    assert t.smem == k4_table_bytes(t.tile_x, ny) + t.ncol * ny * C * 4
    assert t.smem <= SMEM_LIMIT and t.smem % 16 == 0
    assert _resident(threads, t.smem) >= 1
    assert t.blocks >= min(H100_SMS, N * nz * nx)
    assert t.ncol == t.tile_x + 2


def test_k4_tiling_at_the_serving_shape():
    t = k4_tiling(*K4_SHAPES["default"], torch.bfloat16, H100_SMS)
    # 80 (y, group) pairs x 3 lanes; 18 columns of 20 x 32 float32 sums
    assert (t.block, t.tile_x, t.ncol) == ((4, 20, 3), 16, 18)
    assert t.smem == 18 * 20 * 32 * 4 + 448
    assert t.blocks == 288 * 19
    assert _resident(240, t.smem) == 4


def test_k4_tiling_raises_on_too_many_threads():
    with pytest.raises(ValueError, match="1024 threads"):
        k4_tiling(1, 4, 4, 300, 32, torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 4"):
        k4_tiling(1, 4, 4, 4, 6, torch.float32)


# --------------------------------------------- K4's two-stage tile order ----
def _hat(p, size):
    """The kernel's hat: lower tap clamped to [-2, size + 1], weights."""
    pf = torch.floor(p)
    f = p - pf
    return pf.clamp(-2, size + 1).long(), 1.0 - f, f


def _two_stage(volume, P, d0, fd, zs, xs, ys, tile_x, ncol, stride=4):
    """K4's order, tile by tile, in float32: per (n, z, x tile) the column
    window [lo, hi] of the tile's taps inside the image; stage 1 sums each
    window column's depth lerp over the v hat, stage 2 the u hat over
    those sums; a window wider than ``ncol`` gathers every x's columns
    directly.  A tap outside the image adds nothing."""
    N, D, Hf, Wf, C = volume.shape
    nz, nx, ny = len(zs), len(xs), len(ys)
    u, v = _project_uv(P, zs, xs, ys, stride)
    out = torch.zeros((N, nz, nx, ny, C))
    for n in range(N):
        for z in range(nz):
            dz = min(max(int(d0[z]), 0), D - 2)
            f1 = fd[z].float()
            lerp = volume[n, dz].float() * (1.0 - f1) \
                + volume[n, dz + 1].float() * f1  # [Hf, Wf, C]
            v0, wv0, wv1 = _hat(v[n, z], Hf)

            def column(col):  # [ny, C]: the v hat over one column
                t = torch.zeros((ny, C))
                for vv, wv in ((v0, wv0), (v0 + 1, wv1)):
                    ok = (vv >= 0) & (vv < Hf)
                    rows = lerp[vv.clamp(0, Hf - 1), col]
                    t = t + torch.where(ok[:, None], wv[:, None] * rows, 0.0)
                return t

            for xb in range(0, nx, tile_x):
                u0, wu0, wu1 = _hat(u[n, z, xb:xb + tile_x], Wf)
                lo = max(int(u0.min()), 0)
                hi = min(int(u0.max()) + 1, Wf - 1)
                ncols = hi - lo + 1
                staged = ncols <= ncol
                st = torch.full((ncol, ny, C), float("nan"))
                for c in range(ncols if staged else 0):
                    st[c] = column(lo + c)
                for i in range(len(u0)):
                    acc = torch.zeros((ny, C))
                    for uu, wu in ((int(u0[i]), wu0[i]),
                                   (int(u0[i]) + 1, wu1[i])):
                        if 0 <= uu < Wf:
                            t = st[uu - lo] if staged else column(uu)
                            acc = acc + wu * t
                    out[n, z, xb + i] = acc
    return out


def _edge_case(seed):
    """The frustum tests' shape (6 planes of 16 x 24, 10 x 12 x 4 BEV):
    depths past both ends of the planes, columns outside the image on both
    sides, per-sample calibration."""
    rng = np.random.default_rng(seed)
    depths = np.linspace(4.0, 30.0, 6).astype(np.float32)
    zs = (4.0 + (np.arange(10) + 0.5) * 2.0).astype(np.float32)
    zs[0], zs[-1] = 2.5, 34.0
    xs = (-6.0 + (np.arange(12) + 0.5)).astype(np.float32)
    ys = (-1.0 + (np.arange(4) + 0.5) * 0.8).astype(np.float32)
    P = np.tile(np.array([[80.0, 0, 48.0, 2.0], [0, 80.0, 32.0, -0.3],
                          [0, 0, 1, 0.005]], np.float32)[None], (2, 1, 1))
    P[1, 0, 3] += 0.5
    vol = rng.standard_normal((2, 6, 16, 24, 8)).astype(np.float32)
    d0, fd = frustum_tables(depths, zs)
    return [torch.from_numpy(np.ascontiguousarray(a))
            for a in (vol, P, d0, fd, zs, xs, ys)]


@pytest.mark.parametrize("tile_x,ncol", [(4, 0), (4, 6), (5, 7), (12, 26),
                                         (16, 18), (1, 3)])
def test_k4_two_stage_order_matches_plain(tile_x, ncol):
    args = _edge_case(0)
    u, _ = _project_uv(args[1], args[4], args[5], args[6], 4)
    # the case straddles the image: some tiles have columns on both sides
    # of an edge, and some x cells fall wholly outside
    assert float(u.min()) < 0 < float(u.max()) - 24
    got = _two_stage(*args, tile_x=tile_x, ncol=ncol)
    want = frustum_to_voxel_separable(*args, 4)
    tol = 4 * 2.0 ** -23 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol


def test_k4_two_stage_staged_and_direct_agree_bit_for_bit():
    """The two paths sum the same products in the same order, and every
    tap of a staged tile lies in its window (an unstaged slot is NaN)."""
    args = _edge_case(1)
    staged = _two_stage(*args, tile_x=6, ncol=64)
    direct = _two_stage(*args, tile_x=6, ncol=0)
    assert torch.equal(staged, direct)


# ------------------------------------------ K4 backward's staged order ----
def _hat_at(hat, i):
    """The kernel's hat_at: the weight a floor hat puts on tap i."""
    i0, w0, w1 = hat
    return torch.where(i0 == i, w0, torch.where(i0 + 1 == i, w1, 0.0))


def _x_cells(a, b, u0, inv, lo, hi):
    """The kernel's x_cells: the x cells whose u may lie in [a, b), from
    the inverted map widened by a cell each side, within [lo, hi]."""
    if not math.isfinite(inv) or inv == 0.0:
        return lo, hi
    f32 = np.float32
    xa = (f32(a) - f32(u0)) * f32(inv)
    xb = (f32(b) - f32(u0)) * f32(inv)
    first = max(math.floor(min(xa, xb)) - 1.0, lo)
    last = min(math.ceil(max(xa, xb)) + 1.0, hi)
    if not first <= last:
        return lo, lo - 1
    return int(first), int(last)


def _column_runs(i0, w0, wend):
    """The kernel's (first, last) staged cell of each column of [w0, wend)
    for staged cells with lower taps ``i0`` (one row's run of x cells):
    a cell reaches columns i0 and i0 + 1; it is the first of those the
    cell before it does not reach and the last of those the cell after it
    does not reach; a column no cell reaches keeps (1, 0), empty."""
    runs = [[1, 0] for _ in range(wend - w0)]
    n = len(i0)
    for c in range(n):
        prev = {i0[c - 1], i0[c - 1] + 1} if c > 0 else set()
        nxt = {i0[c + 1], i0[c + 1] + 1} if c < n - 1 else set()
        for w in (i0[c], i0[c] + 1):
            if w0 <= w < wend:
                if w not in prev:
                    runs[w - w0][0] = c
                if w not in nxt:
                    runs[w - w0][1] = c
    return runs


def _staged_bwd(grad, u, v, zr, work, d0, fd, depth_hw, tw, xcap):
    """K4's backward in the kernel's order, in float32: per block (sample,
    plane, feature rows h0 and h0 + 1, columns [w0, w0 + tw)), zeros
    unless the plan marks a row; else per BEV row of the plane's range
    with a weight, the y cells whose v hat reaches either row and the x
    cells the inverted map gives for the tile; per chunk of ``xcap`` x
    cells, stage 1 sums each cell's gradient over y for both rows, stage 2
    adds wz * wu times those sums over each column's run of staged cells
    (``_column_runs``).  (The kernel also packs the few cells of several
    near rows into one step: each sum keeps its terms and their order.)"""
    D, Hf, Wf = depth_hw
    N, nz, nx, ny, C = grad.shape
    g = grad.float()
    wzs = k4_plane_weights(d0, fd, D)
    out = torch.full((N, D, Hf, Wf, C), float("nan"))
    for n in range(N):
        for d in range(D):
            for h0 in range(0, Hf, 2):
                hs = slice(h0, min(h0 + 2, Hf))
                for w0 in range(0, Wf, tw):
                    wend = min(w0 + tw, Wf)
                    acc = torch.zeros((2, wend - w0, C))
                    busy = bool(work[n, d, hs].any())
                    for z in range(int(zr[n, d, 0]), int(zr[n, d, 1]) + 1):
                        wz = float(wzs[d, z])
                        hv = _hat(v[n, z], Hf)
                        wv = torch.stack([_hat_at(hv, h0), _hat_at(hv, h0 + 1)],
                                         1)  # [ny, 2]
                        if h0 + 1 >= Hf:  # no row h0 + 1: its weights are 0
                            wv[:, 1] = 0.0
                        ys = torch.nonzero((wv != 0).any(1)).flatten()
                        if not busy or wz == 0.0 or len(ys) == 0:
                            continue
                        u0 = float(u[n, z, 0])
                        inv = (np.float32(nx - 1)
                               / (np.float32(u[n, z, -1]) - np.float32(u0))
                               if nx > 1 else 0.0)
                        xlo, xhi = _x_cells(w0 - 1, wend, u0, inv, 0, nx - 1)
                        for xc in range(xlo, xhi + 1, xcap):
                            ncx = min(xcap, xhi - xc + 1)
                            S = torch.zeros((2, ncx, C))
                            for y in range(int(ys[0]), int(ys[-1]) + 1):
                                S = S + wv[y][:, None, None] * g[
                                    n, z, xc:xc + ncx, y][None]
                            hu = _hat(u[n, z, xc:xc + ncx], Wf)
                            runs = _column_runs(hu[0].tolist(), w0, wend)
                            for w in range(w0, wend):
                                first, last = runs[w - w0]
                                for x in range(first, last + 1):
                                    wu = float(_hat_at(tuple(
                                        a[x] for a in hu), w))
                                    acc[:, w - w0] += np.float32(
                                        wz * wu) * S[:, x]
                    out[n, d, hs, w0:wend] = acc[:hs.stop - h0]
    return out


@pytest.mark.parametrize("slope", [0.59, 1.0, 16.8, -0.8, -5.0, 0.0])
@pytest.mark.parametrize("integer_u", [False, True])
def test_k4_bwd_column_runs_match_brute_force(slope, integer_u):
    """The kernel's column runs hold every staged cell whose u hat puts a
    nonzero weight on the column and only cells whose lower tap is w - 1
    or w, at far rows' (0.59 px a cell), near rows' (16.8) and descending
    slopes, a constant u, and u on whole pixels (zero weights), over x
    cells split into chunks as a piece splits them."""
    Wf, tw = 80, 24
    x = np.arange(150, dtype=np.float32)
    u = np.float32(-3.3) + np.float32(slope) * x
    if slope < 0:
        u = u + np.float32(70.0)
    if integer_u:
        u = np.round(u)
    u = torch.from_numpy(u.astype(np.float32))
    i0, w0s, w1s = _hat(u, Wf)
    for w0 in range(0, Wf, tw):
        wend = min(w0 + tw, Wf)
        for c0 in range(0, 150, 37):
            cells = range(c0, min(c0 + 37, 150))
            runs = _column_runs(i0[c0:c0 + 37].tolist(), w0, wend)
            for w in range(w0, wend):
                got = set(range(c0 + runs[w - w0][0], c0 + runs[w - w0][1] + 1))
                want = {c for c in cells
                        if (i0[c] == w and w0s[c] != 0)
                        or (i0[c] + 1 == w and w1s[c] != 0)}
                assert want <= got
                assert all(int(i0[c]) in (w - 1, w) for c in got)


@pytest.mark.parametrize("tw,xcap", [(24, 64), (8, 3), (5, 1), (16, 7)])
def test_k4_bwd_staged_order_matches_plain(tw, xcap):
    """The plan's zero rows and the two stages, tile by tile, give the
    plain backward at the frustum tests' edge case (BEV rows past both
    ends of the planes, x cells outside the image on both sides, per-
    sample calibration): the same nonzero products summed in another
    order (y, then x, then the rows; the plain version x, then y), so
    within float32 rounding of those sums, 8 ulp of the largest value;
    every output is written (no NaN of the emulation's fill survives)."""
    vol, P, d0, fd, zs, xs, ys = _edge_case(2)
    depth_hw = tuple(vol.shape[1:4])
    grad = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, len(zs), len(xs), len(ys), 8)).astype(np.float32))
    u, v, zr, work = frustum_to_voxel_k4_bwd_plan(P, d0, fd, zs, xs, ys,
                                                  depth_hw, 4)
    got = _staged_bwd(grad, u, v, zr, work, d0, fd, depth_hw, tw, xcap)
    want = frustum_to_voxel_separable_bwd(grad, P, d0, fd, zs, xs, ys,
                                          depth_hw, 4)
    assert not bool(torch.isnan(got).any())
    assert bool((got[want == 0] == 0).all())
    tol = 8 * 2.0 ** -23 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol
