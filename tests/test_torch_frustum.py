"""The port's frustum -> voxel resample (snvc_tpu_torch/ops/frustum.py)
against the JAX package, at the shapes of tests/test_stereonet.py:63-96:
the gather form against ``frustum_to_voxel``, and the plain version of
kernel K4 (``frustum_to_voxel_separable``) against both ``frustum_to_voxel``
and the Pallas kernels run by the Pallas interpreter
(``frustum_to_voxel_pallas`` and ``_v2``, ``interpret=True``).

Float32.  The gather form projects the voxel centers with a matmul, the
separable forms with per-axis products, and the Pallas kernels sum their
hat matmuls in another order, so the samples differ by float32 rounding of
the coordinates times the volume's gradient: atol 2e-4, as the JAX test of
the two uses.  The kernel's wrapper on a CPU tensor is the plain version and
leaves its launch counter alone; a CUDA test compares the kernel with its
plain version on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snvc_tpu.ops.frustum import depth_plane_coords as jax_depth_coords
from snvc_tpu.ops.frustum import frustum_to_voxel as jax_f2v
from snvc_tpu.ops.frustum_pallas import (
    frustum_to_voxel_pallas,
    frustum_to_voxel_pallas_v2,
)
from snvc_tpu_torch.ops.frustum import (
    depth_plane_coords,
    frustum_tables,
    frustum_to_voxel,
    frustum_to_voxel_k4,
    frustum_to_voxel_dP,
    frustum_to_voxel_k4_bwd,
    frustum_to_voxel_separable,
    frustum_to_voxel_separable_bwd,
)

P_TEST = np.array([[80.0, 0, 48.0, 2.0], [0, 80.0, 32.0, -0.3],
                   [0, 0, 1, 0.005]], np.float32)


def _case(seed, N=1):
    """Volume [N, 6, 16, 24, 8] and a 10 x 12 x 4 BEV grid whose depths
    run past both ends of the planes (clamped) and whose columns fall
    partly outside the image (zeros)."""
    rng = np.random.default_rng(seed)
    D, Hf, Wf, C = 6, 16, 24, 8
    depths = np.linspace(4.0, 30.0, D).astype(np.float32)
    zs = (4.0 + (np.arange(10) + 0.5) * 2.0).astype(np.float32)
    zs[0], zs[-1] = 2.5, 34.0
    xs = (-6.0 + (np.arange(12) + 0.5) * 1.0).astype(np.float32)
    ys = (-1.0 + (np.arange(4) + 0.5) * 0.8).astype(np.float32)
    vol = rng.standard_normal((N, D, Hf, Wf, C)).astype(np.float32)
    P = np.tile(P_TEST[None], (N, 1, 1))
    P[1:, 0, 3] += 0.5  # per-sample calibration
    return vol, P, depths, zs, xs, ys


def _centers(zs, xs, ys):
    gz, gx, gy = np.meshgrid(zs, xs, ys, indexing="ij")
    return np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32)


def _separable(vol, P, depths, zs, xs, ys):
    d0, fd = frustum_tables(depths, zs)
    args = (vol, P, d0, fd, zs, xs, ys)
    return frustum_to_voxel_separable(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in args), 4)


def test_depth_plane_coords_matches_jax():
    depths = np.array([2.0, 4.0, 6.0, 8.0], np.float32)
    z = np.array([0.5, 2.0, 5.0, 7.99, 8.0, 100.0], np.float32)
    want = np.asarray(jax_depth_coords(jnp.asarray(z), jnp.asarray(depths)))
    got = depth_plane_coords(torch.from_numpy(z),
                             torch.from_numpy(depths)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_gather_form_matches_jax():
    vol, P, depths, zs, xs, ys = _case(0, N=2)
    c = _centers(zs, xs, ys)
    want = np.asarray(jax_f2v(jnp.asarray(vol), jnp.asarray(P),
                              jnp.asarray(depths), jnp.asarray(c), 4))
    got = frustum_to_voxel(*(torch.from_numpy(a) for a in
                             (vol, P, depths, c)), 4).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_tables_match_the_pallas_wrapper():
    """d0 / fd as frustum_pallas.py:88-91 builds them (clamped at both
    ends of the planes)."""
    _, _, depths, zs, _, _ = _case(1)
    d0, fd = frustum_tables(depths, zs)
    D = len(depths)
    want_d0 = np.clip(np.searchsorted(depths, zs, side="right") - 1, 0, D - 2)
    assert d0.dtype == np.int32 and fd.dtype == np.float32
    np.testing.assert_array_equal(d0, want_d0)
    assert fd[0] == 0.0 and fd[-1] == 1.0 and ((fd >= 0) & (fd <= 1)).all()


@pytest.mark.parametrize("N", [1, 2])
def test_k4_plain_matches_jax_gather(N):
    vol, P, depths, zs, xs, ys = _case(2, N)
    want = np.asarray(jax_f2v(
        jnp.asarray(vol), jnp.asarray(P), jnp.asarray(depths),
        jnp.asarray(_centers(zs, xs, ys)), 4)).reshape(N, 10, 12, 4, 8)
    got = _separable(vol, P, depths, zs, xs, ys).numpy()
    assert got.shape == (N, 10, 12, 4, 8)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


@pytest.mark.parametrize("version", [frustum_to_voxel_pallas,
                                     frustum_to_voxel_pallas_v2])
def test_k4_plain_matches_pallas_interpret(version):
    vol, P, depths, zs, xs, ys = _case(3, N=2)
    want = np.asarray(version(jnp.asarray(vol), jnp.asarray(P), depths, zs,
                              xs, ys, 4, interpret=True))
    got = _separable(vol, P, depths, zs, xs, ys).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def test_k4_wrapper_on_cpu_is_plain_and_uncounted():
    vol, P, depths, zs, xs, ys = _case(4, N=2)
    d0, fd = frustum_tables(depths, zs)
    args = [torch.from_numpy(a) for a in (vol, P, d0, fd, zs, xs, ys)]
    before = frustum_to_voxel_k4.launches
    got = frustum_to_voxel_k4(*args, 4)
    assert torch.equal(got, frustum_to_voxel_separable(*args, 4))
    assert frustum_to_voxel_k4.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_kernel_matches_plain_on_card(cuda_device, dtype):
    """Both sum the same 8 taps in float32 in the same order and round
    once; the plain version's einsums may fuse a multiply-add.  bf16: two
    ulp at the largest value; float32: four (each of the two hat sums
    may round once differently)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    vol, P, depths, zs, xs, ys = _case(5, N=2)
    d0, fd = frustum_tables(depths, zs)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (vol, P, d0, fd, zs, xs, ys)]
    args[0] = args[0].to(dtype)
    got = frustum_to_voxel_k4(*args, 4).float()
    want = frustum_to_voxel_separable(*args, 4).float()
    tol = 4 * 2.0 ** -23 if dtype == torch.float32 else 2 * 2.0 ** -7
    assert bool(((got - want).abs() <= tol * want.abs().max()).all())


def _k4_launch(args, tile_x, lanes, ncol):
    """K4 through its C entry point at an explicit tiling."""
    from snvc_tpu_torch._build import load_library

    vol, P, d0, fd, zs, xs, ys = args
    N, D, Hf, Wf, C = vol.shape
    nz, nx, ny = len(zs), len(xs), len(ys)
    out = torch.empty((N, nz, nx, ny, C), dtype=vol.dtype, device=vol.device)
    err = load_library("frustum_to_voxel").snvc_frustum_to_voxel(
        *(a.data_ptr() for a in args), out.data_ptr(), N, D, Hf, Wf, C, nz,
        nx, ny, 4.0, tile_x, lanes, ncol,
        0 if vol.dtype == torch.bfloat16 else 1,
        torch.cuda.current_stream(vol.device).cuda_stream)
    assert err == 0, err
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile_x,lanes,ncol", [
    (4, 1, 0), (4, 3, 6), (5, 2, 7), (12, 4, 26), (16, 1, 18), (7, 16, 64)])
def test_k4_kernel_tiles_across_image_edges_match_plain_on_card(
        cuda_device, dtype, tile_x, lanes, ncol):
    """x tiles that straddle the image's left and right edges (the case's
    columns run outside on both sides), staged (ncol >= the window) and
    direct (ncol 0) tiles, N = 2 with per-sample calibration: the same bits
    as the wrapper's tiling, and the plain version's rule of
    test_k4_kernel_matches_plain_on_card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    vol, P, depths, zs, xs, ys = _case(6, N=2)
    d0, fd = frustum_tables(depths, zs)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (vol, P, d0, fd, zs, xs, ys)]
    args[0] = args[0].to(dtype)
    got = _k4_launch(args, tile_x, lanes, ncol)
    shipped = frustum_to_voxel_k4(*args, 4)
    want = frustum_to_voxel_separable(*args, 4).float()
    torch.cuda.synchronize()
    assert torch.equal(got, shipped)
    tol = 4 * 2.0 ** -23 if dtype == torch.float32 else 2 * 2.0 ** -7
    assert bool(((got.float() - want).abs() <= tol * want.abs().max()).all())


# ---------------------------------------------------------- backward ----
# JAX gives K4 a custom VJP (frustum_pallas.py:271-289): the XLA VJP of the
# gather form, with respect to the volume and P.  The port's backward with
# respect to the volume is held to it here, P's in
# tests/test_torch_frustum_dp.py.  Float32;
# the gather form projects with a matmul and its weights round otherwise,
# as for the forward: atol 2e-4 of scale.


def _grad_case(seed, N=2):
    vol, P, depths, zs, xs, ys = _case(seed, N)
    g = np.random.default_rng(seed).standard_normal(
        (N, len(zs), len(xs), len(ys), vol.shape[-1])).astype(np.float32)
    return vol, P, depths, zs, xs, ys, g


def _tables(depths, zs, xs, ys, P, device="cpu"):
    d0, fd = frustum_tables(depths, zs)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (P, d0, fd, zs, xs, ys)]


def test_k4_plain_backward_matches_jax_vjp():
    import jax

    from snvc_tpu.ops.frustum_pallas import frustum_to_voxel_pallas_diff

    vol, P, depths, zs, xs, ys, g = _grad_case(7)
    _, vjp = jax.vjp(lambda v: frustum_to_voxel_pallas_diff(
        v, jnp.asarray(P), depths, zs, xs, ys, 4, interpret=True),
        jnp.asarray(vol))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = frustum_to_voxel_separable_bwd(
        torch.from_numpy(g), *_tables(depths, zs, xs, ys, P),
        vol.shape[1:4], 4).numpy()
    assert got.shape == vol.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-4 * np.abs(want).max())


def test_k4_plain_backward_matches_autograd():
    vol, P, depths, zs, xs, ys, g = _grad_case(8)
    tabs = _tables(depths, zs, xs, ys, P)
    vt = torch.from_numpy(vol).requires_grad_()
    out = frustum_to_voxel_separable(vt, *tabs, 4)
    (want,) = torch.autograd.grad(out, (vt,), torch.from_numpy(g))
    got = frustum_to_voxel_separable_bwd(torch.from_numpy(g), *tabs,
                                         vol.shape[1:4], 4)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max())


def test_k4_wrapper_on_cpu_carries_gradients():
    """``FrustumK4``: the output has a graph, its backward is the plain
    backward, uncounted; a P that requires a gradient gets
    ``frustum_to_voxel_dP``'s, and the volume's is unchanged."""
    vol, P, depths, zs, xs, ys, g = _grad_case(9)
    tabs = _tables(depths, zs, xs, ys, P)
    vt = torch.from_numpy(vol).requires_grad_()
    before = frustum_to_voxel_k4_bwd.launches
    out = frustum_to_voxel_k4(vt, *tabs, 4)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    want = frustum_to_voxel_separable_bwd(torch.from_numpy(g), *tabs,
                                          vol.shape[1:4], 4)
    assert torch.equal(vt.grad, want)
    assert frustum_to_voxel_k4_bwd.launches == before
    vt.grad = None
    tabs[0].requires_grad_()
    frustum_to_voxel_k4(vt, *tabs, 4).backward(torch.from_numpy(g))
    assert torch.equal(vt.grad, want)
    assert torch.equal(tabs[0].grad, frustum_to_voxel_dP(
        torch.from_numpy(g), vt, *tabs, 4))
    assert frustum_to_voxel_k4_bwd.launches == before


def test_k4_bwd_tiling():
    """The training shape (C = 32): 2 float4 slots a thread of 256, so 64
    columns a block (5 tiles of the 312) and 2 feature rows (48 pairs) of
    each of the 64 planes; for 120 x cells staged at once (a far row's
    ~112 cells of a tile whole) the float32 v-hat sums of the 2 rows (30
    KB) and the u hat, the block's float32 output sums (16 KB)
    and the tables of 16 BEV rows (with each column's run of staged cells)
    in shared memory, 56,320 bytes, so 4 blocks fit an SM's 228 KB; the
    plan's grid: one block a plane, an int a feature row.  Other widths
    change the tile (C / 4 float4 a column) and the staged x cells (30 KB
    / 8C); C that is no multiple of 8 or exceeds a block, tables past
    shared memory and grids past 65535 raise."""
    from snvc_tpu_torch.ops.frustum import (
        SMEM_LIMIT,
        k4_bwd_smem,
        k4_bwd_tiling,
    )

    t = k4_bwd_tiling(1, 64, 96, 312, 32, 288, 20)
    assert (t.tw, t.xcap) == (64, 120)
    assert t.grid == (5, 48, 64) and t.blocks == 5 * 48 * 64
    assert t.smem == k4_bwd_smem(120, 32, 20, 64) == (
        120 * (256 + 16) + 2 * 64 * 128 + 16 * (16 + 24 + 160 + 256))
    assert 4 * (t.smem + 1024) <= 233472
    assert t.plan_grid == (64, 1) and t.plan_smem == 4 * 96
    t = k4_bwd_tiling(2, 6, 15, 24, 8, 10, 4)
    assert (t.tw, t.xcap, t.grid) == (256, 480, (1, 8, 12))
    assert t.plan_grid == (6, 2)
    t = k4_bwd_tiling(1, 6, 16, 96, 16, 10, 4)
    assert (t.tw, t.xcap, t.grid) == (128, 240, (1, 8, 6))
    assert t.smem == k4_bwd_smem(240, 16, 4, 128)
    # the card tests' chunked pieces (3 cells staged at once) and a piece
    # past shared memory, which the C entry point refuses
    assert k4_bwd_smem(3, 16, 4, 128) == (
        3 * (128 + 16) + 2 * 128 * 64 + 16 * (16 + 24 + 32 + 512))
    assert k4_bwd_smem(1024, 32, 20, 64) > SMEM_LIMIT
    with pytest.raises(ValueError, match="multiple of 8"):
        k4_bwd_tiling(1, 6, 16, 24, 12, 10, 4)
    with pytest.raises(ValueError, match="at most 1024"):
        k4_bwd_tiling(1, 6, 16, 24, 2048, 10, 4)
    with pytest.raises(ValueError, match="shared memory"):
        k4_bwd_tiling(1, 64, 96, 312, 32, 288, 2000)
    with pytest.raises(ValueError, match="65535"):
        k4_bwd_tiling(2, 40000, 96, 312, 32, 288, 20)


def _stereo_tables(N=1):
    """StereoConfig()'s BEV axes and planes at the default calibration
    (the stereo training path's K4), as numpy."""
    from snvc_tpu_torch.config import StereoConfig
    from snvc_tpu_torch.geometry.calib import Calibration
    from snvc_tpu_torch.models.stereonet import _bev_axes, depth_hypotheses

    cfg = StereoConfig()
    zs, xs, ys = (np.asarray(a, np.float32) for a in _bev_axes(cfg))
    P = np.tile(Calibration.default().as_array()[None], (N, 1, 1))
    depth_hw = (cfg.num_depths, cfg.input_size[0] // 4,
                cfg.input_size[1] // 4)
    return P, depth_hypotheses(cfg), zs, xs, ys, depth_hw


def _plan_brute_force(u, v, d0, fd, depth_hw):
    """Each plane's BEV rows and the feature rows receiving any gradient,
    counted tap by tap with the plain version's hat (``_hat`` > 0)."""
    from snvc_tpu_torch.ops.frustum import _hat

    D, Hf, Wf = depth_hw
    N, nz = u.shape[:2]
    zr = np.zeros((N, D, 2), np.int32)
    work = np.zeros((N, D, Hf), np.uint8)
    for n in range(N):
        rows = []  # per z: the feature rows its taps reach
        for z in range(nz):
            x_in = bool((_hat(u[n, z], Wf) > 0).any())
            hits = (_hat(v[n, z], Hf) > 0).numpy().any(0)
            rows.append(hits & x_in)
        for d in range(D):
            reach = []
            for z in range(nz):
                dz = min(max(int(d0[z]), 0), D - 2)
                w = (1.0 - fd[z]) if dz == d else fd[z] if dz + 1 == d else 0
                if w != 0:
                    reach.append(z)
                    work[n, d] |= rows[z]
            zr[n, d] = (reach[0], reach[-1]) if reach else (0, -1)
    return zr, work


@pytest.mark.parametrize("case", ["small", "stereo"])
def test_k4_bwd_plan_matches_brute_force(case):
    """The plan's plane ranges and its (sample, plane, feature row) work
    list (``k4_bwd_plan``, what the plan kernel computes) against a tap-by-
    tap count: the small case (depths past both ends of the planes, per-
    sample calibration) and StereoConfig() at the default calibration,
    where 2,112 of the 6,144 (plane, row) pairs receive gradient, the
    near planes over most rows and the farthest over rows 42-54 only."""
    from snvc_tpu_torch.ops.frustum import frustum_to_voxel_k4_bwd_plan

    if case == "small":
        vol, P, depths, zs, xs, ys = _case(12, N=2)
        depth_hw = vol.shape[1:4]
    else:
        P, depths, zs, xs, ys, depth_hw = _stereo_tables()
    d0, fd = frustum_tables(depths, zs)
    u, v, zr, work = frustum_to_voxel_k4_bwd_plan(
        *_tables(depths, zs, xs, ys, P), depth_hw, 4)
    want_zr, want_work = _plan_brute_force(u, v, d0, fd, depth_hw)
    assert zr.dtype == torch.int32 and work.dtype == torch.uint8
    np.testing.assert_array_equal(zr.numpy(), want_zr)
    np.testing.assert_array_equal(work.numpy(), want_work)
    if case == "small":
        assert 0 < int(work.sum()) < work.numel()
    else:
        assert int(work.sum()) == 2112
        assert np.flatnonzero(want_work[0, -1]).tolist() == list(range(42, 55))
        assert zr[0, 0].tolist() == [0, 4] and zr[0, -1].tolist() == [283, 287]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [1, 2])
def test_k4_backward_kernel_matches_plain_on_card(cuda_device, dtype, N):
    """The kernel adds each tap's (wz * wu * wv) * g to one float32 sum;
    the plain version sums over x, then y, then the rows: bf16 within two
    ulp of the largest value, float32 within 1e-5 of it.  The case's
    columns and rows run off the image and its depths past both ends of
    the planes; N = 2 has per-sample calibration."""
    torch.backends.cuda.matmul.allow_tf32 = False
    vol, P, depths, zs, xs, ys, g = _grad_case(10, N)
    tabs = _tables(depths, zs, xs, ys, P, cuda_device)
    gt = torch.from_numpy(g).to(cuda_device, dtype)
    got = frustum_to_voxel_k4_bwd(gt, *tabs, vol.shape[1:4], 4).float()
    want = frustum_to_voxel_separable_bwd(gt, *tabs, vol.shape[1:4],
                                          4).float()
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2 * 2.0 ** -7
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.cuda
def test_k4_carries_gradients_on_card(cuda_device):
    vol, P, depths, zs, xs, ys, g = _grad_case(11)
    tabs = _tables(depths, zs, xs, ys, P, cuda_device)
    vt = torch.from_numpy(vol).to(cuda_device).requires_grad_()
    before = frustum_to_voxel_k4_bwd.launches
    out = frustum_to_voxel_k4(vt, *tabs, 4)
    assert out.grad_fn is not None
    gt = torch.from_numpy(g).to(cuda_device)
    out.backward(gt)
    assert frustum_to_voxel_k4_bwd.launches == before + 1
    want = frustum_to_voxel_separable_bwd(gt, *tabs, vol.shape[1:4], 4)
    assert float((vt.grad - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["small", "stereo"])
def test_k4_bwd_plan_kernel_matches_plain_on_card(cuda_device, case):
    """The plan kernel projects u and v with the forward's round-to-
    nearest order, the bits of ``_project_uv`` on the card, and finds the
    plain plan's plane ranges and work list exactly."""
    from snvc_tpu_torch.ops.frustum import (
        _project_uv,
        frustum_to_voxel_k4_bwd_plan,
        k4_bwd_plan,
    )

    if case == "small":
        vol, P, depths, zs, xs, ys = _case(13, N=2)
        depth_hw = vol.shape[1:4]
    else:
        P, depths, zs, xs, ys, depth_hw = _stereo_tables(N=2)
        P[1, 0, 3] += 3.0
    tabs = _tables(depths, zs, xs, ys, P, cuda_device)
    u, v, zr, work = frustum_to_voxel_k4_bwd_plan(*tabs, depth_hw, 4)
    want_u, want_v = _project_uv(tabs[0], *tabs[3:], 4)
    want_zr, want_work = k4_bwd_plan(want_u, want_v, tabs[1], tabs[2],
                                     depth_hw)
    torch.cuda.synchronize()
    assert torch.equal(u, want_u) and torch.equal(v, want_v)
    assert torch.equal(zr, want_zr) and torch.equal(work, want_work)


def _near_case(seed, N=2):
    """Planes over 1.5-12 m but BEV rows at 2-5 m only (the planes past
    ~5.5 m receive nothing), 6 BEV y cells on a 32-row image (most feature
    rows receive nothing), and near rows: an x cell spans up to 25 of the
    96 columns.  C = 16; per-sample calibration."""
    rng = np.random.default_rng(seed)
    depths = np.linspace(1.5, 12.0, 8).astype(np.float32)
    zs = (2.0 + np.arange(12) * 0.25).astype(np.float32)
    xs = (-3.0 + (np.arange(13) + 0.5) * 0.5).astype(np.float32)
    ys = (-0.3 + (np.arange(6) + 0.5) * 0.1).astype(np.float32)
    P = np.tile(np.array([[400.0, 0, 192.0, 1.0], [0, 400.0, 64.0, -0.2],
                          [0, 0, 1, 0.003]], np.float32)[None], (N, 1, 1))
    P[1:, 0, 3] += 30.0
    g = rng.standard_normal((N, len(zs), len(xs), len(ys), 16)).astype(
        np.float32)
    return P, depths, zs, xs, ys, g, (8, 32, 96)


def _k4_bwd_launch(gt, tabs, depth_hw, xcap):
    """K4's backward through its C entry points at an explicit number of
    staged x cells: (the main entry point's error code, the output)."""
    from snvc_tpu_torch._build import load_library
    from snvc_tpu_torch.ops.frustum import _k4_bwd_plan_scratch

    N, nz, nx, ny, C = gt.shape
    D, Hf, Wf = depth_hw
    lib = load_library("frustum_to_voxel")
    stream = torch.cuda.current_stream(gt.device).cuda_stream
    scratch = _k4_bwd_plan_scratch(lib, *tabs, depth_hw, 4, stream)
    dvol = torch.full((N, D, Hf, Wf, C), float("nan"), dtype=gt.dtype,
                      device=gt.device)
    err = lib.snvc_frustum_to_voxel_bwd(
        gt.data_ptr(), tabs[1].data_ptr(), tabs[2].data_ptr(),
        scratch.data_ptr(), dvol.data_ptr(), N, D, Hf, Wf, C, nz, nx, ny,
        xcap, 0 if gt.dtype == torch.bfloat16 else 1, stream)
    return err, dvol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("xcap", [256, 3, 1])
def test_k4_backward_kernel_empty_and_near_rows_on_card(cuda_device, dtype,
                                                        xcap):
    """Planes no BEV row reaches and feature rows no y cell reaches (the
    plan's zero rows, written as zeros over a NaN-filled output), near
    rows whose x cells span many columns, several rows' cells packed into
    one piece (xcap 256) and the x cells staged in chunks (xcap 1 and 3),
    against the plain version under the rule of
    test_k4_backward_kernel_matches_plain_on_card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    P, depths, zs, xs, ys, g, depth_hw = _near_case(14)
    tabs = _tables(depths, zs, xs, ys, P, cuda_device)
    gt = torch.from_numpy(g).to(cuda_device, dtype)
    err, got = _k4_bwd_launch(gt, tabs, depth_hw, xcap)
    assert err == 0, err
    got = got.float()
    want = frustum_to_voxel_separable_bwd(gt, *tabs, depth_hw, 4).float()
    torch.cuda.synchronize()
    empty_planes = want.abs().amax(dim=(0, 2, 3, 4)) == 0
    empty_rows = want.abs().amax(dim=(3, 4)) == 0
    assert bool(empty_planes.any()) and bool(empty_rows[:, ~empty_planes].any())
    tol = 1e-5 if dtype == torch.float32 else 2 * 2.0 ** -7
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.cuda
def test_k4_backward_entry_refuses_bad_staging_on_card(cuda_device):
    """The main entry point refuses staged x cells whose sums exceed a
    block's shared memory (1600 at C = 16, as k4_bwd_smem counts them)
    and a piece of no cells, and launches nothing."""
    from snvc_tpu_torch.ops.frustum import SMEM_LIMIT, k4_bwd_smem

    P, depths, zs, xs, ys, g, depth_hw = _near_case(14)
    assert k4_bwd_smem(1600, 16, len(ys), 128) > SMEM_LIMIT
    tabs = _tables(depths, zs, xs, ys, P, cuda_device)
    gt = torch.from_numpy(g).to(cuda_device)
    for xcap in (1600, 0):
        err, dvol = _k4_bwd_launch(gt, tabs, depth_hw, xcap)
        torch.cuda.synchronize()
        assert err != 0, xcap
        assert bool(dvol.isnan().all()), xcap
