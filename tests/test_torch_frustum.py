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
# gather form, with respect to the volume and P.  The port's backward is
# with respect to the volume only (no path differentiates P).  Float32;
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
    backward, uncounted; a P that requires a gradient raises."""
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
    tabs[0].requires_grad_()
    with pytest.raises(NotImplementedError, match="P_mat"):
        frustum_to_voxel_k4(vt, *tabs, 4)
    with torch.no_grad():  # no graph, nothing to refuse
        frustum_to_voxel_k4(vt, *tabs, 4)


def test_k4_bwd_tiling():
    """The training shape: 2 threads of 16 channels a column, 64 columns a
    block, one block's tables (288 rows x 20 cells) in shared memory;
    tables past shared memory, grids past 65535 planes and channels past a
    block's threads raise."""
    from snvc_tpu_torch.ops.frustum import k4_bwd_smem, k4_bwd_tiling

    t = k4_bwd_tiling(1, 64, 96, 312, 32, 288, 20)
    assert t.block == (2, 64) and t.smem == k4_bwd_smem(288, 20) == 28800
    assert t.blocks == 64 * 96 * 5
    assert k4_bwd_tiling(1, 6, 16, 24, 8, 10, 4).block == (1, 24)
    assert k4_bwd_tiling(1, 6, 16, 24, 40, 10, 4).block == (3, 24)
    with pytest.raises(ValueError, match="shared memory"):
        k4_bwd_tiling(1, 64, 96, 312, 32, 4000, 20)
    with pytest.raises(ValueError, match="65535"):
        k4_bwd_tiling(2, 40000, 96, 312, 32, 288, 20)
    with pytest.raises(ValueError, match="threads"):
        k4_bwd_tiling(1, 64, 96, 312, 4096, 288, 20)


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
