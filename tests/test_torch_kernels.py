"""The plain PyTorch versions of the port's two CUDA kernels against the
JAX package, and their wrappers' dispatch.

K1 (stereo voxel sampler): ``snvc_tpu_torch.ops.grid_sample`` against
``snvc_tpu.ops.grid_sample.sample_stereo_voxel`` and the Pallas kernel run
by the Pallas interpreter (``_sample_stereo_voxel_impl(interpret=True)``).
K2 (large-tap conv): ``snvc_tpu_torch.ops.conv3d_fold.conv3d_pertap``
against ``conv3d_pertap_xla`` and ``_fold_vmem_fwd(interpret=True)``.

Float32 throughout; tolerances are float32 noise, except against the
Pallas interpreter, whose hat-matmul sampler rounds its row-interpolated
features once more (2e-4, as tests/test_ops_sampling.py uses).

The tests marked ``cuda`` compare each kernel with its plain version on a
card; they need an NVIDIA GPU and nvcc and skip without them
(chip_smoke.py runs the same comparisons at the flagship shapes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snvc_tpu.ops.conv3d_fold_pallas import _fold_vmem_fwd, conv3d_pertap_xla
from snvc_tpu.ops.grid_sample import sample_stereo_voxel as jax_sample
from snvc_tpu.ops.grid_sample_pallas import _sample_stereo_voxel_impl
from snvc_tpu_torch import _build
from snvc_tpu_torch.ops.conv3d_fold import (
    conv3d_large_tap,
    conv3d_pertap,
    large_tap_eligible,
)
from snvc_tpu_torch.ops.grid_sample import sample_stereo_voxel
from snvc_tpu_torch.ops.stereo_sample_cuda import stereo_voxel_sample


def _k1_inputs(seed, N=2, Hf=16, Wf=16, C=8, grid=(4, 8, 8), roi=64):
    rng = np.random.default_rng(seed)
    P = grid[0] * grid[1] * grid[2]
    lf = rng.standard_normal((N, Hf, Wf, C)).astype(np.float32)
    rf = rng.standard_normal((N, Hf, Wf, C)).astype(np.float32)
    # ROI-pixel coordinates spanning in-image and out-of-image points
    gl = rng.uniform(-10, roi + 10, (N, P, 2)).astype(np.float32)
    gr = rng.uniform(-10, roi + 10, (N, P, 2)).astype(np.float32)
    gl[:, ::7] = -40.0  # far outside: all four taps are zero
    gr[:, 3::11, 1] = roi + 30.0
    return lf, rf, gl, gr, (roi, roi), grid


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("seed,roi", [(0, 64), (1, 48)])
def test_k1_plain_matches_jax_xla(seed, roi):
    lf, rf, gl, gr, roi_hw, grid = _k1_inputs(seed, roi=roi)
    want = np.asarray(jax_sample(lf, rf, gl, gr, roi_hw, grid))
    got = sample_stereo_voxel(*_torch(lf, rf, gl, gr), roi_hw, grid).numpy()
    assert got.shape == want.shape == (2,) + grid + (16,)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_k1_plain_matches_pallas_interpret():
    lf, rf, gl, gr, roi_hw, grid = _k1_inputs(2)
    want = np.asarray(_sample_stereo_voxel_impl(
        jnp.asarray(lf), jnp.asarray(rf), jnp.asarray(gl), jnp.asarray(gr),
        roi_hw, grid, interpret=True))
    got = sample_stereo_voxel(*_torch(lf, rf, gl, gr), roi_hw, grid).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def test_k1_wrapper_on_cpu_is_plain_and_uncounted():
    lf, rf, gl, gr, roi_hw, grid = _k1_inputs(3)
    before = stereo_voxel_sample.launches
    got = stereo_voxel_sample(*_torch(lf, rf, gl, gr), roi_hw, grid)
    want = sample_stereo_voxel(*_torch(lf, rf, gl, gr), roi_hw, grid)
    assert torch.equal(got, want)
    assert stereo_voxel_sample.launches == before


def _k2_inputs(seed, shape, kernel, feats):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal(kernel + (shape[-1], feats)) * 0.1).astype(
        np.float32)
    return x, w


K2_CASES = [  # shape, kernel, dilation, features
    ((1, 8, 8, 16, 32), (7, 7, 7), 1, 16),   # conv1_k7-like
    ((1, 10, 8, 12, 16), (5, 5, 5), 2, 8),   # conv3_k5_d2-like
]


@pytest.mark.parametrize("shape,kernel,dil,feats", K2_CASES)
def test_k2_plain_matches_jax_pertap(shape, kernel, dil, feats):
    x, w = _k2_inputs(0, shape, kernel, feats)
    want = np.asarray(conv3d_pertap_xla(x, w, dilation=dil))
    got = conv3d_pertap(*_torch(x, w), dil).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


@pytest.mark.parametrize("shape,kernel,dil,feats", K2_CASES)
def test_k2_plain_matches_pallas_interpret(shape, kernel, dil, feats):
    x, w = _k2_inputs(1, shape, kernel, feats)
    want = np.asarray(_fold_vmem_fwd(jnp.asarray(x), jnp.asarray(w),
                                     dilation=dil, interpret=True))
    got = conv3d_pertap(*_torch(x, w), dil).numpy()
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)


def test_k2_plain_ragged_h():
    """H not a multiple of 4 (the TPU kernel's row tile drops trailing rows
    there): the plain version equals the JAX per-tap conv on every row."""
    x, w = _k2_inputs(2, (1, 7, 10, 9, 8), (5, 5, 5), 8)
    want = np.asarray(conv3d_pertap_xla(x, w, dilation=1))
    got = conv3d_pertap(*_torch(x, w), 1).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def test_k2_wrapper_on_cpu_is_plain_and_uncounted():
    x, w = _k2_inputs(3, (1, 6, 5, 7, 8), (5, 5, 5), 4)
    before = conv3d_large_tap.launches
    got = conv3d_large_tap(*_torch(x, w), 2)
    assert torch.equal(got, conv3d_pertap(*_torch(x, w), 2))
    assert conv3d_large_tap.launches == before


def test_large_tap_eligibility():
    bf16 = torch.bfloat16
    assert large_tap_eligible((7, 7, 7), (1, 1, 1), bf16)
    assert large_tap_eligible((5, 3, 7), (1, 1, 1), bf16)
    assert not large_tap_eligible((3, 3, 3), (1, 1, 1), bf16)
    assert not large_tap_eligible((5, 5, 5), (2, 1, 1), bf16)
    assert not large_tap_eligible((6, 5, 5), (1, 1, 1), bf16)
    # the kernel takes bf16 only: a float32 conv goes to F.conv3d
    assert not large_tap_eligible((7, 7, 7), (1, 1, 1), torch.float32)


def test_build_keys_libraries_by_source():
    paths = {name: _build.library_path(name) for name in _build.LIBRARIES}
    assert set(_build.LIBRARIES) == {"stereo_voxel_sample", "conv3d_large_tap",
                                     "conv3d_weight_grad",
                                     "plane_sweep_volume", "frustum_to_voxel"}
    for name, path in paths.items():
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(f"lib{name}_") and path.suffix == ".so"
        assert _build.library_path(name) == path  # stable


def test_build_key_covers_shared_header(tmp_path, monkeypatch):
    """An edit to csrc/common.cuh rebuilds every library that includes it."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in _build.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {name: _build.library_path(name) for name in _build.LIBRARIES}
    with open(csrc / "common.cuh", "a") as fh:
        fh.write("// edited\n")
    for name in _build.LIBRARIES:
        assert _build.library_path(name) != before[name]


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No nvcc: the build raises; nothing falls back to a plain version."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_kernel_matches_plain_on_card(cuda_device, dtype):
    lf, rf, gl, gr, roi_hw, grid = _k1_inputs(4)
    args = [t.to(cuda_device) for t in _torch(lf, rf, gl, gr)]
    args[0], args[1] = args[0].to(dtype), args[1].to(dtype)
    got = stereo_voxel_sample(*args, roi_hw, grid).float()
    want = sample_stereo_voxel(*args, roi_hw, grid).float()
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    assert bool(((got - want).abs() <= tol * want.abs() + 1e-5).all())


K2_CARD_CASES = [  # shape, kernel, dilation, features
    ((1, 9, 10, 70, 40), (5, 3, 7), 2, 24),   # ragged C, F and W, dilation 2
    ((1, 8, 12, 40, 32), (7, 7, 7), 1, 64),   # F 64 from C 32 (conv1's dx)
    ((1, 6, 20, 100, 32), (5, 5, 5), 2, 32),  # W off the 32 / 64 tiles
    ((2, 5, 17, 33, 12), (5, 5, 5), 1, 10),   # C, F padded to 16
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kernel,dil,feats", K2_CARD_CASES)
def test_k2_kernel_matches_plain_on_card(cuda_device, shape, kernel, dil,
                                         feats):
    x, w = _k2_inputs(5, shape, kernel, feats)
    xt, wt = (t.to(cuda_device) for t in _torch(x, w))
    got = conv3d_large_tap(xt.bfloat16(), wt.bfloat16(), dil).float()
    torch.backends.cudnn.allow_tf32 = False
    ref = conv3d_pertap(xt.bfloat16().float(), wt.bfloat16().float(), dil)
    tol = 2.0 ** -7 * ref.abs() + 1e-3 * ref.abs().max()
    assert bool(((got - ref).abs() <= tol).all())
