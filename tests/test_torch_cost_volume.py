"""The port's plane-sweep cost volume (snvc_tpu_torch/ops/cost_volume.py)
against the JAX package: the gather form against ``plane_sweep_volume`` /
``_plane_sweep_xla_any``, and the plain version of kernel K3
(``plane_sweep_shifted``) against both the gather form and the Pallas
kernel run by the Pallas interpreter (``_psv_pallas_fwd(interpret=True)``),
with shared [D] and per-sample [N, D] shift tables.  The shifts reuse the
edge cases of tests/test_cost_volume.py: zero, integer, fractional, and
shifts that push taps off the left edge or past the whole row.

Float32.  The gather form rounds x - s before the floor, the kernel
contract splits s itself, so the two differ by an ulp of the column index
(W <= 32 here: ~4e-6 per unit of feature); atol 1e-5 as the JAX tests use.
The kernel's wrapper on a CPU tensor is the plain version and leaves its
launch counter alone; a CUDA test compares the kernel with its plain
version on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snvc_tpu.ops.cost_volume import (
    _plane_sweep_xla_any as jax_any,
    _psv_pallas_fwd,
    plane_sweep_volume as jax_psv,
)
from snvc_tpu_torch.ops.cost_volume import (
    _plane_sweep_xla_any,
    build_cost_volume,
    plane_sweep_shifted,
    plane_sweep_shifted_bwd,
    plane_sweep_volume,
    plane_sweep_volume_k3,
    plane_sweep_volume_k3_bwd,
)

SHARED = np.array([0.0, 1.0, 2.5, 7.25, 21.9], np.float32)


def _features(seed, N=2, H=8, W=24, C=16):
    rng = np.random.default_rng(seed)
    left = rng.standard_normal((N, H, W, C)).astype(np.float32)
    right = rng.standard_normal((N, H, W, C)).astype(np.float32)
    return left, right


def _per_sample(seed, N, W, past_row=True):
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.0, W - 2, size=(N, 4)).astype(np.float32)
    s[0, 0] = 0.0
    s[-1, 1] = 3.0  # integer
    if past_row:  # the right half is all zeros
        s[-1, 2] = W + 5.5
    return s


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


@pytest.mark.parametrize("downsample", [1, 2])
def test_gather_form_matches_jax(downsample):
    left, right = _features(0)
    want = np.asarray(jax_psv(left, right, jnp.asarray(SHARED), downsample))
    got = plane_sweep_volume(*_t(left, right, SHARED), downsample).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_gather_form_per_sample_matches_jax():
    left, right = _features(1, N=3)
    shifts = _per_sample(1, 3, 24)
    want = np.asarray(jax_any(left, right, jnp.asarray(shifts), 1))
    got = _plane_sweep_xla_any(*_t(left, right, shifts), 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("per_sample", [False, True])
def test_k3_plain_matches_pallas_interpret(per_sample):
    """The Pallas kernel pads the row by W zeros, so its shifts stay below
    W (a larger one slices outside its buffer)."""
    left, right = _features(2, N=3)
    shifts = _per_sample(2, 3, 24, past_row=False) if per_sample else SHARED
    want = np.asarray(_psv_pallas_fwd(jnp.asarray(left), jnp.asarray(right),
                                      jnp.asarray(shifts), interpret=True))
    got = plane_sweep_shifted(*_t(left, right, shifts)).numpy()
    assert got.shape == want.shape == (3, shifts.shape[-1], 8, 24, 32)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("per_sample", [False, True])
def test_k3_plain_matches_gather_form(per_sample):
    left, right = _features(3, N=3)
    shifts = _per_sample(3, 3, 24) if per_sample else SHARED
    want = np.asarray(jax_any(left, right, jnp.asarray(shifts), 1))
    got = plane_sweep_shifted(*_t(left, right, shifts)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_k3_plain_rounds_once_in_bf16():
    """bf16 features: the right half is lerped in float32 from the bf16
    taps and rounded once, the left half is copied bit for bit."""
    left, right = _features(4)
    lt, rt = (t.bfloat16() for t in _t(left, right))
    s = torch.from_numpy(SHARED)
    got = plane_sweep_shifted(lt, rt, s)
    assert got.dtype == torch.bfloat16
    want = plane_sweep_shifted(lt.float(), rt.float(), s).bfloat16()
    assert torch.equal(got, want)


def test_k3_wrapper_on_cpu_is_plain_and_uncounted():
    left, right = _features(5)
    shifts = _per_sample(5, 2, 24)
    before = plane_sweep_volume_k3.launches
    got = plane_sweep_volume_k3(*_t(left, right, shifts))
    assert torch.equal(got, plane_sweep_shifted(*_t(left, right, shifts)))
    assert torch.equal(build_cost_volume(*_t(left, right, shifts), 1), got)
    assert plane_sweep_volume_k3.launches == before


def test_k3_rejects_negative_shift():
    left, right = _features(6)
    with pytest.raises(ValueError, match=">= 0"):
        plane_sweep_volume_k3(*_t(left, right,
                                  np.array([0.5, -1.0], np.float32)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_sample", [False, True])
def test_k3_kernel_matches_plain_on_card(cuda_device, dtype, per_sample):
    left, right = _features(7, N=2)
    shifts = _per_sample(7, 2, 24) if per_sample else SHARED
    lt, rt, st = (t.to(cuda_device) for t in _t(left, right, shifts))
    lt, rt = lt.to(dtype), rt.to(dtype)
    got = plane_sweep_volume_k3(lt, rt, st)
    want = plane_sweep_shifted(lt, rt, st)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_k3_kernel_negative_shift_reads_in_bounds(cuda_device):
    """A CUDA table is not read back for its sign; the kernel zeroes taps
    right of the row as well, matching the gather form's zeros outside."""
    left, right = _features(8, N=2)
    shifts = np.array([-0.5, -3.25, -30.0, 1.5], np.float32)
    lt, rt, st = (t.to(cuda_device) for t in _t(left, right, shifts))
    got = plane_sweep_volume_k3(lt, rt, st)
    want = plane_sweep_volume(lt, rt, st)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def _k3_launch(left, right, shifts, block_y, planes):
    """K3 through its C entry point at an explicit tiling."""
    from snvc_tpu_torch._build import load_library

    N, H, W, C = left.shape
    D = shifts.shape[-1]
    out = torch.empty((N, D, H, W, 2 * C), dtype=left.dtype,
                      device=left.device)
    err = load_library("plane_sweep_volume").snvc_plane_sweep_volume(
        left.data_ptr(), right.data_ptr(), shifts.data_ptr(), out.data_ptr(),
        N, D, H, W, C, 0 if shifts.ndim == 1 else D, block_y, planes,
        0 if left.dtype == torch.bfloat16 else 1,
        torch.cuda.current_stream(left.device).cuda_stream)
    assert err == 0, err
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_y,planes", [(16, 4), (64, 8), (7, 3),
                                            (37, 13), (1, 1)])
def test_k3_kernel_ragged_tilings_match_plain_on_card(cuda_device, dtype,
                                                      block_y, planes):
    """W = 37 and D = 13 are multiples of no tile: the last column pass and
    the last plane group of a row are partial; N = 2 with a per-sample
    table whose second row holds the edge shifts (0, integers, past the
    row)."""
    left, right = _features(9, N=2, H=5, W=37, C=16)
    rng = np.random.default_rng(9)
    shifts = rng.uniform(0.0, 37.0, size=(2, 13)).astype(np.float32)
    shifts[1, :7] = [0.0, 1.0, 2.5, 36.0, 37.0, 42.5, 111.25]
    lt, rt, st = (t.to(cuda_device) for t in _t(left, right, shifts))
    lt, rt = lt.to(dtype), rt.to(dtype)
    want = plane_sweep_shifted(lt, rt, st)
    got = _k3_launch(lt, rt, st, block_y, planes)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(plane_sweep_volume_k3(lt, rt, st), want)


# ---------------------------------------------------------- backward ----
# JAX gives K3 a custom VJP (``_psv_bwd``, snvc_tpu/ops/cost_volume.py:
# 160-169): the XLA VJP of the gather form, zeros for the shifts.  The
# port's plain backward is written as its kernel computes it; float32 on
# both sides, so the sums differ by rounding order and by the gather
# form's x - s rounding (as for the forward): atol 1e-5 of scale.  The
# Pallas forward slices outside its padding for a shift >= W (ROADMAP
# Queue 3), so the tables stay below W.


@pytest.mark.parametrize("per_sample", [False, True])
def test_k3_plain_backward_matches_jax_vjp(per_sample):
    import jax

    left, right = _features(10, N=3)
    shifts = _per_sample(10, 3, 24, past_row=False) if per_sample else SHARED
    g = np.random.default_rng(10).standard_normal(
        (3, shifts.shape[-1], 8, 24, 32)).astype(np.float32)
    _, vjp = jax.vjp(lambda l, r: jax_any(l, r, jnp.asarray(shifts), 1),
                     jnp.asarray(left), jnp.asarray(right))
    want = vjp(jnp.asarray(g))
    got = plane_sweep_shifted_bwd(*_t(g, shifts), 24)
    for a, b, name in zip(got, want, ("dleft", "dright")):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max(), err_msg=name)


@pytest.mark.parametrize("per_sample", [False, True])
def test_k3_plain_backward_matches_autograd(per_sample):
    """Against torch autograd of the plain forward, shifts past the row
    included (their taps are all zero)."""
    left, right = _features(11, N=2)
    shifts = _per_sample(11, 2, 24) if per_sample else SHARED
    lt, rt = (t.requires_grad_() for t in _t(left, right))
    out = plane_sweep_shifted(lt, rt, torch.from_numpy(shifts))
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(11))
    want = torch.autograd.grad(out, (lt, rt), g)
    got = plane_sweep_shifted_bwd(g, torch.from_numpy(shifts), 24)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * b.abs().max())


def test_k3_plain_backward_rounds_once_in_bf16():
    left, _ = _features(12)
    g = torch.randn((2, 5, 8, 24, 32),
                    generator=torch.Generator().manual_seed(12))
    s = torch.from_numpy(SHARED)
    got = plane_sweep_shifted_bwd(g.bfloat16(), s, 24)
    want = plane_sweep_shifted_bwd(g.bfloat16().float(), s, 24)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b.bfloat16())


def test_k3_wrapper_on_cpu_carries_gradients():
    """``PlaneSweepK3``: the output has a graph; the backward is the plain
    backward, uncounted; the shifts get no gradient."""
    left, right = _features(13)
    lt, rt = (t.requires_grad_() for t in _t(left, right))
    st = torch.from_numpy(_per_sample(13, 2, 24)).requires_grad_()
    before = plane_sweep_volume_k3_bwd.launches
    out = plane_sweep_volume_k3(lt, rt, st)
    assert out.grad_fn is not None
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(13))
    out.backward(g)
    want = plane_sweep_shifted_bwd(g, st.detach(), 24)
    assert torch.equal(lt.grad, want[0]) and torch.equal(rt.grad, want[1])
    assert st.grad is None
    assert plane_sweep_volume_k3_bwd.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("W,per_sample", [(24, False), (37, True)])
def test_k3_backward_kernel_matches_plain_on_card(cuda_device, dtype, W,
                                                  per_sample):
    """The kernel sums the planes in order, the plain version as torch
    reduces: bf16 within one ulp of the largest value, float32 within
    1e-5 of it.  W = 37 is off every column tile; the per-sample table
    holds 0, integers and shifts past the row."""
    rng = np.random.default_rng(14)
    N, D, H, C = 2, 9, 5, 16
    shifts = rng.uniform(0.0, W, size=(N, D)).astype(np.float32)
    shifts[1, :6] = [0.0, 1.0, 2.5, W - 1.0, W, 3.0 * W + 0.25]
    if not per_sample:
        shifts = shifts[1]
    g = torch.from_numpy(rng.standard_normal((N, D, H, W, 2 * C)).astype(
        np.float32)).to(cuda_device, dtype)
    st = torch.from_numpy(shifts).to(cuda_device)
    got = plane_sweep_volume_k3_bwd(g, st, W)
    want = plane_sweep_shifted_bwd(g, st, W)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    for a, b in zip(got, want):
        b = b.float()
        assert float((a.float() - b).abs().max()) <= tol * float(
            b.abs().max())


@pytest.mark.cuda
def test_k3_carries_gradients_on_card(cuda_device):
    """On the card the volume has a graph and its backward is the kernel:
    the features' gradients are the plain backward's."""
    left, right = _features(15)
    lt, rt = (t.to(cuda_device).requires_grad_() for t in _t(left, right))
    st = torch.from_numpy(_per_sample(15, 2, 24)).to(cuda_device)
    before = plane_sweep_volume_k3_bwd.launches
    out = plane_sweep_volume_k3(lt, rt, st)
    assert out.grad_fn is not None
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(15)
                    ).to(cuda_device)
    out.backward(g)
    assert plane_sweep_volume_k3_bwd.launches == before + 1
    for a, b in zip((lt.grad, rt.grad), plane_sweep_shifted_bwd(g, st, 24)):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
