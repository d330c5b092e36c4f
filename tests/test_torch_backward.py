"""Backward passes of the port's kernels, against ``jax.vjp`` of the JAX
functions whose VJP the JAX package uses:

K1  ``StereoVoxelSample`` (ops/stereo_sample_cuda.py) against the VJP of
    snvc_tpu.ops.grid_sample.sample_stereo_voxel (grid_sample_pallas.py:
    329-342), for both feature maps and both projection grids;
K2  ``conv3d_large_tap``'s ``Conv3dTaps`` (ops/conv3d_fold.py) against the
    VJP of conv3d_pertap_xla (conv3d_fold_pallas.py:285-292), with the
    flipped-weight identity of dx checked on its own;
K5  ``conv3d_k3`` (ops/conv3d_k3.py) against the VJP of conv3d_xla
    (conv3d_pallas.py:138-155).

On the CPU each Function's backward runs the kernels' plain versions
(dx as the SAME conv with flipped weights, dw as per-tap float32 sums,
dfeat as a float32 scatter-add).  Float32 throughout: the tolerances are
float32 summation-order noise, 1e-4 of each output's largest value.  The
``cuda`` tests hold the kernels to the plain versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snvc_tpu.ops.conv3d_fold_pallas import conv3d_pertap_xla
from snvc_tpu.ops.conv3d_pallas import conv3d_xla
from snvc_tpu.ops.grid_sample import sample_stereo_voxel as jax_sample
from snvc_tpu_torch.config import VernierConfig
from snvc_tpu_torch.data.synthetic import synthetic_batch_arrays
from snvc_tpu_torch.models.layers import Conv3d
from snvc_tpu_torch.ops.assemble import assemble_instances, make_grid_local
from snvc_tpu_torch.ops.conv3d_fold import (
    conv3d_input_grad,
    conv3d_large_tap,
    conv3d_pertap,
    conv3d_weight_grad,
    conv3d_weight_grad_plain,
    flip_weight,
    large_tap_eligible,
)
from snvc_tpu_torch.ops.conv3d_k3 import conv3d_k3, k3_eligible
from snvc_tpu_torch.ops.grid_sample import sample_stereo_voxel_bwd
from snvc_tpu_torch.ops.stereo_sample_cuda import (
    stereo_voxel_sample,
    stereo_voxel_sample_bwd,
)
from snvc_tpu_torch.training.train import batch_to_device


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max() + 1e-7)


# ---------------------------------------------------------------- K1 ----
def _k1(seed, N=2, Hf=12, Wf=16, C=8, grid=(3, 6, 5), roi=(48, 64)):
    rng = np.random.default_rng(seed)
    P = grid[0] * grid[1] * grid[2]
    lf = rng.standard_normal((N, Hf, Wf, C)).astype(np.float32)
    rf = rng.standard_normal((N, Hf, Wf, C)).astype(np.float32)
    # inside, on the edges and outside the ROI
    gl = rng.uniform(-6, roi[1] + 6, (N, P, 2)).astype(np.float32)
    gr = rng.uniform(-6, roi[1] + 6, (N, P, 2)).astype(np.float32)
    gl[:, ::9] = -30.0
    g = rng.standard_normal((N,) + grid + (2 * C,)).astype(np.float32)
    return (lf, rf, gl, gr), g, roi, grid


@pytest.mark.parametrize("seed", [0, 1])
def test_k1_backward_matches_jax_vjp(seed):
    args, g, roi, grid = _k1(seed)
    _, vjp = jax.vjp(lambda a, b, c, d: jax_sample(a, b, c, d, roi, grid),
                     *args)
    want = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    out = stereo_voxel_sample(*ts, roi, grid)
    out.backward(torch.from_numpy(g))
    for name, t, w in zip(("dleft", "dright", "dgrid_l", "dgrid_r"), ts,
                          want):
        _close(t.grad, w)


def test_k1_skips_grid_gradient_when_unused():
    args, g, roi, grid = _k1(2)
    lf, rf = (torch.from_numpy(a).requires_grad_() for a in args[:2])
    gl, gr = (torch.from_numpy(a) for a in args[2:])
    stereo_voxel_sample(lf, rf, gl, gr, roi, grid).backward(
        torch.from_numpy(g))
    assert lf.grad is not None and rf.grad is not None
    dl, dr, dpl, dpr = sample_stereo_voxel_bwd(lf.detach(), rf.detach(), gl,
                                               gr, torch.from_numpy(g), roi,
                                               need_grid=False)
    assert dpl is None and dpr is None
    assert torch.equal(dl, lf.grad) and torch.equal(dr, rf.grad)


def test_k1_backward_wrapper_on_cpu_is_plain_and_uncounted():
    args, g, roi, grid = _k1(3)
    ts = [torch.from_numpy(a) for a in args]
    before = stereo_voxel_sample_bwd.launches
    got = stereo_voxel_sample_bwd(*ts, torch.from_numpy(g), roi)
    want = sample_stereo_voxel_bwd(*ts, torch.from_numpy(g), roi)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert stereo_voxel_sample_bwd.launches == before


# ------------------------------------------------------------ K2 / K5 ----
def _conv(seed, shape, kernel, feats):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal(kernel + (shape[-1], feats)) * 0.1).astype(
        np.float32)
    g = rng.standard_normal(shape[:-1] + (feats,)).astype(np.float32)
    return x, w, g


CONV_CASES = [  # shape, kernel, dilation, features
    ((1, 8, 7, 9, 12), (7, 7, 7), 1, 6),    # conv1_k7-like, ragged
    ((2, 9, 8, 10, 8), (5, 5, 5), 2, 8),    # conv3_k5_d2-like
    ((1, 6, 5, 7, 8), (5, 3, 7), 1, 4),     # mixed odd taps
]


@pytest.mark.parametrize("shape,kernel,dil,feats", CONV_CASES)
def test_k2_backward_matches_jax_vjp(shape, kernel, dil, feats):
    x, w, g = _conv(0, shape, kernel, feats)
    _, vjp = jax.vjp(lambda a, b: conv3d_pertap_xla(a, b, dil), x, w)
    dx, dw = vjp(jnp.asarray(g))
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    out = conv3d_large_tap(xt, wt, dil)
    _close(out, conv3d_pertap_xla(x, w, dil))
    out.backward(torch.from_numpy(g))
    _close(xt.grad, dx)
    _close(wt.grad, dw)


@pytest.mark.parametrize("shape,kernel,dil,feats", CONV_CASES[:2])
def test_flipped_weight_identity_and_plain_dw(shape, kernel, dil, feats):
    """dx = SAME conv of g with the weights flipped in every tap and C <->
    F swapped; dw = per-tap sums; both equal the per-tap conv's own
    autograd."""
    x, w, g = _conv(1, shape, kernel, feats)
    xt, wt, gt = (torch.from_numpy(a) for a in (x, w, g))
    xr, wr = xt.clone().requires_grad_(), wt.clone().requires_grad_()
    conv3d_pertap(xr, wr, dil).backward(gt)
    _close(conv3d_input_grad(gt, wt, dil), xr.grad.numpy())
    _close(conv3d_weight_grad_plain(xt, gt, kernel, dil), wr.grad.numpy())
    assert torch.equal(conv3d_weight_grad(xt, gt, kernel, dil),
                       conv3d_weight_grad_plain(xt, gt, kernel, dil))


def test_k2_backward_bf16_rounds_like_jax():
    """bf16: dx and dw come back in bf16 (JAX's VJP of a bf16 conv), within
    the bf16 rounding of the float32 result."""
    x, w, g = _conv(2, (1, 6, 6, 8, 8), (5, 5, 5), 8)
    xb, wb, gb = (torch.from_numpy(a).bfloat16() for a in (x, w, g))
    xt, wt = xb.clone().requires_grad_(), wb.clone().requires_grad_()
    conv3d_large_tap(xt, wt, 1).backward(gb)
    assert xt.grad.dtype == wt.grad.dtype == torch.bfloat16
    _, vjp = jax.vjp(lambda a, b: conv3d_pertap_xla(a, b, 1),
                     *(np.asarray(t.float()) for t in (xb, wb)))
    dx, dw = vjp(jnp.asarray(gb.float().numpy()))
    _close(xt.grad.float(), dx, rel=2.0 ** -6)
    _close(wt.grad.float(), dw, rel=2.0 ** -6)


@pytest.mark.parametrize("shape", [(1, 4, 8, 16, 16), (2, 5, 6, 7, 12)])
def test_k5_forward_and_backward_match_jax(shape):
    x, w, g = _conv(3, shape, (3, 3, 3), 8)
    _, vjp = jax.vjp(conv3d_xla, x, w)
    dx, dw = vjp(jnp.asarray(g))
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    before = conv3d_k3.launches
    out = conv3d_k3(xt, wt)
    _close(out, conv3d_xla(x, w))
    out.backward(torch.from_numpy(g))
    _close(xt.grad, dx)
    _close(wt.grad, dw)
    assert conv3d_k3.launches == before


def test_conv3d_dispatch_predicates():
    """bf16 large-tap convs go to K2 and bf16 k3 convs (pallas="auto") to
    K5; float32 goes to F.conv3d (the kernels take bf16 only)."""
    for k in ((7, 7, 7), (5, 5, 5), (5, 3, 7)):
        assert large_tap_eligible(k, (1, 1, 1), torch.bfloat16)
        assert not large_tap_eligible(k, (1, 1, 1), torch.float32)
    assert k3_eligible((3, 3, 3), (1, 1, 1), 1, torch.bfloat16)
    assert not k3_eligible((3, 3, 3), (1, 1, 1), 1, torch.float32)
    assert not k3_eligible((3, 3, 3), (1, 1, 1), 2, torch.bfloat16)
    assert not k3_eligible((3, 3, 3), (2, 2, 2), 1, torch.bfloat16)
    assert not k3_eligible((5, 5, 5), (1, 1, 1), 1, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3d_module_routes_by_dtype(dtype, monkeypatch):
    """A float32 Conv3d never reaches the K2 / K5 wrappers (on the card
    they raise for float32); a bf16 one does."""
    import snvc_tpu_torch.models.layers as layers

    calls = []
    monkeypatch.setattr(layers, "conv3d_large_tap",
                        lambda x, w, d: calls.append("K2") or
                        conv3d_pertap(x, w, d))
    monkeypatch.setattr(layers, "conv3d_k3",
                        lambda x, w: calls.append("K5") or
                        conv3d_pertap(x, w, 1))
    x = torch.randn((1, 5, 6, 7, 4), generator=torch.Generator()
                    .manual_seed(0)).to(dtype)
    for kernel, pallas in (((5, 5, 5), "never"), ((3, 3, 3), "auto"),
                           ((3, 3, 3), "never")):
        conv = Conv3d(4, 3, kernel, pallas=pallas)
        torch.nn.init.normal_(conv.weight, std=0.1)
        ref = torch.nn.functional.conv3d(
            x.float().permute(0, 4, 1, 2, 3), conv.weight,
            padding=tuple((k - 1) // 2 for k in kernel)).permute(0, 2, 3, 4, 1)
        _close(conv(x).float(), ref.detach().numpy(),
               rel=1e-4 if dtype == torch.float32 else 2.0 ** -5)
    want = [] if dtype == torch.float32 else ["K2", "K5"]
    assert calls == want


# ------------------------------------------------------------ on card ----
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_backward_kernel_matches_plain_on_card(cuda_device, dtype):
    args, g, roi, grid = _k1(4)
    ts = [torch.from_numpy(a).to(cuda_device) for a in args]
    ts[0], ts[1] = ts[0].to(dtype), ts[1].to(dtype)
    gt = torch.from_numpy(g).to(cuda_device, dtype)
    got = stereo_voxel_sample_bwd(*ts, gt, roi)
    want = sample_stereo_voxel_bwd(*(t.float() for t in ts), gt.float(), roi)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    for a, b in zip(got, want):
        err = (a.float() - b).abs()
        assert bool((err <= tol * b.abs() + 1e-4 * b.abs().max()).all())


def _k1_training_case(dev, case):
    """The training shape's K1 backward operands on the card: [8, 64, 64,
    32] features and a [8, 16, 96, 96, 64] gradient, at a seeded
    VernierConfig() batch's projections ("train") or with every point of
    an instance inside one 2x2 tap patch ("one_patch": the adds' worst
    contention)."""
    cfg = VernierConfig()
    N, grid, roi = cfg.max_instances, cfg.grid_resolution, cfg.resolution
    P = grid[0] * grid[1] * grid[2]
    rng = np.random.default_rng(8)
    if case == "train":
        b = batch_to_device(synthetic_batch_arrays(cfg, seed=0), dev)
        gl, gr = assemble_instances(
            b["images_left"], b["images_right"], b["image_idx"], b["trans_l"],
            b["trans_r"], b["samples"], b["P_left"], b["P_right"],
            torch.from_numpy(make_grid_local(cfg)).to(dev), cfg)[2:]
        gl, gr = gl.float().contiguous(), gr.float().contiguous()
    else:
        cells = rng.integers(0, 63, (2, N, 1, 2))
        gl, gr = (torch.from_numpy(((c + rng.uniform(0.05, 0.95, (N, P, 2))
                                     + 0.5) * roi[1] / 64).astype(np.float32))
                  .to(dev) for c in cells)
    lf, rf = (torch.from_numpy(rng.standard_normal((N, 64, 64, 32),
                                                   dtype=np.float32)).to(dev)
              for _ in range(2))
    g = torch.from_numpy(rng.standard_normal((N,) + grid + (64,),
                                             dtype=np.float32)).to(dev)
    return lf, rf, gl, gr, g, roi


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype", [
    ("train", torch.bfloat16), ("one_patch", torch.bfloat16),
    ("one_patch", torch.float32)])
def test_k1_backward_kernel_at_training_shape_on_card(cuda_device, case,
                                                      dtype):
    lf, rf, gl, gr, g, roi = _k1_training_case(cuda_device, case)
    lf, rf, g = lf.to(dtype), rf.to(dtype), g.to(dtype)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    for need_grid in (False, True):
        got = stereo_voxel_sample_bwd(lf, rf, gl, gr, g, roi,
                                      need_grid=need_grid)
        want = sample_stereo_voxel_bwd(lf.float(), rf.float(), gl, gr,
                                       g.float(), roi, need_grid=need_grid)
        for name, a, b in zip(("dleft", "dright", "dgrid_l", "dgrid_r"), got,
                              want):
            if b is None:
                assert a is None
                continue
            assert a.dtype == (dtype if name[1] != "g" else torch.float32)
            rel = tol if name[1] != "g" else 1e-5
            err = (a.float() - b).abs()
            assert bool((err <= rel * b.abs()
                         + 1e-4 * b.abs().max()).all()), \
                f"{name}: max err {err.max().item()}"


CARD_CASES = CONV_CASES + [
    ((1, 6, 12, 40, 64), (7, 7, 7), 1, 32),   # conv1_k7: dx is 32 -> 64
    ((1, 6, 20, 100, 32), (5, 5, 5), 2, 32),  # W off the tiles, dilation 2
    ((2, 9, 10, 70, 40), (5, 3, 7), 2, 24),   # the smoke run's ragged case
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kernel,dil,feats", CARD_CASES)
def test_k2_backward_kernels_match_plain_on_card(cuda_device, shape, kernel,
                                                 dil, feats):
    torch.backends.cudnn.allow_tf32 = False
    x, w, g = _conv(5, shape, kernel, feats)
    xt, wt, gt = (torch.from_numpy(a).to(cuda_device).bfloat16()
                  for a in (x, w, g))
    for got, ref in (
            (conv3d_input_grad(gt, wt, dil),
             conv3d_pertap(gt.float(), flip_weight(wt.float()), dil)),
            (conv3d_weight_grad(xt, gt, kernel, dil),
             conv3d_weight_grad_plain(xt.float(), gt.float(), kernel, dil))):
        err = (got.float() - ref).abs()
        assert bool((err <= 2.0 ** -7 * ref.abs()
                     + 1e-3 * ref.abs().max()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,feats", [
    ((1, 4, 8, 16, 128), 32),   # the JAX tests' shape
    ((1, 4, 8, 16, 32), 64),    # F 64 from C 32
    ((1, 5, 9, 70, 64), 32),    # W off the 32 / 64 tiles
])
def test_k5_kernel_matches_plain_on_card(cuda_device, shape, feats):
    torch.backends.cudnn.allow_tf32 = False
    x, w, g = _conv(6, shape, (3, 3, 3), feats)
    xt, wt, gt = (torch.from_numpy(a).to(cuda_device).bfloat16()
                  for a in (x, w, g))
    for got, ref in (
            (conv3d_k3(xt, wt), conv3d_pertap(xt.float(), wt.float(), 1)),
            (conv3d_input_grad(gt, wt, 1),
             conv3d_pertap(gt.float(), flip_weight(wt.float()), 1)),
            (conv3d_weight_grad(xt, gt, (3, 3, 3), 1),
             conv3d_weight_grad_plain(xt.float(), gt.float(), (3, 3, 3), 1))):
        err = (got.float() - ref).abs()
        assert bool((err <= 2.0 ** -7 * ref.abs()
                     + 1e-3 * ref.abs().max()).all())
