"""The port's work count (snvc_tpu_torch/utils/cost.py), each kernel's
declared work, and ``RefineRunner.cost_stats`` / ``program_cost`` against
JAX's ``cost_stats`` / ``_compiled_cost`` (XLA's cost analysis) on the
CPU.

* Each kernel entry, forward and backward, declares the work of its
  shape formula (written out again here), and under ``count_cost`` its
  plain version counts exactly that declaration: its own aten ops are
  not counted.
* A SAME, a dilated, a strided and a transposed convolution count what
  XLA's cost analysis counts, exactly: 2 per multiply-add of the taps
  inside the input.
* A refinement step at ``_tiny_cfg(max_instances=2)`` and the StereoNet
  forward at ``tiny_stereo_config`` against the same converted weights in
  JAX.  JAX's conv and dot flops are XLA's count of each
  ``conv_general_dilated`` / ``dot_general`` of the traced programs.  On
  the CPU JAX runs a 3D conv as kd 2D convs over a depth-padded volume
  (layers.py ``Conv3d``'s per-tap path) and the k3 stride-2 deconv as 8
  parity convs over a volume padded by one plane (``ConvTranspose3dFast``),
  so XLA counts the taps on those padded planes as work; the port's
  ``F.conv3d`` / ``F.conv_transpose3d`` count only taps inside the volume.
  Counted under JAX's decomposition (all kd depth taps of each output
  plane, all three of a deconv's input plane), the port's convs equal
  JAX's to 1e-6 relative (measured: exactly).  The dots: the refinement
  step's equal JAX's; in the StereoNet forward JAX's K4 fallback projects
  the voxel centres with one [P, 3] x [3, 3] dot that is K4's declared
  work in the port, and the port's SPP upsampling is two einsums where JAX
  sums broadcast weights (stereo_backbone.py:60-80), so each side has one
  piece the other has not.
* The totals.  XLA adds flops for elementwise ops, which the port does
  not count: of JAX's total the refinement step's elementwise band is
  1.15 % (765.5 MFLOP total, 756.8 M conv and dot) and the StereoNet
  forward's 0.78 % (5888.5 MFLOP total).  XLA also drops the RPN conv of
  the right view, whose output JAX's encoder discards (stereonet.py:99);
  the port runs it, and counts it.
* ``bytes_accessed`` is held to its own rule, each op's inputs read and
  outputs written once, on a small program.  It is not XLA's figure,
  which is that of the fused program; the two come out close here: the
  port's count is 0.996x JAX's for the refinement step (64.03 MB against
  64.31 MB) and 1.071x for the StereoNet forward (248.9 MB against
  232.5 MB).
"""

import math

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.extend import core as jcore

import __graft_entry__
from snvc_tpu.geometry.calib import Calibration
from snvc_tpu.inference.refine import _compiled_cost
from snvc_tpu.models.vernier import scope_variables
from snvc_tpu_torch.data.synthetic import synthetic_batch_arrays
from snvc_tpu_torch.ops import conv3d_fold as k2
from snvc_tpu_torch.ops.conv3d_k3 import conv3d_k3
from snvc_tpu_torch.ops.cost_volume import (
    plane_sweep_shifted,
    plane_sweep_shifted_bwd,
    plane_sweep_volume_k3,
    plane_sweep_volume_k3_bwd,
)
from snvc_tpu_torch.ops.frustum import (
    frustum_tables,
    frustum_to_voxel_k4,
    frustum_to_voxel_k4_bwd,
    frustum_to_voxel_separable,
    frustum_to_voxel_separable_bwd,
)
from snvc_tpu_torch.ops.grid_sample import (
    sample_stereo_voxel,
    sample_stereo_voxel_bwd,
)
from snvc_tpu_torch.ops.stereo_sample_cuda import (
    stereo_voxel_sample,
    stereo_voxel_sample_bwd,
)
from snvc_tpu_torch.utils import cost
from snvc_tpu_torch.utils.cost import count_cost, program_cost

jax.config.update("jax_platforms", "cpu")


def _valid_taps(n, k, dil):
    """(output, tap) pairs of a SAME stride-1 conv along one axis whose
    input lies inside it, by brute force."""
    pad = (k - 1) // 2 * dil
    return sum(1 for o in range(n) for t in range(k)
               if 0 <= o + t * dil - pad < n)


def _randn(rng, shape, dtype=torch.float32):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dtype)


# ------------------------------------------------- kernel declarations ----
# Each case: (entry call, plain-version call, kernel name, flops, bytes).

def _k1(i):
    N, Hf, Wf, C, grid, dt = [(2, 4, 6, 8, (2, 3, 4), torch.float32),
                              (1, 5, 3, 16, (1, 2, 2), torch.bfloat16)][i]
    rng = np.random.default_rng(i)
    P = math.prod(grid)
    lf, rf = _randn(rng, (N, Hf, Wf, C), dt), _randn(rng, (N, Hf, Wf, C), dt)
    gl = torch.from_numpy(rng.uniform(-4, 36, (N, P, 2)).astype(np.float32))
    gr = torch.from_numpy(rng.uniform(-4, 36, (N, P, 2)).astype(np.float32))
    es = lf.element_size()
    out = N * P * 2 * C
    args = (lf, rf, gl, gr, (32, 32), grid)
    return (lambda: stereo_voxel_sample(*args),
            lambda: sample_stereo_voxel(*args), "K1", 8.0 * out,
            (2 * N * Hf * Wf * C + out) * es + 2 * N * P * 2 * 4)


def _k1_bwd(i):
    need_grid = bool(i)
    N, Hf, Wf, C, grid, dt = [(2, 4, 6, 8, (2, 3, 4), torch.float32),
                              (1, 5, 3, 16, (1, 2, 2), torch.bfloat16)][i]
    rng = np.random.default_rng(10 + i)
    P = math.prod(grid)
    lf, rf = _randn(rng, (N, Hf, Wf, C), dt), _randn(rng, (N, Hf, Wf, C), dt)
    gl = torch.from_numpy(rng.uniform(-4, 36, (N, P, 2)).astype(np.float32))
    gr = torch.from_numpy(rng.uniform(-4, 36, (N, P, 2)).astype(np.float32))
    g = _randn(rng, (N, *grid, 2 * C), dt)
    es = lf.element_size()
    ng = N * P * 2 * C
    feats, grids = 2 * N * Hf * Wf * C * es, 2 * N * P * 2 * 4
    args = (lf, rf, gl, gr, g, (32, 32), need_grid)
    if need_grid:  # + both maps read, the tap dots, both grid gradients
        flops, nbytes = 16.0 * ng, ng * es + 2 * feats + 2 * grids
    else:
        flops, nbytes = 8.0 * ng, ng * es + feats + grids
    return (lambda: stereo_voxel_sample_bwd(*args),
            lambda: sample_stereo_voxel_bwd(*args), "K1_bwd", flops, nbytes)


_CONVS = [((1, 5, 6, 7, 4), (5, 3, 3), 6, 1, torch.float32),
          ((2, 6, 5, 4, 8), (5, 5, 3), 4, 2, torch.bfloat16)]


def _conv_case(i, name):
    xs, kernel, Fo, dil, dt = _CONVS[i]
    if name == "K5":
        kernel, dil = (3, 3, 3), 1
    rng = np.random.default_rng(20 + i)
    N, D, H, W, C = xs
    x = _randn(rng, xs, dt)
    w = _randn(rng, (*kernel, C, Fo), dt)
    g = _randn(rng, (N, D, H, W, Fo), dt)
    flops = 2.0 * N * Fo * C * math.prod(
        _valid_taps(n, k, dil) for n, k in zip((D, H, W), kernel))
    nbytes = (N * D * H * W * (C + Fo) + math.prod(kernel) * C * Fo) \
        * x.element_size()
    if name == "K2":
        call = (lambda: k2.conv3d_large_tap(x, w, dil),
                lambda: k2.conv3d_pertap(x, w, dil))
    elif name == "K5":
        call = (lambda: conv3d_k3(x, w), lambda: k2.conv3d_pertap(x, w, 1))
    elif name == "K2_dx":
        call = (lambda: k2.conv3d_input_grad(g, w, dil),
                lambda: k2.conv3d_pertap(g, k2.flip_weight(w), dil))
    else:
        call = (lambda: k2.conv3d_weight_grad(x, g, kernel, dil),
                lambda: k2.conv3d_weight_grad_plain(x, g, kernel, dil))
    return call + (name, flops, nbytes)


def _k3_inputs(i):
    N, D, H, W, C, per_sample, dt = [
        (1, 5, 4, 10, 8, False, torch.float32),
        (2, 3, 3, 7, 8, True, torch.bfloat16)][i]
    rng = np.random.default_rng(30 + i)
    shape = (N, D) if per_sample else (D,)
    shifts = torch.from_numpy(rng.uniform(0, W, shape).astype(np.float32))
    return N, D, H, W, C, dt, shifts, rng


def _k3(i):
    N, D, H, W, C, dt, shifts, rng = _k3_inputs(i)
    left, right = _randn(rng, (N, H, W, C), dt), _randn(rng, (N, H, W, C), dt)
    out = N * D * H * W * 2 * C
    return (lambda: plane_sweep_volume_k3(left, right, shifts),
            lambda: plane_sweep_shifted(left, right, shifts), "K3",
            1.5 * out,
            (2 * N * H * W * C + out) * left.element_size()
            + 4 * shifts.numel())


def _k3_bwd(i):
    N, D, H, W, C, dt, shifts, rng = _k3_inputs(i)
    g = _randn(rng, (N, D, H, W, 2 * C), dt)
    ng = g.numel()
    return (lambda: plane_sweep_volume_k3_bwd(g, shifts, W),
            lambda: plane_sweep_shifted_bwd(g, shifts, W), "K3_bwd",
            2.5 * ng, (ng + 2 * N * H * W * C) * g.element_size()
            + 4 * shifts.numel())


def _k4_inputs(i):
    """A volume of D planes over 4-30 m, BEV rows past both ends and
    (case 1) rows that use only some of the planes."""
    N, D, Hf, Wf, C, dt = [(1, 6, 16, 24, 8, torch.float32),
                           (2, 8, 12, 20, 16, torch.bfloat16)][i]
    rng = np.random.default_rng(40 + i)
    depths = np.linspace(4.0, 30.0, D).astype(np.float32)
    zs = ((4.0 + (np.arange(10) + 0.5) * 2.0) if i == 0 else
          (9.0 + np.arange(6) * 1.5)).astype(np.float32)
    zs[0] = 2.5
    xs = (-6.0 + (np.arange(12) + 0.5)).astype(np.float32)
    ys = (-1.0 + (np.arange(4) + 0.5) * 0.8).astype(np.float32)
    d0, fd = frustum_tables(depths, zs)
    P = torch.tensor([[80.0, 0, 48.0, 2.0], [0, 80.0, 32.0, -0.3],
                      [0, 0, 1, 0.005]]).repeat(N, 1, 1)
    tabs = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (d0, fd, zs, xs, ys)]
    planes = len(set(d0.tolist()) | set((d0 + 1).tolist()))
    return N, D, Hf, Wf, C, dt, P, tabs, planes, rng


def _k4(i):
    N, D, Hf, Wf, C, dt, P, tabs, planes, rng = _k4_inputs(i)
    vol = _randn(rng, (N, D, Hf, Wf, C), dt)
    out = N * len(tabs[2]) * len(tabs[3]) * len(tabs[4]) * C
    return (lambda: frustum_to_voxel_k4(vol, P, *tabs),
            lambda: frustum_to_voxel_separable(vol, P, *tabs), "K4",
            24.0 * out, (N * planes * Hf * Wf * C + out) * vol.element_size())


def _k4_bwd(i):
    N, D, Hf, Wf, C, dt, P, tabs, _, rng = _k4_inputs(i)
    g = _randn(rng, (N, len(tabs[2]), len(tabs[3]), len(tabs[4]), C), dt)
    hw = (D, Hf, Wf)
    return (lambda: frustum_to_voxel_k4_bwd(g, P, *tabs, hw),
            lambda: frustum_to_voxel_separable_bwd(g, P, *tabs, hw),
            "K4_bwd", 24.0 * g.numel(),
            (g.numel() + N * D * Hf * Wf * C) * g.element_size())


CASES = {"K1": _k1, "K1_bwd": _k1_bwd,
         "K2": lambda i: _conv_case(i, "K2"),
         "K2_dx": lambda i: _conv_case(i, "K2_dx"),
         "K2_dw": lambda i: _conv_case(i, "K2_dw"),
         "K5": lambda i: _conv_case(i, "K5"),
         "K3": _k3, "K3_bwd": _k3_bwd, "K4": _k4, "K4_bwd": _k4_bwd}
IDS = [(k, i) for k in CASES for i in (0, 1)]


@pytest.mark.parametrize("name,i", IDS, ids=[f"{k}-{i}" for k, i in IDS])
def test_declared_work_is_the_shape_formula(name, i):
    entry, _, kname, flops, nbytes = CASES[name](i)
    with torch.no_grad(), count_cost() as c:
        entry()
    assert c.by_kernel == {kname: {"flops": flops, "bytes_accessed": nbytes,
                                   "calls": 1}}


@pytest.mark.parametrize("name,i", IDS, ids=[f"{k}-{i}" for k, i in IDS])
def test_plain_version_counts_its_declaration(name, i):
    """The entry on a CPU tensor runs the plain version, whose own aten ops
    (counted when it is called alone) are replaced by the declaration."""
    entry, plain, kname, flops, nbytes = CASES[name](i)
    with torch.no_grad(), count_cost() as c:
        entry()
    assert (c.flops, c.bytes_accessed) == (flops, nbytes)
    with torch.no_grad(), count_cost() as alone:
        plain()
    assert alone.bytes_accessed > 0 and not alone.by_kernel
    assert (alone.flops, alone.bytes_accessed) != (flops, nbytes)


def test_backward_declares_dx_and_dw():
    """Autograd through K2's entry counts K2, then K2_dx and K2_dw with
    the forward's work each."""
    rng = np.random.default_rng(3)
    x = _randn(rng, (1, 5, 4, 6, 8)).requires_grad_()
    w = _randn(rng, (5, 3, 3, 8, 4)).requires_grad_()
    with count_cost() as c:
        k2.conv3d_large_tap(x, w, 1).sum().backward()
    fwd = c.by_kernel["K2"]
    for k in ("K2_dx", "K2_dw"):
        assert c.by_kernel[k] == fwd, k


def test_no_counter_calls_no_formula():
    """With no counter open a region does not evaluate its formula (K4's
    reads its table back from the card)."""
    def boom():
        raise AssertionError("formula evaluated")

    with cost.declare_kernel("K4", boom):
        pass
    with pytest.raises(AssertionError):
        with count_cost(), cost.declare_kernel("K4", boom):
            pass


def _small_refine(device, **kw):
    from snvc_tpu_torch.config import tiny_vernier_config
    from snvc_tpu_torch.inference.refine import RefineRunner
    from snvc_tpu_torch.models.vernier import VernierScale

    cfg = tiny_vernier_config(grid_resolution=(8, 16, 16),
                              image_size=(128, 256), max_instances=2,
                              compute_dtype="bfloat16")
    model = VernierScale(cfg, device=device,
                         generator=torch.Generator().manual_seed(1))
    return RefineRunner(model, cfg, device=device, **kw), cfg


def test_meta_device_counts_what_the_cpu_counts():
    """The plain path on the meta device (shapes alone, no data) counts
    the CPU's work exactly, in total, per kernel and per op: how
    chip_smoke.py's phase ``cost`` counts the CPU side of a flagship
    request, whose CPU forward is out of reach."""
    runner, cfg = _small_refine("cpu")
    batch = synthetic_batch_arrays(cfg, seed=7)
    cpu = runner.cost_counter(batch)
    meta = _small_refine("meta")[0].cost_counter(batch)
    assert cpu.totals() == meta.totals()
    assert cpu.by_kernel == meta.by_kernel
    assert set(cpu.by_kernel) == {"K1", "K2"}
    assert cpu.by_kernel["K2"]["calls"] == 3
    assert cpu.by_op == meta.by_op


def test_meta_stereo_count_is_the_cpu_count():
    """chip_smoke.meta_stereo_count (the StereoNet forward on the meta
    device, K4's plane table on the host) against the same forward on the
    CPU, in bf16 as on the card."""
    import chip_smoke
    from snvc_tpu_torch.config import tiny_stereo_config
    from snvc_tpu_torch.data.stereo import synthetic_stereo_request
    from snvc_tpu_torch.models.stereonet import StereoNet

    cfg = tiny_stereo_config(compute_dtype="bfloat16")
    req = synthetic_stereo_request(cfg, seed=7)
    model = StereoNet(cfg, device="cpu")
    args = chip_smoke.stereo_inputs(req, "cpu")
    with torch.inference_mode(), count_cost() as cpu:
        model(*args)
    with torch.inference_mode():
        meta = chip_smoke.meta_stereo_count(cfg, req)
    assert cpu.totals() == meta.totals()
    assert cpu.by_kernel == meta.by_kernel
    assert set(cpu.by_kernel) == {"K3", "K4"}
    assert cpu.by_op == meta.by_op


def test_cost_stats_on_a_mesh_counts_the_whole_batch():
    """A runner on a two-position mesh counts the one-device step over
    the whole batch."""
    from snvc_tpu_torch.parallel.api import make_mesh

    one, cfg = _small_refine("cpu")
    two, _ = _small_refine("cpu", mesh=make_mesh(2, ["cpu", "cpu"]))
    batch = synthetic_batch_arrays(cfg, seed=8)
    assert two.cost_stats(batch) == one.cost_stats(batch)


# ------------------------------------------------ single convs vs XLA ----
def _xla_flops(fn, *args):
    return _compiled_cost(jax.jit(fn), *args)["flops"]


CONV_CASES = {
    # NDHWC input, DHWIO kernel, stride, torch padding, dilation
    "same_k7": ((1, 8, 16, 16, 4), (7, 7, 7, 4, 8), 1, 3, 1),
    "same_k5_dilation2": ((1, 8, 12, 10, 4), (5, 5, 5, 4, 6), 1, 4, 2),
    "strided_k3": ((1, 8, 15, 17, 6), (3, 3, 3, 6, 8), 2, 1, 1),
    "strided_2d_k3": ((2, 15, 17, 6), (3, 3, 6, 8), 2, 1, 1),
}


@pytest.mark.parametrize("name", list(CONV_CASES))
def test_conv_flops_equal_xla(name):
    xs, ws, stride, pad, dil = CONV_CASES[name]
    nd = len(xs) - 2
    rng = np.random.default_rng(5)
    x = rng.standard_normal(xs).astype(np.float32)
    w = rng.standard_normal(ws).astype(np.float32)
    dn = ("NDHWC", "DHWIO", "NDHWC") if nd == 3 else ("NHWC", "HWIO", "NHWC")

    def jfn(x, w):
        return jax.lax.conv_general_dilated(
            x, w, (stride,) * nd, ((pad, pad),) * nd, rhs_dilation=(dil,) * nd,
            dimension_numbers=dn)

    want = _xla_flops(jfn, x, w)
    conv = F.conv3d if nd == 3 else F.conv2d
    xt = torch.from_numpy(x).movedim(-1, 1)
    wt = torch.from_numpy(w).permute(nd + 1, nd, *range(nd))
    with torch.no_grad(), count_cost() as c:
        got = conv(xt, wt, None, stride, pad, dil)
    assert c.flops == want
    np.testing.assert_allclose(got.movedim(1, -1).numpy(), jfn(x, w),
                               rtol=1e-4, atol=1e-4)
    if stride == 1 and nd == 3:  # K2's formula
        assert cost.conv3d_same_flops(xs, ws[:3], ws[-1], dil) == want


@pytest.mark.parametrize("nd", [2, 3])
def test_transposed_conv_flops_equal_xla(nd):
    """torch's k3 stride-2 padding-1 output-padding-1 deconv (the
    models' only one) against XLA's input-dilated conv of the flipped
    kernel, padding (1, 2)."""
    rng = np.random.default_rng(6)
    sp = (4, 6, 5)[:nd]
    x = rng.standard_normal((1, *sp, 4)).astype(np.float32)
    w = rng.standard_normal((4, 6) + (3,) * nd).astype(np.float32)  # I, O, k
    wj = np.ascontiguousarray(
        np.flip(w, axis=tuple(range(2, 2 + nd))).transpose(
            *range(2, 2 + nd), 0, 1))
    dn = ("NDHWC", "DHWIO", "NDHWC") if nd == 3 else ("NHWC", "HWIO", "NHWC")

    def jfn(x, w):
        return jax.lax.conv_general_dilated(
            x, w, (1,) * nd, ((1, 2),) * nd, lhs_dilation=(2,) * nd,
            dimension_numbers=dn)

    want = _xla_flops(jfn, x, wj)
    deconv = F.conv_transpose3d if nd == 3 else F.conv_transpose2d
    with torch.no_grad(), count_cost() as c:
        got = deconv(torch.from_numpy(x).movedim(-1, 1), torch.from_numpy(w),
                     None, 2, 1, 1)
    assert c.flops == want
    np.testing.assert_allclose(got.movedim(1, -1).numpy(), jfn(x, wj),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_backward_flops_equal_xla(stride):
    """``convolution_backward`` counts dx and dw at the forward's taps
    each: XLA's count of the conv's VJP."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 6 + stride, 9, 10, 4)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 4, 5)).astype(np.float32)

    def jfn(x, w):
        return jax.lax.conv_general_dilated(
            x, w, (stride,) * 3, ((1, 1),) * 3,
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))

    g = rng.standard_normal(jfn(x, w).shape).astype(np.float32)
    want = _xla_flops(lambda x, w, g: jax.vjp(jfn, x, w)[1](g), x, w, g)
    xt = torch.from_numpy(x).movedim(-1, 1).requires_grad_()
    wt = torch.from_numpy(w).permute(4, 3, 0, 1, 2).contiguous() \
        .requires_grad_()
    y = F.conv3d(xt, wt, None, stride, 1)
    with count_cost() as c:
        torch.autograd.grad(y, (xt, wt), torch.from_numpy(g).movedim(-1, 1))
    assert c.flops == want
    assert c.by_op["aten.convolution_backward.default"][0] == want


# ------------------------------------------------------ the byte rule ----
def test_bytes_follow_the_eager_rule():
    """Each op's tensor inputs and outputs, once; views, bare allocations
    and copies between devices move nothing."""
    x = torch.randn(2, 4, 8, 8)
    w = torch.randn(6, 4, 3, 3)
    with torch.no_grad(), count_cost() as c:
        y = F.conv2d(x, w, padding=1)  # reads x and w, writes y
        z = F.relu(y)  # reads y, writes z
        z.reshape(2, -1)  # a view
        torch.empty(5)
    b = 4 * (x.numel() + w.numel() + 3 * y.numel())
    assert c.bytes_accessed == b
    assert c.flops == 2.0 * 2 * 6 * 4 * _valid_taps(8, 3, 1) ** 2
    assert set(c.by_op) == {"aten.convolution.default", "aten.relu.default",
                            "aten.view.default", "aten.empty.memory_format"}
    assert program_cost(F.relu, y) == {"flops": 0.0,
                                       "bytes_accessed": 8 * y.numel()}


# -------------------------------------- JAX programs: conv and dot flops ----
def _jax_conv_dot(fn, *args, **kwargs):
    """{"conv", "dot", "dots"}: XLA's flops for each conv_general_dilated
    and dot_general of the traced ``fn`` (each compiled alone), and the
    dots as (flops, contracted length)."""
    cache, acc = {}, {"conv": 0.0, "dot": 0.0, "dots": []}

    def flops(eqn):
        avals = [jax.ShapeDtypeStruct(v.aval.shape, v.aval.dtype)
                 for v in eqn.invars]
        key = (str(eqn.primitive), str(avals), repr(eqn.params))
        if key not in cache:
            cache[key] = _xla_flops(
                lambda *a: eqn.primitive.bind(*a, **eqn.params), *avals)
        return cache[key]

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if str(eqn.primitive) == "conv_general_dilated":
                acc["conv"] += flops(eqn)
            elif str(eqn.primitive) == "dot_general":
                f = flops(eqn)
                acc["dot"] += f
                (lc, _), _ = eqn.params["dimension_numbers"]
                acc["dots"].append(
                    (f, math.prod(eqn.invars[0].aval.shape[d] for d in lc)))
            for p in eqn.params.values():
                for sub in (p if isinstance(p, (list, tuple)) else [p]):
                    if isinstance(sub, jcore.ClosedJaxpr):
                        walk(sub.jaxpr)
                    elif isinstance(sub, jcore.Jaxpr):
                        walk(sub)

    walk(jax.make_jaxpr(lambda *a: fn(*a, **kwargs))(*args).jaxpr)
    return acc


class _ConvLog(torch.utils._python_dispatch.TorchDispatchMode):
    """Each aten.convolution's flops under JAX's CPU decomposition: a 3D
    conv's kd depth taps at every output plane (JAX's per-tap path pads
    the volume), a 3D deconv's three depth taps at every input plane (its
    parity convs over a volume padded by one plane)."""

    def __init__(self):
        super().__init__()
        self.jax_rule = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is not torch.ops.aten.convolution.default:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if func is torch.ops.aten.convolution.default:
            x, w, _, stride, pad, dil, transposed = args[:7]
            f = cost.op_flops(func, args, out)
            if x.ndim == 5:
                k = w.shape[2]
                inside = cost.conv_taps(x.shape[2], out.shape[2], k,
                                        stride[0], pad[0], dil[0], transposed)
                f *= (k * (x.shape[2] if transposed else out.shape[2])
                      / inside)
            self.jax_rule += f
        return out


def _port_split(c):
    """(conv flops, dot flops, declared flops) of a counter."""
    conv = sum(v[0] for k, v in c.by_op.items() if "convolution" in k)
    declared = sum(v["flops"] for v in c.by_kernel.values())
    return conv, c.flops - conv - declared, declared


@pytest.fixture(scope="module")
def refine_counts():
    from tests.test_torch_refine import _jax_batch, _runners

    jcfg = __graft_entry__._tiny_cfg(max_instances=2)
    jr, tr, tcfg = _runners(jcfg, 21)
    a = synthetic_batch_arrays(tcfg, seed=3)
    jb = _jax_batch(a)
    want = jr.cost_stats(jb)
    encode, heads, finalize = jr._progs["split"]
    enc = scope_variables(jr.params, "encoder")
    hv = scope_variables(jr.params, "head")
    arrays = jb.arrays()
    vox = encode(enc, arrays)
    outs = heads(hv, vox)
    jcd = [_jax_conv_dot(encode, enc, arrays), _jax_conv_dot(heads, hv, vox),
           _jax_conv_dot(finalize, outs, arrays, wt=False)]
    c = tr.cost_counter(a)
    log = _ConvLog()
    with torch.inference_mode():
        arr = tr._to_device(a, False)
        with log:
            tr.heads(tr.encode(arr))
    return dict(jax=want, jcd=jcd, port=c, stats=tr.cost_stats(a),
                jax_rule=log.jax_rule)


def test_cost_stats_returns_the_counted_work(refine_counts):
    c = refine_counts["port"]
    assert refine_counts["stats"] == c.totals()
    assert set(c.by_kernel) == {"K1"} and c.by_kernel["K1"]["calls"] == 1


def test_refine_conv_and_dot_flops_match_jax(refine_counts):
    jcd = refine_counts["jcd"]
    conv, dot, _ = _port_split(refine_counts["port"])
    jconv = sum(p["conv"] for p in jcd)
    jdot = sum(p["dot"] for p in jcd)
    assert refine_counts["jax_rule"] == pytest.approx(jconv, rel=1e-6)
    assert dot == pytest.approx(jdot, rel=1e-6)
    # the port counts fewer conv flops: the taps on JAX's padded planes
    assert conv < jconv


def test_refine_totals_differ_by_the_elementwise_band(refine_counts):
    """JAX's total is its conv and dot flops plus the elementwise band
    (1.15 % of it, measured); the port's is its conv and dot flops plus
    K1's declared work."""
    total = refine_counts["jax"]["flops"]
    jcd = refine_counts["jcd"]
    band = (total - sum(p["conv"] + p["dot"] for p in jcd)) / total
    assert 0.0110 < band < 0.0120, band
    c = refine_counts["port"]
    conv, dot, declared = _port_split(c)
    assert c.flops == conv + dot + declared
    assert declared == c.by_kernel["K1"]["flops"] > 0
    ratio = c.bytes_accessed / refine_counts["jax"]["bytes_accessed"]
    assert 0.95 < ratio < 1.05, ratio  # eager traffic, 0.996x XLA's


@pytest.fixture(scope="module")
def stereo_counts():
    from snvc_tpu.config import tiny_stereo_config as jax_tiny
    from snvc_tpu.models import stereonet as jnet
    from snvc_tpu_torch.config import tiny_stereo_config
    from snvc_tpu_torch.models import stereo_backbone, stereonet as tnet
    from snvc_tpu_torch.utils.convert_jax import convert_variables
    from tests.torch_port_helpers import random_variables

    jcfg = jax_tiny()
    H, W = jcfg.input_size
    rng = np.random.default_rng(0)
    left = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    right = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    Pl = Calibration.default().as_array()[None]
    Pr = Calibration.default_right().as_array()[None]
    jm = jnet.StereoNet(jcfg)
    v = random_variables(jm, left, right, Pl, Pr, seed=3)
    want = _compiled_cost(jax.jit(jm.apply), v, left, right, Pl, Pr)
    jcd = _jax_conv_dot(jm.apply, v, left, right, Pl, Pr)
    model = tnet.StereoNet(tiny_stereo_config(), device="cpu")
    model.load_state_dict(convert_variables(v), strict=True)
    args = [torch.from_numpy(a) for a in (left, right, Pl, Pr)]
    # the SPP upsampling's dots, and the right view's RPN conv
    spp, rpn = [], []
    orig = stereo_backbone._bilinear_resize

    def resize(*a):
        with count_cost() as c:
            out = orig(*a)
        spp.append(c.flops)
        return out

    def rpn_flops(m, inputs, out):  # NHWC in and out
        conv = m.Conv_0
        rpn.append(cost.conv_flops(
            inputs[0].movedim(-1, 1).shape, conv.weight.shape,
            out.movedim(-1, 1).shape, conv.stride, conv.padding,
            conv.dilation))

    net = model.encoder.StereoFeatureNet_0
    hook = net._out["rpn"].register_forward_hook(rpn_flops)
    stereo_backbone._bilinear_resize = resize
    try:
        with torch.inference_mode():
            with count_cost() as c:
                model(*args)
            log = _ConvLog()
            with log:
                model(*args)
    finally:
        stereo_backbone._bilinear_resize = orig
        hook.remove()
    with torch.inference_mode():
        program = program_cost(model, *args)
    return dict(jax=want, jcd=jcd, port=c, jax_rule=log.jax_rule,
                spp=sum(spp) / 2, rpn=rpn, program=program)


def test_stereo_conv_and_dot_flops_match_jax(stereo_counts):
    jcd = stereo_counts["jcd"]
    c = stereo_counts["port"]
    assert set(c.by_kernel) == {"K3", "K4"}
    assert stereo_counts["program"] == c.totals()
    _, dot, _ = _port_split(c)
    assert stereo_counts["jax_rule"] == pytest.approx(jcd["conv"], rel=1e-6)
    # JAX's K4 fallback projects the voxel centres, [P, 3] x [3, 3]
    proj = [f for f, k in jcd["dots"] if k == 3]
    assert len(proj) == 1
    assert dot - stereo_counts["spp"] == pytest.approx(
        jcd["dot"] - proj[0], rel=1e-6)
    assert stereo_counts["spp"] > 0


def test_stereo_totals_differ_by_the_elementwise_band(stereo_counts):
    """JAX's total is its conv and dot flops, less the right view's RPN
    conv that XLA drops, plus the elementwise band (0.78 %, measured)."""
    total = stereo_counts["jax"]["flops"]
    jcd = stereo_counts["jcd"]
    left_rpn, right_rpn = stereo_counts["rpn"][:2]
    assert left_rpn == right_rpn > 0
    band = (total - (jcd["conv"] + jcd["dot"] - right_rpn)) / total
    assert 0.0075 < band < 0.0082, band
    c = stereo_counts["port"]
    conv, dot, declared = _port_split(c)
    assert c.flops == conv + dot + declared
    ratio = c.bytes_accessed / stereo_counts["jax"]["bytes_accessed"]
    assert 1.02 < ratio < 1.12, ratio  # 1.071x XLA's fused
