"""Smoke run of the PyTorch port (snvc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py              # the check
    python3 chip_smoke.py --profile    # also profile one request of each
                                       # serving path and one training step

Phases, each printing one line with its elapsed seconds:
  1. device  - the card's name; nvidia-smi's name and power limit;
  2. build   - nvcc builds every CUDA kernel, and each kernel's ptxas
               registers and spills are printed (the two wgmma conv
               kernels must spill nothing and keep their wgmma
               unserialized);
  3. K1      - the stereo voxel sampler kernel against its plain version
               (small shapes; the flagship shape at uniform random
               projections and at a seeded flagship batch's own), with
               kernel (the path's projections; kernel_ms_random beside it)
               / plain / F.grid_sample times and the memory bound;
  4. K2      - the large-tap 3D conv kernel against its plain version for
               the three flagship convs and two ragged shapes, with kernel
               / plain / F.conv3d times, TFLOP/s and the share of the
               tensor-core bound per conv;
  5. K3      - the plane-sweep cost volume kernel against its plain
               version (small shapes with shared and per-sample shift
               tables, shifts of 0, integer, fractional and past the row;
               the detect shape with a [2, 64] table), with kernel / plain
               times and the memory bound;
  6. K4      - the frustum -> voxel kernel against its plain version (small
               and detect shapes), with kernel / plain / F.grid_sample
               times and the memory bound;
  7. serving - a flagship RefineRunner (hrnet-w32, 32x192x192 grid, 4
               instances, bf16, seeded random weights) answers one warm-up
               and three requests; the launch counters must show K1 once
               and K2 three times per request; a small model's outputs on
               the card must agree with the same model on the CPU
               (phase "reference");
  8. detect  - a full-width DetectRunner (StereoConfig(): reslike-det-small,
               384x1248 pair, 64 planes, 288x300x20 BEV grid, bf16, seeded
               random weights) answers one warm-up and three requests; the
               counters must show K3 and K4 once per request and K1 / K2
               not at all; a tiny StereoNet on the card must agree with
               the same weights on the CPU (phase "stereo_reference");
  9. K1_bwd  - the sampler's backward kernel against its plain version
               (small shapes with the grid gradient; the training shape at a
               seeded batch's projections, and with every point of an
               instance on one 2x2 tap patch, float32 and bf16), with
               kernel (the batch's projections, no grid gradient; the one-
               patch time beside it) / plain / F.grid_sample-backward times
               and the memory bound;
 10. K2_bwd  - dx (the K2 kernel on flipped weights) and dw (the split-K
               weight-gradient kernel) of the three prelude convs at the
               training shape and of two ragged shapes, against the
               per-tap conv's float32 autograd, with kernel / plain /
               cuDNN (torch.nn.grad) times, TFLOP/s and the share of the
               tensor-core bound per conv;
 11. K5      - the k3 conv (the K2 kernel at a 3x3x3 tap) forward and
               backward against the plain version at a stereo 3D-stack
               shape and at the JAX tests' [1, 4, 8, 16, 128] -> 32, with
               F.conv3d / conv3d_input / conv3d_weight times beside the
               forward, dx and dw;
 12. train_reference - one training step of a small float32 model on the
               card against the same step on the CPU (losses, every
               gradient, BatchNorm statistics, parameters after the next
               step), then in bf16 held to three times the CPU's own bf16
               drift (+1 % of scale);
 13. train   - the default training config (VernierConfig(): hrnet-w32,
               16x96x96 grid, 256x256 ROIs, 384x1280 images, 8 instances,
               bf16, remat; TrainConfig with warmup_steps=2) takes 12 steps
               on one seeded batch; the loss must be finite and fall, and
               the counters must show per step K1 1 + 1 backward, K2 3 +
               3 dx, dw 3, K3 = K4 = K5 = 0.
Then a {"kernels": [...]} line, nvidia-smi's line, and as the last line
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero
before the last line; without CUDA the script exits non-zero at once.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from snvc_tpu_torch import _build
from snvc_tpu_torch.config import (
    StereoConfig,
    TrainConfig,
    VernierConfig,
    flagship_vernier_config,
    tiny_stereo_config,
    tiny_vernier_config,
)
from snvc_tpu_torch.data.stereo import normalize_images, synthetic_stereo_request
from snvc_tpu_torch.data.synthetic import synthetic_batch_arrays
from snvc_tpu_torch.geometry.calib import Calibration
from snvc_tpu_torch.inference.detect import DetectRunner
from snvc_tpu_torch.inference.refine import RefineRunner
from snvc_tpu_torch.models.stereonet import (
    StereoNet,
    _bev_axes,
    depth_hypotheses,
    plane_shifts,
)
from snvc_tpu_torch.models.vernier import VernierScale
from snvc_tpu_torch.ops.conv3d_fold import (
    conv3d_input_grad,
    conv3d_large_tap,
    conv3d_pertap,
    conv3d_weight_grad,
    conv3d_weight_grad_plain,
    flip_weight,
)
from snvc_tpu_torch.ops.assemble import assemble_instances, make_grid_local
from snvc_tpu_torch.ops.conv3d_k3 import conv3d_k3
from snvc_tpu_torch.ops.cost_volume import (
    plane_sweep_shifted,
    plane_sweep_volume_k3,
)
from snvc_tpu_torch.ops.frustum import (
    _project_uv,
    frustum_tables,
    frustum_to_voxel_k4,
    frustum_to_voxel_separable,
)
from snvc_tpu_torch.ops.grid_sample import (
    sample_stereo_voxel,
    sample_stereo_voxel_bwd,
)
from snvc_tpu_torch.ops.stereo_sample_cuda import (
    stereo_voxel_sample,
    stereo_voxel_sample_bwd,
)
from snvc_tpu_torch.training.train import (
    batch_to_device,
    create_train_state,
    make_train_step,
)

# H100 SXM published peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# float32 outside the tensor cores, HBM3 bandwidth; the bounds below are
# against these.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# the stereo 3D stack's first conv input: the [1, 64, 96, 312, 64] plane-
# sweep volume of StereoConfig()
STEREO_STACK = (1, 64, 96, 312, 64)

T0 = time.perf_counter()


def phase(label: str, t_start: float, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{label}] {time.perf_counter() - t_start:.2f}s {body}", flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def ptxas_report(log: str):
    """(kernel, registers, spill bytes, ptxas performance notes) of each
    kernel in an ``nvcc -Xptxas -v`` log; template kernels keep their
    arguments (``conv3d_large_tap_kernel<32,1,1,7>``)."""
    out, fn, spills, notes = [], "?", 0, {}
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn, spills = short_name(m.group(1)), 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spills = int(m.group(1)) + int(m.group(2))
        m = re.search(r"\((C75\d\d)\).*function '(\S+)'", ln)
        if m:
            notes.setdefault(short_name(m.group(2)), []).append(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.append([fn, int(m.group(1)), spills])
    return [(f, r, sp, notes.get(f, [])) for f, r, sp in out]


def short_name(mangled: str) -> str:
    """``_ZN..23conv3d_large_tap_kernelILi32ELi1ELi1ELi7EEEv..`` ->
    ``conv3d_large_tap_kernel<32,1,1,7>`` (Itanium names: a length, then
    the identifier)."""
    for m in re.finditer(r"(\d+)(?=[A-Za-z_])", mangled):
        end = m.end() + int(m.group(1))
        name = mangled[m.end():end]
        if name.endswith("_kernel"):
            args = re.match(r"I((?:Li-?\d+E)+)E", mangled[end:])
            if args:
                name += "<" + ",".join(re.findall(r"Li(-?\d+)E",
                                                  args.group(1))) + ">"
            return name
    return mangled


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` launches."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def valid_taps(size: int, k: int, dil: int) -> int:
    """(output, tap) pairs along one axis whose input lies inside the
    volume (torch-symmetric padding): the taps a conv must multiply."""
    pad = (k - 1) // 2 * dil
    return sum(1 for o in range(size) for t in range(k)
               if 0 <= o + t * dil - pad < size)


# ---------------------------------------------------------------- K1 ----
def k1_case(gen, N, Hf, Wf, C, grid, roi, dtype, dev):
    """Features and projections; a margin of the ROI puts some points
    outside the image so the zero-padding taps are exercised."""
    nh, nw, nl = grid
    P = nh * nw * nl
    lf = torch.randn((N, Hf, Wf, C), generator=gen).to(dev, dtype)
    rf = torch.randn((N, Hf, Wf, C), generator=gen).to(dev, dtype)
    lo, hi = -0.0625 * roi[1], 1.0625 * roi[1]
    gl = (torch.rand((N, P, 2), generator=gen) * (hi - lo) + lo).to(dev)
    gr = (torch.rand((N, P, 2), generator=gen) * (hi - lo) + lo).to(dev)
    return lf, rf, gl, gr


def batch_projections(cfg, seed, dev):
    """The [N, P, 2] ROI-pixel projections of both views that the path
    computes for one seeded synthetic batch (assemble_instances): ordered
    along the grid and clustered on the object, unlike k1_case's."""
    b = batch_to_device(synthetic_batch_arrays(cfg, seed=seed), dev)
    gl, gr = assemble_instances(
        b["images_left"], b["images_right"], b["image_idx"], b["trans_l"],
        b["trans_r"], b["samples"], b["P_left"], b["P_right"],
        torch.from_numpy(make_grid_local(cfg)).to(dev), cfg)[2:]
    return gl.float().contiguous(), gr.float().contiguous()


def check_k1(gen, dev) -> dict:
    t = time.perf_counter()
    # small shape, f32 and bf16
    for dtype in (torch.float32, torch.bfloat16):
        args = k1_case(gen, 2, 16, 16, 32, (4, 8, 8), (64, 64), dtype, dev)
        got = stereo_voxel_sample(*args, (64, 64), (4, 8, 8)).float()
        want = sample_stereo_voxel(*args, (64, 64), (4, 8, 8)).float()
        tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
        err = (got - want).abs()
        # bf16: kernel and plain round the same f32 sum; they may differ by
        # one bf16 ulp (2^-7 relative) through a different fma order
        assert bool((err <= tol * want.abs() + 1e-5).all()), \
            f"K1 small {dtype}: max err {err.max().item()}"
    # flagship shape: [4, 64, 64, 32] bf16 features, 32x192x192 grid, at
    # uniform random projections and at the path's own (a seeded flagship
    # batch); the path's are the kernel's reported time
    cfg = flagship_vernier_config()
    grid, roi = cfg.grid_resolution, cfg.resolution
    lf, rf, rgl, rgr = k1_case(gen, cfg.max_instances, 64, 64, 32, grid, roi,
                               torch.bfloat16, dev)
    gl, gr = batch_projections(cfg, 0, dev)
    max_err = 0.0
    for label, pl, pr in (("random", rgl, rgr), ("path", gl, gr)):
        got = stereo_voxel_sample(lf, rf, pl, pr, roi, grid)
        want = sample_stereo_voxel(lf, rf, pl, pr, roi, grid)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        assert bool((err <= 2.0 ** -7 * want.float().abs() + 1e-5).all()), \
            f"K1 flagship {label}: max err {err.max().item()}"
        max_err = max(max_err, err.max().item())
        del want
    ms_random = cuda_ms(lambda: stereo_voxel_sample(lf, rf, rgl, rgr, roi,
                                                    grid), 20)
    ms = cuda_ms(lambda: stereo_voxel_sample(lf, rf, gl, gr, roi, grid), 20)
    plain_ms = cuda_ms(lambda: sample_stereo_voxel(lf, rf, gl, gr, roi,
                                                   grid), 3)
    # library: F.grid_sample per view (NCHW view of the same NHWC data,
    # normalized grid [N, 1, P, 2]) and the concat, timed only
    lft, rft = lf.permute(0, 3, 1, 2), rf.permute(0, 3, 1, 2)
    scale = torch.tensor([2.0 / roi[1], 2.0 / roi[0]], device=dev)
    ngl = (gl * scale - 1.0)[:, None].to(torch.bfloat16)
    ngr = (gr * scale - 1.0)[:, None].to(torch.bfloat16)

    def library():
        a = F.grid_sample(lft, ngl, align_corners=False, padding_mode="zeros")
        b = F.grid_sample(rft, ngr, align_corners=False, padding_mode="zeros")
        return torch.cat([a, b], dim=1)

    library_ms = cuda_ms(library, 3)
    # float32 multiply-adds: 4 taps per output element
    bound_ms = max(nbytes(lf, rf, gl, gr, got) / PEAK_BYTES,
                   8.0 * got.numel() / PEAK_F32_FLOPS) * 1e3
    phase("K1", t, max_abs_err=f"{max_err:.3e}", kernel_ms=f"{ms:.4f}",
          kernel_ms_random=f"{ms_random:.4f}", plain_ms=f"{plain_ms:.4f}",
          library_ms=f"{library_ms:.4f}", bound_ms=f"{bound_ms:.4f}")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, library_ms=library_ms)


# ---------------------------------------------------------------- K2 ----
def k2_case(gen, shape, kernel, F_out, dev):
    N, D, H, W, C = shape
    x = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
    fan_in = math.prod(kernel) * C
    w = (torch.randn(kernel + (C, F_out), generator=gen)
         / math.sqrt(fan_in)).to(dev, torch.bfloat16)
    return x, w


def check_k2(gen, dev) -> dict:
    t = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False  # the f32 reference is f32
    torch.backends.cuda.matmul.allow_tf32 = False
    flag = (4, 32, 192, 192)
    cases = [  # name, x shape, kernel, F, dilation, timed
        ("conv1_k7", flag + (64,), (7, 7, 7), 32, 1, True),
        ("conv2_k5", flag + (32,), (5, 5, 5), 32, 1, True),
        ("conv3_k5_d2", flag + (32,), (5, 5, 5), 32, 2, True),
        ("ragged", (2, 9, 10, 70, 40), (5, 3, 7), 24, 2, False),
        ("ragged_scalar", (1, 7, 6, 33, 12), (5, 5, 5), 10, 1, False),
    ]
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    max_err = 0.0
    for name, shape, kernel, F_out, dil, timed in cases:
        tc = time.perf_counter()
        x, w = k2_case(gen, shape, kernel, F_out, dev)
        got = conv3d_large_tap(x, w, dil).float()
        ref = conv3d_pertap(x.float(), w.float(), dil)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        # kernel: exact bf16 products summed in f32, rounded once to bf16
        # (half an ulp, 2^-8 relative); 2^-7 relative plus 1e-3 of the
        # output scale leaves room for the f32 summation order
        tol = 2.0 ** -7 * ref.abs() + 1e-3 * ref.abs().max()
        assert bool((err <= tol).all()), \
            f"K2 {name}: max err {err.max().item()}"
        max_err = max(max_err, err.max().item())
        fields = dict(max_abs_err=f"{err.max().item():.3e}")
        del got, ref
        if timed:
            N, D, H, W, C = shape
            # multiply-adds with padding zeros are not work the conv needs
            flops = 2.0 * N * F_out * C * math.prod(
                valid_taps(n, k, dil) for n, k in zip((D, H, W), kernel))
            out_bytes = N * D * H * W * F_out * 2
            ms = cuda_ms(lambda: conv3d_large_tap(x, w, dil), 3)
            plain_ms = cuda_ms(lambda: conv3d_pertap(x, w, dil), 2)
            xt = x.permute(0, 4, 1, 2, 3)
            wt = w.permute(4, 3, 0, 1, 2).contiguous()
            pad = tuple((k - 1) // 2 * dil for k in kernel)
            library_ms = cuda_ms(
                lambda: F.conv3d(xt, wt, None, 1, pad, dil), 2)
            bound_ms = max(flops / PEAK_BF16_FLOPS,
                           (nbytes(x, w) + out_bytes) / PEAK_BYTES) * 1e3
            for k, v in (("ms", ms), ("plain_ms", plain_ms),
                         ("bound_ms", bound_ms), ("library_ms", library_ms)):
                tot[k] += v
            fields.update(kernel_ms=f"{ms:.3f}", plain_ms=f"{plain_ms:.3f}",
                          library_ms=f"{library_ms:.3f}",
                          bound_ms=f"{bound_ms:.3f}",
                          tflops=f"{flops / ms / 1e9:.1f}",
                          pct_of_bound=f"{100 * bound_ms / ms:.1f}")
        phase(f"K2 {name}", tc, **fields)
        del x, w
        torch.cuda.empty_cache()
    phase("K2", t, max_abs_err=f"{max_err:.3e}",
          **{k: f"{v:.3f}" for k, v in tot.items()})
    return dict(max_abs_err=max_err, **tot)


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at magnitude x (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(x, 2.0 ** -126))) - 7)


def assert_within_ulps(label, got, want, ulps=2):
    """|got - want| <= ``ulps`` bf16 ulp of the largest |want|."""
    got, want = got.float(), want.float()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= ulps * bf16_ulp(scale), \
        f"{label}: max err {err} > {ulps} bf16 ulp of {scale}"
    return err


# ---------------------------------------------------------------- K3 ----
def k3_edge_table(N, D, W, gen):
    """[N, D] shifts: the first row random in [0, W), the rest the edge
    cases 0, integers, fractions, the last column, and past the row."""
    edge = torch.tensor([0.0, 1.0, 2.5, 7.25, W - 1.0, W - 0.5, W + 0.0,
                         W + 5.5, 3 * W + 0.25], dtype=torch.float32)
    t = torch.rand((N, D), generator=gen) * W
    for n in range(1, N):
        t[n, :len(edge)] = edge[: D]
    return t


def check_k3(gen, dev) -> dict:
    t = time.perf_counter()
    # small shapes, f32 and bf16, shared [D] and per-sample [N, D] tables
    for dtype in (torch.float32, torch.bfloat16):
        lf = torch.randn((2, 8, 24, 16), generator=gen).to(dev, dtype)
        rf = torch.randn((2, 8, 24, 16), generator=gen).to(dev, dtype)
        for shifts in (k3_edge_table(2, 9, 24, gen)[1],
                       k3_edge_table(2, 9, 24, gen)):
            s = shifts.to(dev)
            assert_within_ulps(f"K3 small {dtype} {tuple(s.shape)}",
                               plane_sweep_volume_k3(lf, rf, s),
                               plane_sweep_shifted(lf, rf, s))
    # detect shape: [N, 96, 312, 32] bf16 features, 64 planes; a [2, 64]
    # table whose second row holds the edge cases
    cfg = StereoConfig()
    H, W = cfg.input_size[0] // 4, cfg.input_size[1] // 4
    C = 32
    lf = torch.randn((2, H, W, C), generator=gen).to(dev, torch.bfloat16)
    rf = torch.randn((2, H, W, C), generator=gen).to(dev, torch.bfloat16)
    table = k3_edge_table(2, cfg.num_depths, W, gen).to(dev)
    err = assert_within_ulps("K3 detect [2, D]",
                             plane_sweep_volume_k3(lf, rf, table),
                             plane_sweep_shifted(lf, rf, table))
    # the request's own shift table, one sample
    Pl = torch.from_numpy(Calibration.default().as_array()[None]).to(dev)
    Pr = torch.from_numpy(Calibration.default_right().as_array()[None]).to(dev)
    depths = torch.from_numpy(depth_hypotheses(cfg)).to(dev)
    shifts = plane_shifts(Pl, Pr, depths)
    l1, r1 = lf[:1].contiguous(), rf[:1].contiguous()
    got = plane_sweep_volume_k3(l1, r1, shifts)
    err = max(err, assert_within_ulps("K3 detect", got,
                                      plane_sweep_shifted(l1, r1, shifts)))
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: plane_sweep_volume_k3(l1, r1, shifts), 20)
    plain_ms = cuda_ms(lambda: plane_sweep_shifted(l1, r1, shifts), 3)
    # f32 lerp of the right half: 2 multiplies and an add per element
    bound_ms = max(nbytes(l1, r1, shifts, got) / PEAK_BYTES,
                   1.5 * got.numel() / PEAK_F32_FLOPS) * 1e3
    phase("K3", t, max_abs_err=f"{err:.3e}", kernel_ms=f"{ms:.4f}",
          plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
          library_ms="none")
    # no single PyTorch call builds a plane-sweep volume (a gather, a lerp
    # and a concat at least): library_ms is null
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                library_ms=None)


# ---------------------------------------------------------------- K4 ----
def k4_tables(depths, zs, xs, ys, dev):
    d0, fd = frustum_tables(depths, zs)
    return [torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)
            for a, dt in ((d0, np.int32), (fd, np.float32),
                          (zs, np.float32), (xs, np.float32),
                          (ys, np.float32))]


def check_k4(gen, dev) -> dict:
    t = time.perf_counter()
    # small shape, both dtypes: depths past both ends, columns outside
    depths = np.linspace(4.0, 30.0, 6).astype(np.float32)
    zs = (4.0 + (np.arange(10) + 0.5) * 2.0).astype(np.float32)
    zs[0], zs[-1] = 2.5, 34.0
    xs = (-6.0 + (np.arange(12) + 0.5)).astype(np.float32)
    ys = (-1.0 + (np.arange(4) + 0.5) * 0.8).astype(np.float32)
    P = torch.tensor([[80.0, 0, 48.0, 2.0], [0, 80.0, 32.0, -0.3],
                      [0, 0, 1, 0.005]]).repeat(2, 1, 1)
    P[1, 0, 3] += 0.5
    P = P.to(dev)
    tabs = k4_tables(depths, zs, xs, ys, dev)
    for dtype in (torch.float32, torch.bfloat16):
        vol = torch.randn((2, 6, 16, 24, 16), generator=gen).to(dev, dtype)
        assert_within_ulps(f"K4 small {dtype}",
                           frustum_to_voxel_k4(vol, P, *tabs, 4),
                           frustum_to_voxel_separable(vol, P, *tabs, 4))
    # detect shape: [1, 64, 96, 312, 32] bf16 planes -> 288 x 300 x 20
    cfg = StereoConfig()
    D, C = cfg.num_depths, 32
    Hf, Wf = cfg.input_size[0] // 4, cfg.input_size[1] // 4
    depths = depth_hypotheses(cfg)
    tabs = k4_tables(depths, *_bev_axes(cfg), dev)
    vol = torch.randn((1, D, Hf, Wf, C), generator=gen).to(dev, torch.bfloat16)
    P = torch.from_numpy(Calibration.default().as_array()[None]).to(dev)
    got = frustum_to_voxel_k4(vol, P, *tabs, 4)
    err = assert_within_ulps("K4 detect", got,
                             frustum_to_voxel_separable(vol, P, *tabs, 4))
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: frustum_to_voxel_k4(vol, P, *tabs, 4), 20)
    plain_ms = cuda_ms(lambda: frustum_to_voxel_separable(vol, P, *tabs, 4),
                       3)
    # library: one trilinear F.grid_sample over the 5-D volume with
    # align_corners=True and a (u, v, d) grid, timed only
    u, v = _project_uv(P, tabs[2], tabs[3], tabs[4], 4)  # [1,nz,nx], [1,nz,ny]
    d = tabs[0].float() + tabs[1]
    nz, nx, ny = u.shape[1], u.shape[2], v.shape[2]
    grid = torch.stack([
        (2 * u / (Wf - 1) - 1)[..., None].expand(1, nz, nx, ny),
        (2 * v / (Hf - 1) - 1)[:, :, None, :].expand(1, nz, nx, ny),
        (2 * d / (D - 1) - 1)[None, :, None, None].expand(1, nz, nx, ny),
    ], dim=-1).to(torch.bfloat16)
    vt = vol.permute(0, 4, 1, 2, 3)
    library_ms = cuda_ms(lambda: F.grid_sample(
        vt, grid, mode="bilinear", padding_mode="zeros", align_corners=True),
        3)
    # bytes: the output, and each depth plane the tables use, read once;
    # f32 operations per output element: 4 (row, column) taps of a depth
    # lerp (3) and a weighted add (2), then 2 weighted adds over u (4)
    planes = len(set(tabs[0].tolist()) | {i + 1 for i in tabs[0].tolist()})
    read = planes * Hf * Wf * C * vol.element_size()
    bound_ms = max((read + nbytes(got)) / PEAK_BYTES,
                   24.0 * got.numel() / PEAK_F32_FLOPS) * 1e3
    phase("K4", t, max_abs_err=f"{err:.3e}", kernel_ms=f"{ms:.4f}",
          plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
          bound_ms=f"{bound_ms:.4f}", planes=planes)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                library_ms=library_ms)


# ----------------------------------------------------------- serving ----
KERNELS = dict(K1=stereo_voxel_sample, K1_bwd=stereo_voxel_sample_bwd,
               K2=conv3d_large_tap, K2_dx=conv3d_input_grad,
               K2_dw=conv3d_weight_grad, K3=plane_sweep_volume_k3,
               K4=frustum_to_voxel_k4, K5=conv3d_k3)


def counts_of(**nonzero) -> dict:
    """Every kernel's expected count: 0 unless given."""
    return {k: nonzero.get(k, 0) for k in KERNELS}


def reset_counts():
    for fn in KERNELS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in KERNELS.items()}


def check_serving(dev, profile: bool = False) -> dict:
    t = time.perf_counter()
    cfg = flagship_vernier_config()
    model = VernierScale(cfg, device=dev,
                         generator=torch.Generator().manual_seed(0))
    runner = RefineRunner(model, cfg, device=dev)
    runner.step(synthetic_batch_arrays(cfg, seed=100))  # warm-up
    torch.cuda.synchronize()
    batches = [synthetic_batch_arrays(cfg, seed=s) for s in (1, 2, 3)]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = []
    I = cfg.max_instances
    nh, nw, nl = cfg.grid_resolution
    for b in batches:
        t_req = time.perf_counter()
        out = runner.step(b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t_req) * 1e3)
        shapes = dict(one_part=(I, 7), all_parts=(I, 7), confidence=(I, 9),
                      keep=(I,), ncf=(I, 9, nl, nw),
                      occupancy=(I, nh, nw, nl), coordinates=(I, 9, 2))
        for k, s in shapes.items():
            v = out[k]
            assert tuple(v.shape) == s, f"{k}: {tuple(v.shape)} != {s}"
            if k != "keep":
                arr = v if isinstance(v, np.ndarray) else v.cpu().numpy()
                assert np.isfinite(arr).all(), f"{k} is not finite"
    counts = read_counts()
    n = len(batches)
    assert counts == counts_of(K1=n, K2=3 * n), f"launch counts {counts}"
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    med = sorted(times)[len(times) // 2]
    phase("serving", t, request_ms=",".join(f"{v:.1f}" for v in times),
          inst_per_s=f"{I / (med / 1e3):.2f}", peak_mem_gb=f"{peak_gb:.2f}",
          launches=json.dumps(counts).replace(" ", ""))
    if profile:
        profile_request(lambda: runner.step(batches[0]))
    del runner, model
    torch.cuda.empty_cache()
    return dict(counts=counts, request_ms=times)


def profile_request(request) -> None:
    """torch.profiler over one request (``request()``): device time by
    kernel (the 40 largest, and every one of the port's own) and the
    device's busy share of the request's wall time.  Only device (kernel) events are summed: the operator-level
    rows report the same device time again, and a user annotation on the
    device (the optimizer's ``Optimizer.step#AdamW.step``) spans its
    kernels and the gaps between them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_req = time.perf_counter()
        request()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t_req) * 1e3
    rows = []
    for e in prof.key_averages():
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    lines = [f"request wall {wall_ms:.2f} ms (profiled), device busy "
             f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} %), "
             f"{sum(r[1] for r in rows)} kernel launches",
             "device_ms  calls  kernel"]
    # the 40 largest rows, and every row of the port's own kernels
    own = ("stereo_voxel_sample", "conv3d_", "plane_sweep", "frustum_to")
    lines += [f"{ms:9.3f}  {n:5d}  {key[:110]}" for i, (ms, n, key)
              in enumerate(rows) if i < 40 or any(k in key for k in own)]
    for ln in lines:
        print(f"  profile: {ln}")
    phase("profile", t, wall_ms=f"{wall_ms:.2f}", busy_ms=f"{busy_ms:.2f}")


def check_reference(dev) -> None:
    """A small model (hrnet-tiny, 8x32x32 grid, HourglassDeep) on the card
    in bf16 (the kernels) against the same weights on the CPU in float32
    (the plain versions).  Random-weight GroupNorm stacks amplify bf16
    rounding (the CPU's own bf16 run drifts ~10 % of the NCF's scale from
    its float32 run), so the card must stay within three times the CPU
    bf16 drift plus 1 % of the scale: a wrong kernel lands far outside."""
    t = time.perf_counter()
    small = tiny_vernier_config(grid_resolution=(8, 32, 32),
                                image_size=(128, 256), max_instances=2)
    batch = synthetic_batch_arrays(small, seed=7)
    keys = ("ncf", "occupancy", "coordinates")

    def run(cfg, device):
        model = VernierScale(cfg, device=device,
                             generator=torch.Generator().manual_seed(1))
        return RefineRunner(model, cfg, device=device).step(
            batch, host_outputs=keys)

    bf16 = small.replace(compute_dtype="bfloat16")
    ref = run(small, "cpu")
    cpu_bf16 = run(bf16, "cpu")
    reset_counts()
    got = run(bf16, dev)
    assert (stereo_voxel_sample.launches, conv3d_large_tap.launches) == (1, 3)
    fields = {}
    for k in keys:
        scale = max(float(np.abs(ref[k]).max()), 1e-6)
        err = float(np.abs(got[k] - ref[k]).max()) / scale
        drift = float(np.abs(cpu_bf16[k] - ref[k]).max()) / scale
        assert np.isfinite(got[k]).all(), f"small model {k} not finite"
        assert err <= 3.0 * drift + 0.01, \
            f"small model {k}: card rel err {err:.4f}, cpu bf16 {drift:.4f}"
        fields[f"{k}_rel_err"] = f"{err:.4f}"
        fields[f"{k}_cpu_bf16_rel_err"] = f"{drift:.4f}"
    phase("reference", t, **fields)


# ------------------------------------------------------------ detect ----
def check_detect(dev, profile: bool = False) -> dict:
    """A full-width StereoConfig() DetectRunner: one warm-up and three
    requests, each timed on the host clock around a synchronized forward."""
    t = time.perf_counter()
    cfg = StereoConfig()
    model = StereoNet(cfg, device=dev,
                      generator=torch.Generator().manual_seed(0))
    runner = DetectRunner(model, cfg, device=dev)
    runner.forward(synthetic_stereo_request(cfg, seed=100))  # warm-up
    torch.cuda.synchronize()
    requests = [synthetic_stereo_request(cfg, seed=s) for s in (1, 2, 3)]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, n_valid = [], []
    mb = runner.max_boxes
    for r in requests:
        t_req = time.perf_counter()
        boxes, scores, classes, valid = runner.forward(r)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t_req) * 1e3)
        for name, v, shape in (("boxes", boxes, (1, mb, 7)),
                               ("scores", scores, (1, mb)),
                               ("classes", classes, (1, mb)),
                               ("valid", valid, (1, mb))):
            assert tuple(v.shape) == shape, f"{name}: {tuple(v.shape)}"
        assert bool(torch.isfinite(boxes).all()), "boxes are not finite"
        assert bool(torch.isfinite(scores[valid]).all()), \
            "scores of valid proposals are not finite"
        n_valid.append(int(valid.sum()))
    counts = read_counts()
    n = len(requests)
    assert counts == counts_of(K3=n, K4=n), f"launch counts {counts}"
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    med = sorted(times)[len(times) // 2]
    phase("detect", t, request_ms=",".join(f"{v:.1f}" for v in times),
          median_ms=f"{med:.1f}", pairs_per_s=f"{1e3 / med:.2f}",
          peak_mem_gb=f"{peak_gb:.2f}", valid=",".join(map(str, n_valid)),
          launches=json.dumps(counts).replace(" ", ""))
    if profile:
        profile_request(lambda: runner.forward(requests[0]))
    del runner, model
    torch.cuda.empty_cache()
    return dict(counts=counts, request_ms=times)


def check_stereo_reference(dev) -> None:
    """tiny_stereo_config in bf16 on the card (K3, K4) against the same
    weights in float32 on the CPU (their plain versions).  TF32 is off for
    cuDNN convolutions and matmuls and the float32 matmul precision is
    "highest", so the card's float32 work is float32.  The bound is the
    rule of phase "reference": within three times the CPU's own bf16 drift
    from its float32 run, plus 1 % of the output's scale."""
    t = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    small = tiny_stereo_config()
    req = synthetic_stereo_request(small, seed=7)
    keys = ("depth", "cls", "reg", "centerness")

    def run(cfg, device):
        model = StereoNet(cfg, device=device,
                          generator=torch.Generator().manual_seed(2))
        with torch.inference_mode():
            b = {k: torch.from_numpy(req[k]).to(device)
                 for k in ("images_left", "images_right", "P_left",
                           "P_right")}
            out = model(normalize_images(b["images_left"]),
                        normalize_images(b["images_right"]),
                        b["P_left"], b["P_right"])
        return {k: out[k].float().cpu().numpy() for k in keys}

    bf16 = small.replace(compute_dtype="bfloat16")
    ref = run(small, "cpu")
    cpu_bf16 = run(bf16, "cpu")
    reset_counts()
    got = run(bf16, dev)
    counts = read_counts()
    assert counts == counts_of(K3=1, K4=1), f"launch counts {counts}"
    fields = {}
    for k in keys:
        scale = max(float(np.abs(ref[k]).max()), 1e-6)
        err = float(np.abs(got[k] - ref[k]).max()) / scale
        drift = float(np.abs(cpu_bf16[k] - ref[k]).max()) / scale
        assert np.isfinite(got[k]).all(), f"tiny stereo {k} not finite"
        assert err <= 3.0 * drift + 0.01, \
            f"tiny stereo {k}: card rel err {err:.4f}, cpu bf16 {drift:.4f}"
        fields[f"{k}_rel_err"] = f"{err:.4f}"
        fields[f"{k}_cpu_bf16_rel_err"] = f"{drift:.4f}"
    phase("stereo_reference", t, tf32="off", matmul_precision="highest",
          **fields)


# ------------------------------------------------------------ K1 bwd ----
def assert_k1_grad(label, got, want, rel):
    """|got - want| <= rel |want| + 1e-4 of the largest |want|: the kernel
    sums in float32 with atomics (order varies) and rounds once."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    tol = rel * want.abs() + 1e-4 * want.abs().max()
    assert bool((err <= tol).all()), f"{label}: max err {err.max().item()}"
    return err.max().item()


def check_k1_bwd(gen, dev) -> dict:
    t = time.perf_counter()
    # small shape, f32 and bf16, with the grids' gradient
    for dtype in (torch.float32, torch.bfloat16):
        lf, rf, gl, gr = k1_case(gen, 2, 16, 16, 32, (4, 8, 8), (64, 64),
                                 dtype, dev)
        g = torch.randn((2, 4, 8, 8, 64), generator=gen).to(dev, dtype)
        got = stereo_voxel_sample_bwd(lf, rf, gl, gr, g, (64, 64))
        want = sample_stereo_voxel_bwd(lf.float(), rf.float(), gl, gr,
                                       g.float(), (64, 64))
        rel = 1e-5 if dtype == torch.float32 else 2.0 ** -7
        for name, a, b in zip(("dleft", "dright", "dgrid_l", "dgrid_r"),
                              got, want):
            assert_k1_grad(f"K1_bwd small {dtype} {name}", a, b,
                           rel if name[1] != "g" else 1e-5)
    # training shape: [8, 64, 64, 32] bf16 features, 16x96x96 grid, and the
    # projections of a training batch (where they cluster, the adds
    # contend: uniform random points would understate the time)
    cfg = VernierConfig()
    N, grid = cfg.max_instances, cfg.grid_resolution
    roi = cfg.resolution
    P = math.prod(grid)
    gl, gr = batch_projections(cfg, 0, dev)
    max_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        lf, rf, _, _ = k1_case(gen, N, 64, 64, 32, (1, 1, 1), roi, dtype,
                               dev)
        g = torch.randn((N,) + grid + (64,), generator=gen).to(dev, dtype)
        # worst contention: every point of an instance inside one 2x2 tap
        # patch (its own random patch, random fractions inside it)
        cell = torch.randint(0, 63, (N, 1, 2), generator=gen).float()
        frac = torch.rand((N, P, 2), generator=gen) * 0.9 + 0.05
        patch = ((cell + frac + 0.5) * (roi[1] / 64)).to(dev)
        for label, pl, pr in (("one_patch", patch, patch.flip(0)),
                              ("train", gl, gr)):
            if label == "train" and dtype == torch.float32:
                continue  # f32 at the training projections: the small cases
            got = stereo_voxel_sample_bwd(lf, rf, pl.contiguous(),
                                          pr.contiguous(), g, roi)
            want = sample_stereo_voxel_bwd(lf.float(), rf.float(), pl, pr,
                                           g.float(), roi)
            torch.cuda.synchronize()
            rel = 1e-5 if dtype == torch.float32 else 2.0 ** -7
            for name, a, b in zip(("dleft", "dright", "dgrid_l", "dgrid_r"),
                                  got, want):
                e = assert_k1_grad(f"K1_bwd {label} {dtype} {name}", a, b,
                                   rel if name[1] != "g" else 1e-5)
                if name[1] != "g":
                    max_err = max(max_err, e)
            del got, want
    patch = patch.contiguous()
    ms_one_patch = cuda_ms(lambda: stereo_voxel_sample_bwd(
        lf, rf, patch, patch, g, roi, need_grid=False), 5)
    # timed as training runs it: no grid gradient
    ms = cuda_ms(lambda: stereo_voxel_sample_bwd(lf, rf, gl, gr, g, roi,
                                                 need_grid=False), 20)
    plain_ms = cuda_ms(lambda: sample_stereo_voxel_bwd(
        lf, rf, gl, gr, g, roi, need_grid=False), 3)
    # library: the backward of F.grid_sample per view (NCHW views of the
    # NHWC features), timed only
    C = lf.shape[-1]
    scale = torch.tensor([2.0 / roi[1], 2.0 / roi[0]], device=dev)
    leaves = [f.detach().requires_grad_() for f in (lf, rf)]
    outs, gouts = [], []
    for leaf, gp, half in ((leaves[0], gl, g[..., :C]),
                           (leaves[1], gr, g[..., C:])):
        ng = (gp * scale - 1.0)[:, None].to(torch.bfloat16)
        outs.append(F.grid_sample(leaf.permute(0, 3, 1, 2), ng,
                                  align_corners=False, padding_mode="zeros"))
        gouts.append(half.reshape(N, 1, -1, C).permute(0, 3, 1, 2))
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        outs, leaves, gouts, retain_graph=True), 3)
    # bytes: the gradient and both grids read, both feature gradients
    # written; float32 work: 4 taps x (multiply + add) per gradient element
    bound_ms = max(nbytes(g, gl, gr, lf, rf) / PEAK_BYTES,
                   8.0 * g.numel() / PEAK_F32_FLOPS) * 1e3
    phase("K1_bwd", t, max_abs_err=f"{max_err:.3e}", kernel_ms=f"{ms:.4f}",
          kernel_ms_one_patch=f"{ms_one_patch:.4f}",
          plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
          bound_ms=f"{bound_ms:.4f}")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, library_ms=library_ms)


# ------------------------------------------------------------ K2 bwd ----
def conv_flops(shape, kernel, F_out, dil) -> float:
    """Useful multiply-adds x2 of a stride-1 SAME conv (valid taps only)."""
    N, D, H, W, C = shape
    return 2.0 * N * F_out * C * math.prod(
        valid_taps(n, k, dil) for n, k in zip((D, H, W), kernel))


def assert_conv(label, got, ref):
    """The K2 rule: 2^-7 relative plus 1e-3 of the output's scale."""
    err = (got.float() - ref).abs()
    tol = 2.0 ** -7 * ref.abs() + 1e-3 * ref.abs().max()
    assert bool((err <= tol).all()), f"{label}: max err {err.max().item()}"
    return err.max().item()


def conv_grads_ref(x, w, g, dil, fn=conv3d_pertap):
    """dx and dw of ``fn`` by float32 autograd (TF32 off)."""
    with torch.enable_grad():
        xr = x.float().requires_grad_()
        wr = w.float().requires_grad_()
        fn(xr, wr, dil).backward(g.float())
    return xr.grad, wr.grad


def check_k2_bwd(gen, dev) -> dict:
    t = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = VernierConfig()  # [8, 16, 96, 96] voxels per training step
    shape = (cfg.max_instances,) + cfg.grid_resolution
    cases = [  # name, x shape, kernel, F, dilation, timed
        ("conv1_k7", shape + (64,), (7, 7, 7), 32, 1, True),
        ("conv2_k5", shape + (32,), (5, 5, 5), 32, 1, True),
        ("conv3_k5_d2", shape + (32,), (5, 5, 5), 32, 2, True),
        ("ragged", (2, 9, 10, 70, 40), (5, 3, 7), 24, 2, False),
        ("ragged_scalar", (1, 7, 6, 33, 12), (5, 5, 5), 10, 1, False),
    ]
    tot = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                   max_abs_err=0.0) for k in ("dx", "dw")}
    for name, xs, kernel, F_out, dil, timed in cases:
        tc = time.perf_counter()
        x, w = k2_case(gen, xs, kernel, F_out, dev)
        g = torch.randn(xs[:-1] + (F_out,), generator=gen).to(
            dev, torch.bfloat16)
        dx = conv3d_input_grad(g, w, dil)
        dw = conv3d_weight_grad(x, g, kernel, dil)
        ref_dx, ref_dw = conv_grads_ref(x, w, g, dil)
        torch.cuda.synchronize()
        errs = dict(dx=assert_conv(f"K2_bwd {name} dx", dx, ref_dx),
                    dw=assert_conv(f"K2_bwd {name} dw", dw, ref_dw))
        del dx, dw, ref_dx, ref_dw
        fields = {f"{k}_max_abs_err": f"{v:.3e}" for k, v in errs.items()}
        for k, v in errs.items():
            tot[k]["max_abs_err"] = max(tot[k]["max_abs_err"], v)
        if timed:
            flops = conv_flops(xs, kernel, F_out, dil)
            pad = tuple((k - 1) // 2 * dil for k in kernel)
            xt, gt = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
            wt = w.permute(4, 3, 0, 1, 2).contiguous()
            wf = flip_weight(w)
            times = dict(
                dx=(cuda_ms(lambda: conv3d_input_grad(g, w, dil), 3),
                    cuda_ms(lambda: conv3d_pertap(g, wf, dil), 2),
                    cuda_ms(lambda: torch.nn.grad.conv3d_input(
                        xt.shape, wt, gt, 1, pad, dil), 2),
                    nbytes(g, w, x)),
                dw=(cuda_ms(lambda: conv3d_weight_grad(x, g, kernel, dil), 3),
                    cuda_ms(lambda: conv3d_weight_grad_plain(
                        x, g, kernel, dil), 1),
                    cuda_ms(lambda: torch.nn.grad.conv3d_weight(
                        xt, wt.shape, gt, 1, pad, dil), 2),
                    nbytes(x, g, w)))
            for k, (ms, plain_ms, library_ms, moved) in times.items():
                bound_ms = max(flops / PEAK_BF16_FLOPS,
                               moved / PEAK_BYTES) * 1e3
                for key, v in (("ms", ms), ("plain_ms", plain_ms),
                               ("library_ms", library_ms),
                               ("bound_ms", bound_ms)):
                    tot[k][key] += v
                fields.update({f"{k}_ms": f"{ms:.3f}",
                               f"{k}_plain_ms": f"{plain_ms:.3f}",
                               f"{k}_cudnn_ms": f"{library_ms:.3f}",
                               f"{k}_bound_ms": f"{bound_ms:.3f}",
                               f"{k}_tflops": f"{flops / ms / 1e9:.1f}",
                               f"{k}_pct_of_bound":
                                   f"{100 * bound_ms / ms:.1f}"})
        phase(f"K2_bwd {name}", tc, **fields)
        del x, w, g
        torch.cuda.empty_cache()
    phase("K2_bwd", t, **{f"{k}_{key}": f"{v:.3f}" for k, d in tot.items()
                          for key, v in d.items() if key != "max_abs_err"})
    return tot


# ---------------------------------------------------------------- K5 ----
def check_k5(gen, dev) -> dict:
    t = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    cases = [  # name, x shape, F
        ("stereo_stack", STEREO_STACK, 32),
        ("jax_test", (1, 4, 8, 16, 128), 32),
    ]
    out = {}
    for name, xs, F_out in cases:
        tc = time.perf_counter()
        x, w = k2_case(gen, xs, (3, 3, 3), F_out, dev)
        g = torch.randn(xs[:-1] + (F_out,), generator=gen).to(
            dev, torch.bfloat16)
        with torch.enable_grad():
            xr = x.detach().requires_grad_()
            wr = w.detach().requires_grad_()
            y = conv3d_k3(xr, wr)
            y.backward(g)
        ref = conv3d_pertap(x.float(), w.float(), 1)
        ref_dx, ref_dw = conv_grads_ref(x, w, g, 1)
        torch.cuda.synchronize()
        err = assert_conv(f"K5 {name}", y, ref)
        assert_conv(f"K5 {name} dx", xr.grad, ref_dx)
        assert_conv(f"K5 {name} dw", wr.grad, ref_dw)
        del y, ref, ref_dx, ref_dw, xr, wr
        flops = conv_flops(xs, (3, 3, 3), F_out, 1)
        xt = x.permute(0, 4, 1, 2, 3)
        wt = w.permute(4, 3, 0, 1, 2).contiguous()
        ms = cuda_ms(lambda: conv3d_k3(x, w), 5)
        plain_ms = cuda_ms(lambda: conv3d_pertap(x, w, 1), 3)
        library_ms = cuda_ms(lambda: F.conv3d(xt, wt, None, 1, 1), 3)
        gt = g.permute(0, 4, 1, 2, 3)
        dx_ms = cuda_ms(lambda: conv3d_input_grad(g, w, 1), 5)
        dw_ms = cuda_ms(lambda: conv3d_weight_grad(x, g, (3, 3, 3), 1), 5)
        dx_library_ms = cuda_ms(lambda: torch.nn.grad.conv3d_input(
            xt.shape, wt, gt, 1, 1), 3)
        dw_library_ms = cuda_ms(lambda: torch.nn.grad.conv3d_weight(
            xt, wt.shape, gt, 1, 1), 3)
        # forward, dx and dw each read two of x, w, g and write the third
        bound_ms = max(flops / PEAK_BF16_FLOPS,
                       (nbytes(x, w) + nbytes(g)) / PEAK_BYTES) * 1e3
        phase(f"K5 {name}", tc, max_abs_err=f"{err:.3e}",
              kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
              cudnn_ms=f"{library_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
              tflops=f"{flops / ms / 1e9:.1f}",
              pct_of_bound=f"{100 * bound_ms / ms:.1f}",
              dx_ms=f"{dx_ms:.4f}", dx_cudnn_ms=f"{dx_library_ms:.4f}",
              dx_tflops=f"{flops / dx_ms / 1e9:.1f}",
              dw_ms=f"{dw_ms:.4f}", dw_cudnn_ms=f"{dw_library_ms:.4f}",
              dw_tflops=f"{flops / dw_ms / 1e9:.1f}")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, library_ms=library_ms)
        del x, w, g
        torch.cuda.empty_cache()
    phase("K5", t)
    return out["stereo_stack"]


# ---------------------------------------------------------- training ----
REF_TRAIN = TrainConfig(lr=1e-3, warmup_steps=2, total_steps=50,
                        grad_clip=5.0)


def train_two_steps(cfg, device) -> dict:
    """Steps 0 and 1 of a seeded small model on one seeded batch: the
    losses and clipped gradients of step 0 (rate 0), the BatchNorm
    statistics after it, and the parameters after step 1, on the CPU."""
    model = VernierScale(cfg, device=device,
                         generator=torch.Generator().manual_seed(1))
    state = create_train_state(model, cfg, REF_TRAIN)
    step = make_train_step(cfg, REF_TRAIN, device)
    batch = batch_to_device(synthetic_batch_arrays(cfg, seed=7), device)
    m = step(state, batch)
    # copies: on the CPU .cpu() is the tensor itself, which step 1 updates
    res = dict(losses={k: float(v) for k, v in m.items()},
               grads={n: p.grad.float().cpu().clone()
                      for n, p in model.named_parameters()},
               stats={n: b.cpu().clone() for n, b in model.named_buffers()})
    step(state, batch)
    res["params"] = {n: p.detach().float().cpu().clone()
                     for n, p in model.named_parameters()}
    return res


def rel_l2(a: dict, b: dict) -> float:
    num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in b)
    den = sum(float((b[k] ** 2).sum()) for k in b)
    return math.sqrt(num / max(den, 1e-30))


def check_train_reference(dev) -> None:
    """One training step of a small model (hrnet-tiny, 8x16x16 grid, 4
    instances) on the card against the CPU.  The images are 384x1280, the
    default calibration's frame, so the ROIs hold image content (smaller
    images leave every ROI outside the frame, and float32 BatchNorm
    statistics of constant inputs are ill-conditioned).

    float32 (the fault this slice repairs: a float32 Conv3d went to the
    bf16-only K2 kernel): TF32 off and the matmul precision "highest", so
    the card's float32 work is float32.  Losses within 1e-4 relative,
    gradients within 3e-3 (global relative L2) and 3e-2 of each tensor's
    scale (float32 reordering through ~60 layers and their backward; the
    CPU's float32 gradients were 6e-4 / 4.7e-3 from a float64 run),
    BatchNorm statistics within 1e-4 of scale.  Step 1 is Adam's first
    nonzero update, lr x sign(g): every parameter within 2 x lr, and 97 %
    within 1e-5 (gradient elements within noise of zero may flip).

    bf16: the card's losses and gradients within three times the CPU's own
    bf16 drift from its float32 run, plus 1 % of scale."""
    t = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    small = tiny_vernier_config(max_instances=4, image_size=(384, 1280))
    ref = train_two_steps(small, "cpu")
    reset_counts()
    got = train_two_steps(small, dev)
    counts = read_counts()
    assert counts == counts_of(K1=2, K1_bwd=2), f"f32 launch counts {counts}"
    for k, v in ref["losses"].items():
        assert math.isfinite(got["losses"][k]), k
        assert abs(got["losses"][k] - v) <= 1e-4 * abs(v), \
            f"f32 {k}: {got['losses'][k]} vs {v}"
    g_rel = rel_l2(got["grads"], ref["grads"])
    worst = max(float((got["grads"][n] - w).abs().max())
                / max(float(w.abs().max()), 1e-12)
                for n, w in ref["grads"].items())
    assert g_rel <= 3e-3 and worst <= 3e-2, f"f32 grads {g_rel} {worst}"
    for n, w in ref["stats"].items():
        err = float((got["stats"][n] - w).abs().max())
        assert err <= 1e-4 * max(float(w.abs().max()), 1.0), f"{n}: {err}"
    flip = 2.0 * 5e-4 + 1e-6  # rate of step 1
    perr = torch.cat([(got["params"][n] - w).abs().ravel()
                      for n, w in ref["params"].items()])
    close = float((perr <= 1e-5).float().mean())
    assert float(perr.max()) <= flip and close >= 0.97, \
        f"f32 params: max {float(perr.max())}, within 1e-5 {close}"
    fields = dict(f32_total_rel_err=f"{abs(got['losses']['total'] / ref['losses']['total'] - 1):.2e}",
                  f32_grad_rel_l2=f"{g_rel:.2e}", f32_grad_worst=f"{worst:.2e}",
                  f32_params_within_1e5=f"{close:.4f}")

    bf16 = small.replace(compute_dtype="bfloat16")
    cpu_bf16 = train_two_steps(bf16, "cpu")
    reset_counts()
    got = train_two_steps(bf16, dev)
    counts = read_counts()
    assert counts == counts_of(K1=2, K1_bwd=2, K2=6, K2_dx=6, K2_dw=6), \
        f"bf16 launch counts {counts}"
    for k, v in ref["losses"].items():
        err = abs(got["losses"][k] - v) / max(abs(v), 1e-6)
        drift = abs(cpu_bf16["losses"][k] - v) / max(abs(v), 1e-6)
        assert math.isfinite(got["losses"][k]) and err <= 3 * drift + 0.01, \
            f"bf16 {k}: card rel err {err:.4f}, cpu bf16 {drift:.4f}"
        fields[f"bf16_{k}_rel_err"] = f"{err:.4f}"
        fields[f"bf16_{k}_cpu_rel_err"] = f"{drift:.4f}"
    g_err = rel_l2(got["grads"], ref["grads"])
    g_drift = rel_l2(cpu_bf16["grads"], ref["grads"])
    assert g_err <= 3 * g_drift + 0.01, \
        f"bf16 grads: card {g_err:.4f}, cpu bf16 {g_drift:.4f}"
    fields.update(bf16_grad_rel_l2=f"{g_err:.4f}",
                  bf16_grad_cpu_rel_l2=f"{g_drift:.4f}")
    phase("train_reference", t, tf32="off", matmul_precision="highest",
          **fields)


def check_train(dev, profile: bool = False, steps: int = 12) -> dict:
    """The JAX CLI's default training config, full width and depth, on
    one seeded batch; rate warm-up 2 steps (500 would keep the rate ~0)."""
    t = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = True  # the card's defaults
    cfg = VernierConfig()
    tc = TrainConfig(warmup_steps=2)
    model = VernierScale(cfg, device=dev,
                         generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, cfg, tc)
    step = make_train_step(cfg, tc, dev)
    batch = batch_to_device(synthetic_batch_arrays(cfg, seed=0), dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, losses = [], []
    for _ in range(steps):
        t_step = time.perf_counter()
        m = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t_step) * 1e3)
        losses.append(float(m["total"]))
    counts = read_counts()
    n = steps
    assert counts == counts_of(K1=n, K1_bwd=n, K2=3 * n, K2_dx=3 * n,
                               K2_dw=3 * n), f"launch counts {counts}"
    assert all(math.isfinite(v) for v in losses), f"losses {losses}"
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    q1, med, q3 = np.percentile(times, [25, 50, 75])
    I = cfg.max_instances
    phase("train", t, note="TrainConfig.warmup_steps=2",
          loss=",".join(f"{v:.4f}" for v in losses),
          step_ms=",".join(f"{v:.1f}" for v in times),
          median_ms=f"{med:.1f}", q1_ms=f"{q1:.1f}", q3_ms=f"{q3:.1f}",
          inst_per_s=f"{I / (med / 1e3):.2f}", peak_mem_gb=f"{peak_gb:.2f}",
          launches_per_step=json.dumps(
              {k: v // n for k, v in counts.items()}).replace(" ", ""))
    if profile:
        profile_request(lambda: step(state, batch))
    del state, model, step, batch
    torch.cuda.empty_cache()
    return dict(counts=counts, step_ms=times)


def main() -> int:
    t = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    phase("device", t, name=repr(name), nvidia_smi=repr(smi),
          torch=torch.__version__, cuda=torch.version.cuda)

    t = time.perf_counter()
    secs = _build.build()
    phase("build", t, build_s=f"{secs:.2f}")
    for lib in _build.LIBRARIES:
        for fn, regs, spills, notes in ptxas_report(_build.build_log(lib)):
            print(f"  ptxas: {lib} {fn} registers={regs} spill_bytes={spills}"
                  + "".join(f" NOTE {n}" for n in notes))
            # the two wgmma conv kernels: no spills, no serialized wgmma
            if lib in ("conv3d_large_tap", "conv3d_weight_grad"):
                assert spills == 0 and not notes, f"ptxas: {lib} {fn}"

    gen = torch.Generator().manual_seed(0)
    profile = "--profile" in sys.argv
    with torch.inference_mode():
        k1 = check_k1(gen, dev)
        k2 = check_k2(gen, dev)
        k3 = check_k3(gen, dev)
        k4 = check_k4(gen, dev)
        serving = check_serving(dev, profile=profile)
        check_reference(dev)
        detect = check_detect(dev, profile=profile)
        check_stereo_reference(dev)
    # the backward phases build autograd graphs: outside inference mode
    k1_bwd = check_k1_bwd(gen, dev)
    k2_bwd = check_k2_bwd(gen, dev)
    k5 = check_k5(gen, dev)
    check_train_reference(dev)
    train = check_train(dev, profile=profile)

    kernels = [
        dict(name="stereo_voxel_sample", route="cuda",
             source="snvc_tpu_torch/csrc/stereo_voxel_sample.cu",
             replaces="snvc_tpu/ops/grid_sample_pallas.py:217",
             launches=serving["counts"]["K1"], bound_by="bytes", **k1),
        dict(name="conv3d_large_tap", route="cuda",
             source="snvc_tpu_torch/csrc/conv3d_large_tap.cu",
             replaces="snvc_tpu/ops/conv3d_fold_pallas.py:236",
             launches=serving["counts"]["K2"], bound_by="operations", **k2),
        dict(name="plane_sweep_volume", route="cuda",
             source="snvc_tpu_torch/csrc/plane_sweep_volume.cu",
             replaces="snvc_tpu/ops/cost_volume.py:119",
             launches=detect["counts"]["K3"], bound_by="bytes", **k3),
        dict(name="frustum_to_voxel", route="cuda",
             source="snvc_tpu_torch/csrc/frustum_to_voxel.cu",
             replaces="snvc_tpu/ops/frustum_pallas.py:125",
             launches=detect["counts"]["K4"], bound_by="bytes", **k4),
        dict(name="stereo_voxel_sample_bwd", route="cuda",
             source="snvc_tpu_torch/csrc/stereo_voxel_sample.cu",
             replaces="snvc_tpu/ops/grid_sample_pallas.py:329",
             launches=train["counts"]["K1_bwd"], bound_by="bytes", **k1_bwd),
        dict(name="conv3d_large_tap_dx", route="cuda",
             source="snvc_tpu_torch/csrc/conv3d_large_tap.cu",
             replaces="snvc_tpu/ops/conv3d_fold_pallas.py:285",
             launches=train["counts"]["K2_dx"], bound_by="operations",
             **k2_bwd["dx"]),
        dict(name="conv3d_weight_grad", route="cuda",
             source="snvc_tpu_torch/csrc/conv3d_weight_grad.cu",
             replaces="snvc_tpu/ops/conv3d_fold_pallas.py:285",
             launches=train["counts"]["K2_dw"], bound_by="operations",
             **k2_bwd["dw"]),
        dict(name="conv3d_k3", route="cuda",
             source="snvc_tpu_torch/csrc/conv3d_large_tap.cu",
             replaces="snvc_tpu/ops/conv3d_pallas.py:118",
             launches=train["counts"]["K5"] + serving["counts"]["K5"],
             bound_by="operations", **k5),
    ]
    print(f"[total] {time.perf_counter() - T0:.2f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
