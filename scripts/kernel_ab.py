"""A/B timing of the port's kernels (K1 forward and backward, K2 forward,
its dx and dw, K3 and K4 forward and backward, K5) between two trees of
this repository, in turns on one NVIDIA GPU.

    python3 scripts/kernel_ab.py --parent DIR [--rounds 2]

DIR holds another tree of the repository (e.g. unpacked by ``git archive
<commit>``).  The script runs itself once per tree and turn -- parent,
change, change, parent for two rounds -- each in a fresh process that builds
that tree's kernels and times, at the main paths' shapes:

  K2 fwd   the three flagship refinement convs ([4, 32, 192, 192, C]);
  K2 dx    conv3d_input_grad of the three training convs ([8, 16, 96, 96]);
  K2 dw    conv3d_weight_grad of the same;
  K5       forward, dx and dw of the stereo stack's first conv
           ([1, 64, 96, 312, 64] -> 32, 3x3x3);
  K1 fwd   the flagship sampler ([4, 64, 64, 32] bf16 features, 32x192x192
           grid) at the path's projections (a seeded flagship batch through
           assemble_instances) and at uniform random ones;
  K1 bwd   the training sampler's backward ([8, 64, 64, 32], 16x96x96, a
           seeded VernierConfig() batch's projections, no grid gradient);
  K3       the detect request's plane sweep ([1, 96, 312, 32] bf16
           features x2, its own 64-plane shift table);
  K4       the detect request's frustum -> voxel resample ([1, 64, 96, 312,
           32] bf16 volume -> 288 x 300 x 20, the default calibration);
  K3 bwd   the stereo training step's plane-sweep backward ([1, 64, 96,
           312, 64] bf16 gradient, the default calibration's shifts);
  K4 bwd   the stereo training step's resample backward (gradient [1, 288,
           300, 20, 32] bf16 -> the volume's, the default calibration);

and the one PyTorch call that computes each (F.conv3d, torch.nn.grad.
conv3d_input / conv3d_weight, F.grid_sample forward / backward, the 5-D
trilinear F.grid_sample for K4 and its backward with respect to the
volume for K4 bwd; none for K3 or its backward).  Each run prints one JSON
line with the times and, per kernel, a checksum of its output bytes; the
last lines are the medians per tree, the change / parent ratios, and
whether each kernel's checksums agree between the trees (K1's backward
adds in an order that varies from run to run, so its checksum varies
too).  Times are CUDA-event means over a few launches after a warm-up, on
the same seeded inputs in every run.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

FLAGSHIP = (4, 32, 192, 192)
TRAINING = (8, 16, 96, 96)
CONVS = [  # name, input channels, kernel, features, dilation
    ("conv1_k7", 64, (7, 7, 7), 32, 1),
    ("conv2_k5", 32, (5, 5, 5), 32, 1),
    ("conv3_k5_d2", 32, (5, 5, 5), 32, 2),
]
STEREO_STACK = (1, 64, 96, 312, 64)


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def digest(result) -> str:
    """The first 16 hex digits of the SHA-256 of a kernel's output bytes
    (a tensor or a tuple of them)."""
    import torch

    h = hashlib.sha256()
    for t in result if isinstance(result, (tuple, list)) else (result,):
        if t is not None:
            h.update(t.detach().flatten().view(torch.uint8).cpu().numpy()
                     .tobytes())
    return h.hexdigest()[:16]


class Record:
    """Milliseconds of each call and checksums of each kernel's output."""

    def __init__(self):
        self.ms, self.sums = {}, {}

    def kernel(self, key, fn, reps):
        self.sums[key] = digest(fn())
        self.ms[key] = cuda_ms(fn, reps)

    def library(self, key, fn, reps):
        self.ms[key] = cuda_ms(fn, reps)


def time_tree(tree: Path) -> Record:
    """Milliseconds and output checksums of each kernel wrapper of
    ``tree`` and milliseconds of each library call, at the paths'
    shapes."""
    sys.path.insert(0, str(tree))
    import torch
    import torch.nn.functional as F

    from snvc_tpu_torch import _build
    from snvc_tpu_torch.ops.conv3d_fold import (
        conv3d_input_grad,
        conv3d_large_tap,
        conv3d_weight_grad,
    )
    from snvc_tpu_torch.ops.conv3d_k3 import conv3d_k3

    assert Path(_build.__file__).resolve().is_relative_to(tree.resolve())
    _build.build(("conv3d_large_tap", "conv3d_weight_grad",
                  "stereo_voxel_sample", "plane_sweep_volume",
                  "frustum_to_voxel"))
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    torch.backends.cudnn.allow_tf32 = False

    def case(shape, kernel, feats):
        x = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
        w = (torch.randn(kernel + (shape[-1], feats), generator=gen)
             / math.sqrt(math.prod(kernel) * shape[-1])).to(dev,
                                                              torch.bfloat16)
        g = torch.randn(shape[:-1] + (feats,), generator=gen).to(
            dev, torch.bfloat16)
        xt, gt = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
        wt = w.permute(4, 3, 0, 1, 2).contiguous()
        return x, w, g, xt, wt, gt

    out = Record()
    with torch.inference_mode():
        for name, C, kernel, feats, dil in CONVS:
            x, w, _, xt, wt, _ = case(FLAGSHIP + (C,), kernel, feats)
            pad = tuple((k - 1) // 2 * dil for k in kernel)
            out.kernel(f"fwd {name}",
                       lambda: conv3d_large_tap(x, w, dil), 3)
            out.library(f"fwd {name} library",
                        lambda: F.conv3d(xt, wt, None, 1, pad, dil), 3)
            del x, w, xt, wt
        for name, C, kernel, feats, dil in CONVS:
            x, w, g, xt, wt, gt = case(TRAINING + (C,), kernel, feats)
            pad = tuple((k - 1) // 2 * dil for k in kernel)
            out.kernel(f"dx {name}",
                       lambda: conv3d_input_grad(g, w, dil), 3)
            out.kernel(f"dw {name}",
                       lambda: conv3d_weight_grad(x, g, kernel, dil), 3)
            out.library(f"dx {name} library",
                        lambda: torch.nn.grad.conv3d_input(
                            xt.shape, wt, gt, 1, pad, dil), 3)
            out.library(f"dw {name} library",
                        lambda: torch.nn.grad.conv3d_weight(
                            xt, wt.shape, gt, 1, pad, dil), 3)
            del x, w, g, xt, wt, gt
        x, w, g, xt, wt, gt = case(STEREO_STACK, (3, 3, 3), 32)
        out.kernel("K5 fwd", lambda: conv3d_k3(x, w), 5)
        out.kernel("K5 dx", lambda: conv3d_input_grad(g, w, 1), 5)
        out.kernel("K5 dw",
                   lambda: conv3d_weight_grad(x, g, (3, 3, 3), 1), 5)
        out.library("K5 fwd library",
                    lambda: F.conv3d(xt, wt, None, 1, 1), 5)
        out.library("K5 dx library", lambda: torch.nn.grad.conv3d_input(
            xt.shape, wt, gt, 1, 1), 5)
        out.library("K5 dw library", lambda: torch.nn.grad.conv3d_weight(
            xt, wt.shape, gt, 1, 1), 5)
        del x, w, g, xt, wt, gt
        time_k34(out, dev, gen)
    time_k1(out, dev, gen)
    time_k34_bwd(out, dev, gen)
    for part in ("fwd", "dx", "dw"):
        for suffix in ("", " library"):
            out.ms[f"{part} total{suffix}"] = sum(
                out.ms[f"{part} {c[0]}{suffix}"] for c in CONVS)
    return out


def k1_projections(cfg, dev):
    """Both views' [N, P, 2] projections of a seeded synthetic batch, as
    the path computes them."""
    import torch

    from snvc_tpu_torch.data.synthetic import synthetic_batch_arrays
    from snvc_tpu_torch.ops.assemble import assemble_instances, make_grid_local
    from snvc_tpu_torch.training.train import batch_to_device

    b = batch_to_device(synthetic_batch_arrays(cfg, seed=0), dev)
    gl, gr = assemble_instances(
        b["images_left"], b["images_right"], b["image_idx"], b["trans_l"],
        b["trans_r"], b["samples"], b["P_left"], b["P_right"],
        torch.from_numpy(make_grid_local(cfg)).to(dev), cfg)[2:]
    return gl.float().contiguous(), gr.float().contiguous()


def stereo_tables(dev):
    """StereoConfig()'s (D, H, W) feature volume, the default left / right
    P, the 64-plane shift table and K4's five tables (d0, fd, zs, xs, ys)
    on ``dev``."""
    import numpy as np
    import torch

    from snvc_tpu_torch.config import StereoConfig
    from snvc_tpu_torch.geometry.calib import Calibration
    from snvc_tpu_torch.models.stereonet import (
        _bev_axes,
        depth_hypotheses,
        plane_shifts,
    )
    from snvc_tpu_torch.ops.frustum import frustum_tables

    cfg = StereoConfig()
    dhw = (cfg.num_depths, cfg.input_size[0] // 4, cfg.input_size[1] // 4)
    Pl = torch.from_numpy(Calibration.default().as_array()[None]).to(dev)
    Pr = torch.from_numpy(Calibration.default_right().as_array()[None]).to(
        dev)
    depths = depth_hypotheses(cfg)
    shifts = plane_shifts(Pl, Pr, torch.from_numpy(depths).to(dev))
    zs, xs, ys = _bev_axes(cfg)
    d0, fd = frustum_tables(depths, zs)
    tabs = [torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)
            for a, dt in ((d0, np.int32), (fd, np.float32), (zs, np.float32),
                          (xs, np.float32), (ys, np.float32))]
    return dhw, Pl, shifts, tabs


def k4_grid(Pl, tabs, dhw):
    """The [1, nz, nx, ny, 3] bf16 (u, v, d) grid, normalized for a 5-D
    F.grid_sample with align_corners=True, at which the BEV cells sample
    the volume: the library call's form of K4."""
    import torch

    from snvc_tpu_torch.ops.frustum import _project_uv

    D, H, W = dhw
    u, v = _project_uv(Pl, tabs[2], tabs[3], tabs[4], 4)
    d = tabs[0].float() + tabs[1]
    nz, nx, ny = u.shape[1], u.shape[2], v.shape[2]
    return torch.stack([
        (2 * u / (W - 1) - 1)[..., None].expand(1, nz, nx, ny),
        (2 * v / (H - 1) - 1)[:, :, None, :].expand(1, nz, nx, ny),
        (2 * d / (D - 1) - 1)[None, :, None, None].expand(1, nz, nx, ny),
    ], dim=-1).to(torch.bfloat16)


def time_k34(out: Record, dev, gen) -> None:
    """K3 and K4 at the detect request's shapes and tables, and the 5-D
    trilinear F.grid_sample that computes K4's function."""
    import torch
    import torch.nn.functional as F

    from snvc_tpu_torch.ops.cost_volume import plane_sweep_volume_k3
    from snvc_tpu_torch.ops.frustum import frustum_to_voxel_k4

    (D, H, W), Pl, shifts, tabs = stereo_tables(dev)
    C = 32
    lf, rf = (torch.randn((1, H, W, C), generator=gen).to(dev, torch.bfloat16)
              for _ in range(2))
    out.kernel("K3", lambda: plane_sweep_volume_k3(lf, rf, shifts), 20)
    vol = torch.randn((1, D, H, W, C), generator=gen).to(dev, torch.bfloat16)
    out.kernel("K4", lambda: frustum_to_voxel_k4(vol, Pl, *tabs, 4), 20)
    grid = k4_grid(Pl, tabs, (D, H, W))
    vt = vol.permute(0, 4, 1, 2, 3)
    out.library("K4 library", lambda: F.grid_sample(
        vt, grid, mode="bilinear", padding_mode="zeros", align_corners=True),
        3)


def time_k34_bwd(out: Record, dev, gen) -> None:
    """K3's and K4's backwards at the stereo training step's shapes, and
    the backward of K4's 5-D F.grid_sample with respect to the volume
    (outside inference mode: it records a graph)."""
    import torch
    import torch.nn.functional as F

    from snvc_tpu_torch.ops.cost_volume import plane_sweep_volume_k3_bwd
    from snvc_tpu_torch.ops.frustum import frustum_to_voxel_k4_bwd

    (D, H, W), Pl, shifts, tabs = stereo_tables(dev)
    C = 32
    g3 = torch.randn((1, D, H, W, 2 * C), generator=gen).to(dev,
                                                             torch.bfloat16)
    out.kernel("K3 bwd", lambda: plane_sweep_volume_k3_bwd(g3, shifts, W), 20)
    del g3
    nz, nx, ny = (len(t) for t in tabs[2:])
    g4 = torch.randn((1, nz, nx, ny, C), generator=gen).to(dev,
                                                            torch.bfloat16)
    out.kernel("K4 bwd", lambda: frustum_to_voxel_k4_bwd(
        g4, Pl, *tabs, (D, H, W), 4), 20)
    leaf = torch.zeros((1, C, D, H, W), dtype=torch.bfloat16, device=dev,
                       requires_grad=True)
    res = F.grid_sample(leaf, k4_grid(Pl, tabs, (D, H, W)), mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    gout = g4.permute(0, 4, 1, 2, 3)
    out.library("K4 bwd library", lambda: torch.autograd.grad(
        res, leaf, gout, retain_graph=True), 3)


def time_k1(out: Record, dev, gen) -> None:
    """The K1 wrappers and their F.grid_sample calls."""
    import torch
    import torch.nn.functional as F

    from snvc_tpu_torch.config import VernierConfig, flagship_vernier_config
    from snvc_tpu_torch.ops.stereo_sample_cuda import (
        stereo_voxel_sample,
        stereo_voxel_sample_bwd,
    )

    def features(N):
        return [torch.randn((N, 64, 64, 32), generator=gen).to(
            dev, torch.bfloat16) for _ in range(2)]

    def normalized(g, roi):
        scale = torch.tensor([2.0 / roi[1], 2.0 / roi[0]], device=dev)
        return (g * scale - 1.0)[:, None].to(torch.bfloat16)

    cfg = flagship_vernier_config()
    grid, roi, N = cfg.grid_resolution, cfg.resolution, cfg.max_instances
    P = grid[0] * grid[1] * grid[2]
    with torch.inference_mode():
        lf, rf = features(N)
        lft, rft = lf.permute(0, 3, 1, 2), rf.permute(0, 3, 1, 2)
        rnd = [torch.rand((N, P, 2), generator=gen).to(dev) * 1.125 * roi[1]
               - 0.0625 * roi[1] for _ in range(2)]
        for label, (gl, gr) in (("path", k1_projections(cfg, dev)),
                                ("random", rnd)):
            out.kernel(f"K1 fwd {label}", lambda: stereo_voxel_sample(
                lf, rf, gl, gr, roi, grid), 20)
            ngl, ngr = normalized(gl, roi), normalized(gr, roi)
            out.library(f"K1 fwd {label} library", lambda: torch.cat(
                [F.grid_sample(lft, ngl, align_corners=False),
                 F.grid_sample(rft, ngr, align_corners=False)], 1), 5)
        del lf, rf, lft, rft, rnd
    cfg = VernierConfig()
    grid, roi, N = cfg.grid_resolution, cfg.resolution, cfg.max_instances
    lf, rf = features(N)
    gl, gr = k1_projections(cfg, dev)
    g = torch.randn((N,) + grid + (64,), generator=gen).to(dev,
                                                           torch.bfloat16)
    out.kernel("K1 bwd", lambda: stereo_voxel_sample_bwd(
        lf, rf, gl, gr, g, roi, need_grid=False), 20)
    leaves = [f.detach().requires_grad_() for f in (lf, rf)]
    outs = [F.grid_sample(leaf.permute(0, 3, 1, 2), normalized(gp, roi),
                          align_corners=False)
            for leaf, gp in zip(leaves, (gl, gr))]
    gouts = [half.reshape(N, 1, -1, 32).permute(0, 3, 1, 2)
             for half in (g[..., :32], g[..., 32:])]
    out.library("K1 bwd library", lambda: torch.autograd.grad(
        outs, leaves, gouts, retain_graph=True), 5)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="the other tree")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--tree", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--label", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree is not None:  # one timed run, in its own process
        import torch

        if not torch.cuda.is_available():
            print("kernel_ab: needs an NVIDIA GPU", file=sys.stderr)
            return 1
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        rec = time_tree(args.tree)
        print(json.dumps({"label": args.label, "card": smi, "ms": rec.ms,
                          "sha": rec.sums}), flush=True)
        return 0
    if args.parent is None:
        ap.error("--parent is required")
    runs = {"parent": [], "change": []}
    sums = {"parent": [], "change": []}
    for label in ["parent", "change", "change", "parent"] * args.rounds:
        tree = args.parent if label == "parent" else ROOT
        res = subprocess.run(
            [sys.executable, __file__, "--tree", str(tree), "--label", label],
            capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout, res.stderr, file=sys.stderr)
            return res.returncode
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs[label].append(json.loads(line)["ms"])
        sums[label].append(json.loads(line)["sha"])
    keys = list(runs["change"][0])
    summary = {}
    for k in keys:
        p = statistics.median(r[k] for r in runs["parent"])
        c = statistics.median(r[k] for r in runs["change"])
        summary[k] = {"parent_ms": p, "change_ms": c,
                      "change_over_parent": c / p}
    for k, v in summary.items():
        print(f"{k:28s} parent {v['parent_ms']:9.4f}  change "
              f"{v['change_ms']:9.4f}  ratio {v['change_over_parent']:.3f}")
    bits = {}
    for k in sums["change"][0]:
        p = sorted({r[k] for r in sums["parent"]})
        c = sorted({r[k] for r in sums["change"]})
        bits[k] = {"parent": p, "change": c, "same_bits": p == c}
        print(f"{k:28s} checksums parent {','.join(p)}  change "
              f"{','.join(c)}  {'same bits' if p == c else 'DIFFER'}")
    print(json.dumps({"summary": summary, "checksums": bits}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
