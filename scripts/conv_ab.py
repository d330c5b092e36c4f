"""A/B timing of the port's conv kernels (K2 forward, its dx and dw, K5)
between two trees of this repository, in turns on one NVIDIA GPU.

    python3 scripts/conv_ab.py --parent DIR [--rounds 2]

DIR holds another tree of the repository (e.g. unpacked by ``git archive
<commit>``).  The script runs itself once per tree and turn -- parent,
change, change, parent for two rounds -- each in a fresh process that builds
that tree's kernels and times, at the main paths' shapes:

  K2 fwd   the three flagship refinement convs ([4, 32, 192, 192, C]);
  K2 dx    conv3d_input_grad of the three training convs ([8, 16, 96, 96]);
  K2 dw    conv3d_weight_grad of the same;
  K5       forward, dx and dw of the stereo stack's first conv
           ([1, 64, 96, 312, 64] -> 32, 3x3x3);

and the one PyTorch call that computes each (F.conv3d, torch.nn.grad.
conv3d_input / conv3d_weight).  Each run prints one JSON line; the last
lines are the medians per tree and the change / parent ratios.  Times are
CUDA-event means over a few launches after a warm-up, on the same seeded
inputs in every run.
"""

from __future__ import annotations

import argparse
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


def time_tree(tree: Path) -> dict:
    """Milliseconds of each kernel wrapper of ``tree`` and of each library
    call, at the paths' shapes."""
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
    _build.build(("conv3d_large_tap", "conv3d_weight_grad"))
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

    out = {}
    with torch.inference_mode():
        for name, C, kernel, feats, dil in CONVS:
            x, w, _, xt, wt, _ = case(FLAGSHIP + (C,), kernel, feats)
            pad = tuple((k - 1) // 2 * dil for k in kernel)
            out[f"fwd {name}"] = cuda_ms(
                lambda: conv3d_large_tap(x, w, dil), 3)
            out[f"fwd {name} library"] = cuda_ms(
                lambda: F.conv3d(xt, wt, None, 1, pad, dil), 3)
            del x, w, xt, wt
        for name, C, kernel, feats, dil in CONVS:
            x, w, g, xt, wt, gt = case(TRAINING + (C,), kernel, feats)
            pad = tuple((k - 1) // 2 * dil for k in kernel)
            out[f"dx {name}"] = cuda_ms(
                lambda: conv3d_input_grad(g, w, dil), 3)
            out[f"dw {name}"] = cuda_ms(
                lambda: conv3d_weight_grad(x, g, kernel, dil), 3)
            out[f"dx {name} library"] = cuda_ms(
                lambda: torch.nn.grad.conv3d_input(xt.shape, wt, gt, 1, pad,
                                                   dil), 3)
            out[f"dw {name} library"] = cuda_ms(
                lambda: torch.nn.grad.conv3d_weight(xt, wt.shape, gt, 1, pad,
                                                    dil), 3)
            del x, w, g, xt, wt, gt
        x, w, g, xt, wt, gt = case(STEREO_STACK, (3, 3, 3), 32)
        out["K5 fwd"] = cuda_ms(lambda: conv3d_k3(x, w), 5)
        out["K5 dx"] = cuda_ms(lambda: conv3d_input_grad(g, w, 1), 5)
        out["K5 dw"] = cuda_ms(
            lambda: conv3d_weight_grad(x, g, (3, 3, 3), 1), 5)
        out["K5 fwd library"] = cuda_ms(
            lambda: F.conv3d(xt, wt, None, 1, 1), 5)
        out["K5 dx library"] = cuda_ms(
            lambda: torch.nn.grad.conv3d_input(xt.shape, wt, gt, 1, 1), 5)
        out["K5 dw library"] = cuda_ms(
            lambda: torch.nn.grad.conv3d_weight(xt, wt.shape, gt, 1, 1), 5)
    for part in ("fwd", "dx", "dw"):
        for suffix in ("", " library"):
            out[f"{part} total{suffix}"] = sum(
                out[f"{part} {c[0]}{suffix}"] for c in CONVS)
    return out


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
            print("conv_ab: needs an NVIDIA GPU", file=sys.stderr)
            return 1
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        print(json.dumps({"label": args.label, "card": smi,
                          "ms": time_tree(args.tree)}), flush=True)
        return 0
    if args.parent is None:
        ap.error("--parent is required")
    runs = {"parent": [], "change": []}
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
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
