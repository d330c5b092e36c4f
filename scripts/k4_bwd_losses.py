"""How far the stereo training step's losses move when only the rounding
order of K4's backward (the frustum -> voxel resample's gradient with
respect to the volume) changes, on one NVIDIA GPU.

    python3 scripts/k4_bwd_losses.py --parent DIR [--steps 12]

DIR holds another tree of the repository (e.g. unpacked by ``git archive
<commit>``).  The script runs itself once per (tree, backward) -- parent
kernel, change kernel, change plain, parent plain -- each in a fresh
process that trains ``StereoConfig()`` at full width, batch 1, for
``--steps`` steps from seeded weights on one seeded frame with 4 cars
(``chip_smoke.py``'s phase stereo_train: rate warm-up 2 steps, TF32
convolutions), and prints its losses.  ``kernel`` is that tree's K4
backward as the path runs it; ``plain`` replaces it in
``FrustumK4.backward`` with ``frustum_to_voxel_separable_bwd``, which
computes the same function in float32 in another order and rounds once.
Every other part of the step is the same code in both trees, so the two
plain runs show whether the rest of the step is deterministic, and the
plain run's distance from each kernel's shows how far a pure change of
rounding order moves the losses.  The last lines give, for each pair of
runs, the first step whose losses differ and the largest relative
difference of the losses over the steps.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
RUNS = [("parent", "kernel"), ("change", "kernel"), ("change", "plain"),
        ("parent", "plain")]


def train(tree: Path, backward: str, steps: int) -> dict:
    """The losses of ``steps`` stereo training steps with ``tree``'s
    package and K4 backward ``backward`` ('kernel' or 'plain'), and the
    launches of each kernel wrapper."""
    sys.path.insert(0, str(tree))
    import torch

    from snvc_tpu_torch import _build
    from snvc_tpu_torch.config import StereoConfig, TrainConfig
    from snvc_tpu_torch.data.stereo import synthetic_stereo_request
    from snvc_tpu_torch.models.stereonet import StereoNet
    from snvc_tpu_torch.ops import frustum
    from snvc_tpu_torch.training.train_stereo import (
        create_stereo_state,
        make_stereo_train_step,
        stereo_batch_to_device,
    )

    assert Path(_build.__file__).resolve().is_relative_to(tree.resolve())
    _build.build()
    kernel = frustum.frustum_to_voxel_k4_bwd
    kernel.launches = 0
    plain_calls = [0]
    if backward == "plain":
        def plain(*args):
            plain_calls[0] += 1
            return frustum.frustum_to_voxel_separable_bwd(*args)

        frustum.frustum_to_voxel_k4_bwd = plain  # FrustumK4.backward's call
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = True
    cfg = StereoConfig()
    tc = TrainConfig(warmup_steps=2)
    model = StereoNet(cfg, device=dev,
                      generator=torch.Generator().manual_seed(0))
    state = create_stereo_state(model, tc)
    step = make_stereo_train_step(cfg, tc, dev)
    batch = stereo_batch_to_device(
        synthetic_stereo_request(cfg, seed=0, boxes_per_frame=4), dev)
    losses = [float(step(state, batch)["total"]) for _ in range(steps)]
    torch.cuda.synchronize()
    return {"losses": losses, "kernel_launches": kernel.launches,
            "plain_calls": plain_calls[0]}


def first_difference(a, b) -> int | None:
    """The 1-based step of the first loss that differs (None if none)."""
    return next((i + 1 for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="the other tree")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--tree", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--backward", choices=("kernel", "plain"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree is not None:  # one training run, in its own process
        import torch

        if not torch.cuda.is_available():
            print("k4_bwd_losses: needs an NVIDIA GPU", file=sys.stderr)
            return 1
        print(json.dumps(train(args.tree, args.backward, args.steps)))
        return 0
    if args.parent is None:
        ap.error("--parent is required")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    runs = {}
    for label, backward in RUNS:
        tree = args.parent if label == "parent" else ROOT
        res = subprocess.run(
            [sys.executable, __file__, "--tree", str(tree), "--backward",
             backward, "--steps", str(args.steps)],
            capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout, res.stderr, file=sys.stderr)
            return res.returncode
        run = json.loads(res.stdout.strip().splitlines()[-1])
        want = (args.steps, 0) if backward == "kernel" else (0, args.steps)
        got = (run["kernel_launches"], run["plain_calls"])
        assert got == want, f"{label} {backward}: launches, calls {got}"
        key = f"{label} {backward}"
        runs[key] = run["losses"]
        print(f"{key:14s} " + ",".join(f"{v:.4f}" for v in run["losses"]),
              flush=True)
    pairs = {}
    keys = list(runs)
    for i, a in enumerate(keys):
        for b in keys[i + 1:]:
            la, lb = runs[a], runs[b]
            rel = max(abs(x - y) / abs(y) for x, y in zip(la, lb))
            pairs[f"{a} / {b}"] = {"first_step_differing":
                                   first_difference(la, lb),
                                   "max_rel_diff": rel}
            print(f"{a + ' / ' + b:30s} first differing step "
                  f"{first_difference(la, lb)}  max relative difference "
                  f"{rel:.4e}")
    print(json.dumps({"card": smi, "losses": runs, "pairs": pairs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
