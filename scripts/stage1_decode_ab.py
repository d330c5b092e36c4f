"""A/B of stage 1's image decode between two trees of this repository:
the stereo pipeline's host pass and the detect CLI over the val split of
the trained two-stage run, in turns on one NVIDIA GPU.

    python3 scripts/stage1_decode_ab.py --parent DIR [--rounds 2]

DIR holds another tree of the repository (its ``snvc_tpu_torch/`` is
enough, e.g. unpacked by ``git archive <commit> snvc_tpu_torch``).  The
script renders the split once with this tree's renderer
(``make_synthetic_kitti(root, 128, 3, seed=1000, split="val")``, as
``chip_smoke.py``'s phase ``trained_two_stage`` does), then runs itself
once per tree and turn -- one untimed warm-up a tree that builds its
kernels, then parent, change, change, parent for each round -- each in a
fresh process importing that tree's package, which measures:

  pipeline_s  one pass of ``StereoPipeline(training=False)`` over the
              split at the trained model's input size (host only: the
              PNG decodes, the padding, the calibration);
  detect_s    the detect CLI at demo_two_stage's stage-1 settings on the
              committed stereo checkpoint (bf16), as ``trained_two_stage``
              runs it: wall seconds, model load and first call included;

and checksums of the pipeline's image bytes and of the proposal files.
The last lines are the medians per tree, the change / parent ratios and
whether the checksums agree between the trees.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
MODEL_DIR = ROOT / "artifacts" / "two_stage_r4_torch" / "stereo"
VAL_FRAMES, VAL_CARS, VAL_SEED = 128, 3, 1000
STAGE1_ARGS = ["--max_boxes", "8", "--score_threshold", "0.02",
               "--nms_iou", "0.25"]


def time_tree(tree: Path, data: str, out: str) -> dict:
    """The two timings and checksums of one tree's package."""
    sys.path.insert(0, str(tree))
    import snvc_tpu_torch

    assert Path(snvc_tpu_torch.__file__).resolve().is_relative_to(
        tree.resolve()), snvc_tpu_torch.__file__
    from snvc_tpu_torch.config import StereoConfig, load_config
    from snvc_tpu_torch.data.kitti import KittiDataset
    from snvc_tpu_torch.data.stereo_pipeline import StereoPipeline
    from snvc_tpu_torch.tools import detect

    cfg = load_config(str(MODEL_DIR / "config.json"), StereoConfig)
    h = hashlib.sha256()
    t = time.perf_counter()
    for batch in StereoPipeline(KittiDataset(data, "val"), cfg,
                                training=False).batches():
        h.update(batch.images_left.tobytes())
        h.update(batch.images_right.tobytes())
    pipeline_s = time.perf_counter() - t
    t = time.perf_counter()
    detect.main(["--model_dir", str(MODEL_DIR), "--data_path", data,
                 "--output_dir", out, "--device", "cuda"] + STAGE1_ARGS)
    detect_s = time.perf_counter() - t
    p = hashlib.sha256()
    for name in sorted(os.listdir(os.path.join(out, "data"))):
        with open(os.path.join(out, "data", name), "rb") as fh:
            p.update(name.encode() + fh.read())
    return {"s": {"pipeline_s": pipeline_s, "detect_s": detect_s},
            "sha": {"images": h.hexdigest()[:16],
                    "proposals": p.hexdigest()[:16]}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="the other tree")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--tree", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--label", help=argparse.SUPPRESS)
    ap.add_argument("--data", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree is not None:  # one timed run, in its own process
        import torch

        if not torch.cuda.is_available():
            print("stage1_decode_ab: needs an NVIDIA GPU", file=sys.stderr)
            return 1
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        rec = time_tree(args.tree, args.data, args.out)
        print(json.dumps({"label": args.label, "card": smi,
                          "nproc": os.cpu_count(), **rec}), flush=True)
        return 0
    if args.parent is None:
        ap.error("--parent is required")

    sys.path.insert(0, str(ROOT))
    from snvc_tpu_torch.data.synthetic import make_synthetic_kitti

    work = tempfile.mkdtemp(prefix="stage1_ab_")
    try:
        data = os.path.join(work, "val")
        t = time.perf_counter()
        make_synthetic_kitti(data, VAL_FRAMES, VAL_CARS, seed=VAL_SEED,
                             split="val")
        print(json.dumps({"render_s": time.perf_counter() - t}), flush=True)
        runs = {"parent": [], "change": []}
        sums = {"parent": [], "change": []}
        order = (["parent", "change"]
                 + ["parent", "change", "change", "parent"] * args.rounds)
        for i, label in enumerate(order):
            tree = (args.parent if label == "parent" else ROOT).resolve()
            res = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--tree",
                 str(tree), "--label",
                 label, "--data", data, "--out",
                 os.path.join(work, f"run{i}")],
                capture_output=True, text=True, cwd=str(tree))
            if res.returncode != 0:
                print(res.stdout[-4000:], res.stderr[-8000:],
                      file=sys.stderr)
                return res.returncode
            line = res.stdout.strip().splitlines()[-1]
            print(("warm-up " if i < 2 else "") + line, flush=True)
            if i >= 2:
                runs[label].append(json.loads(line)["s"])
            sums[label].append(json.loads(line)["sha"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    summary = {}
    for k in runs["change"][0]:
        p = statistics.median(r[k] for r in runs["parent"])
        c = statistics.median(r[k] for r in runs["change"])
        summary[k] = {"parent": [r[k] for r in runs["parent"]],
                      "change": [r[k] for r in runs["change"]],
                      "parent_median": p, "change_median": c,
                      "change_over_parent": c / p}
        print(f"{k:12s} parent {p:9.3f}  change {c:9.3f}  ratio "
              f"{c / p:.3f}")
    bits = {}
    for k in sums["change"][0]:
        p = sorted({r[k] for r in sums["parent"]})
        c = sorted({r[k] for r in sums["change"]})
        bits[k] = {"parent": p, "change": c, "same_bits": p == c}
        print(f"{k:12s} checksums parent {','.join(p)}  change "
              f"{','.join(c)}  {'same bits' if p == c else 'DIFFER'}")
    print(json.dumps({"summary": summary, "checksums": bits}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
