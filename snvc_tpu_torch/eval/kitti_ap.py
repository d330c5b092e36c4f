"""The KITTI AP evaluator (port of snvc_tpu/eval/kitti_ap.py).

Builds the repo's ``cpp/kitti_eval.cpp`` with g++ into
``build/snvc_tpu_torch/kitti_eval_<hash>`` (rebuilt when the source
changes) and parses its per-metric summary lines into a nested dict:

    {"car": {"detection": {"ap11": [e, m, h], "ap40": [e, m, h]},
             "detection_ground": {...}, "detection_3d": {...},
             "orientation": {...}}}
"""

from __future__ import annotations

import subprocess
from pathlib import Path
from typing import Dict, Optional

from snvc_tpu_torch import _build

SOURCE = Path(__file__).resolve().parents[2] / "cpp" / "kitti_eval.cpp"


def build_evaluator() -> str:
    """Path of the evaluator binary, compiled first if the current source
    has not been built.  Raises RuntimeError if g++ fails."""
    return str(_build.build_host(SOURCE, shared=False))


def run_kitti_eval(gt_dir: str, result_dir: str,
                   car_min_iou: Optional[float] = None) -> Dict:
    """Score ``result_dir/data/XXXXXX.txt`` against ``gt_dir``.
    ``car_min_iou`` replaces the official 0.7 car threshold of all three
    metrics (a diagnostic readout, e.g. AP@0.5)."""
    cmd = [build_evaluator(), gt_dir, result_dir]
    if car_min_iou is not None:
        cmd.append(str(car_min_iou))
    proc = subprocess.run(cmd, capture_output=True, text=True, check=True)
    results: Dict[str, Dict] = {}
    for line in proc.stdout.splitlines():
        parts = line.split()
        if len(parts) == 9 and parts[1] == "AP11:" and parts[5] == "AP40:":
            cls, metric = parts[0].split("_", 1)
            results.setdefault(cls, {})[metric] = {
                "ap11": [float(x) for x in parts[2:5]],
                "ap40": [float(x) for x in parts[6:9]],
            }
    return results
