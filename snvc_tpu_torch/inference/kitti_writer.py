"""KITTI-format prediction writer (port of
snvc_tpu/inference/kitti_writer.py).

One txt per frame under ``<output_dir>/<pred_type>/data/``, lines
"Car trunc occ alpha box2d(4) h w l x y z ry score", with alpha derived
from the refined pose, plus empty files for frames without predictions
on the test split.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from snvc_tpu_torch.config import VernierConfig
from snvc_tpu_torch.geometry.calib import ry_to_alpha


def instance_line(box3d, box2d, score, cls_name: str = "Car") -> str:
    """One KITTI label line: type, truncation and occlusion (-1), alpha,
    the 2D box, h w l, x y z, ry and the score."""
    alpha = ry_to_alpha(float(box3d[3]), float(box3d[5]), float(box3d[6]))
    f = [cls_name, "-1.0", "-1.0", f"{alpha:.6f}"]
    f += [f"{v:.6f}" for v in box2d[:4]]
    f += [f"{v:.6f}" for v in box3d[:7]]
    f.append(f"{score:.8f}")
    return " ".join(f)


class PredictionWriter:
    """Collects the refined boxes of each batch (``add_batch``) and writes
    them per frame and prediction type (``write``)."""

    def __init__(self, cfg: VernierConfig):
        self.cfg = cfg
        self.pred_types = tuple(cfg.pred_type)
        self.records: Dict[str, Dict[str, List[str]]] = {
            t: {} for t in self.pred_types
        }

    def add_batch(self, batch, out: Dict[str, np.ndarray]) -> None:
        """``batch``: an ``InstanceBatch``; ``out``: the runner's outputs
        with each pred type as a host array [I, 7]."""
        for i, name in enumerate(batch.scene_names):
            if name is None or not batch.valid[i]:
                continue
            score = batch.scores[i]
            if np.isnan(score):
                score = 1.0
            for t in self.pred_types:
                line = instance_line(out[t][i], batch.box2d[i], float(score))
                self.records[t].setdefault(name, []).append(line)

    def write(self, output_dir: Optional[str] = None,
              calib_dir: Optional[str] = None) -> str:
        """Write every txt file; with ``calib_dir``, an empty file for each
        frame without predictions.  Returns the output directory."""
        output_dir = output_dir or self.cfg.output_dir
        for t in self.pred_types:
            d = os.path.join(output_dir, t, "data")
            os.makedirs(d, exist_ok=True)
            for name, lines in self.records[t].items():
                with open(os.path.join(d, name + ".txt"), "w") as f:
                    f.write("\n".join(lines))
            if calib_dir and os.path.isdir(calib_dir):
                have = set(self.records[t])
                for fn in os.listdir(calib_dir):
                    if fn.endswith(".txt") and fn[:-4] not in have:
                        open(os.path.join(d, fn), "w").close()
        return output_dir
