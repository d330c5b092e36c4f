"""Tracking-by-detection with the Vernier model (port of
snvc_tpu/inference/track.py): the refinement model is the tracker, each
frame's proposal is the previous frame's refined box (reference
README.md:19-20, search for the next pose from an initial cuboid).

One ``RefineRunner.step`` a frame on a one-instance batch: on the card,
K1 once and, for the BEV_type3 / BEV_type2 heads, K2 three times.  The
motion prior is host numpy, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from snvc_tpu_torch.config import VernierConfig
from snvc_tpu_torch.data.instance_db import InstanceRecord
from snvc_tpu_torch.data.kitti import KittiScene
from snvc_tpu_torch.data.pipeline import RefinementPipeline
from snvc_tpu_torch.inference.refine import RefineRunner


@dataclass
class TrackState:
    box: np.ndarray  # [7] current pose
    confidence: float
    kept: bool


class Tracker:
    """Sequential local-search tracker over a frame sequence; ``update``
    picks the refined pose (``all_parts`` or ``one_part``)."""

    def __init__(self, runner: RefineRunner, cfg: VernierConfig,
                 update: str = "all_parts"):
        self.runner = runner
        self.cfg = cfg
        self.update = update
        self._pipe = RefinementPipeline([], cfg, training=False)

    def step_frame(self, scene: KittiScene, box: np.ndarray,
                   calib_left=None, calib_right=None) -> TrackState:
        """Refines ``box`` in ``scene``; a proposal the model drops keeps
        its pose."""
        cl = calib_left or scene.calibration("left")
        cr = calib_right or scene.calibration("right")
        rec = InstanceRecord(scene=scene, calib_left=cl, calib_right=cr,
                             pred=box.astype(np.float32),
                             box2d=np.zeros(4, np.float32), score=1.0)
        out = self.runner.step(self._pipe.make_batch([rec]))
        kept = bool(out["keep"][0])
        new_box = np.asarray(out[self.update][0]) if kept else box
        conf = float(np.asarray(out["confidence"])[0].mean())
        return TrackState(box=new_box, confidence=conf, kept=kept)

    def track(self, scenes: Sequence[KittiScene], init_box: np.ndarray,
              motion: str = "static", beta: float = 0.5
              ) -> List[TrackState]:
        """Refines the pose frame by frame from ``init_box``.

        ``motion``:
          * ``"static"``: each frame's proposal is the previous refined
            pose (the reference's local search); the refiner absorbs the
            whole per-frame motion.
          * ``"cv"``: a constant-velocity prior: the proposal extrapolates
            the previous refined pose by a velocity estimated from the
            refined poses' differences and damped by an EMA, so the
            refiner corrects only the residual.
        ``beta``: the EMA's damping (0 = the raw frame difference,
        1 = frozen).  The yaw difference is wrapped to [-pi, pi)."""
        states: List[TrackState] = []
        box = np.asarray(init_box, np.float32)
        vel = np.zeros(4, np.float32)  # d(x, y, z, ry) per frame
        for fi, scene in enumerate(scenes):
            proposal = box.copy()
            if motion == "cv" and fi > 0:
                proposal[3:6] += vel[:3]
                proposal[6] += vel[3]
            st = self.step_frame(scene, proposal)
            states.append(st)
            if motion == "cv" and st.kept:
                obs = np.empty(4, np.float32)
                obs[:3] = st.box[3:6] - box[3:6]
                obs[3] = (st.box[6] - box[6] + np.pi) % (2 * np.pi) - np.pi
                # frame 0 refines the initial pose in place: no motion yet
                vel = beta * vel + (1.0 - beta) * obs if fi > 0 else vel
            box = st.box
        return states
