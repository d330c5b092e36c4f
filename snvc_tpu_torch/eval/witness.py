"""Hold a run's KITTI prediction files to a witness: another run's files on
the same frames (JAX's float32 CPU output, committed under
artifacts/two_stage_r4_torch/witness/).

Fields are the label columns 8-14, h w l x y z ry (m, rad); the yaw
difference is wrapped to [-pi, pi).  Two ways to pair boxes:

* ``compare_ordered``: refinement keeps its proposals' order, so box k of
  a file is paired with box k of the witness's file (the rule of
  scripts/two_stage_parity.py);
* ``compare_matched``: detection may order or keep boxes apart, so the
  boxes of a frame are paired greedily by nearest BEV centre, and a box
  left without a partner is allowed only when its score lies within
  ``score_tol`` of the detector's ``threshold`` (it may fall on either
  side of it in either run).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def read_rows(data_dir: str, frames: Optional[Sequence[str]] = None
              ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """{frame name: (boxes [n, 7] h w l x y z ry, scores [n])} of the
    ``*.txt`` files under ``data_dir`` (or of ``frames`` alone; a missing
    file reads as no box).  A line without a score column scores 1."""
    names = (sorted(f[:-4] for f in os.listdir(data_dir)
                    if f.endswith(".txt")) if frames is None else frames)
    out = {}
    for name in names:
        path = os.path.join(data_dir, name + ".txt")
        rows, scores = [], []
        if os.path.isfile(path):
            with open(path) as f:
                lines = f.read().splitlines()
            for ln in lines:
                p = ln.split()
                if p:
                    rows.append([float(v) for v in p[8:15]])
                    scores.append(float(p[15]) if len(p) > 15 else 1.0)
        out[name] = (np.array(rows, np.float64).reshape(-1, 7),
                     np.array(scores, np.float64))
    return out


def field_diff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| of box rows [n, 7], the yaw wrapped."""
    d = np.abs(a - b)
    d[:, 6] = np.abs((a[:, 6] - b[:, 6] + np.pi) % (2 * np.pi) - np.pi)
    return d


def compare_ordered(got_dir: str, want_dir: str, tol: float = 1e-3
                    ) -> Dict:
    """Box k of each file against box k of the witness's: ``boxes``,
    ``over_tol`` (boxes with a field more than ``tol`` off) and
    ``max_diff`` (the largest field difference).  Raises ValueError when
    the files or their line counts differ."""
    got, want = read_rows(got_dir), read_rows(want_dir)
    if list(got) != list(want):
        raise ValueError(f"frames differ: {sorted(set(got) ^ set(want))}")
    diffs = []
    for name in want:
        (g, _), (w, _) = got[name], want[name]
        if g.shape != w.shape:
            raise ValueError(f"{name}: {len(g)} boxes, witness {len(w)}")
        diffs.append(field_diff(g, w))
    d = np.concatenate(diffs) if diffs else np.zeros((0, 7))
    return dict(boxes=len(d), over_tol=int((d.max(axis=1) > tol).sum()),
                max_diff=float(d.max(initial=0.0)))


def compare_matched(got_dir: str, want_dir: str, frames: Sequence[str],
                    threshold: float, tol: float = 1e-3,
                    score_tol: float = 1e-3) -> Dict:
    """The boxes of each frame in ``frames`` paired by nearest BEV centre
    (greedy, closest pair first).  Returns ``matched``, ``over_tol``
    (pairs with a field more than ``tol`` off), ``max_diff`` (largest
    field difference of a pair), ``max_score_diff``, and ``one_sided``: a
    list of (frame, "run" or "witness", score, at_threshold) of the boxes
    left unpaired, ``at_threshold`` when the score lies within
    ``score_tol`` of ``threshold``."""
    got, want = read_rows(got_dir, frames), read_rows(want_dir, frames)
    diffs, sdiffs, one_sided = [], [], []
    for name in frames:
        (g, gs), (w, ws) = got[name], want[name]
        dist = np.linalg.norm(g[:, None, [3, 5]] - w[None, :, [3, 5]],
                              axis=-1) if len(g) and len(w) else None
        free_g, free_w = set(range(len(g))), set(range(len(w)))
        while dist is not None and free_g and free_w:
            i, j = min(((i, j) for i in free_g for j in free_w),
                       key=lambda ij: dist[ij])
            diffs.append(field_diff(g[i:i + 1], w[j:j + 1]))
            sdiffs.append(abs(gs[i] - ws[j]))
            free_g.discard(i)
            free_w.discard(j)
        for side, idx, s in (("run", free_g, gs), ("witness", free_w, ws)):
            for k in sorted(idx):
                one_sided.append((name, side, float(s[k]),
                                  abs(s[k] - threshold) <= score_tol))
    d = np.concatenate(diffs) if diffs else np.zeros((0, 7))
    return dict(matched=len(d), over_tol=int((d.max(axis=1) > tol).sum()),
                max_diff=float(d.max(initial=0.0)),
                max_score_diff=float(max(sdiffs, default=0.0)),
                one_sided=one_sided)
