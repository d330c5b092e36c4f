"""The committed JAX witnesses (artifacts/two_stage_r4_torch/witness, made
by ``scripts/two_stage_parity.py --witness``) and the comparisons that
hold the card's run to them (snvc_tpu_torch/eval/witness.py).

* The witness files: 181 refined boxes for each pred type over the 128
  val frames, in the committed proposals' order (the refinement keeps
  each proposal's line), 16 stage-1 files; witness.json's settings and
  the CPU AP values it records for both packages equal.
* ``compare_ordered``: a run equal to the witness is 0 boxes over 1e-3;
  one field moved 2e-3 (or a yaw moved by 2 pi - 5e-4, which wraps to
  5e-4) counts as over / not over; a file with another line count
  raises.
* ``compare_matched``: the witness's stage-1 boxes shuffled within each
  frame pair back exactly; a box dropped from the run is one-sided, at
  the threshold only when its score lies within 1e-3 of 0.02.
"""

import json
import os
import shutil

import numpy as np
import pytest

from snvc_tpu_torch.eval.witness import (
    compare_matched,
    compare_ordered,
    read_rows,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WITNESS = os.path.join(ROOT, "artifacts", "two_stage_r4_torch", "witness")
PROPOSALS = os.path.join(ROOT, "artifacts", "two_stage_r4", "proposals",
                         "data")


def test_committed_witness_files():
    with open(os.path.join(WITNESS, "witness.json")) as f:
        w = json.load(f)
    props = read_rows(PROPOSALS)
    assert len(props) == 128
    for pt in ("one_part", "all_parts"):
        rows = read_rows(os.path.join(WITNESS, pt, "data"))
        assert list(rows) == list(props)
        assert sum(len(b) for b, _ in rows.values()) == 181
        assert w["refine"][pt]["boxes"] == 181
        assert w["refine"][pt]["port_vs_jax_over_tol"] == 0
        assert w["refine"][pt]["ap3d_jax"] == w["refine"][pt]["ap3d_port"]
        for name, (b, _) in rows.items():
            assert len(b) == len(props[name][0]), name
    assert w["refine"]["config"]["ncf_decode"] == "argmax"
    s1 = w["stage1"]
    assert (s1["frames"], s1["max_boxes"], s1["score_threshold"],
            s1["nms_iou"]) == (16, 8, 0.02, 0.25)
    stage1 = read_rows(os.path.join(WITNESS, "stage1", "data"))
    assert len(stage1) == 16
    assert sum(len(b) for b, _ in stage1.values()) == s1["boxes_jax"]
    assert s1["port_vs_jax_over_tol"] == 0 and not s1["port_vs_jax_one_sided"]
    assert s1["ap3d_jax"] == s1["ap3d_port"]


def _rewrite(src_dir, dst_dir, edit):
    """Copy the KITTI files of ``src_dir`` to ``dst_dir``, each line's
    fields through ``edit(name, k, fields) -> fields or None``."""
    os.makedirs(dst_dir)
    for f in sorted(os.listdir(src_dir)):
        out = []
        with open(os.path.join(src_dir, f)) as fh:
            for k, ln in enumerate(fh.read().splitlines()):
                p = edit(f[:-4], k, ln.split())
                if p is not None:
                    out.append(" ".join(p))
        with open(os.path.join(dst_dir, f), "w") as fh:
            fh.write("\n".join(out) + ("\n" if out else ""))


@pytest.mark.parametrize("col,delta,over", [(11, 2e-3, 1), (11, 5e-4, 0),
                                            (14, 2 * np.pi - 5e-4, 0),
                                            (14, 2e-3, 1)])
def test_compare_ordered(tmp_path, col, delta, over):
    want = os.path.join(WITNESS, "all_parts", "data")
    got = str(tmp_path / "got")

    def edit(name, k, p):
        if (name, k) == ("000003", 0):
            p[col] = repr(float(p[col]) + delta)
        return p

    _rewrite(want, got, edit)
    res = compare_ordered(got, want)
    assert res["boxes"] == 181 and res["over_tol"] == over
    assert compare_ordered(want, want) == dict(boxes=181, over_tol=0,
                                               max_diff=0.0)
    shutil.rmtree(got)
    _rewrite(want, got, lambda n, k, p: None if (n, k) == ("000003", 0)
             else p)
    with pytest.raises(ValueError):
        compare_ordered(got, want)


def test_compare_matched(tmp_path):
    want = os.path.join(WITNESS, "stage1", "data")
    frames = sorted(f[:-4] for f in os.listdir(want))
    rows = read_rows(want, frames)
    # shuffled within each frame: every box pairs back exactly
    got = str(tmp_path / "shuffled")
    os.makedirs(got)
    for f in frames:
        with open(os.path.join(want, f + ".txt")) as fh:
            lines = fh.read().splitlines()
        with open(os.path.join(got, f + ".txt"), "w") as fh:
            fh.write("\n".join(lines[::-1]) + ("\n" if lines else ""))
    res = compare_matched(got, want, frames, 0.02)
    assert res["matched"] == sum(len(b) for b, _ in rows.values())
    assert (res["over_tol"], res["max_diff"], res["one_sided"]) == (0, 0.0,
                                                                    [])
    # the lowest-scoring box dropped from the run, then given the score
    # 0.0205 in the witness's copy: one-sided, at the threshold or not
    name, k = min(((n, i) for n in frames for i in range(len(rows[n][1]))),
                  key=lambda nk: rows[nk[0]][1][nk[1]])
    dropped = str(tmp_path / "dropped")
    _rewrite(want, dropped, lambda n, i, p: None if (n, i) == (name, k)
             else p)
    res = compare_matched(dropped, want, frames, 0.02)
    score = float(rows[name][1][k])
    assert res["one_sided"] == [(name, "witness", score,
                                 abs(score - 0.02) <= 1e-3)]
    near = str(tmp_path / "near")
    _rewrite(want, near, lambda n, i, p: p[:15] + ["0.0205"]
             if (n, i) == (name, k) else p)
    res = compare_matched(dropped, near, frames, 0.02)
    assert res["one_sided"] == [(name, "witness", 0.0205, True)]
