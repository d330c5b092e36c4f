"""RoI-aware pooling, the proposals' LiDAR coverage and the stage-1
diagnostic's statistics of the port against the JAX package on the CPU:

* ``ops/points_in_boxes.roiaware_pool3d`` in ``max`` and ``avg`` mode, with
  points on voxel edges, on the box's faces and outside every box, within
  1e-6 of JAX's (snvc_tpu/ops/points_in_boxes.py:130);
* ``eval/coverage.proposal_lidar_coverage`` on a synthetic KITTI tree with
  noisy-GT proposals: the counts against proposals and the occupied-voxel
  fractions equal JAX's, record by record, and so do their medians.  The
  synthetic LiDAR lies on the GT boxes' faces, where float32 rounding
  decides inside or out and the port rounds apart from XLA (fused
  multiply-adds, its own sin / cos): counts against GT boxes are held to
  JAX's within each box's face points, and their medians within the
  largest such difference;
* ``tools/diagnose_proposals.split_stats`` equals JAX's
  (tools/diagnose_proposals.py:41) on the same prediction directory, but
  for those two GT medians; the CLI decodes a seeded smoke stage-1
  directory on the CPU.
"""

import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snvc_tpu.data.instance_db import attach_nearest_gt as j_attach
from snvc_tpu.data.instance_db import build_db_from_predictions as j_build
from snvc_tpu.data.kitti import KittiDataset as JKitti
from snvc_tpu.eval.coverage import proposal_lidar_coverage as j_coverage
from snvc_tpu.ops.points_in_boxes import roiaware_pool3d as j_pool
from snvc_tpu_torch.config import VernierConfig
from snvc_tpu_torch.data.instance_db import (
    attach_nearest_gt,
    build_db_from_predictions,
)
from snvc_tpu_torch.data.kitti import KittiDataset
from snvc_tpu_torch.data.synthetic import (
    make_synthetic_kitti,
    write_predictions,
)
from snvc_tpu_torch.eval.coverage import (
    coverage_counts,
    proposal_lidar_coverage,
)
from snvc_tpu_torch.ops.points_in_boxes import roiaware_pool3d
from snvc_tpu_torch.tools.diagnose_proposals import split_stats

ROOT = Path(__file__).resolve().parents[1]


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pool_inputs():
    """Three boxes (one axis-aligned with voxel edges at whole meters),
    points on those edges and faces, points inside the others, points
    outside every box, some invalid."""
    rng = np.random.default_rng(0)
    boxes = np.array([
        [2.0, 2.0, 4.0, 0.0, 2.0, 10.0, 0.0],  # ry = 0: l along camera x
        [1.5, 1.6, 3.9, 3.0, 1.7, 14.0, 0.6],
        [1.4, 1.8, 4.2, -4.0, 1.6, 20.0, -2.3],
    ], np.float32)
    # box 0: (l, h, w) = (x, y, z) offsets from its center (0, 1, 10);
    # voxels of 1 m along l, 0.5 m along h and w at out_size (4, 4, 4)
    edges = np.array([[x, y, z] for x in (-1.0, 0.0, 1.0, 2.0, -2.0)
                      for y in (0.5, 1.0, 1.5) for z in (9.5, 10.0, 10.5)],
                     np.float32)
    inside = np.concatenate([
        b[3:6] - [0.0, 0.5 * b[0], 0.0]
        + rng.uniform(-0.5, 0.5, (60, 3)) * b[[2, 0, 1]]
        for b in boxes]).astype(np.float32)
    outside = rng.uniform(-30, 30, (40, 3)).astype(np.float32) + [0, 0, 40]
    pts = np.concatenate([edges, inside, outside]).astype(np.float32)
    feats = rng.standard_normal((len(pts), 3)).astype(np.float32)
    valid = rng.uniform(size=len(pts)) > 0.1
    return pts, feats, valid, boxes


@pytest.mark.parametrize("mode", ["max", "avg"])
def test_roiaware_pool3d_matches_jax(mode):
    pts, feats, valid, boxes = _pool_inputs()
    want = np.asarray(j_pool(jnp.asarray(pts), jnp.asarray(feats),
                             jnp.asarray(valid), jnp.asarray(boxes),
                             (4, 4, 4), mode=mode))
    got = roiaware_pool3d(torch.from_numpy(pts), torch.from_numpy(feats),
                          torch.from_numpy(valid), torch.from_numpy(boxes),
                          (4, 4, 4), mode=mode).numpy()
    assert got.shape == want.shape == (3, 4, 4, 4, 3)
    assert (want != 0).any(axis=-1).sum() >= 20  # many voxels filled
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with pytest.raises(NotImplementedError):
        roiaware_pool3d(torch.from_numpy(pts), torch.from_numpy(feats),
                        torch.from_numpy(valid), torch.from_numpy(boxes),
                        (4, 4, 4), mode="sum")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A 3-frame synthetic val tree (3 cars a frame) with noisy-GT
    proposals under ``props/data`` and an extra false positive."""
    root = str(tmp_path_factory.mktemp("coverage"))
    kitti = os.path.join(root, "kitti_val")
    boxes = make_synthetic_kitti(kitti, 3, 3, seed=5, split="val")
    props = os.path.join(root, "props")
    write_predictions(os.path.join(props, "data"), boxes, noise=0.3)
    with open(os.path.join(props, "data", "000001.txt"), "a") as f:
        f.write("Car -1 -1 0.5 100 120 200 210 1.5 1.6 3.9 8.0 1.7 30.0 "
                "0.3 0.2\n")
    return kitti, props


def _face_points(recs, box_of):
    """Per record: the points of its scene within 1e-5 m of a face of its
    box (float64), where float32 rounding decides inside or out."""
    n = []
    for rec in recs:
        b = box_of(rec).astype(np.float64)
        pts = rec.calib_left.velo_to_rect(rec.scene.lidar()[:, :3])
        off = pts.astype(np.float32).astype(np.float64) - [
            b[3], b[4] - 0.5 * b[0], b[5]]
        c, s = np.cos(b[6]), np.sin(b[6])
        loc = np.abs(np.stack([-(off[:, 0] * s + off[:, 2] * c), off[:, 1],
                               off[:, 0] * c - off[:, 2] * s], axis=1))
        half = 0.5 * b[[1, 0, 2]]
        n.append(int(((np.abs(loc - half) < 1e-5).any(axis=1)
                      & (loc <= half + 1e-5).all(axis=1)).sum()))
    return np.array(n)


def _jax_counts(jdb, out_size=(6, 6, 6)):
    """JAX's per-record counts: the loop of snvc_tpu/eval/coverage.py:
    78-108 on its jitted pooling."""
    from snvc_tpu.eval.coverage import _pool_fn

    by_scene = {}
    for rec in jdb:
        if rec.pred is not None and rec.label is not None:
            by_scene.setdefault(rec.scene.name, []).append(rec)
    clouds = {n: r[0].calib_left.velo_to_rect(r[0].scene.lidar()[:, :3])
              .astype(np.float32) for n, r in by_scene.items()}
    p_max = int(np.ceil(max(c.shape[0] for c in clouds.values()) / 4096)
                * 4096)
    b_max = max(len(r) for r in by_scene.values())
    cp, cg, occ = [], [], []
    for name, recs in by_scene.items():
        pts = np.ones((p_max, 3), np.float32)
        pts[: len(clouds[name])] = clouds[name]
        valid = np.arange(p_max) < len(clouds[name])
        boxes = np.ones((2 * b_max, 7), np.float32)
        for i, rec in enumerate(recs):
            boxes[i], boxes[b_max + i] = rec.pred, rec.label
        o, c = (np.asarray(a) for a in _pool_fn(out_size)(pts, valid, boxes))
        cp += [float(c[i]) for i in range(len(recs))]
        cg += [float(c[b_max + i]) for i in range(len(recs))]
        occ += [float(o[i]) for i in range(len(recs))]
    return cp, cg, occ


def _dbs(kitti, data):
    from snvc_tpu.config import VernierConfig as JConfig

    cfg = VernierConfig()
    db = attach_nearest_gt(build_db_from_predictions(
        KittiDataset(kitti, "val"), cfg, data), cfg)
    jdb = j_attach(j_build(JKitti(kitti, "val"), JConfig(), data), JConfig())
    return db, jdb


def test_proposal_lidar_coverage_matches_jax(tree):
    """Counts against proposals and the pooled occupancy equal JAX's;
    counts against GT boxes, whose faces hold the synthetic points, differ
    at most by the points within 1e-5 m of a face; the medians follow."""
    kitti, props = tree
    db, jdb = _dbs(kitti, os.path.join(props, "data"))
    cp, cg, occ = coverage_counts(db, device="cpu")
    jcp, jcg, jocc = _jax_counts(jdb)
    assert len(cp) == len(jcp) == 10
    assert cp == jcp and occ == jocc
    recs = [r for r in db if r.pred is not None and r.label is not None]
    faces = _face_points(recs, lambda r: r.label)
    dg = np.abs(np.array(cg) - np.array(jcg))
    assert (dg <= faces).all(), (dg, faces)
    assert min(jcg) > 0

    got = proposal_lidar_coverage(db, device="cpu")
    want = j_coverage(jdb)
    assert set(got) == set(want) == {
        "pts_in_proposal_med", "pts_in_gt_med", "coverage_ratio_med",
        "occ_frac_med"}
    for k in ("pts_in_proposal_med", "occ_frac_med"):
        assert got[k] == want[k], k
    # a median moves no more than the largest change of one element
    assert abs(got["pts_in_gt_med"] - want["pts_in_gt_med"]) <= dg.max()
    dr = np.abs(np.array(cp) / np.maximum(cg, 1.0)
                - np.array(jcp) / np.maximum(jcg, 1.0)).max()
    assert abs(got["coverage_ratio_med"]
               - want["coverage_ratio_med"]) <= dr + 1e-3
    assert proposal_lidar_coverage([], device="cpu") == {}


def test_split_stats_matches_jax(tree):
    """Every key equal but the two GT-count medians, held as above."""
    kitti, props = tree
    got = split_stats(KittiDataset(kitti, "val"), props, device="cpu")
    want = _jax_tool("diagnose_proposals").split_stats(
        JKitti(kitti, "val"), props)
    assert set(got) == set(want)
    assert "coverage_ratio_med" in want and "center_med_m" in want
    gt_keys = ("pts_in_gt_med", "coverage_ratio_med")
    assert {k: v for k, v in got.items() if k not in gt_keys} == {
        k: v for k, v in want.items() if k not in gt_keys}
    db, _ = _dbs(kitti, os.path.join(props, "data"))
    assert {k: got[k] for k in gt_keys} == {
        k: v for k, v in proposal_lidar_coverage(db, device="cpu").items()
        if k in gt_keys}


def test_diagnose_proposals_main(tmp_path):
    """The CLI on a seeded smoke stage-1 directory (a step-0 checkpoint of
    ``demo_two_stage --smoke``'s model, 1 + 1 frames) on the CPU: it loads
    the checkpoint the way ``--reuse_stereo`` does (a flag that changes
    the architecture must match), decodes both splits and prints
    ``split_stats``, which JAX's reads the same from the files written."""
    from snvc_tpu_torch.config import TrainConfig
    from snvc_tpu_torch.models.stereonet import StereoNet
    from snvc_tpu_torch.tools import demo_two_stage, diagnose_proposals
    from snvc_tpu_torch.training.train import save_checkpoint
    from snvc_tpu_torch.training.train_stereo import create_stereo_state

    work = str(tmp_path)
    flags = ["--smoke", "--dtype", "float32", "--depth_offset"]
    cfg = demo_two_stage.stereo_config(diagnose_proposals.parse_args(
        ["--work_dir", work] + flags))
    model = StereoNet(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    save_checkpoint(os.path.join(work, "stereo_ckpt"),
                    create_stereo_state(model, TrainConfig()), cfg, 0)
    for split, seed in (("train", 0), ("val", 1000)):
        make_synthetic_kitti(os.path.join(work, f"kitti_{split}"), 1, 2,
                             seed=seed, split=split)
    argv = ["--work_dir", work, "--score_threshold", "0.0", "--device",
            "cpu"] + flags
    got = diagnose_proposals.main(argv)
    assert set(got) == {"train", "val"}
    jdiag = _jax_tool("diagnose_proposals")
    gt_keys = ("pts_in_gt_med", "coverage_ratio_med")
    for split in got:
        assert got[split]["n_proposals"] == 8
        assert "coverage_ratio_med" in got[split]
        want = jdiag.split_stats(
            JKitti(os.path.join(work, f"kitti_{split}"), split),
            os.path.join(work, f"diag_{split}_props"))
        assert set(want) == set(got[split])
        assert {k: v for k, v in got[split].items() if k not in gt_keys} \
            == {k: v for k, v in want.items() if k not in gt_keys}
    with pytest.raises(RuntimeError, match="state_dict"):
        diagnose_proposals.main(argv[:-1])  # without --depth_offset
